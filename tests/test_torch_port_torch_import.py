"""The port's reference-checkpoint import and export
(``nanovs_slam_torch/utils/torch_import.py``, ``torch_import_former.py``,
``torch_export.py``) against the JAX package's on the same reference-named
state_dicts, and the CLIs that load a ``.ckpt``. There is no reference
checkout here: the reference-named dicts are the port's export of seeded
models (KP2DTiny), or made by inverting the documented name map (the
inlier net, KeypointFormer)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_port_util import apply_jit
from nanovs_slam_torch.configs import get_config
from nanovs_slam_torch.models.kp2dtiny import build_model, init_model
from nanovs_slam_torch.utils.convert import (load_jax_inlier_net,
                                             load_jax_variables,
                                             load_state_strict)
from nanovs_slam_torch.utils.torch_export import (export_state_dict,
                                                  save_torch_checkpoint)
from nanovs_slam_torch.utils.torch_import import (
    convert_inlier_net_state_dict, convert_state_dict, load_model_weights,
    load_torch_checkpoint)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PINNED = os.path.join(REPO, "pinned", "extractor_S8.npz")
# every module kind the map covers: V2 / V3, attention, GeM, ConvAP,
# depth, the MCU transposed conv
CONFIGS = {"v2_n": ("N", {}), "v2_s_a": ("S_A", {}),
           "v3_s_a": ("S_A", dict(v3=True)), "gem_n": ("GEM_N", {}),
           "convap_d": ("D", {}), "depth_n": ("N", dict(depth=True)),
           "v3_depth": ("S", dict(v3=True, depth=True)),
           "mcu_s": ("S", dict(to_mcu=True))}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _seeded(name, kw, seed=1):
    cfg = get_config(name, n_classes=8, **kw)
    return cfg, init_model(cfg, torch.Generator().manual_seed(seed), "cpu")


def _assert_equal_states(got, want):
    """Two state dicts: the same keys (but BN's num_batches_tracked) and
    equal tensors, bit for bit."""
    keys = {k for k in want if not k.endswith("num_batches_tracked")}
    assert set(got) == keys
    for k in keys:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("case", sorted(CONFIGS))
def test_import_equals_jax_import_and_export_inverts_it(case):
    """On a reference-named state_dict (the export of a seeded model): the
    port's ``convert_state_dict`` equals, bit for bit, the JAX
    ``convert_state_dict`` carried into the port (``load_jax_variables``),
    which therefore accepts every exported key; the import gives back the
    model's weights; ``export(import(sd)) == sd``, with and without the
    template; a bias on the vladv1 assignment conv is dropped, as the JAX
    importer drops it."""
    from nanovs_slam_tpu.utils.torch_import import \
        convert_state_dict as jax_convert

    name, kw = CONFIGS[case]
    cfg, model = _seeded(name, kw)
    ref = export_state_dict(model)
    got = convert_state_dict(ref)
    params, stats = jax_convert(ref)
    want = load_jax_variables(build_model(cfg), params, stats).state_dict()
    _assert_equal_states(got, want)
    _assert_equal_states(got, model.state_dict())
    back = load_state_strict(build_model(cfg), got)
    for exported in (export_state_dict(back), export_state_dict(back, ref)):
        assert set(exported) == set(ref)
        for k, v in ref.items():
            assert torch.equal(exported[k], v), k
    if cfg.global_descriptor_method == "netvlad":
        extra = dict(ref, **{"vlad_head.netvlad.conv.bias": torch.ones(
            cfg.num_clusters)})
        _assert_equal_states(convert_state_dict(extra), want)


def test_reference_names_follow_the_map():
    """The exported names are the reference's quirks: confAa / confBb,
    convs.N, the descriptor head's lone ``upsample``, the attention's
    PreNorm paths, NetVLAD's soft-assign conv (K, C, 1, 1) and the
    LayerNorm's (1, C, 1, 1)."""
    _, model = _seeded("S_A", {})
    ref = export_state_dict(model)
    for key in ("desc_head.confAa.conv.weight", "desc_head.confBb.weight",
                "seg_head.convs.1.att.fn.to_q.weight",
                "seg_head.convs.1.att.norm.g",
                "seg_head.convs.2.mff.fn.net.1.net.0.weight",
                "seg_head.convs.2.mff.fn.net.3.bias",
                "vlad_head.netvlad.conv.weight"):
        assert key in ref, key
    assert tuple(ref["seg_head.convs.1.att.norm.g"].shape) == (1, 64, 1, 1)
    assert tuple(ref["vlad_head.netvlad.conv.weight"].shape) == (64, 64, 1,
                                                                 1)
    _, mcu = _seeded("S", dict(to_mcu=True))
    names = export_state_dict(mcu)
    assert "desc_head.upsample.transposed_conv.weight" in names
    assert "seg_head.upsample2.transposed_conv.weight" in names


def _reference_inlier_net(net):
    """The port's InlierNet state_dict under the reference's names and
    layout (1x1 convs: (out, in, 1, 1))."""
    sd = net.state_dict()
    out = {"p_in.0.weight": sd["p_in_conv.weight"][:, :, None, None],
           "p_out.weight": sd["p_out.weight"][:, :, None, None],
           "p_out.bias": sd["p_out.bias"]}
    bn = ("weight", "bias", "running_mean", "running_var")
    out.update({f"p_in.1.{x}": sd[f"p_in_bn.{x}"] for x in bn})
    for i in range(4):
        for j in range(2):
            out[f"{i}s{2 * j}.weight"] = \
                sd[f"b{i}_conv{j}.weight"][:, :, None, None]
            out[f"{i}s{2 * j}.bias"] = sd[f"b{i}_conv{j}.bias"]
            out.update({f"{i}s{2 * j + 1}.{x}": sd[f"b{i}_bn{j}.{x}"]
                        for x in bn})
    return {k: v.clone() for k, v in out.items()}


def test_inlier_net_import_equals_jax_import():
    """The reference inlier net's dict: the port's import equals the JAX
    ``convert_inlier_net_state_dict`` carried into the port, bit for bit,
    and gives back the seeded weights."""
    from nanovs_slam_tpu.utils.torch_import import \
        convert_inlier_net_state_dict as jax_convert
    from nanovs_slam_torch.models.inlier_net import (InlierNet,
                                                     init_inlier_net)

    net = init_inlier_net(torch.Generator().manual_seed(3), device="cpu")
    with torch.no_grad():
        for k, v in net.state_dict().items():
            if k.endswith(("running_mean", "running_var")):
                v.copy_(torch.rand(v.shape) + 0.5)
    ref = _reference_inlier_net(net)
    got = convert_inlier_net_state_dict(ref)
    params, stats = jax_convert({k: v.numpy() for k, v in ref.items()})
    want = load_jax_inlier_net(InlierNet(), params, stats).state_dict()
    _assert_equal_states(got, want)
    _assert_equal_states(got, net.state_dict())


def _reference_keypoint_former(model, num_layers):
    """The port's KeypointFormer state_dict under the reference's names,
    by inverting the map of ``torch_import_former`` (its module doc):
    the embeddings as Unfold + 1x1 weights, the heads' sequentials with
    conv, BN, ReLU slots, NetVLAD's conv."""
    from nanovs_slam_torch.utils.torch_import_former import (HEADS,
                                                             MFF_LAYERS)

    sd = model.state_dict()
    out = {}

    def copy(ours, ref, leaves=("weight", "bias")):
        for leaf in leaves:
            if f"{ours}.{leaf}" in sd:
                out[f"{ref}.{leaf}"] = sd[f"{ours}.{leaf}"].clone()

    bn = ("weight", "bias", "running_mean", "running_var",
          "num_batches_tracked")
    for s in range(4):
        w = sd[f"mit.stage{s}_embed.weight"]
        out[f"mit.stages.{s}.1.weight"] = w.reshape(w.shape[0], -1, 1, 1)
        out[f"mit.stages.{s}.1.bias"] = sd[f"mit.stage{s}_embed.bias"]
        for layer in range(num_layers):
            base, ours = f"mit.stages.{s}.2.{layer}", f"mit.stage{s}_l{layer}"
            for i, part in ((0, "norm_att"), (1, "norm_mff")):
                for leaf in ("g", "b"):
                    out[f"{base}.{i}.norm.{leaf}"] = sd[
                        f"{ours}_{part}.{leaf}"].reshape(1, -1, 1, 1)
            for name in ("to_q", "to_kv", "to_out"):
                copy(f"{ours}_att.{name}", f"{base}.0.fn.{name}")
            for ref, name in MFF_LAYERS:
                copy(f"{ours}_mff.{name}", f"{base}.1.fn.net.{ref}")
    for i in range(4):
        copy(f"to_fused{i}_conv", f"to_fused.{i}.0")
        copy(f"to_fused{i}_bn", f"to_fused.{i}.1", bn)
    for ref, ours in HEADS:
        seq, j = 0, 0
        while f"{ours}_conv{j}.weight" in sd:
            copy(f"{ours}_conv{j}", f"{ref}.{seq}")
            if f"{ours}_bn{j}.weight" in sd:
                copy(f"{ours}_bn{j}", f"{ref}.{seq + 1}", bn)
                seq += 3  # conv, BN, ReLU
            else:
                seq += 1
            j += 1
    out["netvlad.conv.weight"] = sd["netvlad.assign_w"].t()[:, :, None, None]
    out["netvlad.conv.bias"] = sd["netvlad.assign_b"].clone()
    out["netvlad.centroids"] = sd["netvlad.centroids"].clone()
    return out


def test_keypoint_former_import_equals_jax_import():
    """KeypointFormer "tiny" (seeded): the port's import of its
    reference-named dict equals the JAX ``convert_keypoint_former_state_
    dict`` carried into the port, bit for bit, and gives back the seeded
    weights; ``load_model_weights`` reads it from a ``.ckpt``."""
    from nanovs_slam_tpu.utils.torch_import_former import \
        convert_keypoint_former_state_dict as jax_convert
    from nanovs_slam_torch.models.keypoint_former import (
        KEYPOINTFORMER_CONFIGS, build_model as kf_build, init_model as kf_init)
    from nanovs_slam_torch.utils.torch_import_former import \
        convert_keypoint_former_state_dict

    cfg = KEYPOINTFORMER_CONFIGS["tiny"]
    model = kf_init(cfg, torch.Generator().manual_seed(4), "cpu")
    ref = _reference_keypoint_former(model, cfg.num_layers)
    got = convert_keypoint_former_state_dict(ref, cfg.num_layers)
    params, stats = jax_convert({k: v.numpy() for k, v in ref.items()},
                                cfg.num_layers)
    want = load_jax_variables(kf_build(cfg), params, stats).state_dict()
    _assert_equal_states(got, want)
    _assert_equal_states(got, model.state_dict())


def test_imported_forward_matches_jax(tmp_path):
    """Config S_A (attention, NetVLAD) from a reference ``.ckpt`` (the
    ``keypoint_net.`` prefix, ``load_torch_checkpoint``): the port's eval
    forward within 1e-4 of the JAX apply of the JAX import of the same
    dict, at 48x64."""
    from nanovs_slam_tpu.configs import get_config as jget
    from nanovs_slam_tpu.models.kp2dtiny import build_model as jbuild
    from nanovs_slam_tpu.utils.torch_import import load_torch_checkpoint \
        as jax_load

    cfg, model = _seeded("S_A", {}, seed=5)
    path = save_torch_checkpoint(str(tmp_path / "m.ckpt"), model,
                                 {"config": "S_A"})
    sd, config = load_torch_checkpoint(path)
    assert config == {"config": "S_A"}
    port = load_model_weights(build_model(cfg), path).eval()
    _assert_equal_states(sd, port.state_dict())
    params, stats, _ = jax_load(path)
    x = np.random.RandomState(6).uniform(-1, 1, (1, 48, 64, 3)).astype(
        np.float32)
    want = apply_jit(jbuild(jget("S_A", n_classes=8)), params, stats, x,
                     train=False)
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    for k, v in want.items():
        g = got[k].numpy()
        g = g.transpose(0, 2, 3, 1) if g.ndim == 4 else g
        np.testing.assert_allclose(g, v, atol=1e-4, err_msg=k)


def test_eval_cli_reads_a_ckpt_as_the_npz(tmp_path):
    """``eval_multitask --model_path x.ckpt`` (pinned S8 exported by
    ``save_torch_checkpoint``) on the CPU writes the same results as
    ``--model_path pinned/extractor_S8.npz``: keypoints on 2 synthetic
    HPatches pairs at 48x64, equal."""
    from nanovs_slam_torch import eval_multitask

    cfg = get_config("S", n_classes=8)
    model = load_model_weights(build_model(cfg), PINNED)
    ckpt = save_torch_checkpoint(str(tmp_path / "s8.ckpt"), model)
    hp = tmp_path / "hpatches"
    subprocess.run([sys.executable, os.path.join(
        REPO, "scripts", "make_synthetic_hpatches.py"), str(hp), "--n-seq",
        "1"], check=True, capture_output=True)
    ds = tmp_path / "datasets.json"
    ds.write_text(json.dumps({"hpatches_data_path": str(hp)}))
    res = {}
    for tag, path in (("ckpt", ckpt), ("npz", PINNED)):
        out = tmp_path / f"{tag}.json"
        eval_multitask.main(
            ["--model_path", path, "--config", "S", "--n_classes", "8",
             "--im_h", "48", "--im_w", "64", "--keypoints", "--max_items",
             "2", "--top_k", "50", "--dataset_config", str(ds), "--device",
             "cpu", "--out", str(out)])
        res[tag] = json.loads(out.read_text())
    assert "error" not in res["npz"]["keypoints_top50"]
    assert res["ckpt"] == res["npz"]
