"""KeypointFormer in the port against the JAX package on the CPU: the
forward at "tiny" and "default" (96x128, seeded random flax variables with
random BN statistics carried across by ``utils/convert``), ``only_encoder``,
train-mode BN statistics, bf16, the vladv2 NetVLAD (its bias) and its
gradients, the postprocess twin at C = 256, ``make_infer_fn`` with a top-K,
the frame sizes the JAX model refuses, one ``train_multitask`` step and its
checkpoint, and the evaluation CLI on a seeded HPatches fixture."""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import (apply_jit, assert_dense_outputs_match,
                              assert_top_k_match_as_sets, nchw, nhwc,
                              random_variables)
from nanovs_slam_tpu.models.keypoint_former import \
    KEYPOINTFORMER_CONFIGS as JAX_CONFIGS
from nanovs_slam_tpu.models.keypoint_former import \
    KeypointFormer as JaxKeypointFormer
from nanovs_slam_torch.models.keypoint_former import (KEYPOINTFORMER_CONFIGS,
                                                      KeypointFormer,
                                                      check_frame_size)
from nanovs_slam_torch.utils.convert import load_jax_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PINNED = os.path.join(REPO, "pinned", "extractor_S8.npz")
H, W, N_CLASSES = 96, 128, 8


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads for this file's torch work (the suite runs
    files in parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _configs(name, dtype="float32"):
    kw = dict(n_classes=N_CLASSES, dtype=dtype)
    return (dataclasses.replace(JAX_CONFIGS[name], **kw),
            dataclasses.replace(KEYPOINTFORMER_CONFIGS[name], **kw))


_PAIRS = {}


def _pair(name, seed=0):
    """(flax model, params, batch_stats, port model with them loaded, in
    eval mode), built once per config."""
    if (name, seed) not in _PAIRS:
        jcfg, cfg = _configs(name)
        model = JaxKeypointFormer(jcfg)
        params, bs = random_variables(
            model, np.zeros((1, H, W, 3), np.float32), True, seed=seed)
        port = load_jax_variables(KeypointFormer(cfg), params, bs).eval()
        _PAIRS[(name, seed)] = (model, params, bs, port)
    return _PAIRS[(name, seed)]


def _x(seed, B=2):
    return np.random.RandomState(seed).uniform(-1, 1, (B, H, W, 3)).astype(
        np.float32)


@pytest.mark.parametrize("name", ["tiny", "default"])
def test_forward_matches_flax(name):
    """Every output of the eval forward within 1e-5 (measured 5e-6), and
    ``only_encoder``'s dense VPR map."""
    model, params, bs, port = _pair(name)
    x = _x(1)
    want = apply_jit(model, params, bs, x, train=False)
    with torch.no_grad():
        got = port(nchw(x))
    assert set(got) == set(want) == {"score", "coord", "feat", "seg",
                                     "vlad"}
    for k, v in want.items():
        assert nhwc(got[k]).shape == v.shape, k
        np.testing.assert_allclose(nhwc(got[k]), v, atol=1e-5, err_msg=k)
    enc = apply_jit(model, params, bs, x, train=False, only_encoder=True)
    with torch.no_grad():
        got_enc = port(nchw(x), only_encoder=True)
    np.testing.assert_allclose(nhwc(got_enc), enc, atol=1e-5)


def test_train_mode_bn_statistics_match_flax():
    """A train-mode forward ("tiny"): the outputs (normalised with the
    batch's statistics) within 1e-4 and the running statistics (flax's
    momentum 0.9, biased variance; torch momentum 0.1) within 1e-5."""
    model, params, bs, _ = _pair("tiny")
    _, cfg = _configs("tiny")
    port = load_jax_variables(KeypointFormer(cfg), params, bs).train()
    x = _x(2)
    want, mut = apply_jit(model, params, bs, x, train=True,
                          mutable=["batch_stats"])
    with torch.no_grad():
        got = port(nchw(x))
    for k, v in want.items():
        np.testing.assert_allclose(nhwc(got[k]), v, atol=1e-4, err_msg=k)
    ref = load_jax_variables(KeypointFormer(cfg), params,
                             mut["batch_stats"]).state_dict()
    n = 0
    for k, v in port.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            n += 1
            torch.testing.assert_close(v, ref[k], atol=1e-5, rtol=0)
    assert n == 2 * (4 + 1 + 1 + 1 + 2 + 1)  # every BN of the model


def test_bf16_forward_within_the_flax_bf16_error():
    """"tiny" at bfloat16 (float32 weights, bf16 compute): every output's
    error against flax's float32 answer at most twice flax bf16's plus
    1e-3 (tests/test_torch_port_bf16.py's criterion), and the output
    dtypes are flax's."""
    model, params, bs, _ = _pair("tiny")
    j16cfg, cfg16 = _configs("tiny", "bfloat16")
    x = _x(3, B=1)
    ref = apply_jit(model, params, bs, x, train=False)
    want = apply_jit(JaxKeypointFormer(j16cfg), params, bs, x, train=False)
    port = load_jax_variables(KeypointFormer(cfg16), params, bs).eval()
    with torch.no_grad():
        got = port(nchw(x))
    for k in ref:
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k
        e = float(np.abs(nhwc(got[k].float())
                         - ref[k].astype(np.float32)).max())
        e_jax = float(np.abs(want[k].astype(np.float32) - ref[k]).max())
        assert e <= 2 * e_jax + 1e-3, (k, e, e_jax)


@pytest.mark.parametrize("C", [64, 256])
def test_vladv2_netvlad_and_its_gradients_match_jax(C):
    """The JAX ``NetVLAD(vladv2=True)`` (a learned bias on the assignment
    logits) against the port's module at KeypointFormer's widths (K = 64;
    C = 64 "tiny", 256 "default") on a training shape: the descriptor and
    the gradients of <y, g> with respect to x, W, the centroids and the
    bias (JAX autodiff against the port's autograd through the twin): y,
    dx, dW and dcen within 1e-5 of each one's largest magnitude, db within
    1e-5 of its terms' size (a pixel's dl sums to 0 over the clusters, so
    db's terms cancel: max over k of sum over the pixels of |dl|, dl the
    gradient of a bias given to every pixel)."""
    from nanovs_slam_tpu.modules.aggregators import NetVLAD as JaxNetVLAD

    from nanovs_slam_torch.modules.aggregators import NetVLAD

    K, B, h, w = 64, 2, 13, 17
    rs = np.random.RandomState(C)
    x = rs.randn(B, h, w, C).astype(np.float32)
    p = {"assign_w": (rs.randn(C, K) * 0.3).astype(np.float32),
         "centroids": rs.rand(K, C).astype(np.float32),
         "assign_b": (rs.randn(K) * 0.5).astype(np.float32)}
    g = rs.randn(B, K * C).astype(np.float32)
    mod = JaxNetVLAD(num_clusters=K, dim=C, vladv2=True)

    def f(xx, pp):
        return jnp.sum(mod.apply({"params": pp}, xx) * g)

    y = np.asarray(mod.apply({"params": p}, jnp.asarray(x)))
    dx, dp = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), p)
    port = NetVLAD(K, C, vladv2=True)
    with torch.no_grad():
        for k, v in p.items():
            getattr(port, k).copy_(torch.from_numpy(v))
    xt = nchw(x).requires_grad_()
    yt = port(xt)
    yt.backward(torch.from_numpy(g))
    np.testing.assert_allclose(yt.detach().numpy(), y, atol=1e-5)
    from nanovs_slam_torch.kernels import netvlad_plain

    b_full = port.assign_b.detach().expand(B, h * w, K).clone()
    b_full.requires_grad_()
    dl, = torch.autograd.grad(netvlad_plain(
        torch.from_numpy(x), port.assign_w.detach(),
        port.centroids.detach(), b_full), b_full, torch.from_numpy(g))
    db_scale = dl.abs().sum((0, 1)).max().item()
    pairs = [(nhwc(xt.grad), dx)] + [
        (getattr(port, k).grad.numpy(), dp[k]) for k in p]
    for (got, want), name in zip(pairs, ["x"] + list(p)):
        want = np.asarray(want)
        scale = db_scale if name == "assign_b" else np.abs(want).max()
        assert np.abs(got - want).max() <= 1e-5 * scale, name


def test_postprocess_twin_at_256_channels_matches_jax():
    """KeypointFormer's descriptors reach the postprocess at C = 256 (cell
    8): the twin against the Pallas kernel (interpret mode) and the XLA
    ``post_process``."""
    from nanovs_slam_tpu.ops.pallas.postprocess_kernel import \
        fused_postprocess_pallas
    from nanovs_slam_tpu.ops.postprocess import post_process

    from nanovs_slam_torch.kernels import postprocess_plain

    rs = np.random.RandomState(4)
    cell, C, Hc, Wc = 8, 256, H // 8, W // 8
    score = rs.rand(1, Hc, Wc, 1).astype(np.float32)
    shift = rs.uniform(-1, 1, (1, Hc, Wc, 2)).astype(np.float32)
    feat = rs.randn(1, 2 * Hc, 2 * Wc, C).astype(np.float32)
    got = postprocess_plain(*(torch.from_numpy(a)
                              for a in (score, shift, feat)), H, W, cell)
    pal = fused_postprocess_pallas(jnp.asarray(score), jnp.asarray(shift),
                                   jnp.asarray(feat), H, W, cell,
                                   interpret=True)
    xla = post_process({"score": jnp.asarray(score),
                        "coord": jnp.asarray(shift),
                        "feat": jnp.asarray(feat)}, H, W, cell)
    for want in (pal, (xla["score"], xla["coord"], xla["feat"])):
        np.testing.assert_allclose(got[0].numpy(), want[0], atol=1e-6)
        np.testing.assert_allclose(got[1].numpy(), want[1], atol=1e-4)
        cos = np.sum(got[2].numpy() * np.asarray(want[2]), -1)
        assert cos.min() > 0.99999


@pytest.mark.parametrize("name", ["tiny", "default"])
def test_make_infer_fn_matches_jax(name):
    """``make_infer_fn`` with top_k 100 against the JAX ``make_infer_fn``
    (XLA postprocess) on the same uint8 frames: dense outputs within 1e-4,
    the top-K as sets (assert_dense_outputs_match,
    assert_top_k_match_as_sets). The threshold is the 75th percentile of
    the port's scores inside the border, so that it selects."""
    from nanovs_slam_tpu.inference import make_infer_fn as jax_make_infer_fn
    from nanovs_slam_tpu.ops.image import to_model_input

    from nanovs_slam_torch.inference import make_infer_fn

    model, params, bs, port = _pair(name, seed=5)
    jcfg, cfg = _configs(name)
    frames = np.random.RandomState(6).randint(0, 256, (2, H, W, 3)).astype(
        np.uint8)
    score = make_infer_fn(port, cfg, H, W, device="cpu")(frames)["score"]
    conf = float(np.percentile(score[score > 0].numpy(), 75))
    want = jax_make_infer_fn(model, jcfg, H, W, top_k=100,
                             conf_threshold=conf, use_pallas=False)(
        {"params": params, "batch_stats": bs},
        to_model_input(jnp.asarray(frames)))
    want = {k: np.asarray(v) for k, v in want.items()}
    got = make_infer_fn(port, cfg, H, W, top_k=100, conf_threshold=conf,
                        device="cpu")(frames)
    got = {k: v.numpy() for k, v in got.items()}
    assert got["feat"].shape[-1] == cfg.feat_dim
    assert_dense_outputs_match({k: want[k] for k in want
                                if not k.startswith(("key", "desc"))},
                               {k: got[k] for k in got
                                if not k.startswith(("key", "desc"))})
    _assert_top_k_match(want, got, conf)


def _assert_top_k_match(want, got, conf):
    """The valid keypoints of each image as sets, a keypoint of one side
    matched to the other's within 1e-3 px (coordinates agree to 1e-4; with
    cell 8 their decimals are arbitrary, so rounding them to a grid, as
    ``assert_top_k_match_as_sets`` does, can split a pair); an unmatched
    keypoint scores within 1e-4 of a cut (the threshold or the K-th
    score); matched ones have descriptor cosine > 0.9999."""
    for b in range(want["keypoints"].shape[0]):
        kth = min(want["keypoint_scores"][b][-1],
                  got["keypoint_scores"][b][-1])
        sides = [(o["keypoints"][b][o["keypoint_valid"][b]],
                  o["keypoint_scores"][b][o["keypoint_valid"][b]],
                  o["descriptors"][b][o["keypoint_valid"][b]])
                 for o in (want, got)]
        assert len(sides[0][0]), "no valid keypoints"
        for (kp, sc, de), (kp2, _, de2) in (sides, sides[::-1]):
            d = np.linalg.norm(kp[:, None] - kp2[None], axis=-1)
            near = d.min(1) <= 1e-3 if len(kp2) else np.zeros(len(kp), bool)
            for i in np.flatnonzero(~near):
                assert min(abs(sc[i] - conf), abs(sc[i] - kth)) < 1e-4, \
                    (kp[i], sc[i])
            for i in np.flatnonzero(near):
                j = d[i].argmin()
                assert float(np.dot(de[i], de2[j])) > 0.9999


@pytest.mark.parametrize("hw", [(120, 160), (240, 320)])
def test_frame_sizes_the_jax_model_refuses(hw):
    """At 120x160 (the COCO / Cityscapes trainer's) and 240x320 (the eval
    CLI's default) the JAX model fails at its fused concatenation; the
    port raises ValueError before any work, and the eval CLI exits. The
    96x128 and 256x320 sizes pass."""
    h, w = hw
    jcfg, cfg = _configs("tiny")
    with pytest.raises(Exception):
        jax.eval_shape(lambda: JaxKeypointFormer(jcfg).init(
            jax.random.PRNGKey(0), jnp.zeros((1, h, w, 3))))
    with pytest.raises(ValueError, match="KeypointFormer: H"):
        KeypointFormer(cfg)(torch.zeros(1, 3, h, w))
    from nanovs_slam_torch import eval_multitask

    with pytest.raises(SystemExit, match="the JAX model fails"):
        eval_multitask.main(["--model_type", "KeypointFormer", "--im_h",
                             str(h), "--im_w", str(w), "--device", "cpu"])
    for ok in ((96, 128), (256, 320)):
        check_frame_size(*ok)


# ------------------------------------------------------------ training

LR = 5e-4


def _batch():
    """Synthetic-shapes images, homographies from RandomState(i), the pair
    built by the JAX package's build_pair_batch at KeypointFormer's d_f =
    cell / 2 = 4."""
    from nanovs_slam_tpu.data.homography import sample_homography
    from nanovs_slam_tpu.data.pipeline import build_pair_batch

    from nanovs_slam_torch.data.datasets import SyntheticShapesDataset

    ds = SyntheticShapesDataset((H, W), 2, N_CLASSES, seed=3)
    imgs = np.stack([ds[i]["image"] for i in range(2)])
    segs = np.stack([ds[i]["seg"] for i in range(2)]).astype(np.int32)
    homos = np.stack([sample_homography((H, W), np.random.RandomState(i))
                      for i in range(2)]).astype(np.float32)
    batch = build_pair_batch(jnp.asarray(imgs), jnp.asarray(segs),
                             jnp.asarray(homos), d_f=4)
    return {k: np.asarray(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def one_step():
    """One train step of "tiny" (seeded random variables, the pinned S8
    inlier net, Adam at 5e-4) on the JAX package's ``make_train_step`` and
    the port's, from the same variables and batch."""
    from nanovs_slam_tpu.models.inlier_net import InlierNet as JaxInlierNet
    from nanovs_slam_tpu.train.schedules import DEFAULT_LOSS_WEIGHTS as JW
    from nanovs_slam_tpu.train.train_step import TrainState as JaxTrainState
    from nanovs_slam_tpu.train.train_step import \
        make_optimizer as jax_make_optimizer
    from nanovs_slam_tpu.train.train_step import \
        make_train_step as jax_make_train_step

    from nanovs_slam_torch.models.inlier_net import InlierNet
    from nanovs_slam_torch.train.schedules import DEFAULT_LOSS_WEIGHTS
    from nanovs_slam_torch.train.train_step import (create_train_state,
                                                    make_optimizer,
                                                    make_train_step)
    from nanovs_slam_torch.utils.checkpoint import load_npz_checkpoint
    from nanovs_slam_torch.utils.convert import (load_jax_inlier_net,
                                                 to_jax_variables)

    model, params, bs, _ = _pair("tiny", seed=9)
    jcfg, cfg = _configs("tiny")
    io_tree, _ = load_npz_checkpoint(PINNED)
    io_p, io_bs = io_tree["io_params"], io_tree["io_batch_stats"]
    batch = _batch()
    step = jax_make_train_step(model, jcfg, H, W,
                               io_net=JaxInlierNet(blocks=4), donate=False)
    tx = jax_make_optimizer("adam", LR)
    jstate = JaxTrainState(
        step=jnp.int32(0), params=params, batch_stats=bs, io_params=io_p,
        io_batch_stats=io_bs,
        opt_state=tx.init({"model": params, "io": io_p}), tx=tx)
    jstate, jmet = step(jstate, {k: jnp.asarray(v) for k, v in
                                 batch.items()}, JW, jax.random.PRNGKey(0))
    want = {"metrics": {k: float(v) for k, v in jmet.items()}}
    for k in ("params", "batch_stats"):
        want[k] = jax.tree_util.tree_map(np.asarray, getattr(jstate, k))

    port = load_jax_variables(KeypointFormer(cfg), params, bs)
    io = load_jax_inlier_net(InlierNet(), io_p, io_bs)
    pstate = create_train_state(port, make_optimizer("adam", LR), io_net=io)
    tbatch = {k: torch.tensor(v) for k, v in batch.items()}
    for k in ("seg", "seg_aug"):
        tbatch[k] = tbatch[k].long()
    pstate, pmet = make_train_step(cfg, H, W)(pstate, tbatch,
                                              DEFAULT_LOSS_WEIGHTS)
    got = {"metrics": {k: float(v) for k, v in pmet.items()}}
    got["params"], got["batch_stats"] = to_jax_variables(pstate.model)
    return want, got, pstate


def test_train_step_matches_jax(one_step):
    """Every loss term within 1e-5 relative to max(1, |term|) (the VPR
    term live, so that the NetVLAD backward with its bias is on the step),
    the BN statistics 1e-5, the bias's gradient live. This step is far
    less well conditioned than KP2DTiny's at 48x64: a 1e-7 relative
    perturbation of the images alone moves the port's own grad_norm by
    6.4e-5 relative and single gradients of the MiT's first stage by up to
    2.2e-4, flipping the sign of 5 (the keypoint losses amplify float32
    noise). So grad_norm is held to 1e-3 relative (measured 2.3e-4) and
    the parameters after Adam (which moves each by lr sign(g) at its first
    step) within 1e-5 where |g| >= 1e-6 in the heads and NetVLAD, as
    tests/test_torch_port_train_step.py holds them, but where |g| >= 1e-3
    in the MiT and the fused pyramid's convs (measured: 26 of their 1e5
    weights 2 lr apart, all with |g| <= 2.3e-4); 2 lr everywhere."""
    from nanovs_slam_torch.utils.convert import convert_variables

    want, got, pstate = one_step
    wm, gm = want["metrics"], got["metrics"]
    assert set(wm) == set(gm) and wm["vlad_loss"] > 0.0
    for k in wm:
        if k != "grad_norm":
            assert abs(gm[k] - wm[k]) <= 1e-5 * max(1.0, abs(wm[k])), \
                (k, gm[k], wm[k])
    assert abs(gm["grad_norm"] - wm["grad_norm"]) <= 1e-3 * wm["grad_norm"]
    ref = convert_variables(want["params"], want["batch_stats"])
    for k, p in pstate.model.named_parameters():
        d = (p.detach() - ref[k]).abs()
        floor = 1e-3 if k.startswith(("mit.", "to_fused")) else 1e-6
        live = p.grad.abs() >= floor
        if live.any():
            assert d[live].max().item() <= 1e-5, k
        assert d.max().item() <= 2 * LR, k
    assert float(pstate.model.netvlad.assign_b.grad.abs().max()) > 1e-6
    for k, v in pstate.model.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            torch.testing.assert_close(v, ref[k], atol=1e-5, rtol=0)


def test_checkpoint_has_flax_names_the_jax_loader_reads(one_step, tmp_path):
    """``save_checkpoint`` of the trained state: the JAX ``load_checkpoint``
    reads it, its ``params`` have the flax tree's keys and shapes, and the
    JAX eval forward of it equals the port's (1e-5); the port's restore
    (``--model_path``) loads it back."""
    from nanovs_slam_tpu.utils.checkpoint import load_checkpoint

    from nanovs_slam_torch.utils.checkpoint import (restore_train_state,
                                                    save_checkpoint)
    from nanovs_slam_torch.utils.convert import _flatten

    want, _, pstate = one_step
    path = save_checkpoint(str(tmp_path / "kf"), pstate, epoch=1)
    tree, meta = load_checkpoint(path)
    assert meta["epoch"] == 1
    flat, ref = _flatten(tree["params"]), _flatten(want["params"])
    assert sorted(flat) == sorted(ref)
    assert all(flat[k].shape == ref[k].shape for k in ref)
    model, _, _, _ = _pair("tiny", seed=9)
    x = _x(7, B=1)
    jout = apply_jit(model, tree["params"], tree["batch_stats"], x,
                     train=False)
    port = pstate.model.eval()
    with torch.no_grad():
        pout = port(nchw(x))
    for k, v in jout.items():
        np.testing.assert_allclose(nhwc(pout[k]), v, atol=1e-5, err_msg=k)
    restore_train_state(path, pstate)


def test_eval_cli_on_a_seeded_hpatches_fixture(tmp_path):
    """``eval_multitask --model_type KeypointFormer --config tiny`` on a
    seeded checkpoint and a 1-sequence synthetic HPatches set (written by
    the repo's script) against the root CLI's keypoint branch computed in
    this process (the JAX ``make_infer_fn`` of the same variables, the JAX
    package's reader and ``evaluate_keypoint_net``): repeatability,
    localisation error and matching score within 1e-4, correctness
    equal."""
    from nanovs_slam_tpu.data.hpatches import HPatchesDataset
    from nanovs_slam_tpu.evaluation.keypoints import evaluate_keypoint_net
    from nanovs_slam_tpu.inference import make_infer_fn as jax_make_infer_fn

    from nanovs_slam_torch import eval_multitask
    from nanovs_slam_torch.utils.checkpoint import _write

    hp = tmp_path / "hpatches"
    subprocess.run([sys.executable, os.path.join(
        REPO, "scripts", "make_synthetic_hpatches.py"), str(hp), "--n-seq",
        "1"], check=True, capture_output=True)
    ds_cfg = tmp_path / "datasets.json"
    ds_cfg.write_text(json.dumps({"hpatches_data_path": str(hp)}))
    model, params, bs, _ = _pair("tiny", seed=11)
    ck = _write(str(tmp_path / "kf"), {"params": params, "batch_stats": bs},
                {})
    out = tmp_path / "port.json"
    eval_multitask.main(["--model_type", "KeypointFormer", "--config",
                         "tiny", "--n_classes", str(N_CLASSES),
                         "--model_path", ck, "--im_h", str(H), "--im_w",
                         str(W), "--keypoints", "--max_items", "3",
                         "--top_k", "50", "--dataset_config", str(ds_cfg),
                         "--device", "cpu", "--out", str(out)])
    got = json.loads(out.read_text())["keypoints_top50"]
    jcfg, _ = _configs("tiny")
    infer = jax_make_infer_fn(model, jcfg, H, W, use_pallas=False)
    variables = {"params": params, "batch_stats": bs}
    items = list(HPatchesDataset(str(hp), (W, H)))[:3]
    want = evaluate_keypoint_net(
        items, lambda im: {k: np.asarray(v) for k, v in
                           infer(variables, im).items()},
        output_shape=(W, H), top_k=50)
    want = json.loads(json.dumps(want, default=str))
    assert "error" not in got and got.keys() == want.keys()
    for k in ("repeatability", "localization_error", "mscore"):
        assert abs(got[k] - want[k]) <= 1e-4, (k, got[k], want[k])
    for k in ("correctness1", "correctness3", "correctness5"):
        assert got[k] == want[k], k
