"""The port's modules (nanovs_slam_torch) against the flax modules on the
CPU: weights carried across by nanovs_slam_torch.utils.convert, inputs made
with numpy from a seed. Tolerance atol 1e-4 on every output (float32, sums
in another order)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanovs_slam_tpu.configs import get_config as jax_get_config
from nanovs_slam_tpu.models.kp2dtiny import build_model as jax_build_model
from nanovs_slam_tpu.models.kp2dtiny import init_model as jax_init_model
from nanovs_slam_torch.configs import get_config
from nanovs_slam_torch.models.kp2dtiny import build_model, init_model
from nanovs_slam_torch.utils.checkpoint import load_npz_checkpoint
from nanovs_slam_torch.utils.convert import (convert_variables,
                                             load_jax_variables)

ATOL = 1e-4
PINNED = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "pinned", "extractor_S8.npz")


def _perturb_stats(batch_stats, seed):
    """Random BN running stats, so that eval-mode BN is not the identity."""
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, v: (rs.uniform(0.5, 1.5, v.shape) if p[-1].key == "var"
                      else rs.randn(*v.shape) * 0.1).astype(np.float32),
        batch_stats)


def _jax_variables(cfg, H, W, seed=0):
    model = jax_build_model(cfg)
    params, bs = jax_init_model(model, jax.random.PRNGKey(seed), (1, H, W, 3))
    params = jax.tree_util.tree_map(np.asarray, params)
    return model, params, _perturb_stats(bs, seed + 1)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _compare(jax_out, torch_out):
    for k, v in jax_out.items():
        t = torch_out[k].detach().numpy()
        if t.ndim == 4:
            t = t.transpose(0, 2, 3, 1)
        np.testing.assert_allclose(t, np.asarray(v), atol=ATOL, err_msg=k)


@pytest.mark.parametrize("name,to_mcu", [("N", False), ("N", True),
                                         ("S", False)])
def test_model_matches_flax(name, to_mcu):
    H, W = 48, 64
    jcfg = jax_get_config(name, n_classes=5, to_mcu=to_mcu)
    model, params, bs = _jax_variables(jcfg, H, W)
    x = np.random.RandomState(3).uniform(-1, 1, (2, H, W, 3)).astype(
        np.float32)
    want = model.apply({"params": params, "batch_stats": bs},
                       jnp.asarray(x), False)
    port = build_model(get_config(name, n_classes=5, to_mcu=to_mcu))
    load_jax_variables(port, params, bs).eval()
    with torch.no_grad():
        got = port(_nchw(x))
    assert set(got) == set(want)
    _compare(want, got)


def test_only_encoder_matches_flax():
    H, W = 48, 64
    jcfg = jax_get_config("N", n_classes=4)
    model, params, bs = _jax_variables(jcfg, H, W, seed=5)
    x = np.random.RandomState(4).uniform(-1, 1, (1, H, W, 3)).astype(
        np.float32)
    want = model.apply({"params": params, "batch_stats": bs},
                       jnp.asarray(x), False, only_encoder=True)
    port = load_jax_variables(build_model(get_config("N", n_classes=4)),
                              params, bs).eval()
    with torch.no_grad():
        got = port(_nchw(x), only_encoder=True)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                               np.asarray(want), atol=ATOL)


def test_pinned_s8_matches_flax():
    """The pinned S8 checkpoint (trained at 96x128) through both packages.
    The vlad head is replaced by flax-random params on both sides, as a
    checkpoint without it would be (absent_heads path)."""
    tree, meta = load_npz_checkpoint(PINNED)
    assert meta["config"]["model_config"] == "S"
    H, W = 96, 128
    jcfg = jax_get_config("S", n_classes=8)
    model = jax_build_model(jcfg)
    init_p, _ = jax_init_model(model, jax.random.PRNGKey(7), (1, H, W, 3))
    params = dict(tree["params"])
    params["vlad_head"] = jax.tree_util.tree_map(np.asarray,
                                                 init_p["vlad_head"])
    bs = tree["batch_stats"]
    x = np.random.RandomState(8).uniform(-1, 1, (1, H, W, 3)).astype(
        np.float32)
    want = model.apply({"params": params, "batch_stats": bs},
                       jnp.asarray(x), False)

    port = init_model(get_config("S", n_classes=8),
                      torch.Generator().manual_seed(0), "cpu")
    no_vlad = {k: v for k, v in tree["params"].items() if k != "vlad_head"}
    load_jax_variables(port, no_vlad, bs, absent_heads=("vlad_head",))
    vlad_sd = convert_variables({"vlad_head": params["vlad_head"]}, {})
    port.load_state_dict(vlad_sd, strict=False)
    with torch.no_grad():
        got = port(_nchw(x))
    _compare(want, got)


def test_convert_rejects_unmatched_keys():
    port = build_model(get_config("N", n_classes=3))
    _, params, bs = _jax_variables(jax_get_config("N", n_classes=3), 48, 64)
    partial = {k: v for k, v in params.items() if k != "seg_head"}
    with pytest.raises(KeyError, match="seg_head"):
        load_jax_variables(port, partial, bs)
    extra = dict(params, bogus={"kernel": np.zeros((3, 3, 1, 1), np.float32)})
    with pytest.raises(KeyError, match="bogus"):
        load_jax_variables(port, extra, bs)
    # a head the caller names as absent may be missing
    bs_no_seg = {k: v for k, v in bs.items() if k != "seg_head"}
    load_jax_variables(port, partial, bs_no_seg, absent_heads=("seg_head",))


def test_pinned_s8_loads_every_array():
    """All 182 arrays of the pinned file (183 entries with __meta__): the
    extractor's params and batch_stats map onto config S with no key left
    over; the rest are the inlier network's."""
    with np.load(PINNED) as z:
        assert len(z.files) == 183 and "__meta__" in z.files
    tree, _ = load_npz_checkpoint(PINNED)
    sd = convert_variables(tree["params"], tree["batch_stats"])
    port = build_model(get_config("S", n_classes=8))
    load_jax_variables(port, tree["params"], tree["batch_stats"])
    n_io = sum(1 for k in ("io_params", "io_batch_stats")
               for _ in jax.tree_util.tree_leaves(tree[k]))
    assert len(sd) + n_io == 182


def test_blocks_functions_match_flax():
    from nanovs_slam_tpu.modules import blocks as jb

    from nanovs_slam_torch.modules import blocks as tb

    rs = np.random.RandomState(10)
    x = rs.randn(2, 8, 12, 6).astype(np.float32)
    x[0, 0, 0] = 0.0  # the eps branch of l2_normalize
    np.testing.assert_allclose(
        tb.l2_normalize(torch.from_numpy(x), dim=-1).numpy(),
        np.asarray(jb.l2_normalize(jnp.asarray(x), axis=-1)), atol=1e-6)
    np.testing.assert_array_equal(
        tb.pixel_unshuffle(torch.from_numpy(x), 2).numpy(),
        np.asarray(jb.pixel_unshuffle(jnp.asarray(x), 2)))
