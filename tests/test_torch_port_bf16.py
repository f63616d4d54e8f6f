"""The port at bfloat16 against the JAX package at bfloat16 on the CPU.

The JAX package computes in ``cfg.dtype`` the flax way: float32 parameters
and BN statistics, each layer casting to bfloat16 at use. XLA may keep
excess precision inside its fusions and PyTorch's CPU kernels round at
their own places, so the two bf16 answers are not bit-equal; the whole-path
tests hold them relative to the JAX float32 answer instead: per output, the
port's error against it is at most twice the JAX bf16 answer's own error
plus 1e-3. Each test states its tolerance.

Kernel-bearing modules: the postprocess, NetVLAD and stem twins (the CPU
side of the bf16 kernel instances) against the Pallas kernels in interpret
mode and the flax modules at bf16. Whole paths: ``make_infer_fn`` of config
N (V2) and S_A (V3, attention) against the JAX ``infer``'s kernel branch
(``nanovs_slam_tpu/inference.py:61-67``: the model at bf16, the fused
postprocess decoding in float32). Also: the float32 ``state_dict`` whatever
``cfg.dtype``, the XLA ``post_process``'s bf16 coordinate grid (a
reference behaviour the port does not copy), LightGlue's refusal of bf16
and the VO's uint8 transfer."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from _torch_port_util import apply_jit, nchw, nhwc, random_variables
from nanovs_slam_tpu.configs import V2_CONFIGS, V3_CONFIGS
from nanovs_slam_tpu.configs import get_config as jax_get_config
from nanovs_slam_tpu.models.kp2dtiny import build_model as jax_build_model
from nanovs_slam_tpu.modules.aggregators import NetVLAD as JaxNetVLAD
from nanovs_slam_tpu.modules.backbone import max_pool_2x2
from nanovs_slam_tpu.modules.blocks import ConvBNAct as JaxConvBNAct
from nanovs_slam_tpu.ops.image import quantize_u8 as jax_quantize_u8
from nanovs_slam_tpu.ops.image import to_model_input as jax_to_model_input
from nanovs_slam_tpu.ops.pallas.netvlad_kernel import netvlad_pallas
from nanovs_slam_tpu.ops.pallas.postprocess_kernel import \
    fused_postprocess_pallas
from nanovs_slam_tpu.ops.postprocess import post_process as jax_post_process
from nanovs_slam_tpu.ops.postprocess import \
    top_k_keypoints as jax_top_k_keypoints
from nanovs_slam_torch.configs import get_config
from nanovs_slam_torch.inference import make_infer_fn
from nanovs_slam_torch.kernels import netvlad_plain, postprocess_plain
from nanovs_slam_torch.kernels.stem import stem_plain
from nanovs_slam_torch.matching.configs import LIGHTGLUE_CONFIGS
from nanovs_slam_torch.matching.lightglue import LightGlue
from nanovs_slam_torch.models.kp2dtiny import build_model
from nanovs_slam_torch.modules.blocks import ConvBNAct
from nanovs_slam_torch.ops.image import quantize_u8
from nanovs_slam_torch.ops.postprocess import top_k_keypoints
from nanovs_slam_torch.utils.convert import (convert_variables,
                                             load_jax_variables)
from nanovs_slam_torch.utils.fuse import fold_conv_bn

BF16 = torch.bfloat16


def _bf16(a):
    """numpy float32 -> (torch bf16, jnp bf16) holding the same values."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(BF16)
    return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _err(a, b):
    return float(np.abs(np.asarray(a, np.float32)
                        - np.asarray(b, np.float32)).max())


# ------------------------------------------------- kernel-bearing modules

def test_postprocess_twin_matches_pallas_at_bf16():
    """bfloat16 score, shift and descriptors: the twin and the Pallas
    kernel both read them as float32 and decode in float32, within 1e-5."""
    rs = np.random.RandomState(1)
    B, H, W, cell, C = 2, 64, 96, 4, 32
    Hc, Wc = H // cell, W // cell
    score, jscore = _bf16(rs.rand(B, Hc, Wc, 1))
    shift, jshift = _bf16(rs.uniform(-1, 1, (B, Hc, Wc, 2)))
    feat, jfeat = _bf16(rs.randn(B, 2 * Hc, 2 * Wc, C))
    want = fused_postprocess_pallas(jscore, jshift, jfeat, H, W, cell,
                                    interpret=True)
    got = postprocess_plain(score, shift, feat, H, W, cell)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_netvlad_twin_matches_pallas_and_flax_at_bf16():
    """A bfloat16 x at config N's widths (C = 48, K = 32). The twin rounds
    the normalised x to bf16 as the flax module (which normalises in bf16)
    does, and holds that module's answer within 2e-5 (flax also rounds the
    norm to bf16, so a normalised value may sit one bf16 ulp away), and
    the Pallas kernel's (which normalises in float32 without the rounding)
    within 2e-5."""
    rs = np.random.RandomState(2)
    B, H, W, C, K = 2, 12, 16, 48, 32
    x, jx = _bf16(rs.randn(B, H, W, C))
    mod = JaxNetVLAD(num_clusters=K, dim=C, dtype=jnp.bfloat16)
    params = {"assign_w": (rs.randn(C, K) / np.sqrt(C)).astype(np.float32),
              "centroids": rs.rand(K, C).astype(np.float32)}
    want = np.asarray(mod.apply({"params": params}, jx))
    pal = np.asarray(netvlad_pallas(jx, params["assign_w"],
                                    params["centroids"], interpret=True))
    got = netvlad_plain(x, torch.from_numpy(params["assign_w"]),
                        torch.from_numpy(params["centroids"]))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), pal, atol=2e-5)


class _JaxStem(fnn.Module):
    """conv1a -> conv1b -> 2x2 max-pool of the flax backbone."""
    c1: int
    c2: int
    dtype: object

    @fnn.compact
    def __call__(self, x):
        x = JaxConvBNAct(self.c1, dtype=self.dtype, name="conv1a")(
            x.astype(self.dtype))
        x = JaxConvBNAct(self.c2, dtype=self.dtype, name="conv1b")(x)
        return max_pool_2x2(x)


@pytest.mark.parametrize("c1,c2", [(16, 24), (16, 32), (64, 128)])
def test_stem_twin_matches_flax_chain_at_bf16(c1, c2):
    """The bf16 stem's twin on BN-folded weights against flax's conv1a ->
    conv1b -> max_pool at bf16 (conv, then a float32 BN rounded to bf16).
    Folding BN into bf16 weights rounds elsewhere, so the two bf16 answers
    differ by up to 4 bf16 ulps of the output's largest value; each stays
    as close to the float32 chain as the other: the twin's error against it
    is at most twice flax's bf16 error plus 1e-3."""
    H, W = 48, 64
    x = np.random.RandomState(3).uniform(-1, 1, (2, H, W, 3)).astype(
        np.float32)
    j32, j16 = _JaxStem(c1, c2, jnp.float32), _JaxStem(c1, c2, jnp.bfloat16)
    params, bs = random_variables(j32, x, seed=4)
    ref = apply_jit(j32, params, bs, x)
    want = apply_jit(j16, params, bs, x)

    port = torch.nn.Module()
    port.conv1a, port.conv1b = ConvBNAct(3, c1), ConvBNAct(c1, c2)
    port.load_state_dict(convert_variables(params, bs), strict=False)
    port.eval()
    w1, b1 = fold_conv_bn(port.conv1a.conv, port.conv1a.bn)
    w2, b2 = fold_conv_bn(port.conv1b.conv, port.conv1b.bn)
    with torch.no_grad():
        got = stem_plain(torch.from_numpy(x).to(BF16), w1, b1, w2, b2)
    assert got.dtype == BF16 and tuple(got.shape) == want.shape
    got = got.float().numpy()
    scale = float(np.abs(ref).max())
    assert _err(got, want) <= 4 * 2 ** -8 * scale
    assert _err(got, ref) <= 2 * _err(want, ref) + 1e-3


# ----------------------------------------------------------- whole paths

H, W, B, TOP_K = 64, 96, 2, 100


def _jax_kernel_branch(model, params, bs, cfg, x, conf):
    """The JAX ``infer`` with ``use_pallas``: model.apply, the fused
    postprocess (interpret mode), the class argmax and the top-K, plus the
    top-K's cell indices."""
    out = apply_jit(model, params, bs, x, train=False)
    score, coord, feat = fused_postprocess_pallas(
        jnp.asarray(out["score"]), jnp.asarray(out["coord"]),
        jnp.asarray(out["feat"]), H, W, cfg.cell, cfg.cross_ratio,
        interpret=True)
    kp, s, d, valid, idx = jax_top_k_keypoints(score, coord, feat, TOP_K,
                                               conf, with_indices=True)
    ans = {"score": score, "coord": coord, "feat": feat, "vlad": out["vlad"],
           "seg": np.argmax(np.asarray(out["seg"], np.float32), -1)[..., None],
           "keypoints": kp, "keypoint_scores": s, "descriptors": d,
           "keypoint_valid": valid, "cells": idx}
    return {k: np.asarray(v) for k, v in ans.items()}


@pytest.fixture(scope="module", params=[("N", False), ("S_A", True)],
                ids=["V2-N", "V3-S_A"])
def bf16_answers(request):
    """(JAX float32 answer, JAX bf16 answer, the port's bf16 answer, the
    threshold) of one request at 64x96, 28 classes, seeded random
    variables. The threshold is the 75th percentile of the JAX bf16 scores
    inside the border, so that it selects."""
    name, v3 = request.param
    kw = dict(v3=v3, n_classes=28)
    j32 = jax_build_model(jax_get_config(name, **kw))
    j16 = jax_build_model(jax_get_config(name, dtype="bfloat16", **kw))
    params, bs = random_variables(j32, np.zeros((1, H, W, 3), np.float32),
                                  True, seed=21)
    frames = np.random.RandomState(22).randint(0, 256, (B, H, W, 3)).astype(
        np.uint8)
    x = np.asarray(jax_to_model_input(jnp.asarray(frames)))
    cfg = get_config(name, dtype="bfloat16", **kw)
    raw = apply_jit(j16, params, bs, x, train=False)["score"].astype(
        np.float32)[:, 1:-1, 1:-1]
    conf = float(np.percentile(raw, 75))
    ref = _jax_kernel_branch(j32, params, bs, cfg, x, conf)
    want = _jax_kernel_branch(j16, params, bs, cfg, x, conf)
    port = load_jax_variables(build_model(cfg), params, bs)
    got = make_infer_fn(port, cfg, H, W, top_k=TOP_K, conf_threshold=conf,
                        device="cpu")(frames)
    got["cells"] = top_k_keypoints(got["score"], got["coord"], got["feat"],
                                   TOP_K, conf, with_indices=True)[-1]
    got = {k: v.float().numpy() if v.is_floating_point() else v.numpy()
           for k, v in got.items()}
    return ref, want, got, conf


def test_bf16_dense_outputs_within_the_jax_bf16_error(bf16_answers):
    """score, coord, descriptors and vlad: the port's error against the JAX
    float32 answer is at most twice the JAX bf16 answer's plus 1e-3; the
    class map agrees with the JAX bf16 one no less than that one agrees
    with the float32 map, minus one point."""
    ref, want, got, _ = bf16_answers
    assert set(got) == set(want)
    for k in ("score", "coord", "feat", "vlad"):
        assert got[k].shape == want[k].shape, k
        assert _err(got[k], ref[k]) <= 2 * _err(want[k], ref[k]) + 1e-3, k
    agree_jax = np.mean(want["seg"] == ref["seg"])
    assert np.mean(got["seg"] == want["seg"]) >= agree_jax - 0.01


def test_bf16_top_k_differs_only_at_the_cut(bf16_answers):
    """The selected cells of each image: a cell selected on one side only
    scores within the score tolerance (twice the JAX bf16 score error plus
    1e-3) of a cut, the threshold or the K-th score; the cells both select
    have descriptors within the descriptors' tolerance."""
    ref, want, got, conf = bf16_answers
    tol = 2 * _err(want["score"], ref["score"]) + 1e-3
    dtol = 2 * _err(want["feat"], ref["feat"]) + 1e-3
    for b in range(B):
        sides = []
        for out in (want, got):
            valid = out["keypoint_valid"][b]
            sides.append(dict(zip(out["cells"][b][valid],
                                  out["descriptors"][b][valid])))
        assert sides[0], "no valid keypoints: the test input is too weak"
        kth = min(want["keypoint_scores"][b][-1],
                  got["keypoint_scores"][b][-1])
        for cell in sides[0].keys() ^ sides[1].keys():
            for out in (want, got):
                s = out["score"][b].reshape(-1)[cell]
                assert min(abs(s - conf), abs(s - kth)) <= tol, (cell, s)
        for cell in sides[0].keys() & sides[1].keys():
            assert _err(sides[0][cell], sides[1][cell]) <= dtol


def test_post_process_decodes_on_a_bf16_grid():
    """A reference behaviour the port does not copy: the XLA
    ``post_process`` that ``__graft_entry__.entry()`` runs builds its cell
    grid in the shift's dtype (``ops/grid.py:36``) and decodes in it, so at
    bf16 the decoded x lies on bf16's grid (1 px in [128, 256), 2 px from
    256), more than half a pixel and at most one such ulp off the kernel
    branch's float32 decode at W = 320. The port decodes in float32 as the
    kernel branch does (1e-5)."""
    rs = np.random.RandomState(5)
    Hh, Ww, cell = 32, 320, 4
    Hc, Wc = Hh // cell, Ww // cell
    score, jscore = _bf16(rs.rand(1, Hc, Wc, 1))
    shift, jshift = _bf16(rs.uniform(-1, 1, (1, Hc, Wc, 2)))
    feat, jfeat = _bf16(rs.randn(1, 2 * Hc, 2 * Wc, 8))
    xla = jax_post_process({"score": jscore, "coord": jshift,
                            "feat": jfeat}, Hh, Ww, cell)["coord"]
    assert xla.dtype == jnp.bfloat16
    xla = np.asarray(xla, np.float32)
    kernel = np.asarray(fused_postprocess_pallas(
        jscore, jshift, jfeat, Hh, Ww, cell, interpret=True)[1])
    far = kernel[..., 0] >= 256
    assert far.any() and np.all(xla[..., 0][far] % 2 == 0)
    gap = np.abs(xla - kernel).max()
    assert 0.5 < gap <= 2.0
    port = postprocess_plain(score, shift, feat, Hh, Ww, cell)[1].numpy()
    np.testing.assert_allclose(port, kernel, atol=1e-5)


# ------------------------------------------------------------- the rest

def test_state_dict_stays_float32_at_bf16():
    """Loading the same flax variables gives the same float32 state_dict
    for cfg.dtype float32 and bfloat16, and a bf16 forward leaves it so."""
    cfg32, cfg16 = (get_config("S_A", v3=True, n_classes=5, dtype=d)
                    for d in ("float32", "bfloat16"))
    params, bs = random_variables(jax_build_model(jax_get_config(
        "S_A", v3=True, n_classes=5)), np.zeros((1, 32, 32, 3), np.float32),
        True, seed=7)
    m32, m16 = (load_jax_variables(build_model(c), params, bs).eval()
                for c in (cfg32, cfg16))
    with torch.no_grad():
        out = m16(torch.zeros(1, 3, 32, 32))
    assert out["score"].dtype == BF16
    sd32, sd16 = m32.state_dict(), m16.state_dict()
    assert sd32.keys() == sd16.keys()
    for k, v in sd16.items():
        assert v.dtype == sd32[k].dtype, k
        assert v.dtype in (torch.float32, torch.int64), k
        torch.testing.assert_close(v, sd32[k], atol=0, rtol=0)


@pytest.mark.parametrize("v3", [False, True], ids=["V2", "V3"])
def test_every_config_builds_at_bf16(v3):
    """No dtype refusal is left in the extractor family."""
    for name in (V3_CONFIGS if v3 else V2_CONFIGS):
        model = build_model(get_config(name, v3=v3, n_classes=5,
                                       dtype="bfloat16"))
        assert model.backbone.conv1a.conv.compute_dtype == BF16


def test_bf16_forward_matches_flax_relative_to_float32():
    """One forward of config D (V2, attention at c5 = 256, ConvAP) at
    48x64: every output's error against flax at float32 is at most twice
    flax bf16's plus 1e-3, and the output dtypes are flax's."""
    Hh, Ww = 48, 64
    kw = dict(n_classes=5)
    j32 = jax_build_model(jax_get_config("D", **kw))
    j16 = jax_build_model(jax_get_config("D", dtype="bfloat16", **kw))
    params, bs = random_variables(j32, np.zeros((1, Hh, Ww, 3), np.float32),
                                  True, seed=8)
    x = np.random.RandomState(9).uniform(-1, 1, (1, Hh, Ww, 3)).astype(
        np.float32)
    ref = apply_jit(j32, params, bs, x, train=False)
    want = apply_jit(j16, params, bs, x, train=False)
    port = load_jax_variables(build_model(get_config("D", dtype="bfloat16",
                                                     **kw)), params, bs)
    with torch.no_grad():
        got = port.eval()(nchw(x))
    for k in ref:
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k
        g = nhwc(got[k].float())
        assert _err(g, ref[k]) <= 2 * _err(want[k], ref[k]) + 1e-3, k


def test_lightglue_still_refuses_bf16():
    """LightGlue takes bfloat16 since it was ported (it raised here
    before; its parity is test_torch_port_lightglue.py::
    test_lightglue_bf16_matches_flax_bf16): its Dense layers and LayerNorm
    compute in bf16 over float32 parameters, the stack is the plain blocks
    on every device; a dtype the JAX package has no use for (float16)
    raises."""
    cfg = dataclasses.replace(LIGHTGLUE_CONFIGS["kp2dtiny_S"],
                              dtype="bfloat16")
    lg = LightGlue(cfg)
    assert lg.transformers_0.self_attn.Wqkv.compute_dtype == torch.bfloat16
    assert lg.transformers_0.self_attn.ffn.norm.compute_dtype \
        == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in lg.parameters())
    assert not lg.kernel_allowed(torch.zeros(1, 2, 32, device="meta"))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        LightGlue(dataclasses.replace(cfg, dtype="float16"))


def test_quantize_u8_matches_jax():
    """The VO's uint8 transfer: the same bytes as the JAX package's
    ``quantize_u8``, ties to even included."""
    rs = np.random.RandomState(10)
    f = np.concatenate([rs.rand(1000), np.arange(256) / 255.0,
                        (np.arange(255) + 0.5) / 255.0, [-0.1, 1.2]])
    f = f.astype(np.float32)
    np.testing.assert_array_equal(quantize_u8(torch.from_numpy(f)).numpy(),
                                  jax_quantize_u8(f))


def test_jax_bf16_inputs_survive_the_jit():
    """The helpers pass bf16 arrays through ``jax.jit`` unchanged (a guard
    for the comparisons above)."""
    a = jnp.asarray(np.linspace(-1, 1, 7), jnp.bfloat16)
    assert jax.jit(lambda v: v)(a).dtype == jnp.bfloat16


def test_bf16_extractor_feeds_float32_lightglue():
    """matching.pair with pinned S8 at bf16 in front of the float32 pinned
    LightGlue (the match path's pair, 240x320, 512 keypoints): the
    extractor hands float32 keypoints and descriptors to the matcher, and
    the pair keeps most of its matches: their count within 10% and their
    precision against the homography (3 px) within 0.1 of the float32
    extractor's (336 matches at 0.714 against 358 at 0.768: LightGlue
    sees the bf16 model's descriptors)."""
    import os

    from nanovs_slam_torch.matching.extractor import \
        gt_matches_from_homography
    from nanovs_slam_torch.matching.pair import make_pair_matcher
    from nanovs_slam_torch.matching.synthetic import (HOMOGRAPHY,
                                                      textured_frame,
                                                      warp_frame)
    from nanovs_slam_torch.utils.checkpoint import load_npz_checkpoint
    from nanovs_slam_torch.utils.convert import load_jax_lightglue

    pinned = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "pinned")
    tree, _ = load_npz_checkpoint(os.path.join(pinned, "extractor_S8.npz"))
    lg_tree, meta = load_npz_checkpoint(os.path.join(pinned,
                                                     "lightglue_S.npz"))
    lg = load_jax_lightglue(LightGlue(LIGHTGLUE_CONFIGS[
        meta["config"]["lg_config"]]), lg_tree["params"]).eval()
    Hh, Ww, K = 240, 320, 512
    img0 = textured_frame(Hh, Ww, 300)
    x0, x1 = img0[None] * 2 - 1, warp_frame(img0, HOMOGRAPHY)[None] * 2 - 1
    result = {}
    for dtype in ("float32", "bfloat16"):
        cfg = get_config("S", n_classes=8, dtype=dtype)
        ex = load_jax_variables(build_model(cfg), tree["params"],
                                tree["batch_stats"])
        out = make_pair_matcher(ex, cfg, lg, Hh, Ww, max_keypoints=K,
                                device="cpu")(x0, x1)
        assert out["keypoints0"].dtype == torch.float32
        m0 = out["matches0"][0].numpy()
        _, gt0, _ = gt_matches_from_homography(
            out["keypoints0"][0].numpy(), out["keypoints1"][0].numpy(),
            HOMOGRAPHY, out["mask0"][0].numpy(), out["mask1"][0].numpy())
        n = int((m0 > -1).sum())
        result[dtype] = (n, float((m0[m0 > -1] == gt0[m0 > -1]).mean()))
    (n32, p32), (n16, p16) = result["float32"], result["bfloat16"]
    assert n32 > 100 and abs(n16 - n32) <= 0.1 * n32, result
    assert p16 >= p32 - 0.1, result
