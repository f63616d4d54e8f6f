"""The port's kernels: each plain twin against the JAX function on the CPU,
and each CUDA kernel against its twin on the card.

The JAX package is imported inside the tests that need it, so that this
file also runs where only the port is installed (on the card:
``python -m pytest --noconftest tests/test_torch_port_kernels.py``); there
the JAX tests skip. The card tests skip where CUDA is absent.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from nanovs_slam_torch.kernels import (fused_postprocess,
                                       fused_stem_pair_pool, netvlad,
                                       netvlad_backward,
                                       netvlad_backward_plain, netvlad_plain,
                                       netvlad_residuals, postprocess_plain,
                                       stem_plain)
from nanovs_slam_torch.kernels.stem import SUPPORTED


def _jnp():
    pytest.importorskip("jax")
    pytest.importorskip("flax")
    import jax.numpy as jnp
    return jnp


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _pp_inputs(B, H, W, cell, C=32, seed=1, edge_shifts=False):
    """With ``edge_shifts`` a third of the shifts are exactly -1 or 1, the
    most a tanh head gives, which puts coordinates of the border cells on
    the image's edge (the clip) and their samples on the map's last row or
    column."""
    rs = np.random.RandomState(seed)
    Hc, Wc = H // cell, W // cell
    score = rs.rand(B, Hc, Wc, 1).astype(np.float32)
    shift = (rs.rand(B, Hc, Wc, 2).astype(np.float32) * 2 - 1)
    if edge_shifts:
        pick = rs.rand(B, Hc, Wc, 2) < 1 / 3
        shift[pick] = np.sign(shift[pick])
    feat = rs.randn(B, 2 * Hc, 2 * Wc, C).astype(np.float32)
    return score, shift, feat


def _stem_inputs(B, H, W, c1, c2, seed=0):
    """conv2's weights at 0.1 for C1 = 16 and scaled as 1/sqrt(C1) beyond,
    so that its outputs keep their spread at every width."""
    rs = np.random.RandomState(seed)
    x = rs.randn(B, H, W, 3).astype(np.float32)
    w1 = rs.randn(3, 3, 3, c1).astype(np.float32) * 0.2  # HWIO
    b1 = rs.randn(c1).astype(np.float32) * 0.1
    w2 = rs.randn(3, 3, c1, c2).astype(np.float32) * (0.1 * (16 / c1) ** 0.5)
    b2 = rs.randn(c2).astype(np.float32) * 0.1
    return x, w1, b1, w2, b2


def _oihw(w):
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


def _cos_min(a, b):
    return float(np.sum(np.asarray(a) * np.asarray(b), -1).min())


# --------------------------------------------------------------- postprocess

@pytest.mark.parametrize("H,W,cell", [(96, 128, 4), (64, 128, 8)])
def test_postprocess_plain_matches_pallas_and_post_process(H, W, cell):
    jnp = _jnp()
    from nanovs_slam_tpu.ops.pallas.postprocess_kernel import \
        fused_postprocess_pallas
    from nanovs_slam_tpu.ops.postprocess import post_process

    score, shift, feat = _pp_inputs(2, H, W, cell)
    k_score, k_coord, k_desc = fused_postprocess_pallas(
        jnp.asarray(score), jnp.asarray(shift), jnp.asarray(feat), H, W,
        cell, interpret=True)
    ref = post_process({"score": jnp.asarray(score),
                        "coord": jnp.asarray(shift),
                        "feat": jnp.asarray(feat)}, H, W, cell)
    t_score, t_coord, t_desc = postprocess_plain(
        torch.from_numpy(score), torch.from_numpy(shift),
        torch.from_numpy(feat), H, W, cell)
    for want_score, want_coord, want_desc in (
            (k_score, k_coord, k_desc),
            (ref["score"], ref["coord"], ref["feat"])):
        np.testing.assert_allclose(t_score.numpy(), np.asarray(want_score),
                                   atol=1e-6)
        np.testing.assert_allclose(t_coord.numpy(), np.asarray(want_coord),
                                   atol=1e-4)
        assert _cos_min(t_desc.numpy(), want_desc) > 0.99999


def test_postprocess_wrapper_checks_inputs():
    score, shift, feat = (torch.from_numpy(a)
                          for a in _pp_inputs(1, 32, 48, 4))
    with pytest.raises(ValueError, match="shapes"):
        fused_postprocess(score, shift[..., :1].contiguous(), feat, 32, 48,
                          4)
    with pytest.raises(ValueError, match="NHWC"):
        fused_postprocess(score, shift, feat[:, ::2], 32, 48, 4)
    before = fused_postprocess.launches
    fused_postprocess(score, shift, feat, 32, 48, 4)
    assert fused_postprocess.launches == before  # the twin is no launch


# ---------------------------------------------------------------------- stem

@pytest.mark.parametrize("shape,c1,c2", [((2, 48, 64), 16, 24),
                                         ((1, 32, 48), 16, 32),
                                         ((1, 32, 48), 64, 128),
                                         ((1, 33, 47), 16, 24)])
def test_stem_plain_matches_xla_chain(shape, c1, c2):
    jnp = _jnp()
    import jax
    from flax import linen as nn

    x, w1, b1, w2, b2 = _stem_inputs(*shape, c1, c2)
    dn = ("NHWC", "HWIO", "NHWC")
    y = jax.lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(w1),
                                     (1, 1), "SAME",
                                     dimension_numbers=dn) + b1
    y = jnp.where(y > 0, y, 0.01 * y)
    y = jax.lax.conv_general_dilated(y, jnp.asarray(w2), (1, 1), "SAME",
                                     dimension_numbers=dn) + b2
    y = jnp.where(y > 0, y, 0.01 * y)
    want = nn.max_pool(y, (2, 2), (2, 2))
    got = fused_stem_pair_pool(torch.from_numpy(x), _oihw(w1),
                               torch.from_numpy(b1), _oihw(w2),
                               torch.from_numpy(b2))
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def _tf32(a):
    """``cvt.rna.tf32.f32``: round to nearest, ties away from zero, to a
    10-bit mantissa (the low 13 bits of a float32 cleared)."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    mag = ((u & 0x7FFFFFFF).astype(np.uint64) + 0x1000) & 0x7FFFE000
    return ((u & 0x80000000) | mag).astype(np.uint32).view(np.float32)


@pytest.mark.parametrize("c1,c2", SUPPORTED)
def test_stem_conv2_needs_3xtf32_for_float32_accuracy(c1, c2):
    """Why ``csrc/stem.cu`` runs conv2 on the tensor cores in 3xTF32 and not
    in plain TF32: conv2 as an im2col product at 48x64 and the card test's
    weight scales, with TF32 roundings emulated, against float64. 3xTF32
    (a_lo b_hi + a_hi b_lo + a_hi b_hi, x = hi + lo) holds the stem's 1e-5;
    plain TF32 misses the 1e-4 the slice keeps against the CPU."""
    x, w1, b1, w2, b2 = _stem_inputs(1, 48, 64, c1, c2)
    y1 = F.leaky_relu(F.conv2d(
        torch.from_numpy(x).double().permute(0, 3, 1, 2),
        _oihw(w1).double(), torch.from_numpy(b1).double(), padding=1), 0.01)
    a = F.unfold(y1.float(), 3, padding=1)[0].T.numpy()  # (48*64, 9*c1)
    b = _oihw(w2).reshape(c2, 9 * c1).T.numpy()
    want = a.astype(np.float64) @ b.astype(np.float64)

    def split(m):
        hi = _tf32(m)
        return hi.astype(np.float64), _tf32(m - hi).astype(np.float64)

    (ah, al), (bh, bl) = split(a), split(b)
    three = (al @ bh + ah @ bl + ah @ bh).astype(np.float32)
    plain = (ah @ bh).astype(np.float32)
    assert np.abs(three - want).max() <= 1e-5
    assert np.abs(plain - want).max() > 1e-4


def test_fold_conv_bn_matches_jax_fold_batchnorm():
    _jnp()
    from nanovs_slam_tpu.utils.fuse import fold_batchnorm

    from nanovs_slam_torch.modules.blocks import ConvBNAct
    from nanovs_slam_torch.utils.fuse import fold_conv_bn

    rs = np.random.RandomState(4)
    kernel = rs.randn(3, 3, 5, 7).astype(np.float32)
    scale, bias, mean = (rs.randn(7).astype(np.float32) for _ in range(3))
    var = rs.uniform(0.5, 2.0, 7).astype(np.float32)
    fp, _ = fold_batchnorm({"conv": {"kernel": kernel},
                            "bn": {"scale": scale, "bias": bias}},
                           {"bn": {"mean": mean, "var": var}})
    blk = ConvBNAct(5, 7)
    blk.conv.weight.data = torch.from_numpy(
        kernel.transpose(3, 2, 0, 1).copy())
    for attr, v in (("weight", scale), ("bias", bias),
                    ("running_mean", mean), ("running_var", var)):
        getattr(blk.bn, attr).data = torch.from_numpy(v)
    w, b = fold_conv_bn(blk.conv, blk.bn)
    np.testing.assert_allclose(w.detach().numpy(),
                               fp["conv"]["kernel"].transpose(3, 2, 0, 1),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(b.detach().numpy(), fp["bn"]["bias"],
                               rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------------- netvlad

@pytest.mark.parametrize("C,K", [(48, 32), (64, 64), (128, 64)])
def test_netvlad_plain_matches_pallas_and_module(C, K):
    """At the widths of configs N, S and F."""
    jnp = _jnp()
    import jax
    from nanovs_slam_tpu.modules.aggregators import NetVLAD as JaxNetVLAD
    from nanovs_slam_tpu.ops.pallas.netvlad_kernel import netvlad_pallas

    from nanovs_slam_torch.modules.aggregators import NetVLAD

    rs = np.random.RandomState(2)
    B, H, W = 2, 12, 16
    x = rs.randn(B, H, W, C).astype(np.float32)
    mod = JaxNetVLAD(num_clusters=K, dim=C)
    params = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    ref = np.asarray(mod.apply({"params": params}, jnp.asarray(x)))
    pal = np.asarray(netvlad_pallas(jnp.asarray(x), params["assign_w"],
                                    params["centroids"], interpret=True))
    aw = torch.from_numpy(np.array(params["assign_w"]))
    cen = torch.from_numpy(np.array(params["centroids"]))
    got = netvlad_plain(torch.from_numpy(x), aw, cen).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5)
    np.testing.assert_allclose(got, pal, atol=2e-5)

    port = NetVLAD(K, C)
    port.assign_w.data, port.centroids.data = aw, cen
    with torch.no_grad():
        got_mod = port(torch.from_numpy(
            np.ascontiguousarray(x.transpose(0, 3, 1, 2)))).numpy()
    np.testing.assert_allclose(got_mod, ref, atol=2e-5)


def test_netvlad_init_params_from_clusters_matches_jax():
    _jnp()
    from nanovs_slam_tpu.modules.aggregators import NetVLAD as JaxNetVLAD

    from nanovs_slam_torch.modules.aggregators import NetVLAD

    rs = np.random.RandomState(6)
    clsts, descs = rs.randn(8, 16), rs.randn(100, 16)
    for a, b in zip(NetVLAD.init_params_from_clusters(clsts, descs),
                    JaxNetVLAD.init_params_from_clusters(clsts, descs)):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------- kernels on a card

@pytest.mark.parametrize("B,H,W,C", [
    (1, 240, 320, 32), (8, 240, 320, 32), (1, 240, 320, 64),
    (2, 240, 320, 128), (2, 244, 332, 32)])
def test_postprocess_kernel_matches_plain(cuda, B, H, W, C):
    """The N slice at B 1 and 8, config F's C = 64, the most channels
    (128) and a ragged cell grid (61x83), with shifts of exactly +-1 (the
    clip at the border), for NCHW and NHWC memory of every input."""
    cell = 4
    score, shift, feat = (torch.from_numpy(a).to(cuda) for a in _pp_inputs(
        B, H, W, cell, C, edge_shifts=True))
    want = postprocess_plain(score, shift, feat, H, W, cell)

    def nchw(t):  # the model hands the kernel NHWC views of NCHW outputs
        return t.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)

    for args in ((score, shift, feat), (nchw(score), nchw(shift), nchw(feat))):
        got = fused_postprocess(*args, H, W, cell)
        torch.cuda.synchronize()
        torch.testing.assert_close(got[0], want[0], atol=1e-5, rtol=0)
        torch.testing.assert_close(got[1], want[1], atol=1e-5, rtol=0)
        assert (got[2] * want[2]).sum(-1).min().item() > 0.99999


@pytest.mark.parametrize("B,H,W,c2,slope", [
    (1, 240, 320, 24, 0.01), (8, 240, 320, 24, 0.01), (2, 240, 320, 32, 0.01),
    (2, 250, 334, 24, 0.01), (2, 250, 334, 32, 0.0), (1, 96, 128, 32, 0.01),
    (1, 240, 320, 24, 0.0), (2, 48, 64, 128, 0.01), (1, 250, 334, 128, 0.0),
    (2, 241, 321, 24, 0.01), (1, 241, 321, 32, 0.01), (1, 241, 321, 128, 0.01),
    (1, 49, 64, 24, 0.01), (1, 48, 65, 128, 0.0), (1, 240, 320, 128, 0.01),
    (8, 240, 320, 128, 0.01), (3, 240, 320, 128, 0.0)])
def test_stem_kernel_matches_plain(cuda, B, H, W, c2, slope):
    """The N slice at B 1 and 8, the S widths, a ragged size whose pooled
    grid (125x167) fills no tile, the weights phase's 96x128, the ReLU
    (slope 0) of the MCU configs, config D's (64, 128) at a small size, a
    ragged one, the D cell's 240x320 at B 1 and 8 and at B 3 (1,800 tiles:
    the persistent blocks' last round part full), and odd frame sizes
    (floor pooling) at all three widths, for NHWC memory and the NHWC view
    of NCHW memory that the model passes."""
    c1 = 64 if c2 == 128 else 16
    x, w1, b1, w2, b2 = _stem_inputs(B, H, W, c1, c2)
    args = [_oihw(w1), torch.from_numpy(b1), _oihw(w2), torch.from_numpy(b2)]
    args = [a.to(cuda) for a in args]
    x = torch.from_numpy(x).to(cuda)
    want = stem_plain(x, *args, slope)
    for xv in (x, x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)):
        got = fused_stem_pair_pool(xv, *args, slope)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("B,C,K,H,W", [
    (1, 48, 32, 60, 80), (8, 48, 32, 60, 80), (1, 64, 64, 60, 80),
    (2, 128, 64, 30, 40), (1, 48, 32, 37, 53)])
def test_netvlad_kernel_matches_plain(cuda, B, C, K, H, W):
    """Config N (B 1, 8), S and F widths and a ragged image, each for the
    NCHW view and NHWC memory, then the view again: a launch reuses the
    scratch (and the zeroed counters) the last one left."""
    rs = np.random.RandomState(9)
    x = torch.from_numpy(rs.randn(B, C, H, W).astype(np.float32)).to(cuda)
    aw = torch.from_numpy(rs.randn(C, K).astype(np.float32)).to(cuda)
    cen = torch.from_numpy(rs.rand(K, C).astype(np.float32)).to(cuda)
    x_nhwc = x.permute(0, 2, 3, 1)
    want = netvlad_plain(x_nhwc, aw, cen)
    for xv in (x_nhwc, x_nhwc.contiguous(), x_nhwc):
        before = netvlad.launches
        got = netvlad(xv, aw, cen)
        torch.cuda.synchronize()
        assert netvlad.launches == before + 1
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


# ------------------------------------------ bfloat16 instances on a card

def _bf16_ulps(got, want):
    """max |got - want| in bfloat16 ulps of the output, the ulp of
    max |want|. Not each element's own ulp: a rounding of conv1's
    activation that the sums' order moves by one changes a near-zero
    output by several of its own ulps."""
    import math

    g, w = got.float(), want.float()
    _, e = math.frexp(float(w.abs().max()))
    return float((g - w).abs().max()) / 2.0 ** (e - 8)


@pytest.mark.parametrize("B,H,W,c2,slope", [
    (1, 240, 320, 24, 0.01), (8, 240, 320, 24, 0.01), (2, 240, 320, 32, 0.01),
    (1, 240, 320, 128, 0.01), (2, 250, 334, 128, 0.0), (2, 241, 321, 24, 0.01),
    (1, 49, 65, 32, 0.0), (1, 128, 512, 32, 0.01), (8, 240, 320, 128, 0.01),
    (3, 240, 320, 128, 0.01), (1, 33, 47, 128, 0.01),
    (3, 240, 320, 24, 0.01)])
def test_stem_bf16_kernel_matches_plain(cuda, B, H, W, c2, slope):
    """The bfloat16 instances at the N slice's B 1 and 8, S and D widths
    (D and N at B 3: the persistent blocks' last round part full),
    ragged and odd sizes (33x47: fewer tiles than the card has SMs), the
    ReLU and the VO frames' 128x512, for NHWC memory and the NHWC view of
    NCHW memory: within one bfloat16 ulp of the output of the twin (the
    sums' order can move a rounding of conv1's activation or of the output
    by one)."""
    c1 = 64 if c2 == 128 else 16
    x, w1, b1, w2, b2 = _stem_inputs(B, H, W, c1, c2)
    args = [_oihw(w1), torch.from_numpy(b1), _oihw(w2), torch.from_numpy(b2)]
    args = [a.to(cuda) for a in args]
    x = torch.from_numpy(x).to(cuda).to(torch.bfloat16)
    want = stem_plain(x, *args, slope)
    assert want.dtype == torch.bfloat16
    for xv in (x, x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)):
        before = (fused_stem_pair_pool.launches,
                  fused_stem_pair_pool.launches_bf16)
        got = fused_stem_pair_pool(xv, *args, slope)
        torch.cuda.synchronize()
        assert (fused_stem_pair_pool.launches,
                fused_stem_pair_pool.launches_bf16) == (before[0],
                                                         before[1] + 1)
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        assert _bf16_ulps(got, want) <= 1.0


@pytest.mark.parametrize("c1,c2,dtype", [
    (64, 128, torch.float32), (64, 128, torch.bfloat16),
    (16, 24, torch.bfloat16), (16, 32, torch.bfloat16)])
def test_stem_wide_kernel_is_deterministic(cuda, c1, c2, dtype):
    """The persistent instances at 240x320, B 8: config D's (64, 128) at
    float32 and bf16 and the narrow bf16 ones, N's (16, 24) and S's
    (16, 32): two launches on the same inputs give the same bits (no
    atomics, fixed sum orders, whichever block takes a tile)."""
    x, w1, b1, w2, b2 = _stem_inputs(8, 240, 320, c1, c2, seed=5)
    args = [a.to(cuda) for a in (_oihw(w1), torch.from_numpy(b1),
                                 _oihw(w2), torch.from_numpy(b2))]
    x = torch.from_numpy(x).to(cuda).to(dtype)
    first = fused_stem_pair_pool(x, *args)
    second = fused_stem_pair_pool(x, *args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("B,H,W,C", [
    (1, 240, 320, 32), (8, 240, 320, 32), (2, 240, 320, 128),
    (2, 244, 332, 32)])
def test_postprocess_bf16_kernel_matches_plain(cuda, B, H, W, C):
    """bfloat16 score, shift and descriptors, float32 out: the N slice at B
    1 and 8, config D's C = 128 and a ragged grid, shifts of exactly +-1
    included, for NCHW and NHWC memory."""
    cell = 4
    score, shift, feat = (torch.from_numpy(a).to(cuda).to(torch.bfloat16)
                          for a in _pp_inputs(B, H, W, cell, C,
                                              edge_shifts=True))
    want = postprocess_plain(score, shift, feat, H, W, cell)

    def nchw(t):
        return t.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)

    for args in ((score, shift, feat), (nchw(score), nchw(shift), nchw(feat))):
        before = fused_postprocess.launches_bf16
        got = fused_postprocess(*args, H, W, cell)
        torch.cuda.synchronize()
        assert fused_postprocess.launches_bf16 == before + 1
        assert all(g.dtype == torch.float32 for g in got)
        torch.testing.assert_close(got[0], want[0], atol=1e-5, rtol=0)
        torch.testing.assert_close(got[1], want[1], atol=1e-5, rtol=0)
        assert (got[2] * want[2]).sum(-1).min().item() > 0.99999


@pytest.mark.parametrize("B,C,K,H,W", [
    (1, 48, 32, 60, 80), (8, 48, 32, 60, 80), (1, 64, 64, 60, 80),
    (2, 128, 64, 30, 40), (1, 48, 32, 37, 53)])
def test_netvlad_bf16_kernel_matches_plain(cuda, B, C, K, H, W):
    """A bfloat16 x at config N (B 1, 8), S and F widths and a ragged
    image, for the NCHW view and NHWC memory: within 1e-5 of the twin."""
    rs = np.random.RandomState(9)
    x = torch.from_numpy(rs.randn(B, C, H, W).astype(np.float32)).to(
        cuda).to(torch.bfloat16)
    aw = torch.from_numpy(rs.randn(C, K).astype(np.float32)).to(cuda)
    cen = torch.from_numpy(rs.rand(K, C).astype(np.float32)).to(cuda)
    x_nhwc = x.permute(0, 2, 3, 1)
    want = netvlad_plain(x_nhwc, aw, cen)
    for xv in (x_nhwc, x_nhwc.contiguous(), x_nhwc):
        before = netvlad.launches_bf16
        got = netvlad(xv, aw, cen)
        torch.cuda.synchronize()
        assert netvlad.launches_bf16 == before + 1
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


# ------------------------------------------------ the NetVLAD backward

def test_netvlad_backward_on_cpu_is_the_twin():
    """On CPU tensors ``netvlad_backward`` is autograd through
    ``netvlad_plain``, and ``netvlad`` differentiates through the plain
    function (no kernel, no launch counted)."""
    rs = np.random.RandomState(3)
    x = torch.from_numpy(rs.randn(2, 5, 7, 16).astype(np.float32))
    aw = torch.from_numpy(rs.randn(16, 8).astype(np.float32))
    cen = torch.from_numpy(rs.rand(8, 16).astype(np.float32))
    gy = torch.from_numpy(rs.randn(2, 128).astype(np.float32))
    leaves = [t.clone().requires_grad_() for t in (x, aw, cen)]
    before = netvlad_backward.launches
    netvlad(*leaves).backward(gy)
    got = netvlad_backward(gy, x, aw, cen, None, None)
    want = netvlad_backward_plain(gy, x, aw, cen)
    assert netvlad_backward.launches == before
    for g, l, w in zip(got, leaves, want):
        torch.testing.assert_close(g, w, atol=0, rtol=0)
        torch.testing.assert_close(l.grad, w, atol=0, rtol=0)


@pytest.mark.parametrize("B,H,W,C,K", [
    (4, 30, 40, 64, 64), (1, 60, 80, 48, 32), (2, 7, 9, 128, 64),
    (1, 60, 80, 48, 64), (3, 13, 17, 48, 64), (2, 9, 11, 30, 20),
    (1, 6, 7, 100, 50)])
def test_netvlad_backward_kernel_matches_twin(cuda, B, H, W, C, K):
    """The train shape of config S (4x30x40, C = K = 64), config N's
    (1x60x80, 48, 32), V3 N's (48, 64), a ragged F-width image, 3 images of
    221 pixels (a multiple of neither the 40-pixel tile nor the cluster of
    8 tiles) and widths that no instance has (run zero-padded in the
    (48, 32) and (128, 64) ones): dx, dW and dcen within
    1e-5 of each gradient's largest magnitude against the twin (float32
    sums in other orders), for the NCHW view and NHWC memory; dW and dcen
    equal across two launches (fixed-order reductions); and the same
    gradients through ``netvlad``'s autograd, one forward and one
    backward launch."""
    rs = np.random.RandomState(B + C)
    x = torch.from_numpy(rs.randn(B, C, H, W).astype(np.float32)).to(cuda)
    aw = torch.from_numpy(rs.randn(C, K).astype(np.float32) * 0.3).to(cuda)
    cen = torch.from_numpy(rs.rand(K, C).astype(np.float32)).to(cuda)
    gy = torch.from_numpy(rs.randn(B, K * C).astype(np.float32)).to(cuda)
    x_nhwc = x.permute(0, 2, 3, 1)
    want = netvlad_backward_plain(gy, x_nhwc, aw, cen)
    for xv in (x_nhwc, x_nhwc.contiguous()):
        _, u, m = netvlad_residuals(xv, aw, cen)
        got = netvlad_backward(gy, xv, aw, cen, u, m)
        again = netvlad_backward(gy, xv, aw, cen, u, m)
        torch.cuda.synchronize()
        assert got[0].stride() == xv.stride()
        for g, w in zip(got, want):
            err = (g - w).abs().max().item()
            assert err <= 1e-5 * w.abs().max().item(), (err, w.abs().max())
        assert torch.equal(got[1], again[1]) and torch.equal(got[2], again[2])
    leaves = [t.clone().requires_grad_() for t in (x_nhwc, aw, cen)]
    fwd, bwd = netvlad.launches, netvlad_backward.launches
    netvlad(*leaves).backward(gy)
    torch.cuda.synchronize()
    assert (netvlad.launches, netvlad_backward.launches) == (fwd + 1, bwd + 1)
    for leaf, w in zip(leaves, want):
        err = (leaf.grad - w).abs().max().item()
        assert err <= 1e-5 * w.abs().max().item()


def _bf16_ulps(got, want):
    """max |got - want| in bf16 ulps of max |want|."""
    import math

    _, e = math.frexp(want.float().abs().max().item())
    return (got.float() - want.float()).abs().max().item() / 2.0 ** (e - 8)


@pytest.mark.parametrize("B,H,W,C,K", [
    (4, 30, 40, 64, 64), (12, 60, 80, 64, 64), (1, 60, 80, 48, 32),
    (3, 13, 17, 48, 64), (2, 9, 11, 128, 64), (2, 9, 11, 30, 20)])
def test_netvlad_backward_bf16_kernel_matches_twin(cuda, B, H, W, C, K):
    """A bfloat16 x (the bf16 train path's, the VPR shape's, config N's,
    ragged and padded widths): dx comes back bf16 within two bf16 ulps of
    its largest magnitude against the twin (autograd through
    ``netvlad_plain`` at bf16; dx^ and dx are each rounded to bf16 on both
    sides, and a rounding on the other side of a midpoint moves an element
    by one ulp; measured 0.25-1.0), dW and dcen float32 within 1e-4 of
    their largest magnitudes (the kernel and the twin sum |x|^2 in other
    orders, so x / den can differ by a float32 ulp and, across a bf16
    midpoint, round x^ one bf16 ulp apart; measured 1.9e-5 at the train
    shape), for the NCHW view and NHWC memory; dW and dcen equal across
    two launches; through ``netvlad``'s autograd the same gradients, one
    bf16 forward and one bf16 backward launch."""
    rs = np.random.RandomState(B + C + 1)
    x = torch.from_numpy(rs.randn(B, C, H, W).astype(np.float32)).to(
        cuda).to(torch.bfloat16)
    aw = torch.from_numpy(rs.randn(C, K).astype(np.float32) * 0.3).to(cuda)
    cen = torch.from_numpy(rs.rand(K, C).astype(np.float32)).to(cuda)
    gy = torch.from_numpy(rs.randn(B, K * C).astype(np.float32)).to(cuda)
    x_nhwc = x.permute(0, 2, 3, 1)
    want = netvlad_backward_plain(gy, x_nhwc, aw, cen)
    assert want[0].dtype == torch.bfloat16

    def check(got):
        assert got[0].dtype == torch.bfloat16
        assert _bf16_ulps(got[0], want[0]) <= 2.0
        for g, w in zip(got[1:], want[1:]):
            err = (g - w).abs().max().item()
            assert err <= 1e-4 * w.abs().max().item(), (err, w.abs().max())

    for xv in (x_nhwc, x_nhwc.contiguous()):
        _, u, m = netvlad_residuals(xv, aw, cen)
        before = netvlad_backward.launches_bf16
        got = netvlad_backward(gy, xv, aw, cen, u, m)
        again = netvlad_backward(gy, xv, aw, cen, u, m)
        torch.cuda.synchronize()
        assert netvlad_backward.launches_bf16 == before + 2
        assert got[0].stride() == xv.stride()
        check(got)
        assert torch.equal(got[1], again[1]) and torch.equal(got[2], again[2])
    leaves = [t.clone().requires_grad_() for t in (x_nhwc, aw, cen)]
    fwd, bwd = netvlad.launches_bf16, netvlad_backward.launches_bf16
    netvlad(*leaves).backward(gy)
    torch.cuda.synchronize()
    assert (netvlad.launches_bf16, netvlad_backward.launches_bf16) == (
        fwd + 1, bwd + 1)
    check([leaf.grad for leaf in leaves])


# ------------------------------- KeypointFormer's widths: bias, C = 256

@pytest.mark.parametrize("B,C,bf16", [(1, 256, False), (8, 256, False),
                                      (1, 64, False), (1, 256, True),
                                      (2, 64, True)])
def test_postprocess_keypoint_former_widths(cuda, B, C, bf16):
    """KeypointFormer at 256x320 (cell 8): score (B,32,40), feat
    (B,64,80,C) as NCHW memory, C = 256 ("default") and 64 ("tiny"), float32
    and bf16 inputs: score and coord within 1e-5, descriptor cosine >
    0.99999 against the twin."""
    H, W, cell = 256, 320, 8
    score, shift, feat = (torch.from_numpy(a).to(cuda) for a in _pp_inputs(
        B, H, W, cell, C, seed=B + C, edge_shifts=True))
    score, shift, feat = (t.permute(0, 3, 1, 2).contiguous().permute(
        0, 2, 3, 1) for t in (score, shift, feat))
    if bf16:
        score, shift, feat = (t.to(torch.bfloat16)
                              for t in (score, shift, feat))
    want = postprocess_plain(score, shift, feat, H, W, cell)
    got = fused_postprocess(score, shift, feat, H, W, cell)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0], want[0], atol=1e-5, rtol=0)
    torch.testing.assert_close(got[1], want[1], atol=1e-5, rtol=0)
    assert (got[2] * want[2]).sum(-1).min().item() > 0.99999


def _vladv2_inputs(dev, B, H, W, C, K, seed, bf16=False):
    """x (B,H,W,C) as NCHW memory, W, the centroids, a bias of spread 0.5
    (so that it moves the softmax) and an upstream gradient."""
    rs = np.random.RandomState(seed)
    x = torch.from_numpy(rs.randn(B, C, H, W).astype(np.float32)).to(
        dev).permute(0, 2, 3, 1)
    if bf16:
        x = x.to(torch.bfloat16)
    aw = torch.from_numpy(rs.randn(C, K).astype(np.float32) * 0.3).to(dev)
    cen = torch.from_numpy(rs.rand(K, C).astype(np.float32)).to(dev)
    b = torch.from_numpy(rs.randn(K).astype(np.float32) * 0.5).to(dev)
    gy = torch.from_numpy(rs.randn(B, K * C).astype(np.float32)).to(dev)
    return x, aw, cen, b, gy


def _db_scale(gy, x, aw, cen, b):
    """max over k of sum over the pixels of |dl[., k]|: db's terms cancel
    (a pixel's dl sums to 0 over k), so its error is measured against the
    size of its terms, not of the sum. dl is the gradient of a bias given
    to every pixel, through the twin."""
    B, H, W, _ = x.shape
    b_full = b.expand(B, H * W, b.shape[0]).clone().requires_grad_()
    with torch.enable_grad():
        dl, = torch.autograd.grad(netvlad_plain(x, aw, cen, b_full), b_full,
                                  gy)
    return dl.abs().sum((0, 1)).max().item()


# Above C = 128 the forward and the backward run kernels of their own, whose
# thread-block clusters split C in slices of 64 channels and walk the
# image's tiles of 32 pixels: widths that are no multiple of a slice (136,
# 200), both K instances' widths (48, 64), a one-pixel image,
# KeypointFormer's train (221 pixels) and serving (1,353) maps, batches of
# 1, 4 and 12. Two flags cycle over the 24 cases: the forward's NHWC
# memory (it takes both bias settings in each case) or the backward's bias
# (it takes both layouts in each case), and bf16 x.
_WIDE_CASES = [
    (B, H, W, C, K, bool(i % 2), bool(i // 2 % 2))
    for i, (B, H, W, C, K) in enumerate(
        (B, H, W, C, K)
        for B, H, W in ((1, 1, 1), (4, 13, 17), (1, 33, 41), (12, 33, 41))
        for C in (136, 200, 256) for K in (48, 64))]


@pytest.mark.parametrize("B,H,W,C,K,nhwc,bf16", [
    (1, 33, 41, 256, 64, False, False), (8, 33, 41, 256, 64, False, False),
    (1, 33, 41, 64, 64, False, False), (2, 33, 41, 256, 64, False, True),
    (1, 33, 41, 64, 64, False, True), (3, 13, 17, 200, 64, False, False)]
    + _WIDE_CASES)
def test_netvlad_vladv2_kernel_matches_plain(cuda, B, H, W, C, K, nhwc,
                                             bf16):
    """The vladv2 forward at KeypointFormer's vlad head (33x41 at 256x320,
    K = 64, C = 256 and 64; bf16 x too), at a width no instance has
    (C = 200) and at the wide cases above: within 1e-5 of the twin with
    the bias; without the bias the kernel computes the function it
    computed before (the twin without it); one launch a call, and the
    same bits from two launches (the sums' order is fixed by the grid,
    which is fixed for a card and a shape)."""
    x, aw, cen, b, _ = _vladv2_inputs(cuda, B, H, W, C, K, B + C, bf16)
    if nhwc:
        x = x.contiguous()
    for bias in (b, None):
        want = netvlad_plain(x, aw, cen, bias)
        before = netvlad.launches_bf16 if bf16 else netvlad.launches
        got = netvlad(x, aw, cen, bias)
        again = netvlad(x, aw, cen, bias)
        torch.cuda.synchronize()
        assert (netvlad.launches_bf16 if bf16 else netvlad.launches) \
            == before + 2
        assert (got - want).abs().max().item() <= 1e-5
        assert torch.equal(got, again)


@pytest.mark.parametrize("B,H,W,C,K,bias,bf16", [
    (8, 13, 17, 256, 64, True, False), (8, 13, 17, 64, 64, True, False),
    (2, 33, 41, 256, 64, True, False), (8, 13, 17, 256, 64, True, True),
    (8, 13, 17, 64, 64, True, True), (3, 7, 9, 160, 64, True, False)]
    + _WIDE_CASES)
def test_netvlad_vladv2_backward_matches_twin(cuda, B, H, W, C, K, bias,
                                              bf16):
    """The backward at KeypointFormer's training shape (13x17 at 96x128,
    K = 64, C = 256 in the wide kernel and 64 in the tiles; bf16 x too),
    at serving's 33x41, at C = 160 (zero-padded slices) and at the wide
    cases above, NCHW and NHWC memory: dx, dW and dcen within 1e-5 of
    each gradient's largest magnitude against autograd through the twin,
    db within 1e-5 of its terms' size (``_db_scale``) (at bf16: dx two
    bf16 ulps, the rest 1e-4, as for the bf16 backward without a bias);
    dW, dcen and db equal across two launches; through ``netvlad``'s
    autograd the same gradients with one forward and one backward
    launch. On a one-pixel image y does not depend on the soft assignment
    (each u_k is a_k (x^ - c_k), which the intra-normalisation divides
    out), so dW and db are zero in exact arithmetic and both sides' are
    rounding noise: there they are held to the same fraction of dcen's
    largest magnitude."""
    x, aw, cen, b, gy = _vladv2_inputs(cuda, B, H, W, C, K, B + C + 7, bf16)
    bb = (b,) if bias else ()
    want = netvlad_backward_plain(gy, x, aw, cen, *bb)
    assert len(want) == 3 + bias
    db_scale = _db_scale(gy, x, aw, cen, b) if bias else None

    def check(got):
        for i, (g, w) in enumerate(zip(got, want)):
            assert g.dtype == w.dtype
            if bf16 and i == 0:
                assert _bf16_ulps(g, w) <= 2.0
                continue
            if H * W == 1 and i in (1, 3):
                scale = want[2].abs().max().item()
            else:
                scale = db_scale if i == 3 else w.abs().max().item()
            err = (g - w).abs().max().item()
            lim = (1e-4 if bf16 else 1e-5) * scale
            assert err <= lim, (i, err, lim)

    for xv in (x, x.contiguous()):
        _, u, m = netvlad_residuals(xv, aw, cen, *bb)
        got = netvlad_backward(gy, xv, aw, cen, u, m, *bb)
        again = netvlad_backward(gy, xv, aw, cen, u, m, *bb)
        torch.cuda.synchronize()
        assert got[0].stride() == xv.stride()
        check(got)
        assert all(torch.equal(g, a) for g, a in zip(got[1:], again[1:]))
    leaves = [t.clone().requires_grad_() for t in (x, aw, cen) + bb]
    counts = (netvlad_backward.launches_bf16 if bf16
              else netvlad_backward.launches)
    netvlad(*leaves).backward(gy)
    torch.cuda.synchronize()
    assert (netvlad_backward.launches_bf16 if bf16
            else netvlad_backward.launches) == counts + 1
    check([leaf.grad for leaf in leaves])


def test_kernels_refuse_widths_past_their_limits(cuda):
    """A CUDA tensor outside a kernel's limits raises (no fallback to the
    twin): C = 257 for the postprocess and both NetVLAD kernels, K = 65
    for NetVLAD."""
    score, shift, feat = (torch.from_numpy(a).to(cuda) for a in _pp_inputs(
        1, 64, 64, 8, 257))
    with pytest.raises(ValueError, match="C=257"):
        fused_postprocess(score, shift, feat, 64, 64, 8)
    for C, K in ((257, 64), (64, 65)):
        x, aw, cen, b, gy = _vladv2_inputs(cuda, 1, 5, 6, C, K, 0)
        with pytest.raises(ValueError, match="the kernel takes"):
            netvlad(x, aw, cen, b)
        with pytest.raises(ValueError, match="the kernel takes"):
            netvlad_backward(gy, x, aw, cen, gy, gy[:, :K].contiguous(),
                             b)


def _int8_inputs(dev, B, H, W, cin, cout, int8_in, seed=0):
    """Random int8 weights (Kpad zero-padded), multipliers, BN affine and
    an input (float32 NCHW, or int8 NHWC codes) for ``int8_conv3x3``
    (``int8_in`` "bf16": the float32 input rounded to bfloat16)."""
    from nanovs_slam_torch.kernels.int8conv import padded_k

    rs = np.random.RandomState(seed)
    wq = np.zeros((cout, padded_k(cin)), np.int8)
    wq[:, :9 * cin] = rs.randint(-127, 128, (cout, 9 * cin))
    m = (rs.rand(cout) * 1e-4 + 1e-5).astype(np.float32)
    a = (1.0 + 0.1 * rs.randn(cout)).astype(np.float32)
    b = (0.1 * rs.randn(cout)).astype(np.float32)
    if int8_in is True:
        x = rs.randint(-127, 128, (B, H, W, cin)).astype(np.int8)
    else:
        x = rs.uniform(-1.5, 1.5, (B, cin, H, W)).astype(np.float32)
    out = [torch.from_numpy(v).to(dev) for v in (x, wq, m, a, b)]
    if int8_in == "bf16":
        out[0] = out[0].bfloat16()
    return out


@pytest.mark.parametrize("B,H,W,cin,cout,int8_in,out", [
    (1, 240, 320, 3, 16, False, "int8"),      # conv1a: Cin 3, K 27 -> 32
    (2, 240, 320, 16, 32, True, "pool"),      # conv1b, its fused pool
    (1, 60, 80, 64, 64, False, "float"),      # a head's conv
    (2, 30, 40, 64, 128, False, "float"),     # K 576 in two chunks
    (1, 120, 160, 96, 64, False, "float"),    # Cin 96 (the concats)
    (3, 37, 51, 32, 24, True, "pool"),        # odd sizes, 24 of 32 lanes
    (1, 19, 23, 48, 256, True, "int8"),       # Cout 256: two n-blocks
    (2, 5, 3, 3, 8, False, "float"),          # a frame under one tile
    # a map under one 4x16 tile, and pixel counts not a multiple of 64
    (1, 3, 7, 16, 16, True, "int8"),
    (2, 9, 13, 32, 32, False, "pool"),
    # each instance, its channels a warp zero-padded: 8-row tiles of 8
    # (Cout 8), 16 (Cout 16, 24 padded) and 32 channels a warp; 4-row tiles
    # of 32 (Cout 64), 64 (128) and 128 (256); and 8-row tiles of 64 (Cout
    # 64 on a map of many tiles, desc_head/convAa's at batch 8)
    (1, 7, 9, 16, 8, True, "float"),
    (1, 11, 21, 64, 16, False, "int8"),
    (2, 6, 10, 24, 24, True, "float"),
    (1, 10, 18, 32, 32, False, "int8"),
    (1, 12, 20, 64, 64, True, "pool"),
    (1, 9, 17, 96, 128, False, "float"),
    (1, 6, 34, 32, 256, False, "float"),
    (8, 120, 160, 96, 64, False, "float"),
    # more than 256 channels: two channel groups of the grid
    (1, 3, 5, 8, 264, False, "float"),
    # weights beyond the resident budget: the K-chunk ring (and, for the
    # float input, its channels staged in chunks)
    (1, 6, 10, 256, 256, True, "float"),
    (1, 5, 12, 256, 256, False, "pool"),
    # float halo rows off 16-byte alignment (W % 4 != 0): 4-byte copies
    (1, 7, 81, 64, 64, False, "float"),
    # int8 codes copied 4 bytes at a time (Cin % 16 != 0), and byte by
    # byte (Cin % 4 != 0)
    (1, 4, 8, 12, 40, True, "int8"),
    (1, 4, 8, 7, 16, True, "float")])
def test_int8_conv_kernel_matches_twin(cuda, B, H, W, cin, cout, int8_in,
                                       out):
    """The int8 conv kernel against its plain twin: the int32 sums are
    exact on both sides and the epilogue rounds each product and sum as
    the twin does, so codes and float32 outputs are equal bit for bit;
    one launch counted. The cases cover the edges of the kernel's design
    (``csrc/int8conv.cuh``): partial tiles, each instance's tile rows and
    channels a warp, channel groups, streamed weights, staged float chunks
    and each input copy."""
    from nanovs_slam_torch.kernels import int8_conv3x3, int8_conv3x3_plain

    x, wq, m, a, b = _int8_inputs(cuda, B, H, W, cin, cout, int8_in)
    args = (x, wq, m, a, b, 0.0123, 0.01,
            None if out == "float" else 0.0371, out == "pool")
    n = int8_conv3x3.launches
    got = int8_conv3x3(*args)
    want = int8_conv3x3_plain(*args)
    torch.cuda.synchronize()
    assert int8_conv3x3.launches == n + 1
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)
    assert float(got.abs().max()) > 0


# (B, H, W, design): 16-pixel tiles, and strips (many images of a few rows)
TIE_SHAPES = [(2, 9, 21, "tiles"), (400, 16, 24, "strips")]


def _design(x, cout, out_scale=None, pool=False, out_dtype=None):
    from nanovs_slam_torch.kernels.int8conv import launch_shape
    return launch_shape(x, cout, out_scale, pool, out_dtype)["design"]


@pytest.mark.parametrize("B,H,W,design", TIE_SHAPES)
@pytest.mark.parametrize("scale", [0.0123, 0.1, 1.0 / 3, 7.1e-3])
def test_int8_conv_kernel_exact_at_ties(cuda, scale, B, H, W, design):
    """Float inputs whose quotients x / scale lie on or a few ulps beside
    half-integers (where a product with the reciprocal rounds to another
    code than the IEEE division) and beyond the clip, zeros and denormals:
    the kernel's codes are the twin's (float32 out shows every int32 sum),
    in each design."""
    from nanovs_slam_torch.kernels import int8_conv3x3, int8_conv3x3_plain

    rs = np.random.RandomState(5)
    cin, cout = 16, 16
    s32 = np.float32(scale)
    k = rs.randint(-130, 130, (B, cin, H, W)).astype(np.float32)
    x = (k + np.float32(0.5)) * s32
    steps = rs.randint(-3, 4, x.shape)
    for d in range(1, 4):
        x = np.where(steps >= d, np.nextafter(x, np.float32(np.inf)), x)
        x = np.where(steps <= -d, np.nextafter(x, np.float32(-np.inf)), x)
    x = x.astype(np.float32)
    x[0, 0, 0, :4] = [0.0, -0.0, 1e-40, -3e-39]
    _, wq, m, a, b = _int8_inputs(cuda, B, H, W, cin, cout, False)
    xt = torch.from_numpy(x).to(cuda)
    assert _design(xt, cout) == design
    got = int8_conv3x3(xt, wq, m, a, b, float(s32), 0.01)
    want = int8_conv3x3_plain(xt, wq, m, a, b, float(s32), 0.01)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("B,H,W,cin,cout,x_in,out,slope", [
    # conv1a of a bf16 model: Cin 3 (byte-by-byte A), chained and not
    (1, 240, 320, 3, 16, "bf16", "int8", 0.01),
    (1, 240, 320, 3, 16, "bf16", "float", 0.01),
    # a head's conv at 60x80 and 30x40 (64 channels), 96 channels
    (1, 60, 80, 64, 64, "bf16", "float", 0.01),
    (2, 30, 40, 64, 128, "bf16", "float", 0.01),
    (1, 120, 160, 96, 64, "bf16", "float", 0.01),
    # odd frames: bf16 rows loaded value by value (W % 8 != 0)
    (1, 241, 321, 3, 16, "bf16", "int8", 0.01),
    (1, 241, 321, 16, 32, "bf16", "pool", 0.01),
    (1, 7, 84, 64, 64, "bf16", "float", 0.01),
    (1, 4, 8, 7, 16, "bf16", "float", 0.01),
    # Cout 256 (a float input, and a chained consumer's codes)
    (1, 19, 24, 48, 256, "bf16", "float", 0.01),
    (1, 30, 40, 64, 256, "int8", "float", 0.01),
    # weights streamed in K chunks, channels staged in chunks
    (1, 6, 16, 256, 256, "bf16", "pool", 0.01),
    # int8 codes in, codes and pooled codes out
    (2, 9, 13, 32, 32, "int8", "int8", 0.01),
    (3, 37, 51, 32, 24, "int8", "pool", 0.01),
    # ReLU; codes pooled at config N's 60x80 widths
    (1, 12, 24, 64, 64, "bf16", "float", 0.0),
    (1, 60, 80, 48, 48, "int8", "pool", 0.01),
    # batch 128 at config N's 60x80 head map
    (128, 60, 80, 48, 64, "bf16", "float", 0.01)])
def test_int8_conv_kernel_bf16_matches_twin(cuda, B, H, W, cin, cout, x_in,
                                            out, slope):
    """The int8 conv kernel's bfloat16 instances (a bf16 map staged as bf16
    and quantised from it; a bf16 block's epilogue, which rounds the BN
    affine and the activation's product to bf16) against the twin, which
    rounds at the same places: bf16 outputs and codes equal bit for bit;
    one launch counted, in ``launches_bf16``."""
    from nanovs_slam_torch.kernels import int8_conv3x3, int8_conv3x3_plain

    dt = torch.bfloat16
    x, wq, m, a, b = _int8_inputs(cuda, B, H, W, cin, cout,
                                  x_in if x_in == "bf16" else True)
    args = (x, wq, m, a, b, 0.0123, slope,
            None if out == "float" else 0.0371, out == "pool")
    counts = (int8_conv3x3.launches, int8_conv3x3.launches_bf16)
    got = int8_conv3x3(*args, out_dtype=dt)
    want = int8_conv3x3_plain(*args, out_dtype=dt)
    torch.cuda.synchronize()
    assert (int8_conv3x3.launches, int8_conv3x3.launches_bf16) == (
        counts[0], counts[1] + 1)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.dtype == (dt if out == "float" else torch.int8)
    assert torch.equal(got, want)
    assert float(got.float().abs().max()) > 0


@pytest.mark.parametrize("B,H,W,design", [(2, 9, 24, "tiles"),
                                           (400, 16, 24, "strips")])
def test_int8_conv_kernel_bf16_exact_at_ties(cuda, B, H, W, design):
    """bfloat16 inputs on and a few bf16 ulps beside half-integer
    quotients x / scale, beyond the clip, zeros and subnormals, through an
    identity conv (the centre tap's weight 1 from each channel to itself,
    m = a = 1, b = 0, slope 1), so that the bf16 output is each input code
    exactly: the kernel's codes are the twin's, which are clip(round(x /
    scale)) of the IEEE quotient, in each design."""
    from nanovs_slam_torch.kernels import int8_conv3x3, int8_conv3x3_plain
    from nanovs_slam_torch.kernels.int8conv import padded_k

    rs = np.random.RandomState(6)
    cin, scale = 16, 0.0123
    k = rs.randint(-130, 130, (B, cin, H, W)).astype(np.float32)
    x = torch.from_numpy((k + np.float32(0.5)) * np.float32(scale)).to(
        torch.bfloat16)
    bits = x.view(torch.int16)
    bits += torch.from_numpy(rs.randint(-3, 4, x.shape).astype(np.int16))
    x[0, 0, 0, :4] = torch.tensor([0.0, -0.0, 1e-40, -3e-39])
    wq = torch.zeros(cin, padded_k(cin), dtype=torch.int8)
    wq[torch.arange(cin), 4 * cin + torch.arange(cin)] = 1
    ones = torch.ones(cin)
    args = [t.to(cuda) for t in (x, wq, ones, ones, torch.zeros(cin))]
    assert _design(args[0], cin, out_dtype=torch.bfloat16) == design
    got = int8_conv3x3(*args, scale, 1.0, out_dtype=torch.bfloat16)
    want = int8_conv3x3_plain(*args, scale, 1.0, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    codes = np.clip(np.round(x.float().numpy() / np.float32(scale)), -127,
                    127)
    assert np.array_equal(got.float().cpu().numpy(), codes)


@pytest.mark.parametrize("B,H,W,cin,cout,x_in,out,block", [
    # config N's head conv at 60x80 (Cin 48 -> Cout 48), bf16 out and codes
    (132, 60, 80, 48, 48, "float", "float", "bf16"),
    (132, 60, 80, 48, 48, "float", "int8", "bf16"),
    # Cin 72 (five channel groups, the k-steps pairing across taps) on a
    # height that is not a multiple of the strip's rows
    (136, 61, 80, 72, 48, "float", "float", "bf16"),
    # Cout 96 (seg_head/convs_6), and codes of Cin 24 in (conv3b)
    (132, 60, 80, 48, 96, "float", "float", "bf16"),
    (132, 60, 80, 24, 48, "int8", "float", "bf16"),
    # conv1b's widths (Cin 16 codes -> pooled codes of Cout 24) on a width
    # of two column tiles, the last narrower, and an odd height
    (136, 31, 344, 16, 24, "int8", "pool", "bf16"),
    # codes of Cin 48 -> pooled codes (conv4b's widths, chained)
    (132, 60, 80, 48, 48, "int8", "pool", "bf16"),
    # conv1a's 3 channels (one group, 13 channels of zero weights)
    (64, 24, 320, 3, 16, "float", "int8", "bf16"),
    (48, 20, 328, 3, 16, "float", "float", "float32"),
    # float32 blocks: a float map, codes in and out, a pooled float map
    (132, 60, 80, 48, 48, "float", "float", "float32"),
    (264, 40, 40, 16, 16, "int8", "int8", "float32"),
    (264, 30, 40, 32, 32, "float", "pool", "float32")])
def test_int8_conv_kernel_strips_match_twin(cuda, B, H, W, cin, cout, x_in,
                                            out, block):
    """The strip design (calls of 3/4 of a wave of strips or more: bulk-copied
    rows, codes quantised once into wgmma's planes, m64nNk32 with A and B
    from shared memory at N = Cout) against the twin, bit for bit: widths
    Cin 3 / 16 / 24 / 48 / 72 and Cout 16 / 24 / 32 / 48 / 96, float and int8
    inputs, float, codes and pooled codes out, bf16 and float32 blocks,
    heights and widths that the strips do not divide."""
    from nanovs_slam_torch.kernels import int8_conv3x3, int8_conv3x3_plain

    dt = torch.bfloat16 if block == "bf16" else torch.float32
    x, wq, m, a, b = _int8_inputs(cuda, B, H, W, cin, cout,
                                  True if x_in == "int8" else
                                  ("bf16" if block == "bf16" else False))
    args = (x, wq, m, a, b, 0.0123, 0.01,
            None if out == "float" else 0.0371, out == "pool")
    assert _design(x, cout, args[7], args[8], dt) == "strips"
    counts = (int8_conv3x3.launches, int8_conv3x3.launches_bf16)
    got = int8_conv3x3(*args, out_dtype=dt)
    want = int8_conv3x3_plain(*args, out_dtype=dt)
    torch.cuda.synchronize()
    bf = block == "bf16"
    assert (int8_conv3x3.launches, int8_conv3x3.launches_bf16) == (
        counts[0] + (not bf), counts[1] + bf)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)
    assert float(got.float().abs().max()) > 0


def test_int8_conv_refuses_what_it_does_not_take(cuda):
    """Cout not a multiple of 8, a pooled float output, a float16 input,
    a float16 block and a map of another dtype than its block's raise for
    CUDA tensors (no fallback to the twin)."""
    from nanovs_slam_torch.kernels import int8_conv3x3

    x, wq, m, a, b = _int8_inputs(cuda, 1, 8, 8, 4, 12, False)
    with pytest.raises(ValueError, match="multiple of 8"):
        int8_conv3x3(x, wq, m, a, b, 0.1, 0.0)
    x, wq, m, a, b = _int8_inputs(cuda, 1, 8, 8, 4, 16, False)
    with pytest.raises(ValueError, match="emits int8 only"):
        int8_conv3x3(x, wq, m, a, b, 0.1, 0.0, None, True)
    with pytest.raises(TypeError, match="float32, bfloat16 or int8"):
        int8_conv3x3(x.half(), wq, m, a, b, 0.1, 0.0)
    with pytest.raises(TypeError, match="out_dtype"):
        int8_conv3x3(x, wq, m, a, b, 0.1, 0.0, out_dtype=torch.float16)
    with pytest.raises(TypeError, match="own dtype"):
        int8_conv3x3(x, wq, m, a, b, 0.1, 0.0, out_dtype=torch.bfloat16)
