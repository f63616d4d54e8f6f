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

from nanovs_slam_torch.kernels import (fused_postprocess,
                                       fused_stem_pair_pool, netvlad,
                                       netvlad_plain, postprocess_plain,
                                       stem_plain)


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


def _pp_inputs(B, H, W, cell, C=32, seed=1):
    rs = np.random.RandomState(seed)
    Hc, Wc = H // cell, W // cell
    score = rs.rand(B, Hc, Wc, 1).astype(np.float32)
    shift = (rs.rand(B, Hc, Wc, 2).astype(np.float32) * 2 - 1)
    feat = rs.randn(B, 2 * Hc, 2 * Wc, C).astype(np.float32)
    return score, shift, feat


def _stem_inputs(B, H, W, c1, c2, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(B, H, W, 3).astype(np.float32)
    w1 = rs.randn(3, 3, 3, c1).astype(np.float32) * 0.2  # HWIO
    b1 = rs.randn(c1).astype(np.float32) * 0.1
    w2 = rs.randn(3, 3, c1, c2).astype(np.float32) * 0.1
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
                                         ((1, 32, 48), 16, 32)])
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

def test_netvlad_plain_matches_pallas_and_module():
    jnp = _jnp()
    import jax
    from nanovs_slam_tpu.modules.aggregators import NetVLAD as JaxNetVLAD
    from nanovs_slam_tpu.ops.pallas.netvlad_kernel import netvlad_pallas

    from nanovs_slam_torch.modules.aggregators import NetVLAD

    rs = np.random.RandomState(2)
    B, H, W, C, K = 2, 12, 16, 48, 32
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

@pytest.mark.parametrize("B", [1, 8])
def test_postprocess_kernel_matches_plain(cuda, B):
    H, W, cell = 240, 320, 4
    score, shift, feat = (torch.from_numpy(a).to(cuda)
                          for a in _pp_inputs(B, H, W, cell))
    # the model hands the kernel NHWC views of NCHW conv outputs
    feat_view = feat.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    want = postprocess_plain(score, shift, feat, H, W, cell)
    for f in (feat, feat_view):
        got = fused_postprocess(score, shift, f, H, W, cell)
        torch.cuda.synchronize()
        torch.testing.assert_close(got[0], want[0], atol=1e-5, rtol=0)
        torch.testing.assert_close(got[1], want[1], atol=1e-5, rtol=0)
        assert (got[2] * want[2]).sum(-1).min().item() > 0.99999


@pytest.mark.parametrize("B,c2", [(1, 24), (8, 24), (2, 32)])
def test_stem_kernel_matches_plain(cuda, B, c2):
    x, w1, b1, w2, b2 = _stem_inputs(B, 240, 320, 16, c2)
    args = [torch.from_numpy(x), _oihw(w1), torch.from_numpy(b1), _oihw(w2),
            torch.from_numpy(b2)]
    args = [a.to(cuda) for a in args]
    want = stem_plain(*args)
    got = fused_stem_pair_pool(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("B", [1, 8])
def test_netvlad_kernel_matches_plain(cuda, B):
    rs = np.random.RandomState(9)
    x = torch.from_numpy(rs.randn(B, 48, 60, 80).astype(np.float32)).to(cuda)
    aw = torch.from_numpy(rs.randn(48, 32).astype(np.float32)).to(cuda)
    cen = torch.from_numpy(rs.rand(32, 48).astype(np.float32)).to(cuda)
    x_nhwc = x.permute(0, 2, 3, 1)
    want = netvlad_plain(x_nhwc, aw, cen)
    for xv in (x_nhwc, x_nhwc.contiguous()):
        got = netvlad(xv, aw, cen)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
