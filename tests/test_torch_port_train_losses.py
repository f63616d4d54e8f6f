"""The port's training pieces on the CPU against the JAX package: the
NetVLAD gradients (the backward kernel's function), each loss's value and
input gradients (``jax.value_and_grad``), the inlier net in train mode with
its BN update, flax-style BatchNorm statistics, the LR schedules and the
plateau controller, and the port's seeded channel dropout. Inputs come
from numpy seeds; JAX references run under ``jax.jit``."""

import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import nchw, nhwc
from nanovs_slam_tpu.data.homography import sample_homography
from nanovs_slam_tpu.losses import depth as jax_depth
from nanovs_slam_tpu.losses import keypoint as jax_kp
from nanovs_slam_tpu.losses import segmentation as jax_seg
from nanovs_slam_tpu.losses import triplet as jax_trip
from nanovs_slam_tpu.models.inlier_net import InlierNet as JaxInlierNet
from nanovs_slam_tpu.modules.aggregators import NetVLAD as JaxNetVLAD
from nanovs_slam_tpu.ops.grid import decode_coords
from nanovs_slam_tpu.train import schedules as jax_sched
from nanovs_slam_torch.kernels import netvlad_backward
from nanovs_slam_torch.losses import depth as port_depth
from nanovs_slam_torch.losses import keypoint as port_kp
from nanovs_slam_torch.losses import segmentation as port_seg
from nanovs_slam_torch.losses import triplet as port_trip
from nanovs_slam_torch.models.inlier_net import InlierNet
from nanovs_slam_torch.modules.aggregators import NetVLAD
from nanovs_slam_torch.modules.blocks import BatchNorm2d, Dropout2d
from nanovs_slam_torch.train import schedules as port_sched
from nanovs_slam_torch.utils.checkpoint import load_npz_checkpoint
from nanovs_slam_torch.utils.convert import load_jax_inlier_net

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads for this file's torch work: the suite runs
    files in parallel workers, and each worker's torch taking every core
    oversubscribes the machine many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol, what=""):
    """max |got - want| <= tol * max(1, max |want|)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.max(np.abs(want))) if want.size else 1.0)
    err = float(np.max(np.abs(got - want))) if want.size else 0.0
    assert err <= tol * scale, (what, err, scale)


def _leaves(*arrays):
    return [torch.tensor(a, requires_grad=True) for a in arrays]


# ------------------------------------------------------ NetVLAD gradients

@pytest.mark.parametrize("B,H,W,C,K", [
    (2, 6, 8, 64, 64), (1, 15, 20, 48, 32), (1, 7, 9, 48, 64),
    (2, 5, 6, 128, 64)])
def test_netvlad_gradients_match_jax_grad(B, H, W, C, K):
    """dx, dW and dcen of the port's NetVLAD (autograd through the plain
    function on CPU tensors, and ``netvlad_backward``'s CPU twin) against
    ``jax.grad`` of the flax NetVLAD, for the upstream gradient gy: 1e-5
    relative to each gradient's largest magnitude. Every width the backward
    kernel has an instance for: config S's (C = K = 64), V2 N's (48, 32),
    V3 N's (48, 64) and F's (128, 64)."""
    rs = np.random.RandomState(C + K)
    x = rs.randn(B, H, W, C).astype(np.float32)
    aw = (rs.randn(C, K) * 0.3).astype(np.float32)
    cen = rs.rand(K, C).astype(np.float32)
    gy = rs.randn(B, K * C).astype(np.float32)
    mod = JaxNetVLAD(num_clusters=K, dim=C)

    @jax.jit
    def vjp(x, aw, cen):
        f = lambda x, aw, cen: jnp.sum(mod.apply(  # noqa: E731
            {"params": {"assign_w": aw, "centroids": cen}}, x) * gy)
        return jax.grad(f, argnums=(0, 1, 2))(x, aw, cen)

    want = [np.asarray(g) for g in vjp(x, aw, cen)]
    port = NetVLAD(K, C)
    with torch.no_grad():
        port.assign_w.copy_(torch.from_numpy(aw))
        port.centroids.copy_(torch.from_numpy(cen))
    xt = nchw(x).requires_grad_()
    port(xt).backward(torch.from_numpy(gy))
    got = [nhwc(xt.grad), port.assign_w.grad.numpy(),
           port.centroids.grad.numpy()]
    twin = netvlad_backward(torch.from_numpy(gy), torch.from_numpy(x),
                            torch.from_numpy(aw), torch.from_numpy(cen),
                            None, None)
    for g, t, w, name in zip(got, twin, want, ("dx", "dW", "dcen")):
        tol = 1e-5 * float(np.abs(w).max())
        assert np.abs(g - w).max() <= tol, name
        assert np.abs(t.numpy() - w).max() <= tol, name


# ------------------------------------------------------------------ losses

Hc, Wc, HI, WI = 6, 8, 24, 32  # cells and the 24x32 image (cell 4)


def _kp_inputs(near_copy, B=2, C=16, seed=0):
    """Post-processed-looking outputs of two views: scores in (0,1), the
    decoded coords of random tanh shifts (a third at +-1, so border cells
    clip onto the image's edge), dense descriptors at 2x the cells; the
    second view independent under a sampled homography, or with
    ``near_copy`` the first one perturbed."""
    rs = np.random.RandomState(seed)

    def view():
        shift = rs.uniform(-1, 1, (B, Hc, Wc, 2)).astype(np.float32)
        pick = rs.rand(B, Hc, Wc, 2) < 1 / 3
        shift[pick] = np.sign(shift[pick])
        coord = np.asarray(decode_coords(jnp.asarray(shift), HI, WI, 4))
        score = rs.rand(B, Hc, Wc, 1).astype(np.float32)
        score[:, 0] = score[:, -1] = 0.0  # border-masked
        score[:, :, 0] = score[:, :, -1] = 0.0
        feat = rs.randn(B, 2 * Hc, 2 * Wc, C).astype(np.float32)
        return score, coord, feat

    source = view()
    if not near_copy:
        homo = np.stack([sample_homography((HI, WI),
                                           np.random.RandomState(i))
                         for i in range(B)]).astype(np.float32)
        return source, view(), homo
    # the target a slightly perturbed copy under a near-identity
    # homography: descriptor NNs land on the true cells (IO gate open)
    homo = (np.eye(3) + rs.randn(B, 3, 3) * 1e-3).astype(np.float32)
    target = tuple((a + rs.randn(*a.shape) * e).astype(np.float32)
                   for a, e in zip(source, (1e-3, 0.1, 1e-2)))
    return source, target, homo


@pytest.fixture(scope="module")
def io_params():
    tree, _ = load_npz_checkpoint(os.path.join(REPO, "pinned",
                                               "extractor_S8.npz"))
    return tree["io_params"], tree["io_batch_stats"]


def _jax_keypoint_terms(io_params, io_stats, top_k, w):
    """value_and_grad of w . (loc, usp, score_mse, metric, io, recall)
    with respect to both views' scores, coords and descriptor maps."""
    net = JaxInlierNet(blocks=4)

    def f(s_score, s_coord, s_feat, t_score, t_coord, t_feat, homo):
        out = {"score": t_score, "coord": t_coord, "feat": t_feat}
        aug = {"score": s_score, "coord": s_coord, "feat": s_feat}
        kp = jax_kp.keypoint_losses(out, aug, homo, HI, WI)
        sg = jax.lax.stop_gradient
        metric, recall = jax_kp.descriptor_loss(
            s_feat, t_feat, sg(kp["source_uv_norm"]),
            sg(kp["source_uv_warped_norm"]), sg(kp["source_uv_warped"]))
        io = jax_kp.io_loss(
            s_score, s_feat, t_feat, t_score, kp["source_uv_norm"],
            kp["target_uv_norm"], kp["source_uv_warped_norm"], HI, WI,
            lambda p, pp: net.apply({"params": p, "batch_stats": io_stats},
                                    pp, True, mutable=["batch_stats"])[0],
            io_params, top_k=top_k)
        terms = jnp.stack([kp["loc_loss"], kp["usp_loss"], kp["score_mse"],
                           metric, io, recall])
        return terms @ jnp.asarray(w), terms

    return jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2, 3, 4, 5),
                                      has_aux=True))


# the weights of the keypoint terms (loc, usp, score_mse, metric) and of
# the IO term, whose gradients are held apart
MAIN_W = [1.0, 1.0, 2.0, 4.0, 0.0, 0.0]
IO_W = [0.0, 0.0, 0.0, 0.0, 1.0, 0.0]


@pytest.mark.parametrize("near_copy", [False, True])
def test_keypoint_losses_match_jax(io_params, near_copy):
    """loc, USP, score MSE, the descriptor triplet (detached coords), the
    IO loss (pinned S8 inlier net in train mode, bottom 24 of 48 cells)
    and recall within 1e-5 (relative to max(1, |value|)), for two
    independent views (the IO gate shut: <= 10 inliers) and a near copy
    (the gate open). Gradients with respect to both views' scores, coords
    and descriptor maps: of the weighted keypoint terms 1e-5; of the IO
    term 1e-3 of the largest, because the inlier net's train-mode
    normalisations (BN over 48 matches, instance norm over 24) condition
    its input gradients badly: JAX's own gradient of the same term from
    two jitted programs differs by 6.7e-5 at the worst coordinate (of a
    0.17 gradient), the port's by 2.0e-4."""
    (ss, sc, sf), (ts, tc, tf), homo = _kp_inputs(near_copy)
    (_, want_terms), want_main = _jax_keypoint_terms(*io_params, 24, MAIN_W)(
        ss, sc, sf, ts, tc, tf, homo)
    _, want_io = _jax_keypoint_terms(*io_params, 24, IO_W)(
        ss, sc, sf, ts, tc, tf, homo)
    io = load_jax_inlier_net(InlierNet(), *io_params).train()
    leaves = _leaves(ss, sc, sf, ts, tc, tf)
    s_score, s_coord, s_feat, t_score, t_coord, t_feat = leaves
    out = {"score": t_score, "coord": t_coord, "feat": t_feat}
    aug = {"score": s_score, "coord": s_coord, "feat": s_feat}
    kp = port_kp.keypoint_losses(out, aug, torch.from_numpy(homo), HI, WI)
    metric, recall = port_kp.descriptor_loss(
        s_feat, t_feat, kp["source_uv_norm"].detach(),
        kp["source_uv_warped_norm"].detach(), kp["source_uv_warped"].detach())
    iol = port_kp.io_loss(s_score, s_feat, t_feat, t_score,
                          kp["source_uv_norm"], kp["target_uv_norm"],
                          kp["source_uv_warped_norm"], HI, WI, io, top_k=24)
    terms = torch.stack([kp["loc_loss"], kp["usp_loss"], kp["score_mse"],
                         metric, iol, recall])
    assert (float(want_terms[4]) > 0) == near_copy  # the IO gate
    _close(terms.detach().numpy(), want_terms, 1e-5, "terms")
    names = ("s_score", "s_coord", "s_feat", "t_score", "t_coord", "t_feat")
    for w, want, tol in ((MAIN_W, want_main, 1e-5), (IO_W, want_io, 1e-3)):
        got = torch.autograd.grad(terms @ torch.tensor(w), leaves,
                                  retain_graph=True, allow_unused=True)
        for g, wg, name in zip(got, want, names):
            g = np.zeros_like(wg) if g is None else g.numpy()
            _close(g, wg, tol, name)


def _labels(rs, shape, C):
    lab = rs.randint(0, C, shape)
    lab[rs.rand(*shape) < 0.1] = 255
    lab[..., 0] = 0
    return lab


@pytest.mark.parametrize("which", ["ce", "dice", "seg"])
def test_segmentation_losses_match_jax(which):
    """CE (ignore 255), Dice and their 0.5 / 1.5 sum, value and gradient
    with respect to the logits, 1e-5; two classes never appear."""
    rs = np.random.RandomState(1)
    logits = rs.randn(2, 6, 8, 7).astype(np.float32) * 2
    labels = _labels(rs, (2, 6, 8), 5)
    jf = {"ce": jax_seg.cross_entropy_loss, "dice": jax_seg.dice_loss,
          "seg": jax_seg.segmentation_loss}[which]
    pf = {"ce": port_seg.cross_entropy_loss, "dice": port_seg.dice_loss,
          "seg": port_seg.segmentation_loss}[which]
    v, g = jax.jit(jax.value_and_grad(jf))(logits, labels.astype(np.int32))
    (t,) = _leaves(logits)
    pv = pf(t, torch.from_numpy(labels))
    pv.backward()
    _close(pv.item(), v, 1e-5, "value")
    _close(t.grad.numpy(), g, 1e-5, "grad")


@pytest.mark.parametrize("hardest", [True, False])
def test_triplet_losses_match_jax(hardest):
    """Batch-hard (the trainer's) and all-triplet losses over paired
    global descriptors, value and gradient, 1e-5; a duplicated row gives
    an exact zero distance off the diagonal."""
    rs = np.random.RandomState(2)
    emb = rs.randn(8, 32).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    emb[5] = emb[1]
    labels = np.array([0, 1, 2, 3, 0, 1, 2, 3])

    def jf(e):
        return jax_trip.hard_triplet_loss(e, jnp.asarray(labels),
                                          hardest=hardest)

    v, g = jax.jit(jax.value_and_grad(jf))(emb)
    (t,) = _leaves(emb)
    pv = port_trip.hard_triplet_loss(t, torch.from_numpy(labels),
                                     hardest=hardest)
    pv.backward()
    _close(pv.item(), v, 1e-5, "value")
    _close(t.grad.numpy(), g, 1e-5, "grad")


def test_global_descriptor_loss_matches_jax():
    rs = np.random.RandomState(3)
    a, b = (rs.randn(4, 64).astype(np.float32) for _ in range(2))
    v, g = jax.jit(jax.value_and_grad(jax_trip.global_descriptor_loss,
                                      argnums=(0, 1)))(a, b)
    ta, tb = _leaves(a, b)
    pv = port_trip.global_descriptor_loss(ta, tb)
    pv.backward()
    _close(pv.item(), v, 1e-5, "value")
    _close(ta.grad.numpy(), g[0], 1e-5, "grad a")
    _close(tb.grad.numpy(), g[1], 1e-5, "grad b")


def test_depth_loss_matches_jax():
    """SILog + Huber (gt > 0 masked; a fifth of gt is 0, a few errors
    beyond the Huber delta), value and gradient, 1e-5."""
    rs = np.random.RandomState(4)
    pred = rs.uniform(0.05, 1.0, (2, 6, 8, 1)).astype(np.float32)
    gt = rs.uniform(0.05, 1.0, (2, 6, 8, 1)).astype(np.float32)
    gt[rs.rand(*gt.shape) < 0.2] = 0.0
    gt[0, 0, :3] = 3.0
    v, g = jax.jit(jax.value_and_grad(
        lambda p: jax_depth.depth_loss(p, gt, 0.7)))(pred)
    (t,) = _leaves(pred)
    pv = port_depth.depth_loss(t, torch.from_numpy(gt), 0.7)
    pv.backward()
    _close(pv.item(), v, 1e-5, "value")
    _close(t.grad.numpy(), g, 1e-5, "grad")


def test_warp_coords_and_masked_mean_match_jax():
    rs = np.random.RandomState(5)
    pts = rs.uniform(-1, 1, (2, 6, 8, 2)).astype(np.float32)
    homo = np.stack([sample_homography((24, 32), np.random.RandomState(i))
                     for i in range(2)]).astype(np.float32)
    _close(port_kp.warp_coords_homography(torch.from_numpy(pts),
                                          torch.from_numpy(homo)).numpy(),
           jax_kp.warp_coords_homography(pts, homo), 1e-6)
    x = rs.randn(2, 6, 8).astype(np.float32)
    mask = rs.rand(1, 6, 8) < 0.5
    _close(port_kp.masked_mean(torch.from_numpy(x),
                               torch.from_numpy(mask)).item(),
           jax_kp.masked_mean(x, mask), 1e-6)


# ------------------------------------------------ inlier net and BatchNorm

def test_inlier_net_train_forward_and_bn_update_match_jax(io_params):
    """The pinned S8 inlier net in train mode on seeded point pairs (B 2,
    N 64): logits and the updated batch statistics of every BN (torch
    momenta 0.9 on p_in_bn, 0.1 on the blocks'), 1e-5; then eval mode."""
    params, stats = io_params
    pp = np.random.RandomState(6).randn(2, 64, 5).astype(np.float32)
    net = JaxInlierNet(blocks=4)
    out, mut = jax.jit(lambda p, s, x: net.apply(
        {"params": p, "batch_stats": s}, x, True,
        mutable=["batch_stats"]))(params, stats, pp)
    port = load_jax_inlier_net(InlierNet(), params, stats).train()
    with torch.no_grad():
        got = port(torch.from_numpy(pp))
    _close(got.numpy(), out, 1e-5, "train logits")
    new = mut["batch_stats"]
    for name, bn in ((k, m) for k, m in port.named_modules()
                     if "_bn" in k):
        _close(bn.running_mean.numpy(), new[name]["mean"], 1e-5, name)
        _close(bn.running_var.numpy(), new[name]["var"], 1e-5, name)
    want = jax.jit(lambda p, s, x: net.apply(
        {"params": p, "batch_stats": s}, x, False))(
        params, jax.tree_util.tree_map(np.asarray, new), pp)
    with torch.no_grad():
        _close(port.eval()(torch.from_numpy(pp)).numpy(), want, 1e-5, "eval")


def test_batchnorm_train_keeps_flax_running_statistics():
    """modules/blocks.BatchNorm2d in train mode against flax's BatchNorm
    (momentum 1 - 0.1): output, running mean and the running average of
    the *biased* batch variance, 1e-6 (nn.BatchNorm2d averages the
    unbiased one: 1/(n-1) apart)."""
    rs = np.random.RandomState(7)
    x = (rs.randn(4, 5, 3, 6) * 2 + 1).astype(np.float32)  # NHWC
    mean0, var0 = rs.randn(6).astype(np.float32), rs.rand(6).astype(
        np.float32) + 0.5
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5)
    y, mut = bn.apply({"params": {"scale": np.ones(6, np.float32),
                                  "bias": np.zeros(6, np.float32)},
                       "batch_stats": {"mean": mean0, "var": var0}}, x,
                      mutable=["batch_stats"])
    port = BatchNorm2d(6, eps=1e-5, momentum=0.1).train()
    port.running_mean.copy_(torch.from_numpy(mean0))
    port.running_var.copy_(torch.from_numpy(var0))
    got = port(nchw(x))
    _close(nhwc(got), y, 1e-5, "output")
    _close(port.running_mean.numpy(), mut["batch_stats"]["mean"], 1e-6)
    _close(port.running_var.numpy(), mut["batch_stats"]["var"], 1e-6)


# ------------------------------------------------------ dropout, schedules

def test_channel_dropout_drops_whole_channels_reproducibly():
    """Train mode: each (image, channel) map is all zero or all scaled by
    1 / 0.8; the dropped share of 8 x 256 maps is within 0.2 +- 0.035
    (4 standard deviations); the same seed gives the same mask, another
    seed another; eval mode and rate 0 are the identity."""
    x = torch.ones(8, 256, 5, 7)
    drop = Dropout2d(0.2).train()
    drop.generator = torch.Generator().manual_seed(0)
    y = drop(x)
    maps = y.reshape(8, 256, -1)
    zero = (maps == 0).all(-1)
    kept = torch.isclose(maps, torch.tensor(1.25)).all(-1)
    assert bool((zero | kept).all())
    assert abs(zero.float().mean().item() - 0.2) <= 0.035
    drop.generator = torch.Generator().manual_seed(0)
    assert torch.equal(drop(x), y)
    drop.generator = torch.Generator().manual_seed(1)
    assert not torch.equal(drop(x), y)
    assert torch.equal(drop.eval()(x), x)
    drop.train().rate = 0.0
    assert torch.equal(drop(x), x)


@pytest.mark.parametrize("name", ["none", "step", "cosine", "plateau"])
def test_lr_schedules_match_jax(name):
    """lr(step) of every scheduler over 30 epochs of 7 steps, 1e-9
    (float32 arithmetic on both sides)."""
    j = jax_sched.make_lr_schedule(name, 5e-4, 7, 30)
    p = port_sched.make_lr_schedule(name, 5e-4, 7, 30)
    for s in range(0, 210, 3):
        assert abs(p(s) - float(j(jnp.int32(s)))) <= 1e-9, s


@pytest.mark.parametrize("schedule", ["default", "refined", "D", "none"])
def test_loss_weight_schedules_match_jax(schedule):
    for epoch in (0, 3, 5, 10, 25, 30, 50, 75, 90, 95, 120):
        assert tuple(port_sched.loss_weights_for_epoch(epoch, schedule)) == \
            tuple(jax_sched.loss_weights_for_epoch(epoch, schedule))


def test_plateau_controller_matches_jax():
    rs = np.random.RandomState(8)
    metrics = list(rs.randn(40).cumsum() * 0.1) + [float("nan")] * 3
    for mode in ("max", "min"):
        j = jax_sched.PlateauController(1e-3, mode=mode, patience=2)
        p = port_sched.PlateauController(1e-3, mode=mode, patience=2)
        assert [p.step(m) for m in metrics] == [j.step(m) for m in metrics]
