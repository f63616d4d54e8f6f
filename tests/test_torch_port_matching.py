"""The port's matching modules on the CPU against the JAX package: LightGlue's
host-staged adaptive depth (``matching/adaptive.py``), static-bucket width
pruning (``matching/width_pruning.py``) and the detector-free dense matcher
(``matching/dense.py``), with pinned S8 and pinned LightGlue (kp2dtiny_S).
The same numpy inputs (from seeds) go through both packages; the JAX side
runs under ``jax.jit``. Each test states its tolerance. A case that needs
the card skips where CUDA is absent."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from nanovs_slam_torch.configs import get_config
from nanovs_slam_torch.matching import adaptive, dense, width_pruning
from nanovs_slam_torch.matching.configs import LIGHTGLUE_CONFIGS
from nanovs_slam_torch.matching.extractor import make_extractor
from nanovs_slam_torch.matching.lightglue import (LightGlue, inference_forward,
                                                  normalize_keypoints)
from nanovs_slam_torch.matching.synthetic import textured_frame, warp_frame
from nanovs_slam_torch.models.kp2dtiny import build_model
from nanovs_slam_torch.utils.checkpoint import load_npz_checkpoint
from nanovs_slam_torch.utils.convert import (load_jax_lightglue,
                                             load_jax_variables)

jax = pytest.importorskip("jax")
jnp = jax.numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PINNED_EX = os.path.join(REPO, "pinned", "extractor_S8.npz")
PINNED_LG = os.path.join(REPO, "pinned", "lightglue_S.npz")
K = 512


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _extractor():
    tree, _ = load_npz_checkpoint(PINNED_EX)
    cfg = get_config("S", n_classes=8)
    return load_jax_variables(build_model(cfg), tree["params"],
                              tree["batch_stats"]).eval(), cfg, tree


@pytest.fixture(scope="module")
def pair_data():
    """LightGlue's input for the synthetic homography pair (120x160, the
    pinned S8 extractor, K = 512 keypoints a frame) as numpy."""
    ex, cfg, _ = _extractor()
    h, w = 120, 160
    img0 = textured_frame(h, w, 5)
    img1 = warp_frame(img0)
    extract = make_extractor(ex, cfg, h, w, K, 0.0, "cpu")
    e0, e1 = extract(img0[None] * 2 - 1), extract(img1[None] * 2 - 1)
    data = {"keypoints0": normalize_keypoints(e0["keypoints"], (w, h)),
            "keypoints1": normalize_keypoints(e1["keypoints"], (w, h)),
            "descriptors0": e0["descriptors"],
            "descriptors1": e1["descriptors"],
            "mask0": e0["mask"], "mask1": e1["mask"]}
    return {k: v.numpy() for k, v in data.items()}


def _pinned_lightglue(edit=None, **overrides):
    """(JAX module, params, port module) of pinned LightGlue; ``edit``
    changes the flax params (numpy) first."""
    from nanovs_slam_tpu.matching.configs import LIGHTGLUE_CONFIGS as JC
    from nanovs_slam_tpu.matching.lightglue import LightGlue as JaxLightGlue

    params = load_npz_checkpoint(PINNED_LG)[0]["params"]
    if edit is not None:
        params = jax.tree_util.tree_map(np.array, params)
        edit(params)
    jm = JaxLightGlue(dataclasses.replace(JC["kp2dtiny_S"], **overrides))
    port = load_jax_lightglue(LightGlue(dataclasses.replace(
        LIGHTGLUE_CONFIGS["kp2dtiny_S"], **overrides)), params).eval()
    return jm, params, port


def _t(data):
    return {k: torch.from_numpy(v) for k, v in data.items()}


def _j(data):
    return {k: jnp.asarray(v) for k, v in data.items()}


def _hold(got, want, keys=("prune0", "prune1")):
    """matches0 equal on >= 99.9% of the entries, matching scores within
    1e-4, ``keys`` equal."""
    m_got, m_want = got["matches0"].numpy(), np.asarray(want["matches0"])
    assert m_got.shape == m_want.shape
    assert (m_got == m_want).mean() >= 0.999
    for k in ("matching_scores0", "matching_scores1"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-4, rtol=0, err_msg=k)
    for k in keys:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=k)


# ------------------------------------------------------------ adaptive depth

@pytest.mark.parametrize("depth_confidence, exit_layer",
                         [(0.95, 3), (0.5, 1), (0.0, 0)])
def test_adaptive_lightglue_matches_jax(pair_data, depth_confidence,
                                        exit_layer):
    """AdaptiveLightGlue on the homography pair: the exit layer equal to
    JAX's (on this pair: the last layer at 0.95, layer 1 at 0.5, layer 0
    at 0.0), matches0 equal on >= 99.9%, scores within 1e-4;
    early_exit_forward gives the same."""
    from nanovs_slam_tpu.matching.adaptive import \
        AdaptiveLightGlue as JaxAdaptive

    jm, params, port = _pinned_lightglue()
    want = JaxAdaptive(jm, params, depth_confidence)(_j(pair_data))
    got = adaptive.AdaptiveLightGlue(port, depth_confidence)(_t(pair_data))
    assert got["exit_layer"] == want["exit_layer"] == exit_layer
    _hold(got, want, ("exit_layer",))
    again = adaptive.early_exit_forward(port, _t(pair_data),
                                        depth_confidence)
    assert again["exit_layer"] == exit_layer
    assert torch.equal(again["matches0"], got["matches0"])


def test_adaptive_one_layer_runs_layer_0():
    """A one-layer LightGlue: the JAX ``early_exit_forward`` finalizes the
    embedded descriptors without running its only layer
    (``nanovs_slam_tpu/matching/adaptive.py:116-121``). The port runs the
    layer: its early exit equals its own static forward (matches equal,
    log assignment within 1e-5), and differs from finalizing the embedding
    alone."""
    torch.manual_seed(4)
    cfg = dataclasses.replace(LIGHTGLUE_CONFIGS["kp2dtiny_S"], n_layers=1)
    port = LightGlue(cfg).eval()
    rs = np.random.RandomState(6)
    data = _t({"keypoints0": rs.uniform(-1, 1, (1, 64, 2)),
               "keypoints1": rs.uniform(-1, 1, (1, 48, 2)),
               "descriptors0": rs.randn(1, 64, 32),
               "descriptors1": rs.randn(1, 48, 32)})
    data = {k: v.float() for k, v in data.items()}
    got = adaptive.early_exit_forward(port, data, 0.95)
    with torch.no_grad():
        want = port(data)
        d0, d1, _, _ = port.embed(data)
        skipped = port.finalize(0, d0, d1)
    assert got["exit_layer"] == 0
    assert torch.equal(got["matches0"], want["matches0"])
    torch.testing.assert_close(got["log_assignment"], want["log_assignment"],
                               atol=1e-5, rtol=0)
    assert (got["log_assignment"] - skipped["log_assignment"]).abs().max() \
        > 1e-2


# ------------------------------------------------------------ width pruning

def test_prune_schedule_matches_jax():
    from nanovs_slam_tpu.matching.width_pruning import (_pow2_at_least,
                                                        prune_schedule)

    for args in ((1024, 9, 128), (1024, 4, 128, 1), (128, 4, 128),
                 (512, 4, 128, None, 300), (512, 4, 128, None, 600),
                 (1000, 6, 100, 2)):
        assert width_pruning.prune_schedule(*args) == prune_schedule(*args)
    for k in (0, 1, 128, 129, 700):
        assert width_pruning._pow2_at_least(k, 128) == _pow2_at_least(k, 128)


def _prunable(shift):
    """An edit of pinned LightGlue's params: every token confident (the
    token heads' biases raised) and the matchability logits lowered by
    ``shift``, so that the keep rule at 0.99 prunes."""
    def edit(params):
        for i in range(3):
            params[f"token_confidence_{i}"]["token"]["bias"][:] = 20.0
        for i in range(4):
            params[f"log_assignment_{i}"]["matchability"]["bias"][:] -= shift
    return edit


EDITS = {"pinned": None, "prunable": _prunable(6.0),
         "floored": _prunable(5.7)}


@pytest.mark.parametrize("case", ["pinned", "prunable"])
def test_width_pruned_forward_matches_jax(pair_data, case):
    """width_pruned_forward at width_confidence 0.99 on K = 512 (the
    schedule 512 -> 256 -> 128 -> 128, floored by nothing): matches0 equal
    on >= 99.9%, scores within 1e-4, prune0 / prune1 equal; with pinned
    LightGlue, and with its heads edited so that the keep rule drops
    points."""
    from nanovs_slam_tpu.matching.width_pruning import \
        width_pruned_forward as jax_pruned

    jm, params, port = _pinned_lightglue(EDITS[case])
    want = jax_pruned(jm, params, _j(pair_data), 0.99)
    got = width_pruning.width_pruned_forward(port, _t(pair_data), 0.99)
    _hold(got, want)
    # the schedule keeps 128 points a side: at least 384 are pruned
    assert (got["prune0"] < 4).sum() >= 384
    assert (got["matches0"] >= 0).sum() > 20


@pytest.mark.parametrize("case, floors", [("pinned", (512, 512)),
                                          ("floored", (256, 256)),
                                          ("prunable", (128, 128))])
def test_engaged_width_forward_matches_jax(pair_data, case, floors):
    """engaged_width_forward at 0.99 on K = 512, against JAX: with pinned
    LightGlue the keep counts reach 512 and the plain forward runs; with
    edited heads the counts floor the schedule at the buckets ``floors``
    (199 / 223 kept: 256; fewer than 128: 128). matches0 equal on >= 99.9%, scores within 1e-4, prune0 /
    prune1 equal. ``inference_forward`` dispatches there for
    width_confidence > 0."""
    from nanovs_slam_tpu.matching.width_pruning import (
        _keep_count_probe, engaged_width_forward)

    edit = EDITS[case]
    jm, params, port = _pinned_lightglue(edit)
    counts = width_pruning._keep_count_probe(port, _t(pair_data), 0.99)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(
        _keep_count_probe(jm, params, _j(pair_data), 0.99)))
    got_floors = tuple(width_pruning._pow2_at_least(int(c), 128)
                       for c in counts)
    assert got_floors == floors
    want = engaged_width_forward(jm, params, _j(pair_data), 0.99)
    got = width_pruning.engaged_width_forward(port, _t(pair_data), 0.99)
    _hold(got, want)
    _, _, port_w = _pinned_lightglue(edit, width_confidence=0.99)
    via = inference_forward(port_w, _t(pair_data))
    assert torch.equal(via["matches0"], got["matches0"])
    assert torch.equal(via["prune0"], got["prune0"])


def test_width_pruning_exact_when_the_bucket_holds_every_point(pair_data):
    """width_confidence = 1 keep-flags every point, and the 100 valid
    points of each side fit the last bucket (128): the pruned result
    equals the port's unpruned forward (matches equal, matched scores
    within 1e-5), and no valid point reports as pruned."""
    data = dict(pair_data)
    for i in (0, 1):
        data[f"mask{i}"] = np.arange(K)[None] < 100
    _, _, port = _pinned_lightglue()
    got = width_pruning.width_pruned_forward(port, _t(data), 1.0)
    with torch.no_grad():
        want = port(_t(data))
    for k in ("matches0", "matches1"):
        assert torch.equal(got[k], want[k]), k
    matched = want["matches0"][0] >= 0
    assert matched.sum() > 10
    torch.testing.assert_close(got["matching_scores0"][0][matched],
                               want["matching_scores0"][0][matched],
                               atol=1e-5, rtol=0)
    assert (got["prune0"][0, :100] == 4).all()


# ------------------------------------------------------------ dense matcher

def _unit(rs, *shape):
    x = rs.randn(*shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def test_coarse_match_and_fine_refine_match_jax():
    """coarse_match on 600 cells (idx equal, conf within 1e-5) and
    fine_refine on points inside, on the border and outside the map,
    with exact .5 ties of the rounding (offsets within 1e-5)."""
    from nanovs_slam_tpu.matching import dense as jd

    rs = np.random.RandomState(0)
    d0 = _unit(rs, 600, 32)
    d1 = d0[rs.permutation(600)] + 0.3 * rs.randn(600, 32).astype(np.float32)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    j_w, c_w = jax.jit(jd.coarse_match)(d0, d1)
    j_g, c_g = dense.coarse_match(torch.from_numpy(d0), torch.from_numpy(d1))
    np.testing.assert_array_equal(j_g.numpy(), np.asarray(j_w))
    np.testing.assert_allclose(c_g.numpy(), np.asarray(c_w), atol=1e-5)
    assert (c_g > 0).sum() > 100

    f1 = _unit(rs, 24, 40, 32)
    d0c = rs.randn(80, 32).astype(np.float32)
    py = rs.uniform(-2, 26, 80).astype(np.float32)
    px = rs.uniform(-2, 42, 80).astype(np.float32)
    py[:6] = [0.5, 1.5, 2.5, 23.5, -0.5, 24.5]
    px[:6] = [38.5, 0.5, 3.5, 39.5, 12.5, -0.5]
    want = jax.jit(jd.fine_refine, static_argnums=(4,))(f1, d0c, py, px, 5)
    got = dense.fine_refine(*(torch.from_numpy(a) for a in (f1, d0c, py,
                                                            px)), 5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_coarse_match_argmax_ties_take_the_first():
    """Rows of exact ties (image 1 holds each descriptor twice): the best
    match is the first of the tied columns, as jnp.argmax gives it, and
    the tied pairs fail the mutual check (a column's best row is then the
    first too)."""
    from nanovs_slam_tpu.matching import dense as jd

    rs = np.random.RandomState(1)
    d0 = _unit(rs, 50, 16)
    d1 = np.concatenate([d0, d0])  # column j and j + 50 tie
    j_w, c_w = jax.jit(jd.coarse_match)(d0, d1)
    j_g, c_g = dense.coarse_match(torch.from_numpy(d0), torch.from_numpy(d1))
    np.testing.assert_array_equal(j_g.numpy(), np.asarray(j_w))
    np.testing.assert_array_equal(j_g.numpy(), np.arange(50))
    np.testing.assert_allclose(c_g.numpy(), np.asarray(c_w), atol=1e-6)


def test_coarse_match_argmax_ties_on_card(cuda):
    """The same tied rows on the card: the first of the tied columns."""
    rs = np.random.RandomState(1)
    d0 = torch.from_numpy(_unit(rs, 50, 16))
    d1 = torch.cat([d0, d0])
    j_c, c_c = dense.coarse_match(d0.to(cuda), d1.to(cuda))
    j, c = dense.coarse_match(d0, d1)
    assert torch.equal(j_c.cpu(), j)
    torch.testing.assert_close(c_c.cpu(), c, atol=1e-6, rtol=0)


def _jax_dense(size, k):
    """The JAX DenseMatcher with pinned S8 and its flax model."""
    from nanovs_slam_tpu.configs import get_config as jget
    from nanovs_slam_tpu.matching.dense import DenseMatcher as JaxDense
    from nanovs_slam_tpu.models.kp2dtiny import build_model as jbuild

    _, _, tree = _extractor()
    jcfg = jget("S", n_classes=8)
    return JaxDense(jbuild(jcfg), jcfg, {"params": tree["params"],
                                         "batch_stats": tree["batch_stats"]},
                    size, k=k)


@pytest.fixture(scope="module")
def corridor_pair():
    """Two consecutive corridor frames (96x320), float [0, 1]."""
    import sys

    cv2 = pytest.importorskip("cv2")
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from make_synthetic_kitti import make_corridor_sequence

    import tempfile
    with tempfile.TemporaryDirectory() as d:
        make_corridor_sequence(d, n_frames=3, W_img=320, H_img=96, seed=3)
        cap = cv2.VideoCapture(os.path.join(d, "06.mp4"))
        frames = [cap.read()[1] for _ in range(3)]
        cap.release()
    return [f[..., ::-1].astype(np.float32) / 255.0 for f in frames[1:]]


@pytest.mark.parametrize("k", [512, 1920])
def test_dense_match_maps_match_jax(corridor_pair, k):
    """DenseMatcher.match_maps on the same fine maps (the port's, from
    pinned S8 on two corridor frames at 96x320): kp0 equal, kp1 within
    1e-3 px, conf within 1e-5. k = 1920 takes every coarse cell, so the
    tail is the exact zeros of the border and the non-mutual cells: their
    order (lower cell first, lax.top_k's) is pinned by kp0 being equal."""
    ex, cfg, _ = _extractor()
    size = (96, 320)
    dm = dense.DenseMatcher(ex, cfg, size, k=k, device="cpu")
    f0, f1 = (dm.extract(img) for img in corridor_pair)
    kp0, kp1, conf = dm.match_maps(f0, f1)
    want = _jax_dense(size, k).match_maps(jnp.asarray(f0.numpy()),
                                          jnp.asarray(f1.numpy()))
    assert kp0.shape[0] == min(k, 24 * 80)
    np.testing.assert_array_equal(kp0.numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(kp1.numpy(), np.asarray(want[1]), atol=1e-3,
                               rtol=0)
    np.testing.assert_allclose(conf.numpy(), np.asarray(want[2]), atol=1e-5,
                               rtol=0)
    if k == 1920:  # at least the border ring's 2 * 80 + 2 * 22 cells
        assert (conf == 0).sum() >= 204


def test_dense_matcher_pair_from_frames_matches_jax(corridor_pair):
    """The whole DenseMatcher pair from frames (the extraction included),
    pinned S8 at 96x320, uint8 and float frames: the kept set
    (rel_threshold 0.1) equal on >= 99.9% of the entries, kept points
    within 1e-3 px; the extraction against flax's within 1e-4."""
    ex, cfg, _ = _extractor()
    size = (96, 320)
    dm = dense.DenseMatcher(ex, cfg, size, k=512, device="cpu")
    jdm = _jax_dense(size, 512)
    img0, img1 = corridor_pair
    np.testing.assert_allclose(dm.extract(img0).numpy(),
                               np.asarray(jdm.extract(img0)), atol=1e-4)
    for a, b in ((img0, img1),
                 (np.round(img0 * 255).astype(np.uint8),
                  np.round(img1 * 255).astype(np.uint8))):
        got = dm(a, b, rel_threshold=0.1)
        want = jdm(a, b, rel_threshold=0.1)
        n = max(len(got["confidence"]), len(want["confidence"]))
        assert n > 10
        kept_g = {tuple(p) for p in got["keypoints0"]}
        kept_w = {tuple(p) for p in want["keypoints0"]}
        assert len(kept_g & kept_w) >= 0.999 * n
        m = min(len(got["keypoints1"]), len(want["keypoints1"]))
        np.testing.assert_allclose(got["keypoints1"][:m],
                                   want["keypoints1"][:m], atol=1e-3)


def test_dense_matcher_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    ex, cfg, _ = _extractor()
    with pytest.raises(RuntimeError, match="cuda"):
        dense.DenseMatcher(ex, cfg, (96, 320))
