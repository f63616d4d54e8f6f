"""The port's visual-odometry path on the CPU against the JAX package:
nearest sampling, top-K with indices, the frame resize, the frontend with
the pinned S8 extractor (with and without the semantic filter), the whole
online VO loop on the seeded corridor fixture (BF with the cv2 pose tail,
and pinned LightGlue), the odd-frame-size forward, the loop's error
handling and the entry points' refusal to fall back to the CPU. Seeded
numpy inputs go through both packages; each test states its tolerance."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from _torch_port_util import apply_jit, nchw, nhwc, random_variables
from nanovs_slam_torch.configs import get_config
from nanovs_slam_torch.models.kp2dtiny import build_model
from nanovs_slam_torch.ops.grid_sample import grid_sample_nearest
from nanovs_slam_torch.ops.postprocess import top_k_keypoints
from nanovs_slam_torch.utils.checkpoint import load_npz_checkpoint
from nanovs_slam_torch.utils.convert import load_jax_variables
from nanovs_slam_torch.vo import visual_odometry as port_vo
from nanovs_slam_torch.vo.camera import PinholeCamera, kitti_params
from nanovs_slam_torch.vo.frontend import KP2DTinyFrontend

cv2 = pytest.importorskip("cv2")
jax = pytest.importorskip("jax")
jnp = jax.numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PINNED_EX = os.path.join(REPO, "pinned", "extractor_S8.npz")
PINNED_LG = os.path.join(REPO, "pinned", "lightglue_S.npz")
H, W = 96, 320


# ------------------------------------------------------------------- ops

def test_native_matcher_builds_and_matches_numpy(tmp_path, monkeypatch):
    """The native BF matcher, built from native/matcher.cpp by the C++
    compiler itself into a new build directory, past a $CXX that fails as
    a compiler without its OpenMP runtime does: the next compiler (c++ or
    g++) builds it, the failure's message is kept in ``build_log``, and
    its matches equal the numpy matcher's (distances within 1e-5)."""
    from nanovs_slam_torch.vo import native
    from nanovs_slam_torch.vo.matcher import ratio_test_match_one_to_one

    bad = tmp_path / "bad-c++"
    bad.write_text("#!/bin/sh\necho \"fatal error: cannot read spec file "
                   "'libgomp.spec'\" >&2\nexit 1\n")
    bad.chmod(0o755)
    monkeypatch.setenv("CXX", str(bad))
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    for attr, v in (("_LIB", None), ("_TRIED", False), ("build_log", None)):
        monkeypatch.setattr(native, attr, v)
    assert native.native_available()
    assert "libgomp.spec" in native.build_log
    assert list((tmp_path / "build").glob("matcher-*/libmatcher.so"))
    rs = np.random.RandomState(3)
    d0 = rs.randn(400, 32).astype(np.float32)
    d1 = np.concatenate([d0[:300] + 0.2 * rs.randn(300, 32),
                         rs.randn(150, 32)]).astype(np.float32)
    for ratio in (0.7, 0.9):
        got = native.ratio_match_native(d0, d1, ratio)
        want = ratio_test_match_one_to_one(d0, d1, ratio)
        assert len(got[0]) > 50
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[2], want[2], rtol=1e-5, atol=1e-5)


def test_grid_sample_nearest_matches_jax():
    """Exact, with points exactly on the .5 ties of both axes and points
    outside [-0.5, size - 0.5] (zero). W - 1 = 8 and H - 1 = 4 make the
    normalised coordinates exact."""
    from nanovs_slam_tpu.ops.grid_sample import grid_sample_nearest as jgs

    rs = np.random.RandomState(0)
    img = rs.randn(2, 5, 9, 3).astype(np.float32)
    ties_x = np.arange(-1.0, 9.5, 0.5)  # 21 values, every .5 of x
    ties_y = np.arange(-1.0, 5.5, 0.5)[np.arange(21) % 13]
    px = np.concatenate([ties_x, rs.uniform(-2, 10, 21)])
    py = np.concatenate([ties_y, rs.uniform(-2, 6, 21)])
    pts = np.stack([px / 4.0 - 1.0, py / 2.0 - 1.0], -1).astype(np.float32)
    grid = np.stack([pts, pts[::-1]]).reshape(2, 3, -1, 2)
    want = np.asarray(jgs(jnp.asarray(img), jnp.asarray(grid)))
    got = grid_sample_nearest(torch.from_numpy(img),
                              torch.from_numpy(grid)).numpy()
    assert got.shape == want.shape == (2, 3, grid.shape[2], 3)
    np.testing.assert_array_equal(got, want)
    assert (got == 0).all(-1).any()  # some points fell outside


def test_top_k_keypoints_with_indices_matches_jax():
    """Exact indices and values on scores with many ties (quantised)."""
    from nanovs_slam_tpu.ops.postprocess import top_k_keypoints as jtk

    rs = np.random.RandomState(1)
    score = (np.round(rs.rand(2, 12, 16, 1) * 8) / 8).astype(np.float32)
    coord = rs.rand(2, 12, 16, 2).astype(np.float32)
    feat = rs.randn(2, 12, 16, 8).astype(np.float32)
    want = jtk(*(jnp.asarray(a) for a in (score, coord, feat)), 50, 0.5,
               with_indices=True)
    got = top_k_keypoints(*(torch.from_numpy(a) for a in
                            (score, coord, feat)), 50, 0.5,
                          with_indices=True)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_prep_frame_matches_cv2_resize():
    """KITTI's 376x1241 BGR frame to the VO's 128x512 in float: the torch
    bilinear resize against cv2.resize (INTER_LINEAR), within 1e-6."""
    from nanovs_slam_tpu.vo.visual_odometry import prep_frame as jprep

    rs = np.random.RandomState(2)
    frame = rs.randint(0, 256, (376, 1241, 3)).astype(np.uint8)
    want = jprep(frame, (128, 512))
    got = port_vo.prep_frame(frame, (128, 512)).numpy()
    assert got.shape == want.shape == (128, 512, 3)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(port_vo.prep_frame(frame).numpy(),
                               jprep(frame), atol=1e-7, rtol=0)


# -------------------------------------------------------------- frontend

def _pinned_pair():
    """(JAX model, cfg, variables), (port model, cfg) with pinned S8."""
    from nanovs_slam_tpu.configs import get_config as jget
    from nanovs_slam_tpu.models.kp2dtiny import build_model as jbuild

    tree, _ = load_npz_checkpoint(PINNED_EX)
    variables = {"params": tree["params"], "batch_stats": tree["batch_stats"]}
    jcfg = jget("S", n_classes=8)
    cfg = get_config("S", n_classes=8)
    port = load_jax_variables(build_model(cfg), tree["params"],
                              tree["batch_stats"])
    return (jbuild(jcfg), jcfg, variables), (port, cfg)


@pytest.fixture(scope="module")
def corridor(tmp_path_factory):
    """The seeded corridor sequence (6 frames at 96x320, KITTI poses)."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from make_synthetic_kitti import make_corridor_sequence

    out = str(tmp_path_factory.mktemp("corridor"))
    make_corridor_sequence(out, n_frames=6, W_img=W, H_img=H, seed=3)
    return out


def _frames(path):
    return list(port_vo.read_video(os.path.join(path, "06.mp4")))


@pytest.mark.parametrize("semantic", [False, True])
def test_frontend_matches_jax(corridor, semantic):
    """Pinned S8 at 96x320 on a corridor frame: keypoints within 1e-4 and
    kp_class equal, slot by slot, and descriptor cosine > 0.9999; with the
    semantic filter on the class the most keypoints fall in."""
    from nanovs_slam_tpu.vo.frontend import KP2DTinyFrontend as JFrontend

    (jm, jcfg, variables), (port, cfg) = _pinned_pair()
    img = port_vo.prep_frame(_frames(corridor)[1]).numpy()
    kw = dict(nn_thresh=0.7, top_k=1000, with_seg=True)
    if semantic:
        cls = np.bincount(JFrontend(jm, jcfg, variables, (H, W),
                                    **kw).run(img)[2]["kp_class"]).argmax()
        kw = dict(kw, semantic_filter=True, classes_to_filter=(int(cls),))
    want = JFrontend(jm, jcfg, variables, (H, W), **kw).run(img)
    got = KP2DTinyFrontend(port, cfg, (H, W), device="cpu", **kw).run(img)
    assert len(got[0]) == len(want[0]) > 50
    np.testing.assert_allclose(got[0], want[0], atol=1e-4, rtol=0)
    assert np.sum(got[1] * want[1], -1).min() > 0.9999
    np.testing.assert_array_equal(got[2]["kp_class"], want[2]["kp_class"])
    if semantic:
        assert cls not in got[2]["kp_class"]


# ------------------------------------------------------------ the VO loop

def _record_matches(monkeypatch, cls):
    """Per-frame n_matches of every process_image of ``cls``."""
    seen = []
    orig = cls.process_image

    def process_image(self, *a, **k):
        out = orig(self, *a, **k)
        seen.append(out[2])
        return out

    monkeypatch.setattr(cls, "process_image", process_image)
    return seen


@pytest.mark.parametrize("matcher", ["bf", "lightglue"])
def test_vo_loop_matches_jax(corridor, monkeypatch, matcher):
    """The online VO over the corridor with pinned S8 (and pinned
    LightGlue): per-frame matches equal, no failed estimate, and the error
    statistics within 1e-4. Both use the host cv2 pose tail, which is
    deterministic, so the extractor is the only source of difference: its
    keypoints differ from JAX's by one float32 ulp (1.5e-5 px at x ~ 300),
    which moves cv2's unit translation by up to 2.3e-5 and the statistics
    (errors of 0.1-0.5) by up to 2.1e-5."""
    import nanovs_slam_tpu.matching.lightglue as jlg
    import nanovs_slam_tpu.vo.visual_odometry as jvo
    from nanovs_slam_tpu.vo.frontend import KP2DTinyFrontend as JFrontend

    (jm, jcfg, variables), (port, cfg) = _pinned_pair()
    kw = dict(nn_thresh=0.7, top_k=512)
    lg = dict(lightglue=PINNED_LG) if matcher == "lightglue" else {}
    if matcher == "lightglue":  # jitted, or the CPU takes minutes
        fwd = jlg.inference_forward
        jitted = {}

        def inference_forward(model, params, data):
            if model not in jitted:
                jitted[model] = jax.jit(lambda p, d: fwd(model, p, d))
            return jitted[model](params, data)

        monkeypatch.setattr(jlg, "inference_forward", inference_forward)
    want_n = _record_matches(monkeypatch, jvo.VisualOdometry)
    want = jvo.evaluate_visual_odometry(
        JFrontend(jm, jcfg, variables, (H, W), **kw), corridor, "06.txt",
        "06.mp4", new_size=(H, W), verbose=True, matcher=matcher, **lg)
    got_n = _record_matches(monkeypatch, port_vo.VisualOdometry)
    got = port_vo.evaluate_visual_odometry(
        KP2DTinyFrontend(port, cfg, (H, W), device="cpu", **kw), corridor,
        "06.txt", "06.mp4", new_size=(H, W), verbose=True, matcher=matcher,
        device="cpu", **lg)
    assert len(got_n) == len(want_n) == 5
    assert got_n == want_n
    assert min(got_n) >= 8
    assert got["estimation_fails"] == want["estimation_fails"] == 0
    assert set(got) == set(want)
    for part in ("translation", "rotation", "total"):
        for k, v in want[part].items():
            assert abs(got[part][k] - v) <= 1e-4, (part, k, got[part][k], v)


def test_vo_device_pose_runs_on_the_corridor(corridor):
    """--device_pose on the CPU: the device RANSAC tail in the loop (256
    hypotheses, 2 restarts), no failed estimate, a bounded error."""
    (_, _, _), (port, cfg) = _pinned_pair()
    got = port_vo.evaluate_visual_odometry(
        KP2DTinyFrontend(port, cfg, (H, W), device="cpu", top_k=512),
        corridor, "06.txt", "06.mp4", new_size=(H, W), verbose=True,
        device_pose=True, pose_hypotheses=256, pose_restarts=2,
        device="cpu")
    assert got["estimation_fails"] == 0
    assert got["total"]["max"] < 0.5
    assert len(got["trajectory"]) == 6


# ------------------------------------------------------ the odd frame size

def test_odd_frame_forward_matches_flax():
    """Config N at 49x65 (the stem pools with floor): the port's forward
    against flax within 1e-4."""
    from nanovs_slam_tpu.configs import get_config as jget
    from nanovs_slam_tpu.models.kp2dtiny import build_model as jbuild

    h, w = 49, 65
    model = jbuild(jget("N", n_classes=5))
    params, bs = random_variables(model, np.zeros((1, h, w, 3), np.float32),
                                  True, seed=0)
    port = load_jax_variables(build_model(get_config("N", n_classes=5)),
                              params, bs).eval()
    x = np.random.RandomState(1).uniform(-1, 1, (2, h, w, 3)).astype(
        np.float32)
    want = apply_jit(model, params, bs, x, train=False)
    with torch.no_grad():
        got = port(nchw(x))
    assert set(got) == set(want)
    for k, v in want.items():
        assert nhwc(got[k]).shape == v.shape, k
        np.testing.assert_allclose(nhwc(got[k]), v, atol=1e-4, err_msg=k)


# ------------------------------------------------------- errors and device

class _Frontend:
    """Fixed keypoints, or an error from fetch."""

    def __init__(self, n=40, error=None):
        rs = np.random.RandomState(5)
        self.kps = rs.uniform(0, 300, (n, 2)).astype(np.float32)
        self.desc = rs.randn(n, 8).astype(np.float32)
        self.error = error

    def run_async(self, img):
        return None

    def fetch(self, handle):
        if self.error is not None:
            raise self.error
        return self.kps, self.desc, {}

    def run(self, img):
        return self.fetch(None)


def _vo(frontend, **kw):
    fx, fy, cx, cy = kitti_params()
    return port_vo.VisualOdometry(frontend, PinholeCamera(320, 96, fx, fy,
                                                          cx, cy),
                                  device="cpu", **kw)


def test_vo_counts_only_failed_estimates(monkeypatch):
    """cv2's error (no matches) and too few matches for the device solver
    count as failed estimates with an identity pose; a kernel or launch
    error, and a missing cv2, propagate and count nothing."""
    vo = _vo(_Frontend(n=0))
    vo.init(None)
    R, t, n = vo.process_image(None)
    assert vo.estimation_fails == 1 and n == 0
    np.testing.assert_array_equal(R, np.eye(3))

    vo = _vo(_Frontend(n=0), device_pose=True)
    vo.init(None)
    vo.process_image(None)
    assert vo.estimation_fails == 1

    vo = _vo(_Frontend())
    vo.init(None)
    vo.frontend.error = RuntimeError("fused_stem_pair_pool: CUDA error 719")
    with pytest.raises(RuntimeError, match="CUDA error"):
        vo.process_image(None)

    def no_cv2(*a, **k):
        raise ImportError("No module named 'cv2'")

    monkeypatch.setattr(port_vo, "estimate_pose", no_cv2)
    vo = _vo(_Frontend())
    vo.init(None)
    with pytest.raises(ImportError):
        vo.process_image(None)

    def launch_error(*a, **k):
        raise RuntimeError("lightglue_transformer: CUDA error 700")

    monkeypatch.setattr(port_vo, "ransac_essential_device", launch_error)
    vo = _vo(_Frontend(), device_pose=True)
    vo.init(None)
    with pytest.raises(RuntimeError, match="CUDA error"):
        vo.process_image(None)
    assert vo.estimation_fails == 0


def test_vo_entry_points_without_card_raise(tmp_path):
    """The frontend, VisualOdometry and the CLI run on the card unless
    given the CPU; without a card they raise instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from nanovs_slam_torch import vo_eval

    cfg = get_config("S", n_classes=8)
    with pytest.raises(RuntimeError, match="cuda"):
        KP2DTinyFrontend(build_model(cfg), cfg, (H, W))
    fx, fy, cx, cy = kitti_params()
    with pytest.raises(RuntimeError, match="cuda"):
        port_vo.VisualOdometry(_Frontend(), PinholeCamera(320, 96, fx, fy,
                                                          cx, cy))
    with pytest.raises(RuntimeError, match="cuda"):
        vo_eval.main(["--kitti_path", str(tmp_path)])


def test_vo_eval_cli_on_cpu(corridor, tmp_path, monkeypatch):
    """``python -m nanovs_slam_torch.vo_eval`` with ``--device cpu`` on the
    corridor: the JSON has the keys of the root vo_eval.py (its arguments
    and ``--device``; the verbose results); --plot writes the trajectory
    beside the JSON, ``<out>_traj.png`` as the root CLI names it (it
    raised, naming ROADMAP.md, before utils/plot.py was ported; --offline
    and --matcher dense run: see tests/test_torch_port_offline.py)."""
    import vo_eval as jax_cli
    from nanovs_slam_torch import vo_eval

    out = str(tmp_path / "vo.json")
    argv = ["--kitti_path", corridor, "--config", "S", "--n_classes", "8",
            "--model_path", PINNED_EX, "--im_h", str(H), "--im_w", str(W),
            "--top_k", "512", "--max_frames", "3", "--out", out]
    assert vo_eval.main(argv + ["--device", "cpu", "--plot"]) == 0
    with open(out) as f:
        saved = json.load(f)
    monkeypatch.setattr(sys, "argv", ["vo_eval.py"] + argv)
    assert set(saved["args"]) == set(vars(jax_cli.parse_args())) | {"device"}
    assert set(saved["results"]) == {"translation", "rotation", "total",
                                     "estimation_fails", "stats",
                                     "trajectory"}
    assert saved["results"]["estimation_fails"] == 0
    png = tmp_path / "vo_traj.png"
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_datasets_match_jax(tmp_path):
    """The frame sources yield the JAX package's frames, exactly: a folder
    of PNGs, the KITTI layout and the factory."""
    from nanovs_slam_tpu.vo import datasets as jds

    from nanovs_slam_torch.vo import datasets as pds

    seq = tmp_path / "sequences" / "06" / "image_0"
    seq.mkdir(parents=True)
    rs = np.random.RandomState(6)
    for i in range(3):
        cv2.imwrite(str(seq / f"{i:06d}.png"),
                    rs.randint(0, 256, (24, 32, 3)).astype(np.uint8))
    for make in (lambda m: m.FolderDataset(str(seq)),
                 lambda m: m.FolderDatasetParallel(str(seq)),
                 lambda m: m.KittiDataset(str(tmp_path)),
                 lambda m: m.dataset_factory("folder", str(seq))):
        want, got = list(make(jds)), list(make(pds))
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_vo_loop_at_bf16_ships_uint8_frames(corridor, monkeypatch):
    """The VO loop with pinned S8 at bfloat16 turns on the uint8 transfer
    by itself, as the JAX VO does for a bf16 model: the frontend receives
    every frame as uint8, with the bytes the JAX VO ships. Against the
    float32 loop: no failed estimate, matches a pair within 10%, the total
    error's mean within 0.15 (0.455 against 0.383 here). The JAX VO at
    bf16 is no reference for these numbers: its XLA ``post_process``
    decodes and samples on the bf16 grid (ROADMAP, Queue 3)."""
    import nanovs_slam_tpu.vo.visual_odometry as jvo
    from nanovs_slam_tpu.ops.image import quantize_u8 as jquantize

    (_, _, variables), (port32, cfg) = _pinned_pair()
    cfg16 = cfg.replace(dtype="bfloat16")
    port16 = load_jax_variables(build_model(cfg16), variables["params"],
                                variables["batch_stats"])
    kw = dict(nn_thresh=0.7, top_k=512)
    runs, seen = [], []
    n_matches = _record_matches(monkeypatch, port_vo.VisualOdometry)
    orig = KP2DTinyFrontend.run_async

    def run_async(self, img):
        seen.append(img)
        return orig(self, img)

    monkeypatch.setattr(KP2DTinyFrontend, "run_async", run_async)
    for model, c in ((port32, cfg), (port16, cfg16)):
        seen.clear()
        runs.append(port_vo.evaluate_visual_odometry(
            KP2DTinyFrontend(model, c, (H, W), device="cpu", **kw),
            corridor, "06.txt", "06.mp4", new_size=(H, W), verbose=True,
            device="cpu"))
    frames = _frames(corridor)
    assert len(seen) == len(frames) and all(s.dtype == torch.uint8
                                            for s in seen)
    np.testing.assert_array_equal(
        seen[1].numpy(), jquantize(jvo.prep_frame(frames[1], (H, W))))
    assert runs[0]["estimation_fails"] == runs[1]["estimation_fails"] == 0
    assert len(n_matches) == 10  # the float32 loop's 5 pairs, then bf16's
    for w, g in zip(n_matches[:5], n_matches[5:]):
        assert abs(g - w) <= 0.1 * w, n_matches
    assert abs(runs[1]["total"]["mean"] - runs[0]["total"]["mean"]) <= 0.15
