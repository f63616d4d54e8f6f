"""The port's dense VO paths on the CPU against the JAX package: the online
VO with the dense matcher, the offline sequence VO (``vo/offline.py``) in
its dense, BF and LightGlue modes, and the CLI's ``--offline`` and
``--matcher dense``. Pinned S8 (and pinned LightGlue) on the seeded
corridor at 96x320; the same numpy inputs go through both packages, and
each test states its tolerance."""

import json
import os
import sys

import numpy as np
import pytest
import torch

import nanovs_slam_torch.vo.pose as port_pose
from nanovs_slam_torch.configs import get_config
from nanovs_slam_torch.models.kp2dtiny import build_model
from nanovs_slam_torch.utils.checkpoint import load_npz_checkpoint
from nanovs_slam_torch.utils.convert import load_jax_variables
from nanovs_slam_torch.vo import offline
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
T = 5  # frames of the offline sequence


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads for this file's torch work (the suite runs
    files in parallel workers; see test_torch_port_train_step.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corridor(tmp_path_factory):
    """The seeded corridor sequence (6 frames at 96x320, KITTI poses)."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from make_synthetic_kitti import make_corridor_sequence

    out = str(tmp_path_factory.mktemp("corridor"))
    make_corridor_sequence(out, n_frames=6, W_img=W, H_img=H, seed=3)
    return out


@pytest.fixture(scope="module")
def stack(corridor):
    """The first T corridor frames, float [0, 1], (T, H, W, 3) numpy."""
    frames = list(port_vo.read_video(os.path.join(corridor, "06.mp4")))[:T]
    return torch.stack([port_vo.prep_frame(f) for f in frames]).numpy()


@pytest.fixture(scope="module")
def pinned():
    """(port model, cfg), (JAX model, cfg, variables) of pinned S8."""
    from nanovs_slam_tpu.configs import get_config as jget
    from nanovs_slam_tpu.models.kp2dtiny import build_model as jbuild

    tree, _ = load_npz_checkpoint(PINNED_EX)
    cfg = get_config("S", n_classes=8)
    port = load_jax_variables(build_model(cfg), tree["params"],
                              tree["batch_stats"]).eval()
    jcfg = jget("S", n_classes=8)
    variables = {"params": tree["params"], "batch_stats": tree["batch_stats"]}
    return (port, cfg), (jbuild(jcfg), jcfg, variables)


def _cam():
    fx, fy, cx, cy = kitti_params()
    return PinholeCamera(W, H, fx, fy, cx, cy)


def _offline_pair(pinned, matcher, **kw):
    """The port's and the JAX package's OfflineVO, built alike."""
    from nanovs_slam_tpu.vo.offline import OfflineVO as JaxOffline
    from nanovs_slam_tpu.vo.visual_odometry import \
        load_lightglue_for_vo as jload

    (port, cfg), (jm, jcfg, variables) = pinned
    k = kw.pop("k", 512 if matcher == "dense" else 1024)
    lg = jlg = None
    if matcher == "lightglue":
        lg = port_vo.load_lightglue_for_vo(PINNED_LG, 32, (W, H))
        jlg = jload(PINNED_LG, 32, (W, H))[:2]
    kw = dict(k=k, matcher=matcher, n_hypotheses=256, restarts=1,
              extract_chunk=T, **kw)
    return (offline.OfflineVO(port, cfg, (H, W), _cam(), lightglue=lg,
                              device="cpu", **kw),
            JaxOffline(jm, jcfg, variables, (H, W), _cam(), lightglue=jlg,
                       **kw))


def _jax_reps(reps):
    return jax.tree.map(lambda a: jnp.asarray(a.numpy()), reps)


# --------------------------------------------------------- the online loop

def _record_matches(monkeypatch, cls):
    seen = []
    orig = cls.process_image

    def process_image(self, *a, **k):
        out = orig(self, *a, **k)
        seen.append(out[2])
        return out

    monkeypatch.setattr(cls, "process_image", process_image)
    return seen


def test_online_dense_vo_matches_jax(corridor, pinned, monkeypatch):
    """The online VO with the dense matcher (k = top_k = 512, the JAX
    CLI's; relative threshold 0.1, topped up to 400) over the corridor,
    the host cv2 pose tail on both: per-frame matches equal, no failed
    estimate, the error statistics within 1e-4 (the matches' points
    differ from XLA's by float32 rounding, which moves cv2's unit
    translation by ~1e-5)."""
    import nanovs_slam_tpu.vo.visual_odometry as jvo
    from nanovs_slam_tpu.matching.dense import DenseMatcher as JaxDense
    from nanovs_slam_tpu.vo.frontend import KP2DTinyFrontend as JFrontend

    (port, cfg), (jm, jcfg, variables) = pinned
    want_n = _record_matches(monkeypatch, jvo.VisualOdometry)
    want = jvo.evaluate_visual_odometry(
        JFrontend(jm, jcfg, variables, (H, W), top_k=512), corridor,
        "06.txt", "06.mp4", new_size=(H, W), verbose=True, matcher="dense",
        dense=JaxDense(jm, jcfg, variables, (H, W), k=512))
    got_n = _record_matches(monkeypatch, port_vo.VisualOdometry)
    got = port_vo.evaluate_visual_odometry(
        KP2DTinyFrontend(port, cfg, (H, W), top_k=512, device="cpu"),
        corridor, "06.txt", "06.mp4", new_size=(H, W), verbose=True,
        matcher="dense", device="cpu")
    assert len(got_n) == len(want_n) == 5
    assert got_n == want_n and min(got_n) >= 400
    assert got["estimation_fails"] == want["estimation_fails"] == 0
    assert set(got) == set(want)
    for part in ("translation", "rotation", "total"):
        for k, v in want[part].items():
            assert abs(got[part][k] - v) <= 1e-4, (part, k, got[part][k], v)


# ------------------------------------------------------------ offline VO

@pytest.mark.parametrize("matcher", ["dense", "bf", "lightglue"])
def test_offline_match_map_matches_jax(stack, pinned, matcher):
    """The match map of every pair of the sequence, on the same frame
    representations (the port's extraction), against JAX's ``_match_map``:
    the correspondences within 1e-5 where both are valid, ``valid`` equal
    (LightGlue: on >= 99.9% of the entries). The port's extraction against
    JAX's: dense maps within 1e-4; keypoints within 1e-4 px on >= 99.9%
    of the slots (near-equal scores may swap two cells) and masks
    equal."""
    vo, jvo = _offline_pair(pinned, matcher)
    reps = vo.extract(stack)
    kpn0, kpn1, valid = vo.match_map(reps)
    w0, w1, wv = (np.asarray(a) for a in jvo._match_map(_jax_reps(reps)))
    assert kpn0.shape == w0.shape and valid.shape == wv.shape
    assert kpn0.shape[0] == T - 1
    v = valid.numpy()
    agree = (v == wv).mean()
    assert agree >= (0.999 if matcher == "lightglue" else 1.0), agree
    both = v & wv
    assert both.sum(1).min() >= 100
    np.testing.assert_allclose(kpn0.numpy()[both], w0[both], atol=1e-5)
    np.testing.assert_allclose(kpn1.numpy()[both], w1[both], atol=1e-5)
    want = jvo._extract_batch(jvo.variables, stack)
    if matcher == "dense":
        np.testing.assert_allclose(reps.numpy(), np.asarray(want), atol=1e-4)
    else:  # near-equal scores may swap two cells' slots
        near = np.abs(reps[0].numpy() - np.asarray(want[0])).max(-1) <= 1e-4
        assert near.mean() >= 0.999, near.mean()
        np.testing.assert_array_equal(reps[2].numpy(), np.asarray(want[2]))


def test_offline_pose_matches_jax_under_injected_noise(stack, pinned,
                                                       monkeypatch):
    """The pose map on dense pairs 0 and 2 (256 hypotheses, 1 restart, 2
    LO rounds), both sides drawing the same numpy gumbel noise (the JAX
    function through patched ``jax.random`` split / gumbel / fold_in, the
    port through ``vo.pose.gumbel_noise``). The port solves in float64,
    so JAX's ``_pose_step`` runs under ``jax.enable_x64`` on the same
    correspondences in float64 (in float32 the two packages' roundings
    pick different MSAC winners on these pairs). R and t within 1e-4,
    inlier and match counts equal."""
    vo, jvo = _offline_pair(pinned, "dense")
    kpn0, kpn1, valid = vo.match_map(vo.extract(stack))
    hyp, lo, N = 256, 2, kpn0.shape[1]
    table = np.random.RandomState(11).gumbel(
        size=(1, 1 + lo, hyp, N)).astype(np.float32)

    def split(key, num=2):
        c = jnp.asarray(key)[0]
        return jnp.stack([jnp.stack([c * 16 + i + 1, jnp.asarray(key)[1]])
                          for i in range(num)])

    def gumbel(key, shape, dtype=jnp.float32):
        c = jnp.asarray(key)[0]
        r = jnp.maximum(c // 16, 1) - 1
        assert tuple(shape) == (hyp, N)
        return jnp.take(jnp.asarray(table.reshape(-1, hyp, N)),
                        r * (1 + lo) + c % 16 - 1, axis=0)

    pairs = [0, 2]
    with monkeypatch.context() as m, jax.enable_x64():
        m.setattr(jax.random, "split", split)
        m.setattr(jax.random, "gumbel", gumbel)
        m.setattr(jax.random, "fold_in", lambda key, i: key)
        step = jax.jit(jvo._pose_step)
        want = [[np.asarray(a) for a in step(
            jnp.asarray(kpn0[i].double().numpy()),
            jnp.asarray(kpn1[i].double().numpy()),
            jnp.asarray(valid[i].numpy()), i, jnp.zeros((2,), jnp.uint32))]
            for i in pairs]
    stage = iter(list(range(1 + lo)) * len(pairs))

    def gumbel_noise(shape, generator):
        assert tuple(shape) == (1, hyp, N)
        return torch.from_numpy(table[:, next(stage)])

    monkeypatch.setattr(port_pose, "gumbel_noise", gumbel_noise)
    R, t, ninl, nmat = vo.pose_map(kpn0[pairs], kpn1[pairs], valid[pairs])
    for j, (Rw, tw, inl_w, n_w) in enumerate(want):
        np.testing.assert_allclose(R[j].numpy(), Rw, atol=1e-4)
        np.testing.assert_allclose(t[j].numpy(), tw, atol=1e-4)
        assert int(ninl[j]) == int(inl_w) > 100
        assert int(nmat[j]) == int(n_w)


def test_offline_pair_streams_are_independent(stack, pinned):
    """Pair i draws from ``pair_generator(seed, i)`` alone: the pose map
    over all pairs gives pair 2 the pose that one RANSAC from that
    generator gives it, and two runs of relative_poses are equal. Rotations
    are orthonormal, translations unit, inliers at most the matches."""
    vo, _ = _offline_pair(pinned, "bf")
    kpn0, kpn1, valid = vo.match_map(vo.extract(stack))
    R, t, ninl, nmat = vo.pose_map(kpn0, kpn1, valid, seed=5)
    R2, t2, inl2 = port_pose.ransac_essential_device(
        kpn0[2].double(), kpn1[2].double(), offline.pair_generator(5, 2, "cpu"),
        valid=valid[2], n_hypotheses=256, restarts=1)
    assert torch.equal(R[2], R2) and torch.equal(t[2], t2[:, 0])
    assert int(ninl[2]) == int(inl2.sum())
    out = vo.relative_poses(stack, seed=5)
    again = vo.relative_poses(stack, seed=5)
    for a, b in zip(out, again):
        np.testing.assert_array_equal(a, b)
    Rn, tn, ninl, nmat = out
    assert Rn.shape == (T - 1, 3, 3) and tn.shape == (T - 1, 3)
    for Ri in Rn:
        np.testing.assert_allclose(Ri @ Ri.T, np.eye(3), atol=1e-9)
    np.testing.assert_allclose(np.linalg.norm(tn, axis=1), 1.0, atol=1e-9)
    assert (ninl <= nmat).all() and (nmat > 0).all()


@pytest.mark.parametrize("matcher", ["dense", "bf"])
def test_offline_extract_chunking_and_u8(stack, pinned, matcher):
    """The chunk loop (2 frames a chunk, max_single_dispatch 0) equals the
    one-batch extraction (the pad frames never reach the output), within
    1e-6; uint8 frames equal the float frames that they are exactly, within
    1e-5 (the normalisation moves after the copy, not its math)."""
    (port, cfg), _ = pinned
    kw = dict(k=512, matcher=matcher, device="cpu")
    chunked = offline.OfflineVO(port, cfg, (H, W), _cam(), extract_chunk=2,
                                max_single_dispatch=0, **kw)
    whole = offline.OfflineVO(port, cfg, (H, W), _cam(), extract_chunk=T,
                              **kw)
    u8 = np.clip(np.rint(stack * 255.0), 0, 255).astype(np.uint8)
    a, b = chunked.extract(stack), whole.extract(stack)
    c, d = whole.extract(u8), whole.extract(u8.astype(np.float32) / 255.0)
    if matcher == "dense":
        a, b, c, d = ((x,) for x in (a, b, c, d))
    assert a[0].shape[0] == T
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, atol=1e-6, rtol=0)
    for x, y in zip(c, d):
        torch.testing.assert_close(x, y, atol=1e-5, rtol=0)


def test_offline_unported_parts_raise(pinned):
    """A CUDA device without a card raises. (The sharded pose map and
    pair_batch > 1, which raised here, are ported:
    tests/test_torch_port_parallel.py and the pair_batch tests below hold
    them.)"""
    (port, cfg), _ = pinned
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            offline.OfflineVO(port, cfg, (H, W), _cam())


@pytest.fixture(scope="module")
def stack8(tmp_path_factory):
    """The seeded corridor's 8 frames (7 pairs) at 96x320, float [0, 1]."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from make_synthetic_kitti import make_corridor_sequence

    out = str(tmp_path_factory.mktemp("corridor8"))
    make_corridor_sequence(out, n_frames=8, W_img=W, H_img=H, seed=3)
    frames = list(port_vo.read_video(os.path.join(out, "06.mp4")))
    return torch.stack([port_vo.prep_frame(f) for f in frames]).numpy()


_BATCHED = {}


def _pair_batch_run(pinned, stack8, matcher, pair_batch):
    """(match map, relative poses at seed 4) of the port's OfflineVO at
    ``pair_batch`` over the 8 frames (k 512, 256 hypotheses, 2
    restarts), run once per (matcher, pair_batch); the frames are
    extracted once per matcher (the extraction takes no pair_batch)."""
    key = (matcher, pair_batch)
    if key not in _BATCHED:
        (port, cfg), _ = pinned
        lg = (port_vo.load_lightglue_for_vo(PINNED_LG, 32, (W, H))
              if matcher == "lightglue" else None)
        vo = offline.OfflineVO(
            port, cfg, (H, W), _cam(), k=512, matcher=matcher, lightglue=lg,
            n_hypotheses=256, restarts=2, pair_batch=pair_batch,
            extract_chunk=8, device="cpu")
        if matcher not in _BATCHED:
            _BATCHED[matcher] = vo.extract(stack8)
        mm = vo.match_map(_BATCHED[matcher])
        _BATCHED[key] = (mm, vo.pose_map(*mm, seed=4))
    return _BATCHED[key]


@pytest.mark.parametrize("pair_batch", [2, 3])
@pytest.mark.parametrize("matcher", ["dense", "bf", "lightglue"])
def test_offline_pair_batch_matches_pair_batch_1(pinned, stack8, matcher,
                                                 pair_batch):
    """OfflineVO at pair_batch 2 and 3 over the 8-frame corridor (7
    pairs: chunks of 2, 2, 2, 1 and 3, 3, 1, so that one is a remainder):
    the match map (one batched matcher call a chunk: bf_match_device,
    LightGlue at batch P, the dense match_maps) equal to pair_batch 1's;
    the poses of the batched RANSAC (the pairs folded into its restarts'
    axis, each drawing from its own generator) within
    relative_poses_sharded's criterion (match counts equal, R and t
    within 1e-3: equal up to MSAC's ties; a batch of other shape may sum
    in another order, measured 2.5e-15 apart with equal inlier
    counts)."""
    (mm1, poses1) = _pair_batch_run(pinned, stack8, matcher, 1)
    (mm, poses) = _pair_batch_run(pinned, stack8, matcher, pair_batch)
    assert mm[0].shape[0] == 7
    for a, b in zip(mm, mm1):
        assert torch.equal(a, b)
    assert int(mm[2].sum(1).min()) >= 50
    (R, t, _, nmat), (R1, t1, _, nmat1) = poses, poses1
    assert torch.equal(nmat, nmat1)
    assert float((R - R1).abs().max()) <= 1e-3
    assert float((t - t1).abs().max()) <= 1e-3


def test_offline_sharded_pair_batch_matches_relative_poses(pinned, stack8):
    """``relative_poses_sharded`` at pair_batch 3 on the one-rank mesh (no
    process group: its pairs' global indices, chunks of 3, 3 and 1)
    against ``relative_poses`` at pair_batch 1 (BF, seed 4), by its own
    criterion: match counts equal, R and t within 1e-3."""
    from nanovs_slam_torch.parallel.mesh import make_mesh

    (port, cfg), _ = pinned
    kw = dict(k=1024, matcher="bf", n_hypotheses=256, restarts=2,
              extract_chunk=8, device="cpu")
    want = offline.OfflineVO(port, cfg, (H, W), _cam(), **kw
                             ).relative_poses(stack8, seed=4)
    got = offline.OfflineVO(port, cfg, (H, W), _cam(), pair_batch=3, **kw
                            ).relative_poses_sharded(
        stack8, make_mesh(device="cpu"), seed=4)
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_allclose(got[0], want[0], atol=1e-3, rtol=0)
    np.testing.assert_allclose(got[1], want[1], atol=1e-3, rtol=0)


def test_offline_pair_batch_2_matches_jax(stack, pinned, monkeypatch):
    """The JAX OfflineVO at pair_batch 2 (its lax.map with batch_size 2,
    the solver vmapped over the chunk) against the port's at pair_batch
    2 (k 512): the BF match map on the same representations as
    test_offline_match_map_matches_jax holds it (valid equal, the
    correspondences within 1e-5), and the pose map of pairs 0 and 2 (one
    chunk) under the same injected noise in float64 (JAX
    under ``jax.enable_x64``, every pair of a chunk drawing the same
    table as the patched JAX key does): R and t within 1e-4, inlier and
    match counts equal."""
    vo, jvo = _offline_pair(pinned, "bf", pair_batch=2, k=512)
    reps = vo.extract(stack)
    kpn0, kpn1, valid = vo.match_map(reps)
    w0, w1, wv = (np.asarray(a) for a in jvo._match_map(_jax_reps(reps)))
    v = valid.numpy()
    np.testing.assert_array_equal(v, wv)
    np.testing.assert_allclose(kpn0.numpy()[v], w0[v], atol=1e-5)
    np.testing.assert_allclose(kpn1.numpy()[v], w1[v], atol=1e-5)

    hyp, lo, N = 256, 2, kpn0.shape[1]
    table = np.random.RandomState(12).gumbel(
        size=(1 + lo, hyp, N)).astype(np.float32)

    def split(key, num=2):
        c = jnp.asarray(key)[0]
        return jnp.stack([jnp.stack([c * 16 + i + 1, jnp.asarray(key)[1]])
                          for i in range(num)])

    def gumbel(key, shape, dtype=jnp.float32):
        c = jnp.asarray(key)[0]
        r = jnp.maximum(c // 16, 1) - 1
        assert tuple(shape) == (hyp, N)
        return jnp.take(jnp.asarray(table), r * (1 + lo) + c % 16 - 1,
                        axis=0)

    pairs = [0, 2]
    with monkeypatch.context() as m, jax.enable_x64():
        m.setattr(jax.random, "split", split)
        m.setattr(jax.random, "gumbel", gumbel)
        m.setattr(jax.random, "fold_in", lambda key, i: key)
        want = [np.asarray(a) for a in jvo._pose_map(
            jnp.asarray(kpn0[pairs].double().numpy()),
            jnp.asarray(kpn1[pairs].double().numpy()),
            jnp.asarray(valid[pairs].numpy()), jnp.zeros((2,), jnp.uint32))]
    # a chunk of P pairs draws stage by stage, each pair in turn
    stages = iter([s for s in range(1 + lo) for _ in pairs])

    def gumbel_noise(shape, generator):
        assert tuple(shape) == (1, hyp, N)
        return torch.from_numpy(table[next(stages)][None])

    monkeypatch.setattr(port_pose, "gumbel_noise", gumbel_noise)
    R, t, ninl, nmat = vo.pose_map(kpn0[pairs], kpn1[pairs], valid[pairs])
    np.testing.assert_allclose(R.numpy(), want[0], atol=1e-4)
    np.testing.assert_allclose(t.numpy(), want[1], atol=1e-4)
    np.testing.assert_array_equal(ninl.numpy(), want[2])
    np.testing.assert_array_equal(nmat.numpy(), want[3])
    assert int(ninl.min()) > 50


# ------------------------------------------------------------------- CLI

@pytest.mark.parametrize("extra", [["--matcher", "dense"],
                                   ["--offline"],
                                   ["--offline", "--matcher", "lightglue",
                                    "--lg_ckpt", PINNED_LG]])
def test_vo_eval_dense_and_offline_on_cpu(corridor, tmp_path, extra):
    """``python -m nanovs_slam_torch.vo_eval --device cpu`` on the corridor
    with --matcher dense (the online loop, host cv2 pose) and --offline
    (dense, and LightGlue; 256 hypotheses, 1 restart): results written
    with 0 estimation failures and a finite trajectory of one entry a
    frame."""
    from nanovs_slam_torch import vo_eval

    out = str(tmp_path / "vo.json")
    argv = ["--kitti_path", corridor, "--config", "S", "--n_classes", "8",
            "--model_path", PINNED_EX, "--im_h", str(H), "--im_w", str(W),
            "--top_k", "512", "--max_frames", "4", "--pose_hypotheses",
            "256", "--pose_restarts", "1", "--device", "cpu", "--out", out]
    assert vo_eval.main(argv + extra) == 0
    with open(out) as f:
        res = json.load(f)["results"]
    assert res["estimation_fails"] == 0
    assert len(res["trajectory"]) == 4
    assert np.isfinite(res["trajectory"]).all()
    assert res["stats"]["n_matches"]["min"] >= 100
