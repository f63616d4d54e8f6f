"""The port's evaluation on the CPU against the JAX package: the metric
files (numpy copies, to 1e-12), the retrieval search (torch, with
``lax.top_k``'s tie order), the cv2-free homography estimator against
``cv2.findHomography``, cv2's INTER_NEAREST resize, the readers (HPatches,
Pittsburgh with scipy's radius search in place of sklearn's, NYUv2), the
eval pairs of the trainer, the keypoint, segmentation and retrieval
evaluations end to end on pinned S8, and the trainer's ``evaluate_model``
fan-out. cv2 and sklearn are imported here only, as the JAX package's
references."""

import os
import sys

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanovs_slam_tpu.configs import get_config as jax_get_config
from nanovs_slam_tpu.data import extra_datasets as jax_extra
from nanovs_slam_tpu.data import hpatches as jax_hpatches
from nanovs_slam_tpu.data import pittsburgh as jax_pitts
from nanovs_slam_tpu.evaluation import depth as jax_depth
from nanovs_slam_tpu.evaluation import descriptor as jax_desc
from nanovs_slam_tpu.evaluation import detector as jax_det
from nanovs_slam_tpu.evaluation import global_descriptor as jax_gd
from nanovs_slam_tpu.evaluation import keypoints as jax_kp
from nanovs_slam_tpu.evaluation import segmentation as jax_seg
from nanovs_slam_tpu.inference import make_infer_fn as jax_make_infer_fn
from nanovs_slam_tpu.models.kp2dtiny import build_model as jax_build_model
from nanovs_slam_tpu.utils.checkpoint import \
    load_npz_checkpoint as jax_load_npz
from nanovs_slam_torch.configs import get_config
from nanovs_slam_torch.data import extra_datasets as port_extra
from nanovs_slam_torch.data import hpatches as port_hpatches
from nanovs_slam_torch.data import pittsburgh as port_pitts
from nanovs_slam_torch.data.datasets import SyntheticShapesDataset
from nanovs_slam_torch.evaluation import depth as port_depth
from nanovs_slam_torch.evaluation import descriptor as port_desc
from nanovs_slam_torch.evaluation import detector as port_det
from nanovs_slam_torch.evaluation import global_descriptor as port_gd
from nanovs_slam_torch.evaluation import keypoints as port_kp
from nanovs_slam_torch.evaluation import segmentation as port_seg
from nanovs_slam_torch.evaluation.homography import (dlt,
                                                     find_homography_ransac,
                                                     transfer_error)
from nanovs_slam_torch.inference import make_eval_fn
from nanovs_slam_torch.models.kp2dtiny import build_model
from nanovs_slam_torch.ops.image import resize_nearest
from nanovs_slam_torch.utils.convert import load_jax_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PINNED = os.path.join(REPO, "pinned", "extractor_S8.npz")
H, W = 96, 128


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads for this file's torch work (the suite runs
    files in parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _script(name):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        return __import__(name)
    finally:
        sys.path.pop(0)


# ------------------------------------------------------------ the metrics

def _pair_data(seed, n1=120, n2=140, C=16):
    """A synthetic evaluation pair: a pixel homography, points with scores
    in and around the (96, 128) image, descriptors (the second view's a
    noisy copy of the first's, warped points, then extra points)."""
    rs = np.random.RandomState(seed)
    a, t, p = 0.05 * rs.randn(2, 2), 5 * rs.randn(2), 1e-4 * rs.randn(2)
    Hm = np.array([[1.0 + a[0, 0], a[0, 1], t[0]],
                   [a[1, 0], 1.0 + a[1, 1], t[1]], [p[0], p[1], 1.0]])
    xy1 = rs.uniform(-5, [W + 5, H + 5], (n1, 2))
    xy2 = np.r_[jax_det.warp_keypoints(xy1, Hm)[: n2 // 2]
                + rs.randn(n2 // 2, 2) * 1.5,
                rs.uniform(-5, [W + 5, H + 5], (n2 - n2 // 2, 2))]
    d1 = rs.randn(n1, C).astype(np.float32)
    d2 = np.r_[d1[: n2 // 2] + 0.3 * rs.randn(n2 // 2, C),
               rs.randn(n2 - n2 // 2, C)].astype(np.float32)
    d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    return {"image_shape": (H, W), "homography": Hm,
            "prob": np.c_[xy1, rs.rand(n1)].astype(np.float32),
            "warped_prob": np.c_[xy2, rs.rand(n2)].astype(np.float32),
            "desc": d1, "warped_desc": d2}


@pytest.mark.parametrize("seed,k", [(0, 300), (1, 40), (2, 5)])
def test_repeatability_and_matching_score_match_jax(seed, k):
    data = _pair_data(seed)
    want = jax_det.compute_repeatability(data, keep_k_points=k)
    got = port_det.compute_repeatability(data, keep_k_points=k)
    assert got[:2] == want[:2]
    np.testing.assert_allclose(got[2:], want[2:], rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        port_desc.compute_matching_score(data, keep_k_points=k),
        jax_desc.compute_matching_score(data, keep_k_points=k),
        rtol=0, atol=1e-12)
    empty = dict(data, warped_prob=data["warped_prob"][:0])
    assert (port_det.compute_repeatability(empty)
            == jax_det.compute_repeatability(empty))


@pytest.mark.parametrize("cross_check", [False, True])
def test_bf_match_matches_jax(cross_check):
    data = _pair_data(3)
    for a, b in ((data["desc"], data["warped_desc"]),
                 (data["desc"][:0], data["warped_desc"])):
        want = jax_desc.bf_match(a, b, cross_check=cross_check)
        got = port_desc.bf_match(a, b, cross_check=cross_check)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_cal_error_auc_matches_jax():
    rs = np.random.RandomState(4)
    errors = list(rs.exponential(3.0, 30)) + [1000, 1000, 0.0]
    for errs in (errors, errors[:1], []):
        want = jax_kp.cal_error_auc(errs, [1, 3, 5])
        got = port_kp.cal_error_auc(errs, [1, 3, 5])
        assert got.keys() == want.keys()
        np.testing.assert_allclose(list(got.values()), list(want.values()),
                                   rtol=0, atol=1e-12)


def test_segmentation_stats_and_reductions_match_jax():
    """255 is the ignore label; the stats are integer counts (equal), the
    reductions to 1e-12."""
    rs = np.random.RandomState(5)
    pred = rs.randint(0, 6, (3, 24, 32))
    gt = rs.randint(0, 6, (3, 24, 32))
    gt[rs.rand(*gt.shape) < 0.2] = 255
    gt[1] = 255  # an image with nothing to count
    for g, w in zip(port_seg.segmentation_stats(pred, gt, 6),
                    jax_seg.segmentation_stats(pred, gt, 6)):
        np.testing.assert_array_equal(g, w)

    def infer(images):
        return {"seg": pred[images[:, 0, 0, 0].astype(int)][..., None]}

    batches = [{"image": np.full((1, 4, 4, 3), i, np.float32),
                "seg": gt[i:i + 1]} for i in range(3)]
    want = jax_seg.evaluate_segmentation(iter(batches), infer, 6)
    got = port_seg.evaluate_segmentation(iter(batches), infer, 6)
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-12, k


def test_depth_errors_match_jax():
    rs = np.random.RandomState(6)
    gt = rs.uniform(0.1, 1.0, (2, 12, 16, 1)).astype(np.float32)
    pred = (gt * rs.uniform(0.7, 1.4, gt.shape)).astype(np.float32)
    want = jax_depth.compute_depth_errors(gt, pred)
    got = port_depth.compute_depth_errors(gt, pred)
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-12, k
    batches = [{"image": gt[i:i + 1], "depth": gt[i:i + 1]} for i in (0, 1)]

    def infer(x):
        return {"depth": x * 1.1}

    want = jax_depth.evaluate_depth(iter(batches), infer)
    got = port_depth.evaluate_depth(iter(batches), infer)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-12, k


def test_retrieval_metrics_match_jax():
    rs = np.random.RandomState(7)
    preds = np.stack([rs.permutation(40)[:20] for _ in range(12)])
    positives = [rs.choice(40, rs.randint(0, 4), replace=False)
                 for _ in range(12)]
    for n_values in ((1, 5, 10, 20), (1, 3)):
        want = jax_gd.retrieval_metrics(preds, positives, 12, n_values)
        got = port_gd.retrieval_metrics(preds, positives, 12, n_values)
        assert got == want


def test_knn_l2_keeps_lax_top_k_tie_order():
    """Duplicated database rows (and queries equal to them) tie exactly:
    the lower index comes first, as in ``lax.top_k``."""
    rs = np.random.RandomState(8)
    base = rs.randn(10, 24).astype(np.float32)
    db = np.concatenate([base, base[::-1], base[:5]])  # 25 rows, 15 ties
    q = np.concatenate([base[[0, 3, 9]], rs.randn(5, 24).astype(np.float32)])
    want = jax_gd.knn_l2(q, db, 20)
    np.testing.assert_array_equal(port_gd.knn_l2(q, db, 20), want)
    np.testing.assert_array_equal(
        port_gd.knn_l2(torch.from_numpy(q), torch.from_numpy(db), 20), want)
    with pytest.raises(ValueError, match="exceeds"):
        port_gd.knn_l2(q, db, 26)
    positives = [np.array([i % 10, 19 - i % 10]) for i in range(len(q))]
    assert (port_gd.evaluate_global_descriptor(db, q, positives)
            == jax_gd.evaluate_global_descriptor(db, q, positives))


# ----------------------------------------------------- the homography

_H_TRUE = np.array([[1.1, 0.05, 12.0], [-0.03, 0.95, -7.0],
                    [1e-4, -2e-4, 1.0]])
_CORNERS = np.array([[0, 0, 1], [0, 239, 1], [319, 0, 1], [319, 239, 1.0]])


def _correspondences(seed, n=300, noise=0.0):
    rs = np.random.RandomState(seed)
    src = rs.rand(n, 2) * [320, 240]
    dst = jax_det.warp_keypoints(src, _H_TRUE)
    out = rs.rand(n) < 0.3
    dst[out] += (rs.uniform(20, 100, (out.sum(), 2))
                 * rs.choice([-1, 1], (out.sum(), 2)))
    return src, dst + rs.randn(n, 2) * noise, ~out


def _corner_dist(Hm):
    a = jax_det.warp_keypoints(_CORNERS[:, :2], _H_TRUE)
    b = jax_det.warp_keypoints(_CORNERS[:, :2], Hm)
    return float(np.linalg.norm(a - b, axis=1).mean())


def test_homography_exact_with_outliers_matches_cv2():
    """Exact correspondences and 30% far outliers: the inlier set is
    cv2's, and H is the truth to 1e-6 (H[2, 2] = 1)."""
    src, dst, inl = _correspondences(0)
    Hm, mask = find_homography_ransac(src, dst)
    Hc, mc = cv2.findHomography(src, dst, cv2.RANSAC, 3, maxIters=5000)
    np.testing.assert_array_equal(mask, mc.ravel().astype(bool))
    np.testing.assert_array_equal(mask, inl)
    assert Hm[2, 2] == 1.0
    np.testing.assert_allclose(Hm, _H_TRUE, rtol=0, atol=1e-6)
    # the same call gives the same answer (a generator seeded per call)
    np.testing.assert_array_equal(find_homography_ransac(src, dst)[0], Hm)


def test_homography_with_noise_against_cv2():
    """0.5 px noise on 20 seeded sets of 300 correspondences (30% far
    outliers). The inlier sets equal cv2's. cv2 5.0's returned model is
    not always the least-squares one on its own inliers (in 12 of these
    20); where it is, H agrees to 1e-5 and the mean corner distance to
    0.05 px; everywhere the port's forward transfer error on those
    inliers is the lower, and the mean gap of the corner distances stays
    within 0.05 px (measured: 0.025 px, the largest 0.097)."""
    gaps = []
    for seed in range(20):
        src, dst, _ = _correspondences(seed, noise=0.5)
        Hm, mask = find_homography_ransac(src, dst)
        Hc, mc = cv2.findHomography(src, dst, cv2.RANSAC, 3, maxIters=5000)
        mc = mc.ravel().astype(bool)
        np.testing.assert_array_equal(mask, mc, err_msg=str(seed))
        cost_port = transfer_error(Hm, src[mc], dst[mc]).sum()
        cost_cv2 = transfer_error(Hc, src[mc], dst[mc]).sum()
        assert cost_port <= cost_cv2 * (1 + 1e-9), seed
        gap = _corner_dist(Hm) - _corner_dist(Hc)
        if cost_cv2 <= cost_port * (1 + 1e-7):  # cv2's is least squares
            np.testing.assert_allclose(Hm, Hc, rtol=0, atol=1e-5)
            assert abs(gap) <= 0.05, seed
        gaps.append(abs(gap))
    assert np.mean(gaps) <= 0.05, gaps


def test_homography_degenerate_inputs_give_no_model():
    """Fewer than 4 points, and points on one line: no model (cv2 gives
    none for the line and raises below 4), so compute_homography gives
    MAX_VAL, as the JAX one does."""
    src, dst, _ = _correspondences(1, n=20)
    assert find_homography_ransac(src[:3], dst[:3]) == (None, None)
    xs = np.linspace(0, 100, 20)
    line = np.c_[xs, 2 * xs + 1]
    assert find_homography_ransac(line, line + 1) == (None, None)
    assert cv2.findHomography(line, line + 1, cv2.RANSAC, 3,
                              maxIters=5000)[0] is None
    desc = np.eye(20, 16, dtype=np.float32)
    for pts in (line[:3], line):
        prob = np.c_[pts, np.linspace(0.8, 0.9, len(pts))]
        data = {"image_shape": (240, 320), "homography": np.eye(3),
                "prob": prob, "warped_prob": prob + [1, 1, 0],
                "desc": desc[:len(pts)], "warped_desc": desc[:len(pts)]}
        assert port_desc.compute_homography(data) == \
            jax_desc.compute_homography(data) == (0, 0, 0, port_desc.MAX_VAL)


def test_homography_dlt_is_exact_on_four_points():
    src = np.array([[0.0, 0.0], [10.0, 1.0], [2.0, 12.0], [11.0, 9.0]])
    dst = jax_det.warp_keypoints(src, _H_TRUE)
    np.testing.assert_allclose(dlt(src, dst), _H_TRUE, atol=1e-9)
    Hm, mask = find_homography_ransac(src, dst)
    np.testing.assert_allclose(Hm, _H_TRUE, atol=1e-9)
    assert mask.all()


# ------------------------------------------------------- nearest resize

@pytest.mark.parametrize("src,dst", [(240, 30), (240, 60), (375, 94),
                                     (94, 375)])
def test_resize_nearest_is_cv2s(src, dst):
    rs = np.random.RandomState(src + dst)
    for shape, out in (((src, 320), (dst, 40)), ((120, src), (60, dst))):
        u8 = rs.randint(0, 255, shape).astype(np.uint8)
        np.testing.assert_array_equal(
            resize_nearest(u8, *out),
            cv2.resize(u8, out[::-1], interpolation=cv2.INTER_NEAREST))
        f32 = rs.rand(*shape, 1).astype(np.float32)
        np.testing.assert_array_equal(
            resize_nearest(f32, *out)[..., 0],
            cv2.resize(f32, out[::-1], interpolation=cv2.INTER_NEAREST))


# ------------------------------------------------------------ the readers

def test_radius_positives_match_sklearn():
    """Database points exactly on the radius (3-4-5 offsets) count, as
    sklearn's do; compared as sets."""
    from sklearn.neighbors import NearestNeighbors

    rs = np.random.RandomState(9)
    utm_q = rs.uniform(0, 500, (30, 2)).round()
    on_ring = utm_q[:, None] + np.array([[15.0, 20.0], [-20.0, 15.0],
                                         [0.0, -25.0]])[None]
    utm_db = np.concatenate([on_ring.reshape(-1, 2),
                             rs.uniform(0, 500, (200, 2))])
    knn = NearestNeighbors(n_jobs=1).fit(utm_db)
    want = knn.radius_neighbors(utm_q, radius=25.0, return_distance=False)
    got = port_pitts.radius_positives(utm_db, utm_q, 25.0)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g.tolist()) == set(w.tolist())
        assert len(g) >= 3


def test_whole_dataset_matches_jax(tmp_path):
    mat = _script("make_synthetic_pittsburgh").make_fixture(
        str(tmp_path), n_places=3, db_per_place=2, q_per_place=1, H=48,
        W=64)
    want = jax_pitts.WholeDataset(mat, str(tmp_path), (40, 56))
    got = port_pitts.WholeDataset(mat, str(tmp_path), (40, 56))
    assert got.dbStruct._asdict().keys() == want.dbStruct._asdict().keys()
    for k, v in want.dbStruct._asdict().items():
        np.testing.assert_array_equal(getattr(got.dbStruct, k), v)
    assert len(got) == len(want) == 9
    for i in range(len(want)):
        np.testing.assert_array_equal(got[i], want[i])
    for g, w in zip(got.get_positives(), want.get_positives()):
        assert set(g.tolist()) == set(w.tolist())


def test_hpatches_dataset_matches_jax(tmp_path):
    rs = np.random.RandomState(10)
    for seq in ("i_a", "v_b"):
        os.makedirs(tmp_path / seq)
        for i in range(1, 7):
            img = rs.randint(0, 255, (60 + i, 90, 3)).astype(np.uint8)
            cv2.imwrite(str(tmp_path / seq / f"{i}.ppm"), img)
            if i > 1:
                np.savetxt(tmp_path / seq / f"H_1_{i}",
                           np.eye(3) + 0.01 * rs.randn(3, 3))
    for seq_type in ("a", "v"):
        want = jax_hpatches.HPatchesDataset(str(tmp_path), (W, H), seq_type)
        got = port_hpatches.HPatchesDataset(str(tmp_path), (W, H), seq_type)
        assert got.items == want.items and len(got) > 0
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    np.testing.assert_array_equal(
        port_hpatches.scale_homography(np.eye(3) * 2, (640, 480), (W, H),
                                       True),
        jax_hpatches.scale_homography(np.eye(3) * 2, (640, 480), (W, H),
                                      True))


def test_synthetic_hpatches_names_a_missing_cv2(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="cv2"):
        port_hpatches.ensure_synthetic_hpatches(str(tmp_path / "hp"))


def test_nyuv2_dataset_matches_jax(tmp_path):
    rs = np.random.RandomState(11)
    for kind in ("image", "depth", "seg13"):
        os.makedirs(tmp_path / kind / "test")
    for i in range(2):
        cv2.imwrite(str(tmp_path / "image" / "test" / f"{i}.png"),
                    rs.randint(0, 255, (50, 70, 3)).astype(np.uint8))
        cv2.imwrite(str(tmp_path / "depth" / "test" / f"{i}.png"),
                    rs.randint(0, 9000, (50, 70)).astype(np.uint16))
        cv2.imwrite(str(tmp_path / "seg13" / "test" / f"{i}.png"),
                    rs.randint(0, 13, (50, 70)).astype(np.uint8))
    want = jax_extra.NYUv2Dataset(str(tmp_path), (24, 32), split="test")
    got = port_extra.NYUv2Dataset(str(tmp_path), (24, 32), split="test")
    assert len(got) == len(want) == 2
    for i in range(2):
        for k, v in want[i].items():
            np.testing.assert_array_equal(got[i][k], v, err_msg=k)


# ------------------------------------------- end to end on pinned S8

@pytest.fixture(scope="module")
def pinned_s8():
    """(JAX infer_np, the port's make_eval_fn) of pinned S8 at 96x128 on
    the CPU, and 4 synthetic eval pairs (the port's, as the trainer makes
    them)."""
    from nanovs_slam_torch.train_multitask import synthetic_homography_pairs

    tree, _ = jax_load_npz(PINNED)
    variables = {"params": tree["params"],
                 "batch_stats": tree["batch_stats"]}
    jcfg = jax_get_config("S", n_classes=8)
    jinfer = jax_make_infer_fn(jax_build_model(jcfg), jcfg, H, W)

    def jax_np(images):
        out = jinfer(variables, jnp.asarray(images, jnp.float32))
        return {k: np.asarray(v) for k, v in out.items()}

    cfg = get_config("S", n_classes=8)
    model = load_jax_variables(build_model(cfg), tree["params"],
                               tree["batch_stats"])
    ds = SyntheticShapesDataset((H, W), 6, 8, seed=3)
    pairs = synthetic_homography_pairs(ds, (H, W), 4, "cpu")
    return jax_np, make_eval_fn(model, cfg, H, W), pairs, ds, cfg


def test_eval_pairs_match_the_jax_trainers(pinned_s8):
    import train_multitask as jax_trainer

    *_, pairs, ds, _ = pinned_s8
    want = jax_trainer.synthetic_homography_pairs(ds, (H, W), 4)
    assert len(pairs) == len(want) == 4
    for g, w in zip(pairs, want):
        np.testing.assert_array_equal(g["image"], w["image"])
        np.testing.assert_array_equal(g["homography"], w["homography"])
        np.testing.assert_allclose(g["image_aug"], w["image_aug"], atol=2e-5)


def test_evaluate_keypoint_net_matches_jax(pinned_s8):
    """Pinned S8 at 96x128 on 4 synthetic pairs, the same [-1, 1] inputs
    through the JAX infer and the port's, top_k 300 and 50: the metrics
    that need no RANSAC (repeatability, localisation error, matching
    score) within 1e-4.

    The homography half cannot be held pair by pair against cv2: on these
    match sets (rotations up to 90 degrees, 20-130 crosscheck matches of
    which 5-20% outliers) the port's RANSAC and cv2's stop on different
    inlier sets, and cv2 5.0 does not always refine to the least-squares
    model of its own. Measured here: the correctness flags differ on 1 of
    the 8 pair evaluations and the mean corner distance by up to 1.18 px
    where JAX's is below 5 px. What is held instead, on the port's own
    matches given to both estimators: wherever the two inlier sets are
    equal and cv2's model is the least-squares one on them, the mean
    corner distance agrees to 1e-3 px (cv2 rounds the points to float32)
    and the flags are equal (2 of the 8 pairs here); and the port's model
    is always the least-squares one on its inliers (a gradient of the
    transfer error below 1e-6)."""
    jax_np, port_np, pairs, *_ = pinned_s8
    held = 0
    for top_k in (300, 50):
        want = jax_kp.evaluate_keypoint_net(pairs, jax_np, (W, H), top_k)
        got = port_kp.evaluate_keypoint_net(pairs, port_np, (W, H), top_k)
        assert want["repeatability"] > 0, want
        for k in ("repeatability", "localization_error", "mscore"):
            assert abs(got[k] - want[k]) <= 1e-4, (k, got[k], want[k])
        for item in pairs:
            o1, o2 = port_np(item["image"]), port_np(item["image_aug"])
            p1, d1 = port_kp.flatten_outputs(o1["score"], o1["coord"],
                                             o1["feat"])
            p2, d2 = port_kp.flatten_outputs(o2["score"], o2["coord"],
                                             o2["feat"])
            Hgt = item["homography"]
            kp1, dd1 = port_desc.keep_shared_points(p1, d1, Hgt, (H, W),
                                                    top_k)
            kp2, dd2 = port_desc.keep_shared_points(
                p2, d2, np.linalg.inv(Hgt), (H, W), top_k)
            q, t = port_desc.bf_match(dd1, dd2, cross_check=True)
            a, b = kp1[q].astype(np.float64), kp2[t].astype(np.float64)
            Hm, mask = find_homography_ransac(a, b)
            Hc, mc = cv2.findHomography(a, b, cv2.RANSAC, 3, maxIters=5000)
            mc = mc.ravel().astype(bool)
            # the port's model: least squares on its inliers
            eps = 1e-6
            base = transfer_error(Hm, a[mask], b[mask]).sum()
            for i in range(8):
                step = np.zeros(9)
                step[i] = eps * max(abs(Hm.flat[i]), 1e-3)
                Hs = Hm + step.reshape(3, 3)
                grad = (transfer_error(Hs, a[mask], b[mask]).sum()
                        - base) / step[i]
                assert abs(grad) * step[i] <= 1e-6 * max(base, 1.0), grad
            cost_cv2 = transfer_error(Hc, a[mc], b[mc]).sum()
            if (mask == mc).all() and cost_cv2 <= base * (1 + 1e-7):
                corners = np.array([[0, 0], [0, H - 1], [W - 1, 0],
                                    [W - 1, H - 1]], np.float64)
                real = port_det.warp_keypoints(corners, Hgt)

                def dist(Hx):
                    est = port_det.warp_keypoints(corners, Hx)
                    return np.linalg.norm(real - est, axis=1).mean()

                assert abs(dist(Hm) - dist(Hc)) <= 1e-3
                assert ([dist(Hm) <= t for t in (1, 3, 5)]
                        == [dist(Hc) <= t for t in (1, 3, 5)])
                held += 1
    assert held >= 1


def test_segmentation_and_retrieval_match_jax(pinned_s8):
    """evaluate_segmentation over the pairs' images (ground truth resized
    with the port's INTER_NEAREST) within 1e-4, and
    evaluate_global_descriptor (originals as the database, warps as the
    queries) equal."""
    jax_np, port_np, pairs, ds, cfg = pinned_s8
    hs, ws = 2 * (H // cfg.cell), 2 * (W // cfg.cell)
    batches = [{"image": ds[i]["image"][None] * 2 - 1,
                "seg": resize_nearest(ds[i]["seg"], hs, ws)[None]}
               for i in range(4)]
    want = jax_seg.evaluate_segmentation(iter(batches), jax_np, 8)
    got = port_seg.evaluate_segmentation(iter(batches), port_np, 8)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-4, (k, got[k], want[k])

    def vlads(infer, key):
        return np.stack([infer(p[key])["vlad"][0] for p in pairs])

    positives = [np.array([i]) for i in range(4)]
    want = jax_gd.evaluate_global_descriptor(
        vlads(jax_np, "image"), vlads(jax_np, "image_aug"), positives, (1, 3))
    got = port_gd.evaluate_global_descriptor(
        vlads(port_np, "image"), vlads(port_np, "image_aug"), positives,
        (1, 3))
    assert got == want


# ---------------------------------------------- the trainer's evaluation

def _error_entries(tree) -> list:
    """The ``"error"`` entries of a results dict, at any depth."""
    if not isinstance(tree, dict):
        return []
    return [v for k, v in tree.items() if k == "error"] + [
        e for v in tree.values() for e in _error_entries(v)]


def _eval_args(tmp_path, **kw):
    import argparse

    kw = dict(dict(max_eval_items=3, full_eval=1, top_k=50, debug=False,
                   dataset_config=str(tmp_path / "datasets.json"),
                   out_model_path=str(tmp_path / "ck")), **kw)
    return argparse.Namespace(**kw)


def test_evaluate_model_fanout_synthetic(tmp_path, capsys):
    """The counterpart of the JAX trainer's fan-out test
    (tests/test_trainer_eval.py): config N, 6 classes, 48x64, 3 eval
    items, on the CPU: segmentation, keypoints, retrieval and VO (a
    3-frame synthetic KITTI sequence) give numbers and no error; --debug
    writes its pictures; the model gets its training mode back; an epoch
    off the --full_eval boundary runs segmentation only."""
    import json

    from nanovs_slam_torch.train_multitask import (evaluate_model,
                                                   plateau_metric)

    kitti = tmp_path / "kitti"
    _script("make_synthetic_kitti").make_sequence(str(kitti), 3)
    (tmp_path / "datasets.json").write_text(
        json.dumps({"kitti_data_path": str(kitti)}))
    cfg = get_config("N", n_classes=6)
    model = build_model(cfg).train()
    ds_val = SyntheticShapesDataset((48, 64), 4, 6, seed=5)
    args = _eval_args(tmp_path, debug=True)
    flags = {"keypoints": True, "segmentation": True, "visloc": True,
             "depth": False}
    results = evaluate_model(model, cfg, ds_val, (48, 64), args, flags, 0)
    assert model.training
    assert not _error_entries(results), results
    assert "IoU" in results["segmentation"], results
    assert "repeatability" in results["keypoints"], results
    assert set(results["visloc"]) == {"Recall", "AUC", "MatchRatio"}
    assert list(results["visloc"]["Recall"]) == [1]  # n <= 3 items
    assert np.isfinite(results["vo"]["mean"]), results["vo"]
    assert np.isfinite(plateau_metric(results, [1.0]))
    assert os.path.exists(tmp_path / "ck_media" / "debug_pair_e0.png")
    assert os.path.exists(tmp_path / "ck_media" / "debug_seg_e0.png")

    args.full_eval, args.debug = 3, False
    quick = evaluate_model(model, cfg, ds_val, (48, 64), args, flags, 0)
    assert "segmentation" in quick and "keypoints" not in quick


@pytest.mark.parametrize("cv2_present", [True, False])
def test_depth_metrics_survive_without_cv2(tmp_path, monkeypatch, capsys,
                                           cv2_present):
    """The depth task: its metrics as evaluate_depth gives them, and the
    example pictures written with cv2; without cv2 the pictures are not
    written (the reason printed) and the metrics stay, where the JAX
    trainer stores an error in their place."""
    from nanovs_slam_torch.train_multitask import evaluate_model

    cfg = get_config("N", n_classes=6, depth=True)
    model = build_model(cfg).eval()
    ds_val = SyntheticShapesDataset((48, 64), 3, 6, seed=6, with_depth=True)
    args = _eval_args(tmp_path, full_eval=3)
    if not cv2_present:
        monkeypatch.setitem(sys.modules, "cv2", None)
    flags = {"segmentation": False, "depth": True}
    results = evaluate_model(model, cfg, ds_val, (48, 64), args, flags, 0)
    assert set(results) == {"depth"}
    assert np.isfinite(results["depth"]["abs_rel"]), results
    png = tmp_path / "ck_media" / "depth_examples_e0.png"
    assert png.exists() == cv2_present
    if not cv2_present:
        assert "depth examples not written" in capsys.readouterr().out
