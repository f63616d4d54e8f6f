"""Descriptor metrics: homography-estimation correctness + matching score
(a copy of ``nanovs_slam_tpu/evaluation/descriptor.py``, with the port's
cv2-free ``homography.find_homography_ransac`` in place of
``cv2.findHomography``).

Metric definitions match the reference (src/evaluation/descriptor.py:85-285):
- matching score: bidirectional brute-force NN matching, correct if the
  GT-warped match lands within 3px, normalized over in-view matches.
- correctness@{1,3,5}: crosscheck BF matches -> RANSAC homography
  (th 3, maxIters 5000, cv2's recipe) -> mean corner-warp distance
  thresholds.
Brute-force matching uses numpy matmul (argmin over L2) instead of the
reference's cv2.BFMatcher — identical results for float descriptors, and
the distance matrix runs as one GEMM.
"""

from __future__ import annotations

import numpy as np

from .detector import warp_keypoints
from .homography import find_homography_ransac

MAX_VAL = 1000


def _l2_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Squared L2 distances (N, M) via the Gram identity."""
    aa = np.sum(a * a, axis=1)[:, None]
    bb = np.sum(b * b, axis=1)[None, :]
    return np.maximum(aa + bb - 2.0 * (a @ b.T), 0.0)


def bf_match(desc1: np.ndarray, desc2: np.ndarray, cross_check: bool = False):
    """Brute-force NN match (cv2.BFMatcher(NORM_L2) semantics).
    Returns (query_idx, train_idx) arrays."""
    if desc1.shape[0] == 0 or desc2.shape[0] == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    d = _l2_matrix(desc1, desc2)
    nn12 = np.argmin(d, axis=1)
    if not cross_check:
        q = np.arange(desc1.shape[0])
        return q, nn12
    nn21 = np.argmin(d, axis=0)
    q = np.arange(desc1.shape[0])
    mutual = nn21[nn12] == q
    return q[mutual], nn12[mutual]


def _select_k_best_desc(points, descriptors, k):
    order = points[:, 2].argsort()
    start = min(k, points.shape[0])
    return points[order, :2][-start:], descriptors[order][-start:]


def keep_shared_points(keypoints, descriptors, H, shape, keep_k_points=1000):
    warped = warp_keypoints(keypoints[:, :2], H)
    mask = ((warped[:, 0] >= 0) & (warped[:, 0] < shape[0])
            & (warped[:, 1] >= 0) & (warped[:, 1] < shape[1]))
    return _select_k_best_desc(keypoints[mask], descriptors[mask],
                               keep_k_points)


def compute_matching_score(data, keep_k_points: int = 1000) -> float:
    shape = data["image_shape"]
    real_H = data["homography"]

    keypoints, desc = _select_k_best_desc(data["prob"], data["desc"],
                                          keep_k_points)
    warped_keypoints, warped_desc = _select_k_best_desc(
        data["warped_prob"], data["warped_desc"], keep_k_points)

    def one_way(kp_a, desc_a, kp_b, desc_b, H):
        q, t = bf_match(desc_a, desc_b)
        if len(q) == 0:
            return 0.0
        m_a, m_b = kp_a[q], kp_b[t]
        true_b = warp_keypoints(m_b, H)
        vis = np.all((true_b >= 0) & (true_b <= (np.array(shape) - 1)),
                     axis=-1)
        norm = np.linalg.norm(true_b - m_a, axis=-1)
        correct = norm < 3
        return np.sum(correct * vis) / np.maximum(np.sum(vis), 1.0)

    score1 = one_way(keypoints, desc, warped_keypoints, warped_desc,
                     np.linalg.inv(real_H))
    score2 = one_way(warped_keypoints, warped_desc, keypoints, desc, real_H)
    return (score1 + score2) / 2


def compute_homography(data, keep_k_points: int = 1000):
    """Returns (correct@1, correct@3, correct@5, mean_corner_dist)."""
    shape = data["image_shape"]
    real_H = data["homography"]

    keypoints, desc = keep_shared_points(data["prob"], data["desc"], real_H,
                                         shape, keep_k_points)
    warped_keypoints, warped_desc = keep_shared_points(
        data["warped_prob"], data["warped_desc"], np.linalg.inv(real_H),
        shape, keep_k_points)

    q, t = bf_match(desc, warped_desc, cross_check=True)
    m_kp, m_warped = keypoints[q], warped_keypoints[t]
    if m_kp.shape[0] < 4 or m_warped.shape[0] < 4:
        return 0, 0, 0, MAX_VAL

    H, _ = find_homography_ransac(m_kp, m_warped, 3, max_iters=5000)
    if H is None:
        return 0, 0, 0, MAX_VAL

    corners = np.array([[0, 0, 1], [0, shape[1] - 1, 1],
                        [shape[0] - 1, 0, 1],
                        [shape[0] - 1, shape[1] - 1, 1]])
    real_w = corners @ real_H.T
    real_w = real_w[:, :2] / real_w[:, 2:]
    est_w = corners @ H.T
    est_w = est_w[:, :2] / est_w[:, 2:]
    mean_dist = float(np.mean(np.linalg.norm(real_w - est_w, axis=1)))
    return (float(mean_dist <= 1), float(mean_dist <= 3),
            float(mean_dist <= 5), mean_dist)
