"""Keypoint repeatability / localization error (a copy of
``nanovs_slam_tpu/evaluation/detector.py``).

Metric definitions match the reference exactly
(src/evaluation/detector.py:8-115, itself derived from the public
SuperPoint evaluation): symmetric nearest-neighbor counting within
distance_thresh over the top-k in-view points of both views.
Host-side numpy (runs per HPatches pair, tiny arrays).
"""

from __future__ import annotations

import numpy as np


def warp_keypoints(keypoints: np.ndarray, H: np.ndarray) -> np.ndarray:
    """Homogeneous warp of (N, 2) xy points by 3x3 H
    (reference utils/keypoints.py:7-25)."""
    num = keypoints.shape[0]
    homo = np.concatenate([keypoints, np.ones((num, 1))], axis=1)
    warped = homo @ H.T
    return warped[:, :2] / warped[:, 2:]


def _filter_in_shape(points: np.ndarray, shape) -> np.ndarray:
    mask = ((points[:, 0] >= 0) & (points[:, 0] < shape[0])
            & (points[:, 1] >= 0) & (points[:, 1] < shape[1]))
    return points[mask, :]


def _keep_true_keypoints(points: np.ndarray, H: np.ndarray, shape
                         ) -> np.ndarray:
    warped = warp_keypoints(points[:, :2], H)
    mask = ((warped[:, 0] >= 0) & (warped[:, 0] < shape[0])
            & (warped[:, 1] >= 0) & (warped[:, 1] < shape[1]))
    return points[mask, :]


def select_k_best(points: np.ndarray, k: int) -> np.ndarray:
    sorted_prob = points[points[:, 2].argsort(), :2]
    start = min(k, points.shape[0])
    return sorted_prob[-start:, :]


def compute_repeatability(data, keep_k_points: int = 300,
                          distance_thresh: float = 3):
    """data: image_shape (H,W), homography (3,3), prob (N,3) [x,y,score],
    warped_prob (N,3). Returns (N1, N2, repeatability, loc_err)."""
    H = data["homography"]
    shape = data["image_shape"]

    keypoints = data["prob"][:, :2]
    warped_keypoints = _keep_true_keypoints(
        data["warped_prob"], np.linalg.inv(H), shape)

    true_warped = warp_keypoints(keypoints, H)
    true_warped = np.stack([true_warped[:, 0], true_warped[:, 1],
                            data["prob"][:, 2]], axis=-1)
    true_warped = _filter_in_shape(true_warped, shape)

    warped_keypoints = select_k_best(warped_keypoints, keep_k_points)
    true_warped = select_k_best(true_warped, keep_k_points)

    N1, N2 = true_warped.shape[0], warped_keypoints.shape[0]
    norm = np.linalg.norm(true_warped[:, None] - warped_keypoints[None],
                          axis=2)
    count1 = count2 = 0
    le1 = le2 = 0.0
    if N2 != 0 and N1 != 0:
        min1 = np.min(norm, axis=1)
        correct1 = min1 <= distance_thresh
        count1, le1 = np.sum(correct1), min1[correct1].sum()
        min2 = np.min(norm, axis=0)
        correct2 = min2 <= distance_thresh
        count2, le2 = np.sum(correct2), min2[correct2].sum()
    if N1 + N2 > 0 and count1 + count2 > 0:
        repeatability = (count1 + count2) / (N1 + N2)
        loc_err = (le1 + le2) / (count1 + count2)
    else:
        repeatability, loc_err = -1, -1
    return N1, N2, repeatability, loc_err
