"""Keypoint evaluation driver (HPatches-style homography pairs), a copy of
``nanovs_slam_tpu/evaluation/keypoints.py``.

Mirrors the reference evaluate_keypoint_net loop
(src/evaluation/keypoints.py:57-175): per pair, run model + postproc on
both views, flatten cells, filter score > 0.7, and compute repeatability,
localization error, homography correctness@{1,3,5}, matching score and
RANSAC-homography AUC@{1,3,5}.

The model side is the caller's infer_fn (``inference.make_eval_fn``: the
model and its postprocess on the model's device); the metric tail is host
numpy, with no cv2.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable

import numpy as np

from .descriptor import compute_homography, compute_matching_score
from .detector import compute_repeatability


def cal_error_auc(errors, thresholds) -> Dict[float, float]:
    """(reference keypoints.py:12-24)"""
    if len(errors) == 0:
        return {t: float("nan") for t in thresholds}
    sort_idx = np.argsort(errors)
    errors = np.array(errors, dtype=np.float64)[sort_idx]
    recall = (np.arange(len(errors)) + 1) / len(errors)
    errors = np.r_[0.0, errors]
    recall = np.r_[0.0, recall]
    aucs = {}
    for t in thresholds:
        last_index = np.searchsorted(errors, t)
        r = np.r_[recall[:last_index], recall[last_index - 1]]
        e = np.r_[errors[:last_index], t]
        aucs[t] = float(np.round(np.trapezoid(r, x=e) / t, 4))
    return aucs


def flatten_outputs(score, coord, feat, conf_threshold: float = 0.7):
    """Dense (Hc,Wc) maps -> filtered (N,3) points + (N,C) descriptors.
    Matches the reference flatten+filter (keypoints.py:113-128).
    score (1,Hc,Wc,1), coord (1,Hc,Wc,2), feat (1,Hc,Wc,C) numpy."""
    s = np.asarray(score).reshape(-1)
    xy = np.asarray(coord).reshape(-1, 2)
    d = np.asarray(feat).reshape(-1, np.asarray(feat).shape[-1])
    pts = np.concatenate([xy, s[:, None]], axis=1)
    keep = s > conf_threshold
    return pts[keep], d[keep]


def evaluate_keypoint_net(data_iter: Iterable[Dict], infer_fn: Callable,
                          output_shape=(320, 240), top_k: int = 300,
                          conf_threshold: float = 0.7) -> Dict[str, float]:
    """data_iter yields dicts with image/image_aug (1,H,W,3) in [-1,1] and
    homography (3,3) numpy. infer_fn(images) -> dict with score/coord/feat
    (post-processed, eval mode)."""
    localization_err, repeatability = [], []
    c1s, c3s, c5s, mscores, dists = [], [], [], [], []

    for sample in data_iter:
        out1 = infer_fn(sample["image"])
        out2 = infer_fn(sample["image_aug"])
        prob1, desc1 = flatten_outputs(out1["score"], out1["coord"],
                                       out1["feat"], conf_threshold)
        prob2, desc2 = flatten_outputs(out2["score"], out2["coord"],
                                       out2["feat"], conf_threshold)
        data = {
            "image_shape": output_shape[::-1],  # (H, W)
            "homography": np.asarray(sample["homography"]),
            "prob": prob1, "warped_prob": prob2,
            "desc": desc1, "warped_desc": desc2,
        }
        _, _, rep, loc_err = compute_repeatability(data, keep_k_points=top_k,
                                                   distance_thresh=3)
        if rep != -1 and loc_err != -1:
            repeatability.append(rep)
            localization_err.append(loc_err)
        c1, c3, c5, mean_dist = compute_homography(data, keep_k_points=top_k)
        c1s.append(c1)
        c3s.append(c3)
        c5s.append(c5)
        dists.append(mean_dist)
        mscores.append(compute_matching_score(data, keep_k_points=top_k))

    return {
        "repeatability": float(np.mean(repeatability)) if repeatability else -1,
        "localization_error": float(np.mean(localization_err)) if localization_err else -1,
        "correctness1": float(np.mean(c1s)),
        "correctness3": float(np.mean(c3s)),
        "correctness5": float(np.mean(c5s)),
        "mscore": float(np.mean(mscores)),
        "homography_auc": cal_error_auc(dists, [1, 3, 5]),
    }
