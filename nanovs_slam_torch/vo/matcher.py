"""Feature matching for VO, the counterpart of
``nanovs_slam_tpu/vo/matcher.py`` (reference:
src/visual_odometry/feature_matcher.py).

- knnMatch k=2 (NORM_L2) + Lowe ratio test 0.7 (kRatioTest);
- one-to-one train-index dedup keeping the best distance
  (goodMatchesOneToOne, :179-209).

The host matchers are numpy copies of the JAX package's (the FLANN and
crosscheck ones import cv2 where they run). ``bf_match_device`` is the
fixed-shape torch twin of the ratio test on any device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

K_RATIO_TEST = 0.7


def knn2(desc1: np.ndarray, desc2: np.ndarray
         ) -> Tuple[np.ndarray, np.ndarray]:
    """For each row of desc1, the 2 nearest rows of desc2 by L2.
    Returns (indices (N, 2), distances (N, 2))."""
    aa = np.sum(desc1 * desc1, 1)[:, None]
    bb = np.sum(desc2 * desc2, 1)[None, :]
    d2 = np.maximum(aa + bb - 2.0 * desc1 @ desc2.T, 0.0)
    idx = np.argpartition(d2, 1, axis=1)[:, :2]
    d_pair = np.take_along_axis(d2, idx, axis=1)
    order = np.argsort(d_pair, axis=1)
    idx = np.take_along_axis(idx, order, axis=1)
    d_pair = np.take_along_axis(d_pair, order, axis=1)
    return idx, np.sqrt(d_pair)


def ratio_test_match_one_to_one(desc_query: np.ndarray,
                                desc_train: np.ndarray,
                                ratio_test: float = K_RATIO_TEST):
    """Returns (idx_query, idx_train, distances), one-to-one in train index
    keeping the smallest distance (feature_matcher.py:179-209)."""
    if desc_query.shape[0] < 2 or desc_train.shape[0] < 2:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                np.zeros(0, np.float32))
    idx, dist = knn2(desc_query, desc_train)
    return ratio_one_to_one_from_knn(idx, dist, ratio_test)


def match_keypoints(kps_prev, feat_prev, kps_cur, feat_cur,
                    top_k_matches: int = 1000,
                    ratio_test: float = K_RATIO_TEST,
                    use_native: bool = True):
    """(evaluation/visual_odometry.py:125-136): match prev->cur, keep the
    top_k best-distance matches. Returns (kps0, kps1). Uses the native
    C++ matcher (vo/native.py) when available."""
    if use_native:
        from .native import native_available, ratio_match_native

        if native_available():
            idxs0, idxs1, score = ratio_match_native(
                np.asarray(feat_prev, np.float32),
                np.asarray(feat_cur, np.float32), ratio_test)
        else:
            idxs0, idxs1, score = ratio_test_match_one_to_one(
                feat_prev, feat_cur, ratio_test)
    else:
        idxs0, idxs1, score = ratio_test_match_one_to_one(
            feat_prev, feat_cur, ratio_test)
    kps0 = np.asarray(kps_prev)[idxs0, :]
    kps1 = np.asarray(kps_cur)[idxs1, :]
    if len(score) > top_k_matches > 0:
        top = np.argpartition(score, top_k_matches)[:top_k_matches]
        kps0, kps1 = kps0[top], kps1[top]
    return kps0, kps1


def flann_knn2(desc_query: np.ndarray, desc_train: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Approximate k=2 NN via cv2 FLANN (KD-tree, trees=4, checks=32 —
    reference FlannFeatureMatcher NORM_L2 params, feature_matcher.py:276-281).
    Returns (indices (N,2), distances (N,2)) like knn2."""
    import cv2

    FLANN_INDEX_KDTREE = 1
    matcher = cv2.FlannBasedMatcher(
        dict(algorithm=FLANN_INDEX_KDTREE, trees=4), dict(checks=32))
    matches = matcher.knnMatch(np.ascontiguousarray(desc_query, np.float32),
                               np.ascontiguousarray(desc_train, np.float32),
                               k=2)
    n = len(matches)
    idx = np.zeros((n, 2), np.int64)
    dist = np.full((n, 2), np.inf, np.float32)
    for q, pair in enumerate(matches):
        for j, m in enumerate(pair[:2]):
            idx[q, j] = m.trainIdx
            dist[q, j] = m.distance
    return idx, dist


def ratio_one_to_one_from_knn(idx: np.ndarray, dist: np.ndarray,
                              ratio_test: float = K_RATIO_TEST):
    """The ratio + one-to-one tail of ratio_test_match_one_to_one, applied
    to precomputed k=2 neighbors (shared by the exact and FLANN paths)."""
    keep = dist[:, 0] <= ratio_test * dist[:, 1]
    idx1, idx2, score = [], [], []
    best_for_train = {}
    index_match = {}
    for q in np.nonzero(keep)[0]:
        t = int(idx[q, 0])
        d = float(dist[q, 0])
        if t not in best_for_train:
            best_for_train[t] = d
            idx1.append(int(q))
            idx2.append(t)
            index_match[t] = len(idx2) - 1
            score.append(d)
        elif d < best_for_train[t]:
            best_for_train[t] = d
            pos = index_match[t]
            idx1[pos] = int(q)
            score[pos] = d
    return (np.asarray(idx1, np.int64), np.asarray(idx2, np.int64),
            np.asarray(score, np.float32))


def match_keypoints_flann(kps_prev, feat_prev, kps_cur, feat_cur,
                          top_k_matches: int = 1000,
                          ratio_test: float = K_RATIO_TEST):
    """FLANN-approximate variant of match_keypoints (reference
    FlannFeatureMatcher, feature_matcher.py:253-282). Same ratio +
    one-to-one tail; NN search is approximate KD-tree."""
    if len(feat_prev) < 2 or len(feat_cur) < 2:
        return np.zeros((0, 2)), np.zeros((0, 2))
    idx, dist = flann_knn2(np.asarray(feat_prev), np.asarray(feat_cur))
    idxs0, idxs1, score = ratio_one_to_one_from_knn(idx, dist, ratio_test)
    kps0 = np.asarray(kps_prev)[idxs0, :]
    kps1 = np.asarray(kps_cur)[idxs1, :]
    if len(score) > top_k_matches > 0:
        top = np.argpartition(score, top_k_matches)[:top_k_matches]
        kps0, kps1 = kps0[top], kps1[top]
    return kps0, kps1


def match_crosscheck_fundamental(kps_prev, feat_prev, kps_cur, feat_cur,
                                 ratio_test: float = K_RATIO_TEST,
                                 err_thld: float = 1.0):
    """Cross-check + ratio test + fundamental-matrix model fit (reference
    matchWithCrossCheckAndModelFit, feature_matcher.py:109-174): mutual-NN
    matches filtered by a USAC_MSAC fundamental-matrix inlier mask.
    Returns (kps0, kps1) inliers only."""
    import cv2

    if len(feat_prev) < 8 or len(feat_cur) < 8:
        return np.zeros((0, 2)), np.zeros((0, 2))
    idx12, dist12 = knn2(np.asarray(feat_prev), np.asarray(feat_cur))
    idx21, _ = knn2(np.asarray(feat_cur), np.asarray(feat_prev))
    q = np.arange(len(idx12))
    cross = idx21[idx12[:, 0], 0] == q
    ratio = dist12[:, 0] <= ratio_test * dist12[:, 1]
    keep = cross & ratio
    if np.count_nonzero(keep) < 8:
        return np.zeros((0, 2)), np.zeros((0, 2))
    kps0 = np.asarray(kps_prev)[keep]
    kps1 = np.asarray(kps_cur)[idx12[keep, 0]]
    method = getattr(cv2, "USAC_MSAC", cv2.RANSAC)
    _, mask = cv2.findFundamentalMat(kps0, kps1, method, err_thld,
                                     confidence=0.999)
    if mask is None:
        return kps0, kps1
    inl = mask.ravel().astype(bool)
    return kps0[inl], kps1[inl]


def match_semantic(kps_prev, feat_prev, seg_prev, kps_cur, feat_cur,
                   seg_cur, n_classes: int = 28,
                   ratio_test: float = K_RATIO_TEST):
    """Per-semantic-class matching (reference
    visual_odometry.py:347-380): only keypoints of the same segmentation
    class are matched against each other, suppressing cross-class outliers.
    Returns (kps0, kps1)."""
    out0, out1 = [], []
    seg_prev = np.asarray(seg_prev).reshape(-1)
    seg_cur = np.asarray(seg_cur).reshape(-1)
    for class_id in range(n_classes):
        i0 = np.where(seg_prev == class_id)[0]
        i1 = np.where(seg_cur == class_id)[0]
        if len(i0) < 2 or len(i1) < 2:
            continue
        q, t, _ = ratio_test_match_one_to_one(
            np.asarray(feat_prev)[i0], np.asarray(feat_cur)[i1], ratio_test)
        if len(q):
            out0.append(np.asarray(kps_prev)[i0][q])
            out1.append(np.asarray(kps_cur)[i1][t])
    if not out0:
        return np.zeros((0, 2)), np.zeros((0, 2))
    return np.concatenate(out0), np.concatenate(out1)


def bf_match_device(feat0: torch.Tensor, feat1: torch.Tensor,
                    mask0: Optional[torch.Tensor] = None,
                    mask1: Optional[torch.Tensor] = None,
                    ratio_test: float = K_RATIO_TEST):
    """Fixed-shape BF matching on the tensors' device: the twin of
    ``ratio_test_match_one_to_one`` (reference feature_matcher.py:179-209):
    k=2 L2 NN + Lowe ratio + one-to-one train dedup keeping the best
    distance (ties -> lowest query index, the host path's first-seen-wins
    order).

    feat0 (K0, C) query, feat1 (K1, C) train, optional boolean validity
    masks for padded slots. Returns (train_idx (K0,) int32, valid (K0,)
    bool): query q matches train train_idx[q] iff valid[q]. Leading dims
    (pairs: (P, K0, C), (P, K1, C), masks (P, K)) match each pair alone.
    """
    K0, K1 = feat0.shape[-2], feat1.shape[-2]
    aa = (feat0 * feat0).sum(-1)[..., :, None]
    bb = (feat1 * feat1).sum(-1)[..., None, :]
    d2 = torch.clamp(aa + bb - 2.0 * feat0 @ feat1.transpose(-1, -2),
                     min=0.0)
    if mask1 is not None:
        d2 = torch.where(mask1[..., None, :], d2, torch.inf)
    # the two smallest; a stable sort keeps lax.top_k's order on ties
    d_sorted, idx2 = torch.sort(d2, dim=-1, stable=True)
    d_pair = torch.sqrt(torch.clamp(d_sorted[..., :2], min=0.0))
    t = idx2[..., 0]
    d0, d1 = d_pair[..., 0], d_pair[..., 1]
    keep = (d0 <= ratio_test * d1) & torch.isfinite(d0)
    if mask0 is not None:
        keep = keep & mask0
    # one-to-one: per train index, the kept query with the smallest
    # distance wins; exact ties go to the smallest query index
    q_idx = torch.arange(K0, device=feat0.device).expand(t.shape)
    d_for_min = torch.where(keep, d0, torch.inf)
    lead = tuple(t.shape[:-1])
    seg_min = torch.full(lead + (K1,), torch.inf, dtype=d0.dtype,
                         device=d0.device).scatter_reduce(
        -1, t, d_for_min, "amin")
    cand = keep & (d0 == torch.gather(seg_min, -1, t))
    q_for_min = torch.where(cand, q_idx, K0)
    seg_min_q = torch.full(lead + (K1,), K0, dtype=q_idx.dtype,
                           device=d0.device).scatter_reduce(
        -1, t, q_for_min, "amin")
    valid = cand & (q_idx == torch.gather(seg_min_q, -1, t))
    return t.to(torch.int32), valid
