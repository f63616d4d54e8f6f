"""Segmentation metrics: IoU / accuracy / F1, micro- and macro-imagewise
(a copy of ``nanovs_slam_tpu/evaluation/segmentation.py``).

Implements the segmentation_models_pytorch stats+reduction semantics the
reference relies on (src/evaluation/segmentation.py:42-61):
- get_stats(multiclass, ignore_index=255): per-image per-class tp/fp/fn/tn
  counts over the argmax map.
- micro-imagewise: per image, sum stats over classes, compute the metric,
  then average over images.
- macro-imagewise: per image, compute the metric per class, average over
  classes, then average over images.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable

import numpy as np


def segmentation_stats(pred: np.ndarray, gt: np.ndarray, n_classes: int,
                       ignore_index: int = 255):
    """pred/gt (B, H, W) int -> tp, fp, fn, tn each (B, n_classes)."""
    B = pred.shape[0]
    tp = np.zeros((B, n_classes), np.int64)
    fp = np.zeros((B, n_classes), np.int64)
    fn = np.zeros((B, n_classes), np.int64)
    tn = np.zeros((B, n_classes), np.int64)
    for b in range(B):
        p = pred[b].reshape(-1)
        g = gt[b].reshape(-1)
        valid = g != ignore_index
        p, g = p[valid], g[valid]
        total = p.shape[0]
        for c in range(n_classes):
            pc = p == c
            gc = g == c
            tp[b, c] = np.sum(pc & gc)
            fp[b, c] = np.sum(pc & ~gc)
            fn[b, c] = np.sum(~pc & gc)
            tn[b, c] = total - tp[b, c] - fp[b, c] - fn[b, c]
    return tp, fp, fn, tn


def _safe_div(num, den):
    return np.where(den == 0, 0.0, num / np.maximum(den, 1e-12))


def _reduce(metric_fn, tp, fp, fn, tn, reduction: str) -> float:
    if reduction == "micro-imagewise":
        score = metric_fn(tp.sum(1), fp.sum(1), fn.sum(1), tn.sum(1))
        return float(np.mean(score))
    if reduction == "macro-imagewise":
        score = metric_fn(tp, fp, fn, tn)  # (B, C)
        return float(np.mean(score.mean(1)))
    raise ValueError(reduction)


def iou_score(tp, fp, fn, tn):
    return _safe_div(tp, tp + fp + fn)


def accuracy(tp, fp, fn, tn):
    return _safe_div(tp + tn, tp + fp + fn + tn)


def f1_score(tp, fp, fn, tn):
    return _safe_div(2 * tp, 2 * tp + fp + fn)


def evaluate_segmentation(data_iter: Iterable[Dict], infer_fn: Callable,
                          n_classes: int) -> Dict[str, float]:
    """data_iter yields {image (B,H,W,3), seg (B,h,w) int}; infer_fn returns
    post-processed outputs with seg (B,h,w,1) argmax maps."""
    iou_m, iou_M, acc_m, f1_m, n = 0.0, 0.0, 0.0, 0.0, 0
    for sample in data_iter:
        out = infer_fn(sample["image"])
        pred = np.asarray(out["seg"])[..., 0].astype(np.int64)
        gt = np.asarray(sample["seg"]).astype(np.int64)
        tp, fp, fn_, tn = segmentation_stats(pred, gt, n_classes)
        iou_m += _reduce(iou_score, tp, fp, fn_, tn, "micro-imagewise")
        iou_M += _reduce(iou_score, tp, fp, fn_, tn, "macro-imagewise")
        acc_m += _reduce(accuracy, tp, fp, fn_, tn, "micro-imagewise")
        f1_m += _reduce(f1_score, tp, fp, fn_, tn, "micro-imagewise")
        n += 1
    n = max(n, 1)
    return {"IoU": iou_m / n, "IoU_macro": iou_M / n,
            "accuracy": acc_m / n, "f1": f1_m / n}
