"""Monocular depth metrics (a copy of
``nanovs_slam_tpu/evaluation/depth.py``; reference
src/evaluation/depth_estimation.py:35-83):
delta<1.25/1.25^2/1.25^3, abs_rel, sq_rel, RMSE, RMSE_log, SILog, log10,
with a running-average aggregator."""

from __future__ import annotations

from typing import Callable, Dict, Iterable

import numpy as np


def compute_depth_errors(gt: np.ndarray, pred: np.ndarray) -> Dict[str, float]:
    gt = np.asarray(gt, np.float64)
    pred = np.asarray(pred, np.float64)
    thresh = np.maximum(gt / pred, pred / gt)
    a1 = float((thresh < 1.25).mean())
    a2 = float((thresh < 1.25 ** 2).mean())
    a3 = float((thresh < 1.25 ** 3).mean())
    abs_rel = float(np.mean(np.abs(gt - pred) / gt))
    sq_rel = float(np.mean(((gt - pred) ** 2) / gt))
    rmse = float(np.sqrt(np.mean((gt - pred) ** 2)))
    rmse_log = float(np.sqrt(np.mean((np.log(gt) - np.log(pred)) ** 2)))
    err = np.log(pred) - np.log(gt)
    silog = float(np.sqrt(np.mean(err ** 2) - np.mean(err) ** 2) * 100)
    log_10 = float(np.abs(np.log10(gt) - np.log10(pred)).mean())
    return dict(a1=a1, a2=a2, a3=a3, abs_rel=abs_rel, sq_rel=sq_rel,
                rmse=rmse, rmse_log=rmse_log, silog=silog, log_10=log_10)


class RunningAverageDict:
    def __init__(self):
        self._sums: Dict[str, float] = {}
        self._count = 0

    def update(self, new: Dict[str, float]):
        for k, v in new.items():
            self._sums[k] = self._sums.get(k, 0.0) + v
        self._count += 1

    def get_value(self) -> Dict[str, float]:
        return {k: v / max(self._count, 1) for k, v in self._sums.items()}


def evaluate_depth(data_iter: Iterable[Dict], infer_fn: Callable
                   ) -> Dict[str, float]:
    metrics = RunningAverageDict()
    for sample in data_iter:
        out = infer_fn(sample["image"])
        pred = np.asarray(out["depth"])
        gt = np.asarray(sample["depth"])
        metrics.update(compute_depth_errors(gt, pred))
    return metrics.get_value()
