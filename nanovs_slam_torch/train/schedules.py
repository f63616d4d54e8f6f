"""Loss-weight schedules and LR schedules, the counterpart of
``nanovs_slam_tpu/train/schedules.py``:
- the default loss weights and the per-epoch schedules "default",
  "refined" and "D", applied at the epoch boundary (folded forward, so a
  resume gets the weights of its epoch);
- LR schedules of the step count: none, step (step_size 10 epochs, gamma
  0.1), cosine warm restarts (T0 = 2 epochs, eta_min 0, stepped per
  iteration at the fractional epoch), plateau (driven by
  ``PlateauController`` between epochs). They compute in float32 as the
  JAX schedules do.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np

from .multitask_loss import LossWeights

DEFAULT_LOSS_WEIGHTS = LossWeights(
    keypoint_loss=0.5, loc_loss=1.0, io_loss=1.0, score_loss=1.0,
    descriptor_loss=2.0, segmentation_loss=2.0, vlad_loss=1.0,
    depth_loss=0.5, huber_loss=1.0)

# epoch -> partial weight overrides (train_multitask.py:63-73)
SCHEDULE_DEFAULT: Dict[int, Dict[str, float]] = {
    5: dict(keypoint_loss=1.4, score_loss=1.4, descriptor_loss=2.0,
            segmentation_loss=0.5, vlad_loss=1.0, depth_loss=0.5,
            huber_loss=1.0),
}

# train_multitask.py:76-143
SCHEDULE_REFINED: Dict[int, Dict[str, float]] = {
    0: dict(keypoint_loss=2.0, loc_loss=1.0, io_loss=1.0, score_loss=1.0,
            descriptor_loss=2.0, segmentation_loss=5.0, vlad_loss=1.0,
            depth_loss=0.5, huber_loss=1.0),
    3: dict(keypoint_loss=0.1, loc_loss=1.0, io_loss=1.0, score_loss=1.0,
            descriptor_loss=2.0, segmentation_loss=4.0, vlad_loss=0.1,
            depth_loss=0.5, huber_loss=1.0),
    50: dict(keypoint_loss=0.2, loc_loss=1.0, io_loss=1.0, score_loss=1.0,
             descriptor_loss=2.0, segmentation_loss=3.0, vlad_loss=0.3,
             depth_loss=0.5, huber_loss=1.0),
    75: dict(keypoint_loss=0.5, loc_loss=1.0, io_loss=1.0, score_loss=1.5,
             descriptor_loss=2.0, segmentation_loss=2.0, vlad_loss=1.0,
             depth_loss=0.5, huber_loss=1.0),
    90: dict(keypoint_loss=0.7, loc_loss=1.0, io_loss=1.0, score_loss=1.5,
             descriptor_loss=2.0, segmentation_loss=1.5, vlad_loss=2.0,
             depth_loss=0.5, huber_loss=1.0),
    95: dict(keypoint_loss=0.3, loc_loss=1.0, io_loss=1.0, score_loss=1.5,
             descriptor_loss=2.0, segmentation_loss=1.5, vlad_loss=1.0,
             depth_loss=0.5, huber_loss=1.0),
}

# train_multitask.py:145-173
SCHEDULE_D: Dict[int, Dict[str, float]] = {
    10: dict(keypoint_loss=1.4, score_loss=1.4, descriptor_loss=2.0,
             segmentation_loss=0.5, vlad_loss=3.0, depth_loss=0.5,
             huber_loss=1.0),
    25: dict(keypoint_loss=1.0, score_loss=1.0, descriptor_loss=2.5,
             segmentation_loss=2.0, vlad_loss=2.0, depth_loss=0.5,
             huber_loss=1.0),
    30: dict(keypoint_loss=1.2, score_loss=1.2, descriptor_loss=2.0,
             segmentation_loss=1.0, vlad_loss=1.5, depth_loss=0.5,
             huber_loss=1.0),
}

SCHEDULES = {"default": SCHEDULE_DEFAULT, "refined": SCHEDULE_REFINED,
             "D": SCHEDULE_D, "none": {}}


def loss_weights_for_epoch(epoch: int, schedule_name: str = "default",
                           base: Optional[LossWeights] = None) -> LossWeights:
    """Resolve the loss weights active at `epoch` (the reference mutates
    weights when `epoch in schedule`; we fold forward so resume works)."""
    w = (base or DEFAULT_LOSS_WEIGHTS)._asdict()
    sched = SCHEDULES[schedule_name]
    for e in sorted(sched):
        if epoch >= e:
            w.update(sched[e])
    return LossWeights(**w)


def make_lr_schedule(name: str, lr: float, steps_per_epoch: int,
                     n_epochs: int):
    """Returns lr(step) for an int step (the optimizer's step count before
    the update, as optax evaluates a schedule)."""
    if name in ("none", None, "plateau"):
        # plateau: the trainer's PlateauController sets the LR per epoch
        return lambda step: lr
    spe = np.float32(max(steps_per_epoch, 1))
    lr32 = np.float32(lr)
    if name == "step":
        def sched(step):
            epoch = int(step) // int(spe)
            return float(lr32 * np.power(np.float32(0.1),
                                         np.float32(epoch // 10)))
        return sched
    if name == "cosine":
        # CosineAnnealingWarmRestarts(T_0=2, eta_min=0), T_mult=1
        T0 = np.float32(2.0)

        def sched(step):
            t = np.mod(np.float32(step) / spe, T0)
            return float(lr32 * np.float32(0.5) * (
                np.float32(1.0) + np.cos(np.float32(np.pi) * t / T0)))
        return sched
    raise NotImplementedError(name)


class PlateauController:
    """ReduceLROnPlateau analog (reference train_multitask.py:386-388:
    mode="max", factor=0.1, patience=5).

    Quirk note: the reference steps its plateau scheduler per-iteration
    with the FRACTIONAL EPOCH as the metric (train_multitask.py:521-522),
    which under mode="max" monotonically increases, so its LR never
    actually drops. We implement the intended semantics instead: feed a
    validation metric (or -train_loss) once per epoch."""

    def __init__(self, lr: float, mode: str = "max", factor: float = 0.1,
                 patience: int = 5, min_lr: float = 0.0,
                 threshold: float = 1e-4):
        assert mode in ("max", "min")
        self.lr = float(lr)
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.threshold = threshold
        self.best: Optional[float] = None
        self.bad_epochs = 0

    def _improved(self, metric: float) -> bool:
        if self.best is None:
            return True
        if self.mode == "max":
            return metric > self.best * (1.0 + self.threshold) \
                if self.best >= 0 else metric > self.best * (1.0 - self.threshold)
        return metric < self.best * (1.0 - self.threshold) \
            if self.best >= 0 else metric < self.best * (1.0 + self.threshold)

    def step(self, metric: float) -> float:
        """Record an epoch metric; returns the (possibly reduced) LR."""
        metric = float(metric)
        if math.isnan(metric):
            self.bad_epochs += 1
        elif self._improved(metric):
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
        if self.bad_epochs > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.bad_epochs = 0
        return self.lr
