"""Depth losses, the counterpart of ``nanovs_slam_tpu/losses/depth.py``:
depth loss = SILog(pred, gt, mask = gt > 0) + Huber(pred, gt, mask) *
huber_factor, with SILog = 10 sqrt(var(g) + 0.15 mean(g)^2), g = log pred -
log gt, var with Bessel's correction (torch.var), over the masked
elements."""

from __future__ import annotations

from typing import Optional

import torch

Tensor = torch.Tensor


def _masked_moments(x: Tensor, mask: Tensor):
    m = mask.to(x.dtype)
    n = torch.sum(m)
    mean = torch.sum(x * m) / torch.clamp(n, min=1.0)
    var_biased = torch.sum((x - mean) ** 2 * m) / torch.clamp(n, min=1.0)
    var = var_biased * n / torch.clamp(n - 1.0, min=1.0)
    return mean, var, n


def silog_loss(pred: Tensor, gt: Tensor,
               mask: Optional[Tensor] = None) -> Tensor:
    if mask is None:
        mask = torch.ones_like(gt, dtype=torch.bool)
    one = torch.ones_like(pred)
    g = torch.log(torch.where(mask, pred, one)) - torch.log(
        torch.where(mask, gt, one))
    mean, var, _ = _masked_moments(g, mask)
    return 10.0 * torch.sqrt(var + 0.15 * mean ** 2)


def huber_loss(pred: Tensor, gt: Tensor, mask: Optional[Tensor] = None,
               delta: float = 1.0) -> Tensor:
    if mask is None:
        mask = torch.ones_like(gt, dtype=torch.bool)
    d = torch.abs(pred - gt)
    per = torch.where(d < delta, 0.5 * d * d, delta * (d - 0.5 * delta))
    m = mask.to(per.dtype)
    return torch.sum(per * m) / torch.clamp(torch.sum(m), min=1.0)


def depth_loss(pred: Tensor, gt: Tensor, huber_factor: float = 1.0
               ) -> Tensor:
    """pred / gt (B, H, W, 1) at the same size."""
    mask = gt > 0.0
    return silog_loss(pred, gt, mask) + huber_loss(pred, gt, mask) \
        * huber_factor
