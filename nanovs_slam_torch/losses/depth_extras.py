"""Additional depth and segmentation losses, the counterparts of
``nanovs_slam_tpu/losses/depth_extras.py`` (the reference loss library,
src/kp2dtiny/utils/losses.py:155-318), as plain tensor functions. The
shipped training configs do not use them (their grad / normal factors are
0.0); they are part of the framework's surface. Maps are NHWC.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def jaccard_distance_loss(y_true: Tensor, y_pred: Tensor,
                          smooth: float = 100.0) -> Tensor:
    """(losses.py:155-172), over the last dim."""
    intersection = torch.abs(y_true * y_pred).sum(dim=-1)
    total = torch.sum(torch.abs(y_true) + torch.abs(y_pred), dim=-1)
    jac = (intersection + smooth) / (total - intersection + smooth)
    return (1.0 - jac) * smooth


def rmse_log(pred: Tensor, gt: Tensor) -> Tensor:
    """(losses.py:199-208)"""
    return torch.sqrt(torch.mean(torch.abs(torch.log(gt) - torch.log(pred))
                                 ** 2))


def l1(pred: Tensor, gt: Tensor) -> Tensor:
    """(losses.py:211-220): mean |10 gt - 10 pred|."""
    return torch.mean(torch.abs(10.0 * gt - 10.0 * pred))


def l1_log(pred: Tensor, gt: Tensor) -> Tensor:
    return torch.mean(torch.abs(torch.log(gt) - torch.log(pred)))


def rmse(pred: Tensor, gt: Tensor) -> Tensor:
    return torch.sqrt(torch.mean(torch.abs(10.0 * gt - 10.0 * pred) ** 2))


def berhu(pred: Tensor, gt: Tensor, threshold: float = 0.2) -> Tensor:
    """(losses.py:235-255): reverse Huber with delta = threshold times the
    largest |gt - pred| where gt > 0 (pred zeroed elsewhere)."""
    pred = pred * (gt > 0).to(pred.dtype)
    diff = torch.abs(gt - pred)
    delta = threshold * torch.max(diff)
    zero = torch.zeros_like(diff)
    part1 = torch.where(diff <= delta, diff, zero)
    part2 = torch.where(diff > delta,
                        (diff ** 2 - delta ** 2) / (2.0 * delta) + delta, zero)
    return torch.sum(part1 + part2)


def sobel_gradients(img: Tensor) -> Tuple[Tensor, Tensor]:
    """(gy, gx), each (B, H, W, 1), of a (B, H, W, 1) map: 3x3 Sobel
    cross-correlations with zero padding (the Grad module,
    losses.py:270-290)."""
    fx = torch.tensor([[1.0, 0.0, -1.0], [2.0, 0.0, -2.0], [1.0, 0.0, -1.0]],
                      dtype=img.dtype, device=img.device)
    fy = torch.tensor([[1.0, 2.0, 1.0], [0.0, 0.0, 0.0], [-1.0, -2.0, -1.0]],
                      dtype=img.dtype, device=img.device)
    out = F.conv2d(img.permute(0, 3, 1, 2), torch.stack([fy, fx])[:, None],
                   padding=1).permute(0, 2, 3, 1)
    return out[..., 0:1], out[..., 1:2]


def grad_loss(grad_fake: Tensor, grad_real: Tensor,
              mask: Optional[Tensor] = None) -> Tensor:
    """(losses.py:293-302): mean |grad_real - grad_fake|, over ``mask``
    where given."""
    d = torch.abs(grad_real - grad_fake)
    if mask is not None:
        m = mask.to(d.dtype)
        return torch.sum(d * m) / torch.clamp(torch.sum(m), min=1.0)
    return torch.mean(d)


def normal_loss(grad_fake: Tensor, grad_real: Tensor,
                eps: float = 1e-12) -> Tensor:
    """(losses.py:305-318): 1 - the mean cosine of the gradient directions;
    grads (B, N, 2)."""
    prod = torch.sum(grad_fake * grad_real, dim=-1)
    fn = torch.sqrt(torch.sum(grad_fake ** 2, dim=-1))
    rn = torch.sqrt(torch.sum(grad_real ** 2, dim=-1))
    return 1.0 - torch.mean(prod / torch.clamp(fn * rn, min=eps))
