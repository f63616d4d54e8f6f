"""Segmentation losses, the counterpart of
``nanovs_slam_tpu/losses/segmentation.py``: cross-entropy (ignore 255) and
multiclass soft Dice (segmentation_models_pytorch semantics: per-class
dice over batch and space, smooth 0, eps 1e-7, classes absent from the
labels zeroed, mean over classes); seg loss = CE * 0.5 + Dice * 1.5.
Logits are NHWC (B, H, W, C), labels (B, H, W) int."""

from __future__ import annotations

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def cross_entropy_loss(logits: Tensor, labels: Tensor,
                       ignore_index: int = 255) -> Tensor:
    """Mean negative log-likelihood over the non-ignored pixels."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    m = valid.to(nll.dtype)
    return torch.sum(nll * m) / torch.clamp(torch.sum(m), min=1.0)


def dice_loss(logits: Tensor, labels: Tensor, ignore_index: int = 255,
              smooth: float = 0.0, eps: float = 1e-7) -> Tensor:
    B, C = logits.shape[0], logits.shape[-1]
    probs = torch.softmax(logits, dim=-1).reshape(B, -1, C)
    labels_flat = labels.reshape(B, -1)
    valid = (labels_flat != ignore_index)[..., None].to(probs.dtype)
    safe = torch.where(labels_flat != ignore_index, labels_flat,
                       torch.zeros_like(labels_flat)).long()
    onehot = F.one_hot(safe, C).to(probs.dtype) * valid
    probs = probs * valid
    inter = torch.sum(probs * onehot, dim=(0, 1))
    card = torch.sum(probs + onehot, dim=(0, 1))
    denom = card + smooth
    dice = (2.0 * inter + smooth) / torch.maximum(
        denom, torch.full_like(denom, eps))
    present = (torch.sum(onehot, dim=(0, 1)) > 0).to(dice.dtype)
    return torch.mean((1.0 - dice) * present)


def segmentation_loss(logits: Tensor, labels: Tensor,
                      ignore_index: int = 255) -> Tensor:
    """CE * 0.5 + Dice * 1.5."""
    return (cross_entropy_loss(logits, labels, ignore_index) * 0.5
            + dice_loss(logits, labels, ignore_index) * 1.5)
