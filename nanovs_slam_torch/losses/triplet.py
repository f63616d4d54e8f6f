"""Batch-hard triplet loss for global descriptors, the counterpart of
``nanovs_slam_tpu/losses/triplet.py``: the Gram-matrix distance with a
clamp at 0 and the zero-distance eps, hardest positive (max) and hardest
negative (min, negatives masked by adding the row max), mean of
max(dp - dn + 0.1, 0) (the reference's hard-coded margin). Maxima and
minima split their gradient over ties and the clamps give half at a tie,
as ``jnp.max`` / ``jnp.maximum`` do."""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def _max0(x: Tensor) -> Tensor:
    return torch.maximum(x, torch.zeros_like(x))


def pairwise_distance(x: Tensor, squared: bool = False,
                      eps: float = 1e-16) -> Tensor:
    cor = x @ x.T
    norm = torch.diagonal(cor)
    d = _max0(norm[:, None] - 2 * cor + norm[None, :])
    if not squared:
        zero_mask = (d == 0.0).to(d.dtype)
        d = torch.sqrt(d + zero_mask * eps) * (1.0 - zero_mask)
    return d


def hard_triplet_loss(embeddings: Tensor, labels: Tensor,
                      margin: float = 0.1, hardest: bool = True,
                      squared: bool = False) -> Tensor:
    """embeddings (N, D), labels (N,) int."""
    d = pairwise_distance(embeddings, squared=squared)
    n = labels.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=d.device)
    same = labels[None, :] == labels[:, None]
    if hardest:
        pos_mask = (same & ~eye).to(d.dtype)
        hardest_pos = torch.amax(d * pos_mask, dim=1, keepdim=True)
        neg_mask = (~same).to(d.dtype)
        row_max = torch.amax(d, dim=1, keepdim=True)
        anchor_neg = d + row_max * (1.0 - neg_mask)
        hardest_neg = torch.amin(anchor_neg, dim=1, keepdim=True)
        return torch.mean(_max0(hardest_pos - hardest_neg + 0.1))
    loss = d[:, :, None] - d[:, None, :] + margin
    valid = (same[:, :, None] & ~same[:, None, :] & ~eye[:, :, None]
             & ~eye[:, None, :] & ~eye[None, :, :])
    loss = _max0(loss * valid.to(loss.dtype))
    n_hard = torch.sum((loss > 1e-16).to(loss.dtype))
    return torch.sum(loss) / (n_hard + 1e-16)


def global_descriptor_loss(pred: Tensor, pred_aug: Tensor) -> Tensor:
    """The trainer's VPR loss: (pred, pred_aug) stacked with paired labels,
    batch-hard mining."""
    n = pred.shape[0]
    labels = torch.cat([torch.arange(n), torch.arange(n)]).to(pred.device)
    return hard_triplet_loss(torch.cat([pred, pred_aug], dim=0), labels,
                             hardest=True)
