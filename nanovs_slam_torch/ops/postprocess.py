"""Inference post-processing (NHWC), the counterpart of
``nanovs_slam_tpu/ops/postprocess.py``: border mask, coordinate decode,
descriptor sampling, segmentation argmax and fixed-K keypoint selection.

At eval the border mask, decode and sampling run through the fused
postprocess wrapper: its CUDA kernel for CUDA tensors, its plain twin for
CPU tensors.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..kernels.postprocess import fused_postprocess
from .grid import decode_coords, remove_border

Tensor = torch.Tensor


def post_process(out: Dict[str, Tensor], H: int, W: int, cell: int,
                 cross_ratio: float = 2.0, eval_mode: bool = True
                 ) -> Dict[str, Tensor]:
    """out: score (B,Hc,Wc,1) sigmoid scores, coord (B,Hc,Wc,2) tanh shifts,
    feat (B,Hs,Ws,C) dense descriptors, seg (B,Hs,Ws,nCls), all NHWC.
    Returns a new dict with the border-masked score, decoded image coords
    and, if ``eval_mode``, per-cell L2-normalised descriptors sampled at the
    coords (B,Hc,Wc,C) and the argmax class map (B,Hs,Ws,1) int32."""
    out = dict(out)
    if eval_mode and "feat" in out:
        out["score"], out["coord"], out["feat"] = fused_postprocess(
            out["score"], out["coord"], out["feat"], H, W, cell, cross_ratio)
    else:
        out["score"] = remove_border(out["score"])
        out["coord"] = decode_coords(out["coord"], H, W, cell, cross_ratio)
    if eval_mode and "seg" in out:
        out["seg"] = torch.argmax(out["seg"], dim=-1,
                                  keepdim=True).to(torch.int32)
    return out


def stable_top_k(values: Tensor, k: int):
    """(top values, their indices) of the last dim, descending, equal
    values with the lower index first, as ``jax.lax.top_k`` orders them
    (``torch.topk`` does not promise an order among ties)."""
    top, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return top[..., :k], idx[..., :k]


def top_k_keypoints(score: Tensor, coord: Tensor, feat: Tensor, k: int,
                    conf_threshold: float = 0.0, with_indices: bool = False):
    """Fixed-shape top-K keypoint selection over all cells.

    score (B,Hc,Wc,1), coord (B,Hc,Wc,2), feat (B,Hc,Wc,C) ->
    (kp_xy (B,K,2), kp_score (B,K), desc (B,K,C), valid (B,K) bool) with
    K = min(k, Hc*Wc), and with ``with_indices`` the selected cells' flat
    indices (B,K) int64 after them. Entries at or below
    ``conf_threshold`` are marked invalid; their data is still the
    next-best cells. Equal scores keep the lower cell index first, as
    ``jax.lax.top_k`` orders them (a saturated score head gives many cells
    a score of exactly 1).
    """
    B, Hc, Wc, _ = score.shape
    k = min(k, Hc * Wc)
    top_s, idx = stable_top_k(score.reshape(B, Hc * Wc), k)
    kp = torch.gather(coord.reshape(B, Hc * Wc, 2), 1,
                      idx[..., None].expand(B, k, 2))
    C = feat.shape[-1]
    ds = torch.gather(feat.reshape(B, Hc * Wc, C), 1,
                      idx[..., None].expand(B, k, C))
    if with_indices:
        return kp, top_s, ds, top_s > conf_threshold, idx
    return kp, top_s, ds, top_s > conf_threshold
