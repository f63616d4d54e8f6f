"""Bilinear and nearest grid sampling with align_corners=True and zero
padding (NHWC), the counterpart of ``nanovs_slam_tpu/ops/grid_sample.py``:

  pixel = (norm + 1) / 2 * (size - 1); out-of-range taps contribute 0.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample_bilinear(img: torch.Tensor,
                         grid: torch.Tensor) -> torch.Tensor:
    """img (B, H, W, C); grid (B, ..., 2) normalised coords in [-1, 1]
    ([..., 0] = x) -> (B, ..., C)."""
    B, C = img.shape[0], img.shape[-1]
    lead = grid.shape[1:-1]
    g = grid.reshape(B, 1, -1, 2).to(img.dtype)
    out = F.grid_sample(img.permute(0, 3, 1, 2), g, mode="bilinear",
                        padding_mode="zeros", align_corners=True)
    return out[:, :, 0].permute(0, 2, 1).reshape((B,) + tuple(lead) + (C,))


def grid_sample_nearest(img: torch.Tensor,
                        grid: torch.Tensor) -> torch.Tensor:
    """img (B, H, W, C); grid (B, ..., 2) normalised coords in [-1, 1]
    ([..., 0] = x) -> (B, ..., C): the pixel at ``floor(p + 0.5)``,
    clipped to the image; a point outside [-0.5, size - 0.5] reads 0 (the
    JAX formulation, whose ties at .5 round up)."""
    B, Hi, Wi, C = img.shape
    lead = grid.shape[1:-1]
    g = grid.reshape(B, -1, 2)
    px = (g[..., 0] + 1.0) * 0.5 * (Wi - 1)
    py = (g[..., 1] + 1.0) * 0.5 * (Hi - 1)
    ix = torch.floor(px + 0.5).long().clamp(0, Wi - 1)
    iy = torch.floor(py + 0.5).long().clamp(0, Hi - 1)
    valid = ((px >= -0.5) & (px <= Wi - 0.5) & (py >= -0.5)
             & (py <= Hi - 0.5)).to(img.dtype)
    idx = (iy * Wi + ix)[..., None].expand(B, ix.shape[1], C)
    out = torch.gather(img.reshape(B, Hi * Wi, C), 1, idx) * valid[..., None]
    return out.reshape((B,) + tuple(lead) + (C,))


def sample_descriptors(feat: torch.Tensor, coords: torch.Tensor, H: int,
                       W: int, normalize: bool = True) -> torch.Tensor:
    """Sample a dense descriptor map at image coordinates.

    feat (B, Hf, Wf, C); coords (B, ..., 2) image coords with [..., 0] = x
    in [0, W-1] -> (B, ..., C), divided by max(||v||, 1e-12) if
    ``normalize``.
    """
    gx = coords[..., 0] / ((W - 1) / 2.0) - 1.0
    gy = coords[..., 1] / ((H - 1) / 2.0) - 1.0
    out = grid_sample_bilinear(feat, torch.stack([gx, gy], dim=-1))
    if normalize:
        dn = torch.linalg.vector_norm(out, dim=-1, keepdim=True)
        out = out / torch.clamp(dn, min=1e-12)
    return out
