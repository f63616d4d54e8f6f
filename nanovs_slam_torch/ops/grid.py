"""Cell-grid keypoint coordinate decoding (NHWC), the counterpart of
``nanovs_slam_tpu/ops/grid.py``.

coord = grid * cell + step + tanh_shift * cross_ratio * step with
step = (cell - 1) / 2; x clamped to [0, W-1], y to [0, H-1]. Channel 0 is
x (column), channel 1 is y (row).
"""

from __future__ import annotations

import torch


def image_grid(Hc: int, Wc: int, device=None,
               dtype=torch.float32) -> torch.Tensor:
    """(Hc, Wc, 2) grid with [..., 0] = x (column) and [..., 1] = y (row)."""
    ys, xs = torch.meshgrid(torch.arange(Hc, device=device, dtype=dtype),
                            torch.arange(Wc, device=device, dtype=dtype),
                            indexing="ij")
    return torch.stack([xs, ys], dim=-1)


def decode_coords(shift: torch.Tensor, H: int, W: int, cell: int,
                  cross_ratio: float = 2.0) -> torch.Tensor:
    """Tanh shifts (B, Hc, Wc, 2) -> image coordinates (B, Hc, Wc, 2)."""
    B, Hc, Wc, _ = shift.shape
    step = (cell - 1) / 2.0
    base = image_grid(Hc, Wc, shift.device, shift.dtype) * cell + step
    coord = base[None] + shift * (cross_ratio * step)
    x = torch.clamp(coord[..., 0], 0.0, W - 1.0)
    y = torch.clamp(coord[..., 1], 0.0, H - 1.0)
    return torch.stack([x, y], dim=-1)


def remove_border(score: torch.Tensor) -> torch.Tensor:
    """Zero the 1-cell border of the score map (B, Hc, Wc, 1)."""
    mask = torch.zeros_like(score)
    mask[:, 1:-1, 1:-1] = 1.0
    return score * mask
