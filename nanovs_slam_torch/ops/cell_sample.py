"""Gather-free per-cell descriptor sampling, the counterpart of
``nanovs_slam_tpu/ops/cell_sample.py`` (NHWC, plain PyTorch).

The postprocess samples the dense descriptor map (Hf = 2 Hc rows) at each
cell's decoded keypoint. A decoded coordinate stays within the cell centre
+- cross_ratio (cell - 1) / 2, so every bilinear tap of cell (i, j) lies in
the feature-pixel window of rows 2i-2 .. 2i+3 and columns 2j-2 .. 2j+3.
Bilinear sampling is then a 36-tap hat-weighted stencil,

    out(i, j, c) = sum over a, b in -2..3 of relu(1 - |py - (2i + a)|)
                   * relu(1 - |px - (2j + b)|) * feat(2i + a, 2j + b, c),

of stride-2 slices of the padded map: the hat relu(1 - |d|) is the
bilinear kernel, zero at all but the 4 true taps; taps outside the map
weigh 0 (grid_sample's zero padding). No path of the port calls it (nor
of the JAX package): the postprocess kernel and its twin
(``kernels/postprocess.py``) sample by gathers.
"""

from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor
# the tap window in feature pixels around 2 * the cell index
TAP_OFFSETS = (-2, -1, 0, 1, 2, 3)


def feat_pixel_coords(coord: Tensor, H: int, W: int, Hf: int, Wf: int
                      ) -> Tuple[Tensor, Tensor]:
    """Image coordinates -> feature-map pixel coordinates under
    align_corners=True: px = x / (W - 1) * (Wf - 1)."""
    px = coord[..., 0] * ((Wf - 1) / (W - 1))
    py = coord[..., 1] * ((Hf - 1) / (H - 1))
    return px, py


def sample_cell_descriptors_dense(feat: Tensor, coord: Tensor, H: int,
                                  W: int, normalize: bool = True) -> Tensor:
    """feat (B, Hf, Wf, C) with Hf = 2 Hc, coord (B, Hc, Wc, 2) image
    coordinates -> (B, Hc, Wc, C) bilinear align-corners samples (L2
    normalised with ``normalize``)."""
    B, Hf, Wf, C = feat.shape
    _, Hc, Wc, _ = coord.shape
    if (Hf, Wf) != (2 * Hc, 2 * Wc):
        raise ValueError(f"feat {tuple(feat.shape)} is not twice the cell "
                         f"grid {tuple(coord.shape)}")
    px, py = feat_pixel_coords(coord, H, W, Hf, Wf)
    lo, hi = 2, 3  # the window's reach beyond the map
    fpad = torch.nn.functional.pad(feat, (0, 0, lo, hi, lo, hi))
    jj = torch.arange(Wc, dtype=px.dtype, device=px.device)[None, None] * 2.0
    ii = torch.arange(Hc, dtype=py.dtype, device=py.device)[None, :, None] \
        * 2.0
    out = feat.new_zeros((B, Hc, Wc, C))
    for a in TAP_OFFSETS:
        wy = torch.clamp(1.0 - torch.abs(py - (ii + a)), min=0.0)
        wy = torch.where(((ii + a) >= 0) & ((ii + a) <= Hf - 1), wy, 0.0)
        rows = fpad[:, lo + a:lo + a + 2 * Hc:2]
        for b in TAP_OFFSETS:
            wx = torch.clamp(1.0 - torch.abs(px - (jj + b)), min=0.0)
            wx = torch.where(((jj + b) >= 0) & ((jj + b) <= Wf - 1), wx,
                             0.0)
            tap = rows[:, :, lo + b:lo + b + 2 * Wc:2]
            out = out + (wy * wx).to(feat.dtype)[..., None] * tap
    if normalize:
        o = out.float()
        out = (o / torch.clamp(torch.linalg.vector_norm(
            o, dim=-1, keepdim=True), min=1e-12)).to(feat.dtype)
    return out
