"""A seeded synthetic image pair for the match path: a textured frame and
a copy warped by a known mild homography, so that matches can be scored
against ``extractor.gt_matches_from_homography``. Data preparation, not
part of the path."""

from __future__ import annotations

import numpy as np
import torch

from ..ops.grid_sample import grid_sample_bilinear

# frame 0 px -> frame 1 px: 2% scale and shear, a few px of shift
HOMOGRAPHY = np.array([[1.02, 0.03, -6.0], [-0.02, 0.99, 4.0],
                       [1e-5, -2e-5, 1.0]])


def textured_frame(h: int, w: int, seed: int) -> np.ndarray:
    """Random rectangles on grey with a little noise, (h, w, 3) in [0, 1]."""
    rs = np.random.RandomState(seed)
    img = np.full((h, w, 3), 0.5, np.float32)
    for _ in range(120):
        y0, x0 = rs.randint(0, h), rs.randint(0, w)
        img[y0:y0 + rs.randint(4, h // 4), x0:x0 + rs.randint(4, w // 4)] = \
            rs.rand(3)
    img += rs.rand(h, w, 3).astype(np.float32) * 0.05
    return np.clip(img, 0, 1)


def warp_frame(img: np.ndarray, homography: np.ndarray = HOMOGRAPHY
               ) -> np.ndarray:
    """img warped by ``homography`` (frame 0 px -> frame 1 px), bilinear
    through the port's sampler, zero outside."""
    h, w = img.shape[:2]
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    src = np.stack([xs, ys, np.ones_like(xs)], -1) @ np.linalg.inv(
        homography).T
    src = src[..., :2] / src[..., 2:]
    grid = np.stack([src[..., 0] / (w - 1), src[..., 1] / (h - 1)], -1) * 2 - 1
    out = grid_sample_bilinear(torch.from_numpy(img)[None],
                               torch.from_numpy(grid.astype(np.float32))[None])
    return out[0].numpy()
