"""Random homography sampling and homography image warping on the device,
the counterpart of ``nanovs_slam_tpu/data/homography.py``.

- ``sample_homography``: a copy of the JAX package's numpy function (corner
  perturbations in normalised [-1, 1] coordinates, the 8-dof DLT by pinv),
  driven by the caller's ``RandomState``, so that a seed gives the same
  homography bit for bit.
- ``homography_warp_image``: for every destination pixel p in normalised
  align-corners coordinates, sample the source at H @ p (torchgeometry's
  ``HomographyWarper``), through ``ops/grid_sample`` (nearest or
  bilinear), on the tensors' device. The destination grid is built with
  ``jnp.linspace``'s arithmetic, so that it equals the JAX package's.
- ``homography_to_pixel``: the pixel point-transfer matrix (numpy copy).
"""

from __future__ import annotations

from math import pi
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.grid_sample import grid_sample_bilinear, grid_sample_nearest


def sample_homography(
    shape: Tuple[int, int],
    rng: Optional[np.random.RandomState] = None,
    perspective: bool = True,
    scaling: bool = True,
    rotation: bool = True,
    translation: bool = True,
    n_scales: int = 100,
    n_angles: int = 100,
    scaling_amplitude: float = 0.2,
    perspective_amplitude: float = 0.2,
    patch_ratio: float = 0.7,
    max_angle: float = pi / 2,
) -> np.ndarray:
    """Sample a random 3x3 homography in normalized coords (numpy, host)."""
    rng = rng or np.random
    hw_ratio = float(shape[0]) / float(shape[1])

    pts1 = np.array([[-1.0, -1.0], [-1.0, 1.0], [1.0, -1.0], [1.0, 1.0]])
    pts2 = pts1 * patch_ratio
    pts2[:, 1] *= hw_ratio

    if perspective:
        amp = perspective_amplitude / 2
        px = np.clip(rng.normal(0.0, amp, 2), -amp, amp)
        py = np.clip(rng.normal(0.0, hw_ratio * amp, 2),
                     -hw_ratio * amp, hw_ratio * amp)
        pts2[0] -= [px[1], py[1]]
        pts2[1] += [-px[0], py[1]]
        pts2[2] += [px[1], -py[0]]
        pts2[3] += [px[0], py[0]]

    if scaling:
        amp = scaling_amplitude / 2
        scales = np.clip(rng.normal(1.0, amp, n_scales), 1 - amp, 1 + amp)
        center = pts2.mean(axis=0, keepdims=True)
        s = scales[rng.randint(n_scales)]
        pts2 = (pts2 - center) * s + center

    if translation:
        t_min = np.min(pts2 - [-1.0, -hw_ratio], axis=0)
        t_max = np.min([1.0, hw_ratio] - pts2, axis=0)
        pts2 += np.array([rng.uniform(-t_min[0], t_max[0]),
                          rng.uniform(-t_min[1], t_max[1])])[None]

    if rotation:
        angles = np.concatenate([[0.0],
                                 np.linspace(-max_angle, max_angle, n_angles)])
        center = pts2.mean(axis=0, keepdims=True)
        rot = np.stack([np.cos(angles), -np.sin(angles),
                        np.sin(angles), np.cos(angles)], axis=1).reshape(-1, 2, 2)
        rotated = np.matmul((pts2 - center)[None], rot) + center
        valid = np.where(np.all((rotated >= [-1.0, -hw_ratio])
                                & (rotated < [1.0, hw_ratio]), axis=(1, 2)))[0]
        pts2 = rotated[valid[rng.randint(len(valid))]]

    pts2 = pts2.copy()
    pts2[:, 1] /= hw_ratio

    # DLT: solve for H mapping pts1 -> pts2 with pinv (dataset_utils:123-135)
    def ax(p, q):
        return [p[0], p[1], 1, 0, 0, 0, -p[0] * q[0], -p[1] * q[0]]

    def ay(p, q):
        return [0, 0, 0, p[0], p[1], 1, -p[0] * q[1], -p[1] * q[1]]

    a_mat = np.stack([f(pts1[i], pts2[i]) for i in range(4)
                      for f in (ax, ay)])
    p_vec = np.array([pts2[i][j] for i in range(4) for j in range(2)])
    h = np.linalg.pinv(a_mat) @ p_vec
    return np.concatenate([h, [1.0]]).reshape(3, 3).astype(np.float32)


def _linspace(n: int, device) -> torch.Tensor:
    """n points from -1 to 1 in float32, rounded as ``jnp.linspace``
    computes them under ``jit`` (XLA multiplies by the reciprocal):
    -(1 - h) + h with h = i * (1/(n-1)), the last point exactly 1."""
    step = float(np.float32(1.0) / np.float32(n - 1))
    h = torch.arange(n - 1, device=device, dtype=torch.float32) * step
    return torch.cat([-(1.0 - h) + h,
                      torch.ones(1, device=device, dtype=torch.float32)])


def homography_warp_image(img: torch.Tensor, homography: torch.Tensor,
                          mode: str = "nearest") -> torch.Tensor:
    """Warp an image batch by per-image homographies.

    img (B, H, W, C); homography (B, 3, 3) in normalised coords.
    out[p] = img[H @ p] for destination pixel p (align-corners grid, zero
    outside the source).
    """
    B, H, W, C = img.shape
    gy, gx = torch.meshgrid(_linspace(H, img.device),
                            _linspace(W, img.device), indexing="ij")
    grid = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)  # (H, W, 3)
    src = torch.einsum("bdc,hwc->bhwd", homography.to(torch.float32), grid)
    src = src[..., :2] / src[..., 2:3]
    if mode == "nearest":
        return grid_sample_nearest(img, src)
    if mode == "bilinear":
        return grid_sample_bilinear(img, src)
    raise ValueError(f"unknown warp mode {mode}")


def warp_image_batch(img: torch.Tensor, homography: torch.Tensor,
                     mode: str = "nearest") -> torch.Tensor:
    return homography_warp_image(img, homography, mode)


def homography_to_pixel(H_norm: np.ndarray,
                        shape: Tuple[int, int]) -> np.ndarray:
    """Normalized sampling homography -> pixel point-transfer matrix.

    `homography_warp_image` uses image_aug(p) = image(H_norm @ p) in
    normalized align-corners coords, so a keypoint at pixel x in `image`
    lands at x' = (Ninv @ H_norm @ N)^-1 @ x in `image_aug`. The returned
    matrix is that point transfer — the HPatches H_1_N convention the
    evaluators expect (evaluation/detector.py warp_keypoints)."""
    h, w = shape
    N = np.array([[2.0 / (w - 1), 0.0, -1.0],
                  [0.0, 2.0 / (h - 1), -1.0],
                  [0.0, 0.0, 1.0]], np.float64)
    H_pix_sampling = np.linalg.inv(N) @ np.asarray(H_norm, np.float64) @ N
    H = np.linalg.inv(H_pix_sampling)
    return (H / H[2, 2]).astype(np.float32)
