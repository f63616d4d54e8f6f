"""Pinhole camera model, the counterpart of ``nanovs_slam_tpu/vo/camera.py``
(reference: src/visual_odometry/camera.py:32-253).

``PinholeCamera`` is numpy (the host pose tail); it undistorts through
cv2 only for a distorted camera. ``PinholeCameraDevice`` is its torch twin
on a device, without distortion.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device


def add_ones(pts: np.ndarray) -> np.ndarray:
    return np.concatenate([pts, np.ones((pts.shape[0], 1))], axis=1)


class PinholeCamera:
    def __init__(self, width, height, fx, fy, cx, cy, D=None, fps=1):
        self.width, self.height = width, height
        self.fx, self.fy, self.cx, self.cy = fx, fy, cx, cy
        self.D = np.array(D if D is not None else [0, 0, 0, 0, 0],
                          dtype=np.float64)
        self.fps = fps
        self.is_distorted = np.linalg.norm(self.D) > 1e-10
        self.K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)
        self.Kinv = np.array([[1 / fx, 0, -cx / fx],
                              [0, 1 / fy, -cy / fy], [0, 0, 1]], np.float64)
        self.u_min, self.u_max = 0, width
        self.v_min, self.v_max = 0, height
        self._update_bounds()

    def project(self, xcs: np.ndarray):
        projs = self.K @ xcs.T
        zs = projs[-1]
        projs = projs[:2] / zs
        return projs.T, zs

    def unproject_points(self, uvs: np.ndarray) -> np.ndarray:
        """(N, 2) pixels -> (N, 2) normalized image-plane coords."""
        return (self.Kinv @ add_ones(uvs).T).T[:, 0:2]

    def undistort_points(self, uvs: np.ndarray) -> np.ndarray:
        if not self.is_distorted:
            return uvs
        import cv2

        uvs_c = np.ascontiguousarray(uvs[:, :2]).reshape(-1, 1, 2)
        und = cv2.undistortPoints(uvs_c, self.K, self.D, None, self.K)
        return und.reshape(-1, 2)

    def _update_bounds(self):
        uv = np.array([[self.u_min, self.v_min], [self.u_min, self.v_max],
                       [self.u_max, self.v_min], [self.u_max, self.v_max]],
                      np.float32).reshape(4, 2)
        if self.is_distorted:
            uv = self.undistort_points(uv)
        self.u_min = min(uv[0][0], uv[1][0])
        self.u_max = max(uv[2][0], uv[3][0])
        self.v_min = min(uv[0][1], uv[2][1])
        self.v_max = max(uv[1][1], uv[3][1])

    def is_in_image(self, uv, z) -> bool:
        return bool((uv[0] > self.u_min) and (uv[0] < self.u_max)
                    and (uv[1] > self.v_min) and (uv[1] < self.v_max)
                    and (z > 0))


def kitti_params():
    """KITTI grayscale cam intrinsics (fx, fy, cx, cy) used by the
    reference VO eval (evaluation/visual_odometry.py:66-71)."""
    return 718.856, 718.856, 607.1928, 185.2157


class PinholeCameraDevice:
    """The camera as float32 torch tensors on ``device`` (default "cuda";
    a CUDA device without a card raises): batched project / unproject /
    in-image tests. Distortion is not modelled: undistort on the host
    first, as the reference's torch camera does (:203-210)."""

    def __init__(self, width, height, fx, fy, cx, cy, device=None):
        dev = resolve_device(device)
        self.width, self.height = width, height
        self.fx, self.fy, self.cx, self.cy = fx, fy, cx, cy
        self.K = torch.tensor([[fx, 0, cx], [0, fy, cy], [0, 0, 1]],
                              dtype=torch.float32, device=dev)
        self.Kinv = torch.tensor([[1 / fx, 0, -cx / fx],
                                  [0, 1 / fy, -cy / fy], [0, 0, 1]],
                                 dtype=torch.float32, device=dev)

    def project(self, xcs: torch.Tensor):
        """(..., N, 3) camera-frame points -> ((..., N, 2) pixels, depths)."""
        projs = torch.einsum("ij,...nj->...ni", self.K, xcs)
        zs = projs[..., 2]
        return projs[..., :2] / zs[..., None], zs

    def unproject_points(self, uvs: torch.Tensor) -> torch.Tensor:
        """(..., N, 2) pixels -> normalized image-plane coords."""
        homo = torch.cat([uvs, torch.ones_like(uvs[..., :1])], dim=-1)
        return torch.einsum("ij,...nj->...ni", self.Kinv, homo)[..., :2]

    def are_in_image(self, uvs: torch.Tensor, zs: torch.Tensor
                     ) -> torch.Tensor:
        """(camera.py:244-253) batched visibility mask."""
        return ((uvs[..., 0] > 0) & (uvs[..., 0] < self.width)
                & (uvs[..., 1] > 0) & (uvs[..., 1] < self.height)
                & (zs > 0))
