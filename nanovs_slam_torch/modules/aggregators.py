"""Global-descriptor aggregators (NCHW), the counterparts of
``nanovs_slam_tpu/modules/aggregators.py``.

NetVLAD: L2-normalise each pixel across channels, soft-assign with a 1x1
conv and a softmax over K clusters, sum the assignment-weighted residuals
to the centroids over space as ``a^T x - (sum a) * centroids``,
intra-normalise per cluster, flatten, L2. ``vladv2=True`` (KeypointFormer's
head) adds a learned bias ``assign_b`` (K,) to the assignment logits,
zeros at init, as the JAX module's ``assign_b``. The forward is the NetVLAD
kernel's wrapper: the CUDA kernel for CUDA tensors, its plain twin for CPU
tensors; in training its gradient is the ``netvlad_backward`` kernel on
CUDA, autograd through the twin on the CPU.

GeM: pixel-unshuffle by 4, ``clamp(min=eps) ** p``, mean over space,
``** (1/p)``, with ``p`` a learned (1,) parameter (3 at init); the channel
order is ``nn.PixelUnshuffle``'s, which the JAX package's NHWC
``pixel_unshuffle`` mirrors.

ConvAP: a 1x1 ``channel_pool`` conv with bias, adaptive average pooling to
(s1, s2) bins (``F.adaptive_avg_pool2d``: bin i averages rows
[floor(i H/s1), ceil((i+1) H/s1)), the JAX package's rule), flatten in
(C, s1, s2) order, L2.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..kernels.netvlad import netvlad
from .blocks import Conv2d, l2_normalize


class NetVLAD(nn.Module):
    def __init__(self, num_clusters: int = 64, dim: int = 128,
                 vladv2: bool = False):
        super().__init__()
        self.num_clusters = num_clusters
        self.dim = dim
        self.assign_w = nn.Parameter(torch.empty(dim, num_clusters))
        self.centroids = nn.Parameter(torch.empty(num_clusters, dim))
        self.assign_b = nn.Parameter(torch.zeros(num_clusters)) \
            if vladv2 else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, C, H, W) dense features -> (B, K*C) global descriptor."""
        if x.shape[1] != self.dim:
            raise ValueError(f"NetVLAD: {x.shape[1]} channels, expected "
                             f"{self.dim}")
        return netvlad(x.permute(0, 2, 3, 1), self.assign_w, self.centroids,
                       self.assign_b)

    @staticmethod
    def init_params_from_clusters(clsts: np.ndarray, traindescs: np.ndarray):
        """(assign_w (C, K), centroids (K, C)) from k-means clusters
        ``clsts`` (K, C) and training descriptors (M, C), vladv1 style:
        alpha = -log(0.01) / mean(top1 - top2 cluster dots)."""
        clsts_assign = clsts / np.linalg.norm(clsts, axis=1, keepdims=True)
        dots = clsts_assign @ traindescs.T  # (K, M)
        dots = -np.sort(-dots, axis=0)  # descending per column
        alpha = (-np.log(0.01) / np.mean(dots[0, :] - dots[1, :])).item()
        assign_w = (alpha * clsts_assign).T.astype(np.float32)  # (C, K)
        return assign_w, clsts.astype(np.float32)


class GeM(nn.Module):
    def __init__(self, eps: float = 1e-6, unshuffle: int = 4):
        super().__init__()
        self.eps = eps
        self.unshuffle = unshuffle
        self.p = nn.Parameter(torch.full((1,), 3.0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, C, H, W) -> (B, C * unshuffle**2)."""
        if self.unshuffle > 1:
            x = F.pixel_unshuffle(x, self.unshuffle)
        x = x.clamp(min=self.eps).pow(self.p).mean(dim=(2, 3))
        return x.pow(1.0 / self.p)


class ConvAP(nn.Module):
    def __init__(self, c_in: int, out_channels: int = 512, s1: int = 2,
                 s2: int = 2):
        super().__init__()
        self.bins = (s1, s2)
        self.channel_pool = Conv2d(c_in, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, C, H, W) -> (B, out_channels * s1 * s2)."""
        x = F.adaptive_avg_pool2d(self.channel_pool(x), self.bins)
        return l2_normalize(x.flatten(1), dim=-1)
