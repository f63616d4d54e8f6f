"""NetVLAD global-descriptor aggregation, the counterpart of ``NetVLAD`` in
``nanovs_slam_tpu/modules/aggregators.py``.

L2-normalise each pixel across channels, soft-assign with a 1x1 conv and a
softmax over K clusters, sum the assignment-weighted residuals to the
centroids over space as ``a^T x - (sum a) * centroids``, intra-normalise per
cluster, flatten, L2. The forward is the NetVLAD kernel's wrapper: the CUDA
kernel for CUDA tensors, its plain twin for CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from ..kernels.netvlad import netvlad


class NetVLAD(nn.Module):
    def __init__(self, num_clusters: int = 64, dim: int = 128):
        super().__init__()
        self.num_clusters = num_clusters
        self.dim = dim
        self.assign_w = nn.Parameter(torch.empty(dim, num_clusters))
        self.centroids = nn.Parameter(torch.empty(num_clusters, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, C, H, W) dense features -> (B, K*C) global descriptor."""
        if x.shape[1] != self.dim:
            raise ValueError(f"NetVLAD: {x.shape[1]} channels, expected "
                             f"{self.dim}")
        return netvlad(x.permute(0, 2, 3, 1), self.assign_w, self.centroids)

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
