"""Fused NetVLAD aggregation: per-pixel L2, soft assignment and softmax over
K, ``a^T x - (sum a) * centroids``, intra-normalisation, global L2.

``netvlad`` launches ``csrc/netvlad.cu`` for CUDA tensors and runs
``netvlad_plain`` for CPU tensors. It replaces the TPU kernel
``nanovs_slam_tpu/ops/pallas/netvlad_kernel.py::netvlad_pallas``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..modules.blocks import l2_normalize
from . import _build
from .common import (check_contiguous, check_kernel_inputs, check_nhwc_dense,
                     device_of)

_P, _S, _I = ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong), ctypes.c_int
_ARGTYPES = [_P, _S] + [_P] * 5 + [_I] * 4 + [_P]
MAX_CLUSTERS = 64
MAX_CHANNELS = 128

# (device index, stream) -> (partials, counters): reused by every launch on
# that stream, which leaves the counters at zero; grown when a call needs
# more
_scratch: dict = {}


def _scratch_for(dev: torch.device, stream: int, n_partial: int,
                 B: int) -> Tuple[torch.Tensor, torch.Tensor]:
    key = (dev.index, stream)
    part, cnt = _scratch.get(key, (None, None))
    if part is None or part.numel() < n_partial:
        part = torch.empty(n_partial, device=dev, dtype=torch.float32)
    if cnt is None or cnt.numel() < B:
        cnt = torch.zeros(B, device=dev, dtype=torch.int32)
    _scratch[key] = (part, cnt)
    return part, cnt


def netvlad_plain(x: torch.Tensor, assign_w: torch.Tensor,
                  centroids: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch (einsum chain), with the
    normalisation of ``modules/aggregators.NetVLAD``."""
    B, H, W, C = x.shape
    K = assign_w.shape[1]
    xf = l2_normalize(x.reshape(B, H * W, C).float(), dim=-1)
    a = torch.softmax(torch.einsum("bsc,ck->bsk", xf, assign_w), dim=-1)
    weighted = torch.einsum("bsk,bsc->bkc", a, xf)
    vlad = weighted - a.sum(dim=1)[..., None] * centroids[None]
    vlad = l2_normalize(vlad, dim=-1).reshape(B, K * C)
    return l2_normalize(vlad, dim=-1)


def netvlad(x: torch.Tensor, assign_w: torch.Tensor,
            centroids: torch.Tensor) -> torch.Tensor:
    """x (B,H,W,C) dense features, assign_w (C,K), centroids (K,C) ->
    (B, K*C) float32 global descriptors."""
    name = "netvlad"
    check_nhwc_dense(name, x=x)
    B, H, W, C = x.shape
    K = assign_w.shape[-1]
    if tuple(assign_w.shape) != (C, K) or tuple(centroids.shape) != (K, C):
        raise ValueError(f"{name}: shapes x {tuple(x.shape)}, assign_w "
                         f"{tuple(assign_w.shape)}, centroids "
                         f"{tuple(centroids.shape)}")
    dev = device_of(name, x, assign_w, centroids)
    if dev.type == "cpu":
        return netvlad_plain(x, assign_w, centroids)
    check_kernel_inputs(name, x=x, assign_w=assign_w, centroids=centroids)
    check_contiguous(name, assign_w=assign_w, centroids=centroids)
    if K > MAX_CLUSTERS or C > MAX_CHANNELS:
        raise ValueError(f"{name}: the kernel takes K <= {MAX_CLUSTERS} and "
                         f"C <= {MAX_CHANNELS}, got K={K}, C={C}")
    if B > 65535:
        raise ValueError(f"{name}: batch {B} > 65535")
    S = H * W
    per_image = _build.bind("nvs_netvlad_partial_size", [_I] * 3)(S, C, K)
    stream = _build.stream_ptr(dev)
    partial, counter = _scratch_for(dev, stream.value, B * per_image, B)
    out = torch.empty((B, K * C), device=dev, dtype=torch.float32)
    # H and W are adjacent in both NHWC and NCHW memory: one pixel stride
    sx = (ctypes.c_longlong * 3)(x.stride(0), x.stride(2), x.stride(3))
    fn = _build.bind("nvs_netvlad", _ARGTYPES)
    err = fn(x.data_ptr(), sx, assign_w.data_ptr(), centroids.data_ptr(),
             partial.data_ptr(), counter.data_ptr(), out.data_ptr(), B, S, C,
             K, stream)
    _build.check(err, name)
    netvlad.launches += 1
    return out


netvlad.launches = 0
