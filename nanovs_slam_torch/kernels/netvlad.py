"""Fused NetVLAD aggregation: per-pixel L2, soft assignment and softmax over
K, ``a^T x - (sum a) * centroids``, intra-normalisation, global L2.

``netvlad`` launches ``csrc/netvlad.cu`` for CUDA tensors and runs
``netvlad_plain`` for CPU tensors. It replaces the TPU kernel
``nanovs_slam_tpu/ops/pallas/netvlad_kernel.py::netvlad_pallas``.
"""

from __future__ import annotations

import ctypes

import torch

from ..modules.blocks import l2_normalize
from . import _build
from .common import (check_contiguous, check_kernel_inputs, check_nhwc_dense,
                     device_of)

_P, _S, _I = ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong), ctypes.c_int
_ARGTYPES = [_P, _S] + [_P] * 4 + [_I] * 5 + [_P]
MAX_CLUSTERS = 64
PIXELS_PER_BLOCK = 256


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
    if K > MAX_CLUSTERS:
        raise ValueError(f"{name}: K={K} > {MAX_CLUSTERS}")
    S = H * W
    P = -(-S // PIXELS_PER_BLOCK)
    partial = torch.empty((B, P, K * C + K), device=dev, dtype=torch.float32)
    out = torch.empty((B, K * C), device=dev, dtype=torch.float32)
    # H and W are adjacent in both NHWC and NCHW memory: one pixel stride
    sx = (ctypes.c_longlong * 3)(x.stride(0), x.stride(2), x.stride(3))
    fn = _build.bind("nvs_netvlad", _ARGTYPES)
    err = fn(x.data_ptr(), sx, assign_w.data_ptr(), centroids.data_ptr(),
             partial.data_ptr(), out.data_ptr(), B, S, C, K, P,
             _build.stream_ptr(dev))
    _build.check(err, name)
    netvlad.launches += 1
    return out


netvlad.launches = 0
