"""Fused NetVLAD aggregation: per-pixel L2, soft assignment and softmax over
K, ``a^T x - (sum a) * centroids``, intra-normalisation, global L2, and its
gradient.

``netvlad`` launches ``csrc/netvlad.cu`` for CUDA tensors and runs
``netvlad_plain`` for CPU tensors. It replaces the TPU kernel
``nanovs_slam_tpu/ops/pallas/netvlad_kernel.py::netvlad_pallas``. Where a
gradient is needed (grad mode on and an input requiring it) the CUDA call
goes through an ``autograd.Function``: its forward launches the same kernel,
which then also writes each image's u = a^T x - (sum a) * centroids and
masses, and its backward launches ``netvlad_backward`` (x float32 or
bfloat16; at bfloat16 dx is bfloat16, with the roundings of autograd
through the twin: see ``csrc/netvlad.cu``). The JAX package has no
backward kernel: XLA differentiates its plain NetVLAD
(``nanovs_slam_tpu/modules/aggregators.py:40-80``). ``netvlad_backward_plain``
(autograd through ``netvlad_plain``) is the backward's twin.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..modules.blocks import l2_normalize
from . import _build
from .common import (FLOAT32_OR_BF16, check_contiguous, check_kernel_inputs,
                     check_nhwc_dense, device_of)

_P, _S, _I = ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong), ctypes.c_int
_ARGTYPES = [_P, _S] + [_P] * 7 + [_I] * 4 + [_P]
_BWD_ARGTYPES = [_P, _P, _S] + [_P] * 4 + [_P, _S] + [_P] * 3 + [_I] * 4 \
    + [_P]
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
    normalisation of ``modules/aggregators.NetVLAD``. A bfloat16 x is
    normalised in float32 and rounded to bfloat16, as the module normalises
    in its compute dtype; the rest is float32."""
    B, H, W, C = x.shape
    K = assign_w.shape[1]
    xf = l2_normalize(x.reshape(B, H * W, C).float(), dim=-1)
    if x.dtype == torch.bfloat16:
        xf = xf.to(torch.bfloat16).float()
    a = torch.softmax(torch.einsum("bsc,ck->bsk", xf, assign_w), dim=-1)
    weighted = torch.einsum("bsk,bsc->bkc", a, xf)
    vlad = weighted - a.sum(dim=1)[..., None] * centroids[None]
    vlad = l2_normalize(vlad, dim=-1).reshape(B, K * C)
    return l2_normalize(vlad, dim=-1)


def netvlad_backward_plain(gy: torch.Tensor, x: torch.Tensor,
                           assign_w: torch.Tensor, centroids: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """(dx, dW, dcen) of ``netvlad_plain`` for the upstream gradient gy
    (B, K*C), by autograd: the backward kernel's twin."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in
                  (x, assign_w, centroids)]
        y = netvlad_plain(*leaves)
        return torch.autograd.grad(y, leaves, gy)


def _check_shapes(name: str, x, assign_w, centroids) -> None:
    check_nhwc_dense(name, x=x)
    B, H, W, C = x.shape
    K = assign_w.shape[-1]
    if tuple(assign_w.shape) != (C, K) or tuple(centroids.shape) != (K, C):
        raise ValueError(f"{name}: shapes x {tuple(x.shape)}, assign_w "
                         f"{tuple(assign_w.shape)}, centroids "
                         f"{tuple(centroids.shape)}")


class _NetVLADFunction(torch.autograd.Function):
    """The kernel with its hand-written backward."""

    @staticmethod
    def forward(ctx, x, assign_w, centroids):
        y, residual, mass = _launch(x, assign_w, centroids, True)
        ctx.save_for_backward(x, assign_w, centroids, residual, mass)
        return y

    @staticmethod
    def backward(ctx, gy):
        return netvlad_backward(gy.contiguous(), *ctx.saved_tensors)


def netvlad(x: torch.Tensor, assign_w: torch.Tensor,
            centroids: torch.Tensor) -> torch.Tensor:
    """x (B,H,W,C) dense features (float32 or bfloat16), assign_w (C,K),
    centroids (K,C) float32 -> (B, K*C) float32 global descriptors.
    Differentiable: on CUDA through ``netvlad_backward``, at either x
    dtype."""
    name = "netvlad"
    _check_shapes(name, x, assign_w, centroids)
    dev = device_of(name, x, assign_w, centroids)
    if dev.type == "cpu":
        return netvlad_plain(x, assign_w, centroids)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, assign_w, centroids)):
        return _NetVLADFunction.apply(x, assign_w, centroids)
    return _launch(x, assign_w, centroids, False)


def _launch(x: torch.Tensor, assign_w: torch.Tensor,
            centroids: torch.Tensor, residuals: bool):
    """One launch of the forward kernel: y, and with ``residuals`` also
    u (B, K*C) and the masses (B, K) for the backward."""
    name = "netvlad"
    B, H, W, C = x.shape
    K = assign_w.shape[-1]
    dev = x.device
    check_kernel_inputs(name, {"x": FLOAT32_OR_BF16}, x=x,
                        assign_w=assign_w, centroids=centroids)
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
    residual = mass = None
    if residuals:
        residual = torch.empty((B, K * C), device=dev, dtype=torch.float32)
        mass = torch.empty((B, K), device=dev, dtype=torch.float32)
    # H and W are adjacent in both NHWC and NCHW memory: one pixel stride
    sx = (ctypes.c_longlong * 3)(x.stride(0), x.stride(2), x.stride(3))
    bf16 = x.dtype == torch.bfloat16
    fn = _build.bind("nvs_netvlad_bf16" if bf16 else "nvs_netvlad",
                     _ARGTYPES)
    err = fn(x.data_ptr(), sx, assign_w.data_ptr(), centroids.data_ptr(),
             partial.data_ptr(), counter.data_ptr(), out.data_ptr(),
             None if residual is None else residual.data_ptr(),
             None if mass is None else mass.data_ptr(), B, S, C, K, stream)
    _build.check(err, name)
    if bf16:
        netvlad.launches_bf16 += 1
    else:
        netvlad.launches += 1
    return (out, residual, mass) if residuals else out


def netvlad_residuals(x: torch.Tensor, assign_w: torch.Tensor,
                      centroids: torch.Tensor):
    """(y, u (B, K*C), masses (B, K)): the forward kernel's launch that
    also writes what ``netvlad_backward`` starts from (CUDA tensors)."""
    _check_shapes("netvlad", x, assign_w, centroids)
    if device_of("netvlad", x, assign_w, centroids).type != "cuda":
        raise ValueError("netvlad_residuals: the forward kernel's output, "
                         "for CUDA tensors")
    return _launch(x, assign_w, centroids, True)


def netvlad_backward(gy: torch.Tensor, x: torch.Tensor,
                     assign_w: torch.Tensor, centroids: torch.Tensor,
                     residual: torch.Tensor, mass: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, dW, dcen) of ``netvlad`` for the upstream gradient gy (B, K*C):
    the backward kernel for CUDA tensors (``residual`` and ``mass`` from
    ``netvlad_residuals``; dx has x's dtype and strides; a bfloat16 x
    launches the bf16 instance, counted in ``launches_bf16``), the twin
    ``netvlad_backward_plain`` for CPU tensors (which ignores them). gy,
    W, the centroids, dW and dcen are float32."""
    name = "netvlad_backward"
    _check_shapes(name, x, assign_w, centroids)
    B, H, W, C = x.shape
    K = assign_w.shape[-1]
    dev = device_of(name, gy, x, assign_w, centroids)
    if dev.type == "cpu":
        return netvlad_backward_plain(gy, x, assign_w, centroids)
    device_of(name, x, residual, mass)
    if tuple(gy.shape) != (B, K * C) or tuple(residual.shape) != (B, K * C) \
            or tuple(mass.shape) != (B, K):
        raise ValueError(f"{name}: gy {tuple(gy.shape)}, residual "
                         f"{tuple(residual.shape)}, mass "
                         f"{tuple(mass.shape)} for B={B}, K={K}, C={C}")
    check_kernel_inputs(name, {"x": FLOAT32_OR_BF16}, gy=gy, x=x,
                        assign_w=assign_w, centroids=centroids,
                        residual=residual, mass=mass)
    check_contiguous(name, gy=gy, assign_w=assign_w, centroids=centroids,
                     residual=residual, mass=mass)
    if K > MAX_CLUSTERS or C > MAX_CHANNELS or B > 65535:
        raise ValueError(f"{name}: the kernel takes K <= {MAX_CLUSTERS}, "
                         f"C <= {MAX_CHANNELS}, B <= 65535, got K={K}, "
                         f"C={C}, B={B}")
    S = H * W
    n = _build.bind("nvs_netvlad_backward_scratch_size", [_I] * 4)(B, S, C,
                                                                    K)
    scratch = torch.empty(n, device=dev, dtype=torch.float32)
    dx = torch.empty_like(x)
    dw = torch.empty_like(assign_w)
    dcen = torch.empty_like(centroids)
    sx = (ctypes.c_longlong * 3)(x.stride(0), x.stride(2), x.stride(3))
    sdx = (ctypes.c_longlong * 3)(dx.stride(0), dx.stride(2), dx.stride(3))
    bf16 = x.dtype == torch.bfloat16
    fn = _build.bind("nvs_netvlad_backward_bf16" if bf16
                     else "nvs_netvlad_backward", _BWD_ARGTYPES)
    err = fn(gy.data_ptr(), x.data_ptr(), sx, assign_w.data_ptr(),
             centroids.data_ptr(), residual.data_ptr(), mass.data_ptr(),
             dx.data_ptr(), sdx, scratch.data_ptr(), dw.data_ptr(),
             dcen.data_ptr(), B, S, C, K, _build.stream_ptr(dev))
    _build.check(err, name)
    if bf16:
        netvlad_backward.launches_bf16 += 1
    else:
        netvlad_backward.launches += 1
    return dx, dw, dcen


netvlad.launches = 0
netvlad.launches_bf16 = 0
netvlad_backward.launches = 0
netvlad_backward.launches_bf16 = 0
