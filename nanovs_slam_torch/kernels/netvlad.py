"""Fused NetVLAD aggregation: per-pixel L2, soft assignment (with the
vladv2 bias where one is given) and softmax over K, ``a^T x - (sum a) *
centroids``, intra-normalisation, global L2, and its gradient.

``netvlad`` launches ``csrc/netvlad.cu`` for CUDA tensors and runs
``netvlad_plain`` for CPU tensors. It replaces the TPU kernel
``nanovs_slam_tpu/ops/pallas/netvlad_kernel.py::netvlad_pallas``. Where a
gradient is needed (grad mode on and an input requiring it) the CUDA call
goes through an ``autograd.Function``: its forward launches the same kernel,
which then also writes each image's u = a^T x - (sum a) * centroids and
masses, and its backward launches ``netvlad_backward`` (x float32 or
bfloat16; at bfloat16 dx is bfloat16, with the roundings of autograd
through the twin: see ``csrc/netvlad.cu``; with a bias also its gradient
db). Both kernels take C <= 256 and K <= 64; above C = 128 each runs in a
kernel of its own (``netvlad_wide_kernel``, ``netvlad_bwd_wide``: clusters
of blocks splitting C; ``wide_launch_shape`` reads their launch). The JAX
package has no backward kernel: XLA differentiates its plain NetVLAD
(``nanovs_slam_tpu/modules/aggregators.py:40-80``). ``netvlad_backward_plain``
(autograd through ``netvlad_plain``) is the backward's twin.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..modules.blocks import l2_normalize
from . import _build
from .common import (FLOAT32_OR_BF16, check_contiguous, check_kernel_inputs,
                     check_nhwc_dense, device_of)

_P, _S, _I = ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong), ctypes.c_int
_ARGTYPES = [_P, _S] + [_P] * 8 + [_I] * 4 + [_P]
_BWD_ARGTYPES = [_P, _P, _S] + [_P] * 5 + [_P, _S] + [_P] * 4 + [_I] * 4 \
    + [_P]
MAX_CLUSTERS = 64
MAX_CHANNELS = 256

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
                  centroids: torch.Tensor,
                  assign_b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch (einsum chain), with the
    normalisation of ``modules/aggregators.NetVLAD`` and, where given, the
    vladv2 bias added to the logits. A bfloat16 x is normalised in float32
    and rounded to bfloat16, as the module normalises in its compute dtype;
    the rest is float32."""
    B, H, W, C = x.shape
    K = assign_w.shape[1]
    xf = l2_normalize(x.reshape(B, H * W, C).float(), dim=-1)
    if x.dtype == torch.bfloat16:
        xf = xf.to(torch.bfloat16).float()
    logits = torch.einsum("bsc,ck->bsk", xf, assign_w)
    if assign_b is not None:
        logits = logits + assign_b
    a = torch.softmax(logits, dim=-1)
    weighted = torch.einsum("bsk,bsc->bkc", a, xf)
    vlad = weighted - a.sum(dim=1)[..., None] * centroids[None]
    vlad = l2_normalize(vlad, dim=-1).reshape(B, K * C)
    return l2_normalize(vlad, dim=-1)


def netvlad_backward_plain(gy: torch.Tensor, x: torch.Tensor,
                           assign_w: torch.Tensor, centroids: torch.Tensor,
                           assign_b: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, ...]:
    """(dx, dW, dcen), and db after them where ``assign_b`` is given, of
    ``netvlad_plain`` for the upstream gradient gy (B, K*C), by autograd:
    the backward kernel's twin."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in
                  (x, assign_w, centroids)
                  + (() if assign_b is None else (assign_b,))]
        y = netvlad_plain(*leaves)
        return torch.autograd.grad(y, leaves, gy)


def _check_shapes(name: str, x, assign_w, centroids, assign_b=None) -> None:
    check_nhwc_dense(name, x=x)
    B, H, W, C = x.shape
    K = assign_w.shape[-1]
    if tuple(assign_w.shape) != (C, K) or tuple(centroids.shape) != (K, C) \
            or (assign_b is not None and tuple(assign_b.shape) != (K,)):
        bias = None if assign_b is None else tuple(assign_b.shape)
        raise ValueError(f"{name}: shapes x {tuple(x.shape)}, assign_w "
                         f"{tuple(assign_w.shape)}, centroids "
                         f"{tuple(centroids.shape)}, assign_b {bias}")


def _tensors(*ts):
    return tuple(t for t in ts if t is not None)


class _NetVLADFunction(torch.autograd.Function):
    """The kernel with its hand-written backward."""

    @staticmethod
    def forward(ctx, x, assign_w, centroids, assign_b):
        y, residual, mass = _launch(x, assign_w, centroids, assign_b, True)
        ctx.has_bias = assign_b is not None
        ctx.save_for_backward(x, assign_w, centroids, residual, mass,
                              *_tensors(assign_b))
        return y

    @staticmethod
    def backward(ctx, gy):
        x, w, cen, residual, mass, *b = ctx.saved_tensors
        grads = netvlad_backward(gy.contiguous(), x, w, cen, residual, mass,
                                 b[0] if ctx.has_bias else None)
        return grads if ctx.has_bias else grads + (None,)


def netvlad(x: torch.Tensor, assign_w: torch.Tensor,
            centroids: torch.Tensor,
            assign_b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (B,H,W,C) dense features (float32 or bfloat16), assign_w (C,K),
    centroids (K,C) and the optional vladv2 bias assign_b (K,) float32 ->
    (B, K*C) float32 global descriptors. Differentiable: on CUDA through
    ``netvlad_backward``, at either x dtype."""
    name = "netvlad"
    _check_shapes(name, x, assign_w, centroids, assign_b)
    dev = device_of(name, x, assign_w, centroids,
                    *_tensors(assign_b))
    if dev.type == "cpu":
        return netvlad_plain(x, assign_w, centroids, assign_b)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in _tensors(x, assign_w, centroids,
                                              assign_b)):
        return _NetVLADFunction.apply(x, assign_w, centroids, assign_b)
    return _launch(x, assign_w, centroids, assign_b, False)


def _launch(x: torch.Tensor, assign_w: torch.Tensor,
            centroids: torch.Tensor, assign_b: Optional[torch.Tensor],
            residuals: bool):
    """One launch of the forward kernel: y, and with ``residuals`` also
    u (B, K*C) and the masses (B, K) for the backward."""
    name = "netvlad"
    B, H, W, C = x.shape
    K = assign_w.shape[-1]
    dev = x.device
    bias = {} if assign_b is None else {"assign_b": assign_b}
    check_kernel_inputs(name, {"x": FLOAT32_OR_BF16}, x=x,
                        assign_w=assign_w, centroids=centroids, **bias)
    check_contiguous(name, assign_w=assign_w, centroids=centroids, **bias)
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
    err = fn(x.data_ptr(), sx, assign_w.data_ptr(),
             None if assign_b is None else assign_b.data_ptr(),
             centroids.data_ptr(), partial.data_ptr(), counter.data_ptr(),
             out.data_ptr(),
             None if residual is None else residual.data_ptr(),
             None if mass is None else mass.data_ptr(), B, S, C, K, stream)
    _build.check(err, name)
    if bf16:
        netvlad.launches_bf16 += 1
    else:
        netvlad.launches += 1
    return (out, residual, mass) if residuals else out


def netvlad_residuals(x: torch.Tensor, assign_w: torch.Tensor,
                      centroids: torch.Tensor,
                      assign_b: Optional[torch.Tensor] = None):
    """(y, u (B, K*C), masses (B, K)): the forward kernel's launch that
    also writes what ``netvlad_backward`` starts from (CUDA tensors)."""
    _check_shapes("netvlad", x, assign_w, centroids, assign_b)
    if device_of("netvlad", x, assign_w, centroids,
                 *_tensors(assign_b)).type != "cuda":
        raise ValueError("netvlad_residuals: the forward kernel's output, "
                         "for CUDA tensors")
    return _launch(x, assign_w, centroids, assign_b, True)


def netvlad_backward(gy: torch.Tensor, x: torch.Tensor,
                     assign_w: torch.Tensor, centroids: torch.Tensor,
                     residual: torch.Tensor, mass: torch.Tensor,
                     assign_b: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, ...]:
    """(dx, dW, dcen), and db after them where ``assign_b`` is given, of
    ``netvlad`` for the upstream gradient gy (B, K*C): the backward kernel
    for CUDA tensors (``residual`` and ``mass`` from ``netvlad_residuals``
    with the same bias; dx has x's dtype and strides; a bfloat16 x launches
    the bf16 instance, counted in ``launches_bf16``), the twin
    ``netvlad_backward_plain`` for CPU tensors (which ignores them). gy,
    W, the centroids, the bias and their gradients are float32."""
    name = "netvlad_backward"
    _check_shapes(name, x, assign_w, centroids, assign_b)
    B, H, W, C = x.shape
    K = assign_w.shape[-1]
    dev = device_of(name, gy, x, assign_w, centroids, *_tensors(assign_b))
    if dev.type == "cpu":
        return netvlad_backward_plain(gy, x, assign_w, centroids, assign_b)
    device_of(name, x, residual, mass)
    if tuple(gy.shape) != (B, K * C) or tuple(residual.shape) != (B, K * C) \
            or tuple(mass.shape) != (B, K):
        raise ValueError(f"{name}: gy {tuple(gy.shape)}, residual "
                         f"{tuple(residual.shape)}, mass "
                         f"{tuple(mass.shape)} for B={B}, K={K}, C={C}")
    bias = {} if assign_b is None else {"assign_b": assign_b}
    check_kernel_inputs(name, {"x": FLOAT32_OR_BF16}, gy=gy, x=x,
                        assign_w=assign_w, centroids=centroids,
                        residual=residual, mass=mass, **bias)
    check_contiguous(name, gy=gy, assign_w=assign_w, centroids=centroids,
                     residual=residual, mass=mass, **bias)
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
    db = None if assign_b is None else torch.empty_like(assign_b)
    sx = (ctypes.c_longlong * 3)(x.stride(0), x.stride(2), x.stride(3))
    sdx = (ctypes.c_longlong * 3)(dx.stride(0), dx.stride(2), dx.stride(3))
    bf16 = x.dtype == torch.bfloat16
    fn = _build.bind("nvs_netvlad_backward_bf16" if bf16
                     else "nvs_netvlad_backward", _BWD_ARGTYPES)
    err = fn(gy.data_ptr(), x.data_ptr(), sx, assign_w.data_ptr(),
             None if assign_b is None else assign_b.data_ptr(),
             centroids.data_ptr(), residual.data_ptr(), mass.data_ptr(),
             dx.data_ptr(), sdx, scratch.data_ptr(), dw.data_ptr(),
             dcen.data_ptr(), None if db is None else db.data_ptr(), B, S,
             C, K, _build.stream_ptr(dev))
    _build.check(err, name)
    if bf16:
        netvlad_backward.launches_bf16 += 1
    else:
        netvlad_backward.launches += 1
    return (dx, dw, dcen) if db is None else (dx, dw, dcen, db)


_SHAPE_KEYS = ("blocks", "cluster", "threads", "smem_bytes", "blocks_per_sm",
               "sms", "registers", "local_bytes", "resident_clusters")


def wide_launch_shape(B: int, S: int, bf16: bool = False,
                      backward: bool = False) -> dict:
    """The launch a call at 128 < C <= 256 makes on the current card for a
    batch of B images of S pixels (``backward``: the backward's tiles, whose
    reduction follows as a second launch): blocks, blocks a cluster,
    threads and dynamic shared bytes a block, blocks an SM (-1 where the
    occupancy calculator refuses a cluster kernel), the card's SMs, the
    SMs the grid covers, registers and local bytes a thread, and for the
    forward the clusters the card holds at once (the occupancy
    calculator's, which sizes its grid). Nothing is launched."""
    shape = (ctypes.c_int * len(_SHAPE_KEYS))()
    fn = _build.bind("nvs_netvlad_wide_shape", [_I] * 4 + [_P])
    _build.check(fn(int(backward), int(bf16), B, S, shape),
                 "netvlad_backward" if backward else "netvlad")
    out = dict(zip(_SHAPE_KEYS, shape))
    out["sms_covered"] = min(out["sms"], out["blocks"])
    return out


netvlad.launches = 0
netvlad.launches_bf16 = 0
netvlad_backward.launches = 0
netvlad_backward.launches_bf16 = 0
