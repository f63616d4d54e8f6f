"""Fused backbone stem: conv3x3 + bias, LeakyReLU, conv3x3 + bias,
LeakyReLU, 2x2 max-pool, with BatchNorm folded into the biases.

``fused_stem_pair_pool`` launches ``csrc/stem.cu`` for CUDA tensors and runs
``stem_plain`` for CPU tensors. It replaces the TPU kernel
``nanovs_slam_tpu/ops/pallas/fused_stem.py::fused_stem_pair_pool``. A
bfloat16 x selects the bfloat16 instances: x and the weights rounded to
bfloat16, float32 sums, conv1's activation and the output rounded to
bfloat16.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build
from .common import (FLOAT32_OR_BF16, check_contiguous, check_kernel_inputs,
                     check_nhwc_dense, device_of)

_P, _S, _I = ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong), ctypes.c_int
_ARGTYPES = [_P, _S] + [_P] * 6 + [_I] * 5 + [ctypes.c_float, _P]
# (C1, C2) pairs the kernel is instantiated for: configs N (16, 24), S/F
# (16, 32) and D (64, 128)
SUPPORTED = ((16, 24), (16, 32), (64, 128))
# the instances that read conv2's weights from a copy that a kernel of
# their own packs into scratch at each call, in the layout of Hopper's
# warpgroup products (wgmma)
_WIDE = ((64, 128),)


def stem_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
               w2: torch.Tensor, b2: torch.Tensor,
               negative_slope: float = 0.01) -> torch.Tensor:
    """The kernel's function in plain PyTorch (two ``F.conv2d``). For a
    bfloat16 x, float32 convolutions of bfloat16-rounded operands (their
    products are exact in float32) with the bfloat16 instance's rounding
    points."""
    if x.dtype == torch.bfloat16:
        def r(t):
            return t.to(torch.bfloat16).float()

        y = F.conv2d(x.permute(0, 3, 1, 2).float(), r(w1), b1, padding=1)
        y = r(F.leaky_relu(y, negative_slope))
        y = F.leaky_relu(F.conv2d(y, r(w2), b2, padding=1), negative_slope)
        return F.max_pool2d(y, 2, 2).to(torch.bfloat16).permute(0, 2, 3, 1)
    y = F.conv2d(x.permute(0, 3, 1, 2), w1, b1, padding=1)
    y = F.leaky_relu(y, negative_slope)
    y = F.leaky_relu(F.conv2d(y, w2, b2, padding=1), negative_slope)
    return F.max_pool2d(y, 2, 2).permute(0, 2, 3, 1)


def fused_stem_pair_pool(x: torch.Tensor, w1: torch.Tensor,
                         b1: torch.Tensor, w2: torch.Tensor,
                         b2: torch.Tensor, negative_slope: float = 0.01
                         ) -> torch.Tensor:
    """x (B,H,W,3) NHWC with H, W >= 2, float32 or bfloat16; w1 (C1,3,3,3)
    and w2 (C2,C1,3,3) OIHW conv weights with BN folded in, b1 (C1,), b2
    (C2,), all float32; ``negative_slope`` 0.01 (LeakyReLU) or 0 (ReLU) ->
    (B,H//2,W//2,C2) NHWC in x's dtype (for the kernel, a view of NCHW
    memory).
    An odd H or W pools with floor, as ``F.max_pool2d`` and flax's VALID
    ``max_pool`` do; the convolutions' SAME padding is taken against the
    full frame, so the last pooled row still sees input row H-1.
    The kernel has no backward: a CUDA call in grad mode with any of x,
    w1, b1, w2, b2 requiring grad raises (``check_kernel_inputs``), so a
    gradient is never cut silently; ``modules/backbone.stem_kernel_allowed``
    keeps such calls on the plain chain."""
    name = "fused_stem_pair_pool"
    check_nhwc_dense(name, x=x)
    B, H, W, c0 = x.shape
    C1, C2 = w1.shape[0], w2.shape[0]
    if (c0 != 3 or tuple(w1.shape) != (C1, 3, 3, 3)
            or tuple(w2.shape) != (C2, C1, 3, 3) or tuple(b1.shape) != (C1,)
            or tuple(b2.shape) != (C2,)):
        raise ValueError(f"{name}: shapes x {tuple(x.shape)}, w1 "
                         f"{tuple(w1.shape)}, w2 {tuple(w2.shape)}")
    if H < 2 or W < 2:
        raise ValueError(f"{name}: H={H}, W={W} must be at least 2")
    dev = device_of(name, x, w1, b1, w2, b2)
    if dev.type == "cpu":
        return stem_plain(x, w1, b1, w2, b2, negative_slope)
    check_kernel_inputs(name, {"x": FLOAT32_OR_BF16}, x=x, w1=w1, b1=b1,
                        w2=w2, b2=b2)
    check_contiguous(name, w1=w1, b1=b1, w2=w2, b2=b2)
    if (C1, C2) not in SUPPORTED:
        raise ValueError(f"{name}: (C1, C2)={(C1, C2)} not in {SUPPORTED}")
    bf16 = x.dtype == torch.bfloat16
    out = torch.empty((B, C2, H // 2, W // 2), device=dev, dtype=x.dtype)
    scratch = None
    if (C1, C2) in _WIDE:  # conv2's weights in bf16, or float32 split into
        # TF32 hi and lo; conv1's as mma.sync fragments
        n = 9 * C1 * C2 // 2 + 16 * C1 if bf16 else 2 * 9 * C1 * C2 + 64 * C1
        scratch = torch.empty(n, device=dev, dtype=torch.float32)
    fn = _build.bind("nvs_stem_pair_pool_bf16" if bf16
                     else "nvs_stem_pair_pool", _ARGTYPES)
    err = fn(x.data_ptr(), _build.strides(x), w1.data_ptr(), b1.data_ptr(),
             w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
             None if scratch is None else scratch.data_ptr(), B, H, W, C1,
             C2, negative_slope, _build.stream_ptr(dev))
    _build.check(err, name)
    if bf16:
        fused_stem_pair_pool.launches_bf16 += 1
    else:
        fused_stem_pair_pool.launches += 1
    return out.permute(0, 2, 3, 1)


fused_stem_pair_pool.launches = 0
fused_stem_pair_pool.launches_bf16 = 0
