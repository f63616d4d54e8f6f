"""Fused inference postprocess: border mask, coordinate decode, bilinear
descriptor sampling and L2 normalisation for every cell.

``fused_postprocess`` launches ``csrc/postprocess.cu`` for CUDA tensors
and runs ``postprocess_plain`` for CPU tensors. It replaces the TPU kernel
``nanovs_slam_tpu/ops/pallas/postprocess_kernel.py::fused_postprocess_pallas``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..ops.grid import decode_coords, remove_border
from ..ops.grid_sample import sample_descriptors
from . import _build
from .common import (FLOAT32_OR_BF16, check_kernel_inputs, check_nhwc_dense,
                     device_of)

_P, _S, _I = ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong), ctypes.c_int
_ARGTYPES = ([_P, _S] * 3 + [_P] * 3 + [_I] * 9
             + [ctypes.c_float, _P])
MAX_CHANNELS = 256


def postprocess_plain(score: torch.Tensor, shift: torch.Tensor,
                      feat: torch.Tensor, H: int, W: int, cell: int,
                      cross_ratio: float = 2.0
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch (``F.grid_sample``), in
    float32 whatever the inputs' float type, as the kernel computes."""
    coord = decode_coords(shift.float(), H, W, cell, cross_ratio)
    desc = sample_descriptors(feat.float(), coord, H, W)
    return remove_border(score.float()), coord, desc


def fused_postprocess(score: torch.Tensor, shift: torch.Tensor,
                      feat: torch.Tensor, H: int, W: int, cell: int,
                      cross_ratio: float = 2.0
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """score (B,Hc,Wc,1) sigmoid scores, shift (B,Hc,Wc,2) tanh shifts,
    feat (B,Hf,Wf,C) dense descriptors, all float32 or all bfloat16 ->
    (border-masked score (B,Hc,Wc,1), image coords (B,Hc,Wc,2),
    L2-normalised descriptors (B,Hc,Wc,C)), all float32 NHWC."""
    name = "fused_postprocess"
    check_nhwc_dense(name, score=score, shift=shift, feat=feat)
    B, Hc, Wc, one = score.shape
    C = feat.shape[-1]
    if one != 1 or tuple(shift.shape) != (B, Hc, Wc, 2) or feat.shape[0] != B:
        raise ValueError(f"{name}: shapes score {tuple(score.shape)}, shift "
                         f"{tuple(shift.shape)}, feat {tuple(feat.shape)}")
    dev = device_of(name, score, shift, feat)
    if dev.type == "cpu":
        return postprocess_plain(score, shift, feat, H, W, cell, cross_ratio)
    ok = {k: FLOAT32_OR_BF16 for k in ("score", "shift", "feat")}
    check_kernel_inputs(name, ok, score=score, shift=shift, feat=feat)
    bf16 = score.dtype == torch.bfloat16
    if shift.dtype != score.dtype or feat.dtype != score.dtype:
        raise TypeError(f"{name}: score, shift and feat must share a dtype, "
                        f"got {score.dtype}, {shift.dtype}, {feat.dtype}")
    if not 1 <= C <= MAX_CHANNELS:
        raise ValueError(f"{name}: C={C} outside [1, {MAX_CHANNELS}]")
    Hf, Wf = feat.shape[1:3]
    score_out = torch.empty((B, Hc, Wc, 1), device=dev, dtype=torch.float32)
    coord_out = torch.empty((B, Hc, Wc, 2), device=dev, dtype=torch.float32)
    desc_out = torch.empty((B, Hc, Wc, C), device=dev, dtype=torch.float32)
    fn = _build.bind("nvs_postprocess_bf16" if bf16 else "nvs_postprocess",
                     _ARGTYPES)
    err = fn(score.data_ptr(), _build.strides(score), shift.data_ptr(),
             _build.strides(shift), feat.data_ptr(), _build.strides(feat),
             score_out.data_ptr(), coord_out.data_ptr(), desc_out.data_ptr(),
             B, Hc, Wc, Hf, Wf, C, H, W, cell, cross_ratio,
             _build.stream_ptr(dev))
    _build.check(err, name)
    if bf16:
        fused_postprocess.launches_bf16 += 1
    else:
        fused_postprocess.launches += 1
    return score_out, coord_out, desc_out


fused_postprocess.launches = 0
fused_postprocess.launches_bf16 = 0
