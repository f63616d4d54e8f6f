"""Argument checks shared by the kernel wrappers."""

from __future__ import annotations

import torch


def device_of(name: str, *tensors: torch.Tensor) -> torch.device:
    """The one device all tensors lie on: "cpu" selects the plain twin,
    "cuda" the kernel; anything else raises."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices {devices}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel or plain version for {dev}")
    return dev


FLOAT32 = (torch.float32,)
FLOAT32_OR_BF16 = (torch.float32, torch.bfloat16)


def check_kernel_inputs(name: str, dtypes=None, **tensors: torch.Tensor
                        ) -> None:
    """What every kernel takes: each argument in its allowed dtypes
    (``dtypes`` maps an argument's name to them; float32 where it is not
    named), no autograd (only NetVLAD has a backward kernel, and its
    wrapper launches the forward inside its ``autograd.Function``)."""
    for arg, t in tensors.items():
        allowed = (dtypes or {}).get(arg, FLOAT32)
        if t.dtype not in allowed:
            raise TypeError(f"{name}: {arg} must be "
                            f"{' or '.join(map(str, allowed))}, got "
                            f"{t.dtype}")
        if t.requires_grad and torch.is_grad_enabled():
            raise RuntimeError(f"{name}: {arg} requires grad, but the CUDA "
                               "kernel has no backward; call it under "
                               "torch.no_grad() or torch.inference_mode()")


def check_contiguous(name: str, **tensors: torch.Tensor) -> None:
    for arg, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def check_nhwc_dense(name: str, **tensors: torch.Tensor) -> None:
    """A 4-D NHWC-shaped tensor whose memory is NHWC or NCHW contiguous (a
    ``permute(0, 2, 3, 1)`` view of a conv output): the kernels read both
    through the strides."""
    for arg, t in tensors.items():
        if t.dim() != 4:
            raise ValueError(f"{name}: {arg} must be 4-D NHWC, got "
                             f"{tuple(t.shape)}")
        if not (t.is_contiguous() or t.permute(0, 3, 1, 2).is_contiguous()):
            raise ValueError(f"{name}: {arg} must be NHWC- or "
                             "NCHW-contiguous")
