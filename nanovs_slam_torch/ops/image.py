"""Image normalisation on the device, the counterpart of
``nanovs_slam_tpu/ops/image.py``: callers may ship uint8 frames (a 4x
smaller host-to-device copy) and normalise after the copy."""

from __future__ import annotations

import torch


def to_model_input(raw: torch.Tensor) -> torch.Tensor:
    """uint8 frames or float frames in [0, 1] -> float32 in [-1, 1]
    ((x - 0.5) * 2; uint8 is divided by 255 first)."""
    x = raw.to(torch.float32)
    if raw.dtype == torch.uint8:
        x = x / 255.0
    return (x - 0.5) * 2.0


def quantize_u8(frames01: torch.Tensor) -> torch.Tensor:
    """float frames in [0, 1] -> uint8 (round to nearest even, clipped):
    the inverse of ``to_model_input``'s /255 branch up to the 2/255 step,
    which at bfloat16 compute equals the input cast's ulp near +-1. Resize
    in float first; only the transfer quantizes."""
    x = torch.as_tensor(frames01)
    return torch.clamp(torch.round(x * 255.0), 0, 255).to(torch.uint8)
