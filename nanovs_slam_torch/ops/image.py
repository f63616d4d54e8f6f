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


def resize_nearest(img, H: int, W: int):
    """numpy (h, w, ...) -> (H, W, ...): cv2.resize's INTER_NEAREST (the
    JAX package resizes ground truth with it). Source row of row y:
    min(floor(y * ify), h - 1) with ify = 1 / (H / h) in float64, cv2's
    arithmetic (h / H itself differs from it by an ulp at some ratios and
    moves whole rows); columns alike. A trailing channel axis of size 1
    is kept (cv2 drops it)."""
    import numpy as np

    h, w = img.shape[:2]
    ify, ifx = 1.0 / (H / h), 1.0 / (W / w)
    ys = np.minimum(np.floor(np.arange(H) * ify).astype(np.int64), h - 1)
    xs = np.minimum(np.floor(np.arange(W) * ifx).astype(np.int64), w - 1)
    return img[ys[:, None], xs[None, :]]
