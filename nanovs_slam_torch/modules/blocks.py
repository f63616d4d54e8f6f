"""Basic NN blocks (NCHW modules; the public functions take NHWC).

Counterparts of ``nanovs_slam_tpu/modules/blocks.py``:

- ``ConvBNAct``: 3x3 conv (no bias) + BatchNorm (eps 1e-5, torch momentum
  0.1) + LeakyReLU(0.01) or ReLU;
- ``Upsampler``: 2x upsample, ``pixelshuffle`` (``nn.PixelShuffle`` in NCHW
  has the channel ordering the JAX ``pixel_shuffle`` mirrors) or
  ``convtranspose`` (ConvTranspose k3 s2 p1 op1, c -> c//4, + BN + act);
- ``Dropout2d``: channel dropout, a no-op in eval mode;
- ``l2_normalize``: ``x / max(sqrt(sum(x^2) + eps^2), eps)``;
- ``pixel_unshuffle``: NHWC, the ordering of ``nn.PixelUnshuffle``;
- ``Conv2d`` / ``ConvTranspose2d``: the layers with a compute dtype.

Reduced precision follows flax, not autocast: parameters and BN statistics
stay float32, and every conv casts its input, weight and bias to its
``compute_dtype`` at use (flax's ``nn.Conv(dtype=...)``);
``set_compute_dtype`` sets it for a whole model. BatchNorm on a bfloat16
conv output is a float32 affine against the float32 statistics, rounded to
bfloat16 (``nn.BatchNorm2d`` computes so on a bfloat16 input), as flax's
``nn.BatchNorm(dtype=...)`` does.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

Dropout2d = nn.Dropout2d


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """x / max(||x||, eps) with the norm computed as sqrt(sum(x^2) + eps^2),
    the JAX package's formulation (finite gradient at x == 0)."""
    norm = torch.sqrt((x * x).sum(dim=dim, keepdim=True) + eps * eps)
    return x / torch.clamp(norm, min=eps)


def pixel_unshuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """NHWC (B, H*r, W*r, C) -> (B, H, W, C*r*r),
    out[b, h, w, c*r*r + i*r + j] = in[b, h*r+i, w*r+j, c]."""
    return F.pixel_unshuffle(x.permute(0, 3, 1, 2), r).permute(0, 2, 3, 1)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in ``compute_dtype`` (float32 until
    ``set_compute_dtype`` sets it); its parameters stay float32."""

    compute_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` (fixed output padding) computing in
    ``compute_dtype``, as ``Conv2d``."""

    compute_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt), bias,
                                  self.stride, self.padding,
                                  self.output_padding, self.groups,
                                  self.dilation)


def set_compute_dtype(module: nn.Module, dtype: torch.dtype) -> None:
    """Every conv of ``module`` computes in ``dtype`` from now on."""
    for m in module.modules():
        if isinstance(m, (Conv2d, ConvTranspose2d)):
            m.compute_dtype = dtype


def act(leaky: bool) -> nn.Module:
    return nn.LeakyReLU(0.01) if leaky else nn.ReLU()


class ConvBNAct(nn.Module):
    """Conv(3x3, no bias) + BatchNorm + (Leaky)ReLU."""

    def __init__(self, c_in: int, c_out: int, bn_momentum: float = 0.1,
                 leaky_relu: bool = True):
        super().__init__()
        self.conv = Conv2d(c_in, c_out, 3, padding=1, bias=False)
        self.bn = nn.BatchNorm2d(c_out, eps=1e-5, momentum=bn_momentum)
        self.act = act(leaky_relu)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.bn(self.conv(x)))


class Upsampler(nn.Module):
    """Upscale by 2: C channels in, C//4 channels out at 2x resolution."""

    def __init__(self, in_features: int, method: str = "pixelshuffle",
                 bn_momentum: float = 0.1, leaky_relu: bool = True):
        super().__init__()
        self.method = method
        if method == "pixelshuffle":
            self.shuffle = nn.PixelShuffle(2)
        elif method == "convtranspose":
            self.transposed_conv = ConvTranspose2d(
                in_features, in_features // 4, 3, stride=2, padding=1,
                output_padding=1, bias=False)
            self.bn = nn.BatchNorm2d(in_features // 4, eps=1e-5,
                                     momentum=bn_momentum)
            self.act = act(leaky_relu)
        else:
            raise NotImplementedError(f"upscale method {method}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.method == "pixelshuffle":
            return self.shuffle(x)
        return self.act(self.bn(self.transposed_conv(x)))
