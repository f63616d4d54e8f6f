"""Keypoint task heads (NCHW), counterparts of
``nanovs_slam_tpu/modules/heads.py``.

- ``SimpleTaskHead``: ConvBNAct(c_in -> c_hidden) [+ drop] + Conv3x3 with
  bias (c_hidden -> c_out); the score (1 ch) and loc (2 ch) heads.
- ``UpscaleHead``: convA ConvBNAct [+ drop] -> convB Conv -> 2x upsample ->
  concat skip -> convAa ConvBNAct -> convBb Conv; the dense descriptor map
  at skip resolution.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .blocks import Conv2d, ConvBNAct, Dropout2d, Upsampler


class SimpleTaskHead(nn.Module):
    def __init__(self, c_in: int, c_hidden: int, c_out: int,
                 bn_momentum: float = 0.1, with_drop: bool = False,
                 leaky_relu: bool = True):
        super().__init__()
        self.convDa = ConvBNAct(c_in, c_hidden, bn_momentum, leaky_relu)
        self.drop = Dropout2d(0.2) if with_drop else nn.Identity()
        self.convDb = Conv2d(c_hidden, c_out, 3, padding=1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.convDb(self.drop(self.convDa(x)))


class UpscaleHead(nn.Module):
    """Dense descriptor head: upsample 2x, fuse skip, project to c5."""

    def __init__(self, c_in: int, c_skip: int, c1: int, c2: int, c4: int,
                 c5: int, with_drop: bool = True, bn_momentum: float = 0.1,
                 upscale_method: str = "pixelshuffle",
                 leaky_relu: bool = True):
        super().__init__()
        self.convA = ConvBNAct(c_in, c1, bn_momentum, leaky_relu)
        self.drop = Dropout2d(0.2) if with_drop else nn.Identity()
        self.convB = Conv2d(c1, c2, 3, padding=1, bias=True)
        self.upsample1 = Upsampler(c2, upscale_method, bn_momentum,
                                   leaky_relu)
        self.convAa = ConvBNAct(c2 // 4 + c_skip, c4, bn_momentum,
                                leaky_relu)
        self.convBb = Conv2d(c4, c5, 3, padding=1, bias=True)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        x = self.convB(self.drop(self.convA(x)))
        x = torch.cat([self.upsample1(x), skip], dim=1)
        return self.convBb(self.convAa(x))
