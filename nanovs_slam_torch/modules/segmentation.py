"""V2 segmentation decoder without attention (NCHW), the counterpart of
``SegmentationHead`` in ``nanovs_slam_tpu/modules/segmentation.py``:

conv(c_in->ch), conv(ch->ch), pool, conv(ch->ch), conv(ch->ch),
conv(ch->d1), [drop], up2x (d1->d1/4), cat(x), conv(d1/4+c_in->ch), [drop],
conv(ch->d1), up2x, cat(skip), conv(d1/4+c_skip->ch), final Conv(ch->c_out).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .blocks import ConvBNAct, Dropout2d, Upsampler


class SegmentationHead(nn.Module):
    def __init__(self, c_in: int, c_skip: int, c_hidden: int, c_out: int,
                 d1: int, with_drop: bool = True, bn_momentum: float = 0.1,
                 upscale_method: str = "pixelshuffle",
                 leaky_relu: bool = True):
        super().__init__()
        kw = dict(bn_momentum=bn_momentum, leaky_relu=leaky_relu)
        ch = c_hidden
        self.convs_0 = ConvBNAct(c_in, ch, **kw)
        self.convs_1 = ConvBNAct(ch, ch, **kw)
        self.convs_2 = ConvBNAct(ch, ch, **kw)
        self.convs_3 = ConvBNAct(ch, ch, **kw)
        self.convs_4 = ConvBNAct(ch, d1, **kw)
        self.convs_5 = ConvBNAct(d1 // 4 + c_in, ch, **kw)
        self.convs_6 = ConvBNAct(ch, d1, **kw)
        self.convs_7 = ConvBNAct(d1 // 4 + c_skip, ch, **kw)
        self.convs_8 = nn.Conv2d(ch, c_out, 3, padding=1, bias=True)
        self.upsample1 = Upsampler(d1, upscale_method, bn_momentum,
                                   leaky_relu)
        self.upsample2 = Upsampler(d1, upscale_method, bn_momentum,
                                   leaky_relu)
        self.drop = Dropout2d(0.2) if with_drop else nn.Identity()

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        seg = self.convs_1(self.convs_0(x))
        seg = F.max_pool2d(seg, 2, 2)
        seg = self.convs_4(self.convs_3(self.convs_2(seg)))
        seg = self.upsample1(self.drop(seg))
        seg = self.convs_5(torch.cat([seg, x], dim=1))
        seg = self.convs_6(self.drop(seg))
        seg = torch.cat([self.upsample2(seg), skip], dim=1)
        return self.convs_8(self.convs_7(seg))
