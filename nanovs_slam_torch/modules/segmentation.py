"""Segmentation decoders (NCHW), counterparts of
``nanovs_slam_tpu/modules/segmentation.py``; the layers keep the flax
names so that ``utils/convert.py`` maps them.

- ``SegmentationHead`` (V2): conv(c_in->ch), conv(ch->ch), pool,
  conv(ch->ch), conv(ch->ch), conv(ch->d1), [drop], up2x (d1->d1/4),
  cat(x), conv(d1/4+c_in->ch), [drop], conv(ch->d1), up2x, cat(skip),
  conv(d1/4+c_skip->ch), final Conv(ch->c_out) ``convs_8``.
- ``SegmentationHeadATT`` (V2 with attention): conv(c_in->ch), attention,
  pool, attention, conv(ch->d1), [drop], up2x, cat(x), conv(d1/4+c_in->ch),
  conv(ch->d1), [drop], up2x, cat(skip), conv(d1/4+c_skip->ch), final
  Conv(ch->c_out) ``convs_7``.
- ``SegmentationFeatHeadLight[ATT]`` (V3, decoder fusion): the same trunks,
  whose last conv gives c_hidden_b = ch (+ ch/2 with depth) channels,
  split with dim_split = ch // 2 into the descriptor map
  ``featB(y[:, :dim_split])``, the depth map ``featD(y[:, dim_split:
  2*dim_split])`` (no bias) and the class logits ``final(y[:,
  -dim_split:])``; the forward returns (seg, feat[, depth]).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .attention import SegFormerAttentionModule
from .blocks import Conv2d, ConvBNAct, Dropout2d, Upsampler


def _conv3(c_in: int, c_out: int, bias: bool = True) -> Conv2d:
    return Conv2d(c_in, c_out, 3, padding=1, bias=bias)


class SegmentationHead(nn.Module):
    def __init__(self, c_in: int, c_skip: int, c_hidden: int, c_out: int,
                 d1: int, with_drop: bool = True, bn_momentum: float = 0.1,
                 upscale_method: str = "pixelshuffle",
                 leaky_relu: bool = True, c_last: int = 0):
        """``c_last``: the last ConvBNAct's width (default c_hidden); a
        fused head sets it and replaces ``convs_8``."""
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
        self.convs_7 = ConvBNAct(d1 // 4 + c_skip, c_last or ch, **kw)
        self.convs_8 = _conv3(ch, c_out)
        self.upsample1 = Upsampler(d1, upscale_method, bn_momentum,
                                   leaky_relu)
        self.upsample2 = Upsampler(d1, upscale_method, bn_momentum,
                                   leaky_relu)
        self.drop = Dropout2d(0.2) if with_drop else nn.Identity()

    def trunk(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        seg = self.convs_1(self.convs_0(x))
        seg = F.max_pool2d(seg, 2, 2)
        seg = self.convs_4(self.convs_3(self.convs_2(seg)))
        seg = self.upsample1(self.drop(seg))
        seg = self.convs_5(torch.cat([seg, x], dim=1))
        seg = self.convs_6(self.drop(seg))
        seg = torch.cat([self.upsample2(seg), skip], dim=1)
        return self.convs_7(seg)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        return self.convs_8(self.trunk(x, skip))


class SegmentationHeadATT(nn.Module):
    def __init__(self, c_in: int, c_skip: int, c_hidden: int, c_out: int,
                 d1: int, with_drop: bool = True, bn_momentum: float = 0.1,
                 upscale_method: str = "pixelshuffle",
                 leaky_relu: bool = True, c_last: int = 0):
        """``c_last`` as for ``SegmentationHead``; the final conv is
        ``convs_7``."""
        super().__init__()
        kw = dict(bn_momentum=bn_momentum, leaky_relu=leaky_relu)
        ch = c_hidden
        self.convs_0 = ConvBNAct(c_in, ch, **kw)
        self.convs_1 = SegFormerAttentionModule(ch)
        self.convs_2 = SegFormerAttentionModule(ch)
        self.convs_3 = ConvBNAct(ch, d1, **kw)
        self.convs_4 = ConvBNAct(d1 // 4 + c_in, ch, **kw)
        self.convs_5 = ConvBNAct(ch, d1, **kw)
        self.convs_6 = ConvBNAct(d1 // 4 + c_skip, c_last or ch, **kw)
        self.convs_7 = _conv3(ch, c_out)
        self.upsample1 = Upsampler(d1, upscale_method, bn_momentum,
                                   leaky_relu)
        self.upsample2 = Upsampler(d1, upscale_method, bn_momentum,
                                   leaky_relu)
        self.drop = Dropout2d(0.2) if with_drop else nn.Identity()

    def trunk(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        seg = self.convs_1(self.convs_0(x))
        seg = F.max_pool2d(seg, 2, 2)
        seg = self.convs_3(self.convs_2(seg))
        seg = self.upsample1(self.drop(seg))
        seg = self.convs_5(self.convs_4(torch.cat([seg, x], dim=1)))
        seg = torch.cat([self.upsample2(self.drop(seg)), skip], dim=1)
        return self.convs_6(seg)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        return self.convs_7(self.trunk(x, skip))


def _split_heads(y: torch.Tensor, seg_conv: Conv2d, featB: Conv2d,
                 featD) -> tuple:
    """The V3 heads on the fused trunk's output: (seg, feat[, depth])."""
    ds = featB.in_channels
    seg, feat = seg_conv(y[:, -ds:]), featB(y[:, :ds])
    if featD is None:
        return seg, feat
    return seg, feat, featD(y[:, ds:2 * ds])


class SegmentationFeatHeadLight(SegmentationHead):
    def __init__(self, c_in: int, c_skip: int, c_hidden: int, c_out: int,
                 n_feat: int, d1: int, with_drop: bool = True,
                 bn_momentum: float = 0.1,
                 upscale_method: str = "pixelshuffle",
                 leaky_relu: bool = True, depth: bool = False):
        ds = c_hidden // 2
        super().__init__(c_in, c_skip, c_hidden, c_out, d1, with_drop,
                         bn_momentum, upscale_method, leaky_relu,
                         c_last=c_hidden + (ds if depth else 0))
        self.convs_8 = _conv3(ds, c_out)
        self.featB = _conv3(ds, n_feat)
        self.featD = _conv3(ds, 1, bias=False) if depth else None

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> tuple:
        return _split_heads(self.trunk(x, skip), self.convs_8, self.featB,
                            self.featD)


class SegmentationFeatHeadLightATT(SegmentationHeadATT):
    def __init__(self, c_in: int, c_skip: int, c_hidden: int, c_out: int,
                 n_feat: int, d1: int, with_drop: bool = True,
                 bn_momentum: float = 0.1,
                 upscale_method: str = "pixelshuffle",
                 leaky_relu: bool = True, depth: bool = False):
        ds = c_hidden // 2
        super().__init__(c_in, c_skip, c_hidden, c_out, d1, with_drop,
                         bn_momentum, upscale_method, leaky_relu,
                         c_last=c_hidden + (ds if depth else 0))
        self.convs_7 = _conv3(ds, c_out)
        self.featB = _conv3(ds, n_feat)
        self.featD = _conv3(ds, 1, bias=False) if depth else None

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> tuple:
        return _split_heads(self.trunk(x, skip), self.convs_7, self.featB,
                            self.featD)
