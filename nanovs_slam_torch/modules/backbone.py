"""Shared convolutional backbone (NCHW), the counterpart of
``nanovs_slam_tpu/modules/backbone.py``.

8 conv blocks conv1a..conv4b with 2x2 max-pools keyed on ``downsample``:
after pair 1 if downsample >= 2, after pair 2 if >= 3, after the skip tap
if >= 1. Dropout2d(0.2) after each pair when ``with_drop``.

On CUDA with downsample >= 2, ``conv1a -> conv1b -> maxpool`` runs as the
fused stem kernel on BN-folded weights, its bfloat16 instance for a
bfloat16 input, wherever ``stem_kernel_allowed`` says so: in eval mode
(dropout the identity, BN's running statistics) and with no gradient to
flow through the stem, since the kernel has no backward (nor has the JAX
one), and with conv1a and conv1b unobserved (no int8 scale under
``quant.int8_execution``, at float32 or bfloat16 alike, no forward hooks:
calibration observes their inputs). An eval-mode forward under autograd
(VPR finetuning differentiates the model in inference mode), train mode,
int8 execution and calibration run the block chain, as the CPU always
does.

On a slab of rows (``slabs`` set inside
``parallel.spatial.spatial_partition``) the kernel takes the slab extended
by two input rows from each neighbouring slab and drops the pooled row
each extension adds; at the map's first and last rows the slab is not
extended, since the kernel's own zero padding is the true one there (a
zero row in its place would not be: conv1a of a zero row is its bias
through the activation).

Under ``quant.int8_execution(..., chain=True)`` the blocks of
``quant.BACKBONE_CHAIN`` hand int8 ``QTensor``s to each other; a producer
that a max-pool follows pools in its kernel (``ConvBNAct``'s ``pool``).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import quant
from ..kernels.stem import fused_stem_pair_pool
from ..utils.fuse import fold_conv_bn
from .blocks import ConvBNAct, Dropout2d


def stem_kernel_allowed(backbone: "BackBone", x: torch.Tensor) -> bool:
    """Whether the backbone's stem may run as the fused kernel for ``x``:
    eval mode, downsample >= 2, conv1a and conv1b unobserved (no int8
    scale or chained output, whatever the dtype; no forward hook), and
    grad mode off or neither ``x`` nor a parameter of conv1a / conv1b
    requiring grad.
    The choice is by what the call needs, not a fallback: the kernel
    cannot pass a gradient, run int8 or show a hook the blocks' inputs."""
    if backbone.training or backbone.downsample < 2:
        return False
    for m in (backbone.conv1a, backbone.conv1b):
        if (quant.active_int8_scale(m.path) is not None
                or quant.active_int8_out_scale(m.path) is not None
                or m._forward_pre_hooks or m._forward_hooks):
            return False
    if not torch.is_grad_enabled():
        return True
    stem = (p for m in (backbone.conv1a, backbone.conv1b)
            for p in m.parameters())
    return not (x.requires_grad or any(p.requires_grad for p in stem))


def max_pool_2x2(x):
    """2x2 max-pool of a float map; a ``QTensor`` comes pooled already
    (its producer pooled in its kernel)."""
    return x if isinstance(x, quant.QTensor) else F.max_pool2d(x, 2, 2)


class BackBone(nn.Module):
    """Returns (x, skip): x at 1/cell resolution (c4 ch), skip at
    1/(cell/2) resolution (c4 ch)."""

    slabs = None  # set inside ``spatial_partition``

    def __init__(self, c1: int, c2: int, c3: int, c4: int,
                 downsample: int = 2, with_drop: bool = True,
                 bn_momentum: float = 0.1, leaky_relu: bool = True):
        super().__init__()
        kw = dict(bn_momentum=bn_momentum, leaky_relu=leaky_relu)
        self.downsample = downsample
        self.leaky_relu = leaky_relu
        self.conv1a = ConvBNAct(3, c1, **kw)
        self.conv1b = ConvBNAct(c1, c2, **kw)
        self.conv2a = ConvBNAct(c2, c2, **kw)
        self.conv2b = ConvBNAct(c2, c3, **kw)
        self.conv3a = ConvBNAct(c3, c3, **kw)
        self.conv3b = ConvBNAct(c3, c4, **kw)
        self.conv4a = ConvBNAct(c4, c4, **kw)
        self.conv4b = ConvBNAct(c4, c4, **kw)
        self.drop = Dropout2d(0.2) if with_drop else nn.Identity()

    def _stem(self, x: torch.Tensor) -> torch.Tensor:
        if x.is_cuda and stem_kernel_allowed(self, x):
            w1, b1 = fold_conv_bn(self.conv1a.conv, self.conv1a.bn)
            w2, b2 = fold_conv_bn(self.conv1b.conv, self.conv1b.bn)
            if self.slabs is not None:
                h, top = x.shape[2], int(self.slabs.mesh.rank > 0)
                x = self.slabs.halo(x, 2, 2, zero_edges=False)
            y = fused_stem_pair_pool(x.permute(0, 2, 3, 1), w1, b1, w2, b2,
                                     0.01 if self.leaky_relu else 0.0)
            y = y.permute(0, 3, 1, 2)
            if self.slabs is not None:
                y = y[:, :, top:top + h // 2]
            return y
        pool = self.downsample >= 2
        x = self.drop(self.conv1b(self.conv1a(x), pool=pool))
        return max_pool_2x2(x) if pool else x

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self._stem(x)
        pool = self.downsample >= 3
        x = self.drop(self.conv2b(self.conv2a(x), pool=pool))
        if pool:
            x = max_pool_2x2(x)
        skip = self.drop(self.conv3b(self.conv3a(x)))
        x = F.max_pool2d(skip, 2, 2) if self.downsample >= 1 else skip
        x = self.drop(self.conv4b(self.conv4a(x)))
        return x, skip
