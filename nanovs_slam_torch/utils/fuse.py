"""Conv + BatchNorm folding for inference.

At inference the BN affine transform folds into the preceding conv:

    w' = w * gamma / sqrt(var + eps)
    b' = beta - gamma * mean / sqrt(var + eps)

the rule of the JAX package's ``utils/fuse.fold_batchnorm``. The fused stem
kernel consumes the folded weights of the backbone's first two blocks.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn


def fold_conv_bn(conv: nn.Conv2d, bn: nn.BatchNorm2d
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(weight OIHW, bias) of ``bn(conv(x))`` with the BN running stats
    folded in. ``conv`` must have no bias of its own."""
    if conv.bias is not None:
        raise ValueError("fold_conv_bn expects a conv without bias")
    inv = bn.weight / torch.sqrt(bn.running_var + bn.eps)
    w = conv.weight * inv[:, None, None, None]
    b = bn.bias - bn.running_mean * inv
    return w.contiguous(), b.contiguous()
