"""InlierNet (IO-Net), the counterpart of
``nanovs_slam_tpu/models/inlier_net.py``: a per-match MLP over point pairs
(B, N, 5) = (x0, y0, x1, y1, descriptor distance) -> inlier logits (B, N).

``p_in_conv`` (Linear 5 -> 128, no bias) + BN + ReLU; ``blocks`` residual
blocks of [Linear -> instance norm over the N matches (no affine, eps
1e-5, biased variance) -> BN -> ReLU] x 2 with a skip; ``p_out`` (Linear
128 -> 1). Layer names are flax's, so ``utils/convert.load_jax_inlier_net``
loads ``io_params`` / ``io_batch_stats``. The BNs keep flax's running
statistics (``modules/blocks.BatchNorm1d``). Their momenta are torch's:
the JAX module's flax momentum 0.1 on ``p_in_bn`` is torch momentum 0.9,
its 0.9 on the blocks' BNs torch momentum 0.1.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..modules.blocks import BatchNorm1d


def _instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x (B, N, C): normalise over N per (batch, channel), no affine."""
    var, mean = torch.var_mean(x, dim=1, keepdim=True, unbiased=False)
    return (x - mean) / torch.sqrt(var + eps)


class InlierNet(nn.Module):
    def __init__(self, blocks: int = 4, width: int = 128):
        super().__init__()
        self.blocks = blocks
        self.p_in_conv = nn.Linear(5, width, bias=False)
        self.p_in_bn = BatchNorm1d(width, eps=1e-5, momentum=0.9)
        for i in range(blocks):
            for j in range(2):
                setattr(self, f"b{i}_conv{j}", nn.Linear(width, width))
                setattr(self, f"b{i}_bn{j}",
                        BatchNorm1d(width, eps=1e-5, momentum=0.1))
        self.p_out = nn.Linear(width, 1)

    def forward(self, point_pair: torch.Tensor) -> torch.Tensor:
        """point_pair (B, N, 5) -> inlier logits (B, N)."""
        x = torch.relu(self.p_in_bn(self.p_in_conv(point_pair)))
        for i in range(self.blocks):
            y = x
            for j in range(2):
                y = _instance_norm(getattr(self, f"b{i}_conv{j}")(y))
                y = torch.relu(getattr(self, f"b{i}_bn{j}")(y))
            x = y + x
        return self.p_out(x)[..., 0]


@torch.no_grad()
def init_inlier_net(generator: torch.Generator, blocks: int = 4,
                    device=None) -> InlierNet:
    """A new ``InlierNet`` with flax's initialisers drawn from
    ``generator`` (a CPU generator): lecun-normal Dense kernels, zero
    biases, unit BN; on ``device`` (default "cuda")."""
    from ..utils.device import resolve_device
    from .kp2dtiny import _lecun_normal_

    net = InlierNet(blocks=blocks)
    for mod in net.modules():
        if isinstance(mod, nn.Linear):
            _lecun_normal_(mod.weight, mod.weight.shape[1], generator)
            if mod.bias is not None:
                mod.bias.zero_()
    return net.to(resolve_device(device))
