"""KeypointFormer in PyTorch, the counterpart of
``nanovs_slam_tpu/models/keypoint_former.py`` (reference:
src/kp2dtiny/models/kp2d_former.py and segformer.py).

- ``MiT``: four stages of an overlapping patch embed (one strided conv with
  bias: kernel, stride, pad (7, 4, 3), then (3, 2, 1) three times) and
  ``num_layers`` x [ChannelLayerNorm, EfficientSelfAttention, residual;
  ChannelLayerNorm, MixFeedForward, residual] at the stage's width, heads,
  expansion and reduction ratio. Unlike KP2DTiny's SegFormer blocks these
  have residuals. Stage outputs at H/4, H/8, H/16, H/32.
- ``KeypointFormer``: each stage through a 1x1 conv + BN + ReLU to
  ``decoder_dim`` channels, upsampled by 2^i (nearest, ``repeat``) to H/4
  and concatenated; heads on the fused map: seg (1x1, 1x1), score and loc
  (3x3 stride 2, then 1x1, to the cell-8 grid; sigmoid / tanh), feat (1x1,
  3x3, 1x1 at H/4) and the VPR head (a 1x1 conv with stride 2 and pad 1,
  so its border rows are the bias alone, BN, ReLU, 1x1, ReLU) feeding
  ``NetVLAD(num_clusters, feat_dim, vladv2=True)``. Every head conv has a
  bias; BN is flax's (momentum 0.9 there, 0.1 here; eps 1e-5).
- The forward takes and returns NCHW: score (B,1,H/8,W/8), coord (B,2,...),
  feat (B,feat_dim,H/4,W/4), seg logits (B,n_classes,H/4,W/4) (no softmax
  at eval, as in the JAX model), vlad (B, num_clusters * feat_dim);
  ``only_encoder`` returns the VPR head's dense map (B,feat_dim,h,w).

The fused concatenation needs every stage, upsampled, at the first stage's
size: ceil(H/4) and ceil(W/4) divisible by 8, which H and W divisible by 32
give. The JAX model fails there otherwise (at 120x160 and 240x320); the
port raises ``ValueError`` before any work.

On a slab of rows (``slabs`` set inside
``parallel.spatial.spatial_partition``) the VPR head's rows are those its
strided first conv gives the rank (``SlabPlan.conv_rows``), and NetVLAD
takes the head's map gathered from them: every rank computes the same
descriptor.

Submodules keep the flax names (``mit.stage{s}_embed``,
``mit.stage{s}_l{l}_att``, ``to_fused{i}_conv``, ``seg_conv0``,
``netvlad``, ...), so that ``utils/convert.load_jax_variables`` maps a flax
tree onto the ``state_dict`` by name. ``cfg.dtype`` is the compute dtype,
as for KP2DTiny (``modules/blocks.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from ..modules.aggregators import NetVLAD
from ..modules.attention import (ChannelLayerNorm, EfficientSelfAttention,
                                 MixFeedForward)
from ..modules.blocks import BatchNorm2d, Conv2d, set_compute_dtype


@dataclasses.dataclass(frozen=True)
class KeypointFormerConfig:
    """A copy of the JAX package's ``KeypointFormerConfig`` (``dtype`` a
    string)."""
    dims: Tuple[int, ...] = (32, 64, 160, 256)
    heads: Tuple[int, ...] = (1, 2, 5, 8)
    ff_expansion: Tuple[int, ...] = (8, 8, 4, 4)
    reduction_ratio: Tuple[int, ...] = (8, 4, 2, 1)
    num_layers: int = 2
    decoder_dim: int = 256
    feat_dim: int = 256
    n_classes: int = 4
    num_clusters: int = 64
    dtype: str = "float32"

    @property
    def cell(self) -> int:
        return 8

    @property
    def cross_ratio(self) -> float:
        return 2.0

    @property
    def compute_dtype(self) -> torch.dtype:
        return {"float32": torch.float32,
                "bfloat16": torch.bfloat16}[self.dtype]


KEYPOINTFORMER_CONFIGS = {
    "default": KeypointFormerConfig(),
    "tiny": KeypointFormerConfig(dims=(16, 32, 64, 64), heads=(1, 2, 4, 4),
                                 ff_expansion=(4, 4, 2, 2),
                                 reduction_ratio=(8, 4, 4, 2),
                                 decoder_dim=64, feat_dim=64),
}

_STAGE_KSP = ((7, 4, 3), (3, 2, 1), (3, 2, 1), (3, 2, 1))


def check_frame_size(H: int, W: int) -> None:
    """Raise where the JAX model's fused concatenation fails: a stage
    upsampled by 2^i must have the first stage's size, ceil(side / 4)."""
    for side, name in ((H, "H"), (W, "W")):
        if -(-side // 4) % 8:
            raise ValueError(
                f"KeypointFormer: {name} = {side} gives stage sizes that do "
                f"not upsample back to ceil({name}/4) (the fused pyramid "
                f"needs ceil({name}/4) divisible by 8, e.g. {name} a "
                "multiple of 32); the JAX model fails at its concatenation "
                "there")


class MiT(nn.Module):
    """Mix Transformer pyramid encoder; returns all four stage outputs."""

    def __init__(self, cfg: KeypointFormerConfig):
        super().__init__()
        self.cfg = cfg
        c_in = 3
        for s, (dim, (k, stride, pad)) in enumerate(zip(cfg.dims,
                                                        _STAGE_KSP)):
            self.add_module(f"stage{s}_embed",
                            Conv2d(c_in, dim, k, stride=stride, padding=pad))
            for l in range(cfg.num_layers):
                self.add_module(f"stage{s}_l{l}_norm_att",
                                ChannelLayerNorm(dim))
                self.add_module(f"stage{s}_l{l}_att", EfficientSelfAttention(
                    dim, cfg.heads[s], cfg.reduction_ratio[s]))
                self.add_module(f"stage{s}_l{l}_norm_mff",
                                ChannelLayerNorm(dim))
                self.add_module(f"stage{s}_l{l}_mff",
                                MixFeedForward(dim, cfg.ff_expansion[s]))
            c_in = dim

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        outs = []
        for s in range(len(self.cfg.dims)):
            x = getattr(self, f"stage{s}_embed")(x)
            for l in range(self.cfg.num_layers):
                y = getattr(self, f"stage{s}_l{l}_norm_att")(x)
                x = x + getattr(self, f"stage{s}_l{l}_att")(y)
                y = getattr(self, f"stage{s}_l{l}_norm_mff")(x)
                x = x + getattr(self, f"stage{s}_l{l}_mff")(y)
            outs.append(x)
        return tuple(outs)


# the heads: (name, [(features, kernel, stride, pad, bn), ...]); features
# None is cfg.feat_dim, "classes" cfg.n_classes, 0 the decoder width
_HEADS = (
    ("seg", ((0, 1, 1, 0, True), ("classes", 1, 1, 0, False))),
    ("score", ((0, 3, 2, 1, True), (1, 1, 1, 0, False))),
    ("loc", ((0, 3, 2, 1, True), (2, 1, 1, 0, False))),
    ("feat", ((0, 1, 1, 0, True), (0, 3, 1, 1, True),
              (None, 1, 1, 0, False))),
    ("vlad", ((0, 1, 2, 1, True), (None, 1, 1, 0, False))),
)


def _upsample_nearest(x: torch.Tensor, factor: int) -> torch.Tensor:
    if factor == 1:
        return x
    return x.repeat_interleave(factor, 2).repeat_interleave(factor, 3)


class KeypointFormer(nn.Module):
    slabs = None  # set inside ``spatial_partition``

    def __init__(self, cfg: KeypointFormerConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.decoder_dim
        self.mit = MiT(cfg)
        for i, dim in enumerate(cfg.dims):
            self.add_module(f"to_fused{i}_conv", Conv2d(dim, d, 1))
            self.add_module(f"to_fused{i}_bn",
                            BatchNorm2d(d, eps=1e-5, momentum=0.1))
        width = {0: d, None: cfg.feat_dim, "classes": cfg.n_classes}
        for name, convs in _HEADS:
            c_in = len(cfg.dims) * d
            for j, (feats, k, stride, pad, bn) in enumerate(convs):
                c_out = width.get(feats, feats)
                self.add_module(f"{name}_conv{j}", Conv2d(
                    c_in, c_out, k, stride=stride, padding=pad))
                if bn:
                    self.add_module(f"{name}_bn{j}", BatchNorm2d(
                        c_out, eps=1e-5, momentum=0.1))
                c_in = c_out
        self.netvlad = NetVLAD(cfg.num_clusters, cfg.feat_dim, vladv2=True)
        set_compute_dtype(self, cfg.compute_dtype)

    def _head(self, name: str, y: torch.Tensor) -> torch.Tensor:
        for j, (*_, bn) in enumerate(dict(_HEADS)[name]):
            y = getattr(self, f"{name}_conv{j}")(y)
            if bn:
                y = torch.relu(getattr(self, f"{name}_bn{j}")(y))
        return y

    def forward(self, x: torch.Tensor, only_encoder: bool = False
                ) -> Dict[str, torch.Tensor]:
        """x (B, 3, H, W) in [-1, 1]; the BN layers use their batch
        statistics in training mode."""
        check_frame_size(x.shape[2], x.shape[3])
        stage_outs = self.mit(x.to(self.cfg.compute_dtype))
        fused = []
        for i, so in enumerate(stage_outs):
            y = getattr(self, f"to_fused{i}_conv")(so)
            y = torch.relu(getattr(self, f"to_fused{i}_bn")(y))
            fused.append(_upsample_nearest(y, 2 ** i))
        fused = torch.cat(fused, dim=1)  # (B, 4d, H/4, W/4)
        vlad_feat = torch.relu(self._head("vlad", fused))
        if self.slabs is not None:
            conv = self.vlad_conv0
            _, _, _, lo, total = self.slabs.conv_rows(
                fused.shape[2], conv.kernel_size[0], conv.stride[0],
                conv.padding[0])
            vlad_feat = self.slabs.gather_rows(vlad_feat, 2, lo, total)
        if only_encoder:
            return vlad_feat
        return {"score": torch.sigmoid(self._head("score", fused)),
                "coord": torch.tanh(self._head("loc", fused)),
                "feat": self._head("feat", fused),
                "seg": self._head("seg", fused),
                "vlad": self.netvlad(vlad_feat)}


def build_model(cfg: KeypointFormerConfig) -> KeypointFormer:
    return KeypointFormer(cfg)


@torch.no_grad()
def init_model(cfg: KeypointFormerConfig, generator: torch.Generator,
               device: Optional[torch.device] = None) -> KeypointFormer:
    """A new KeypointFormer with weights drawn from ``generator`` by the
    JAX package's initialisers (``models.kp2dtiny.init_weights_``), in
    eval mode on ``device`` (default "cuda")."""
    from .kp2dtiny import init_weights_
    from ..utils.device import resolve_device

    model = build_model(cfg)
    init_weights_(model, generator)
    return model.to(resolve_device(device)).eval()
