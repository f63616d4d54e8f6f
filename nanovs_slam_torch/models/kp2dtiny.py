"""KP2DTiny in PyTorch, the counterparts of ``KP2DTinyV2`` and
``KP2DTinyV3`` in ``nanovs_slam_tpu/models/kp2dtiny.py``.

V2 ("dedicated decoders"): a shared BackBone and the heads score (sigmoid,
1 ch), loc (tanh, 2 ch), dense descriptors (UpscaleHead), segmentation
(SegmentationHead, or SegmentationHeadATT with attention), VPR (VPRHead)
and, with ``cfg.depth``, depth (the segmentation head's class with one
channel, then a sigmoid). V3 ("decoder fusion"): a 3-channel score+loc
head (sigmoid on channel 0, tanh on 1-2), a fused segmentation +
descriptor (+ depth) head, a softmax over the classes at eval, and VPR.

The forward takes and returns NCHW tensors: score (B,1,Hc,Wc), coord =
tanh shift (B,2,Hc,Wc), feat (B,nfeat,Hs,Ws), seg (B,nCls,Hs,Ws) (V2
logits, V3 probabilities at eval), vlad (B,D), depth (B,1,Hs,Ws), with Hc =
H/cell and Hs = 2*Hc.

``cfg.dtype`` is the compute dtype (float32 or bfloat16), as in flax: the
forward casts its input to it once, every conv computes in it, the
parameters and BN statistics stay float32 (``modules/blocks.py``).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from ..configs import KP2DTinyConfig
from ..modules.aggregators import NetVLAD
from ..modules.backbone import BackBone
from ..modules.blocks import name_blocks, set_compute_dtype
from ..modules.heads import SimpleTaskHead, UpscaleHead
from ..modules.segmentation import (SegmentationFeatHeadLight,
                                    SegmentationFeatHeadLightATT,
                                    SegmentationHead, SegmentationHeadATT)
from ..modules.vpr import VPRHead
from ..utils.device import resolve_device

ALL_HEADS = ("score", "loc", "desc", "seg", "vlad", "depth")


def _backbone(cfg: KP2DTinyConfig) -> BackBone:
    c1, c2, c3, c4 = cfg.channel_dims[:4]
    return BackBone(c1, c2, c3, c4, cfg.downsample, cfg.with_drop,
                    cfg.bn_momentum, cfg.leaky_relu)


def _vpr_head(cfg: KP2DTinyConfig) -> VPRHead:
    return VPRHead(cfg.channel_dims[3], cfg.enc_dim, cfg.num_clusters,
                   cfg.with_drop, cfg.bn_momentum, cfg.remove_netvlad,
                   cfg.leaky_relu, cfg.global_descriptor_method)


class KP2DTinyV2(nn.Module):
    def __init__(self, cfg: KP2DTinyConfig):
        super().__init__()
        self.cfg = cfg
        c1, c2, c3, c4, c5, d1 = cfg.channel_dims
        m, drop, leaky = cfg.bn_momentum, cfg.with_drop, cfg.leaky_relu
        up = cfg.upscale_method
        self.backbone = _backbone(cfg)
        self.score_head = SimpleTaskHead(c4, c4, 1, m, drop, leaky)
        self.loc_head = SimpleTaskHead(c4, c4, 2, m, drop, leaky)
        self.desc_head = UpscaleHead(c4, c4, c4, c3 * 4, c4, cfg.nfeatures,
                                     drop, m, up, leaky)
        seg_cls = SegmentationHeadATT if cfg.use_attention \
            else SegmentationHead
        self.seg_head = seg_cls(c4, c4, c5, cfg.n_classes, d1, drop, m, up,
                                leaky)
        self.vlad_head = _vpr_head(cfg)
        if cfg.depth:
            self.depth_head = seg_cls(c4, c4, c5, 1, d1, drop, m, up, leaky)
        set_compute_dtype(self, cfg.compute_dtype)
        name_blocks(self)

    def forward(self, x: torch.Tensor, only_encoder: bool = False,
                heads: Sequence[str] = ALL_HEADS) -> Dict[str, torch.Tensor]:
        """x (B, 3, H, W) in [-1, 1]. ``heads`` selects the task heads to
        compute ("depth" only where the config has it); ``only_encoder``
        returns the L2-normalised dense VPR encoder map (for NetVLAD k-means
        init)."""
        unknown = set(heads) - set(ALL_HEADS)
        if unknown:
            raise ValueError(f"unknown heads {sorted(unknown)}")
        feat_x, skip = self.backbone(x.to(self.cfg.compute_dtype))
        if only_encoder:
            return self.vlad_head(feat_x, only_encoder=True)
        out: Dict[str, torch.Tensor] = {}
        if "score" in heads:
            out["score"] = torch.sigmoid(self.score_head(feat_x))
        if "loc" in heads:
            out["coord"] = torch.tanh(self.loc_head(feat_x))
        if "desc" in heads:
            out["feat"] = self.desc_head(feat_x, skip)
        if "seg" in heads:
            out["seg"] = self.seg_head(feat_x, skip)
        if "vlad" in heads:
            out["vlad"] = self.vlad_head(feat_x)
        if self.cfg.depth and "depth" in heads:
            out["depth"] = torch.sigmoid(self.depth_head(feat_x, skip))
        return out


class KP2DTinyV3(nn.Module):
    """Every head is computed on each call, as in the JAX package. At eval
    (``not self.training``) the class map is a softmax over the classes,
    as the reference's forward gives it."""

    def __init__(self, cfg: KP2DTinyConfig):
        super().__init__()
        self.cfg = cfg
        c4, c5, d1 = cfg.channel_dims[3:]
        m, drop, leaky = cfg.bn_momentum, cfg.with_drop, cfg.leaky_relu
        self.backbone = _backbone(cfg)
        self.score_loc_head = SimpleTaskHead(c4, c4, 3, m, drop, leaky)
        seg_cls = SegmentationFeatHeadLightATT if cfg.use_attention \
            else SegmentationFeatHeadLight
        self.seg_head = seg_cls(c4, c4, c5, cfg.n_classes, cfg.nfeatures, d1,
                                drop, m, cfg.upscale_method, leaky,
                                cfg.depth)
        self.vlad_head = _vpr_head(cfg)
        set_compute_dtype(self, cfg.compute_dtype)
        name_blocks(self)

    def forward(self, x: torch.Tensor, only_encoder: bool = False
                ) -> Dict[str, torch.Tensor]:
        """x (B, 3, H, W) in [-1, 1]; ``only_encoder`` as for V2."""
        feat_x, skip = self.backbone(x.to(self.cfg.compute_dtype))
        if only_encoder:
            return self.vlad_head(feat_x, only_encoder=True)
        score_loc = self.score_loc_head(feat_x)
        seg, feat, *depth = self.seg_head(feat_x, skip)
        if not self.training:
            seg = torch.softmax(seg, dim=1)
        out = {"score": torch.sigmoid(score_loc[:, 0:1]),
               "coord": torch.tanh(score_loc[:, 1:3]), "feat": feat,
               "seg": seg, "vlad": self.vlad_head(feat_x)}
        if depth:
            out["depth"] = torch.sigmoid(depth[0])
        return out


def build_model(cfg: KP2DTinyConfig) -> nn.Module:
    return KP2DTinyV3(cfg) if cfg.variant == "v3" else KP2DTinyV2(cfg)


def _lecun_normal_(w: torch.Tensor, fan_in: int,
                   generator: torch.Generator) -> None:
    """flax's lecun_normal: truncated normal (+-2 sd) scaled to variance
    1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


@torch.no_grad()
def init_model(cfg: KP2DTinyConfig, generator: torch.Generator,
               device: Optional[torch.device] = None) -> nn.Module:
    """A new model with weights drawn from ``generator`` (a CPU generator,
    so the draw is the same for every device), following the JAX package's
    initialisers: lecun-normal conv kernels (a depthwise kernel's fan_in
    is its 9 taps) and NetVLAD assignment, zero biases, unit BN, uniform
    [0, 1) centroids; LayerNorm's g = 1, b = 0 and GeM's p = 3 as the
    modules are built. Returns it in eval mode on ``device`` (default
    "cuda")."""
    dev = resolve_device(device)
    model = build_model(cfg)
    init_weights_(model, generator)
    return model.to(dev).eval()


@torch.no_grad()
def init_weights_(model: nn.Module, generator: torch.Generator) -> None:
    """``model``'s weights in place by the JAX package's initialisers (see
    ``init_model``)."""
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
            # Conv2d (O, I, kH, kW): fan_in I*kH*kW; ConvTranspose2d
            # (I, O, kH, kW): flax's fan_in of its (kH, kW, O, I) kernel is
            # O*kH*kW. Both are the product of dims 1-3.
            w = mod.weight
            _lecun_normal_(w, w.shape[1] * w.shape[2] * w.shape[3], generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.BatchNorm2d):
            mod.reset_parameters()
        elif isinstance(mod, NetVLAD):
            _lecun_normal_(mod.assign_w, mod.dim, generator)
            nn.init.uniform_(mod.centroids, 0.0, 1.0, generator=generator)
            if mod.assign_b is not None:
                mod.assign_b.zero_()
