"""KP2DTiny V2 ("dedicated decoders") in PyTorch, the counterpart of
``KP2DTinyV2`` in ``nanovs_slam_tpu/models/kp2dtiny.py``.

Shared BackBone + five heads: score (sigmoid, 1 ch), loc (tanh, 2 ch),
dense descriptors (UpscaleHead), segmentation (SegmentationHead) and VPR
(VPRHead). The forward takes and returns NCHW tensors: score (B,1,Hc,Wc),
coord = tanh shift (B,2,Hc,Wc), feat (B,nfeat,Hs,Ws), seg logits
(B,nCls,Hs,Ws), vlad (B,D) with Hc = H/cell and Hs = 2*Hc.

Not ported yet: V3, attention heads, the depth head, GeM, ConvAP and
reduced-precision compute.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from ..configs import KP2DTinyConfig
from ..modules.aggregators import NetVLAD
from ..modules.backbone import BackBone
from ..modules.heads import SimpleTaskHead, UpscaleHead
from ..modules.segmentation import SegmentationHead
from ..modules.vpr import VPRHead
from ..utils.device import resolve_device

ALL_HEADS = ("score", "loc", "desc", "seg", "vlad")


class KP2DTinyV2(nn.Module):
    def __init__(self, cfg: KP2DTinyConfig):
        super().__init__()
        if cfg.variant != "v2":
            raise NotImplementedError("KP2DTinyV3 is not ported yet")
        if cfg.use_attention:
            raise NotImplementedError("attention heads are not ported yet")
        if cfg.depth:
            raise NotImplementedError("the depth head is not ported yet")
        if cfg.dtype != "float32":
            raise NotImplementedError("reduced-precision compute is not "
                                      "ported yet")
        self.cfg = cfg
        c1, c2, c3, c4, c5, d1 = cfg.channel_dims
        m, drop, leaky = cfg.bn_momentum, cfg.with_drop, cfg.leaky_relu
        up = cfg.upscale_method
        self.backbone = BackBone(c1, c2, c3, c4, cfg.downsample, drop, m,
                                 leaky)
        self.score_head = SimpleTaskHead(c4, c4, 1, m, drop, leaky)
        self.loc_head = SimpleTaskHead(c4, c4, 2, m, drop, leaky)
        self.desc_head = UpscaleHead(c4, c4, c4, c3 * 4, c4, cfg.nfeatures,
                                     drop, m, up, leaky)
        self.seg_head = SegmentationHead(c4, c4, c5, cfg.n_classes, d1, drop,
                                         m, up, leaky)
        self.vlad_head = VPRHead(c4, cfg.enc_dim, cfg.num_clusters, drop, m,
                                 cfg.remove_netvlad, leaky,
                                 cfg.global_descriptor_method)

    def forward(self, x: torch.Tensor, only_encoder: bool = False,
                heads: Sequence[str] = ALL_HEADS) -> Dict[str, torch.Tensor]:
        """x (B, 3, H, W) in [-1, 1]. ``heads`` selects the task heads to
        compute; ``only_encoder`` returns the L2-normalised dense VPR
        encoder map (for NetVLAD k-means init)."""
        unknown = set(heads) - set(ALL_HEADS)
        if unknown:
            raise ValueError(f"unknown heads {sorted(unknown)}")
        feat_x, skip = self.backbone(x)
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
        return out


def build_model(cfg: KP2DTinyConfig) -> nn.Module:
    return KP2DTinyV2(cfg)


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
    initialisers: lecun-normal conv kernels and NetVLAD assignment, zero
    biases, unit BN, uniform [0, 1) centroids. Returns it in eval mode on
    ``device`` (default "cuda")."""
    dev = resolve_device(device)
    model = build_model(cfg)
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
    return model.to(dev).eval()
