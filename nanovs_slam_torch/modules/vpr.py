"""VPR head (NCHW), the counterpart of ``nanovs_slam_tpu/modules/vpr.py``:
convlad1 ConvBNAct [+ drop] -> convlad2 -> convlad3 -> the aggregator of
``method`` (NetVLAD, GeM or ConvAP), named ``netvlad`` whatever it is, as in
flax. ``only_encoder`` returns the L2-normalised dense map instead (for
k-means cluster init); ``remove_netvlad`` (export) the raw map, for the
netvlad method only, as in the JAX package. On a slab of rows (``slabs``
set inside ``parallel.spatial.spatial_partition``) the aggregator, which
pools over the whole map, takes the map gathered from the slabs; every
rank computes the same descriptor.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .aggregators import ConvAP, GeM, NetVLAD
from .blocks import ConvBNAct, Dropout2d, l2_normalize


class VPRHead(nn.Module):
    slabs = None  # set inside ``spatial_partition``

    def __init__(self, c_in: int, encoder_dim: int, num_clusters: int = 64,
                 with_drop: bool = True, bn_momentum: float = 0.1,
                 remove_netvlad: bool = False, leaky_relu: bool = True,
                 method: str = "netvlad"):
        super().__init__()
        kw = dict(bn_momentum=bn_momentum, leaky_relu=leaky_relu)
        self.remove_netvlad = remove_netvlad and method == "netvlad"
        self.convlad1 = ConvBNAct(c_in, encoder_dim, **kw)
        self.drop = Dropout2d(0.2) if with_drop else nn.Identity()
        self.convlad2 = ConvBNAct(encoder_dim, encoder_dim, **kw)
        self.convlad3 = ConvBNAct(encoder_dim, encoder_dim, **kw)
        if method == "netvlad":
            if not remove_netvlad:
                self.netvlad = NetVLAD(num_clusters, encoder_dim)
        elif method == "gem":
            self.netvlad = GeM(unshuffle=4)
        elif method == "convap":
            self.netvlad = ConvAP(encoder_dim, encoder_dim, 4, 4)
        else:
            raise ValueError(f"unknown global descriptor method {method}")

    def forward(self, x: torch.Tensor,
                only_encoder: bool = False) -> torch.Tensor:
        v = self.drop(self.convlad1(x))
        v = self.convlad3(self.convlad2(v))
        if self.remove_netvlad:
            return v
        if only_encoder:
            return l2_normalize(v, dim=1)
        if self.slabs is not None:
            v = self.slabs.gather(v, 2)[0]
        return self.netvlad(v)
