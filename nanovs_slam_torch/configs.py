"""Model configurations as frozen dataclasses.

The same registry as ``nanovs_slam_tpu/configs.py`` (config names S, S_A,
N, N_A, F, D, GEM_*, CONVAP_* for V2 and V3, and the derived quantities
cell = 2**downsample, cross_ratio = 2.0, encoder_dim default = c4), kept as
a copy so that the port does not import the JAX package. ``dtype`` is a
string; ``compute_dtype`` maps it to a torch dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class KP2DTinyConfig:
    """Architecture config for KP2DTinyV2 (dedicated decoders) and KP2DTinyV3
    (decoder fusion)."""

    name: str = "S"
    variant: str = "v2"  # "v2" (dedicated decoders) | "v3" (decoder fusion)
    nfeatures: int = 32
    channel_dims: Tuple[int, int, int, int, int, int] = (16, 32, 32, 64, 64, 128)
    bn_momentum: float = 0.1
    n_classes: int = 8
    num_clusters: int = 64
    downsample: int = 2
    use_attention: bool = False
    leaky_relu: bool = True
    encoder_dim: Optional[int] = None
    global_descriptor_method: str = "netvlad"  # netvlad | gem | convap
    upscale_method: str = "pixelshuffle"  # pixelshuffle | convtranspose (MCU)
    remove_netvlad: bool = False  # export mode: strip aggregation layer
    depth: bool = False
    with_drop: bool = True
    dtype: str = "float32"

    @property
    def cell(self) -> int:
        """Cell size of the keypoint grid."""
        return 2 ** self.downsample

    @property
    def cross_ratio(self) -> float:
        """Subpixel shift can cross cell borders by this factor."""
        return 2.0

    @property
    def c0(self) -> int:
        return 3

    @property
    def enc_dim(self) -> int:
        """Encoder dim of the VPR head (default c4)."""
        return self.encoder_dim if self.encoder_dim is not None else self.channel_dims[3]

    @property
    def global_desc_dim(self) -> int:
        """Output dim of the global descriptor."""
        if self.remove_netvlad:
            return 0
        if self.global_descriptor_method == "netvlad":
            return self.enc_dim * self.num_clusters
        if self.global_descriptor_method == "gem":
            return self.enc_dim * 16  # PixelUnshuffle(4) factor
        if self.global_descriptor_method == "convap":
            return self.enc_dim * 4 * 4
        raise ValueError(self.global_descriptor_method)

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    def replace(self, **kw) -> "KP2DTinyConfig":
        return dataclasses.replace(self, **kw)

    def to_mcu(self) -> "KP2DTinyConfig":
        """MCU deployment variant."""
        return self.replace(upscale_method="convtranspose", leaky_relu=False)

    def to_export(self) -> "KP2DTinyConfig":
        """Export variant: strip the VPR aggregation layer."""
        return self.replace(remove_netvlad=True)


_S_DIMS = (16, 32, 32, 64, 64, 128)
_N_DIMS = (16, 24, 24, 48, 48, 96)
_F_DIMS = (16, 32, 64, 128, 128, 256)
_D_DIMS = (64, 128, 128, 256, 256, 512)

V2_CONFIGS = {
    "S": KP2DTinyConfig(name="S", channel_dims=_S_DIMS, encoder_dim=64),
    "S_A": KP2DTinyConfig(name="S_A", channel_dims=_S_DIMS, encoder_dim=64,
                          use_attention=True),
    "N": KP2DTinyConfig(name="N", channel_dims=_N_DIMS, encoder_dim=48,
                        num_clusters=32),
    "N_A": KP2DTinyConfig(name="N_A", channel_dims=_N_DIMS, encoder_dim=48,
                          num_clusters=32, use_attention=True),
    "F": KP2DTinyConfig(name="F", channel_dims=_F_DIMS, nfeatures=64,
                        downsample=3),
    "D": KP2DTinyConfig(name="D", channel_dims=_D_DIMS, nfeatures=128,
                        encoder_dim=128, use_attention=True,
                        global_descriptor_method="convap"),
    "GEM_N": KP2DTinyConfig(name="GEM_N", channel_dims=_N_DIMS, encoder_dim=48,
                            num_clusters=32, global_descriptor_method="gem"),
    "GEM_S_A": KP2DTinyConfig(name="GEM_S_A", channel_dims=_S_DIMS,
                              encoder_dim=64, use_attention=True,
                              global_descriptor_method="gem"),
    "CONVAP_S_A": KP2DTinyConfig(name="CONVAP_S_A", channel_dims=_S_DIMS,
                                 encoder_dim=64, use_attention=True,
                                 global_descriptor_method="convap"),
}

V3_CONFIGS = {
    "S": KP2DTinyConfig(name="S", variant="v3", channel_dims=_S_DIMS,
                        encoder_dim=64),
    "S_A": KP2DTinyConfig(name="S_A", variant="v3", channel_dims=_S_DIMS,
                          encoder_dim=64, use_attention=True),
    "N": KP2DTinyConfig(name="N", variant="v3", channel_dims=_N_DIMS,
                        encoder_dim=48),
    "N_A": KP2DTinyConfig(name="N_A", variant="v3", channel_dims=_N_DIMS,
                          encoder_dim=48, use_attention=True),
    "D": KP2DTinyConfig(name="D", variant="v3", channel_dims=_D_DIMS,
                        nfeatures=128, encoder_dim=128,
                        global_descriptor_method="convap"),
    "D_A": KP2DTinyConfig(name="D_A", variant="v3", channel_dims=_D_DIMS,
                          nfeatures=128, encoder_dim=128, use_attention=True,
                          global_descriptor_method="convap"),
    "CONVAP_S_A": KP2DTinyConfig(name="CONVAP_S_A", variant="v3",
                                 channel_dims=_S_DIMS, encoder_dim=64,
                                 use_attention=True,
                                 global_descriptor_method="convap"),
}


def get_config(name: str, *, v3: bool = False, n_classes: int = 8,
               to_mcu: bool = False, to_export: bool = False,
               dtype: str = "float32", depth: bool = False) -> KP2DTinyConfig:
    """Look up a named config."""
    registry = V3_CONFIGS if v3 else V2_CONFIGS
    if name not in registry:
        raise ValueError(
            f"Config {name!r} not supported, choose from {sorted(registry)}")
    if dtype not in _DTYPES:
        raise ValueError(f"dtype {dtype!r} not supported, choose from "
                         f"{sorted(_DTYPES)}")
    cfg = registry[name].replace(n_classes=n_classes, dtype=dtype, depth=depth)
    if to_mcu:
        cfg = cfg.to_mcu()
    if to_export:
        cfg = cfg.to_export()
    return cfg
