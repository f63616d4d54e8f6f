"""Model information, the counterpart of ``nanovs_slam_tpu/utils/info.py``
(the reference's ``gather_info``)."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch.nn as nn

from ..configs import KP2DTinyConfig


def n_params(tree) -> int:
    """The number of values in a module's parameters, or in a (nested)
    dict / list of arrays or tensors (a flax tree: the JAX count)."""
    if isinstance(tree, nn.Module):
        return int(sum(p.numel() for p in tree.parameters()))
    if isinstance(tree, dict):
        return int(sum(n_params(v) for v in tree.values()))
    if isinstance(tree, (list, tuple)):
        return int(sum(n_params(v) for v in tree))
    return int(np.prod(tree.shape))


def gather_info(cfg: KP2DTinyConfig, params) -> Dict:
    """The reference's model summary: the constructor's arguments, the
    parameter counts (of ``params``: a model, whose trainable count is its
    parameters that require a gradient, or a tree) and the head options."""
    trainable = (int(sum(p.numel() for p in params.parameters()
                         if p.requires_grad))
                 if isinstance(params, nn.Module) else n_params(params))
    return {
        "init_args": {
            "nfeatures": cfg.nfeatures,
            "channel_dims": list(cfg.channel_dims),
            "downsample": cfg.downsample,
            "use_attention": cfg.use_attention,
            "leaky_relu": cfg.leaky_relu,
            "num_clusters": cfg.num_clusters,
            "encoder_dim": cfg.enc_dim,
            "nClasses": cfg.n_classes,
            "global_descriptor_method": cfg.global_descriptor_method,
            "upscale_method": cfg.upscale_method,
            "variant": cfg.variant,
        },
        "total_params": n_params(params),
        "trainable_params": trainable,
        "netvlad_dim": cfg.global_desc_dim,
        "upscale_method": cfg.upscale_method,
        "leaky_relu": cfg.leaky_relu,
        "use_attention": cfg.use_attention,
    }
