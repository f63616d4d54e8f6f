"""Conv + BatchNorm folding for inference.

At inference the BN affine transform folds into the preceding conv:

    w' = w * gamma / sqrt(var + eps)
    b' = beta - gamma * mean / sqrt(var + eps)

the rule of the JAX package's ``utils/fuse.fold_batchnorm``. The fused stem
kernel consumes the folded weights of the backbone's first two blocks
(``fold_conv_bn``); ``fold_batchnorm`` folds a whole flax-layout tree
(``utils/convert.to_jax_variables``), the JAX function's copy.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
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


def fold_bn_affine(gamma, beta, mean, var, eps: float
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Eval BatchNorm as a * y + b in float32 numpy: a = gamma / sqrt(var +
    eps), b = beta - mean * a (the JAX package's arithmetic, which its
    ``fold_batchnorm`` and bundle writer share)."""
    a = gamma / np.sqrt(var + np.float32(eps))
    return a.astype(np.float32), (beta - mean * a).astype(np.float32)


def fold_batchnorm(params: Dict, batch_stats: Dict, eps: float = 1e-5
                   ) -> Tuple[Dict, Dict]:
    """(folded params, batch_stats) of flax-layout numpy trees: every
    {conv: {kernel}, bn: {scale, bias}} pair with BN statistics gets the
    BN folded into its kernel (HWIO, the out dim last) and its bias, and
    the BN becomes the identity (scale 1, mean 0, var 1 - eps) plus that
    bias, so that the model applies unchanged."""

    def walk(p, s):
        if not isinstance(p, dict):
            return p, s
        p = dict(p)
        s = dict(s) if isinstance(s, dict) else {}
        if "conv" in p and "bn" in p and isinstance(p["conv"], dict) \
                and "kernel" in p["conv"] and "bn" in s:
            kernel = np.asarray(p["conv"]["kernel"], np.float32)
            gamma = np.asarray(p["bn"]["scale"], np.float32)
            beta = np.asarray(p["bn"]["bias"], np.float32)
            mean = np.asarray(s["bn"]["mean"], np.float32)
            var = np.asarray(s["bn"]["var"], np.float32)
            inv, bias = fold_bn_affine(gamma, beta, mean, var, eps)
            conv = dict(p["conv"])
            conv["kernel"] = kernel * inv
            p["conv"] = conv
            p["bn"] = {"scale": np.ones_like(gamma), "bias": bias}
            s["bn"] = {"mean": np.zeros_like(mean),
                       "var": np.ones_like(var) * (1.0 - eps)}
        for k in list(p.keys()):
            if isinstance(p[k], dict) and k not in ("conv", "bn"):
                p[k], sk = walk(p[k], s.get(k, {}))
                if k in s:
                    s[k] = sk
        return p, s

    return walk(params, batch_stats)
