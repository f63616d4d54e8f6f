"""SegFormer-style attention block (NCHW), the counterpart of
``nanovs_slam_tpu/modules/attention.py``.

- ``ChannelLayerNorm``: over the channels with the reference's formula
  ``(x - mean) / (sqrt(biased var) + eps) * g + b`` (eps outside the
  square root, so not ``F.layer_norm``);
- ``EfficientSelfAttention``: q from a 1x1 conv, k and v from one r x r
  stride-r conv with 2C outputs (k first, then v; no biases; r = 2 in
  KP2DTiny, up to 8 in KeypointFormer's MiT), 4 heads (or the MiT stage's)
  as head-major channel groups, softmax over the keys, a 1x1 ``to_out``.
  The r x r stride-r conv is computed as one matmul over the r x r patches
  (the same function): PyTorch's CPU convolution at bfloat16 returns wrong
  values for an 8x8 stride-8 kernel (2.4 off on a 24x32 map whose float32
  values are about 1), where its matmul does not;
- ``MixFeedForward``: 1x1 expand, depthwise 3x3, pointwise 1x1, exact-erf
  GELU, 1x1 project (all with bias), expansion 2;
- ``SegFormerAttentionModule``: norm, attention, norm, mix-FF, with no
  residual connection (the trained weights expect none).

The attention is ``torch.matmul``, softmax, ``torch.matmul`` outside any
kernel, as the JAX package computes it: q k^T of the compute-dtype q and k
in float32 (flax's ``preferred_element_type=float32``), the softmax in
float32 and its weights rounded to the compute dtype, then their product
with v accumulated in float32 and rounded once to the compute dtype (flax
rounds it there too, as ``to_out`` casts its input). At bfloat16 the
LayerNorm's output is float32 (bf16 normalised values times the float32
``g``), as in flax.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .blocks import Conv2d


class ChannelLayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.g = nn.Parameter(torch.ones(dim))
        self.b = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=1, keepdim=True)
        var = x.var(dim=1, unbiased=False, keepdim=True)
        y = (x - mean) / (torch.sqrt(var) + self.eps)
        return y * self.g[:, None, None] + self.b[:, None, None]


class EfficientSelfAttention(nn.Module):
    """Spatially reduced self-attention over a feature map. On a slab of
    rows (``slabs`` set inside ``parallel.spatial.spatial_partition``) it
    attends over the whole map, gathered from the slabs, and keeps its
    slab's rows: the gather's backward sums the ranks' gradients."""

    slabs = None  # set inside ``spatial_partition``

    def __init__(self, dim: int, heads: int = 4, reduction_ratio: int = 2):
        super().__init__()
        self.heads = heads
        r = reduction_ratio
        self.to_q = Conv2d(dim, dim, 1, bias=False)
        self.to_kv = Conv2d(dim, 2 * dim, r, stride=r, bias=False)
        self.to_out = Conv2d(dim, dim, 1, bias=False)

    def _kv(self, x: torch.Tensor) -> torch.Tensor:
        """``to_kv`` (an r x r stride-r conv, no padding: floor at the
        edge) as a matmul over the r x r patches, in its compute dtype."""
        conv = self.to_kv
        dt = conv.compute_dtype
        B, C, H, W = x.shape
        r = conv.stride[0]
        Hr, Wr = H // r, W // r
        patches = x[:, :, :Hr * r, :Wr * r].to(dt).reshape(
            B, C, Hr, r, Wr, r).permute(0, 2, 4, 1, 3, 5).reshape(
            B, Hr * Wr, C * r * r)
        kv = patches @ conv.weight.to(dt).reshape(-1, C * r * r).t()
        return kv.transpose(1, 2).reshape(B, -1, Hr, Wr)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.slabs is None:
            return self._attend(x)
        full, rows = self.slabs.gather(x, 2, partial_grads=True)
        return self._attend(full)[:, :, rows]

    def _attend(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        h = self.heads
        dh = C // h
        k, v = self._kv(x).chunk(2, dim=1)

        def to_heads(t):  # (B, h*dh, H', W') -> (B, h, H'*W', dh)
            return t.reshape(B, h, dh, -1).transpose(2, 3)

        q, k, v = to_heads(self.to_q(x)), to_heads(k), to_heads(v)
        sim = torch.matmul(q.float(), k.float().transpose(2, 3)) * dh ** -0.5
        out = torch.matmul(sim.softmax(dim=-1).to(v.dtype), v)
        return self.to_out(out.transpose(2, 3).reshape(B, C, H, W))


class MixFeedForward(nn.Module):
    def __init__(self, dim: int, expansion_factor: int = 2):
        super().__init__()
        hidden = dim * expansion_factor
        self.expand = Conv2d(dim, hidden, 1)
        self.dw = Conv2d(hidden, hidden, 3, padding=1, groups=hidden)
        self.pw = Conv2d(hidden, hidden, 1)
        self.project = Conv2d(hidden, dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.pw(self.dw(self.expand(x)))
        return self.project(F.gelu(x))


class SegFormerAttentionModule(nn.Module):
    """norm, attention, norm, mix-FF; no residuals (see the module doc)."""

    def __init__(self, dim: int, heads: int = 4, reduction_ratio: int = 2):
        super().__init__()
        self.norm_att = ChannelLayerNorm(dim)
        self.att = EfficientSelfAttention(dim, heads, reduction_ratio)
        self.norm_mff = ChannelLayerNorm(dim)
        self.mff = MixFeedForward(dim, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mff(self.norm_mff(self.att(self.norm_att(x))))
