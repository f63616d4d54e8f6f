"""LightGlue matcher in PyTorch, the counterpart of
``nanovs_slam_tpu/matching/lightglue.py`` (fixed shapes with boolean
validity masks; reference: lightglue/lightglue.py).

- keypoint normalisation, learnable Fourier positional encoding and the
  rotary on the interleaved (even, odd) pairs;
- per layer a self block (rotary qkv) and a cross block (shared ``to_qk``,
  bidirectional softmax), each with the cat([x, message]) FFN;
- matchability and the double-softmax log assignment, mutual-nearest
  filtering, token confidence and the value-level early exit.

Submodules keep the flax names (``transformers_{i}``, ``log_assignment_{i}``,
``token_confidence_{i}``, ``self_attn.Wqkv``, ``ffn.fc1/norm/fc2``,
``posenc.Wr``), so that ``utils/convert.load_jax_lightglue`` maps a flax
tree onto the ``state_dict`` by name. ``posenc.Wr`` keeps the flax layout
(2, head_dim/2).

On a CUDA device the float32 transformer stack runs through the
hand-written kernel (``kernels/lightglue.lightglue_transformer``): all
layers in one call at static depth, one layer per call with
``depth_confidence > 0``. On the CPU it runs the blocks below. The
embedding and the assignment tail are plain PyTorch on both.

``cfg.dtype = "bfloat16"`` computes as flax's ``dtype=bfloat16`` modules
do (``Dense`` and ``LayerNorm`` below): every Dense layer casts its input
and its float32 weights to bf16, its product rounded to bf16 before the
bias; the attention products take bf16 (or, after the rotary's float32
tables, float32) operands with float32 accumulation
(``preferred_element_type``); the masked softmax is cast to v's dtype; the
LayerNorm takes float32 statistics and rounds its output to bf16; a
float32 residual stream (the descriptors, when no input projection casts
them) stays float32 by type promotion, as in JAX. At bf16 the stack runs
these blocks on every device (``kernel_allowed``): the kernel is float32
only, as the Pallas one is, and the JAX package reaches no Pallas kernel
at bf16 either (XLA runs its modules), so this is a choice by dtype, not a
fallback.

Training (``forward(train=True)``) runs the stack's layers through the
plain blocks (``run_layer``) under autograd, on the card too: the JAX
trainer computes the stack in XLA (``LightGlue.__call__`` never reaches
``fused_transformer``, which has no VJP), so this is the JAX training
computation, not a fallback from the kernel (the rule
``modules/backbone.stem_kernel_allowed`` applies to the stem). It returns
every layer's log assignment stacked (``all_log_assignments``) and the
layers' descriptors (``ref_descriptors0/1``); ``assignment_at_layer``
recomputes layer i's assignment from stored descriptors for the loss
(``matching/loss.py``).
Host-staged adaptive depth is ``matching/adaptive.py``; width pruning,
which ``inference_forward`` runs for ``width_confidence > 0``, is
``matching/width_pruning.py``; both run one layer a kernel call.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..kernels.lightglue import (lightglue_transformer, pack_weights,
                                 split_weights)
from .configs import LightGlueConfig

Tensor = torch.Tensor
NEG_INF = -1e9


def normalize_keypoints(kpts: Tensor, size) -> Tensor:
    """(lightglue.py:134-145). kpts (B, N, 2); size (w, h) or (B, 2)."""
    size = torch.as_tensor(size, dtype=kpts.dtype, device=kpts.device)
    if size.dim() == 1:
        size = size[None]
    shift = size / 2.0
    scale = size.max(-1).values / 2.0
    return (kpts - shift[:, None, :]) / scale[:, None, None]


def rotate_half(x: Tensor) -> Tensor:
    x = x.unflatten(-1, (-1, 2))
    return torch.stack([-x[..., 1], x[..., 0]], -1).flatten(-2)


def apply_rotary(enc: Tuple[Tensor, Tensor], t: Tensor) -> Tensor:
    """enc = (cos, sin) each (B, 1, N, head_dim); t (B, H, N, head_dim)."""
    return t * enc[0] + rotate_half(t) * enc[1]


class FourierPositionalEncoding(nn.Module):
    """Learnable Fourier features -> rotary (cos, sin) pair (:158-171)."""

    def __init__(self, head_dim: int, in_dim: int = 2, gamma: float = 1.0):
        super().__init__()
        self.Wr = nn.Parameter(torch.empty(in_dim, head_dim // 2))
        nn.init.normal_(self.Wr, std=gamma ** -2)

    def tables(self, kpts: Tensor) -> Tuple[Tensor, Tensor]:
        """(cos, sin) each (B, N, head_dim/2), not repeated."""
        projected = kpts @ self.Wr
        return torch.cos(projected), torch.sin(projected)

    def forward(self, kpts: Tensor) -> Tuple[Tensor, Tensor]:
        """(cos, sin) each (B, 1, N, head_dim), repeat-interleaved."""
        return tuple(t.repeat_interleave(2, -1)[:, None]
                     for t in self.tables(kpts))


class Dense(nn.Linear):
    """``nn.Linear`` computing in ``compute_dtype`` as flax's ``nn.Dense(
    dtype=...)``: the input and the float32 weight cast to it, the
    product rounded to it, then the bias added in it (float32: exactly
    ``nn.Linear``)."""

    compute_dtype = torch.float32

    def forward(self, x: Tensor) -> Tensor:
        dt = self.compute_dtype
        if dt == torch.float32:
            return super().forward(x)
        y = F.linear(x.to(dt), self.weight.to(dt))
        return y if self.bias is None else y + self.bias.to(dt)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm``; at a reduced ``compute_dtype`` flax's
    ``nn.LayerNorm(dtype=...)``: the mean and the variance (E[x^2] -
    E[x]^2, clipped at 0) in float32, the float32 affine, the output
    rounded to the compute dtype."""

    compute_dtype = torch.float32

    def forward(self, x: Tensor) -> Tensor:
        if self.compute_dtype == torch.float32:
            return super().forward(x)
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean,
                          min=0.0)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight)
        return (y + self.bias).to(self.compute_dtype)


def _mm32(a: Tensor, b: Tensor) -> Tensor:
    """a @ b with float32 accumulation (``preferred_element_type``): the
    products of bf16 operands are exact in float32."""
    return a.float() @ b.float()


def masked_softmax(logits: Tensor, mask: Optional[Tensor], dim: int = -1
                   ) -> Tensor:
    """softmax with invalid entries masked out; fully-masked rows -> 0."""
    if mask is None:
        return torch.softmax(logits, dim)
    out = torch.softmax(logits.masked_fill(~mask, NEG_INF), dim)
    return out * mask.any(dim, keepdim=True)


class FFN(nn.Module):
    """cat([x, message]) -> Linear(2d) -> LayerNorm -> GELU -> Linear(d);
    the caller adds the residual (:249-254)."""

    def __init__(self, dim: int):
        super().__init__()
        self.fc1 = Dense(2 * dim, 2 * dim)
        self.norm = LayerNorm(2 * dim, eps=1e-5)
        self.fc2 = Dense(2 * dim, dim)

    def forward(self, x: Tensor, message: Tensor) -> Tensor:
        y = self.norm(self.fc1(torch.cat([x, message], -1)))
        return self.fc2(F.gelu(y, approximate="none"))


def _split_heads(t: Tensor, heads: int) -> Tensor:
    """(B, N, H*dh) -> (B, H, N, dh)."""
    return t.unflatten(-1, (heads, -1)).transpose(1, 2)


def _merge_heads(t: Tensor) -> Tensor:
    """(B, H, N, dh) -> (B, N, H*dh)."""
    return t.transpose(1, 2).flatten(-2)


class SelfBlock(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.Wqkv = Dense(dim, 3 * dim)
        self.out_proj = Dense(dim, dim)
        self.ffn = FFN(dim)

    def forward(self, x: Tensor, enc: Tuple[Tensor, Tensor],
                mask: Optional[Tensor] = None) -> Tensor:
        B, N, _ = x.shape
        h = self.heads
        # torch packing: channel = h * (dh * 3) + dh_idx * 3 + {q,k,v}; the
        # head width from the projection, so that a rank's share of the
        # heads (parallel/tp.py) runs this block unchanged
        qkv = self.Wqkv(x)
        dh = qkv.shape[-1] // (3 * h)
        qkv = qkv.reshape(B, N, h, dh, 3).transpose(1, 2)
        q, k, v = qkv[..., 0], qkv[..., 1], qkv[..., 2]
        q, k = apply_rotary(enc, q), apply_rotary(enc, k)
        sim = _mm32(q, k.transpose(-1, -2)) * dh ** -0.5
        key_mask = None if mask is None else mask[:, None, None, :]
        attn = masked_softmax(sim, key_mask).to(v.dtype)
        ctx = _merge_heads(_mm32(attn, v).to(x.dtype))
        return x + self.ffn(x, self.out_proj(ctx))


class CrossBlock(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.to_qk = Dense(dim, dim)
        self.to_v = Dense(dim, dim)
        self.to_out = Dense(dim, dim)
        self.ffn = FFN(dim)

    def forward(self, x0: Tensor, x1: Tensor, mask0: Optional[Tensor] = None,
                mask1: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
        h = self.heads
        qk0 = _split_heads(self.to_qk(x0), h)
        qk1 = _split_heads(self.to_qk(x1), h)
        s = qk0.shape[-1] ** -0.5  # the head width, as in SelfBlock
        v0 = _split_heads(self.to_v(x0), h)
        v1 = _split_heads(self.to_v(x1), h)
        sim = _mm32(qk0 * s ** 0.5, (qk1 * s ** 0.5).transpose(-1, -2))
        m1k = None if mask1 is None else mask1[:, None, None, :]
        m0k = None if mask0 is None else mask0[:, None, None, :]
        msg0 = _mm32(masked_softmax(sim, m1k).to(v1.dtype), v1)
        msg1 = _mm32(masked_softmax(sim.transpose(-1, -2), m0k).to(v0.dtype),
                     v0)
        msg0 = self.to_out(_merge_heads(msg0.to(x0.dtype)))
        msg1 = self.to_out(_merge_heads(msg1.to(x1.dtype)))
        return x0 + self.ffn(x0, msg0), x1 + self.ffn(x1, msg1)


class TransformerLayer(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.self_attn = SelfBlock(dim, heads)
        self.cross_attn = CrossBlock(dim, heads)

    def forward(self, desc0, desc1, enc0, enc1, mask0=None, mask1=None):
        desc0 = self.self_attn(desc0, enc0, mask0)
        desc1 = self.self_attn(desc1, enc1, mask1)
        return self.cross_attn(desc0, desc1, mask0, mask1)


def sigmoid_log_double_softmax(sim: Tensor, z0: Tensor, z1: Tensor,
                               mask0: Optional[Tensor] = None,
                               mask1: Optional[Tensor] = None) -> Tensor:
    """(:362-374) with validity masking of padded keypoints."""
    B, M, N = sim.shape
    if mask0 is not None:
        sim = sim.masked_fill(~mask0[:, :, None], NEG_INF)
    if mask1 is not None:
        sim = sim.masked_fill(~mask1[:, None, :], NEG_INF)
    certainties = F.logsigmoid(z0) + F.logsigmoid(z1).transpose(1, 2)
    scores = sim.new_zeros((B, M + 1, N + 1))
    scores[:, :M, :N] = (F.log_softmax(sim, 2) + F.log_softmax(sim, 1)
                         + certainties)
    scores[:, :-1, -1] = F.logsigmoid(-z0[..., 0])
    scores[:, -1, :-1] = F.logsigmoid(-z1[..., 0])
    return scores


class MatchAssignment(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim
        self.matchability = Dense(dim, 1)
        self.final_proj = Dense(dim, dim)

    def forward(self, desc0: Tensor, desc1: Tensor,
                mask0: Optional[Tensor] = None,
                mask1: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
        """-> (log assignment (B, M+1, N+1), sim)."""
        mdesc0 = self.final_proj(desc0) / self.dim ** 0.25
        mdesc1 = self.final_proj(desc1) / self.dim ** 0.25
        sim = _mm32(mdesc0, mdesc1.transpose(1, 2))
        z0 = self.matchability(desc0)
        z1 = self.matchability(desc1)
        return sigmoid_log_double_softmax(sim, z0, z1, mask0, mask1), sim


def filter_matches(scores: Tensor, th: float,
                   mask0: Optional[Tensor] = None,
                   mask1: Optional[Tensor] = None):
    """(:399-415); -> (m0, m1, mscores0, mscores1), fixed shapes, -1 = no
    match. Padded keypoints (mask False) never match."""
    inner = scores[:, :-1, :-1]
    max0, m0 = inner.max(2)
    m1 = inner.argmax(1)
    M, N = m0.shape[1], m1.shape[1]
    idx0 = torch.arange(M, device=scores.device)[None]
    idx1 = torch.arange(N, device=scores.device)[None]
    mutual0 = idx0 == torch.gather(m1, 1, m0)
    mutual1 = idx1 == torch.gather(m0, 1, m1)
    zero = scores.new_zeros(())
    mscores0 = torch.where(mutual0, max0.exp(), zero)
    mscores1 = torch.where(mutual1, torch.gather(mscores0, 1, m1), zero)
    valid0 = mutual0 & (mscores0 > th)
    valid1 = mutual1 & torch.gather(valid0, 1, m1)
    if mask0 is not None:
        valid0 = valid0 & mask0
        valid1 = valid1 & torch.gather(mask0, 1, m1)
    if mask1 is not None:
        valid0 = valid0 & torch.gather(mask1, 1, m0)
        valid1 = valid1 & mask1
    return (torch.where(valid0, m0, -1), torch.where(valid1, m1, -1),
            mscores0, mscores1)


class TokenConfidence(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.token = Dense(dim, 1)

    def forward(self, desc0: Tensor, desc1: Tensor) -> Tuple[Tensor, Tensor]:
        t0 = torch.sigmoid(self.token(desc0.detach()))[..., 0]
        t1 = torch.sigmoid(self.token(desc1.detach()))[..., 0]
        return t0, t1


def confidence_threshold(layer_index: int, n_layers: int) -> float:
    """(:613-616)"""
    return float(np.clip(0.8 + 0.1 * np.exp(-4.0 * layer_index / n_layers),
                         0, 1))


class LightGlue(nn.Module):
    def __init__(self, cfg: LightGlueConfig):
        super().__init__()
        dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
        if cfg.dtype not in dtypes:
            raise ValueError(f"LightGlue dtype {cfg.dtype}: float32 or "
                             "bfloat16")
        self.cfg = cfg
        d = cfg.descriptor_dim
        if cfg.input_dim != d:
            self.input_proj = Dense(cfg.input_dim, d)
        self.posenc = FourierPositionalEncoding(d // cfg.num_heads)
        for i in range(cfg.n_layers):
            self.add_module(f"transformers_{i}",
                            TransformerLayer(d, cfg.num_heads))
            self.add_module(f"log_assignment_{i}", MatchAssignment(d))
        for i in range(cfg.n_layers - 1):
            self.add_module(f"token_confidence_{i}", TokenConfidence(d))
        for m in self.modules():
            if isinstance(m, (Dense, LayerNorm)):
                m.compute_dtype = dtypes[cfg.dtype]
        self._packed: Optional[Tuple[tuple, Tensor, Optional[Tensor]]] = None

    # --- staged methods (as in the flax module) ---

    def embed(self, data: Dict[str, Tensor]):
        """Input projection + positional encoding."""
        desc0, desc1 = data["descriptors0"], data["descriptors1"]
        if self.cfg.input_dim != self.cfg.descriptor_dim:
            desc0, desc1 = self.input_proj(desc0), self.input_proj(desc1)
        enc0 = self.posenc(data["keypoints0"])
        enc1 = self.posenc(data["keypoints1"])
        return desc0, desc1, enc0, enc1

    def run_layer(self, i: int, desc0, desc1, enc0, enc1,
                  mask0=None, mask1=None):
        """One self+cross transformer layer, through the plain blocks on
        every device; ``run_layers(range(i, i + 1), ...)`` launches the
        kernel on a CUDA device."""
        return getattr(self, f"transformers_{i}")(desc0, desc1, enc0, enc1,
                                                  mask0, mask1)

    def stop_ratio(self, i: int, desc0, desc1) -> Tensor:
        """Confident-token ratio after layer i (reference check_if_stop,
        :627-638); early exit when this exceeds depth_confidence."""
        t0, t1 = getattr(self, f"token_confidence_{i}")(desc0, desc1)
        thr = confidence_threshold(i, self.cfg.n_layers)
        conf = torch.cat([t0, t1], -1)
        return 1.0 - (conf < thr).float().mean()

    def matchability(self, i: int, desc) -> Tensor:
        """sigmoid matchability of layer i's assigner (:577,583), the
        width-pruning keep signal; desc (B, N, D) -> (B, N)."""
        z = getattr(self, f"log_assignment_{i}").matchability(desc)
        return torch.sigmoid(z)[..., 0]

    def token_confidence(self, i: int, desc0, desc1):
        """TokenConfidence head i's outputs (width pruning never prunes a
        low-confidence point, :619-624)."""
        return getattr(self, f"token_confidence_{i}")(desc0, desc1)

    def finalize(self, i: int, desc0, desc1, mask0=None, mask1=None
                 ) -> Dict[str, Tensor]:
        """Assignment + match filtering with the EXIT layer's assigner
        (reference :560-563)."""
        scores, _ = getattr(self, f"log_assignment_{i}")(desc0, desc1,
                                                         mask0, mask1)
        m0, m1, ms0, ms1 = filter_matches(scores, self.cfg.filter_threshold,
                                          mask0, mask1)
        return {"matches0": m0, "matches1": m1, "matching_scores0": ms0,
                "matching_scores1": ms1, "log_assignment": scores}

    # --- the transformer stack on the card ---

    def packed_weights(self) -> Tensor:
        """The stack's weights in the kernel's layout, rebuilt when a
        parameter was replaced or changed in place."""
        return self._kernel_weights()[1]

    def split_weights(self) -> Optional[Tensor]:
        """At D = 256 on the card, the packed weights' TF32 fragments
        (``kernels.lightglue.split_weights``), made once with them; else
        None."""
        return self._kernel_weights()[2]

    def _kernel_weights(self) -> Tuple[tuple, Tensor, Optional[Tensor]]:
        params = [p for n, p in self.named_parameters()
                  if n.startswith("transformers_")]
        key = tuple((p.data_ptr(), p._version) for p in params)
        if self._packed is None or self._packed[0] != key:
            D = self.cfg.descriptor_dim
            with torch.no_grad():
                packed = pack_weights(self.state_dict(), self.cfg.n_layers, D)
                split = split_weights(packed) \
                    if D == 256 and packed.is_cuda else None
            self._packed = (key, packed, split)
        return self._packed

    def kernel_allowed(self, desc: Tensor) -> bool:
        """Whether the stack runs as the kernel for ``desc``: on a CUDA
        device at float32. At bf16 the blocks run on every device (the
        JAX package's bf16 LightGlue runs XLA's modules; the kernel, as
        the Pallas one, is float32 only): a choice by dtype, not a
        fallback."""
        return desc.device.type == "cuda" and self.cfg.dtype == "float32"

    def run_layers(self, layers: range, desc0, desc1, enc0, enc1,
                   mask0=None, mask1=None):
        """Layers ``layers`` of the stack: one call of the kernel where
        ``kernel_allowed``, else the plain blocks."""
        if not self.kernel_allowed(desc0):
            for i in layers:
                desc0, desc1 = self.run_layer(i, desc0, desc1, enc0, enc1,
                                              mask0, mask1)
            return desc0, desc1
        # the kernel takes the cos/sin tables before the repeat
        tables = [t[:, 0, :, 0::2].contiguous() for t in (*enc0, *enc1)]
        _, packed, split = self._kernel_weights()
        return lightglue_transformer(desc0.contiguous(), desc1.contiguous(),
                                     *tables, mask0, mask1, packed, layers,
                                     split)

    def forward(self, data: Dict[str, Tensor], train: bool = False
                ) -> Dict[str, Tensor]:
        """data: keypoints0/1 (B,M,2)/(B,N,2) NORMALIZED (see
        normalize_keypoints), descriptors0/1 (B,M,C)/(B,N,C), optional
        mask0/mask1 (B,M)/(B,N) bool validity. ``train`` returns every
        layer's descriptors and log assignment (see the module doc)."""
        cfg, L = self.cfg, self.cfg.n_layers
        mask0, mask1 = data.get("mask0"), data.get("mask1")
        desc0, desc1, enc0, enc1 = self.embed(data)
        if train:
            return self._train_forward(desc0, desc1, enc0, enc1, mask0,
                                       mask1)
        if cfg.depth_confidence > 0:
            # value-level early exit: once stopped, layers become no-ops
            stopped = torch.zeros((), dtype=torch.bool, device=desc0.device)
            for i in range(L):
                new0, new1 = self.run_layers(range(i, i + 1), desc0, desc1,
                                             enc0, enc1, mask0, mask1)
                desc0 = torch.where(stopped, desc0, new0)
                desc1 = torch.where(stopped, desc1, new1)
                if i < L - 1:
                    stopped = stopped | (self.stop_ratio(i, desc0, desc1)
                                         > cfg.depth_confidence)
        else:
            desc0, desc1 = self.run_layers(range(L), desc0, desc1, enc0,
                                           enc1, mask0, mask1)
        pred = self.finalize(L - 1, desc0, desc1, mask0, mask1)
        pred["ref_descriptors0"] = desc0[:, None]
        pred["ref_descriptors1"] = desc1[:, None]
        return pred

    def _train_forward(self, desc0, desc1, enc0, enc1, mask0, mask1
                       ) -> Dict[str, Tensor]:
        """Every layer through the plain blocks (no early exit), each
        layer's descriptors and log assignment kept (JAX ``__call__`` with
        ``train=True``)."""
        L = self.cfg.n_layers
        all_desc0, all_desc1, all_la = [], [], []
        for i in range(L):
            desc0, desc1 = self.run_layer(i, desc0, desc1, enc0, enc1,
                                          mask0, mask1)
            all_desc0.append(desc0)
            all_desc1.append(desc1)
            if i < L - 1:
                all_la.append(assignment_at_layer(self, i, desc0, desc1,
                                                  mask0, mask1))
        pred = self.finalize(L - 1, desc0, desc1, mask0, mask1)
        all_la.append(pred["log_assignment"])
        pred["ref_descriptors0"] = torch.stack(all_desc0, 1)
        pred["ref_descriptors1"] = torch.stack(all_desc1, 1)
        pred["all_log_assignments"] = torch.stack(all_la, 1)
        return pred


def assignment_at_layer(model: LightGlue, layer: int, desc0: Tensor,
                        desc1: Tensor, mask0: Optional[Tensor] = None,
                        mask1: Optional[Tensor] = None) -> Tensor:
    """Layer ``layer``'s log assignment (B, M+1, N+1) of stored
    descriptors (the deep-supervision loss re-runs it, reference loss
    :646-656)."""
    return getattr(model, f"log_assignment_{layer}")(desc0, desc1, mask0,
                                                     mask1)[0]


def inference_forward(model: LightGlue, data: Dict[str, Tensor]
                      ) -> Dict[str, Tensor]:
    """Config-dispatched inference entry (the JAX ``inference_forward``):
    ``cfg.width_confidence > 0`` runs ``width_pruning.
    engaged_width_forward`` (one keep-count read picks the bucket floor,
    so a fully matchable pair runs the plain forward); otherwise the
    module's forward. Host-staged adaptive depth stays an explicit opt-in
    (``matching/adaptive.py``)."""
    if model.cfg.width_confidence > 0:
        from .width_pruning import engaged_width_forward

        return engaged_width_forward(model, data,
                                     model.cfg.width_confidence)
    return model(data)
