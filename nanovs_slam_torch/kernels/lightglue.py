"""The LightGlue transformer stack: L layers of rotary self-attention and
bidirectional cross-attention, each followed by the cat-Linear-LayerNorm-
GELU-Linear FFN with a residual, on a batch of descriptor-set pairs.

``lightglue_transformer`` launches ``csrc/lightglue.cu`` for CUDA tensors
and runs ``lightglue_transformer_plain`` for CPU tensors. It replaces the
TPU kernel ``nanovs_slam_tpu/ops/pallas/lightglue_kernel.py::
fused_transformer``. The embedding before the stack and the assignment
after it stay in ``matching/lightglue.py``.

The weights go in as one ``(L, P)`` float32 tensor from ``pack_weights``:
per layer, the self block then the cross block, each laid out as
``[proj (D, T*D), proj bias (T*D), out proj (D, D), out bias (D),
fc1 (2D, 2D), fc1 bias, LN weight, LN bias (2D each), fc2 (2D, D),
fc2 bias (D)]`` with every matrix stored (in, out). The projection's
outputs are ordered (type, head, channel): q, k, v for self-attention
(T = 3), to_qk, to_v for cross-attention (T = 2).
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _build
from .common import check_contiguous, check_kernel_inputs, device_of

HEADS = 4
DIMS = (32, 64)  # descriptor widths of the kp2dtiny configs
# launches a layer: self attention, self FFN + cross projection, cross
# attention, cross FFN + the next layer's self projection; a call adds one,
# the first layer's self projection
KERNELS_PER_LAYER = 4
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_I, _I] + [_P] * 12 + [ctypes.c_longlong] + [_I] * 5 + [_P]

Tensor = torch.Tensor


def device_kernels(n_layers: int) -> int:
    """Device kernels one call over ``n_layers`` layers enqueues."""
    return KERNELS_PER_LAYER * n_layers + 1 if n_layers else 0


def _block_fields(D: int, T: int):
    return (("proj", (D, T * D)), ("proj_b", (T * D,)), ("wo", (D, D)),
            ("bo", (D,)), ("fc1", (2 * D, 2 * D)), ("b1", (2 * D,)),
            ("ln_g", (2 * D,)), ("ln_b", (2 * D,)), ("fc2", (2 * D, D)),
            ("b2", (D,)))


def _layout(D: int):
    """[(block, field, shape)] in packed order."""
    return [(blk, name, shape) for blk, T in (("self", 3), ("cross", 2))
            for name, shape in _block_fields(D, T)]


def packed_size(D: int) -> int:
    return sum(math.prod(s) for _, _, s in _layout(D))


def _unpack(packed_l: Tensor, D: int) -> Dict[str, Dict[str, Tensor]]:
    """One packed layer -> {"self": {field: view}, "cross": {...}}."""
    out, off = {"self": {}, "cross": {}}, 0
    for blk, name, shape in _layout(D):
        n = math.prod(shape)
        out[blk][name] = packed_l[off:off + n].view(shape)
        off += n
    return out


def pack_weights(sd: Mapping[str, Tensor], L: int, D: int) -> Tensor:
    """A LightGlue ``state_dict`` (the port's flax-named keys
    ``transformers_{l}.self_attn.Wqkv.weight`` ...) -> (L, P) float32.

    ``Wqkv`` keeps the reference's channel packing
    ``h*(DH*3) + j*3 + {q,k,v}``; it is reordered to (type, head, j)."""
    DH = D // HEADS
    perm = [(o % D) // DH * DH * 3 + (o % DH) * 3 + o // D
            for o in range(3 * D)]
    layers = []
    for l in range(L):
        p = f"transformers_{l}."
        sa, ca = p + "self_attn.", p + "cross_attn."
        wqkv = sd[sa + "Wqkv.weight"][perm]
        bqkv = sd[sa + "Wqkv.bias"][perm]
        wc = torch.cat([sd[ca + "to_qk.weight"], sd[ca + "to_v.weight"]])
        bc = torch.cat([sd[ca + "to_qk.bias"], sd[ca + "to_v.bias"]])
        parts = []
        for pre, w, b, wo in ((sa, wqkv, bqkv, "out_proj"),
                              (ca, wc, bc, "to_out")):
            f = pre + "ffn."
            parts += [w.t(), b, sd[pre + wo + ".weight"].t(),
                      sd[pre + wo + ".bias"], sd[f + "fc1.weight"].t(),
                      sd[f + "fc1.bias"], sd[f + "norm.weight"],
                      sd[f + "norm.bias"], sd[f + "fc2.weight"].t(),
                      sd[f + "fc2.bias"]]
        layers.append(torch.cat([t.reshape(-1) for t in parts]))
    packed = torch.stack(layers).float().contiguous()
    if packed.shape[1] != packed_size(D):
        raise ValueError(f"packed layer size {packed.shape[1]} != "
                         f"{packed_size(D)} for D={D}")
    return packed


# ------------------------------------------------------------- plain twin

def _heads(y: Tensor, t: int, D: int) -> Tensor:
    """(B, N, T*D) projection -> (B, H, N, DH) of output type t."""
    B, N, _ = y.shape
    return y[..., t * D:(t + 1) * D].reshape(B, N, HEADS, D // HEADS
                                             ).transpose(1, 2)


def _rotary(t: Tensor, cs: Tensor, sn: Tensor) -> Tensor:
    """Rotation of the interleaved (even, odd) pairs; cs/sn (B, N, DH/2)."""
    a, b = t[..., 0::2], t[..., 1::2]
    c, s = cs[:, None], sn[:, None]
    return torch.stack([a * c - b * s, b * c + a * s], -1).flatten(-2)


def _attend(q: Tensor, k: Tensor, v: Tensor,
            key_mask: Optional[Tensor]) -> Tensor:
    """Softmax attention over valid keys; a query with no valid key gets a
    zero context. -> (B, Nq, D) with the heads side by side."""
    sim = q @ k.transpose(-1, -2) * q.shape[-1] ** -0.5
    if key_mask is not None:
        m = key_mask[:, None, None, :]
        sim = sim.masked_fill(~m, -1e9)
    p = torch.softmax(sim, -1)
    if key_mask is not None:
        p = p * m.any(-1, keepdim=True)
    ctx = p @ v
    B, _, Nq, _ = ctx.shape
    return ctx.transpose(1, 2).reshape(B, Nq, -1)


def _ffn_residual(x: Tensor, ctx: Tensor, w: Dict[str, Tensor]) -> Tensor:
    msg = ctx @ w["wo"] + w["bo"]
    y = torch.cat([x, msg], -1) @ w["fc1"] + w["b1"]
    y = F.layer_norm(y, (y.shape[-1],), w["ln_g"], w["ln_b"], 1e-5)
    return x + F.gelu(y, approximate="none") @ w["fc2"] + w["b2"]


def lightglue_transformer_plain(x0: Tensor, x1: Tensor, cs0: Tensor,
                                sn0: Tensor, cs1: Tensor, sn1: Tensor,
                                mask0: Optional[Tensor],
                                mask1: Optional[Tensor], packed: Tensor,
                                layers: Sequence[int]
                                ) -> Tuple[Tensor, Tensor]:
    """The kernel's function in plain PyTorch, on the packed weights."""
    D = x0.shape[-1]
    for l in layers:
        w = _unpack(packed[l], D)
        s, c = w["self"], w["cross"]
        out = []
        for x, cs, sn, mask in ((x0, cs0, sn0, mask0), (x1, cs1, sn1, mask1)):
            y = x @ s["proj"] + s["proj_b"]
            q = _rotary(_heads(y, 0, D), cs, sn)
            k = _rotary(_heads(y, 1, D), cs, sn)
            out.append(_ffn_residual(x, _attend(q, k, _heads(y, 2, D), mask),
                                     s))
        x0, x1 = out
        y0 = x0 @ c["proj"] + c["proj_b"]
        y1 = x1 @ c["proj"] + c["proj_b"]
        qk0, v0 = _heads(y0, 0, D), _heads(y0, 1, D)
        qk1, v1 = _heads(y1, 0, D), _heads(y1, 1, D)
        x0, x1 = (_ffn_residual(x0, _attend(qk0, qk1, v1, mask1), c),
                  _ffn_residual(x1, _attend(qk1, qk0, v0, mask0), c))
    return x0, x1


# ----------------------------------------------------------------- wrapper

def lightglue_transformer(x0: Tensor, x1: Tensor, cs0: Tensor, sn0: Tensor,
                          cs1: Tensor, sn1: Tensor, mask0: Optional[Tensor],
                          mask1: Optional[Tensor], packed: Tensor,
                          layers: Optional[range] = None
                          ) -> Tuple[Tensor, Tensor]:
    """x0 (B,M,D), x1 (B,N,D) descriptors after the input projection;
    cs/sn (B,M,DH/2) and (B,N,DH/2) the rotary cos/sin (not repeated);
    mask0 (B,M), mask1 (B,N) bool validity or None; packed (L, P) from
    ``pack_weights``; ``layers`` a step-1 range of layer indices (default
    all L) -> the descriptors (B,M,D), (B,N,D) after those layers.

    H = 4 heads, D in {32, 64}, float32."""
    name = "lightglue_transformer"
    L = packed.shape[0]
    layers = range(L) if layers is None else layers
    if not isinstance(layers, range) or layers.step != 1 or \
            not 0 <= layers.start <= layers.stop <= L:
        raise ValueError(f"{name}: layers must be a step-1 range within "
                         f"[0, {L}], got {layers!r}")
    if x0.dim() != 3 or x1.dim() != 3 or x0.shape[0] != x1.shape[0] or \
            x0.shape[2] != x1.shape[2]:
        raise ValueError(f"{name}: shapes x0 {tuple(x0.shape)}, x1 "
                         f"{tuple(x1.shape)}")
    B, M, D = x0.shape
    N = x1.shape[1]
    if D % (2 * HEADS):
        raise ValueError(f"{name}: D={D} is not a multiple of {2 * HEADS}")
    half = D // HEADS // 2
    for arg, t, n in (("cs0", cs0, M), ("sn0", sn0, M), ("cs1", cs1, N),
                      ("sn1", sn1, N)):
        if tuple(t.shape) != (B, n, half):
            raise ValueError(f"{name}: {arg} shape {tuple(t.shape)} != "
                             f"{(B, n, half)}")
    for arg, t, n in (("mask0", mask0, M), ("mask1", mask1, N)):
        if t is not None and (t.dtype != torch.bool
                              or tuple(t.shape) != (B, n)):
            raise ValueError(f"{name}: {arg} must be bool {(B, n)}")
    if packed.dim() != 2 or packed.shape[1] != packed_size(D):
        raise ValueError(f"{name}: packed shape {tuple(packed.shape)}, "
                         f"expected (L, {packed_size(D)})")
    floats = dict(x0=x0, x1=x1, cs0=cs0, sn0=sn0, cs1=cs1, sn1=sn1,
                  packed=packed)
    masks = {k: m for k, m in (("mask0", mask0), ("mask1", mask1))
             if m is not None}
    dev = device_of(name, *floats.values(), *masks.values())
    if dev.type == "cpu":
        return lightglue_transformer_plain(x0, x1, cs0, sn0, cs1, sn1, mask0,
                                           mask1, packed, layers)
    check_kernel_inputs(name, **floats)
    check_contiguous(name, **floats, **masks)
    if D not in DIMS:
        raise ValueError(f"{name}: the kernel takes D in {DIMS}, got {D}")
    if packed.data_ptr() % 16:
        raise ValueError(f"{name}: packed must be 16-byte aligned")
    if B > 65535 // 2:
        raise ValueError(f"{name}: batch {B} > {65535 // 2}")
    o0 = torch.empty_like(x0)
    o1 = torch.empty_like(x1)
    scratch = torch.empty(4 * B * (M + N) * D, device=dev,
                          dtype=torch.float32)

    def ptr(t):
        return None if t is None else t.data_ptr()

    fn = _build.bind("nvs_lightglue_layers", _ARGTYPES)
    err = fn(layers.start, layers.stop, x0.data_ptr(), x1.data_ptr(),
             o0.data_ptr(), o1.data_ptr(), cs0.data_ptr(), sn0.data_ptr(),
             cs1.data_ptr(), sn1.data_ptr(), ptr(mask0), ptr(mask1),
             packed.data_ptr(), scratch.data_ptr(), packed.shape[1], B, M, N,
             D, int(lightglue_transformer.pdl), _build.stream_ptr(dev))
    _build.check(err, name)
    lightglue_transformer.launches += 1
    return o0, o1


lightglue_transformer.launches = 0
# programmatic dependent launch between the kernels of a call; False only to
# read per-kernel device times with a profiler (the results are the same)
lightglue_transformer.pdl = True
