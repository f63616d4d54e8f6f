"""Int8 execution, calibration, weight quantisation and QAT, the
counterpart of ``nanovs_slam_tpu/quant.py``.

- ``int8_execution(scales, chain)``: while the context is open,
  every ``ConvBNAct`` in eval mode whose flax path (``"backbone/conv1a"``,
  set on the block by ``modules.blocks.name_blocks``) has a calibrated
  input scale runs its conv as int8 x int8 -> int32: the input quantised
  as ``clip(round(x / scale_in), -127, 127)``, the weights per output
  channel as ``_quantize_kernel`` does, the sums rescaled by
  ``float32(scale_in) * s_w`` before the BatchNorm and the activation
  (in a bfloat16 model the BN's float32 affine is rounded to bf16 and the
  activation runs on bf16, as the JAX block at bf16 computes).
  It runs as the ``kernels.int8conv`` wrapper: the CUDA kernel for a CUDA
  tensor, its plain twin for a CPU one. With ``chain`` the producers of
  ``BACKBONE_CHAIN`` emit int8 (a ``QTensor``, NHWC) at their consumer's
  scale, the 2x2 max-pool between them fused into the producer's kernel.
- ``calibrate_conv_scales``: each block's input absmax / 127 over
  calibration batches, by forward pre-hooks on the ``ConvBNAct`` blocks.
- ``_quantize_kernel``, ``quantize_params_int8``, ``dequantize_params``,
  ``fake_quant_params``, ``int8_size_bytes``: numpy on flax-layout trees
  (``utils/convert.to_jax_variables``), copies of the JAX package's, so
  that their outputs are its outputs bit for bit.
- ``fake_quant_ste`` / ``qat_params``: QAT's straight-through fake
  quantisation of every flax ``kernel`` leaf, per its last axis (dim 0 of
  the torch weight).
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .utils.fuse import fold_bn_affine

_INT8_CTX: Dict[str, Optional[Dict[str, float]]] = {"scales": None,
                                                    "out_scales": None}


class QTensor:
    """An int8 activation (B, H, W, C), NHWC, and its scale, flowing
    between chained conv blocks: the producer quantises with its
    consumer's calibrated input scale, so the consumer reads int8 and
    skips its quantise pass."""

    __slots__ = ("values", "scale")

    def __init__(self, values: torch.Tensor, scale: float):
        self.values = values
        self.scale = scale


@contextmanager
def int8_execution(scales: Dict[str, float], chain: bool = False):
    """Int8 conv execution while open (see the module's docstring);
    ``chain`` adds int8 activation chaining over ``BACKBONE_CHAIN``."""
    prev = (_INT8_CTX["scales"], _INT8_CTX["out_scales"])
    _INT8_CTX["scales"] = dict(scales)
    _INT8_CTX["out_scales"] = (
        chain_out_scales(scales) if chain else None)
    try:
        yield
    finally:
        _INT8_CTX["scales"], _INT8_CTX["out_scales"] = prev


def active_int8_scale(path: str) -> Optional[float]:
    scales = _INT8_CTX["scales"]
    return None if scales is None else scales.get(path)


def active_int8_out_scale(path: str) -> Optional[float]:
    out_scales = _INT8_CTX["out_scales"]
    return None if out_scales is None else out_scales.get(path)


# Single-consumer edges of the backbone: producer -> consumer whose input
# scale is the producer's output scale (the max-pool and eval-mode dropout
# between them preserve values). conv3b feeds the heads' skip too and
# stays float32.
BACKBONE_CHAIN: Dict[str, str] = {
    "backbone/conv1a": "backbone/conv1b",
    "backbone/conv1b": "backbone/conv2a",
    "backbone/conv2a": "backbone/conv2b",
    "backbone/conv2b": "backbone/conv3a",
    "backbone/conv3a": "backbone/conv3b",
    "backbone/conv4a": "backbone/conv4b",
}


def chain_out_scales(scales: Dict[str, float]) -> Dict[str, float]:
    """{producer path: consumer input scale} for every edge of
    ``BACKBONE_CHAIN`` whose consumer has a calibrated scale."""
    return {prod: scales[cons] for prod, cons in BACKBONE_CHAIN.items()
            if cons in scales}


# ------------------------------------------------------- int8 conv blocks

def _block_plan(block: nn.Module, scale_in: float, dev: torch.device):
    """(wq (Cout, Kpad) int8 with K in (tap, channel) order, m = float32(
    scale_in) * s_w, a, b) of a ConvBNAct on ``dev``, computed on the host
    in numpy (so that the card and the CPU use the same numbers) and kept
    on the block until a weight, a BN tensor, the device or the scale
    changes."""
    tensors = (block.conv.weight, block.bn.weight, block.bn.bias,
               block.bn.running_mean, block.bn.running_var)
    key = (str(dev), float(scale_in)) + tuple(
        (t.data_ptr(), 0 if t.is_inference() else t._version)
        for t in tensors)
    cached = getattr(block, "_int8_plan", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    w, gamma, beta, mean, var = (t.detach().float().cpu().numpy()
                                 for t in tensors)
    q, s_w = _quantize_kernel(w.transpose(2, 3, 1, 0))  # HWIO, per O
    cout, cin = w.shape[:2]
    from .kernels.int8conv import padded_k  # kernels import modules.blocks

    wq = np.zeros((cout, padded_k(cin)), np.int8)
    wq[:, :9 * cin] = q.transpose(3, 0, 1, 2).reshape(cout, 9 * cin)
    m = np.float32(scale_in) * s_w.reshape(-1)
    a, b = fold_bn_affine(gamma, beta, mean, var, block.bn.eps)
    plan = tuple(torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                 for v in (wq, m, a, b))
    block._int8_plan = (key, plan)
    return plan


def quantize_activation(y: torch.Tensor, scale: float) -> QTensor:
    """A float32 or bfloat16 NCHW block output -> its int8 NHWC
    ``QTensor`` at ``scale``, dividing as the JAX package does (``x /
    scale``, not a product with the reciprocal)."""
    from .kernels.int8conv import true_divide

    q = torch.clamp(torch.round(true_divide(y.float(), scale)), -127,
                    127).to(torch.int8)
    return QTensor(q.permute(0, 2, 3, 1).contiguous(), scale)


def int8_block(block: nn.Module, x, scale_in: Optional[float],
               out_scale: Optional[float], pool: bool):
    """A ConvBNAct's forward under ``int8_execution``: an int8 conv where
    ``scale_in`` is given or ``x`` is a ``QTensor``, else its float
    forward; an int8 ``QTensor`` out at ``out_scale`` where the block is a
    chain's producer, 2x2 max-pooled where ``pool`` (in the kernel), else
    NCHW in the block's compute dtype. At bfloat16 the kernel reads a bf16
    input itself and rounds as the JAX block at bf16 does (a float32 BN
    rounded to bf16, the activation in bf16; ``kernels.int8conv``)."""
    from .kernels.int8conv import int8_conv3x3

    pre_q = isinstance(x, QTensor)
    if not pre_q and scale_in is None:  # a float producer of a chain
        y = block.act(block.bn(block.conv(x)))
        return quantize_activation(F.max_pool2d(y, 2, 2) if pool else y,
                                   out_scale)
    if pre_q:
        x, scale_in = x.values, x.scale
    else:  # quantised as it is, float32 or bfloat16, as the JAX block does
        x = x.contiguous()
    wq, m, a, b = _block_plan(block, scale_in, x.device)
    slope = 0.01 if isinstance(block.act, nn.LeakyReLU) else 0.0
    y = int8_conv3x3(x, wq, m, a, b, scale_in, slope, out_scale,
                     pool and out_scale is not None,
                     out_dtype=block.conv.compute_dtype)
    return y if out_scale is None else QTensor(y, out_scale)


# ------------------------------------------------------------ calibration

@torch.no_grad()
def calibrate_conv_scales(model: nn.Module, batches: Iterable,
                          max_batches: int = 100, **forward_kwargs
                          ) -> Dict[str, float]:
    """{flax path: absmax / 127} of every named ``ConvBNAct``'s float
    input (bfloat16 in a bf16 model, as the JAX package's ``sow`` reads
    it) over ``batches`` (each (B, H, W, 3) NHWC model input in [-1, 1],
    numpy or a tensor), the model in eval mode on its device, called with
    ``forward_kwargs`` (e.g. ``heads=`` of a V2 model; by default every
    head runs, as the JAX package's ``apply`` without ``heads=``). The
    fused stem stays off while the hooks observe conv1a and conv1b."""
    from .modules.blocks import ConvBNAct

    dev = next(model.parameters()).device
    maxima: Dict[str, float] = {}

    def hook(block, args):
        x = args[0]
        if not isinstance(x, QTensor):  # |x| exact in x's dtype (bf16 too)
            m = float(x.abs().amax())
            maxima[block.path] = max(maxima.get(block.path, 0.0), m)

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, ConvBNAct) and m.path]
    was_training = model.training
    model.eval()
    try:
        for i, batch in enumerate(batches):
            if i >= max_batches:
                break
            x = torch.as_tensor(np.asarray(batch, np.float32)) \
                if not torch.is_tensor(batch) else batch.float()
            model(x.to(dev).permute(0, 3, 1, 2).contiguous(),
                  **forward_kwargs)
    finally:
        for h in handles:
            h.remove()
        model.train(was_training)
    return {k: v / 127.0 for k, v in maxima.items()}


# ---------------------------------------- weights (flax-layout numpy trees)

def _quantize_kernel(w: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-output-channel symmetric int8. Conv kernels are HWIO (last dim
    = out channels); dense kernels are (in, out)."""
    axes = tuple(range(w.ndim - 1))
    absmax = np.max(np.abs(w), axis=axes, keepdims=True)
    scale = np.maximum(absmax, 1e-12) / 127.0
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)


def quantize_params_int8(params) -> Dict:
    """A tree mirroring ``params`` where each ``kernel`` leaf becomes
    {'q': int8 values, 'scale': float32 per-channel scales}; other leaves
    are kept as they are."""
    def walk(node):
        if isinstance(node, dict) or hasattr(node, "items"):
            out = {}
            for k, v in node.items():
                if k == "kernel" and hasattr(v, "ndim") and v.ndim >= 2:
                    q, s = _quantize_kernel(np.asarray(v))
                    out[k] = {"q": q, "scale": s}
                else:
                    out[k] = walk(v)
            return out
        return np.asarray(node)
    return walk(params)


def dequantize_params(qparams) -> Dict:
    def walk(node):
        if isinstance(node, dict):
            if set(node) == {"q", "scale"}:
                return (node["q"].astype(np.float32) * node["scale"]
                        ).astype(np.float32)
            return {k: walk(v) for k, v in node.items()}
        return node
    return walk(qparams)


def fake_quant_params(params) -> Dict:
    """Quantise -> dequantise: float32 params numerically identical to
    the int8 deployment."""
    return dequantize_params(quantize_params_int8(params))


def int8_size_bytes(qparams) -> int:
    """The bytes of every leaf of a (quantised) tree."""
    if isinstance(qparams, dict):
        return sum(int8_size_bytes(v) for v in qparams.values())
    return np.asarray(qparams).nbytes


# -------------------------------------------------------------------- QAT

def fake_quant_ste(w: torch.Tensor) -> torch.Tensor:
    """Per-output-channel (dim 0) symmetric int8 fake quantisation with a
    straight-through gradient: the forward sees the quantised weights,
    the gradient passes to ``w`` unchanged (``w + (q - w).detach()``, the
    JAX package's arithmetic)."""
    dims = tuple(range(1, w.dim()))
    absmax = w.detach().abs().amax(dim=dims, keepdim=True)
    scale = torch.clamp(absmax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(w / scale), -127, 127) * scale
    return w + (q - w).detach()


def qat_params(model: nn.Module) -> Dict[str, torch.Tensor]:
    """{name: fake_quant_ste(p)} for every parameter of ``model`` that is a
    flax ``kernel`` leaf (``utils/convert.kernel_parameters``): the
    parameters to substitute in a QAT forward
    (``torch.func.functional_call``)."""
    from .utils.convert import kernel_parameters

    return {k: fake_quant_ste(p)
            for k, p in kernel_parameters(model).items()}
