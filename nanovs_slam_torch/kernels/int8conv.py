"""Int8 3x3 convolution (stride 1, SAME) with BatchNorm and (Leaky)ReLU:
the conv block of int8 serving (``quant.int8_execution``).

``int8_conv3x3`` launches ``csrc/int8conv.cu`` (the kernel in
``csrc/int8conv.cuh``, its instances that stage a bf16 map in
``csrc/int8conv_bf16.cu``) for CUDA tensors and runs
``int8_conv3x3_plain`` for CPU tensors. It replaces no Pallas kernel: its
JAX counterpart is XLA's int8 convolution in
``nanovs_slam_tpu/quant.py::int8_conv`` (``lax.conv_general_dilated`` on
int8 with int32 results), and PyTorch has no int8 convolution on CUDA.

The function, for a block computing in ``out_dtype`` (float32 or
bfloat16) and an NCHW input x of that dtype (quantised as it loads) or an
int8 NHWC input (a chained producer's codes, already at ``scale_in``):

    xq  = clip(round(float32(x) / scale_in), -127, 127) (float32 division)
    acc = conv3x3(xq, wq)                               (int32, exact)
    v   = (float(acc) * m) * a + b,  m = float32(scale_in) * s_w
    v   = v if v > 0 else v * slope                     (float32)

At ``out_dtype`` bfloat16 the epilogue rounds where a bf16 block does (the
JAX package's: a float32 BatchNorm rounded to bf16, then the activation in
bf16, as ``nn.LeakyReLU`` rounds a bf16 tensor):

    v   = bf16((float(acc) * m) * a + b)
    v   = v if v > 0 else bf16(float32(v) * slope)

then ``out_dtype`` NCHW out, or ``clip(round(float32(v) / out_scale),
-127, 127)`` as int8 NHWC, 2x2 max-pooled (floor) where ``pool``. The
weights ``wq`` (Cout, Kpad) int8 hold K = 9 Cin in (tap, channel) order,
zero-padded to Kpad, a multiple of 32 (``padded_k``).

At config S's and N's widths bytes bound it. The kernel
(``csrc/int8conv.cuh`` says how) is an implicit GEMM on the tensor cores
in persistent blocks that keep their weights in shared memory, in one of
two designs, chosen by shape: 16-pixel tiles for the
latency-bound calls of under 3/4 of a wave of strips (the S8 request at
batch 1, its 60x80 and 30x40 maps at batch 8; ``wgmma`` s8 where a warp
has 64 or more channels, ``mma.sync`` below), and strips for the rest
(config N at batch 128, S8's wide maps at batch 8): whole rows
bulk-copied by a producer warp into a ring of stages, quantised once into
code planes that ``wgmma`` reads by descriptor (A and B from shared
memory, N = Cout), the output stored along W in 16-byte pieces
(``tools/int8_variants.py`` times both designs at every call).
``launch_shape`` reads the launch a call makes.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build
from .common import check_contiguous, device_of

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P, _I] + [_P] * 5 + [_I] * 8 + [_F] * 3 + [_P]
# out modes of the launcher
_FLOAT, _INT8, _INT8_POOL = 0, 1, 2
# input types of the launcher
_X_TYPES = {torch.float32: 0, torch.int8: 1, torch.bfloat16: 2}
BF16 = torch.bfloat16


def padded_k(cin: int) -> int:
    """The weights' row length: 9 Cin rounded up to a multiple of 32 (the
    depth of one int8 tensor-core product)."""
    return -(-9 * cin // 32) * 32


def true_divide(t: torch.Tensor, scale: float) -> torch.Tensor:
    """t / float32(scale) as a true division (a CUDA tensor divided by a
    Python scalar is multiplied by its reciprocal, which can move a code
    by one). The divisor is filled on the device: a copy from the host
    would wait for the device."""
    return t / torch.full((1,), scale, dtype=torch.float32, device=t.device)


def in_channels(x: torch.Tensor) -> int:
    """Cin of an input: dim 3 of int8 NHWC codes, dim 1 of float NCHW."""
    return x.shape[3] if x.dtype == torch.int8 else x.shape[1]


def int8_conv3x3_plain(x: torch.Tensor, wq: torch.Tensor, m: torch.Tensor,
                       a: torch.Tensor, b: torch.Tensor, scale_in: float,
                       slope: float, out_scale=None, pool: bool = False,
                       out_dtype: torch.dtype = torch.float32
                       ) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the integer conv in
    float64 (exact: |acc| <= 127^2 9 Cin < 2^53), then the kernel's
    epilogue, operation for operation (at bfloat16 rounding where the
    kernel rounds)."""
    if x.dtype == torch.int8:
        xq = x.permute(0, 3, 1, 2).double()
    else:  # a bf16 value widens to float32 exactly
        xq = torch.clamp(torch.round(true_divide(x.float(), scale_in)),
                         -127, 127).double()
    cout, cin = wq.shape[0], in_channels(x)
    w = wq[:, :9 * cin].reshape(cout, 3, 3, cin).permute(0, 3, 1, 2)
    acc = F.conv2d(xq, w.double(), padding=1).to(torch.int32)
    v = acc.float() * m.view(1, -1, 1, 1)
    v = v * a.view(1, -1, 1, 1) + b.view(1, -1, 1, 1)
    if out_dtype == BF16:
        v = v.to(BF16).float()
        v = torch.where(v > 0, v, v * slope).to(BF16)
    else:
        v = torch.where(v > 0, v, v * slope)
    if out_scale is None:
        return v.contiguous()
    q = torch.clamp(torch.round(true_divide(v.float(), out_scale)), -127,
                    127)
    if pool:
        q = F.max_pool2d(q, 2, 2)
    return q.to(torch.int8).permute(0, 2, 3, 1).contiguous()


def int8_conv3x3(x: torch.Tensor, wq: torch.Tensor, m: torch.Tensor,
                 a: torch.Tensor, b: torch.Tensor, scale_in: float,
                 slope: float, out_scale=None, pool: bool = False,
                 out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """x (B, Cin, H, W) NCHW of ``out_dtype``, or (B, H, W, Cin) int8
    NHWC; wq (Cout, padded_k(Cin)) int8; m, a, b (Cout,) float32;
    ``slope`` 0.01 (LeakyReLU) or 0 (ReLU); ``out_dtype`` float32 or
    bfloat16, the block's dtype (a float map's, where the epilogue rounds
    and the float output's); ``out_scale`` None for ``out_dtype`` (B, Cout,
    H, W) out, else int8 (B, H', W', Cout) NHWC with H' = H // 2 where
    ``pool`` (which needs ``out_scale``). Cout must be a multiple of 8. No
    autograd: int8 execution is inference only. A launch at bfloat16 is
    counted in ``launches_bf16``."""
    name = "int8_conv3x3"
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be 4-D, got {tuple(x.shape)}")
    int8_in = x.dtype == torch.int8
    if x.dtype not in _X_TYPES:
        raise TypeError(f"{name}: x must be float32, bfloat16 or int8, got "
                        f"{x.dtype}")
    if out_dtype not in (torch.float32, BF16):
        raise TypeError(f"{name}: out_dtype must be float32 or bfloat16, "
                        f"got {out_dtype}")
    if not int8_in and x.dtype != out_dtype:
        raise TypeError(f"{name}: a {x.dtype} map into a {out_dtype} block;"
                        " a block takes a map of its own dtype or int8 codes")
    B, cin = x.shape[0], in_channels(x)
    H, W = x.shape[1:3] if int8_in else x.shape[2:]
    cout = wq.shape[0]
    if (wq.dtype != torch.int8
            or tuple(wq.shape) != (cout, padded_k(cin))
            or any(t.shape != (cout,) or t.dtype != torch.float32
                   for t in (m, a, b))):
        raise ValueError(f"{name}: x {tuple(x.shape)} {x.dtype}, wq "
                         f"{tuple(wq.shape)} {wq.dtype}")
    if pool and out_scale is None:
        raise ValueError(f"{name}: the fused pool emits int8 only")
    dev = device_of(name, x, wq, m, a, b)
    if dev.type == "cpu":
        return int8_conv3x3_plain(x, wq, m, a, b, scale_in, slope,
                                  out_scale, pool, out_dtype)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, m, a, b)):
        raise RuntimeError(f"{name}: the CUDA kernel has no backward")
    check_contiguous(name, x=x, wq=wq, m=m, a=a, b=b)
    if cout % 8:
        raise ValueError(f"{name}: Cout={cout} is not a multiple of 8")
    if out_scale is None:
        mode = _FLOAT
        out = torch.empty((B, cout, H, W), device=dev, dtype=out_dtype)
    else:
        mode = _INT8_POOL if pool else _INT8
        ho, wo = (H // 2, W // 2) if pool else (H, W)
        out = torch.empty((B, ho, wo, cout), device=dev, dtype=torch.int8)
    fn = _build.bind("nvs_int8_conv3x3", _ARGTYPES)
    bf16 = out_dtype == BF16
    err = fn(x.data_ptr(), _X_TYPES[x.dtype], wq.data_ptr(), m.data_ptr(),
             a.data_ptr(), b.data_ptr(), out.data_ptr(), mode, int(bf16), B,
             H, W, cin, cout, padded_k(cin), scale_in,
             0.0 if out_scale is None else out_scale, slope,
             _build.stream_ptr(dev))
    _build.check(err, name)
    if bf16:
        int8_conv3x3.launches_bf16 += 1
    else:
        int8_conv3x3.launches += 1
    return out


int8_conv3x3.launches = 0
int8_conv3x3.launches_bf16 = 0

_SHAPE_KEYS = ("blocks_x", "blocks_y", "smem_bytes", "blocks_per_sm", "sms",
               "weights_resident", "k_chunk", "staged_channels",
               "chunks_a_tile", "channels_a_warp", "tile_rows", "design",
               "tile_cols", "stages", "warpgroups", "m_blocks")
DESIGNS = ("tiles", "strips")


def launch_shape(x: torch.Tensor, cout: int, out_scale=None,
                 pool: bool = False, out_dtype: torch.dtype = None) -> dict:
    """The launch ``int8_conv3x3`` makes for this input on the current
    card (nothing is launched): its ``design`` ("tiles", 16-pixel
    tiles, or "strips", the wide strips of calls with at least 3/4 of a
    wave of them: ``csrc/int8conv.cuh`` states the rule), the persistent grid
    (``blocks_x`` blocks walking the tiles, for each of ``blocks_y``
    channel groups), shared memory a block, blocks an SM, the card's SMs
    and the SMs the grid covers, whether the weights stay resident (else
    their K chunk; strips: the k-steps' depth), a float input's staged
    channels (strips: channels, or int8 rows, a chunk) and chunks a tile,
    a warp's channels (strips: a warpgroup's), the tile's rows and
    columns, the input's stages, the consumer warpgroups a block (strips:
    each fed by a producer warp of its own; 0 for tiles) and a strip's
    64-pixel m-blocks. ``out_dtype``: the block's (by default a float
    map's, float32 for int8 codes); a bf16 block takes instances of its
    own and stages a bf16 map as bf16."""
    int8_in = x.dtype == torch.int8
    if out_dtype is None:
        out_dtype = torch.float32 if int8_in else x.dtype
    B, cin = x.shape[0], in_channels(x)
    H, W = x.shape[1:3] if int8_in else x.shape[2:]
    mode = _FLOAT if out_scale is None else (_INT8_POOL if pool else _INT8)
    shape = (ctypes.c_int * len(_SHAPE_KEYS))()
    fn = _build.bind("nvs_int8_conv3x3_shape", [_I] * 9 + [_P])
    _build.check(fn(_X_TYPES[x.dtype], mode, int(out_dtype == BF16), B, H, W,
                    cin, cout, padded_k(cin), shape), "int8_conv3x3")
    out = dict(zip(_SHAPE_KEYS, shape))
    out["design"] = DESIGNS[out["design"]]
    out["sms_covered"] = min(out["sms"], out["blocks_x"] * out["blocks_y"])
    return out
