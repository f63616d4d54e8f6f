"""Basic NN blocks (NCHW modules; the public functions take NHWC).

Counterparts of ``nanovs_slam_tpu/modules/blocks.py``:

- ``ConvBNAct``: 3x3 conv (no bias) + BatchNorm (eps 1e-5, torch momentum
  0.1) + LeakyReLU(0.01) or ReLU;
- ``Upsampler``: 2x upsample, ``pixelshuffle`` (``nn.PixelShuffle`` in NCHW
  has the channel ordering the JAX ``pixel_shuffle`` mirrors) or
  ``convtranspose`` (ConvTranspose k3 s2 p1 op1, c -> c//4, + BN + act);
- ``BatchNorm2d`` / ``BatchNorm1d``: ``nn.BatchNorm2d`` / ``1d`` whose train
  mode keeps flax's running statistics (see ``batch_norm_train``);
- ``Dropout2d``: channel dropout (whole channels, kept ones scaled by
  1/(1 - rate)) drawn from the ``generator`` that ``set_dropout`` gives it,
  a no-op in eval mode;
- ``synced_batch``: the context of a data-parallel forward, in which each
  rank holds a shard of the global batch: BatchNorm normalises with the
  global batch's statistics and dropout keeps the rank's rows of the
  global batch's mask;
- ``l2_normalize``: ``x / max(sqrt(sum(x^2) + eps^2), eps)``;
- ``pixel_unshuffle``: NHWC, the ordering of ``nn.PixelUnshuffle``;
- ``Conv2d`` / ``ConvTranspose2d``: the layers with a compute dtype.

Reduced precision follows flax, not autocast: parameters and BN statistics
stay float32, and every conv casts its input, weight and bias to its
``compute_dtype`` at use (flax's ``nn.Conv(dtype=...)``);
``set_compute_dtype`` sets it for a whole model. BatchNorm on a bfloat16
conv output is a float32 affine against the float32 statistics, rounded to
bfloat16 (``nn.BatchNorm2d`` computes so on a bfloat16 input), as flax's
``nn.BatchNorm(dtype=...)`` does.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import quant


def batch_norm_train(bn: nn.modules.batchnorm._BatchNorm, x: torch.Tensor,
                     dims) -> torch.Tensor:
    """BatchNorm in train mode with flax's running statistics: the output
    is normalised with the batch's mean and biased variance (as both
    frameworks do), and the running variance averages the *biased* batch
    variance (flax), not the unbiased one (``nn.BatchNorm``). ``momentum``
    is torch's: new = (1 - m) old + m batch. ``dims`` are the reduced
    dims of ``x``. Inside ``synced_batch`` the batch is the global one
    (``_synced_batch_norm``)."""
    if bn.batch_mesh is not None:
        return _synced_batch_norm(bn, x, dims, bn.batch_mesh)
    y = F.batch_norm(x, None, None, bn.weight, bn.bias, True, 0.0, bn.eps)
    with torch.no_grad():
        var, mean = torch.var_mean(x.float(), dim=dims, unbiased=False)
        bn.running_mean.lerp_(mean, bn.momentum)
        bn.running_var.lerp_(var, bn.momentum)
        bn.num_batches_tracked += 1
    return y


def _synced_batch_norm(bn, x: torch.Tensor, dims, mesh) -> torch.Tensor:
    """``batch_norm_train`` over the global batch of which ``x`` is this
    rank's part (channels on dim 1): a shard of the batch, or of a
    spatially partitioned batch a slab of rows, so the parts may differ in
    size. Each rank's count, per-channel mean and centred sum of squares
    are gathered (one collective, whose backward sums the ranks' partial
    gradients) and combined with their counts as Chan et al.'s parallel
    variance does; the output is the float32 affine of ``x`` against the
    global mean and biased variance, in ``x``'s dtype. The running
    statistics take the global ones, as on one device."""
    from ..parallel.mesh import gather_stats

    xf = x.float()
    shape = [1] * x.dim()
    shape[1] = x.shape[1]
    n_i = float(xf.numel() // x.shape[1])
    mean_i = xf.mean(dim=dims)
    m2_i = ((xf - mean_i.reshape(shape)) ** 2).sum(dim=dims)
    stats = gather_stats(mesh, torch.stack(
        [torch.full_like(mean_i, n_i), mean_i, m2_i])[None])
    n = stats[:, 0]
    total = n.sum(0)
    # the parts' weights n / total: 1 / size exactly for equal parts of a
    # power-of-two mesh, where this is the mean of the parts' means
    mean = (n / total * stats[:, 1]).sum(0)
    m2 = (stats[:, 2] + n * (stats[:, 1] - mean) ** 2).sum(0)
    var = m2 / total
    y = (xf - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape) + bn.eps)
    y = y * bn.weight.reshape(shape) + bn.bias.reshape(shape)
    with torch.no_grad():
        bn.running_mean.lerp_(mean, bn.momentum)
        bn.running_var.lerp_(var, bn.momentum)
        bn.num_batches_tracked += 1
    return y.to(x.dtype)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (NCHW) with flax's running statistics in train
    mode (``batch_norm_train``); eval mode is ``nn.BatchNorm2d``'s."""

    batch_mesh = None  # set inside ``synced_batch``

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        return batch_norm_train(self, x, (0, 2, 3))


class BatchNorm1d(nn.BatchNorm1d):
    """``nn.BatchNorm1d`` over the last dim of a (..., C) tensor, with
    flax's running statistics in train mode (``batch_norm_train``)."""

    batch_mesh = None  # set inside ``synced_batch``

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = x.shape
        x = x.reshape(-1, shape[-1])
        y = super().forward(x) if not self.training \
            else batch_norm_train(self, x, (0,))
        return y.reshape(shape)


class Dropout2d(nn.Module):
    """Channel dropout of NCHW maps: in train mode each (image, channel)
    is kept with probability 1 - rate and scaled by 1 / (1 - rate), else
    zeroed, as flax's ``Dropout(broadcast_dims=(1, 2))`` does in NHWC.
    The keep mask is drawn from ``generator`` (on the input's device; the
    device's default generator where it is None); inside ``synced_batch``
    it is the global batch's mask, of which the rank keeps its rows."""

    batch_mesh = None  # set inside ``synced_batch``

    def __init__(self, rate: float = 0.2):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if (not self.training or self.rate == 0.0
                or isinstance(x, quant.QTensor)):
            return x  # a chained int8 tensor only flows at inference
        keep = 1.0 - self.rate
        mesh, B = self.batch_mesh, x.shape[0]
        n = 1 if mesh is None else mesh.size
        mask = torch.empty((B * n,) + x.shape[1:2] + (1,) * (x.dim() - 2),
                           device=x.device, dtype=x.dtype)
        mask.bernoulli_(keep, generator=self.generator)
        if mesh is not None:
            mask = mask[mesh.rank * B:(mesh.rank + 1) * B]
        return x * mask / keep


def set_dropout(module: nn.Module, rate: Optional[float] = None,
                generator: Optional[torch.Generator] = None) -> None:
    """Every ``Dropout2d`` of ``module`` draws from ``generator`` from now
    on and, where ``rate`` is given, drops at that rate."""
    for m in module.modules():
        if isinstance(m, Dropout2d):
            m.generator = generator
            if rate is not None:
                m.rate = rate


@contextlib.contextmanager
def synced_batch(module: nn.Module, mesh):
    """Within the context, ``module``'s forwards in train mode take their
    input as this rank's equal shard (rows ``mesh.rank`` of ``mesh.size``)
    of a global batch: every BatchNorm normalises with, and keeps running
    averages of, the global batch's statistics, and every Dropout2d keeps
    the rank's rows of the mask it would draw for the global batch. The
    ranks' generators must be seeded alike."""
    mods = [m for m in module.modules()
            if isinstance(m, (BatchNorm2d, BatchNorm1d, Dropout2d))]
    for m in mods:
        m.batch_mesh = mesh
    try:
        yield
    finally:
        for m in mods:
            m.batch_mesh = None


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """x / max(||x||, eps) with the norm computed as sqrt(sum(x^2) + eps^2),
    the JAX package's formulation (finite gradient at x == 0)."""
    norm = torch.sqrt((x * x).sum(dim=dim, keepdim=True) + eps * eps)
    return x / torch.clamp(norm, min=eps)


def pixel_unshuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """NHWC (B, H*r, W*r, C) -> (B, H, W, C*r*r),
    out[b, h, w, c*r*r + i*r + j] = in[b, h*r+i, w*r+j, c]."""
    return F.pixel_unshuffle(x.permute(0, 3, 1, 2), r).permute(0, 2, 3, 1)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in ``compute_dtype`` (float32 until
    ``set_compute_dtype`` sets it); its parameters stay float32. Under
    ``parallel.spatial.spatial_partition`` (``slabs`` set) the input is
    this rank's slab of rows: a conv padded in height first takes the
    halo its rows read from the neighbouring slabs, then runs unpadded in
    height, so that it writes the rows ``SlabPlan.conv_rows`` gives the
    rank (a stride-1 conv: exactly the slab's rows)."""

    compute_dtype = torch.float32
    slabs = None  # set inside ``spatial_partition``

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        ph = self.padding[0]
        if self.slabs is None or not ph:
            return self._conv_forward(x.to(dt), self.weight.to(dt), bias)
        k, st = self.kernel_size[0], self.stride[0]
        top, bottom, rows, _, _ = self.slabs.conv_rows(x.shape[2], k, st, ph)
        if top or bottom:
            x = self.slabs.halo(x, top, bottom)
        return F.conv2d(x[:, :, rows].to(dt), self.weight.to(dt), bias,
                        self.stride, (0, self.padding[1]), self.dilation,
                        self.groups)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` (fixed output padding) computing in
    ``compute_dtype``, as ``Conv2d``. On a slab (``slabs`` set) the
    Upsampler's k3 s2 p1 op1 reads one row below the slab: it takes that
    row from the rank below (zeros below the map, as the full map's output
    padding sees), and keeps the slab's 2h output rows."""

    compute_dtype = torch.float32
    slabs = None  # set inside ``spatial_partition``

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        h = x.shape[2]
        if self.slabs is not None:
            if (self.kernel_size[0], self.stride[0], self.padding[0],
                    self.output_padding[0]) != (3, 2, 1, 1):
                raise ValueError("a slab takes the k3 s2 p1 op1 upsampler "
                                 "only")
            x = self.slabs.halo(x, 0, 1)
        y = F.conv_transpose2d(x.to(dt), self.weight.to(dt), bias,
                               self.stride, self.padding,
                               self.output_padding, self.groups,
                               self.dilation)
        return y if self.slabs is None else y[:, :, :2 * h]


def set_compute_dtype(module: nn.Module, dtype: torch.dtype) -> None:
    """Every conv of ``module`` computes in ``dtype`` from now on."""
    for m in module.modules():
        if isinstance(m, (Conv2d, ConvTranspose2d)):
            m.compute_dtype = dtype


def act(leaky: bool) -> nn.Module:
    return nn.LeakyReLU(0.01) if leaky else nn.ReLU()


class ConvBNAct(nn.Module):
    """Conv(3x3, no bias) + BatchNorm + (Leaky)ReLU.

    ``path`` is the block's flax path ("backbone/conv1a"; ``name_blocks``
    sets it), by which ``quant.int8_execution`` finds its scales: in eval
    mode under that context a block with an input scale, or given a
    chained ``QTensor``, runs its conv in int8 (``quant.int8_block``).
    """

    def __init__(self, c_in: int, c_out: int, bn_momentum: float = 0.1,
                 leaky_relu: bool = True):
        super().__init__()
        self.conv = Conv2d(c_in, c_out, 3, padding=1, bias=False)
        self.bn = BatchNorm2d(c_out, eps=1e-5, momentum=bn_momentum)
        self.act = act(leaky_relu)
        self.path = ""

    def forward(self, x, pool: bool = False):
        """``pool``: a 2x2 max-pool follows the block (after its dropout).
        A block that emits chained int8 pools in its kernel and returns the
        pooled ``QTensor``; otherwise the caller pools."""
        if not self.training:
            scale = quant.active_int8_scale(self.path)
            out_scale = quant.active_int8_out_scale(self.path)
            if (scale is not None or out_scale is not None
                    or isinstance(x, quant.QTensor)):
                return quant.int8_block(self, x, scale, out_scale, pool)
        return self.act(self.bn(self.conv(x)))


def name_blocks(model: nn.Module) -> None:
    """Set every ``ConvBNAct``'s ``path`` to its flax path under ``model``
    (the port keeps the flax module names: "seg_head.convs_0" ->
    "seg_head/convs_0")."""
    for name, m in model.named_modules():
        if isinstance(m, ConvBNAct):
            m.path = name.replace(".", "/")


class Upsampler(nn.Module):
    """Upscale by 2: C channels in, C//4 channels out at 2x resolution."""

    def __init__(self, in_features: int, method: str = "pixelshuffle",
                 bn_momentum: float = 0.1, leaky_relu: bool = True):
        super().__init__()
        self.method = method
        if method == "pixelshuffle":
            self.shuffle = nn.PixelShuffle(2)
        elif method == "convtranspose":
            self.transposed_conv = ConvTranspose2d(
                in_features, in_features // 4, 3, stride=2, padding=1,
                output_padding=1, bias=False)
            self.bn = BatchNorm2d(in_features // 4, eps=1e-5,
                                  momentum=bn_momentum)
            self.act = act(leaky_relu)
        else:
            raise NotImplementedError(f"upscale method {method}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.method == "pixelshuffle":
            return self.shuffle(x)
        return self.act(self.bn(self.transposed_conv(x)))
