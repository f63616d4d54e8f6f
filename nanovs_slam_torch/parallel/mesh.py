"""Rank groups and the collectives of the port, the counterpart of
``nanovs_slam_tpu/parallel/mesh.py``.

A JAX mesh is a grid of devices that one program spans; XLA inserts the
collectives its shardings need. Here a ``Mesh`` is a grid of ranks (one
process each) with a process group along every axis, and the port calls
the collectives itself. Every collective is written from ``all_reduce``
and ``broadcast`` alone, so that it runs the same on NCCL, on gloo with CPU
tensors and on gloo with CUDA tensors (several ranks sharing one card,
where NCCL refuses and gloo serves CUDA tensors for those two only):

- ``all_reduce``: the sum over the group (a copy);
- ``broadcast``: rank 0's tensor on every rank (a copy; ``broadcast_``
  writes it into the tensor);
- ``all_gather_rows``: the ranks' equal shards concatenated along dim 0,
  as an all-reduce of zero-padded buffers (every entry has one
  contributor, so the gather is exact; bool travels as uint8 and 16-bit
  floats as float32);
- ``gather_batch`` / ``gather_stats``: the gather under autograd. The
  backward of ``gather_batch`` returns the rank's own rows of the
  gradient: its consumer runs the same computation on every rank (the loss
  tail on the global batch), so each rank already holds the whole
  gradient. That of ``gather_stats`` all-reduces the gradient first: each
  rank's consumer covers only its own rows (synced BatchNorm), so the
  ranks hold partial gradients;
- ``halo_rows`` / ``gather_slabs``: the exchanges of a map split over the
  ranks by height into slabs of rows (``parallel/spatial.py``), under
  autograd. ``halo_rows`` gives a rank its neighbours' edge rows (the
  halo a padded convolution reads), and its backward returns the halo's
  gradient to the rank that owns those rows; ``gather_slabs`` is the whole
  map from uneven slabs, its backward as ``gather_batch``'s or, for a
  consumer of which each rank keeps only its own rows, as
  ``gather_stats``'s.

A mesh of one rank without a process group makes every collective the
identity, so that the parallel paths also run in a plain process.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device

Tensor = torch.Tensor


@dataclasses.dataclass(eq=False)
class Mesh:
    """A grid of ranks. ``ranks``: the global ranks in mesh order; ``rank``:
    this process's index in it; ``group``: the process group over them
    (None for a one-rank mesh in a process without a group); ``axes``: the
    one-axis sub-mesh through this rank along each axis name."""
    group: Optional[Any]
    ranks: Tuple[int, ...]
    rank: int
    device: torch.device
    axis_names: Tuple[str, ...] = ("data",)
    shape: Tuple[int, ...] = (1,)
    axes: Dict[str, "Mesh"] = dataclasses.field(default_factory=dict)

    @property
    def size(self) -> int:
        return len(self.ranks)

    def axis(self, name: str) -> "Mesh":
        """The one-axis sub-mesh through this rank along ``name``."""
        if len(self.axis_names) == 1 and name == self.axis_names[0]:
            return self
        return self.axes[name]


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = ("data",),
              shape: Optional[Sequence[int]] = None, device=None
              ) -> Optional[Mesh]:
    """A mesh over the first ``n_devices`` ranks of the default group (all
    of them where None), 1-D by default; ``axis_names`` with their
    ``shape`` make an N-D mesh, ranks in row-major order (the last axis
    on neighbouring ranks, as the JAX ``make_mesh`` orders devices). Every rank of the
    default group must call it (``new_group`` is collective); a rank
    outside the mesh gets None. ``device``: this rank's device (default
    "cuda", the current card). Without a process group it is the one-rank
    mesh."""
    axis_names = tuple(axis_names)
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if not dist.is_initialized():
        if n_devices not in (None, 1) or (shape and int(np.prod(shape)) != 1):
            raise ValueError("a mesh of more than one rank needs a process "
                             "group (parallel.distributed.initialize)")
        return Mesh(None, (0,), 0, dev, axis_names,
                    (1,) * len(axis_names))
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n > world:
        raise ValueError(f"{n} ranks asked for, the group has {world}")
    if shape is None:
        if len(axis_names) > 1:
            raise ValueError("an N-D mesh needs its shape")
        shape = (n,)
    shape = tuple(int(s) for s in shape)
    if int(np.prod(shape)) != n or len(shape) != len(axis_names):
        raise ValueError(f"shape {shape} does not hold {n} ranks over "
                         f"axes {axis_names}")
    me = dist.get_rank()
    ranks = tuple(range(n))
    group = dist.group.WORLD if n == world else dist.new_group(list(ranks))
    grid = np.arange(n).reshape(shape)
    axes: Dict[str, Mesh] = {}
    if len(shape) > 1:
        for a, name in enumerate(axis_names):
            lines = np.moveaxis(grid, a, -1).reshape(-1, shape[a])
            for line in lines:  # every rank creates every group, in order
                sub = dist.new_group([int(r) for r in line])
                if me in line:
                    axes[name] = Mesh(sub, tuple(int(r) for r in line),
                                      int(np.where(line == me)[0][0]), dev,
                                      (name,), (shape[a],))
    if me >= n:
        return None
    return Mesh(group, ranks, me, dev, axis_names, shape, axes)


# ------------------------------------------------------------ collectives

def _wire(t: Tensor) -> Tensor:
    """A contiguous copy in a dtype every backend sums: bool as uint8,
    16-bit floats as float32 (exact both ways)."""
    if t.dtype == torch.bool:
        return t.to(torch.uint8)
    if t.dtype in (torch.bfloat16, torch.float16):
        return t.float()
    return t.clone(memory_format=torch.contiguous_format)


def all_reduce(mesh: Mesh, t: Tensor) -> Tensor:
    """The sum of ``t`` over the mesh's ranks, a new tensor in ``t``'s
    dtype (bool: the sum's truth)."""
    if mesh.group is None:
        return t.clone()
    out = _wire(t)
    dist.all_reduce(out, group=mesh.group)
    return out.to(t.dtype) if t.dtype != torch.bool else out > 0


def broadcast(mesh: Mesh, t: Tensor, src: int = 0) -> Tensor:
    """Mesh rank ``src``'s ``t`` on every rank (a new tensor)."""
    if mesh.group is None:
        return t.clone()
    out = _wire(t)
    dist.broadcast(out, src=mesh.ranks[src], group=mesh.group)
    return out.to(t.dtype) if t.dtype != torch.bool else out > 0


def broadcast_(mesh: Mesh, t: Tensor) -> Tensor:
    """Mesh rank 0's ``t`` written into ``t`` (no copy where the backend
    takes its dtype as it is); returns ``t``."""
    if mesh.group is None:
        return t
    if t.dtype in (torch.bool, torch.bfloat16, torch.float16) \
            or not t.is_contiguous():
        with torch.no_grad():
            t.copy_(broadcast(mesh, t))
    else:
        dist.broadcast(t.detach(), src=mesh.ranks[0], group=mesh.group)
    return t


def all_gather_rows(mesh: Mesh, t: Tensor) -> Tensor:
    """The ranks' shards, each (b, ...), as one (size * b, ...) tensor in
    rank order on every rank: an all-reduce of zero-padded buffers. The
    shards must have one shape."""
    if mesh.group is None:
        return t.clone()
    b, wire = t.shape[0], _wire(t)
    buf = wire.new_zeros((mesh.size * b,) + tuple(t.shape[1:]))
    buf[mesh.rank * b:(mesh.rank + 1) * b] = wire
    dist.all_reduce(buf, group=mesh.group)
    return buf.to(t.dtype) if t.dtype != torch.bool else buf > 0


def own_rows(mesh: Mesh, t: Tensor) -> Tensor:
    """This rank's rows of a (size * b, ...) tensor."""
    b = t.shape[0] // mesh.size
    return t[mesh.rank * b:(mesh.rank + 1) * b]


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, t, partial_grads):
        ctx.mesh, ctx.partial = mesh, partial_grads
        return all_gather_rows(mesh, t)

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:
            g = all_reduce(ctx.mesh, g)
        return None, own_rows(ctx.mesh, g), None


def gather_batch(mesh: Mesh, t: Tensor) -> Tensor:
    """``all_gather_rows`` under autograd, for a consumer that every rank
    runs alike on the whole result: the backward keeps the rank's rows of
    the gradient (no sum over ranks)."""
    return _Gather.apply(mesh, t, False)


def gather_stats(mesh: Mesh, t: Tensor) -> Tensor:
    """``all_gather_rows`` under autograd, for a consumer of which each
    rank runs only its own part (its rows of a synced BatchNorm): the
    backward sums the ranks' partial gradients, then keeps the rank's
    rows."""
    return _Gather.apply(mesh, t, True)


# ------------------------------------------------ exchanges between slabs

class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, x, top, bottom, zero_edges):
        r, n, h = mesh.rank, mesh.size, x.shape[2]
        k = max(top, bottom)
        if h < k:
            raise ValueError(f"a slab of {h} rows cannot lend a halo of {k}")
        up, down = r > 0, r < n - 1
        wire = _wire(x)
        buf = wire.new_zeros((n, 2) + tuple(x.shape[:2]) + (k, x.shape[3]))
        buf[r, 0], buf[r, 1] = wire[:, :, :k], wire[:, :, h - k:]
        if mesh.group is not None:
            dist.all_reduce(buf, group=mesh.group)
        buf = buf.to(x.dtype)
        zeros = x.new_zeros(tuple(x.shape[:2]) + (k, x.shape[3]))
        parts = []
        ctx.top = top if (up or zero_edges) else 0
        ctx.bottom = bottom if (down or zero_edges) else 0
        if ctx.top:
            parts.append((buf[r - 1, 1] if up else zeros)[:, :, k - top:])
        parts.append(x)
        if ctx.bottom:
            parts.append((buf[r + 1, 0] if down else zeros)[:, :, :bottom])
        ctx.mesh, ctx.k, ctx.h = mesh, k, h
        return torch.cat(parts, 2)

    @staticmethod
    def backward(ctx, g):
        mesh, k, h, top = ctx.mesh, ctx.k, ctx.h, ctx.top
        r, n = mesh.rank, mesh.size
        gx = _wire(g[:, :, top:top + h])
        buf = gx.new_zeros((n, 2) + tuple(g.shape[:2]) + (k, g.shape[3]))
        # the halo above came from the bottom rows of the rank above, the
        # one below from the top rows of the rank below
        if top and r > 0:
            buf[r - 1, 1, :, :, k - top:] = g[:, :, :top]
        if ctx.bottom and r < n - 1:
            buf[r + 1, 0, :, :, :ctx.bottom] = g[:, :, top + h:]
        if mesh.group is not None:
            dist.all_reduce(buf, group=mesh.group)
        gx[:, :, :k] += buf[r, 0]
        gx[:, :, h - k:] += buf[r, 1]
        return None, gx.to(g.dtype), None, None, None


def halo_rows(mesh: Mesh, x: Tensor, top: int, bottom: int,
              zero_edges: bool = True) -> Tensor:
    """x (B, C, h, W): this rank's slab of a map whose rows are split
    over the mesh's ranks in rank order. Returns the slab with the last
    ``top`` rows of the rank above prepended and the first ``bottom`` rows
    of the rank below appended: one all-reduce, in which every rank writes
    its edge rows into its place of a zeroed (ranks, 2, B, C, k, W)
    buffer. Beyond the map's first and last rows the halo is zeros (a
    convolution's zero padding) where ``zero_edges``, else left out. The
    backward adds the halo's gradient to the rows it came from (one
    all-reduce)."""
    return _Halo.apply(mesh, x, top, bottom, zero_edges)


class _GatherSlabs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, x, dim, start, height, partial_grads):
        wire = _wire(x)
        shape = list(x.shape)
        shape[dim] = height
        buf = wire.new_zeros(shape)
        buf.narrow(dim, start, x.shape[dim]).copy_(wire)
        if mesh.group is not None:
            dist.all_reduce(buf, group=mesh.group)
        ctx.mesh, ctx.dim, ctx.start, ctx.rows = mesh, dim, start, x.shape[dim]
        ctx.partial = partial_grads
        return buf.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:
            g = all_reduce(ctx.mesh, g)
        return (None, g.narrow(ctx.dim, ctx.start, ctx.rows), None, None,
                None, None)


def gather_slabs(mesh: Mesh, x: Tensor, dim: int, start: int, height: int,
                 partial_grads: bool = False) -> Tensor:
    """The whole map on every rank from the ranks' slabs along ``dim`` (of
    any heights; this rank's begins at row ``start`` of ``height``): an
    all-reduce of zero-padded buffers, exact. The backward returns this
    rank's rows of the gradient, after summing the ranks' gradients where
    ``partial_grads`` (each rank's consumer keeps only its own rows)."""
    return _GatherSlabs.apply(mesh, x, dim, start, height, partial_grads)


# ------------------------------------------------------- placing pytrees

def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    if isinstance(tree, (Tensor, np.ndarray)):
        return fn(tree)
    return tree


def replicate(mesh: Mesh, tree):
    """Rank 0's values on every rank, on the mesh's device: a tensor (in
    place where it lies on that device), an array (a new tensor), a module
    (its parameters and buffers, in place), a train state (its model's,
    inlier net's and optimizer state's, in place), or a dict / list /
    tuple of those."""
    import torch.nn as nn

    if isinstance(tree, nn.Module):
        tree.to(mesh.device)
        for t in list(tree.parameters()) + list(tree.buffers()):
            broadcast_(mesh, t)
        return tree
    if hasattr(tree, "optimizer") and hasattr(tree, "model"):
        replicate(mesh, tree.model)
        if tree.io_net is not None:
            replicate(mesh, tree.io_net)
        for st in tree.optimizer.state.values():
            for k, v in st.items():
                if isinstance(v, Tensor):
                    st[k] = broadcast_(mesh, v.to(mesh.device))
        return tree
    if isinstance(tree, (dict, list, tuple)):
        return type(tree)(replicate(mesh, v) for v in tree) \
            if not isinstance(tree, dict) \
            else {k: replicate(mesh, v) for k, v in tree.items()}
    if isinstance(tree, Tensor):
        return broadcast_(mesh, tree.to(mesh.device))
    if isinstance(tree, np.ndarray):
        return broadcast_(mesh, torch.tensor(tree, device=mesh.device))
    return tree


def shard_batch(mesh: Mesh, batch, dim: int = 0):
    """Every tensor or array of ``batch`` cut along ``dim`` (the batch)
    into ``mesh.size`` equal parts, this rank's part on the mesh's device.
    Raises ValueError where the batch does not divide."""
    def cut(x):
        x = torch.as_tensor(x)
        n = x.shape[dim]
        if n % mesh.size:
            raise ValueError(f"batch {n} not divisible by the mesh's "
                             f"{mesh.size} ranks")
        b = n // mesh.size
        return x.narrow(dim, mesh.rank * b, b).to(mesh.device)

    return _tree_map(cut, batch)
