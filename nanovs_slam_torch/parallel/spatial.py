"""Spatial partitioning of the KP2DTiny and KeypointFormer forwards over
image height, the counterpart of ``nanovs_slam_tpu/parallel/spatial.py``.

JAX annotates the input with a height sharding and lets GSPMD split every
convolution and insert the halo exchanges. Here each rank of the mesh's
spatial axis holds a slab of rows, and the port's modules make the
exchanges themselves inside ``spatial_partition`` (the context of a
spatial forward, as ``modules.blocks.synced_batch`` is of a data-parallel
one):

- the slabs (``slab_bounds``): height split at multiples of the model's
  slab unit (``slab_unit``) as evenly as that allows (the last ranks take
  the spare units, the last rank the remainder rows, so odd frames work).
  KP2DTiny's unit is ``2 * cell`` rows, because the segmentation head
  pools the 1/cell map once more: slabs at multiples of the cell alone
  would split that 2x2 pool between two ranks at an odd boundary.
  KeypointFormer's is 32 rows, the product of the MiT's stage strides (4,
  2, 2, 2), so that every stage's slab is whole; its frames must have H a
  multiple of 32 (``check_frame``). ValueError where ``H < unit * ranks``
  (GSPMD would pad);
- every convolution padded in height (``modules.blocks.Conv2d``: the 3x3
  convs, the mix-FF's depthwise 3x3, the MiT's strided patch embeds,
  KeypointFormer's strided heads) writes the output rows whose window
  centre lies in its slab (``SlabPlan.conv_rows``; rows above or below
  the map to the first or last rank): it takes the halo those rows read
  from the neighbouring slabs (``mesh.halo_rows``), then runs unpadded in
  height. KeypointFormer's VPR head opens with a 1x1 conv of stride 2 and
  pad 1, whose output row o reads input row 2o - 1: rank 0 also owns row
  0 (the bias alone), and the head's map is gathered from these rows,
  which do not overlap. The upsampler's transposed conv takes one row
  from below; max-pools, pixel shuffle and nearest upsampling stay local,
  the unit keeping them aligned;
- the fused stem kernel takes its slab extended by two input rows at each
  interior side and drops the pooled row each adds (``BackBone._stem``);
- the non-local parts run on the map gathered from the slabs
  (``mesh.gather_slabs``): the SegFormer and MiT attention (global
  attention over an r x r strided K / V), which keeps its slab's rows,
  and the VPR aggregator (NetVLAD, GeM, ConvAP's adaptive pool;
  KeypointFormer's vladv2 NetVLAD), whose descriptor every rank computes
  alike;
- in training, BatchNorm normalises over the whole mesh (data x spatial),
  combining the parts' statistics with their true counts (slabs can be
  uneven), and Dropout2d keeps the rows of the global draw at the rank's
  data-axis position, so that every slab of an image has its mask.

``spatial_forward`` runs the eval forward and gathers its outputs along
height over the spatial axis (JAX's ``out_shardings=rep``);
``make_spatial_infer_fn`` is ``inference.make_infer_fn`` over it, its
``post_process`` on the whole maps (the postprocess kernel on the card).
``spatial_train_step`` runs the train step over a (data, model) mesh: the
head outputs gathered along height and then over data, the loss tail on
the global batch on every rank, one gradient all-reduce over the whole
mesh.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from .data_parallel import IMAGES, DataParallel
from .mesh import (Mesh, all_gather_rows, gather_batch, gather_slabs,
                   halo_rows, replicate)

Tensor = torch.Tensor
# parameters that every rank of the spatial axis computes whole: the VPR
# aggregator (KP2DTiny's, KeypointFormer's) runs on the gathered map
AGGREGATOR = ("model.vlad_head.netvlad.", "model.netvlad.")
# KeypointFormer's slab unit: the product of the MiT's stage strides
MIT_UNIT = 32


def _is_keypoint_former(cfg) -> bool:
    from ..models.keypoint_former import KeypointFormerConfig

    return isinstance(cfg, KeypointFormerConfig)


def slab_unit(cfg) -> int:
    """The rows of a slab come in multiples of this: for KP2DTiny twice
    the model's cell (the segmentation head's pool of the 1/cell map), for
    KeypointFormer 32 (its fourth stage is at H/32)."""
    return MIT_UNIT if _is_keypoint_former(cfg) else 2 * cfg.cell


def check_frame(cfg, H: int, W: int) -> None:
    """Raise ValueError for a frame the model's slabs cannot take: a
    KeypointFormer frame the model refuses (``check_frame_size``), or
    whose H is not a multiple of 32 (the slabs' stage maps would not
    tile the whole map's)."""
    if not _is_keypoint_former(cfg):
        return
    from ..models.keypoint_former import check_frame_size

    check_frame_size(H, W)
    if H % MIT_UNIT:
        raise ValueError(f"KeypointFormer's spatial slabs need H a multiple "
                         f"of {MIT_UNIT}, got {H}")


def slab_bounds(H: int, ranks: int, unit: int) -> Tuple[int, ...]:
    """The first image row of each rank's slab, then H: whole units of
    ``unit`` rows shared out as evenly as they go (the last ranks take
    the spare units), the rows past the last whole unit to the last rank.
    Raises ValueError where a rank would get no unit."""
    units = H // unit
    if units < ranks:
        raise ValueError(f"{H} rows cannot be split over {ranks} ranks in "
                         f"slabs of at least {unit} rows")
    base, extra = divmod(units, ranks)
    counts = [base + (r >= ranks - extra) for r in range(ranks)]
    bounds = [0] + [int(c) * unit for c in np.cumsum(counts)]
    bounds[-1] = H
    return tuple(bounds)


@dataclasses.dataclass(eq=False)
class SlabPlan:
    """The slabs of one forward: ``mesh`` the spatial axis, ``bounds`` the
    image rows where its ranks' slabs begin, then H."""
    mesh: Mesh
    bounds: Tuple[int, ...]

    def _scale(self, h: int) -> int:
        """The power of two f with this rank's slab rows // f == h (every
        rank finds the same f: its slab holds at least one unit)."""
        r = self.mesh.rank
        rows, f = self.bounds[r + 1] - self.bounds[r], 1
        while rows // f > h:
            f *= 2
        if rows // f != h:
            raise ValueError(f"a slab of {h} rows is at no level of "
                             f"{rows} image rows")
        return f

    def level(self, h: int) -> Tuple[int, int]:
        """(this rank's first row, the map's rows) at the level of the
        model where this rank's slab has ``h`` rows (``_scale``)."""
        f = self._scale(h)
        return self.bounds[self.mesh.rank] // f, self.bounds[-1] // f

    def halo(self, x: Tensor, top: int, bottom: int,
             zero_edges: bool = True) -> Tensor:
        """``mesh.halo_rows`` on this plan's axis."""
        return halo_rows(self.mesh, x, top, bottom, zero_edges)

    def conv_rows(self, h: int, k: int, stride: int, pad: int
                  ) -> Tuple[int, int, slice, int, int]:
        """A convolution in height (kernel ``k``, ``stride``, zero pad
        ``pad``) of the map at the level where this rank's slab has ``h``
        rows. Output row o reads input rows stride * o - pad + [0, k); a
        rank writes the rows whose window centre (+ (k - 1) // 2) lies in
        its slab, the first rank also those above the map, the last those
        below. Returns (top, bottom, rows, lo, total): the halo every rank
        takes above and below its slab (alike on every rank: one
        collective), the rows of the extended slab that this rank's
        windows read, this rank's first output row and the output's
        rows."""
        n, r, f = self.mesh.size, self.mesh.rank, self._scale(h)
        starts = [b // f for b in self.bounds]
        rows = starts[-1]
        total = (rows + 2 * pad - k) // stride + 1
        c = (k - 1) // 2

        def first_out(i):  # the first output row rank i writes
            if i == 0:
                return 0
            if i == n:
                return total
            return -(-(starts[i] + pad - c) // stride)

        tops, bottoms = [], []
        for i in range(n):
            lo, hi = first_out(i), first_out(i + 1)
            tops.append(starts[i] - (stride * lo - pad))
            bottoms.append(stride * (hi - 1) - pad + k - starts[i + 1])
        top, bottom = max(0, *tops), max(0, *bottoms)
        lo, hi = first_out(r), first_out(r + 1)
        skip = top - tops[r]
        return (top, bottom, slice(skip, skip + stride * (hi - lo - 1) + k),
                lo, total)

    def gather_rows(self, x: Tensor, dim: int, start: int, height: int,
                    partial_grads: bool = False) -> Tensor:
        """``mesh.gather_slabs`` of rows ``start:start + x.shape[dim]`` of
        a map of ``height`` rows (rows that are no level's slab)."""
        return gather_slabs(self.mesh, x, dim, start, height, partial_grads)

    def gather(self, x: Tensor, dim: int, partial_grads: bool = False
               ) -> Tuple[Tensor, slice]:
        """(the whole map from the slabs along ``dim``, this rank's rows
        of it) (``mesh.gather_slabs``)."""
        start, height = self.level(x.shape[dim])
        full = gather_slabs(self.mesh, x, dim, start, height, partial_grads)
        return full, slice(start, start + x.shape[dim])


@contextlib.contextmanager
def spatial_partition(model: nn.Module, plan: SlabPlan,
                      data: Optional[Mesh] = None,
                      batch: Optional[Mesh] = None):
    """Within the context ``model``'s forwards take this rank's slab of
    ``plan`` (see the module doc). In train mode, ``batch``: the mesh over
    which BatchNorm takes its statistics (all the ranks holding parts of
    the global batch); ``data``: the data axis, whose position picks the
    rank's rows of Dropout2d's global draw (None: one data row)."""
    from ..models.keypoint_former import KeypointFormer
    from ..modules.attention import EfficientSelfAttention
    from ..modules.backbone import BackBone
    from ..modules.blocks import (BatchNorm2d, Conv2d, ConvTranspose2d,
                                  Dropout2d)
    from ..modules.vpr import VPRHead

    slabbed = (Conv2d, ConvTranspose2d, EfficientSelfAttention, VPRHead,
               BackBone, KeypointFormer)
    mods = list(model.modules())
    for m in mods:
        if isinstance(m, slabbed):
            m.slabs = plan
        if isinstance(m, BatchNorm2d):
            m.batch_mesh = batch
        if isinstance(m, Dropout2d):
            m.batch_mesh = data
    try:
        yield
    finally:
        for m in mods:
            if isinstance(m, slabbed):
                m.slabs = None
            if isinstance(m, (BatchNorm2d, Dropout2d)):
                m.batch_mesh = None


def _check_model(model: nn.Module):
    from ..configs import KP2DTinyConfig

    cfg = getattr(model, "cfg", None)
    if not (isinstance(cfg, KP2DTinyConfig) or _is_keypoint_former(cfg)):
        raise ValueError("spatial partitioning takes a KP2DTiny or a "
                         "KeypointFormer model")
    return cfg


def _data_rows(data: Optional[Mesh], x: Tensor) -> Tensor:
    if data is None:
        return x
    if x.shape[0] % data.size:
        raise ValueError(f"batch {x.shape[0]} not divisible by the data "
                         f"axis's {data.size} ranks")
    b = x.shape[0] // data.size
    return x.narrow(0, data.rank * b, b)


def _axes(mesh: Mesh, batch_axis: Optional[str], spatial_axis: str):
    data = mesh.axis(batch_axis) if batch_axis else None
    return data, mesh.axis(spatial_axis)


def spatial_forward(mesh: Mesh, model: nn.Module,
                    variables: Optional[Dict[str, Tensor]] = None, *,
                    batch_axis: Optional[str] = None,
                    spatial_axis: str = "model",
                    heads: Optional[Sequence[str]] = None) -> Callable:
    """``run(images)``: ``model``'s eval forward with the images' height
    split over ``mesh``'s ``spatial_axis`` (and their batch over
    ``batch_axis`` where given), its outputs gathered to the whole batch
    and maps on every rank, NHWC as the JAX apply returns them.
    ``variables``: a state dict loaded into the model first (None: its
    own weights); rank 0's weights are then broadcast to every rank.
    ``heads``: V2's heads to compute (default all; V3 and KeypointFormer
    compute every head). images: (B, H, W, 3) model input in [-1, 1], the
    global batch (a tensor on any device, or an array)."""
    from ..configs import KP2DTinyConfig

    cfg = _check_model(model)
    data, sp = _axes(mesh, batch_axis, spatial_axis)
    if variables is not None:
        model.load_state_dict(variables)
    replicate(mesh, model)
    model.eval()
    v2 = isinstance(cfg, KP2DTinyConfig) and cfg.variant != "v3"
    kw = {"heads": heads} if v2 and heads is not None else {}

    @torch.inference_mode()
    def run(images) -> Dict[str, Tensor]:
        x = _data_rows(data, torch.as_tensor(images))
        if x.dim() != 4:
            raise ValueError(f"images must be (B, H, W, 3), got "
                             f"{tuple(x.shape)}")
        check_frame(cfg, x.shape[1], x.shape[2])
        plan = SlabPlan(sp, slab_bounds(x.shape[1], sp.size,
                                        slab_unit(cfg)))
        r = sp.rank
        x = x[:, plan.bounds[r]:plan.bounds[r + 1]].to(mesh.device)
        with spatial_partition(model, plan):
            out = model(x.permute(0, 3, 1, 2).contiguous(), **kw)
        res = {}
        for k, v in out.items():
            if v.dim() == 4:
                v = plan.gather(v, 2)[0].permute(0, 2, 3, 1)
            res[k] = v if data is None else all_gather_rows(data, v)
        return res

    return run


def make_spatial_infer_fn(mesh: Mesh, model: nn.Module, cfg, H: int, W: int,
                          top_k: Optional[int] = None,
                          conf_threshold: float = 0.0, with_seg: bool = True,
                          with_vlad: bool = True,
                          batch_axis: Optional[str] = None,
                          spatial_axis: str = "model"
                          ) -> Callable[[Tensor], Dict[str, Tensor]]:
    """``inference.make_infer_fn``'s ``infer`` with the forward spatially
    partitioned over ``mesh`` (``spatial_forward``): every rank normalises
    the frames, runs its slab, gathers the maps and post-processes them
    whole. The same frames, arguments and result on every rank; the model
    runs on the mesh's device."""
    from ..inference import request_heads, request_result
    from ..ops.image import to_model_input
    from ..ops.postprocess import post_process

    run = spatial_forward(mesh, model, batch_axis=batch_axis,
                          spatial_axis=spatial_axis,
                          heads=request_heads(cfg, with_seg, with_vlad))

    @torch.inference_mode()
    def infer(images) -> Dict[str, Tensor]:
        if isinstance(images, np.ndarray):
            images = torch.from_numpy(images)
        if tuple(images.shape[1:]) != (H, W, 3):
            raise ValueError(f"images must be (B, {H}, {W}, 3), got "
                             f"{tuple(images.shape)}")
        x = to_model_input(images.to(mesh.device, non_blocking=True))
        post = post_process(run(x), H, W, cfg.cell, cfg.cross_ratio,
                            eval_mode=True)
        return request_result(post, with_seg, with_vlad, top_k,
                              conf_threshold)

    return infer


class SpatialParallel(DataParallel):
    """The hooks ``make_train_step(parallel=...)`` calls for a step over a
    mesh of a data axis and a spatial axis (see the module doc). ``place``
    cuts a global batch into this rank's part and sets the step's slabs
    from its images' height."""

    def __init__(self, mesh: Mesh, cfg, batch_axis: Optional[str] = "data",
                 spatial_axis: str = "model", timing: bool = False):
        super().__init__(mesh, timing)
        self.cfg = cfg
        self.mesh = mesh  # the gradient all-reduce spans the whole mesh
        self.data, self.spatial = _axes(
            mesh, batch_axis if batch_axis in mesh.axis_names else None,
            spatial_axis)
        self.unit = slab_unit(cfg)
        self.plan: Optional[SlabPlan] = None

    def place(self, batch: Dict) -> Dict[str, Tensor]:
        """This rank's rows of the global batch on the mesh's device, the
        images (B, H, W, 3) also cut to its slab of rows."""
        out = {k: _data_rows(self.data, torch.as_tensor(v))
               for k, v in batch.items()}
        H = out[IMAGES[0]].shape[1]
        check_frame(self.cfg, H, out[IMAGES[0]].shape[2])
        self.plan = SlabPlan(self.spatial, slab_bounds(H, self.spatial.size,
                                                       self.unit))
        b, r = self.plan.bounds, self.spatial.rank
        return {k: (v[:, b[r]:b[r + 1]] if k in IMAGES else v).to(
            self.mesh.device) for k, v in out.items()}

    def forwards(self, model) -> contextlib.AbstractContextManager:
        return spatial_partition(model, self.plan, self.data, self.mesh)

    def gather_outputs(self, out: Dict[str, Tensor]) -> Dict[str, Tensor]:
        res = {}
        for k, v in out.items():  # NHWC maps, or (B, D) descriptors
            if v.dim() == 4:
                v = self.plan.gather(v, 1)[0]
            res[k] = v if self.data is None else gather_batch(self.data, v)
        return res

    def gather_labels(self, batch: Dict[str, Tensor]) -> Dict[str, Tensor]:
        return {k: v if self.data is None else all_gather_rows(self.data, v)
                for k, v in batch.items() if k not in IMAGES}

    def replicas(self, key: str) -> int:
        if key.startswith(AGGREGATOR):
            return self.spatial.size
        return super().replicas(key)


def spatial_train_step(mesh: Mesh, step_fn: Callable,
                       batch_axis: str = "data",
                       spatial_axis: str = "model", *, cfg,
                       timing: bool = False) -> Callable:
    """The train step over ``mesh``: ``step_fn(parallel=...)`` makes it
    from the ``SpatialParallel`` hooks (``functools.partial(
    train.train_step.make_train_step, cfg, H, W, ...)``). Returns
    ``run(state, batch, *args)``: ``batch`` is the global batch (arrays or
    tensors), of which ``run`` takes this rank's part; the state's model
    and inlier net must be alike on every rank (``mesh.replicate``). The
    step equals the single-device step on the global batch; ``run.
    parallel`` holds the hooks (``reduce_ms`` with ``timing``)."""
    par = SpatialParallel(mesh, cfg, batch_axis, spatial_axis, timing)
    step = step_fn(parallel=par)

    def run(state, batch, *args):
        return step(state, par.place(batch), *args)

    run.parallel = par
    return run
