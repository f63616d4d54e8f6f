"""A whole training epoch on the card, the counterpart of
``nanovs_slam_tpu/train/scan_epoch.py``.

The JAX package scans its train step over an epoch as one XLA program
(``lax.scan``). PyTorch runs eagerly, so here the scan is a loop over the
epoch's S steps with everything on the device: each step assembles its
batch from the resident dataset (``data/device_cache._assemble``: gather,
``/255``, photometric augment, homography pair) and runs the train step;
each step's metrics stay 0-d device tensors and are stacked on the device.
The host uploads the epoch's (S, B) indices and (S, B, 3, 3) homographies
once (``DeviceCachedPairLoader.epoch_arrays``) and reads the stacked
metrics once, at the end: no step waits for the host.

The epoch consumes the inputs of ``DeviceCachedPairLoader.epoch`` in the
same order (the same indices, homographies and augment generator), so an
epoch here equals the loop over ``epoch()`` with the same step.

Data parallel: ``shard_epoch_inputs`` replicates the state and the cache
over a mesh and gives each rank its columns of the (S, B) indices and
homographies; ``make_epoch_fn(..., mesh=mesh)`` with the data-parallel
step (``parallel.data_parallel.make_dp_train_step``) then assembles and
forwards the rank's rows of each global batch (the augment's draws are
the global batch's, of which the rank keeps its rows), and the epoch
equals the single-process one.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..data.device_cache import _assemble
from .multitask_loss import LossWeights


def make_epoch_fn(step_body, d_f: int, with_depth: bool, augment: bool,
                  mesh=None):
    """step_body: ``make_train_step(...)``'s train_step(state, batch,
    weights) -> (state, metrics); with ``mesh``, the data-parallel step
    over it, and the epoch's operands from ``shard_epoch_inputs``.

    Returns epoch_fn(state, cache, idx_all, homos_all, weights,
    assemble_gen, step_gen) -> (state, stacked metrics {name: (S,)}), with
    cache = ``DeviceCachedPairLoader.cache_arrays()`` and idx_all,
    homos_all, assemble_gen from ``.epoch_arrays(epoch)``. ``step_gen``,
    where given, becomes the model's dropout generator for the epoch
    (``modules.blocks.set_dropout``); None keeps the one it has."""
    from ..modules.blocks import set_dropout

    def epoch_fn(state, cache, idx_all: torch.Tensor,
                 homos_all: torch.Tensor, weights: LossWeights,
                 assemble_gen: Optional[torch.Generator],
                 step_gen: Optional[torch.Generator] = None):
        images, segs, depths = cache
        if step_gen is not None:
            set_dropout(state.model, generator=step_gen)
        data = None if mesh is None else mesh.axis(mesh.axis_names[0])
        shard = None if data is None else (data.rank, data.size)
        per_step: Dict[str, list] = {}
        for s in range(idx_all.shape[0]):
            batch = _assemble(images, segs, depths, idx_all[s], homos_all[s],
                              assemble_gen, d_f, with_depth, augment, shard)
            state, metrics = step_body(state, batch, weights)
            for k, v in metrics.items():
                per_step.setdefault(k, []).append(v)
        return state, {k: torch.stack(v) for k, v in per_step.items()}

    return epoch_fn


def shard_epoch_inputs(mesh, state, cache, idx_all: torch.Tensor,
                       homos_all: torch.Tensor):
    """An epoch's operands on a data-parallel mesh, as the JAX package
    places them: the train state and the dataset cache replicated (rank
    0's on every rank's device, written into each rank's own where it
    lies there), the (S, B) indices and (S, B, 3, 3) homographies split
    along B, this rank's (S, B / n) columns returned.
    Raises ValueError where B is not divisible by the mesh's first axis.
    Returns (state, cache, idx, homos)."""
    from ..parallel.mesh import replicate, shard_batch

    axis = mesh.axis_names[0]
    sub = mesh.axis(axis)
    B = idx_all.shape[1]
    if B % sub.size != 0:
        raise ValueError(f"batch {B} not divisible by mesh axis "
                         f"'{axis}' size {sub.size}")
    state = replicate(sub, state)
    cache = tuple(None if c is None else replicate(sub, c) for c in cache)
    idx, homos = shard_batch(sub, (idx_all, homos_all), dim=1)
    return state, cache, idx, homos


def weights_as_arrays(weights: LossWeights, device=None) -> LossWeights:
    """The loss weights as float32 0-d tensors on ``device``, as the JAX
    package hands them to its epoch program."""
    return LossWeights(*[torch.tensor(float(v), dtype=torch.float32,
                                      device=device) for v in weights])
