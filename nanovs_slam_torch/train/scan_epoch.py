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
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..data.device_cache import _assemble
from .multitask_loss import LossWeights


def make_epoch_fn(step_body, d_f: int, with_depth: bool, augment: bool):
    """step_body: ``make_train_step(...)``'s train_step(state, batch,
    weights) -> (state, metrics).

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
        per_step: Dict[str, list] = {}
        for s in range(idx_all.shape[0]):
            batch = _assemble(images, segs, depths, idx_all[s], homos_all[s],
                              assemble_gen, d_f, with_depth, augment)
            state, metrics = step_body(state, batch, weights)
            for k, v in metrics.items():
                per_step.setdefault(k, []).append(v)
        return state, {k: torch.stack(v) for k, v in per_step.items()}

    return epoch_fn


def shard_epoch_inputs(*args, **kwargs):
    """The JAX package places an epoch's operands on a data-parallel mesh
    here; the port's data parallelism waits in ROADMAP Queue 1 item 7."""
    raise NotImplementedError(
        "shard_epoch_inputs: data-parallel epochs wait in ROADMAP Queue 1 "
        "item 7 (parallel)")


def weights_as_arrays(weights: LossWeights, device=None) -> LossWeights:
    """The loss weights as float32 0-d tensors on ``device``, as the JAX
    package hands them to its epoch program."""
    return LossWeights(*[torch.tensor(float(v), dtype=torch.float32,
                                      device=device) for v in weights])
