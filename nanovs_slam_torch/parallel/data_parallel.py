"""The data-parallel train step: ``train/train_step.make_train_step`` over
a mesh's ranks, each holding a shard of the global batch.

In JAX a data-parallel step is one global program, whose loss, gradients,
BatchNorm statistics and dropout are those of one device on the global
batch. DDP's sum of local losses is not that: BatchNorm, the masked means
of the keypoint losses, the IO loss's gate, Dice, the triplet mining and
dropout all span the batch. So the step here keeps the global program:

1. each rank forwards its shard (``modules.blocks.synced_batch``):
   BatchNorm normalises with the global batch's mean and biased variance
   (gathered under autograd, flax's running statistics), and dropout keeps
   the rank's rows of the global batch's mask;
2. the head outputs are gathered to the global batch
   (``mesh.gather_batch``, whose backward returns the rank's own rows),
   and so are the labels;
3. the loss tail (post-process decode, the losses, the inlier net) runs on
   the global batch on every rank;
4. after the backward one all-reduce sums the flattened gradients: the
   model's are partial sums over the ranks' rows; the inlier net's, which
   every rank computed whole, are averaged. Every rank then takes the same
   clip and optimizer step, and its metrics are the global batch's.

``torch.func.functional_call`` bypasses DDP's forward (and with it its
reducer), which is one reason the step does its own reduction.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Tuple

import torch

from ..modules.blocks import synced_batch
from .mesh import Mesh, all_gather_rows, all_reduce, gather_batch

Tensor = torch.Tensor
# parameters that every rank's loss tail covers whole (the inlier net runs
# on the gathered global batch)
REPLICATED = ("io.",)
IMAGES = ("image", "image_aug")


class DataParallel:
    """The hooks ``make_train_step(parallel=...)`` calls on ``mesh``'s
    "data" axis. ``timing``: synchronise around the gradient all-reduce
    and keep its ms a step in ``reduce_ms``."""

    def __init__(self, mesh: Mesh, timing: bool = False):
        self.mesh = mesh.axis(mesh.axis_names[0])
        self.timing = timing
        self.reduce_ms: List[float] = []

    def forwards(self, model) -> contextlib.AbstractContextManager:
        return synced_batch(model, self.mesh)

    def gather_outputs(self, out: Dict[str, Tensor]) -> Dict[str, Tensor]:
        return {k: gather_batch(self.mesh, v) for k, v in out.items()}

    def gather_labels(self, batch: Dict[str, Tensor]) -> Dict[str, Tensor]:
        return {k: all_gather_rows(self.mesh, v) for k, v in batch.items()
                if k not in IMAGES}

    def reduce_gradients(self, grads: List[Tuple[str, Tensor]]) -> None:
        """Sum the ranks' gradients in place (one all-reduce of them all,
        flattened), averaging those that several ranks computed whole
        (``replicas``)."""
        if not grads:
            return
        dev = grads[0][1].device
        if self.timing and dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        flat = all_reduce(self.mesh, torch.cat(
            [g.reshape(-1).float() for _, g in grads]))
        if self.timing:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            self.reduce_ms.append((time.perf_counter() - t0) * 1e3)
        offset = 0
        for k, g in grads:
            part = flat[offset:offset + g.numel()].view_as(g)
            offset += g.numel()
            n = self.replicas(k)
            g.copy_(part / n if n > 1 else part)

    def replicas(self, key: str) -> int:
        """How many ranks computed parameter ``key``'s gradient whole (it
        is averaged over them; the rest are partial sums): the whole
        mesh for the ``REPLICATED`` ones, else 1."""
        return self.mesh.size if key.startswith(REPLICATED) else 1


def make_dp_train_step(mesh: Mesh, cfg, H: int, W: int, timing=False,
                       **kwargs):
    """``make_train_step(cfg, H, W, **kwargs)`` over ``mesh``: the step
    takes this rank's rows of the global batch (``mesh.shard_batch``) and
    a state whose model and inlier net are alike on every rank
    (``mesh.replicate``), and is the single-device step on the global
    batch. Returns (step, its ``DataParallel``)."""
    from ..train.train_step import make_train_step

    dp = DataParallel(mesh, timing)
    return make_train_step(cfg, H, W, parallel=dp, **kwargs), dp
