"""Batched inference fanned out over a mesh's ranks, the counterpart of
``nanovs_slam_tpu/parallel/eval_fanout.py``: the model replicated, each
batch cut along B, each rank running its rows, the outputs gathered on
every rank. The evaluators' metric tails then run unchanged on the whole
result.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List

import numpy as np
import torch

from .mesh import Mesh, all_gather_rows, make_mesh, replicate, shard_batch


def sharded_infer_fn(infer: Callable, model: torch.nn.Module,
                     mesh: Mesh = None) -> Callable:
    """``infer(images) -> {name: (B, ...) tensor}`` (``make_infer_fn`` of
    ``model``, on the mesh's device) over ``mesh``'s first axis (default:
    every rank): the model's weights become rank 0's, and ``run(images)``
    takes a whole batch (B divisible by the ranks), runs this rank's rows
    and returns the whole batch's outputs on every rank."""
    mesh = mesh or make_mesh()
    mesh = mesh.axis(mesh.axis_names[0])
    replicate(mesh, model)

    def run(images) -> Dict[str, torch.Tensor]:
        out = infer(shard_batch(mesh, images))
        return {k: all_gather_rows(mesh, v) for k, v in out.items()}

    return run


def map_batched(run: Callable, items: Iterable[np.ndarray],
                batch_size: int) -> List[Dict[str, np.ndarray]]:
    """Drive ``run`` over an item stream in fixed-size batches (the last
    padded with zero items, its pads dropped from the results); returns
    one dict of numpy arrays a batch."""
    out: List[Dict[str, np.ndarray]] = []
    buf: List[np.ndarray] = []

    def flush():
        if not buf:
            return
        n = len(buf)
        batch = np.stack(buf + [np.zeros_like(buf[0])] * (batch_size - n))
        res = run(batch)
        out.append({k: v.float().cpu().numpy()[:n] if v.is_floating_point()
                    else v.cpu().numpy()[:n] for k, v in res.items()})
        buf.clear()

    for item in items:
        buf.append(np.asarray(item))
        if len(buf) == batch_size:
            flush()
    flush()
    return out
