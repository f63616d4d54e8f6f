"""k-means on the tensor's device, for NetVLAD's cluster init.

The JAX package's ``train_visloc.get_clusters`` runs sklearn's
``MiniBatchKMeans(n_init=3, random_state=seed)``. The card's machine has
no sklearn, so the port has its own: greedy k-means++ seeding (sklearn's
rule: 2 + log(k) candidates a centre, the one that lowers the potential
most) drawn from a numpy ``RandomState``, then full-batch Lloyd
iterations, the best of 3 runs by inertia. It cannot draw
sklearn's numbers, so its centres are not sklearn's (ROADMAP Queue 3); the
tests hold its inertia against sklearn's on seeded sets.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

Tensor = torch.Tensor
N_INIT = 3  # the JAX package's MiniBatchKMeans(n_init=3)
MAX_ITER = 300
TOL = 1e-4  # of the data's mean variance, as sklearn's


def _sq_dists(x: Tensor, x_sq: Tensor, c: Tensor) -> Tensor:
    """(M, k) squared distances of the rows of x to the rows of c, by one
    product (TF32 off), clamped at 0."""
    return torch.clamp(x_sq[:, None] - 2.0 * (x @ c.T)
                       + (c * c).sum(1)[None], min=0.0)


def kmeans_plusplus(x: Tensor, k: int, rs: np.random.RandomState
                    ) -> Tensor:
    """k initial centres (k, C) of x (M, C) by greedy k-means++: the first
    a uniform draw, each next one the best of 2 + floor(log k) candidates
    drawn with probability proportional to the squared distance to the
    nearest centre so far. The draws and their cumulative sums are float64
    on the host; the distances are on x's device."""
    M = x.shape[0]
    x_sq = (x * x).sum(1)
    n_trials = 2 + int(math.log(k))
    centres = [int(rs.randint(M))]
    closest = _sq_dists(x, x_sq, x[centres[-1]][None])[:, 0]
    pot = float(closest.sum())
    for _ in range(1, k):
        cum = np.cumsum(closest.double().cpu().numpy())
        r = rs.random_sample(n_trials) * pot
        cand = np.minimum(np.searchsorted(cum, r), M - 1)
        d = _sq_dists(x, x_sq, x[torch.as_tensor(cand, device=x.device)])
        new = torch.minimum(closest[:, None], d)  # (M, n_trials)
        best = int(torch.argmin(new.sum(0)))
        centres.append(int(cand[best]))
        closest = new[:, best]
        pot = float(closest.sum())
    return x[torch.as_tensor(centres, device=x.device)].clone()


def lloyd(x: Tensor, centres: Tensor) -> Tuple[Tensor, float]:
    """Lloyd iterations from ``centres`` until the centres move by less
    than TOL times the data's mean variance (squared, summed; sklearn's
    rule) or MAX_ITER; an empty cluster keeps its centre. Returns the
    centres and their inertia (the summed squared distances to the nearest
    centre)."""
    x_sq = (x * x).sum(1)
    k = centres.shape[0]
    thresh = float(x.var(0, unbiased=False).mean()) * TOL
    for _ in range(MAX_ITER):
        labels = torch.argmin(_sq_dists(x, x_sq, centres), dim=1)
        sums = torch.zeros_like(centres).index_add_(0, labels, x)
        counts = torch.bincount(labels, minlength=k).to(x.dtype)
        new = torch.where(counts[:, None] > 0,
                          sums / torch.clamp(counts, min=1.0)[:, None],
                          centres)
        shift = float(((new - centres) ** 2).sum())
        centres = new
        if shift <= thresh:
            break
    inertia = float(_sq_dists(x, x_sq, centres).min(dim=1).values.sum())
    return centres, inertia


def kmeans(x: Tensor, k: int, seed: int = 0) -> Tuple[Tensor, float]:
    """(centres (k, C), inertia) of the best of N_INIT k-means runs on x
    (M, C) float32, on x's device; the seeding draws come from one
    ``np.random.RandomState(seed)``."""
    if x.shape[0] < k:
        raise ValueError(f"kmeans: {x.shape[0]} points for {k} clusters")
    rs = np.random.RandomState(seed)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        best = None
        for _ in range(N_INIT):
            c, inertia = lloyd(x, kmeans_plusplus(x, k, rs))
            if best is None or inertia < best[1]:
                best = (c, inertia)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return best
