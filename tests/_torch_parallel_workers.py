"""Rank functions of tests/test_torch_port_parallel.py. The ranks are new
processes (start method "spawn") that import this module by name, so it
imports neither jax nor the JAX package."""

import numpy as np
import torch

from nanovs_slam_torch import dryrun
from nanovs_slam_torch.parallel import mesh as pm


def collectives(mesh):
    """Every collective on rank-dependent inputs, and the two gathers'
    gradients; returns what each rank saw."""
    r = mesh.rank
    out = {"rank": r, "size": mesh.size}
    rows = torch.arange(12.0).reshape(6, 2)
    out["shard"] = pm.shard_batch(mesh, {"x": rows})["x"]
    try:
        pm.shard_batch(mesh, torch.zeros(3, 1))
    except ValueError as e:
        out["shard_error"] = str(e)
    net = torch.nn.Linear(3, 2)
    with torch.no_grad():
        net.weight.fill_(r + 1.0)
    out["replicated"] = pm.replicate(mesh, net).weight.detach().clone()
    t = torch.full((2,), r + 1.0)
    out["replicated_in_place"] = pm.replicate(mesh, t) is t
    out["replicated_tensor"] = t
    out["broadcast"] = pm.broadcast(mesh, torch.tensor([r + 5]))
    out["sum"] = pm.all_reduce(mesh, torch.tensor([r + 1.0, 2.0 * r]))
    bf16 = torch.tensor([[r + 1.25]], dtype=torch.bfloat16)
    for name, t in (("f32", torch.tensor([[r + 0.5, -0.0]])),
                    ("i64", torch.tensor([[r + 7]])),
                    ("bool", torch.tensor([[r == 0, True]])),
                    ("bf16", bf16)):
        g = pm.all_gather_rows(mesh, t)
        out["gather_" + name] = g
        out["dtype_" + name] = str(g.dtype)
    # gather_batch: a replicated consumer, the rank's rows of its gradient
    x = torch.full((2, 3), r + 1.0, requires_grad=True)
    g = pm.gather_batch(mesh, x)
    (g * torch.arange(g.shape[0] * 3.0).reshape(-1, 3)).sum().backward()
    out["gather_batch_grad"] = x.grad.clone()
    # gather_stats: each rank's consumer covers its rows, gradients summed
    y = torch.full((1, 2), r + 1.0, requires_grad=True)
    s = pm.gather_stats(mesh, y)
    (s.sum() * (r + 1.0)).backward()
    out["gather_stats_grad"] = y.grad.clone()
    return out


def mesh_axes(mesh):
    """A (2, 2) ("data", "model") mesh over the group's four ranks and a
    1-D mesh over its first two: each axis's ranks, this rank's place on
    it and the sum of the global ranks along it; the grid's sum; the
    two-rank mesh's ranks and sum (None outside it)."""
    grid = pm.make_mesh(4, ("data", "model"), (2, 2), device="cpu")
    me = torch.tensor([float(mesh.rank)])
    out = {name: {"ranks": list(grid.axis(name).ranks),
                  "rank": grid.axis(name).rank,
                  "sum": float(pm.all_reduce(grid.axis(name), me)[0])}
           for name in grid.axis_names}
    out["grid_sum"] = float(pm.all_reduce(grid, me)[0])
    pair = pm.make_mesh(2, device="cpu")
    out["pair"] = None if pair is None else (
        list(pair.ranks), float(pm.all_reduce(pair, me)[0]))
    return out


def pair_noise(n_pairs: int, table: np.ndarray, seed: int = 0):
    """An injected ``vo.pose.gumbel_noise``: call k on a generator of pair
    i (known by its seed, ``pair_generator(seed, i)``) returns table[i,
    k]."""
    from nanovs_slam_torch.vo.offline import pair_generator

    pair_of = {pair_generator(seed, i, "cpu").initial_seed(): i
               for i in range(n_pairs)}
    calls = {}  # id -> (the generator, kept alive, its calls so far)

    def gumbel_noise(shape, generator):
        i = pair_of[generator.initial_seed()]
        _, k = calls.get(id(generator), (generator, 0))
        calls[id(generator)] = (generator, k + 1)
        return torch.from_numpy(table[i, k].reshape(shape))

    return gumbel_noise


def vo_with_noise(mesh, spec, table):
    """``dryrun.sharded_vo`` with every pair's RANSAC noise from
    ``table`` (pairs, calls, ...)."""
    import nanovs_slam_torch.vo.pose as pose

    pose.gumbel_noise = pair_noise(table.shape[0], table)
    return dryrun.sharded_vo(mesh, spec)
