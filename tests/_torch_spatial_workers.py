"""Rank functions of tests/test_torch_port_spatial.py. The ranks are new
processes (start method "spawn") that import this module by name, so it
imports neither jax nor the JAX package."""

import torch
import torch.nn.functional as F

from _torch_parallel_workers import mesh_axes
from nanovs_slam_torch import dryrun
from nanovs_slam_torch.parallel import mesh as pm
from nanovs_slam_torch.parallel.distributed import to_host


def halo_conv(mesh, spec):
    """One 3x3 convolution (padding 1) of ``spec["x"]`` (B, C, H, W) over
    the first ``len(spec["bounds"]) - 1`` ranks, rank r holding rows
    ``bounds[r]:bounds[r + 1]``: its input slab takes its halo from
    ``halo_rows`` and the convolution runs unpadded in height. Returns
    the slab's output, the gradient of sum(output * ``spec["g"]``) with
    respect to the slab, and that with respect to the weight summed over
    the ranks (nothing on a rank outside the mesh)."""
    b = spec["bounds"]
    sub = pm.make_mesh(len(b) - 1, ("model",), device="cpu")
    if sub is None:
        return {}
    r = sub.rank
    xs = torch.from_numpy(spec["x"][:, :, b[r]:b[r + 1]]).requires_grad_()
    w = torch.from_numpy(spec["w"]).requires_grad_()
    y = F.conv2d(pm.halo_rows(sub, xs, 1, 1), w, padding=(0, 1))
    (y * torch.from_numpy(spec["g"][:, :, b[r]:b[r + 1]])).sum().backward()
    return {"y": y, "gx": xs.grad, "gw": pm.all_reduce(sub, w.grad)}


def slab_batch_norm(mesh, spec):
    """A train-mode ``BatchNorm2d`` (weight ``spec["w"]``, bias 0.3) of
    ``spec["x"]`` (B, C, H, W) over the four ranks as a 2x2 ("data",
    "model") mesh: data row i holds images ``2i:2i + 2``, model rank j
    rows ``bounds[j]:bounds[j + 1]`` of them, and the statistics span the
    whole mesh (``spatial_partition``'s BatchNorm). Returns the part's
    output, the gradient of sum(output * ``spec["g"]``) with respect to
    it, the weight's gradient summed over the mesh and the running
    variance."""
    from nanovs_slam_torch.modules.blocks import BatchNorm2d

    grid = pm.make_mesh(4, ("data", "model"), (2, 2), device="cpu")
    i, j = grid.axis("data").rank, grid.axis("model").rank
    b = spec["bounds"]
    bn = BatchNorm2d(spec["w"].shape[0]).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(spec["w"]))
        bn.bias.fill_(0.3)
    bn.batch_mesh = grid
    part = (slice(2 * i, 2 * i + 2), slice(None), slice(b[j], b[j + 1]))
    x = torch.from_numpy(spec["x"][part]).requires_grad_()
    y = bn(x)
    (y * torch.from_numpy(spec["g"][part])).sum().backward()
    return {"y": y, "gx": x.grad, "gw": pm.all_reduce(grid, bn.weight.grad),
            "var": bn.running_var}


def slab_conv(mesh, spec):
    """Each convolution of ``spec["convs"]`` ((kernel, stride, pad) in
    height and width, with a bias) of ``spec["x"]`` (B, C, H, W) as the
    port's slabbed ``Conv2d`` runs it over the first ``len(spec["bounds"])
    - 1`` ranks, rank r holding rows ``bounds[r]:bounds[r + 1]``. Returns
    a result a conv: the rows this rank writes, its first row, the map
    gathered from every rank's rows (``SlabPlan.gather_rows``), the
    gradient of sum(output * ``spec["g"]``'s rows) with respect to the
    slab, and that with respect to the weight summed over the ranks."""
    from nanovs_slam_torch.modules.blocks import Conv2d
    from nanovs_slam_torch.parallel.spatial import SlabPlan

    b = spec["bounds"]
    sub = pm.make_mesh(len(b) - 1, ("model",), device="cpu")
    if sub is None:
        return {}
    r, plan = sub.rank, SlabPlan(sub, tuple(b))
    out = {}
    for i, (k, st, pad) in enumerate(spec["convs"]):
        conv = Conv2d(spec["x"].shape[1], 3, k, stride=st, padding=pad)
        with torch.no_grad():
            conv.weight.copy_(torch.from_numpy(spec["w"][i]))
            conv.bias.fill_(0.25)
        conv.slabs = plan
        xs = torch.from_numpy(spec["x"][:, :, b[r]:b[r + 1]]).requires_grad_()
        y = conv(xs)
        _, _, _, lo, total = plan.conv_rows(xs.shape[2], k, st, pad)
        g = torch.from_numpy(spec["g"][i])[:, :, lo:lo + y.shape[2]]
        (y * g).sum().backward()
        out[str(i)] = {"y": y, "lo": lo,
                       "full": plan.gather_rows(y.detach(), 2, lo, total),
                       "gx": xs.grad,
                       "gw": pm.all_reduce(sub, conv.weight.grad)}
    return out


KINDS = {"halo_conv": halo_conv, "slab_batch_norm": slab_batch_norm,
         "slab_conv": slab_conv,
         "mesh_axes": lambda mesh, spec: mesh_axes(mesh)}


def spatial_jobs(mesh, jobs):
    """[(name, kind, spec)] in order on this group: a kind of ``KINDS``,
    or of ``dryrun.JOBS`` (through ``dryrun.run_jobs``) -> {name:
    result}."""
    out = {}
    for name, kind, spec in jobs:
        if kind in KINDS:
            out[name] = to_host(KINDS[kind](mesh, spec))
        else:
            out.update(dryrun.run_jobs(mesh, [(name, kind, spec)]))
    return out
