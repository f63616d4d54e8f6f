"""Dry run of the parallel layer over N ranks, the counterpart of the JAX
package's ``__graft_entry__.dryrun_multichip``:

    python -m nanovs_slam_torch.dryrun N [--device cpu] [--timeout S]

It spawns N ranks (NCCL where each has a card of its own, else gloo: on
the CPU, or ranks sharing a card) and holds each parallel path against the
same work in this process on one device:

- dp step: 2 data-parallel train steps of config N (48x64, global batch
  2N, dropout on) against the single-process steps;
- dp epoch: a 2-step ``shard_epoch_inputs`` epoch over the card-resident
  loader against the single-process epoch;
- tp LightGlue: head-parallel LightGlue (D = 64, 4 heads, 2 layers, 24
  keypoints) against the replicated forward (N must divide the heads);
- sharded VO: ``OfflineVO.relative_poses_sharded`` (pinned S8, BF, 4
  frames) against ``relative_poses``;
- eval fan-out: ``sharded_infer_fn`` over 11 items at batch 4N against the
  single run;
- dp x sp (N even): the dp step's steps over an (N / 2, 2) ("data",
  "model") mesh, each image's rows split over the "model" axis
  (``spatial_train_step``), against the single-process steps with the dp
  step's bounds and, as the JAX dry run holds it, its loss within 1e-2 +
  1e-3 |loss| of the dp step's.

It prints one line a check and exits 1 if any failed. The jobs
(``run_jobs``, ``JOBS``) are what the tests and ``chip_smoke.py`` spawn at
their own sizes.
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PINNED_EX = os.path.join(_REPO, "pinned", "extractor_S8.npz")
PINNED_LG = os.path.join(_REPO, "pinned", "lightglue_S.npz")
SEED = 0


# ------------------------------------------------------------------ inputs

def _config(spec: dict):
    """(cfg, its ``init_model``) of a job: KeypointFormer's
    ``spec["config"]`` ("tiny", "default") with ``spec["keypoint_former"]``,
    else KP2DTiny's (V3 with ``spec["v3"]``), at ``spec["n_classes"]`` and
    ``spec["dtype"]``."""
    kw = dict(n_classes=spec["n_classes"], dtype=spec.get("dtype",
                                                           "float32"))
    if spec.get("keypoint_former"):
        import dataclasses

        from .models.keypoint_former import KEYPOINTFORMER_CONFIGS, init_model

        return dataclasses.replace(KEYPOINTFORMER_CONFIGS[spec["config"]],
                                   **kw), init_model
    from .configs import get_config
    from .models.kp2dtiny import init_model

    return get_config(spec["config"], v3=spec.get("v3", False), **kw), \
        init_model


def train_batch(H: int, W: int, B: int, n_classes: int, seed: int,
                d_f: int = 2) -> Dict[str, np.ndarray]:
    """One global training batch of the synthetic set through the
    PairLoader's host augments and homographies, as numpy; labels at
    H / ``d_f`` (the trainer's cell / 2: 4 for KeypointFormer)."""
    from .data.datasets import SyntheticShapesDataset
    from .data.pipeline import PairLoader

    loader = PairLoader(SyntheticShapesDataset((H, W), max(B, 8), n_classes,
                                               seed=seed),
                        B, H, W, d_f=d_f, seed=seed, device="cpu")
    return {k: v.numpy() for k, v in next(iter(loader)).items()}


def shifted_frames(T: int, H: int, W: int) -> np.ndarray:
    """(T, H, W, 3) float frames in [0, 1]: a synthetic-shapes image moved
    by (3, 6) pixels a frame (wrapping), a sequence to match."""
    from .data.datasets import SyntheticShapesDataset

    img = SyntheticShapesDataset((H, W), 1, 8, seed=SEED)[0]["image"]
    return np.stack([np.roll(img, (3 * t, 6 * t), (0, 1))
                     for t in range(T)]).astype(np.float32)


def lightglue_data(D: int, K: int, seed: int, pad: Tuple[int, int] = (4, 6)
                   ) -> Dict[str, torch.Tensor]:
    """A pair of K random keypoints each with unit descriptors of width D,
    the last ``pad`` of each side masked out."""
    rs = np.random.RandomState(seed)

    def unit(*shape):
        d = rs.randn(*shape).astype(np.float32)
        return torch.from_numpy(d / np.linalg.norm(d, axis=-1, keepdims=True))

    return {"keypoints0": torch.from_numpy(
                rs.uniform(-1, 1, (1, K, 2)).astype(np.float32)),
            "keypoints1": torch.from_numpy(
                rs.uniform(-1, 1, (1, K, 2)).astype(np.float32)),
            "descriptors0": unit(1, K, D), "descriptors1": unit(1, K, D),
            "mask0": torch.arange(K)[None] < K - pad[0],
            "mask1": torch.arange(K)[None] < K - pad[1]}


# -------------------------------------------------------------------- jobs

def _train_state(spec: dict, dev):
    """(cfg, train state) of a dp / train job: the config's model and an
    inlier net from the seed (or ``spec["init"]``'s numpy state dicts),
    Adam at ``lr`` (on a cosine schedule of ``spec["cosine"]`` = (steps an
    epoch, epochs) where given), dropout on a generator seeded alike on
    every rank, or off. A KeypointFormer with ``spec["keypoint_former"]``
    (``_config``)."""
    from .models.inlier_net import init_inlier_net
    from .modules.blocks import set_dropout
    from .train.schedules import make_lr_schedule
    from .train.train_step import create_train_state, make_optimizer

    seed = spec.get("seed", SEED)
    cfg, init_model = _config(spec)
    model = init_model(cfg, torch.Generator().manual_seed(seed), dev)
    io = init_inlier_net(torch.Generator().manual_seed(seed + 2), device=dev)
    if spec.get("init"):
        for net, sd in ((model, spec["init"]["model"]),
                        (io, spec["init"]["io"])):
            net.load_state_dict({k: torch.as_tensor(v) for k, v in
                                 sd.items()})
    set_dropout(model, rate=None if spec.get("dropout", True) else 0.0,
                generator=torch.Generator(dev).manual_seed(seed + 1))
    lr = spec.get("lr", 5e-4)
    schedule = (make_lr_schedule("cosine", lr, *spec["cosine"])
                if spec.get("cosine") else None)
    return cfg, create_train_state(model, make_optimizer(
        "adam", lr, schedule=schedule), io_net=io)


def _state_numpy(state) -> Dict[str, np.ndarray]:
    """The state's model and inlier net as numpy arrays (a copy)."""
    out = {"model." + k: v for k, v in state.model.state_dict().items()}
    out.update({"io." + k: v for k, v in state.io_net.state_dict().items()})
    return {k: v.detach().cpu().numpy().copy() for k, v in out.items()}


def _grads_numpy(state) -> Dict[str, np.ndarray]:
    """The raw gradients of the state's last step (a copy)."""
    return {k: p.grad.detach().cpu().numpy().copy()
            for k, p in state.named_parameters() if p.grad is not None}


def _sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def dp_steps(mesh, spec: dict, dev=None) -> dict:
    """``spec["steps"]`` train steps on ``spec["batch"]`` (the global
    batch, numpy): data parallel over ``mesh`` (this rank's rows), or with
    ``spec["spatial"]`` over a (size / 2, 2) ("data", "model") mesh of its
    ranks (``spatial_train_step``: this rank's rows and slab), or on
    ``dev`` in one process where ``mesh`` is None. Returns each step's
    metrics and host ms (synchronised), the final state, the first step's
    raw gradients and the state after it (with ``spec["grads"]``, under
    "first") and, data parallel, the
    gradient all-reduce's ms a step (with ``spec["timing"]``)."""
    from .parallel.data_parallel import make_dp_train_step
    from .parallel.mesh import make_mesh, shard_batch
    from .parallel.spatial import spatial_train_step
    from .train.schedules import DEFAULT_LOSS_WEIGHTS
    from .train.train_step import make_train_step

    dev = mesh.device if mesh is not None else torch.device(dev)
    cfg, state = _train_state(spec, dev)
    H, W = spec["H"], spec["W"]
    kw = dict(io_top_k=spec.get("io_top_k", 300),
              train_flags=spec.get("train_flags"))
    batch = {k: torch.as_tensor(v) for k, v in spec["batch"].items()}
    dp = None
    timing = spec.get("timing", False)
    if mesh is not None and spec.get("spatial"):
        mesh = make_mesh(mesh.size, ("data", "model"),
                         (mesh.size // 2, 2), device=mesh.device)
        step = spatial_train_step(mesh, functools.partial(
            make_train_step, cfg, H, W, **kw), cfg=cfg, timing=timing)
        dp = step.parallel
    elif mesh is not None:
        step, dp = make_dp_train_step(mesh, cfg, H, W, timing=timing, **kw)
        batch = shard_batch(mesh, batch)
    else:
        step = make_train_step(cfg, H, W, **kw)
        batch = {k: v.to(dev) for k, v in batch.items()}
    out = {"metrics": [], "step_ms": []}
    for s in range(spec["steps"]):
        _sync(dev)
        t0 = time.perf_counter()
        state, met = step(state, batch, DEFAULT_LOSS_WEIGHTS)
        _sync(dev)
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["metrics"].append({k: float(v) for k, v in met.items()})
        if s == 0 and spec.get("grads"):
            out["first"] = {"grads": _grads_numpy(state),
                            "state": _state_numpy(state)}
    out["state"] = _state_numpy(state)
    if dp is not None:
        out["reduce_ms"] = dp.reduce_ms
    return out


def dp_epoch(mesh, spec: dict, dev=None) -> dict:
    """One epoch of ``spec["steps"]`` steps through ``make_epoch_fn`` over
    the card-resident loader (the synthetic set, global batch
    ``spec["B"]``): data parallel through ``shard_epoch_inputs`` over
    ``mesh``, or in one process on ``dev``. Returns the stacked metrics and
    the final state; with ``spec["grads"]`` also the last step's raw
    gradients and, under "first", the first step's and the state after
    it."""
    from .data.datasets import SyntheticShapesDataset
    from .data.device_cache import DeviceCachedPairLoader
    from .parallel.data_parallel import make_dp_train_step
    from .train.scan_epoch import (make_epoch_fn, shard_epoch_inputs,
                                   weights_as_arrays)
    from .train.schedules import DEFAULT_LOSS_WEIGHTS
    from .train.train_step import make_train_step

    dev = mesh.device if mesh is not None else torch.device(dev)
    cfg, state = _train_state(spec, dev)
    H, W, B = spec["H"], spec["W"], spec["B"]
    loader = DeviceCachedPairLoader(
        SyntheticShapesDataset((H, W), B * spec["steps"], spec["n_classes"],
                               seed=0), B, H, W, d_f=cfg.cell // 2,
        seed=spec.get("seed", SEED), device=dev)
    idx, homos, gen = loader.epoch_arrays(0)
    idx, homos = idx[:spec["steps"]], homos[:spec["steps"]]
    cache = loader.cache_arrays()
    kw = dict(io_top_k=spec.get("io_top_k", 300))
    if mesh is not None:
        step, _ = make_dp_train_step(mesh, cfg, H, W, **kw)
        state, cache, idx, homos = shard_epoch_inputs(mesh, state, cache,
                                                      idx, homos)
    else:
        step = make_train_step(cfg, H, W, **kw)
    first: dict = {}
    if spec.get("grads"):
        inner = step

        def step(state, batch, weights):
            state, met = inner(state, batch, weights)
            if not first:
                first.update(grads=_grads_numpy(state),
                             state=_state_numpy(state))
            return state, met
    epoch_fn = make_epoch_fn(step, cfg.cell // 2, False, True, mesh=mesh)
    state, stack = epoch_fn(state, cache, idx, homos,
                            weights_as_arrays(DEFAULT_LOSS_WEIGHTS, dev), gen)
    out = {"metrics": {k: v.cpu().numpy() for k, v in stack.items()},
           "state": _state_numpy(state)}
    if spec.get("grads"):
        out.update(first=first, grads=_grads_numpy(state))
    return out


def _pinned_s8(dev):
    from .configs import get_config
    from .models.kp2dtiny import build_model
    from .utils.checkpoint import load_npz_checkpoint
    from .utils.convert import load_jax_variables

    tree, _ = load_npz_checkpoint(PINNED_EX)
    cfg = get_config("S", n_classes=8)
    model = load_jax_variables(build_model(cfg), tree["params"],
                               tree["batch_stats"])
    return cfg, model.to(dev).eval()


def sharded_vo(mesh, spec: dict, dev=None) -> dict:
    """Pinned S8's offline VO over ``spec["frames"]`` ((T, H, W, 3) in [0,
    1], numpy): ``relative_poses_sharded`` over ``mesh``, or
    ``relative_poses`` on ``dev``. ``spec``: matcher ("bf" or
    "lightglue", pinned LightGlue), k, n_hypotheses, restarts, cam (W, H)
    (KITTI's intrinsics; default the frames' size). Returns R, t,
    n_inliers, n_matches and the host ms of the sequence."""
    from .vo.camera import PinholeCamera, kitti_params
    from .vo.offline import OfflineVO
    from .vo.visual_odometry import load_lightglue_for_vo

    dev = mesh.device if mesh is not None else torch.device(dev)
    cfg, model = _pinned_s8(dev)
    frames = spec["frames"]
    H, W = frames.shape[1:3]
    cw, ch = spec.get("cam", (W, H))
    fx, fy, cx, cy = kitti_params()
    cam = PinholeCamera(cw, ch, fx, fy, cx, cy)
    k = spec.get("k", 512)
    lg = (load_lightglue_for_vo(PINNED_LG, cfg.nfeatures, (cw, ch), max_n=k)
          if spec.get("matcher") == "lightglue" else None)
    vo = OfflineVO(model, cfg, (H, W), cam, k=k,
                   matcher=spec.get("matcher", "bf"), lightglue=lg,
                   n_hypotheses=spec.get("n_hypotheses", 256),
                   restarts=spec.get("restarts", 1),
                   extract_chunk=spec.get("extract_chunk", 16), device=dev)
    x = torch.from_numpy(frames).to(dev)
    _sync(dev)
    t0 = time.perf_counter()
    out = (vo.relative_poses_sharded(x, mesh, seed=SEED) if mesh is not None
           else vo.relative_poses(x, seed=SEED))
    _sync(dev)
    R, t, ninl, nmat = out
    return {"R": R, "t": t, "n_inliers": ninl, "n_matches": nmat,
            "ms": (time.perf_counter() - t0) * 1e3}


def _job_model(spec: dict, dev):
    """(cfg, eval model on ``dev``) of a serving job: pinned S8 with
    ``spec["pinned"]``, else ``spec["config"]`` (``_config``) seeded, or
    loaded from ``spec["init"]`` (a numpy state dict)."""
    if spec.get("pinned"):
        return _pinned_s8(dev)
    cfg, init_model = _config(spec)
    model = init_model(cfg, torch.Generator().manual_seed(SEED), dev)
    if spec.get("init"):
        model.load_state_dict({k: torch.as_tensor(v)
                               for k, v in spec["init"].items()})
    return cfg, model


def sp_forward(mesh, spec: dict, dev=None) -> dict:
    """The model of ``_job_model(spec)`` on ``spec["frames"]`` ((B, H, W,
    3) in [0, 1], numpy): with ``spec["request"]`` the request (the keys of
    ``make_infer_fn``'s result; keypoints with ``spec["top_k"]``), else the
    raw forward's outputs (NHWC) on the frames as model input; spatially
    partitioned over the first ``spec["ranks"]`` ranks of ``mesh`` (with
    ``spec["data"]`` > 1 a
    ("data", "model") mesh of that many rows, the batch split over
    "data"), or in one process on ``dev`` where ``mesh`` is None. Returns
    the outputs (none on a rank outside the mesh) and the host ms of a
    call (the median of ``spec["repeats"]``, default 1, after a first)."""
    from .inference import make_infer_fn
    from .ops.image import to_model_input
    from .parallel.mesh import make_mesh
    from .parallel.spatial import make_spatial_infer_fn, spatial_forward

    dev = mesh.device if mesh is not None else torch.device(dev)
    frames = torch.from_numpy(spec["frames"])
    B, H, W = frames.shape[:3]
    top_k = spec.get("top_k")
    cfg, model = _job_model(spec, dev)
    if mesh is not None:
        nd, ns = spec.get("data", 1), spec["ranks"]
        mesh = (make_mesh(nd * ns, ("data", "model"), (nd, ns), device=dev)
                if nd > 1 else make_mesh(ns, ("model",), device=dev))
        if mesh is None:
            return {"out": {}, "ms": 0.0}
    axis = "data" if spec.get("data", 1) > 1 else None
    if spec.get("request"):
        run = (make_spatial_infer_fn(mesh, model, cfg, H, W, top_k=top_k,
                                     batch_axis=axis) if mesh is not None
               else make_infer_fn(model, cfg, H, W, top_k=top_k, device=dev))
        x = frames
    else:
        if mesh is not None:
            run = spatial_forward(mesh, model, batch_axis=axis)
        else:
            @torch.inference_mode()
            def run(x):
                out = model(x.to(dev).permute(0, 3, 1, 2))
                return {k: v.permute(0, 2, 3, 1) if v.dim() == 4 else v
                        for k, v in out.items()}
        x = to_model_input(frames)
    times = []
    for _ in range(1 + spec.get("repeats", 1)):
        _sync(dev)
        t0 = time.perf_counter()
        out = run(x)
        _sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    return {"out": out, "ms": float(np.median(times[1:]))}


def fanout(mesh, spec: dict, dev=None) -> dict:
    """``make_infer_fn`` of a seeded model (``spec["config"]``, or pinned
    S8 with ``spec["pinned"]``) over ``spec["n_items"]`` seeded frames in
    [0, 1] at ``spec["batch_size"]``: ``sharded_infer_fn`` over ``mesh``,
    or the plain infer on ``dev``. Returns the outputs, items
    concatenated, and the host ms a batch."""
    from .inference import make_infer_fn
    from .parallel.eval_fanout import map_batched, sharded_infer_fn

    dev = mesh.device if mesh is not None else torch.device(dev)
    H, W = spec["H"], spec["W"]
    cfg, model = _job_model(spec, dev)
    infer = make_infer_fn(model, cfg, H, W, device=dev)
    run = sharded_infer_fn(infer, model, mesh) if mesh is not None else infer
    items = np.random.RandomState(spec.get("seed", 5)).rand(
        spec["n_items"], H, W, 3).astype(np.float32)
    _sync(dev)
    t0 = time.perf_counter()
    res = map_batched(run, items, spec["batch_size"])
    _sync(dev)
    ms = (time.perf_counter() - t0) * 1e3 / len(res)
    return {"out": {k: np.concatenate([r[k] for r in res]) for k in res[0]},
            "ms": ms}


def _lightglue(spec: dict):
    """The job's LightGlue on the CPU: pinned kp2dtiny_S, or a config
    (a name of LIGHTGLUE_CONFIGS or a dict of LightGlueConfig fields) with
    PyTorch's initialisation drawn from the seed."""
    from .matching.configs import LIGHTGLUE_CONFIGS, LightGlueConfig
    from .matching.lightglue import LightGlue
    from .utils.checkpoint import load_npz_checkpoint
    from .utils.convert import load_jax_lightglue

    lg = spec["lg"]
    if spec.get("jax_params") is not None:  # flax params of config ``lg``
        return load_jax_lightglue(LightGlue(LightGlueConfig(**lg)),
                                  spec["jax_params"]).eval()
    if lg == "pinned":
        tree, meta = load_npz_checkpoint(PINNED_LG)
        cfg = LIGHTGLUE_CONFIGS[meta["config"]["lg_config"]]
        return load_jax_lightglue(LightGlue(cfg), tree["params"]).eval()
    cfg = LIGHTGLUE_CONFIGS[lg] if isinstance(lg, str) \
        else LightGlueConfig(**lg)
    torch.manual_seed(spec.get("seed", SEED))
    return LightGlue(cfg).eval()


def tp_lightglue(mesh, spec: dict, dev=None) -> dict:
    """LightGlue on one pair of ``spec["K"]`` keypoints: head parallel
    over ``mesh`` (``tp_lightglue_forward``), or the module's forward on
    ``dev`` (the kernel on a card). Returns matches0, log_assignment, the
    last layer's descriptors and the host ms of a forward (the second of
    two)."""
    from .parallel.tp import tp_lightglue_forward

    dev = mesh.device if mesh is not None else torch.device(dev)
    model = _lightglue(spec)
    data = lightglue_data(model.cfg.input_dim, spec["K"],
                          spec.get("seed", SEED) + 1)
    if mesh is not None:
        run = tp_lightglue_forward(mesh, model, spec.get("jax_params"))
    else:
        model.to(dev)

        @torch.inference_mode()
        def run(d):
            return model({k: v.to(dev) for k, v in d.items()})
    for _ in range(2):
        _sync(dev)
        t0 = time.perf_counter()
        pred = run(data)
        _sync(dev)
    return {"matches0": pred["matches0"], "log_assignment":
            pred["log_assignment"], "descriptors0": pred["ref_descriptors0"],
            "descriptors1": pred["ref_descriptors1"],
            "ms": (time.perf_counter() - t0) * 1e3}


JOBS = {"dp_steps": dp_steps, "dp_epoch": dp_epoch, "sharded_vo": sharded_vo,
        "fanout": fanout, "tp_lightglue": tp_lightglue,
        "sp_forward": sp_forward}


def _launches() -> Dict[str, int]:
    from .kernels import BF16_KERNELS, KERNELS

    out = {k.__name__: k.launches for k in KERNELS}
    out.update({k.__name__ + "_bf16": k.launches_bf16 for k in BF16_KERNELS})
    return out


def run_jobs(mesh, jobs: List[tuple], dev=None) -> Dict[str, dict]:
    """[(name, job kind of ``JOBS``, spec)] run in order over ``mesh`` (or
    on ``dev`` in one process where ``mesh`` is None) -> {name: result},
    each with the kernels' launch counts during its job. TF32 is off for
    cuDNN and matmul (the comparisons' float32)."""
    from .kernels import reset_launches
    from .parallel.distributed import to_host

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for name, kind, spec in jobs:
        reset_launches()
        res = JOBS[kind](mesh, spec, dev)
        res["launches"] = _launches()
        out[name] = to_host(res)
    return out


# ------------------------------------------------------------- comparisons

def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(1.0, abs(b))


def compare_steps(got: List[dict], want: List[dict]
                  ) -> Tuple[List[float], List[float]]:
    """(the largest relative gap (to max(1, |term|)) of the loss terms,
    grad_norm's relative gap) at each step."""
    return ([max(_rel(g[k], w[k]) for k in w if k != "grad_norm")
             for g, w in zip(got, want)],
            [abs(g["grad_norm"] - w["grad_norm"]) / w["grad_norm"]
             for g, w in zip(got, want)])


def grad_rel_l2(got: dict, want: dict) -> float:
    """sqrt(sum (a - b)^2 / sum b^2) over every raw gradient."""
    num = sum(float(((got[k] - v) ** 2).sum()) for k, v in want.items())
    den = sum(float((v ** 2).sum()) for v in want.values())
    return (num / den) ** 0.5


def adam_step_offenders(got: dict, want: dict, ref_grads: dict,
                        tol: float = 1e-5) -> List[str]:
    """After one Adam step from one state, the parameter tensors of which
    more than 1% (and more than one) of the weights whose reference
    gradient is at least 1e-6 lie over ``tol`` apart. Adam's first step
    moves a weight by lr g / (|g| + eps): where float32 noise flips the
    sign of a small g, by 2 lr, which seeded weights' ill-conditioned
    gradients do to a few; a gradient of the wrong sign throughout a
    tensor does it to most of them."""
    out = []
    for k, g in ref_grads.items():
        live = np.abs(g) >= 1e-6
        off = int((np.abs(got[k] - want[k])[live] > tol).sum())
        if off > max(1, int(live.sum()) // 100):
            out.append(f"{k}: {off} of {int(live.sum())}")
    return out


def compare_states(got: dict, want: dict) -> Dict[str, float]:
    """The largest gaps between two numpy train states: over the
    parameters ("params"), and relative (to max(1, |value|)) over the
    model's and the inlier net's BN running statistics ("model_bn",
    "io_bn"). The inlier net's input is the argmin association of
    keypoints, which float32 noise can flip: after a first Adam step its
    statistics drift by more than the model's."""
    out = {"params": 0.0, "model_bn": 0.0, "io_bn": 0.0}
    for k, w in want.items():
        if w.dtype.kind != "f":
            continue
        gap = np.abs(got[k] - w)
        if k.endswith(("running_mean", "running_var")):
            key = "io_bn" if k.startswith("io.") else "model_bn"
            gap = gap / np.maximum(1.0, np.abs(w))
        else:
            key = "params"
        out[key] = max(out[key], float(gap.max()))
    return out


def compare_vo(got: dict, want: dict) -> dict:
    return {"matches_equal": bool(np.array_equal(got["n_matches"],
                                                 want["n_matches"])),
            "inliers_equal": bool(np.array_equal(got["n_inliers"],
                                                 want["n_inliers"])),
            "R": float(np.abs(got["R"] - want["R"]).max()),
            "t": float(np.abs(got["t"] - want["t"]).max())}


def compare_outputs(got: dict, want: dict) -> float:
    """The largest gap over the floating outputs; inf where an integer one
    differs."""
    worst = 0.0
    for k, w in want.items():
        g = got[k]
        if np.asarray(w).dtype.kind == "f":
            worst = max(worst, float(np.abs(g - w).max()))
        elif not np.array_equal(g, w):
            return math.inf
    return worst


# --------------------------------------------------------------------- CLI

def dryrun_jobs(n: int) -> List[tuple]:
    """The dry run's jobs for ``n`` ranks at small sizes."""
    H, W, B = 48, 64, 2 * n
    train = dict(config="N", n_classes=8, H=H, W=W, steps=2, lr=5e-4,
                 io_top_k=48)
    batch = train_batch(H, W, B, 8, 3)
    jobs = [("dp step", "dp_steps", dict(train, batch=batch)),
            ("dp epoch", "dp_epoch", dict(train, B=B)),
            ("sharded VO", "sharded_vo",
             dict(frames=shifted_frames(4, 64, 160), matcher="bf", k=256)),
            ("eval fan-out", "fanout",
             dict(config="N", n_classes=8, H=H, W=W, n_items=11,
                  batch_size=4 * n))]
    if 4 % n == 0:
        jobs.append(("tp LightGlue", "tp_lightglue",
                     dict(lg=dict(input_dim=64, descriptor_dim=64,
                                  n_layers=2, num_heads=4), K=24)))
    if n % 2 == 0:
        jobs.append(("dp x sp", "dp_steps", dict(train, batch=batch,
                                                 spatial=True)))
    return jobs


def check(name: str, got: dict, want: dict, lr: float = 5e-4
          ) -> Tuple[bool, str]:
    """(passed, detail) of one dry-run job against its reference."""
    if name in ("dp step", "dp epoch", "dp x sp"):
        gm, wm = got["metrics"], want["metrics"]
        if isinstance(wm, dict):  # the epoch's stacked metrics
            gm = [{k: float(v[i]) for k, v in gm.items()}
                  for i in range(len(next(iter(gm.values()))))]
            wm = [{k: float(v[i]) for k, v in wm.items()}
                  for i in range(len(next(iter(wm.values()))))]
        gaps, norms = compare_steps(gm, wm)
        st = compare_states(got["state"], want["state"])
        ok = gaps[0] <= 1e-4 and max(gaps) <= 1e-2 and max(norms) <= 1e-2 \
            and st["params"] <= 2 * lr * len(gaps) and st["model_bn"] <= 1e-3
        return ok, (f"loss terms {['%.2g' % g for g in gaps]} apart "
                    f"(relative), grad_norm {['%.2g' % g for g in norms]}, "
                    + ", ".join(f"{k} {v:.3g}" for k, v in st.items()))
    if name == "sharded VO":
        c = compare_vo(got, want)
        ok = c["matches_equal"] and c["R"] <= 1e-3 and c["t"] <= 1e-3
        return ok, json.dumps(c)
    if name == "eval fan-out":
        gap = compare_outputs(got["out"], want["out"])
        return gap <= 1e-5, f"outputs {gap:.3g} apart"
    gap = float(np.abs(got["log_assignment"]
                       - want["log_assignment"]).max())
    same = bool(np.array_equal(got["matches0"], want["matches0"]))
    return same and gap <= 2e-4, (f"matches equal {same}, log assignment "
                                  f"{gap:.3g} apart")


def sp_against_dp(sp: dict, dp: dict) -> Tuple[float, bool]:
    """(the largest gap of the dp x sp steps' total loss from the dp
    steps', whether every step's is within 1e-2 + 1e-3 |loss|: the JAX dry
    run's bound)."""
    gaps = [(abs(g["total_loss"] - w["total_loss"]),
             1e-2 + 1e-3 * abs(w["total_loss"]))
            for g, w in zip(sp["metrics"], dp["metrics"])]
    return max(g for g, _ in gaps), all(g <= lim for g, lim in gaps)


def main(argv: Optional[List[str]] = None) -> int:
    from .parallel.distributed import spawn, spawn_backend
    from .utils.device import resolve_device

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n", type=int, help="ranks")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--timeout", type=float, default=300.0,
                   help="seconds before a silent group raises")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    threads = 2 if dev.type == "cpu" else None
    backend = spawn_backend(dev, args.n)
    print(f"dryrun: {args.n} ranks over {backend} on {dev.type}"
          + (f" ({torch.cuda.device_count()} card(s): ranks share them)"
             if dev.type == "cuda" and backend == "gloo" else ""),
          flush=True)
    if dev.type == "cuda":
        from .kernels import _build

        _build.load_library()  # once, before the ranks start
    jobs = dryrun_jobs(args.n)
    t0 = time.perf_counter()
    ranks = spawn(run_jobs, args.n, (jobs,), device=dev, backend=backend,
                  timeout=args.timeout, deadline=args.timeout + 60.0,
                  threads=threads)
    print(f"dryrun: ranks done in {time.perf_counter() - t0:.1f} s",
          flush=True)
    if threads:
        torch.set_num_threads(threads)
    # the dp x sp steps' reference is the dp step's single process
    want = run_jobs(None, [j for j in jobs if not j[2].get("spatial")], dev)
    failed = 0
    for name, _, spec in jobs:
        ref = "dp step" if spec.get("spatial") else name
        try:
            ok, detail = check(name, ranks[0][name], want[ref])
            for r in range(1, args.n):  # every rank holds the whole result
                ok = ok and check(name, ranks[r][name], ranks[0][name])[0]
            if spec.get("spatial"):
                gap, ok_dp = sp_against_dp(ranks[0][name], ranks[0][ref])
                ok = ok and ok_dp
                detail += f"; loss {gap:.3g} from the dp step's"
        except (KeyError, ValueError) as e:
            ok, detail = False, f"{type(e).__name__}: {e}"
        failed += not ok
        print(f"dryrun {name}: {'ok' if ok else 'FAILED'}, {detail}",
              flush=True)
    if args.n % 2:
        print("dryrun dp x sp: not run (the (N / 2, 2) mesh needs N even)")
    print(f"dryrun_multichip({args.n}): {'ok' if not failed else 'FAILED'}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
