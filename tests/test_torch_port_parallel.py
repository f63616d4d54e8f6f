"""The port's parallel layer (``nanovs_slam_torch/parallel``, the
data-parallel step and epoch, ``OfflineVO.relative_poses_sharded``, the
trainer's ``--num_devices`` and the dry run) on the CPU: ranks spawned over
gloo (two torch threads each), each path held against the same work in
this process and against the JAX package's parallel counterpart on the
``make_mesh(2)`` of conftest's virtual CPU devices. Each test states its
tolerance."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nanovs_slam_tpu.modules.blocks as jax_blocks
import nanovs_slam_torch.vo.pose as port_pose
from _torch_parallel_workers import (collectives, mesh_axes, pair_noise,
                                     vo_with_noise)
from _torch_port_util import random_variables
from nanovs_slam_torch import dryrun
from nanovs_slam_torch.parallel import distributed
from nanovs_slam_torch.parallel.distributed import spawn
from nanovs_slam_torch.utils.convert import (load_jax_inlier_net,
                                             load_jax_variables)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, B, LR = 48, 64, 4, 5e-4


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads here and in every rank (see
    test_torch_port_train_step.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _spawn(fn, *args, n=2, threads=2):
    return spawn(fn, n, args, device="cpu", threads=threads, timeout=120,
                 deadline=300)


# ------------------------------------------------------------ collectives

def test_initialize_is_a_noop_for_one_process(monkeypatch):
    """No coordinator, one process and no launcher's environment: no
    group; empty or single-task launcher variables do not count (as the
    JAX ``_pod_env_detected``); the loader's batch is the global one."""
    for var in ("WORLD_SIZE", "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize() is False
    assert distributed.initialize(num_processes=1) is False
    monkeypatch.setenv("SLURM_NTASKS", "")
    monkeypatch.setenv("OMPI_COMM_WORLD_SIZE", "1")
    assert distributed.initialize() is False
    assert not torch.distributed.is_initialized()
    monkeypatch.setenv("SLURM_NTASKS", "4")
    monkeypatch.setenv("SLURM_PROCID", "3")
    assert distributed._pod_env() == (3, 4)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    monkeypatch.setenv("SLURM_LOCALID", "1")
    assert distributed.local_rank() == 1
    assert distributed.process_local_batch_size(8) == 8
    mesh = distributed.global_mesh(device="cpu")
    assert mesh.size == 1 and mesh.group is None
    batch = {"x": np.arange(6.0)}
    np.testing.assert_array_equal(
        distributed.host_local_batch_to_global(mesh, batch)["x"].numpy(),
        batch["x"])


def test_collectives_over_two_ranks():
    """shard_batch gives each rank its rows (and refuses a batch that does
    not divide), replicate and broadcast give rank 0's values, all_reduce
    sums, all_gather_rows concatenates in rank order bit for bit (float32,
    int64, bool, bfloat16), gather_batch's gradient is the rank's rows and
    gather_stats's the ranks' sum."""
    out = _spawn(collectives)
    for r, o in enumerate(out):
        np.testing.assert_array_equal(
            o["shard"], np.arange(12.0).reshape(6, 2)[3 * r:3 * r + 3])
        assert "not divisible" in o["shard_error"]
        np.testing.assert_array_equal(o["replicated"], np.ones((2, 3)))
        assert o["replicated_in_place"]
        assert o["replicated_tensor"].tolist() == [1.0, 1.0]
        assert o["broadcast"].tolist() == [5]
        assert o["sum"].tolist() == [3.0, 2.0]
        np.testing.assert_array_equal(o["gather_f32"], [[0.5, 0.0],
                                                        [1.5, 0.0]])
        assert o["gather_i64"].tolist() == [[7], [8]]
        assert o["gather_bool"].tolist() == [[True, True], [False, True]]
        assert o["gather_bf16"].tolist() == [[1.25], [2.25]]
        assert [o["dtype_" + k] for k in ("f32", "i64", "bool", "bf16")] \
            == ["torch.float32", "torch.int64", "torch.bool",
                "torch.bfloat16"]
        # d/dx of sum(g * arange): the rank's rows of arange
        np.testing.assert_array_equal(
            o["gather_batch_grad"],
            np.arange(12.0).reshape(4, 3)[2 * r:2 * r + 2])
        # each rank's loss weighs the gathered stats by rank + 1: 1 + 2
        np.testing.assert_array_equal(o["gather_stats_grad"],
                                      np.full((1, 2), 3.0))


def test_make_mesh_axes_over_four_ranks():
    """``make_mesh(4, ("data", "model"), (2, 2))`` on four ranks (one
    thread each): ranks in row-major order, so rank r sits at (r // 2,
    r % 2); each axis's group holds the ranks of its line, and an
    all-reduce along it sums only those; ``make_mesh(2)`` is the first two
    ranks' mesh, and None on the others."""
    out = _spawn(mesh_axes, n=4, threads=1)
    for r, o in enumerate(out):
        i, j = divmod(r, 2)
        assert o["data"] == {"ranks": [j, 2 + j], "rank": i,
                             "sum": float(2 * j + 2)}, (r, o)
        assert o["model"] == {"ranks": [2 * i, 2 * i + 1], "rank": j,
                              "sum": float(4 * i + 1)}, (r, o)
        assert o["grid_sum"] == 6.0
        assert o["pair"] == (([0, 1], 1.0) if r < 2 else None), (r, o)


# ---------------------------------------------------------- the dp step

def _port_single(spec):
    return dryrun.run_jobs(None, [("s", "dp_steps", spec)], "cpu")["s"]


@pytest.fixture(scope="module")
def variables():
    """Seeded flax variables of config N (8 classes) and of the inlier net
    (drawn through jax.eval_shape), and the port's state dicts of them."""
    from nanovs_slam_tpu.configs import get_config as jget
    from nanovs_slam_tpu.models.inlier_net import InlierNet as JaxInlierNet
    from nanovs_slam_tpu.models.kp2dtiny import build_model as jbuild
    from nanovs_slam_torch.configs import get_config
    from nanovs_slam_torch.models.inlier_net import InlierNet
    from nanovs_slam_torch.models.kp2dtiny import build_model

    params, stats = random_variables(jbuild(jget("N", n_classes=8)),
                                     np.zeros((1, H, W, 3), np.float32),
                                     False, seed=1)
    io_params, io_stats = random_variables(
        JaxInlierNet(blocks=4), np.zeros((1, 16, 5), np.float32), False,
        seed=2)
    model = load_jax_variables(build_model(get_config("N", n_classes=8)),
                               params, stats)
    io = load_jax_inlier_net(InlierNet(), io_params, io_stats)
    init = {"model": {k: v.numpy() for k, v in model.state_dict().items()},
            "io": {k: v.numpy() for k, v in io.state_dict().items()}}
    return (params, stats, io_params, io_stats), init


def _jax_mesh_step(jvars, batch):
    """One JAX ``make_train_step`` of config N on ``make_mesh(2)`` (state
    replicated, batch sharded), dropout off, from step 0 -> (metrics,
    the updated variables)."""
    from nanovs_slam_tpu.configs import get_config as jget
    from nanovs_slam_tpu.models.inlier_net import InlierNet as JaxInlierNet
    from nanovs_slam_tpu.models.kp2dtiny import build_model as jbuild
    from nanovs_slam_tpu.parallel.mesh import make_mesh, replicate, \
        shard_batch
    from nanovs_slam_tpu.train.schedules import DEFAULT_LOSS_WEIGHTS
    from nanovs_slam_tpu.train.train_step import (TrainState, make_optimizer,
                                                  make_train_step)

    params, stats, io_params, io_stats = jvars
    jcfg = jget("N", n_classes=8)
    tx = make_optimizer("adam", LR)
    step = make_train_step(jbuild(jcfg), jcfg, H, W,
                           io_net=JaxInlierNet(blocks=4), donate=False)
    state = TrainState(step=jnp.int32(0), params=params, batch_stats=stats,
                       io_params=io_params, io_batch_stats=io_stats,
                       opt_state=tx.init({"model": params,
                                          "io": io_params}), tx=tx)
    mesh = make_mesh(2)
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_blocks.Dropout2d, "__call__",
               lambda self, x, train=False: x)
    try:
        state, met = step(replicate(mesh, state), shard_batch(
            mesh, {k: jnp.asarray(v) for k, v in batch.items()}),
            DEFAULT_LOSS_WEIGHTS, jax.random.PRNGKey(0))
        met = {k: float(v) for k, v in met.items()}
    finally:
        mp.undo()
    return met, {k: jax.tree_util.tree_map(np.asarray, getattr(state, k))
                 for k in ("params", "batch_stats", "io_params",
                           "io_batch_stats")}


def _assert_one_step(got, want_metrics, want_state, ref_grads):
    """One step's results against a reference: every loss term within 1e-5
    of max(1, |term|), grad_norm within 1e-5 relative; the data-parallel
    step's raw gradients within 5e-2 in relative L2 of ``ref_grads`` (the
    single-process step's; chip_smoke's bound; measured 1.3e-3 with dropout
    off, 1.1e-4 on, 1.9e-3 on the epoch's first step); the parameters
    within 1e-5 wherever the reference's raw gradient is at least 1e-6,
    but for at most 1% of those weights in any tensor (at least one:
    ``dryrun.adam_step_offenders``), which stay within 2 lr; within 2 lr
    everywhere; the BN statistics
    within 1e-5 (the bounds of test_train_step_updated_params_match_jax).
    Seeded random weights make these gradients ill-conditioned: float32
    noise flips the sign of a few above 1e-6, which Adam's first step
    turns into 2 lr (measured: at most 18 weights in a tensor of 20,723,
    0.09%, and one in a tensor of 48). A gradient of the wrong sign
    throughout a tensor fails the 1%, one of the wrong size the L2."""
    for k, w in want_metrics.items():
        lim = 1e-5 * (abs(w) if k == "grad_norm" else max(1.0, abs(w)))
        assert abs(got["metrics"][0][k] - w) <= lim, (k, got["metrics"][0][k],
                                                      w)
    assert dryrun.grad_rel_l2(got["grads"], ref_grads) <= 5e-2
    state = got["state"]
    assert dryrun.adam_step_offenders(state, want_state, ref_grads) == []
    for k, w in want_state.items():
        d = np.abs(state[k] - w)
        if k.endswith(("running_mean", "running_var")):
            assert d.max() <= 1e-5, k
        elif w.dtype.kind == "f" and not k.endswith("num_batches_tracked"):
            assert d.max() <= 2 * LR, k


def _port_state_as_numpy(jstate):
    """The JAX step's updated variables as the port's numpy state dict."""
    from nanovs_slam_torch.configs import get_config
    from nanovs_slam_torch.models.inlier_net import InlierNet
    from nanovs_slam_torch.models.kp2dtiny import build_model

    model = load_jax_variables(build_model(get_config("N", n_classes=8)),
                               jstate["params"], jstate["batch_stats"])
    io = load_jax_inlier_net(InlierNet(), jstate["io_params"],
                             jstate["io_batch_stats"])
    out = {"model." + k: v.numpy() for k, v in model.state_dict().items()}
    out.update({"io." + k: v.numpy() for k, v in io.state_dict().items()})
    return out


def test_dp_step_matches_single_process_and_jax(variables):
    """A 2-rank data-parallel step (config N, 48x64, global batch 4, Adam
    5e-4, seeded flax variables) against the port's single-process step on
    the same global batch and against the JAX ``make_train_step`` on the
    2-device mesh (dropout off on both sides: their streams differ), with
    _assert_one_step's bounds; with dropout on (the ranks keep their rows
    of the global batch's mask) against the single-process step with the
    same generator. Both ranks end with the same state and metrics."""
    jvars, init = variables
    batch = dryrun.train_batch(H, W, B, 8, 3)
    base = dict(config="N", n_classes=8, H=H, W=W, steps=1, lr=LR,
                batch=batch, grads=True)
    jobs = [("off", "dp_steps", dict(base, init=init, dropout=False)),
            ("on", "dp_steps", dict(base, dropout=True))]
    ranks = _spawn(dryrun.run_jobs, jobs)
    got = distributed.same_on_every_rank(ranks)
    for name, _, spec in jobs:
        want = _port_single(spec)
        _assert_one_step(dict(got[name]["first"],
                              metrics=got[name]["metrics"]),
                         want["metrics"][0], want["state"],
                         want["first"]["grads"])
    jmet, jstate = _jax_mesh_step(jvars, batch)
    want = _port_single(jobs[0][2])
    assert set(jmet) == set(got["off"]["metrics"][0])
    _assert_one_step(dict(got["off"]["first"], metrics=got["off"]["metrics"]),
                     jmet, _port_state_as_numpy(jstate),
                     want["first"]["grads"])


def test_dp_epoch_matches_single_process():
    """A 2-rank ``shard_epoch_inputs`` epoch of 2 steps (config N, 48x64,
    the card-resident loader's global batch 4, dropout on) against the
    single-process epoch. The first step as the dp step test holds it
    (_assert_one_step: its loss terms, raw gradients, the parameters and
    BN statistics after it). The second: its loss terms within 1e-3 of
    max(1, |term|) (measured 4.2e-4), but the IO term within 1e-2 (its
    inputs are argmin associations, ROADMAP Queue 3; measured 4.7e-3); its
    raw gradients within 0.25 in relative L2 (measured 0.113); the model's
    BN statistics within 1e-3 of max(1, |value|) (measured 3.0e-4; the
    inlier net's, fed by the associations, are not held after the first
    step). The second step cannot be held tighter: the first Adam step
    moves a weight whose gradient is near 0 by up to lr either way (as
    test_train_step_updated_params_match_jax says), and in one process a
    1e-7 relative change of the initial weights alone moves the second
    step's gradients by 0.118 in relative L2 and two fifths of the
    weights by more than 1e-5 (measured)."""
    spec = dict(config="N", n_classes=8, H=H, W=W, steps=2, lr=LR, B=B,
                grads=True)
    job = [("e", "dp_epoch", spec)]
    got = distributed.same_on_every_rank(_spawn(dryrun.run_jobs, job))["e"]
    want = dryrun.run_jobs(None, job, "cpu")["e"]
    assert set(got["metrics"]) == set(want["metrics"])
    steps = [[{k: float(v[i]) for k, v in r["metrics"].items()}
              for i in range(2)] for r in (got, want)]
    _assert_one_step(dict(got["first"], metrics=steps[0][:1]), steps[1][0],
                     want["first"]["state"], want["first"]["grads"])
    io = [{k: v for k, v in m.items() if k == "io_loss"} for m in
          (steps[0][1], steps[1][1])]
    rest = [{k: v for k, v in m.items() if k != "io_loss"} for m in
            (steps[0][1], steps[1][1])]
    assert dryrun.compare_steps([rest[0]], [rest[1]])[0][0] <= 1e-3, steps
    assert abs(io[0]["io_loss"] - io[1]["io_loss"]) <= 1e-2 * max(
        1.0, abs(io[1]["io_loss"])), io
    assert dryrun.grad_rel_l2(got["grads"], want["grads"]) <= 0.25
    st = dryrun.compare_states(got["state"], want["state"])
    assert st["model_bn"] <= 1e-3, st


# ------------------------------------------------------------ offline VO

@pytest.fixture(scope="module")
def corridor_frames(tmp_path_factory):
    """The seeded corridor's first 4 frames at 96x320, float [0, 1]."""
    pytest.importorskip("cv2")
    from nanovs_slam_torch.vo import visual_odometry as port_vo

    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from make_synthetic_kitti import make_corridor_sequence

    out = str(tmp_path_factory.mktemp("corridor"))
    make_corridor_sequence(out, n_frames=6, W_img=320, H_img=96, seed=3)
    frames = list(port_vo.read_video(os.path.join(out, "06.mp4")))[:4]
    return torch.stack([port_vo.prep_frame(f) for f in frames]).numpy()


def _jax_patches(monkeypatch, table, lo):
    """jax.random split / gumbel / fold_in giving call k of pair i the
    noise table[i, k]: fold_in keeps the pair in the key's second word,
    split numbers restarts and stages in its first (the scheme of
    test_torch_port_offline.py)."""
    def fold_in(key, i):
        return jnp.stack([jnp.zeros((), jnp.uint32), jnp.asarray(
            i, jnp.uint32)])

    def split(key, num=2):
        c = jnp.asarray(key)[0]
        return jnp.stack([jnp.stack([c * 16 + i + 1, jnp.asarray(key)[1]])
                          for i in range(num)]).astype(jnp.uint32)

    def gumbel(key, shape, dtype=jnp.float32):
        c, pair = jnp.asarray(key)[0], jnp.asarray(key)[1]
        r = jnp.maximum(c // 16, 1) - 1
        t = jnp.asarray(table.reshape(table.shape[0], -1, *shape))
        return t[pair, r * (1 + lo) + c % 16 - 1]

    monkeypatch.setattr(jax.random, "fold_in", fold_in)
    monkeypatch.setattr(jax.random, "split", split)
    monkeypatch.setattr(jax.random, "gumbel", gumbel)


def test_sharded_vo_matches_relative_poses_and_jax(corridor_frames,
                                                   monkeypatch):
    """Pinned S8's BF offline VO over 4 corridor frames (3 pairs: the pair
    count padded to 4 over 2 ranks, the pad dropped), 256 hypotheses, 1
    restart: ``relative_poses_sharded`` on 2 ranks against
    ``relative_poses`` in this process, every pair's RANSAC noise injected
    from one table by its global index (the ranks see only their pairs):
    poses, inlier and match counts equal. Against the JAX package's
    ``relative_poses_sharded`` on ``make_mesh(2)`` under the same noise
    (its jax.random patched) and ``jax.enable_x64`` (the port solves in
    float64; in float32 the JAX RANSAC picks another winner on one of these
    pairs, ROADMAP Queue 3): match and inlier counts equal, the poses
    within 1e-4 (measured 6.7e-6)."""
    from nanovs_slam_tpu.configs import get_config as jget
    from nanovs_slam_tpu.models.kp2dtiny import build_model as jbuild
    from nanovs_slam_tpu.parallel.mesh import make_mesh
    from nanovs_slam_tpu.vo.offline import OfflineVO as JaxOffline
    from nanovs_slam_torch.utils.checkpoint import load_npz_checkpoint
    from nanovs_slam_torch.vo.camera import PinholeCamera, kitti_params

    frames = corridor_frames
    k, hyp, lo = 256, 256, 2
    table = np.random.RandomState(11).gumbel(
        size=(3, 1 + lo, hyp, k)).astype(np.float32)
    spec = dict(frames=frames, matcher="bf", k=k, n_hypotheses=hyp,
                restarts=1, extract_chunk=4)
    got = distributed.same_on_every_rank(
        _spawn(vo_with_noise, spec, table))
    monkeypatch.setattr(port_pose, "gumbel_noise", pair_noise(3, table))
    want = dryrun.sharded_vo(None, spec, "cpu")
    for key in ("R", "t", "n_inliers", "n_matches"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["R"].shape == (3, 3, 3) and int(got["n_matches"].min()) > 30

    tree, _ = load_npz_checkpoint(dryrun.PINNED_EX)
    jcfg = jget("S", n_classes=8)
    fx, fy, cx, cy = kitti_params()
    jvo = JaxOffline(jbuild(jcfg), jcfg, {"params": tree["params"],
                                          "batch_stats": tree["batch_stats"]},
                     frames.shape[1:3], PinholeCamera(
                         frames.shape[2], frames.shape[1], fx, fy, cx, cy),
                     k=k, matcher="bf", n_hypotheses=hyp, restarts=1,
                     extract_chunk=4)
    _jax_patches(monkeypatch, table, lo)
    with jax.enable_x64():
        R, t, ninl, nmat = jvo.relative_poses_sharded(frames, make_mesh(2))
    np.testing.assert_array_equal(nmat, got["n_matches"])
    np.testing.assert_array_equal(ninl, got["n_inliers"])
    np.testing.assert_allclose(R, got["R"], atol=1e-4)
    np.testing.assert_allclose(t, got["t"], atol=1e-4)


# ------------------------------------------------------- eval fan-out, TP

def test_eval_fanout_matches_single_run_and_jax(variables):
    """``sharded_infer_fn`` + ``map_batched`` over 11 items at batch 8 on
    2 ranks (config N, 48x64, the seeded flax variables) against the plain
    infer over the same batches and against the JAX ``sharded_infer_fn``
    on ``make_mesh(2)``: every output within 1e-5, the integer ones
    equal."""
    from nanovs_slam_tpu.configs import get_config as jget
    from nanovs_slam_tpu.inference import make_infer_fn as jinfer
    from nanovs_slam_tpu.models.kp2dtiny import build_model as jbuild
    from nanovs_slam_tpu.parallel.eval_fanout import map_batched, \
        sharded_infer_fn
    from nanovs_slam_tpu.parallel.mesh import make_mesh

    (params, stats, _, _), init = variables
    spec = dict(config="N", n_classes=8, H=H, W=W, n_items=11,
                batch_size=8, init=init["model"])
    job = [("f", "fanout", spec)]
    got = distributed.same_on_every_rank(
        _spawn(dryrun.run_jobs, job))["f"]["out"]
    want = dryrun.run_jobs(None, job, "cpu")["f"]["out"]
    assert got["score"].shape[0] == 11
    assert dryrun.compare_outputs(got, want) <= 1e-5
    jcfg = jget("N", n_classes=8)
    items = np.random.RandomState(5).rand(11, H, W, 3).astype(np.float32)
    run = sharded_infer_fn(jinfer(jbuild(jcfg), jcfg, H, W),
                           {"params": params, "batch_stats": stats},
                           make_mesh(2))
    res = map_batched(run, list((items - 0.5) * 2.0), batch_size=8)
    jout = {k: np.concatenate([np.asarray(r[k]) for r in res])
            for k in ("score", "coord", "feat", "vlad")}
    for k, v in jout.items():
        np.testing.assert_allclose(got[k], v, atol=1e-5, err_msg=k)


def test_tp_lightglue_matches_replicated_and_jax():
    """Head-parallel LightGlue on 2 ranks (D = 64, 4 heads, 2 layers, 24
    keypoints a side with masked pads; seeded flax params sharded through
    ``tp_shard_variables``) against the port's replicated forward and
    against the JAX ``tp_lightglue_forward`` on a (1, 2) ("data",
    "model") mesh: matches equal, the log assignment within 2e-4 (the JAX
    test's bound). The specs split Wqkv and fc1 by output rows and
    out_proj by input columns, and replicate the heads."""
    from nanovs_slam_tpu.matching.lightglue import LightGlue as JaxLightGlue
    from nanovs_slam_tpu.matching.lightglue import \
        LightGlueConfig as JaxConfig
    from nanovs_slam_tpu.parallel.mesh import make_mesh
    from nanovs_slam_tpu.parallel.tp import tp_lightglue_forward
    from nanovs_slam_torch.parallel.tp import lightglue_param_specs

    lg = dict(input_dim=64, descriptor_dim=64, n_layers=2, num_heads=4)
    data = dryrun.lightglue_data(64, 24, dryrun.SEED + 1)
    jdata = {k: jnp.asarray(v.numpy()) for k, v in data.items()}
    jmodel = JaxLightGlue(JaxConfig(**lg))
    params, _ = random_variables(jmodel, jdata, True, seed=4)
    spec = dict(lg=lg, jax_params=params, K=24)
    job = [("tp", "tp_lightglue", spec)]
    got = distributed.same_on_every_rank(_spawn(dryrun.run_jobs, job))["tp"]
    want = dryrun.run_jobs(None, job, "cpu")["tp"]
    np.testing.assert_array_equal(got["matches0"], want["matches0"])
    np.testing.assert_allclose(got["log_assignment"],
                               want["log_assignment"], atol=2e-4)
    jout = tp_lightglue_forward(
        make_mesh(2, axis_names=("data", "model"), shape=(1, 2)), jmodel,
        {"params": params})(jdata)
    np.testing.assert_array_equal(got["matches0"],
                                  np.asarray(jout["matches0"]))
    np.testing.assert_allclose(got["log_assignment"],
                               np.asarray(jout["log_assignment"]), atol=2e-4)
    specs = lightglue_param_specs(dryrun._lightglue(spec).state_dict())
    assert specs["transformers_0.self_attn.Wqkv.weight"] == 0
    assert specs["transformers_0.self_attn.out_proj.weight"] == 1
    assert specs["transformers_0.self_attn.out_proj.bias"] is None
    assert specs["transformers_0.cross_attn.ffn.norm.weight"] == 0
    assert specs["log_assignment_0.final_proj.weight"] is None
    assert specs["posenc.Wr"] is None


# ------------------------------------------------------------ the CLIs

def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    return env


@pytest.mark.parametrize("flags,refusal", [
    (["--num_devices", "2"], None),
    (["--num_devices", "4", "--num_processes", "2", "--process_id", "1",
      "--coordinator_address", "10.0.0.1:29500"], None),
    (["--num_devices", "2", "--device_cache", "--scan_epoch"], None),
    (["--num_processes", "2", "--process_id", "0", "--coordinator_address",
      "10.0.0.1:29500", "--device_cache"], "single-process only"),
    (["--num_devices", "3", "--num_processes", "2"], "does not split"),
    (["--num_devices", "3"], "--batch_size 4 does not split"),
    (["--num_processes", "2"], "needs --coordinator_address")])
def test_trainer_checks_its_parallel_flags(flags, refusal):
    """The data-parallel flags are accepted (they exited, naming ROADMAP
    Queue 1 item 7); --device_cache with more than one process exits as
    the JAX CLI does, and so do layouts that do not split."""
    from nanovs_slam_torch.train_multitask import check_supported, parse_args

    args = parse_args(flags + ["--device", "cpu"])
    if refusal is None:
        check_supported(args)
    else:
        with pytest.raises(SystemExit, match=refusal):
            check_supported(args)


@pytest.mark.parametrize("start", ["spawn", "launcher", "device_cache"])
def test_trainer_runs_data_parallel_on_cpu(tmp_path, start):
    """``train_multitask --device cpu`` on 2 ranks, 2 steps an epoch on
    the synthetic set (config S, 96x128, global batch 4): with
    ``--num_devices 2`` (the CLI spawns the ranks), so over 2 epochs with
    ``--device_cache`` (the state and cache replicated once, each epoch's
    indices split), or as two processes that a launcher started
    (torchrun's RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT,
    no parallel flags: each joins the group through ``initialize``). Rank
    0's first line says how the ranks run, it logs finite losses, and it
    alone writes metrics.jsonl and a checkpoint an epoch (the step itself
    is held against the single-process one above)."""
    epochs = 2 if start == "device_cache" else 1
    cmd = [sys.executable, "-m", "nanovs_slam_torch.train_multitask",
           "--device", "cpu", "--no_eval", "--dataset_name", "synthetic",
           "--batch_size", "4", "--synthetic_items", "8",
           "--max_steps_per_epoch", "2", "--log_every", "1", "--n_epochs",
           str(epochs), "--out_model_path", "ck"]
    if start != "launcher":
        flags = ["--num_devices", "2"] + (
            ["--device_cache"] if start == "device_cache" else [])
        r = subprocess.run(cmd + flags, cwd=tmp_path,
                           env=_env(), capture_output=True, text=True,
                           timeout=300)
        first = "data parallel: 2 ranks, 2 on process 0 of 1, over gloo " \
            "on cpu"
    else:
        port = str(distributed.free_port())
        procs = [subprocess.Popen(
            cmd, cwd=tmp_path, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=dict(
                _env(), RANK=str(i), LOCAL_RANK=str(i), WORLD_SIZE="2",
                MASTER_ADDR="127.0.0.1", MASTER_PORT=port))
            for i in range(2)]
        outs = [p.communicate(timeout=300) for p in procs]
        r = subprocess.CompletedProcess(cmd, max(p.returncode
                                                 for p in procs),
                                        outs[0][0], outs[0][1] + outs[1][1])
        assert outs[1][0] == "", outs[1][0]  # rank 1 prints nothing
        first = "data parallel: 2 ranks, 1 on process 0 of 2, over gloo " \
            "on cpu"
    assert r.returncode == 0, r.stdout + r.stderr
    out = r.stdout.splitlines()
    assert out[0] == first, out
    for e in range(epochs):
        steps = [line for line in out if line.startswith(f"E{e} it")]
        assert len(steps) == 2 and all(
            np.isfinite(float(line.split()[3])) for line in steps), out
        assert out.count(f"E{e} checkpoint ck.npz") == 1, out
    assert (tmp_path / "ck.npz").exists()
    lines = open(tmp_path / "metrics.jsonl").read().splitlines()
    # the config and two steps an epoch, from rank 0 alone
    assert len(lines) == 1 + 2 * epochs


def test_dryrun_exits_zero_on_cpu():
    """``python -m nanovs_slam_torch.dryrun 2 --device cpu``: every check
    passes, the dp x sp one (a (1, 2) mesh) among them."""
    r = subprocess.run([sys.executable, "-m", "nanovs_slam_torch.dryrun",
                        "2", "--device", "cpu"], cwd=REPO, env=_env(),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "dryrun_multichip(2): ok" in r.stdout
    assert "dryrun dp x sp: ok," in r.stdout
    assert r.stdout.count(": ok,") == 6, r.stdout
