"""The port's spatial partitioning (``nanovs_slam_torch/parallel/spatial.py``
and the halo exchange of ``parallel/mesh.py``) on the CPU: one group of
four ranks spawned over gloo (one torch thread each) runs every check, each
held against the same work in this process and against the JAX package's
single-device program on the same seeded flax variables. Each test states
its tolerance."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import nanovs_slam_tpu.modules.blocks as jax_blocks
from _torch_port_util import apply_jit, random_variables
from _torch_spatial_workers import spatial_jobs
from nanovs_slam_torch import dryrun
from nanovs_slam_torch.parallel import distributed
from nanovs_slam_torch.parallel.spatial import (slab_bounds, slab_unit,
                                                spatial_forward)
from nanovs_slam_torch.utils.convert import (load_jax_inlier_net,
                                             load_jax_variables)
from test_torch_port_parallel import _assert_one_step

LR = 5e-4
TRAIN_HW = (48, 64)
# name: (config, V3, (H, W), batch, spatial ranks, data rows, top_k)
FORWARDS = {
    "v2_n": ("N", False, (64, 64), 1, 2, 1, None),
    "v2_s_a": ("S_A", False, (64, 64), 1, 2, 1, None),
    "v3_s": ("S", True, (48, 64), 1, 2, 1, None),
    "uneven": ("N", False, (72, 64), 1, 2, 1, None),  # 32 and 40 rows
    "four_ranks": ("N", False, (96, 64), 1, 4, 1, None),
    "data_x_model": ("N", False, (64, 64), 2, 2, 2, None),
    "request": ("N", False, (64, 64), 1, 2, 1, 50),
}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads here (see test_torch_port_train_step.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_config(name, v3):
    from nanovs_slam_tpu.configs import get_config as jget

    return jget(name, v3=v3, n_classes=8)


def _flax_variables(name, v3, seed):
    from nanovs_slam_tpu.models.kp2dtiny import build_model as jbuild

    return random_variables(jbuild(_jax_config(name, v3)),
                            np.zeros((1, 48, 64, 3), np.float32), False,
                            seed=seed)


def _port_state(name, v3, params, stats):
    from nanovs_slam_torch.configs import get_config
    from nanovs_slam_torch.models.kp2dtiny import build_model

    model = load_jax_variables(build_model(get_config(name, v3=v3,
                                                      n_classes=8)),
                               params, stats)
    return {k: v.numpy() for k, v in model.state_dict().items()}


def _frames(B, H, W, seed):
    return np.random.RandomState(seed).rand(B, H, W, 3).astype(np.float32)


def _train_variables():
    from nanovs_slam_tpu.models.inlier_net import InlierNet as JaxInlierNet
    from nanovs_slam_torch.models.inlier_net import InlierNet

    params, stats = _flax_variables("N", False, 1)
    io_params, io_stats = random_variables(
        JaxInlierNet(blocks=4), np.zeros((1, 16, 5), np.float32), False,
        seed=2)
    io = load_jax_inlier_net(InlierNet(), io_params, io_stats)
    init = {"model": _port_state("N", False, params, stats),
            "io": {k: v.numpy() for k, v in io.state_dict().items()}}
    return (params, stats, io_params, io_stats), init


@pytest.fixture(scope="module")
def setup():
    """Every job's spec, the flax variables behind them, and the four
    ranks' results (one spawn)."""
    rs = np.random.RandomState(0)
    x = rs.randn(2, 5, 20, 12).astype(np.float32)
    halo = dict(x=x, w=rs.randn(3, 5, 3, 3).astype(np.float32),
                g=rs.randn(2, 3, 20, 12).astype(np.float32),
                bounds=(0, 6, 13, 16, 20))
    bn = dict(x=rs.randn(4, 3, 7, 5).astype(np.float32),
              g=rs.randn(4, 3, 7, 5).astype(np.float32),
              w=rs.rand(3).astype(np.float32) + 0.5, bounds=(0, 3, 7))
    jobs = [("halo", "halo_conv", halo), ("bn", "slab_batch_norm", bn),
            ("axes", "mesh_axes", {})]
    flax = {}
    for i, (name, (cfg, v3, (H, W), B, ns, nd, top_k)) in enumerate(
            FORWARDS.items()):
        params, stats = _flax_variables(cfg, v3, 10 + i)
        flax[name] = (params, stats)
        spec = dict(config=cfg, v3=v3, n_classes=8, ranks=ns, data=nd,
                    frames=_frames(B, H, W, i),
                    init=_port_state(cfg, v3, params, stats))
        if top_k:
            spec.update(request=True, top_k=top_k)
        jobs.append((name, "sp_forward", spec))
    jvars, init = _train_variables()
    H, W = TRAIN_HW
    train = dict(config="N", n_classes=8, H=H, W=W, steps=1, lr=LR,
                 batch=dryrun.train_batch(H, W, 4, 8, 3), grads=True,
                 init=init, spatial=True)
    jobs += [("train", "dp_steps", dict(train, dropout=False)),
             ("train_dropout", "dp_steps", dict(train, init=None))]
    ranks = distributed.spawn(spatial_jobs, 4, (jobs,), device="cpu",
                              threads=1, timeout=120, deadline=300)
    return {"jobs": {n: s for n, _, s in jobs}, "flax": flax,
            "jvars": jvars, "ranks": ranks}


def test_slab_bounds_split_at_the_unit_and_refuse_short_maps():
    """Slabs at multiples of twice the cell, the spare units to the last
    ranks and the remainder rows to the last rank; a map of fewer than
    unit * ranks rows raises ValueError, in ``spatial_forward`` too."""
    from nanovs_slam_torch.configs import get_config
    from nanovs_slam_torch.models.kp2dtiny import init_model
    from nanovs_slam_torch.parallel.mesh import make_mesh

    assert slab_unit(get_config("S")) == 8 and slab_unit(get_config("F")) \
        == 16
    assert slab_bounds(240, 2, 8) == (0, 120, 240)
    assert slab_bounds(240, 4, 8) == (0, 56, 112, 176, 240)
    assert slab_bounds(241, 2, 8) == (0, 120, 241)
    assert slab_bounds(23, 2, 8) == (0, 8, 23)
    with pytest.raises(ValueError, match="cannot be split"):
        slab_bounds(31, 4, 8)
    model = init_model(get_config("N"), torch.Generator().manual_seed(0),
                       "cpu")
    run = spatial_forward(make_mesh(axis_names=("model",), device="cpu"),
                          model)
    with pytest.raises(ValueError, match="cannot be split"):
        run(torch.zeros(1, 7, 16, 3))


def test_halo_gradient_matches_autograd_through_one_conv(setup):
    """A 3x3 convolution of a map split in slabs of 6, 7, 3 and 4 rows over
    four ranks, each slab extended by ``halo_rows``: its output and the
    gradients of a weighted sum of it (the slab's input, the weight summed
    over the ranks: a sum of 480 terms, within 1e-5 of its largest
    magnitude) within 1e-5 of autograd through the padded convolution of
    the whole map in this process."""
    spec, got = setup["jobs"]["halo"], [r["halo"] for r in setup["ranks"]]
    x = torch.from_numpy(spec["x"]).requires_grad_()
    w = torch.from_numpy(spec["w"]).requires_grad_()
    y = F.conv2d(x, w, padding=1)
    (y * torch.from_numpy(spec["g"])).sum().backward()
    b = spec["bounds"]
    np.testing.assert_allclose(np.concatenate([g["y"] for g in got], 2),
                               y.detach().numpy(), atol=1e-5)
    np.testing.assert_allclose(np.concatenate([g["gx"] for g in got], 2),
                               x.grad.numpy(), atol=1e-5)
    for r, g in enumerate(got):
        assert g["gx"].shape[2] == b[r + 1] - b[r]
        np.testing.assert_allclose(g["gw"], w.grad.numpy(),
                                   atol=1e-5 * float(w.grad.abs().max()))


def test_batch_norm_over_uneven_slabs_matches_one_process(setup):
    """Train-mode BatchNorm over a 2x2 mesh whose parts are two images by
    slabs of 3 and 4 rows: the output, the input's and the weight's
    gradients and the running variance within 1e-5 of one process's
    BatchNorm over the whole batch (the parts' statistics combined with
    their true counts)."""
    from nanovs_slam_torch.modules.blocks import BatchNorm2d

    spec, got = setup["jobs"]["bn"], [r["bn"] for r in setup["ranks"]]
    bn = BatchNorm2d(3).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(spec["w"]))
        bn.bias.fill_(0.3)
    x = torch.from_numpy(spec["x"]).requires_grad_()
    y = bn(x)
    (y * torch.from_numpy(spec["g"])).sum().backward()
    b = spec["bounds"]
    for r, g in enumerate(got):
        i, j = divmod(r, 2)
        part = (slice(2 * i, 2 * i + 2), slice(None), slice(b[j], b[j + 1]))
        np.testing.assert_allclose(g["y"], y.detach().numpy()[part],
                                   atol=1e-5)
        np.testing.assert_allclose(g["gx"], x.grad.numpy()[part], atol=1e-5)
        np.testing.assert_allclose(g["gw"], bn.weight.grad.numpy(),
                                   atol=1e-5)
        np.testing.assert_allclose(g["var"], bn.running_var.numpy(),
                                   atol=1e-5)


def test_make_mesh_groups_follow_the_jax_device_order(setup):
    """``make_mesh(4, ("data", "model"), (2, 2))``: every rank's data and
    model groups are the column and the row of the JAX ``make_mesh``'s
    device grid that hold its device (rank r is device r)."""
    from nanovs_slam_tpu.parallel.mesh import make_mesh as jax_make_mesh

    grid = np.vectorize(lambda d: d.id)(jax_make_mesh(
        4, axis_names=("data", "model"), shape=(2, 2)).devices)
    for r, res in enumerate(setup["ranks"]):
        i, j = map(int, np.argwhere(grid == r)[0])
        assert res["axes"]["data"]["ranks"] == grid[:, j].tolist(), r
        assert res["axes"]["model"]["ranks"] == grid[i, :].tolist(), r
        assert (res["axes"]["data"]["rank"], res["axes"]["model"]["rank"]) \
            == (i, j)


@pytest.mark.parametrize("name", list(FORWARDS))
def test_spatial_forward_matches_single_process_and_jax(setup, name):
    """``spatial_forward`` (or, for "request", ``make_spatial_infer_fn``
    with top_k) of seeded flax variables on every spatial rank: within
    1e-5 of the port's single process on the same weights (the request's
    integer outputs equal), and the raw forward within 2e-4 of the JAX
    single-device apply (the bound of tests/test_parallel_nd.py). Every
    rank of the mesh holds the whole answer."""
    from nanovs_slam_tpu.models.kp2dtiny import build_model as jbuild
    from nanovs_slam_torch.ops.image import to_model_input

    cfg, v3, (H, W), B, ns, nd, top_k = FORWARDS[name]
    spec = setup["jobs"][name]
    got = [r[name]["out"] for r in setup["ranks"][:ns * nd]]
    assert all(r[name]["out"] == {} for r in setup["ranks"][ns * nd:])
    want = dryrun.sp_forward(None, spec, "cpu")["out"]
    want = {k: v.numpy() for k, v in want.items()}
    for g in got:
        assert set(g) == set(want)
        assert dryrun.compare_outputs(g, want) <= 1e-5, name
    if top_k:
        return
    x = to_model_input(torch.from_numpy(spec["frames"])).numpy()
    params, stats = setup["flax"][name]
    jout = apply_jit(jbuild(_jax_config(cfg, v3)), params, stats, x,
                     train=False)
    for k in want:
        np.testing.assert_allclose(got[0][k], jout[k], atol=2e-4, rtol=2e-4,
                                   err_msg=k)


def _jax_step(jvars, batch):
    """One JAX ``make_train_step`` of config N at TRAIN_HW on one device,
    dropout off, from step 0 -> its metrics."""
    import jax
    import jax.numpy as jnp

    from nanovs_slam_tpu.models.inlier_net import InlierNet as JaxInlierNet
    from nanovs_slam_tpu.models.kp2dtiny import build_model as jbuild
    from nanovs_slam_tpu.train.schedules import DEFAULT_LOSS_WEIGHTS
    from nanovs_slam_tpu.train.train_step import (TrainState, make_optimizer,
                                                  make_train_step)

    params, stats, io_params, io_stats = jvars
    jcfg = _jax_config("N", False)
    tx = make_optimizer("adam", LR)
    step = make_train_step(jbuild(jcfg), jcfg, *TRAIN_HW,
                           io_net=JaxInlierNet(blocks=4), donate=False)
    state = TrainState(step=jnp.int32(0), params=params, batch_stats=stats,
                       io_params=io_params, io_batch_stats=io_stats,
                       opt_state=tx.init({"model": params,
                                          "io": io_params}), tx=tx)
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_blocks.Dropout2d, "__call__",
               lambda self, x, train=False: x)
    try:
        _, met = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                      DEFAULT_LOSS_WEIGHTS, jax.random.PRNGKey(0))
        return {k: float(v) for k, v in met.items()}
    finally:
        mp.undo()


@pytest.mark.parametrize("name", ["train", "train_dropout"])
def test_spatial_train_step_matches_single_process_and_jax(setup, name):
    """``spatial_train_step`` on a 2x2 ("data", "model") mesh (config N at
    48x64: slabs of 24 rows, global batch 4, Adam 5e-4) from
    the seeded flax variables ("train", dropout off) or the seeded port
    weights ("train_dropout": dropout on, every slab of an image keeping
    its rows of the global draw): against the port's single-process step
    on the global batch with _assert_one_step's bounds, every rank alike;
    "train"'s total loss within 5e-4 of the JAX single-device step's (the
    bound of tests/test_parallel_nd.py). Uneven slabs' statistics are
    held by test_batch_norm_over_uneven_slabs_matches_one_process: at
    56x64 (slabs of 24 and 32 rows) these seeded weights make the step
    ill-conditioned (in one process, 1e-7 of input noise moves grad_norm
    by 3.4e-6 relative; the step on the mesh lands 1.7e-5 off, past
    _assert_one_step's 1e-5, its worst tensors the backbone's first BN
    scales, 1.5-3% off in L2, against 0.7-1% for the dp step)."""
    spec = setup["jobs"][name]
    got = distributed.same_on_every_rank([r[name] for r in setup["ranks"]])
    want = dryrun.run_jobs(None, [("s", "dp_steps", spec)], "cpu")["s"]
    _assert_one_step(dict(got["first"], metrics=got["metrics"]),
                     want["metrics"][0], want["first"]["state"],
                     want["first"]["grads"])
    if name == "train":
        jmet = _jax_step(setup["jvars"], spec["batch"])
        assert np.isclose(got["metrics"][0]["total_loss"],
                          jmet["total_loss"], rtol=5e-4, atol=5e-4)
