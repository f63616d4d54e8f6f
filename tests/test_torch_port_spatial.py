"""The port's spatial partitioning (``nanovs_slam_torch/parallel/spatial.py``
and the halo exchange of ``parallel/mesh.py``) on the CPU, for KP2DTiny
and KeypointFormer: one group of four ranks spawned over gloo (one torch
thread each) runs every check, each held against the same work in this
process and against the JAX package's single-device program on the same
seeded flax variables. Each test states its tolerance."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import nanovs_slam_tpu.modules.blocks as jax_blocks
from _torch_port_util import apply_jit, random_variables
from _torch_spatial_workers import spatial_jobs
from nanovs_slam_torch import dryrun
from nanovs_slam_torch.parallel import distributed
from nanovs_slam_torch.parallel.spatial import (SpatialParallel,
                                                slab_bounds, slab_unit,
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
    # KeypointFormer: slabs of 32, and of 64 and 96 rows
    "kf_tiny": ("tiny", False, (64, 64), 1, 2, 1, None),
    "kf_tiny_uneven": ("tiny", False, (160, 64), 1, 2, 1, None),
    "kf_default": ("default", False, (64, 64), 1, 2, 1, None),
    "kf_default_uneven": ("default", False, (160, 64), 1, 2, 1, None),
    "kf_request": ("default", False, (64, 64), 1, 2, 1, 50),
}
KF = ("tiny", "default")
# the slabbed convs of test_strided_slab_convs_match_the_whole_map: (kernel,
# stride, pad) of KeypointFormer's VPR head, its stage-0 and later patch
# embeds (and score / loc heads), and a stride-1 3x3
SLAB_CONVS = ((1, 2, 1), (7, 4, 3), (3, 2, 1), (3, 1, 1))
KF_TRAIN_HW = (64, 64)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads here (see test_torch_port_train_step.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_model(name, v3):
    """The JAX package's model of config ``name`` (KeypointFormer's for
    "tiny" and "default"), 8 classes."""
    if name in KF:
        import dataclasses

        from nanovs_slam_tpu.models.keypoint_former import (
            KEYPOINTFORMER_CONFIGS, KeypointFormer)

        return KeypointFormer(dataclasses.replace(
            KEYPOINTFORMER_CONFIGS[name], n_classes=8))
    from nanovs_slam_tpu.configs import get_config as jget
    from nanovs_slam_tpu.models.kp2dtiny import build_model as jbuild

    return jbuild(jget(name, v3=v3, n_classes=8))


def _flax_variables(name, v3, seed):
    shape = (1, 64, 64, 3) if name in KF else (1, 48, 64, 3)
    return random_variables(_jax_model(name, v3), np.zeros(shape, np.float32),
                            False, seed=seed)


def _port_state(name, v3, params, stats):
    from nanovs_slam_torch.dryrun import _config

    cfg, _ = _config(dict(config=name, v3=v3, n_classes=8,
                          keypoint_former=name in KF))
    if name in KF:
        from nanovs_slam_torch.models.keypoint_former import build_model
    else:
        from nanovs_slam_torch.models.kp2dtiny import build_model
    model = load_jax_variables(build_model(cfg), params, stats)
    return {k: v.numpy() for k, v in model.state_dict().items()}


def _frames(B, H, W, seed):
    return np.random.RandomState(seed).rand(B, H, W, 3).astype(np.float32)


def _train_variables(name="N", seed=1):
    """The seeded flax variables of config ``name`` and of an inlier net,
    and the same as the port's numpy state dicts (a job's "init")."""
    from nanovs_slam_tpu.models.inlier_net import InlierNet as JaxInlierNet
    from nanovs_slam_torch.models.inlier_net import InlierNet

    params, stats = _flax_variables(name, False, seed)
    io_params, io_stats = random_variables(
        JaxInlierNet(blocks=4), np.zeros((1, 16, 5), np.float32), False,
        seed=2)
    io = load_jax_inlier_net(InlierNet(), io_params, io_stats)
    init = {"model": _port_state(name, False, params, stats),
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
    convs = dict(x=rs.randn(2, 4, 160, 10).astype(np.float32),
                 w=[rs.randn(3, 4, k, k).astype(np.float32) / k
                    for k, _, _ in SLAB_CONVS],
                 g=[rs.randn(2, 3, (160 + 2 * p - k) // st + 1,
                             (10 + 2 * p - k) // st + 1).astype(np.float32)
                    for k, st, p in SLAB_CONVS],
                 convs=SLAB_CONVS, bounds=(0, 64, 160))
    jobs = [("halo", "halo_conv", halo), ("bn", "slab_batch_norm", bn),
            ("convs", "slab_conv", convs), ("axes", "mesh_axes", {})]
    flax = {}
    for i, (name, (cfg, v3, (H, W), B, ns, nd, top_k)) in enumerate(
            FORWARDS.items()):
        params, stats = _flax_variables(cfg, v3, 10 + i)
        flax[name] = (params, stats)
        spec = dict(config=cfg, v3=v3, n_classes=8, ranks=ns, data=nd,
                    keypoint_former=cfg in KF, frames=_frames(B, H, W, i),
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
    kf_jvars, kf_init = _train_variables("tiny", 3)
    H, W = KF_TRAIN_HW
    jobs.append(("kf_train", "dp_steps", dict(
        config="tiny", keypoint_former=True, n_classes=8, H=H, W=W, steps=1,
        lr=LR, batch=dryrun.train_batch(H, W, 4, 8, 3, d_f=4), grads=True,
        init=kf_init, dropout=False, spatial=True)))
    ranks = distributed.spawn(spatial_jobs, 4, (jobs,), device="cpu",
                              threads=1, timeout=120, deadline=300)
    return {"jobs": {n: s for n, _, s in jobs}, "flax": flax,
            "jvars": jvars, "kf_jvars": kf_jvars, "ranks": ranks}


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
    """``spatial_forward`` (or, for "request" and "kf_request",
    ``make_spatial_infer_fn`` with top_k) of seeded flax variables on
    every spatial rank: within 1e-5 of the port's single process on the
    same weights (the request's integer outputs equal; KeypointFormer's
    request, whose decoded pixel coordinates reach 64 px, within 1e-5
    relative: its raw coord is 2.7e-6 apart, which the decode scales by
    8), and the raw forward within 2e-4 of the JAX single-device apply
    (the bound of tests/test_parallel_nd.py). Every rank of the mesh
    holds the whole answer."""
    from nanovs_slam_torch.ops.image import to_model_input

    cfg, v3, (H, W), B, ns, nd, top_k = FORWARDS[name]
    spec = setup["jobs"][name]
    got = [r[name]["out"] for r in setup["ranks"][:ns * nd]]
    assert all(r[name]["out"] == {} for r in setup["ranks"][ns * nd:])
    want = dryrun.sp_forward(None, spec, "cpu")["out"]
    want = {k: v.numpy() for k, v in want.items()}
    for g in got:
        assert set(g) == set(want)
        if cfg in KF and top_k:
            for k, w in want.items():
                np.testing.assert_allclose(g[k], w, rtol=1e-5, atol=1e-5,
                                           err_msg=k)
        else:
            assert dryrun.compare_outputs(g, want) <= 1e-5, name
    if top_k:
        return
    x = to_model_input(torch.from_numpy(spec["frames"])).numpy()
    params, stats = setup["flax"][name]
    jout = apply_jit(_jax_model(cfg, v3), params, stats, x, train=False)
    for k in want:
        np.testing.assert_allclose(got[0][k], jout[k], atol=2e-4, rtol=2e-4,
                                   err_msg=k)


def _jax_step(jvars, batch, name="N", hw=TRAIN_HW):
    """One JAX ``make_train_step`` of config ``name`` (KeypointFormer's for
    "tiny" and "default") at ``hw`` on one device, dropout off, from step
    0 -> its metrics."""
    import jax
    import jax.numpy as jnp

    from nanovs_slam_tpu.configs import get_config as jget
    from nanovs_slam_tpu.models.inlier_net import InlierNet as JaxInlierNet
    from nanovs_slam_tpu.models.kp2dtiny import build_model as jbuild
    from nanovs_slam_tpu.train.schedules import DEFAULT_LOSS_WEIGHTS
    from nanovs_slam_tpu.train.train_step import (TrainState, make_optimizer,
                                                  make_train_step)

    params, stats, io_params, io_stats = jvars
    if name in KF:
        model = _jax_model(name, False)
        jcfg = model.cfg
    else:
        jcfg = jget(name, n_classes=8)
        model = jbuild(jcfg)
    tx = make_optimizer("adam", LR)
    step = make_train_step(model, jcfg, *hw, io_net=JaxInlierNet(blocks=4),
                           donate=False)
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


def test_keypoint_former_slabs_refuse_short_and_unaligned_frames():
    """KeypointFormer's slab unit is 32 rows (its fourth stage is at H/32),
    not twice its cell; a frame of fewer than 32 rows a rank raises
    ValueError, as do a frame the model refuses (48 rows) and one it
    takes whose H is no multiple of 32 (253 rows: ceil(253 / 4) = 64), in
    ``spatial_forward`` and in the train step's ``place``, before any
    work."""
    import dataclasses

    from nanovs_slam_torch.models.keypoint_former import (
        KEYPOINTFORMER_CONFIGS, init_model)
    from nanovs_slam_torch.parallel.mesh import make_mesh

    cfg = dataclasses.replace(KEYPOINTFORMER_CONFIGS["tiny"], n_classes=8)
    assert slab_unit(cfg) == 32
    assert slab_bounds(160, 2, 32) == (0, 64, 160)
    assert slab_bounds(256, 4, 32) == (0, 64, 128, 192, 256)
    with pytest.raises(ValueError, match="cannot be split"):
        slab_bounds(32, 2, 32)
    mesh = make_mesh(axis_names=("model",), device="cpu")
    run = spatial_forward(mesh, init_model(
        cfg, torch.Generator().manual_seed(0), "cpu"))
    par = SpatialParallel(mesh, cfg, batch_axis=None)
    for h, match in ((48, "KeypointFormer: H"), (253, "multiple of 32")):
        with pytest.raises(ValueError, match=match):
            run(torch.zeros(1, h, 64, 3))
        with pytest.raises(ValueError, match=match):
            par.place({"image": np.zeros((1, h, 64, 3), np.float32),
                       "image_aug": np.zeros((1, h, 64, 3), np.float32)})


def test_strided_slab_convs_match_the_whole_map(setup):
    """The slabbed ``Conv2d`` over slabs of 64 and 96 rows (at multiples of
    the strides' product, as KeypointFormer's unit of 32 keeps them): the
    VPR head's 1x1 conv of stride 2 and pad 1 (81 output rows: rank 0
    writes rows 0-32, row 0 the bias alone, rank 1 rows 33-80, whose
    input rows 2o - 1 are its own), the 7x7 / 4 / 3 and 3x3 / 2 / 1
    patch embeds and a 3x3 / 1 / 1: every rank's rows, and the map
    gathered from them, within 1e-5 of the padded convolution of the
    whole map in this process, the rows not overlapping; the gradients
    of a weighted sum of the output (the slab's input, the weight summed
    over the ranks) within 1e-5 (of the weight gradient's largest
    magnitude) of autograd's."""
    spec, got = setup["jobs"]["convs"], [r["convs"] for r in setup["ranks"]]
    b = spec["bounds"]
    for i, (k, st, pad) in enumerate(spec["convs"]):
        x = torch.from_numpy(spec["x"]).requires_grad_()
        w = torch.from_numpy(spec["w"][i]).requires_grad_()
        y = F.conv2d(x, w, torch.full((3,), 0.25), st, pad)
        (y * torch.from_numpy(spec["g"][i])).sum().backward()
        want = y.detach().numpy()
        parts = [g[str(i)] for g in got[:2]]
        assert parts[0]["lo"] == 0
        assert parts[1]["lo"] == parts[0]["y"].shape[2]
        assert parts[1]["lo"] + parts[1]["y"].shape[2] == want.shape[2]
        if (k, st, pad) == (1, 2, 1):
            assert [p["y"].shape[2] for p in parts] == [33, 48]
        for p in parts:
            np.testing.assert_allclose(p["full"], want, atol=1e-5)
            lo = p["lo"]
            np.testing.assert_allclose(
                p["y"], want[:, :, lo:lo + p["y"].shape[2]], atol=1e-5)
            np.testing.assert_allclose(
                p["gw"], w.grad.numpy(), atol=1e-5 * float(
                    w.grad.abs().max()))
        np.testing.assert_allclose(
            np.concatenate([p["gx"] for p in parts], 2), x.grad.numpy(),
            atol=1e-5)
        assert [p["gx"].shape[2] for p in parts] == [b[1] - b[0],
                                                     b[2] - b[1]]
    assert all(r["convs"] == {} for r in setup["ranks"][2:])


def test_keypoint_former_spatial_train_step_matches_single_process_and_jax(
        setup):
    """``spatial_train_step`` of KeypointFormer "tiny" on a 2x2 ("data",
    "model") mesh (64x64: slabs of 32 rows, global batch 4, labels at
    d_f = 4, Adam 5e-4, from the seeded flax variables): BatchNorm over the whole
    mesh, the MiT's attention and NetVLAD (vladv2, its backward) on the
    gathered maps, the VPR head's strided rows, NetVLAD's gradient
    counted once over the spatial axis. Against the port's
    single-process step on the global batch, with chip_smoke.check_dp's
    bounds for a first step: every loss term within 1e-4 of max(1,
    |term|), grad_norm within 1e-4 relative, the raw gradients within
    5e-2 in relative L2, the BN statistics within 1e-5 of max(1, |value|)
    (``dryrun.compare_states``), no tensor with more than 1% of its
    weights whose reference gradient is at least 1e-6 moved over 1e-5
    off (``dryrun.adam_step_offenders``), every parameter within 2 lr;
    every rank alike. Against the JAX single-device step on the same batch
    from the same variables: the total loss and every loss term within
    1e-5 of max(1, |term|) (the bound of the single-process KeypointFormer
    step in tests/test_torch_port_keypoint_former.py; measured 8.6e-7)."""
    spec = setup["jobs"]["kf_train"]
    got = distributed.same_on_every_rank([r["kf_train"]
                                          for r in setup["ranks"]])
    want = dryrun.run_jobs(None, [("s", "dp_steps", dict(
        spec, spatial=False))], "cpu")["s"]
    gaps, norms = dryrun.compare_steps(got["metrics"], want["metrics"])
    assert gaps[0] <= 1e-4 and norms[0] <= 1e-4, (gaps, norms)
    assert got["metrics"][0]["vlad_loss"] > 0.0
    assert dryrun.grad_rel_l2(got["first"]["grads"],
                              want["first"]["grads"]) <= 5e-2
    first = dryrun.compare_states(got["first"]["state"],
                                  want["first"]["state"])
    assert first["model_bn"] <= 1e-5 and first["io_bn"] <= 1e-5, first
    assert first["params"] <= 2 * LR, first
    assert dryrun.adam_step_offenders(got["first"]["state"],
                                      want["first"]["state"],
                                      want["first"]["grads"]) == []
    jmet = _jax_step(setup["kf_jvars"], spec["batch"], "tiny", KF_TRAIN_HW)
    terms = [k for k in jmet if k.endswith("_loss")]
    assert "total_loss" in terms and jmet["vlad_loss"] > 0.0
    for k in terms:
        assert abs(got["metrics"][0][k] - jmet[k]) <= 1e-5 * max(
            1.0, abs(jmet[k])), (k, got["metrics"][0][k], jmet[k])
