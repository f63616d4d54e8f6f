"""One whole multitask train step of the port against the JAX package's
``make_train_step`` on the CPU: config S (pinned S8 weights with seeded
NetVLAD centroids, its inlier net), 48x64, batch 2, Adam at 5e-4, the
same batch, with channel dropout patched to the identity on both sides
(their random streams differ; the port's dropout is held by
``test_torch_port_train_losses.py``). Plus a
checkpoint round trip through the JAX ``load_checkpoint``, a resumed
run's first step against the JAX trainer's (``restore_train_state``
against ``filter_params`` + ``merge_params`` into a fresh state), the
CLI's refusal of the flags whose modules wait in ROADMAP.md, and
freeze_backbone."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nanovs_slam_tpu.modules.blocks as jax_blocks
import nanovs_slam_torch.modules.blocks as port_blocks
from _torch_port_util import nhwc
from nanovs_slam_tpu.configs import get_config as jax_get_config
from nanovs_slam_tpu.data.homography import sample_homography
from nanovs_slam_tpu.data.pipeline import build_pair_batch as jax_pair_batch
from nanovs_slam_tpu.models.inlier_net import InlierNet as JaxInlierNet
from nanovs_slam_tpu.models.kp2dtiny import build_model as jax_build_model
from nanovs_slam_tpu.train.schedules import \
    DEFAULT_LOSS_WEIGHTS as JAX_WEIGHTS
from nanovs_slam_tpu.train.train_step import TrainState as JaxTrainState
from nanovs_slam_tpu.train.train_step import \
    make_optimizer as jax_make_optimizer
from nanovs_slam_tpu.train.train_step import \
    make_train_step as jax_make_train_step
from nanovs_slam_tpu.utils.checkpoint import \
    filter_params as jax_filter_params
from nanovs_slam_tpu.utils.checkpoint import \
    load_checkpoint as jax_load_checkpoint
from nanovs_slam_tpu.utils.checkpoint import merge_params as jax_merge_params
from nanovs_slam_torch.configs import get_config
from nanovs_slam_torch.data.datasets import SyntheticShapesDataset
from nanovs_slam_torch.models.inlier_net import InlierNet, init_inlier_net
from nanovs_slam_torch.models.kp2dtiny import build_model, init_model
from nanovs_slam_torch.train.schedules import DEFAULT_LOSS_WEIGHTS
from nanovs_slam_torch.train.train_step import (create_train_state,
                                                make_optimizer,
                                                make_train_step)
from nanovs_slam_torch.utils.checkpoint import (filter_params,
                                                load_npz_checkpoint,
                                                restore_train_state,
                                                save_checkpoint)
from nanovs_slam_torch.utils.convert import (_flatten, convert_variables,
                                             load_jax_inlier_net,
                                             load_jax_variables,
                                             merge_jax_variables,
                                             to_jax_variables)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PINNED = os.path.join(REPO, "pinned", "extractor_S8.npz")
H, W, B, LR = 48, 64, 2, 5e-4


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads for this file's torch work: the suite runs
    files in parallel workers, and each worker's torch taking every core
    oversubscribes the machine many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batch():
    """Synthetic-shapes images (seeded numpy), homographies from
    RandomState(i), the pair built by the JAX package's build_pair_batch."""
    ds = SyntheticShapesDataset((H, W), B, 8, seed=3)
    imgs = np.stack([ds[i]["image"] for i in range(B)])
    segs = np.stack([ds[i]["seg"] for i in range(B)]).astype(np.int32)
    homos = np.stack([sample_homography((H, W), np.random.RandomState(i))
                      for i in range(B)]).astype(np.float32)
    batch = jax_pair_batch(jnp.asarray(imgs), jnp.asarray(segs),
                           jnp.asarray(homos), d_f=2)
    return {k: np.asarray(v) for k, v in batch.items()}


def _max_diff(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b), (sorted(a), sorted(b))
        return max(_max_diff(a[k], b[k]) for k in a)
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


@pytest.fixture
def no_dropout():
    """Channel dropout as the identity on both sides: their random streams
    differ."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_blocks.Dropout2d, "__call__",
               lambda self, x, train=False: x)
    mp.setattr(port_blocks.Dropout2d, "forward", lambda self, x: x)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def jax_step():
    """The JAX ``make_train_step`` of config S at 48x64 (one jit for the
    file's steps) and its Adam."""
    jcfg = jax_get_config("S", n_classes=8)
    step = jax_make_train_step(jax_build_model(jcfg), jcfg, H, W,
                               io_net=JaxInlierNet(blocks=4), donate=False)
    return step, jax_make_optimizer("adam", LR)


def _jax_step(jax_step, params, batch_stats, io_params, io_batch_stats,
              batch):
    """One JAX step from step 0 and a fresh Adam over the given variables
    -> (metrics, the updated variables as numpy trees)."""
    step, tx = jax_step
    state = JaxTrainState(
        step=jnp.int32(0), params=params, batch_stats=batch_stats,
        io_params=io_params, io_batch_stats=io_batch_stats,
        opt_state=tx.init({"model": params, "io": io_params}), tx=tx)
    jstate, jmet = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                        JAX_WEIGHTS, jax.random.PRNGKey(0))
    return ({k: float(v) for k, v in jmet.items()},
            {k: jax.tree_util.tree_map(np.asarray, getattr(jstate, k))
             for k in ("params", "batch_stats", "io_params",
                       "io_batch_stats")})


def _port_step(pstate, batch):
    tbatch = {k: torch.tensor(v) for k, v in batch.items()}
    for k in ("seg", "seg_aug"):
        tbatch[k] = tbatch[k].long()
    return make_train_step(get_config("S", n_classes=8), H, W)(
        pstate, tbatch, DEFAULT_LOSS_WEIGHTS)


def _assert_params_match(pstate, want):
    """The model's and the inlier net's parameters after the Adam step
    against the JAX step's: 1e-5 where the raw gradient is at least 1e-6,
    2 lr everywhere (see test_train_step_updated_params_match_jax)."""
    for net, tree, dense in ((pstate.model, want["params"], False),
                             (pstate.io_net, want["io_params"], True)):
        ref = convert_variables(tree, {}, dense)
        for k, p in net.named_parameters():
            d = (p.detach() - ref[k]).abs()
            live = p.grad.abs() >= 1e-6
            if live.any():
                assert d[live].max().item() <= 1e-5, k
            assert d.max().item() <= 2 * LR, k


@pytest.fixture(scope="module")
def one_step(jax_step):
    tree, _ = load_npz_checkpoint(PINNED)
    # the pinned centroids separate two images by far more than the VPR
    # loss's 0.1 margin (a zero loss, no gradient); seeded uniform [0, 1)
    # centroids (the initialiser's) put the NetVLAD backward on the step
    nv = tree["params"]["vlad_head"]["netvlad"]
    nv["centroids"] = np.random.RandomState(7).rand(
        *nv["centroids"].shape).astype(np.float32)
    batch = _batch()
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_blocks.Dropout2d, "__call__",
               lambda self, x, train=False: x)
    mp.setattr(port_blocks.Dropout2d, "forward", lambda self, x: x)
    try:
        jmet, want = _jax_step(jax_step, tree["params"], tree["batch_stats"],
                               tree["io_params"], tree["io_batch_stats"],
                               batch)
        want["metrics"] = jmet
        cfg = get_config("S", n_classes=8)
        model = load_jax_variables(build_model(cfg), tree["params"],
                                   tree["batch_stats"])
        io = load_jax_inlier_net(InlierNet(), tree["io_params"],
                                 tree["io_batch_stats"])
        pstate = create_train_state(model, make_optimizer("adam", LR),
                                    io_net=io)
        pstate, pmet = _port_step(pstate, batch)
    finally:
        mp.undo()
    got = {"metrics": {k: float(v) for k, v in pmet.items()}}
    got["params"], got["batch_stats"] = to_jax_variables(pstate.model)
    got["io_params"], got["io_batch_stats"] = to_jax_variables(pstate.io_net)
    return want, got, pstate


def test_train_step_loss_terms_match_jax(one_step):
    """Every loss term within 1e-5 (relative to max(1, |term|)); the IO
    term is live (its gate open) on this batch."""
    want, got, _ = one_step
    wm, gm = want["metrics"], got["metrics"]
    assert set(wm) == set(gm)
    assert wm["io_loss"] > 0.0 and wm["vlad_loss"] > 0.0
    for k in wm:
        if k != "grad_norm":
            assert abs(gm[k] - wm[k]) <= 1e-5 * max(1.0, abs(wm[k])), \
                (k, gm[k], wm[k])


def test_train_step_grad_norm_matches_jax(one_step):
    """The global norm of the raw gradients within 1e-5 relative (measured
    1e-6)."""
    want, got, _ = one_step
    g, w = got["metrics"]["grad_norm"], want["metrics"]["grad_norm"]
    assert abs(g - w) <= 1e-5 * w, (g, w)


def test_train_step_updated_params_match_jax(one_step):
    """The model's and the inlier net's parameters after the Adam step
    within 1e-5 wherever the raw gradient is at least 1e-6 (measured
    5.3e-7 at most). The first Adam step moves a weight by
    lr g / (|g| + 1e-8): where |g| is near 1e-8 or below, the float32
    sum-order noise of g (which may flip its sign) moves it by up to lr
    either way, so 2 lr bounds it there. Measured: 751 of 1.05e6 weights
    more than 1e-5 apart, 41 kernel taps with |g| below 2.1e-7 (up to
    6.2e-4) and 710 of the inlier net's block biases, whose true gradient
    is 0 (an instance norm follows them) and whose computed one is ~1e-9
    noise."""
    _, _, pstate = one_step
    _assert_params_match(pstate, one_step[0])


def test_train_step_bn_statistics_match_jax(one_step):
    """The running statistics after the two forwards (augmented view,
    then clean) and the IO net's: flax's biased-variance averages, 1e-5."""
    want, got, _ = one_step
    assert _max_diff(got["batch_stats"], want["batch_stats"]) <= 1e-5
    assert _max_diff(got["io_batch_stats"], want["io_batch_stats"]) <= 1e-5


def test_resume_takes_the_jax_trainers_first_step(jax_step, no_dropout):
    """``--model_path pinned/extractor_S8.npz``: the port's fresh train
    state (weights from seed 0, the inlier net from seed + 2) restored by
    ``restore_train_state`` against the JAX trainer's restore of the same
    file (``filter_params`` + ``merge_params`` into the same fresh
    variables). The restore leaves the step at 0, Adam empty and the
    inlier net as seeded, although the file holds ``io_params``; one step
    on both then gives the same parameters (as
    test_train_step_updated_params_match_jax)."""
    seed = 0
    cfg = get_config("S", n_classes=8)
    model = init_model(cfg, torch.Generator().manual_seed(seed), "cpu")
    io = init_inlier_net(torch.Generator().manual_seed(seed + 2),
                         device="cpu")
    init_params, init_stats = to_jax_variables(model)
    io_params, io_stats = to_jax_variables(io)
    pstate = create_train_state(model, make_optimizer("adam", LR),
                                io_net=io)
    tree, _ = load_npz_checkpoint(PINNED)
    assert "io_params" in tree
    restore_train_state(PINNED, pstate)
    assert pstate.step == 0 and not pstate.optimizer.state_dict()["state"]
    for k, v in convert_variables(io_params, io_stats, True).items():
        assert torch.equal(pstate.io_net.state_dict()[k], v), k

    params = jax_merge_params(init_params, jax_filter_params(tree["params"]))
    stats = jax_merge_params(init_stats, tree["batch_stats"])
    batch = _batch()
    _, want = _jax_step(jax_step, params, stats, io_params, io_stats, batch)
    pstate, _ = _port_step(pstate, batch)
    assert pstate.step == 1
    _assert_params_match(pstate, want)


@pytest.mark.parametrize("mode", ["seg_last", "seg", "vlad"])
def test_filter_params_is_the_jax_packages(mode):
    """Each partial-restore mode drops what the JAX ``filter_params``
    drops from the pinned S8 params, and a restore of the filtered file
    keeps the fresh init of what was dropped (``merge_params``'s
    strict=False)."""
    tree, _ = load_npz_checkpoint(PINNED)
    got = _flatten(filter_params(tree["params"], mode))
    want = _flatten(jax_filter_params(tree["params"], mode))
    assert sorted(got) == sorted(want)
    cfg = get_config("S", n_classes=8)
    model = init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    fresh = {k: v.clone() for k, v in model.state_dict().items()}
    merge_jax_variables(model, filter_params(tree["params"], mode),
                        tree["batch_stats"])
    head = {"seg_last": "seg_head.convs_8.", "seg": "seg_head.",
            "vlad": "vlad_head."}[mode]
    kept = [k for k in fresh if k.startswith(head)
            and not k.endswith(("running_mean", "running_var",
                                "num_batches_tracked"))]
    assert kept
    for k in kept:
        assert torch.equal(model.state_dict()[k], fresh[k]), k
    assert not torch.equal(model.state_dict()["backbone.conv1a.conv.weight"],
                           fresh["backbone.conv1a.conv.weight"])


def test_checkpoint_loads_in_jax_and_gives_the_same_forward(one_step,
                                                            tmp_path):
    """The port's save_checkpoint .npz -> the JAX load_checkpoint -> the
    JAX eval forward equals the port's (1e-5); its optimizer state rides
    under keys of its own."""
    from _torch_port_util import apply_jit

    _, _, pstate = one_step
    path = save_checkpoint(str(tmp_path / "ck"), pstate, epoch=1)
    tree, meta = jax_load_checkpoint(path)
    assert meta["epoch"] == 1 and meta["step"] == 1
    assert "torch_optimizer" in tree and "io_params" in tree
    x = np.random.RandomState(5).uniform(-1, 1, (1, H, W, 3)).astype(
        np.float32)
    jcfg = jax_get_config("S", n_classes=8)
    want = apply_jit(jax_build_model(jcfg), tree["params"],
                     tree["batch_stats"], x, train=False)
    model = pstate.model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    for k in want:
        np.testing.assert_allclose(nhwc(got[k]), want[k], atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("flags,item", [
    (["--bf16"], "item 4"), (["--qat"], "item 6"), (["--to_mcu"], "item 6"),
    (["--device_cache"], "item 4"), (["--scan_epoch"], "item 4"),
    (["--num_devices", "2"], "item 7"), (["--num_processes", "2"], "item 7"),
    (["--coordinator_address", "localhost:1"], "item 7"),
    (["--process_id", "1"], "item 7"), (["--wandb"], "item 7"),
    (["--model_type", "KeypointFormer"], "item 7")])
def test_cli_rejects_deferred_flags(flags, item):
    """Each flag whose module the port lacks raises, naming its ROADMAP
    item."""
    from nanovs_slam_torch.train_multitask import check_supported, parse_args

    with pytest.raises(SystemExit, match=item):
        check_supported(parse_args(flags + ["--device", "cpu"]))


@pytest.mark.parametrize("flags", [[], ["--debug"], ["--no_eval"]])
def test_cli_accepts_its_evaluation_flags(flags):
    """The trainer's evaluation is ported: it runs without --no_eval, and
    --debug is accepted."""
    from nanovs_slam_torch.train_multitask import check_supported, parse_args

    check_supported(parse_args(flags + ["--device", "cpu"]))


def test_freeze_backbone_keeps_the_backbone_out_of_adamw(one_step):
    """freeze_backbone with adamw: the backbone's weights do not move (not
    even by the weight decay), every other trainable weight does, and the
    backbone's gradient still counts in grad_norm."""
    cfg = get_config("S", n_classes=8)
    model = build_model(cfg)
    _, _, pstate = one_step
    model.load_state_dict(pstate.model.state_dict())
    state = create_train_state(model, make_optimizer("adamw", LR,
                                                     freeze_backbone=True),
                               with_io=False)
    assert not any(n.startswith("model.backbone.")
                   for n in state.param_names)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    batch = {k: torch.tensor(v) for k, v in _batch().items()}
    for k in ("seg", "seg_aug"):
        batch[k] = batch[k].long()
    state, met = make_train_step(cfg, H, W)(state, batch,
                                            DEFAULT_LOSS_WEIGHTS)
    for k, p in model.named_parameters():
        moved = not torch.equal(p.detach(), before[k])
        assert moved != k.startswith("backbone."), k
    bb = sum(float((p.grad ** 2).sum()) for k, p in model.named_parameters()
             if k.startswith("backbone."))
    assert bb > 0 and float(met["grad_norm"]) ** 2 > bb
