"""bf16 training of the port against the JAX package's on the CPU.

The JAX trainer's ``--bf16`` builds the model at ``dtype="bfloat16"``:
float32 parameters, BN statistics and optimizer state, bf16 compute, the
losses casting to float32 where they cast, no loss scaling
(``nanovs_slam_tpu/train/train_step.py:9-10``). XLA keeps excess
precision inside its fusions and PyTorch rounds at its own places, so the
two bf16 answers are not bit-equal; as ``test_torch_port_bf16.py`` does,
each test holds the port's bf16 answer against the JAX float32 one, at
most twice as far from it as the JAX bf16 answer plus a small slack (the
update leaf by leaf, and no nearer than a quarter of it). Here:
NetVLAD's gradient (the plain twin of the bf16 backward kernel) against
``jax.grad`` of the flax module at bf16, and one whole train step (config
S, pinned S8 weights with seeded centroids, 48x64, batch 2, dropout off on
both sides, SGD so that the update is the clipped gradient) against the
JAX bf16 step."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nanovs_slam_tpu.modules.blocks as jax_blocks
import nanovs_slam_torch.modules.blocks as port_blocks
from nanovs_slam_tpu.configs import get_config as jax_get_config
from nanovs_slam_tpu.data.homography import sample_homography
from nanovs_slam_tpu.data.pipeline import build_pair_batch as jax_pair_batch
from nanovs_slam_tpu.models.inlier_net import InlierNet as JaxInlierNet
from nanovs_slam_tpu.models.kp2dtiny import build_model as jax_build_model
from nanovs_slam_tpu.modules.aggregators import NetVLAD as JaxNetVLAD
from nanovs_slam_tpu.train.schedules import \
    DEFAULT_LOSS_WEIGHTS as JAX_WEIGHTS
from nanovs_slam_tpu.train.train_step import TrainState as JaxTrainState
from nanovs_slam_tpu.train.train_step import \
    make_optimizer as jax_make_optimizer
from nanovs_slam_tpu.train.train_step import \
    make_train_step as jax_make_train_step
from nanovs_slam_torch.configs import get_config
from nanovs_slam_torch.data.datasets import SyntheticShapesDataset
from nanovs_slam_torch.kernels import netvlad_backward_plain
from nanovs_slam_torch.models.inlier_net import InlierNet
from nanovs_slam_torch.models.kp2dtiny import build_model
from nanovs_slam_torch.train.schedules import DEFAULT_LOSS_WEIGHTS
from nanovs_slam_torch.train.train_step import (create_train_state,
                                                make_optimizer,
                                                make_train_step)
from nanovs_slam_torch.utils.checkpoint import load_npz_checkpoint
from nanovs_slam_torch.utils.convert import (_flatten, load_jax_inlier_net,
                                             load_jax_variables,
                                             to_jax_variables)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PINNED = os.path.join(REPO, "pinned", "extractor_S8.npz")
H, W, B, LR = 48, 64, 2, 1e-3
BF16 = torch.bfloat16


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads for this file's torch work: the suite runs
    files in parallel workers, and each worker's torch taking every core
    oversubscribes the machine many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    """||a - b|| / ||b|| over float32 copies."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("C,K", [(48, 32), (64, 64)])
def test_netvlad_bf16_gradient_twin_matches_jax(C, K):
    """(dx, dW, dcen) of NetVLAD at a bf16 x: autograd through
    ``netvlad_plain`` (the bf16 backward kernel's twin) against
    ``jax.grad`` of the flax module at bf16, each relative to the float32
    ``jax.grad``: its relative L2 error at most twice the JAX bf16 one's
    plus 1e-3; dx comes back bf16 on both sides."""
    rs = np.random.RandomState(C + K)
    x32 = rs.randn(2, 12, 16, C).astype(np.float32)
    xb = torch.from_numpy(x32).to(BF16)
    x16 = xb.float().numpy()  # the bf16 values, as float32
    aw = (rs.randn(C, K) / np.sqrt(C)).astype(np.float32)
    cen = rs.rand(K, C).astype(np.float32)
    gy = rs.randn(2, K * C).astype(np.float32)

    def grads(dtype, x):
        mod = JaxNetVLAD(num_clusters=K, dim=C, dtype=dtype)

        def f(x, aw, cen):
            y = mod.apply({"params": {"assign_w": aw, "centroids": cen}}, x)
            return jnp.sum(y * gy)

        return jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(x, dtype), aw, cen)

    ref = grads(jnp.float32, x16)
    want = grads(jnp.bfloat16, x16)
    got = netvlad_backward_plain(torch.from_numpy(gy), xb,
                                 torch.from_numpy(aw), torch.from_numpy(cen))
    assert got[0].dtype == BF16 and want[0].dtype == jnp.bfloat16
    for name, g, w, r in zip(("dx", "dW", "dcen"), got, want, ref):
        g = g.float().numpy()
        assert _rel(g, r) <= 2 * _rel(w, r) + 1e-3, \
            (name, _rel(g, r), _rel(w, r))


def _batch():
    ds = SyntheticShapesDataset((H, W), B, 8, seed=3)
    imgs = np.stack([ds[i]["image"] for i in range(B)])
    segs = np.stack([ds[i]["seg"] for i in range(B)]).astype(np.int32)
    homos = np.stack([sample_homography((H, W), np.random.RandomState(i))
                      for i in range(B)]).astype(np.float32)
    batch = jax_pair_batch(jnp.asarray(imgs), jnp.asarray(segs),
                           jnp.asarray(homos), d_f=2)
    return {k: np.asarray(v) for k, v in batch.items()}


def _leaf_update(before, after):
    """{leaf: -(after - before) / lr} over every parameter: the clipped
    gradient, for SGD's first step."""
    fa, fb = _flatten(after), _flatten(before)
    return {k: (fb[k] - fa[k]).ravel() / LR for k in sorted(fb)}


def _leaf_distances(upd, ref, head):
    """(median, worst) over the leaves under ``head`` of each leaf's
    relative L2 distance to ``ref``'s."""
    d = [_rel(upd[k], ref[k]) for k in ref if k.startswith(head + "/")]
    return float(np.median(d)), max(d)


@pytest.fixture(scope="module")
def bf16_steps():
    """One SGD step of config S from pinned S8 (seeded centroids, as
    ``test_torch_port_train_step.py``), float32 and bf16 on the JAX side,
    bf16 and float32 on the port's; dropout off on both sides. Returns
    (ref, want, got, got_f32), each (metrics, {leaf: update},
    batch_stats)."""
    tree, _ = load_npz_checkpoint(PINNED)
    nv = tree["params"]["vlad_head"]["netvlad"]
    nv["centroids"] = np.random.RandomState(7).rand(
        *nv["centroids"].shape).astype(np.float32)
    batch = _batch()
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_blocks.Dropout2d, "__call__",
               lambda self, x, train=False: x)
    mp.setattr(port_blocks.Dropout2d, "forward", lambda self, x: x)
    tx = jax_make_optimizer("sgd", LR)
    out = []
    try:
        for dtype in ("float32", "bfloat16"):
            jcfg = jax_get_config("S", n_classes=8, dtype=dtype)
            step = jax_make_train_step(jax_build_model(jcfg), jcfg, H, W,
                                       io_net=JaxInlierNet(blocks=4),
                                       donate=False)
            params = {"model": tree["params"], "io": tree["io_params"]}
            state = JaxTrainState(
                step=jnp.int32(0), params=tree["params"],
                batch_stats=tree["batch_stats"],
                io_params=tree["io_params"],
                io_batch_stats=tree["io_batch_stats"],
                opt_state=tx.init(params), tx=tx)
            js, jm = step(state, {k: jnp.asarray(v) for k, v in
                                  batch.items()}, JAX_WEIGHTS,
                          jax.random.PRNGKey(0))
            after = {"model": jax.tree_util.tree_map(np.asarray, js.params),
                     "io": jax.tree_util.tree_map(np.asarray, js.io_params)}
            out.append(({k: float(v) for k, v in jm.items()},
                        _leaf_update(params, after),
                        jax.tree_util.tree_map(np.asarray, js.batch_stats)))
        tb = {k: torch.tensor(v) for k, v in batch.items()}
        for k in ("seg", "seg_aug"):
            tb[k] = tb[k].long()
        for dtype in ("bfloat16", "float32"):
            cfg = get_config("S", n_classes=8, dtype=dtype)
            model = load_jax_variables(build_model(cfg), tree["params"],
                                       tree["batch_stats"])
            io = load_jax_inlier_net(InlierNet(), tree["io_params"],
                                     tree["io_batch_stats"])
            pstate = create_train_state(model, make_optimizer("sgd", LR),
                                        io_net=io)
            pstate, pm = make_train_step(cfg, H, W)(pstate, tb,
                                                    DEFAULT_LOSS_WEIGHTS)
            p_after, p_stats = to_jax_variables(pstate.model)
            io_after, _ = to_jax_variables(pstate.io_net)
            out.append(({k: float(v) for k, v in pm.items()},
                        _leaf_update(params, {"model": p_after,
                                              "io": io_after}),
                        p_stats))
    finally:
        mp.undo()
    return out


def test_bf16_step_keeps_float32_state(bf16_steps):
    """Parameters, BN statistics and the optimizer state stay float32 at
    bf16, as flax keeps them; every loss term is finite."""
    cfg = get_config("S", n_classes=8, dtype="bfloat16")
    model = build_model(cfg)
    assert all(v.dtype in (torch.float32, torch.int64)
               for v in model.state_dict().values())
    metrics = bf16_steps[2][0]
    assert all(np.isfinite(v) for v in metrics.values())


def test_bf16_step_loss_terms_within_the_jax_bf16_error(bf16_steps):
    """Every loss term and the gradient norm: the port's bf16 value's
    distance to the JAX float32 one at most twice the larger of the JAX
    bf16 value's and one bf16 rounding of the term (2^-8 |term|: a single
    scalar's JAX error can be near 0 by chance, measured 2.4e-4 of the
    total's 6.37) plus 1e-3 relative. ``recall`` counts exact matches of
    the 280 interior cells, so it may move by two of them more (an argmin
    flipped by bf16 noise; measured one)."""
    (ref, _, _), (want, _, _), (got, _, _) = bf16_steps[:3]
    assert set(got) == set(want) == set(ref)
    assert ref["io_loss"] > 0 and ref["vlad_loss"] > 0
    for k in ref:
        tol = 2 * max(abs(want[k] - ref[k]), 2 ** -8 * abs(ref[k])) \
            + 1e-3 * max(1.0, abs(ref[k])) + (2 / 280 if k == "recall"
                                             else 0.0)
        assert abs(got[k] - ref[k]) <= tol, (k, got[k], want[k], ref[k])


def test_bf16_step_update_within_the_jax_bf16_error(bf16_steps):
    """The SGD update (the clipped gradient), leaf by leaf over the
    backbone (24 leaves) and the VPR head (11 leaves, whose gradient is
    the VPR loss's alone, through NetVLAD's bf16 backward): each leaf's
    relative L2 distance to the JAX float32 step's. Per set, the port's
    median leaf at most twice the JAX bf16 step's and at least a quarter
    of it (the bf16 roundings are there), its worst leaf at most three
    times JAX's. Measured (median, worst): backbone JAX 0.1233 / 0.2496,
    port 0.1489 / 0.3062; VPR head JAX 0.0295 / 0.0740, port 0.0284 /
    0.1135. The keypoint heads and the IO net, whose losses pick by
    argmin, are left out: their leaves reach 0.60 (loc_head) for both,
    and the IO net's conv biases (|g| near 1e-9) 0.2-2.5. Two controls must
    fail the same limits: a zeroed update (every leaf 1.0) and the port's
    float32 step (the roundings left out: medians 2.7e-5 and 7.4e-5).
    The BN running statistics: at most twice the JAX bf16 error plus
    1e-3, in max norm."""
    (_, r_upd, r_bs), (_, w_upd, w_bs), (_, g_upd, g_bs), (_, f_upd, _) = \
        bf16_steps
    zeroed = {k: np.zeros_like(v) for k, v in r_upd.items()}
    for head in ("model/backbone", "model/vlad_head"):
        want = _leaf_distances(w_upd, r_upd, head)

        def holds(med_worst):
            med, worst = med_worst
            return want[0] / 4 <= med <= 2 * want[0] and worst <= 3 * want[1]

        got = _leaf_distances(g_upd, r_upd, head)
        controls = [_leaf_distances(u, r_upd, head) for u in (zeroed, f_upd)]
        print(f"{head} (median, worst leaf) from the JAX float32 step: "
              f"JAX bf16 {want}, port bf16 {got}; controls (zeroed, port "
              f"float32) {controls}")
        assert holds(got), (head, got, want)
        assert not any(holds(c) for c in controls), (head, controls, want)
    fr, fw, fg = _flatten(r_bs), _flatten(w_bs), _flatten(g_bs)
    for k in fr:
        e_w = float(np.abs(fw[k] - fr[k]).max())
        e_g = float(np.abs(fg[k] - fr[k]).max())
        assert e_g <= 2 * e_w + 1e-3, (k, e_g, e_w)
