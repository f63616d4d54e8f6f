"""LightGlue training in the port against the JAX package on the CPU: the
loss functions (``matching/loss.py``), ``forward(train=True)`` with padding
masks, the deep-supervision ``lightglue_loss``, one step of
``python -m nanovs_slam_torch.train_lightglue`` against the root CLI's
jitted step on the same data, and the CLI's checkpoint read by the JAX
``load_checkpoint``. Weights are carried across by ``utils/convert``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import random_variables
from nanovs_slam_tpu.matching import loss as jloss
from nanovs_slam_tpu.matching.configs import LIGHTGLUE_CONFIGS as JAX_CONFIGS
from nanovs_slam_tpu.matching.lightglue import LightGlue as JaxLightGlue
from nanovs_slam_torch.matching import loss as ploss
from nanovs_slam_torch.matching.configs import LIGHTGLUE_CONFIGS
from nanovs_slam_torch.matching.lightglue import LightGlue
from nanovs_slam_torch.utils.convert import load_jax_lightglue

NAME = "kp2dtiny_S"  # D = 32, 4 layers, 4 heads


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads for this file's torch work (the suite runs
    files in parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _data(B, M, N, D, seed, pad=(3, 5)):
    """Normalised keypoints, descriptors and padding masks (the last
    pad[0] / pad[1] keypoints of image b + 1 invalid) as numpy."""
    rs = np.random.RandomState(seed)
    mask0, mask1 = np.ones((B, M), bool), np.ones((B, N), bool)
    mask0[1:, M - pad[0]:] = False
    mask1[1:, N - pad[1]:] = False
    return {"keypoints0": rs.uniform(-1, 1, (B, M, 2)).astype(np.float32),
            "keypoints1": rs.uniform(-1, 1, (B, N, 2)).astype(np.float32),
            "descriptors0": rs.randn(B, M, D).astype(np.float32),
            "descriptors1": rs.randn(B, N, D).astype(np.float32),
            "mask0": mask0, "mask1": mask1}


def _gt(data, seed):
    """A ground truth as gt_matches_from_homography gives it: a random
    half of the valid keypoints of image 0 matched one to one into image
    1, the rest -1, padded keypoints -2."""
    rs = np.random.RandomState(seed)
    B, M = data["mask0"].shape
    N = data["mask1"].shape[1]
    a = np.zeros((B, M, N), np.float32)
    g0, g1 = np.full((B, M), -1), np.full((B, N), -1)
    for b in range(B):
        v0 = np.flatnonzero(data["mask0"][b])
        v1 = np.flatnonzero(data["mask1"][b])
        n = min(len(v0), len(v1)) // 2
        i, j = rs.permutation(v0)[:n], rs.permutation(v1)[:n]
        a[b, i, j] = 1.0
        g0[b, i], g1[b, j] = j, i
    g0 = np.where(data["mask0"], g0, -2)
    g1 = np.where(data["mask1"], g1, -2)
    return {"gt_assignment": a, "gt_matches0": g0, "gt_matches1": g1}


def _t(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


_MODELS = {}


def _models(seed=0, M=16, N=16):
    """(flax LightGlue, its seeded params, the port's matcher with them)."""
    if seed not in _MODELS:
        model = JaxLightGlue(JAX_CONFIGS[NAME])
        params, _ = random_variables(model, _j(_data(1, M, N, 32, 0)),
                                     True, seed=seed)
        port = load_jax_lightglue(LightGlue(LIGHTGLUE_CONFIGS[NAME]), params)
        _MODELS[seed] = (model, params, port)
    return _MODELS[seed]


def test_loss_functions_match_jax():
    """gt_weights_from_matches, weight_loss, nll_loss (balancing 0.3),
    confidence_loss and matcher_metrics on the same inputs, each output
    within 1e-6."""
    B, M, N = 2, 12, 10
    data = _data(B, M, N, 4, 1)
    gt = _gt(data, 2)
    rs = np.random.RandomState(3)
    la = np.log(rs.dirichlet(np.ones(N + 1), (B, M + 1))).astype(np.float32)
    la2 = np.log(rs.dirichlet(np.ones(N + 1), (B, M + 1))).astype(np.float32)
    t0, t1 = (rs.randn(B, n).astype(np.float32) * 3 for n in (M, N))
    m0 = np.where(rs.rand(B, M) < 0.5, gt["gt_matches0"], -1)
    sc = rs.rand(B, M).astype(np.float32)

    def close(got, want):
        if isinstance(want, dict):
            assert set(got) == set(want)
            for k in want:
                close(got[k], want[k])
        elif isinstance(want, tuple):
            for g, w in zip(got, want):
                close(g, w)
        else:
            np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                       atol=1e-6, rtol=1e-6)

    wj = jloss.gt_weights_from_matches(la.shape, *_j(gt).values())
    wp = ploss.gt_weights_from_matches(la.shape, *_t(gt).values())
    close(wp, wj)
    close(ploss.weight_loss(torch.from_numpy(la), wp),
          jloss.weight_loss(jnp.asarray(la), wj))
    close(ploss.nll_loss(torch.from_numpy(la), wp, 0.3),
          jloss.nll_loss(jnp.asarray(la), wj, 0.3))
    close(ploss.confidence_loss(*map(torch.from_numpy, (t0, t1, la, la2))),
          jloss.confidence_loss(*map(jnp.asarray, (t0, t1, la, la2))))
    close(ploss.matcher_metrics(*map(torch.from_numpy, (
        m0, gt["gt_matches0"], sc))),
        jloss.matcher_metrics(*map(jnp.asarray,
                                   (m0, gt["gt_matches0"], sc))))


@pytest.fixture(scope="module")
def train_preds():
    """JAX ``apply(..., True)`` (jitted) and the port's
    ``forward(train=True)`` on the same padded pair, B = 2, M = N = 16."""
    model, params, port = _models()
    data = _data(2, 16, 16, 32, 4)
    want = jax.jit(lambda p, d: model.apply({"params": p}, d, True))(
        params, _j(data))
    want = jax.tree_util.tree_map(np.asarray, want)
    got = port(_t(data), train=True)
    return data, want, got


def test_train_forward_matches_jax(train_preds):
    """Every output of the train forward: every layer's log assignment
    (B, L, M+1, N+1), the layers' descriptors and the matches, with
    padding masks; floats within 1e-5 (atol and rtol: a masked entry's
    log assignment is near -1e9)."""
    _, want, got = train_preds
    assert set(got) == set(want)
    assert got["all_log_assignments"].shape == (2, 4, 17, 17)
    assert got["ref_descriptors0"].shape == (2, 4, 16, 32)
    for k, v in want.items():
        g = got[k].detach().numpy()
        if v.dtype.kind in "iub":
            np.testing.assert_array_equal(g, v, err_msg=k)
        else:
            np.testing.assert_allclose(g, v, atol=1e-5, rtol=1e-5,
                                       err_msg=k)


def test_deep_supervision_loss_matches_jax(train_preds):
    """``lightglue_loss`` (every layer's NLL at gamma 1 and the confidence
    heads' BCE on detached descriptors) of each side's own train forward:
    every term within 1e-5; the confidence term's gradient reaches only
    the token-confidence heads."""
    data, want, got = train_preds
    model, params, port = _models()
    gt = _gt(data, 5)
    jd = {**_j(data), **_j(gt)}
    wl = jloss.lightglue_loss(model, params, _j(want), jd, 4)
    pl = ploss.lightglue_loss(port, got, {**_t(data), **_t(gt)})
    for k, v in wl.items():
        np.testing.assert_allclose(pl[k].detach().numpy(), np.asarray(v),
                                   atol=1e-5, rtol=1e-5, err_msg=k)
    port.zero_grad()
    pl["confidence"].sum().backward()
    for n, p in port.named_parameters():
        assert (p.grad is not None) == n.startswith("token_confidence_"), n


LR = 1e-4


def _root_cli_step(model, params, data, gt):
    """The root CLI's jitted ``train_step`` (train_lightglue.py:173-192),
    as it is written there: the mean over layers of nll_loss(...).mean(),
    optax.adam(lr) from a fresh state."""
    import optax

    tx = optax.adam(LR)

    @jax.jit
    def train_step(lg_params, opt_state, data, gt):
        def loss_fn(p):
            pred = model.apply({"params": p}, data, True)
            weights = jloss.gt_weights_from_matches(
                pred["log_assignment"].shape, gt["gt_assignment"],
                gt["gt_matches0"], gt["gt_matches1"])
            total = jnp.zeros(())
            n_layers = pred["all_log_assignments"].shape[1]
            for i in range(n_layers):
                nll, _ = jloss.nll_loss(pred["all_log_assignments"][:, i],
                                        weights)
                total = total + nll.mean()
            return total / n_layers, pred

        (loss, pred), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            lg_params)
        updates, opt_state = tx.update(grads, opt_state, lg_params)
        return optax.apply_updates(lg_params, updates), opt_state, loss

    new, _, loss = train_step(params, tx.init(params), _j(data), _j(gt))
    return jax.tree_util.tree_map(np.asarray, new), float(loss)


def test_cli_step_matches_the_root_cli_step():
    """One step of the port's CLI (``train_lightglue.train_step``: the
    stack under autograd, Adam) against the root CLI's at D = 32, M = N =
    64, B = 2, padded: the loss within 1e-5 relative and the parameters
    after Adam within 1e-5 where the gradient is at least 1e-6 (2 lr
    everywhere: Adam's first step moves a weight by lr sign(g), and
    float32 noise may flip the sign of a gradient near 0)."""
    from nanovs_slam_torch.train_lightglue import make_optimizer, train_step
    from nanovs_slam_torch.utils.convert import _flatten, _torch_entry

    model, params, _ = _models(seed=7, M=64, N=64)
    port = load_jax_lightglue(LightGlue(LIGHTGLUE_CONFIGS[NAME]), params)
    data = _data(2, 64, 64, 32, 8)
    gt = _gt(data, 9)
    want, want_loss = _root_cli_step(model, params, data, gt)
    loss, _ = train_step(port.train(), make_optimizer(port, LR), _t(data),
                         _t(gt))
    assert abs(float(loss) - want_loss) <= 1e-5 * abs(want_loss)
    ref = dict(_torch_entry(k, v, dense=True)
               for k, v in _flatten(want).items())
    named = dict(port.named_parameters())
    assert set(named) == set(ref)
    for k, p in named.items():
        d = (p.detach() - ref[k]).abs()
        if p.grad is None:  # the token-confidence heads: no NLL gradient
            assert k.startswith("token_confidence_") and d.max() == 0, k
            continue
        live = p.grad.abs() >= 1e-6
        if live.any():
            assert d[live].max().item() <= 1e-5, k
        assert d.max().item() <= 2 * LR, k


def test_cli_writes_a_checkpoint_the_jax_loader_reads(tmp_path, capsys):
    """Three CLI steps at 96x128, K = 64 on the CPU: finite NLLs, and the
    ``.npz`` it writes is read by the JAX ``load_checkpoint``: flax
    LightGlue params with the init's keys and shapes, the flags in the
    meta; the JAX forward with them and the port's with them loaded agree
    (1e-5). An extractor checkpoint directory raises (a reference torch
    ``.ckpt`` loads: tests/test_torch_port_torch_import.py)."""
    from nanovs_slam_tpu.utils.checkpoint import load_checkpoint

    from nanovs_slam_torch import train_lightglue
    from nanovs_slam_torch.utils.convert import _flatten

    out = str(tmp_path / "lg")
    assert train_lightglue.main([
        "--device", "cpu", "--n_steps", "3", "--im_h", "96", "--im_w",
        "128", "--max_keypoints", "64", "--log_every", "1",
        "--out_model_path", out]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("step ")]
    assert len(lines) == 3
    assert all(np.isfinite(float(ln.split()[3])) for ln in lines)
    tree, meta = load_checkpoint(out + ".npz")
    assert meta["config"]["lg_config"] == NAME
    _, params, _ = _models()
    flat, ref = _flatten(tree["params"]), _flatten(params)
    assert sorted(flat) == sorted(ref)
    assert all(flat[k].shape == ref[k].shape for k in ref)
    port = load_jax_lightglue(LightGlue(LIGHTGLUE_CONFIGS[NAME]),
                              tree["params"]).eval()
    data = _data(1, 16, 16, 32, 10)
    want = jax.jit(lambda p, d: JaxLightGlue(JAX_CONFIGS[NAME]).apply(
        {"params": p}, d))(tree["params"], _j(data))
    with torch.no_grad():
        got = port(_t(data))
    np.testing.assert_allclose(got["log_assignment"].numpy(),
                               np.asarray(want["log_assignment"]),
                               atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="directories"):
        train_lightglue.main(["--device", "cpu", "--extractor_path",
                              str(tmp_path)])


def test_cli_matcher_initialises_from_torch_generators():
    """The CLI's matcher is PyTorch's initialisation drawn from ``--seed``
    (the same weights for the same seed, the global generator left as it
    was), not the JAX CLI's ``jax.random`` draw of the same seed: the
    flax tree has the same keys and shapes and other values, so a run
    differs from the JAX CLI's unless the weights are carried across
    (ROADMAP Queue 3)."""
    from nanovs_slam_torch.train_lightglue import build_matcher
    from nanovs_slam_torch.utils.convert import _flatten, to_jax_lightglue

    state = torch.random.get_rng_state()
    a = to_jax_lightglue(build_matcher(NAME, 32, 0, "cpu"))
    b = to_jax_lightglue(build_matcher(NAME, 32, 0, "cpu"))
    assert torch.equal(state, torch.random.get_rng_state())
    model = JaxLightGlue(JAX_CONFIGS[NAME])
    ref = jax.jit(lambda k, d: model.init(k, d, True))(
        jax.random.PRNGKey(0), _j(_data(1, 8, 8, 32, 0)))["params"]
    fa, fb, fr = _flatten(a), _flatten(b), _flatten(ref)
    assert sorted(fa) == sorted(fr)
    assert all(np.array_equal(fa[k], fb[k]) for k in fa)
    assert all(fa[k].shape == fr[k].shape for k in fa)
    kernels = [k for k in fa if k.endswith("kernel")]
    assert not any(np.allclose(fa[k], np.asarray(fr[k])) for k in kernels)
