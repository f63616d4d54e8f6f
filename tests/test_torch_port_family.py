"""The rest of the KP2DTiny family in the port against the JAX package on
the CPU: attention (V2 and V3), decoder fusion (V3), depth, GeM, ConvAP and
config D's widths. Whole forwards at 48x64 within atol 1e-4 (seeded random
flax variables with random BN stats), ``make_infer_fn`` for V3 S_A and V2 D
against the JAX ``make_infer_fn``, and every registry config building and
loading its flax tree with no key left over."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import (apply_jit, assert_dense_outputs_match,
                              assert_top_k_match_as_sets, nchw, nhwc,
                              random_variables)
from nanovs_slam_tpu.configs import V2_CONFIGS, V3_CONFIGS
from nanovs_slam_tpu.configs import get_config as jax_get_config
from nanovs_slam_tpu.inference import make_infer_fn as jax_make_infer_fn
from nanovs_slam_tpu.models.kp2dtiny import build_model as jax_build_model
from nanovs_slam_tpu.ops.image import to_model_input as jax_to_model_input
from nanovs_slam_torch.configs import get_config
from nanovs_slam_torch.inference import make_infer_fn
from nanovs_slam_torch.models.kp2dtiny import build_model
from nanovs_slam_torch.utils.convert import load_jax_variables

ATOL = 1e-4


def _pair(name, v3, depth, H, W, seed):
    """(flax model, params, batch_stats, port model with them loaded)."""
    kw = dict(v3=v3, n_classes=5, depth=depth)
    model = jax_build_model(jax_get_config(name, **kw))
    params, bs = random_variables(model, np.zeros((1, H, W, 3), np.float32),
                                  True, seed=seed)
    port = load_jax_variables(build_model(get_config(name, **kw)), params,
                              bs).eval()
    return model, params, bs, port


@pytest.mark.parametrize("name,v3,depth", [
    ("N_A", False, False), ("GEM_N", False, False),
    ("CONVAP_S_A", False, False), ("D", False, False), ("N", False, True),
    ("S_A", True, False), ("N", True, True), ("D_A", True, True)])
def test_family_forward_matches_flax(name, v3, depth):
    H, W = 48, 64
    model, params, bs, port = _pair(name, v3, depth, H, W, seed=0)
    x = np.random.RandomState(1).uniform(-1, 1, (2, H, W, 3)).astype(
        np.float32)
    want = apply_jit(model, params, bs, x, train=False)
    with torch.no_grad():
        got = port(nchw(x))
    assert set(got) == set(want) == (
        {"score", "coord", "feat", "seg", "vlad"} | ({"depth"} if depth
                                                      else set()))
    for k, v in want.items():
        np.testing.assert_allclose(nhwc(got[k]), v, atol=ATOL, err_msg=k)


H, W, B, TOP_K = 64, 96, 2, 100


@pytest.fixture(scope="module", params=[("S_A", True), ("D", False)],
                ids=["V3-S_A", "V2-D"])
def infer_outputs(request):
    """(JAX answer, port answer, threshold). Random weights put every score
    within a few hundredths of one value, so the threshold is the 75th
    percentile of the port's scores inside the border: it selects."""
    name, v3 = request.param
    model, params, bs, port = _pair(name, v3, False, H, W, seed=11)
    cfg = get_config(name, v3=v3, n_classes=5)
    frames = np.random.RandomState(12).randint(0, 256, (B, H, W, 3)).astype(
        np.uint8)
    score = make_infer_fn(port, cfg, H, W, device="cpu")(frames)["score"]
    conf = float(np.percentile(score[score > 0].numpy(), 75))
    want = jax_make_infer_fn(model, jax_get_config(name, v3=v3, n_classes=5),
                             H, W, top_k=TOP_K, conf_threshold=conf,
                             use_pallas=False)(
        {"params": params, "batch_stats": bs},
        jax_to_model_input(jnp.asarray(frames)))
    want = {k: np.asarray(v) for k, v in want.items()}
    infer = make_infer_fn(port, cfg, H, W, top_k=TOP_K, conf_threshold=conf,
                          device="cpu")
    got = {k: v.numpy() for k, v in infer(frames).items()}
    return want, got, conf


def test_family_infer_dense_outputs_match(infer_outputs):
    assert_dense_outputs_match(*infer_outputs[:2])


def test_family_infer_top_k_matches_as_sets(infer_outputs):
    assert_top_k_match_as_sets(*infer_outputs)


@pytest.mark.parametrize("name,v3", [(n, False) for n in V2_CONFIGS]
                         + [(n, True) for n in V3_CONFIGS])
def test_every_config_loads_its_flax_tree(name, v3):
    """With and without depth; ``load_jax_variables`` raises on a key
    missing or left over on either side and on a shape that differs."""
    for depth in (False, True):
        cfg = jax_get_config(name, v3=v3, n_classes=7, depth=depth)
        model = jax_build_model(cfg)
        shapes = jax.eval_shape(lambda: model.init(
            {"params": jax.random.PRNGKey(0),
             "dropout": jax.random.PRNGKey(0)},
            jnp.zeros((1, 64, 64, 3)), True))
        zeros = jax.tree_util.tree_map(
            lambda s: np.zeros(s.shape, np.float32), shapes)
        load_jax_variables(
            build_model(get_config(name, v3=v3, n_classes=7, depth=depth)),
            zeros["params"], zeros["batch_stats"])
