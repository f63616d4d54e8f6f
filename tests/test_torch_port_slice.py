"""The port's serving slice on the CPU against the JAX package:
nanovs_slam_torch.inference.make_infer_fn(device="cpu") against
nanovs_slam_tpu.inference.make_infer_fn(use_pallas=False), KP2DTiny-N at
64x96, batch 2, fixed-K keypoints. Plus the port's import boundary and its
refusal to fall back to the CPU."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import (assert_dense_outputs_match,
                              assert_top_k_match_as_sets)
from nanovs_slam_tpu.configs import get_config as jax_get_config
from nanovs_slam_tpu.inference import make_infer_fn as jax_make_infer_fn
from nanovs_slam_tpu.models.kp2dtiny import build_model as jax_build_model
from nanovs_slam_tpu.models.kp2dtiny import init_model as jax_init_model
from nanovs_slam_tpu.ops.image import to_model_input as jax_to_model_input
from nanovs_slam_torch.configs import get_config
from nanovs_slam_torch.inference import make_infer_fn
from nanovs_slam_torch.models.kp2dtiny import build_model
from nanovs_slam_torch.utils.convert import load_jax_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, B, TOP_K, CONF = 64, 96, 2, 100, 0.5


@pytest.fixture(scope="module")
def slice_outputs():
    cfg = jax_get_config("N", n_classes=6)
    model = jax_build_model(cfg)
    params, bs = jax_init_model(model, jax.random.PRNGKey(11), (1, H, W, 3))
    rs = np.random.RandomState(12)
    params = jax.tree_util.tree_map(np.asarray, params)
    bs = jax.tree_util.tree_map_with_path(
        lambda p, v: (rs.uniform(0.5, 1.5, v.shape) if p[-1].key == "var"
                      else rs.randn(*v.shape) * 0.1).astype(np.float32), bs)
    frames = rs.randint(0, 256, (B, H, W, 3)).astype(np.uint8)

    jax_infer = jax_make_infer_fn(model, cfg, H, W, top_k=TOP_K,
                                  conf_threshold=CONF, use_pallas=False)
    want = jax_infer({"params": params, "batch_stats": bs},
                     jax_to_model_input(jnp.asarray(frames)))
    want = {k: np.asarray(v) for k, v in want.items()}

    port = load_jax_variables(build_model(get_config("N", n_classes=6)),
                              params, bs)
    infer = make_infer_fn(port, get_config("N", n_classes=6), H, W,
                          top_k=TOP_K, conf_threshold=CONF, device="cpu")
    got = {k: v.numpy() for k, v in infer(frames).items()}
    return want, got


def test_slice_dense_outputs_match(slice_outputs):
    assert_dense_outputs_match(*slice_outputs)


def test_slice_top_k_matches_as_sets(slice_outputs):
    assert_top_k_match_as_sets(*slice_outputs, CONF)


def test_port_imports_no_jax():
    """Importing every module of the port (the VO path, the training path
    and their CLIs included), and chip_smoke, leaves jax, flax, optax,
    orbax and nanovs_slam_tpu out of sys.modules, and cv2 and sklearn
    too: the card's machine has neither, so no module imports them at the
    top (only the functions that need cv2 do)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import nanovs_slam_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'nanovs_slam_tpu', "
        "'cv2', 'sklearn'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_make_infer_fn_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    model = build_model(get_config("N", n_classes=3))
    with pytest.raises(RuntimeError, match="cuda"):
        make_infer_fn(model, get_config("N", n_classes=3), H, W)
    assert next(model.parameters()).device.type == "cpu"
