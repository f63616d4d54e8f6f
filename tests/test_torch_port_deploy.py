"""The port's MCU bundles (``nanovs_slam_torch/deploy.py``) and whole-tree
BatchNorm folding (``utils/fuse.fold_batchnorm``) against the JAX
package's on the CPU: the ``.nvsb`` bytes, the numpy interpreter and the C
runtime on the pinned bundle, the interpreter against the port's int8
forward, at 48x64."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import nchw, random_variables
from nanovs_slam_tpu import deploy as jdeploy
from nanovs_slam_tpu.configs import get_config as jax_get_config
from nanovs_slam_tpu.models.kp2dtiny import build_model as jax_build_model
from nanovs_slam_tpu.utils.fuse import fold_batchnorm as jax_fold_batchnorm
from nanovs_slam_torch import deploy, quant
from nanovs_slam_torch.configs import get_config
from nanovs_slam_torch.models.kp2dtiny import build_model
from nanovs_slam_torch.utils.convert import (_flatten, load_jax_variables,
                                             to_jax_variables)
from nanovs_slam_torch.utils.fuse import fold_batchnorm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PINNED_BUNDLE = os.path.join(REPO, "pinned", "kp2dtiny_S8_int8.nvsb")
H, W = 48, 64
HEADS = ("score", "loc", "desc")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads for this file's torch work (the suite runs
    files in parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mcu():
    """Config S's MCU export variant (to_mcu, to_export, 7 classes), JAX
    variables and the port model holding them, its scales calibrated by
    the port on one image (heads score/loc/desc), and that image."""
    jcfg = jax_get_config("S", n_classes=7, to_mcu=True, to_export=True)
    img = np.random.RandomState(3).rand(H, W, 3).astype(np.float32)
    params, bs = random_variables(jax_build_model(jcfg),
                                  jnp.asarray(img[None]), False)
    cfg = get_config("S", n_classes=7, to_mcu=True, to_export=True)
    model = load_jax_variables(build_model(cfg), params, bs).eval()
    scales = quant.calibrate_conv_scales(model, [img[None]], heads=HEADS)
    return jcfg, cfg, params, bs, model, scales, img


@pytest.mark.parametrize("int8", [True, False])
def test_bundle_bytes_equal_jax(mcu, tmp_path, int8):
    """``export_mcu_bundle(model, cfg, path, scales)`` writes the bytes
    that the JAX package's writes for the same weights and scales (int8,
    and float32 without scales)."""
    jcfg, cfg, params, bs, model, scales, _ = mcu
    s = scales if int8 else None
    got = deploy.export_mcu_bundle(model, cfg, str(tmp_path / "p.nvsb"), s)
    want = jdeploy.export_mcu_bundle(params, bs, jcfg,
                                     str(tmp_path / "j.nvsb"), scales=s)
    with open(got, "rb") as f, open(want, "rb") as g:
        a, b = f.read(), g.read()
    assert a == b
    assert (b"conv8" in a) == int8


def test_numpy_interpreter_matches_the_int8_forward(mcu, tmp_path):
    """The bundle's numpy run against the port's int8 forward
    (``int8_execution``, unchained, heads score/loc/desc): the rule of
    tests/test_deploy_bundle.py (max error under 2e-2 and mean error under
    2e-3 of the output's mean magnitude)."""
    _, cfg, _, _, model, scales, img = mcu
    path = deploy.export_mcu_bundle(model, cfg, str(tmp_path / "b.nvsb"),
                                    scales)
    with torch.no_grad(), quant.int8_execution(scales):
        ref = model(nchw(img[None]), heads=HEADS)
    ref = {k: v[0].permute(1, 2, 0).numpy() for k, v in ref.items()}
    got = deploy.run_bundle_numpy(path, img)
    assert set(got) == set(ref)
    for k, r in ref.items():
        assert got[k].shape == r.shape, k
        scale = np.abs(r).mean() + 1e-6
        err = np.abs(got[k] - r)
        assert err.max() / scale < 2e-2 and err.mean() / scale < 2e-3, k


def test_pinned_bundle_runtimes_match_jax():
    """pinned/kp2dtiny_S8_int8.nvsb: the port's numpy interpreter equals
    the JAX package's exactly, and the port's C runtime (native/
    mcu_runtime.c built by the host compiler into nanovs_slam_torch/
    _build/) is within 1e-4 of it (the same arithmetic, another float32
    summation order)."""
    img = np.random.RandomState(5).rand(H, W, 3).astype(np.float32)
    want = jdeploy.run_bundle_numpy(PINNED_BUNDLE, img)
    got = deploy.run_bundle_numpy(PINNED_BUNDLE, img)
    assert set(got) == set(want) == {"score", "coord", "feat"}
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    got_c = deploy.run_bundle_c(PINNED_BUNDLE, img)
    for k in want:
        assert got_c[k].shape == want[k].shape
        assert np.abs(got_c[k] - want[k]).max() < 1e-4, k


def test_c_runtime_raises_without_a_compiler(monkeypatch, tmp_path):
    """No compiler builds the runtime: ``run_bundle_c`` raises with what
    the compilers said (no switch to numpy)."""
    bad = tmp_path / "bad-cc"
    bad.write_text("#!/bin/sh\necho 'cc: no toolchain' >&2\nexit 1\n")
    bad.chmod(0o755)
    monkeypatch.setattr(deploy, "compilers", lambda env, names: [str(bad)])
    monkeypatch.setattr(deploy, "BUILD_ROOT", tmp_path / "build")
    for attr, v in (("_LIB", None), ("_TRIED", False), ("build_log", None)):
        monkeypatch.setattr(deploy, attr, v)
    assert not deploy.c_runtime_available()
    with pytest.raises(RuntimeError, match="no toolchain"):
        deploy.run_bundle_c(PINNED_BUNDLE, np.zeros((H, W, 3), np.float32))


def test_pixelshuffle_config_rejected(mcu, tmp_path):
    model = build_model(get_config("S", n_classes=7))
    with pytest.raises(ValueError, match="convtranspose"):
        deploy.export_mcu_bundle(model, get_config("S", n_classes=7),
                                 str(tmp_path / "bad.nvsb"))


def test_fold_batchnorm_matches_jax_and_keeps_the_forward(mcu):
    """``fold_batchnorm`` of the port's flax-layout trees equals the JAX
    package's exactly, and the model with the folded trees gives the same
    eval forward within 1e-5 (every head)."""
    _, cfg, params, bs, model, _, img = mcu
    p, s = to_jax_variables(model)
    got = fold_batchnorm(p, s)
    want = jax_fold_batchnorm(params, bs)

    for g_tree, w_tree in zip(got, want):
        g, w = _flatten(g_tree), _flatten(w_tree)
        assert sorted(g) == sorted(w)
        for k in w:
            assert np.array_equal(g[k], w[k]), k
    folded = load_jax_variables(build_model(cfg), *got).eval()
    with torch.no_grad():
        a, b = model(nchw(img[None])), folded(nchw(img[None]))
    for k in a:
        torch.testing.assert_close(b[k], a[k], atol=1e-5, rtol=0)
