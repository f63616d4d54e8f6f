"""Int8 execution, calibration, weight quantisation and QAT of the port
(``nanovs_slam_torch/quant.py``) against the JAX package's
``nanovs_slam_tpu/quant.py`` on the CPU, at 48x64: config S (8 classes)
and its MCU variant (convtranspose, ReLU), JAX variables drawn by
``tests/_torch_port_util.random_variables``. On the CPU the int8 conv runs
as the kernel's plain twin (``kernels/int8conv.int8_conv3x3_plain``); the
card holds the kernel against that twin (test_torch_port_kernels.py,
chip_smoke.py)."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nanovs_slam_tpu.modules.blocks as jax_blocks
import nanovs_slam_torch.modules.blocks as port_blocks
from _torch_port_util import nchw, nhwc, random_variables
from nanovs_slam_tpu import quant as jquant
from nanovs_slam_tpu.configs import get_config as jax_get_config
from nanovs_slam_tpu.models.inlier_net import InlierNet as JaxInlierNet
from nanovs_slam_tpu.models.kp2dtiny import build_model as jax_build_model
from nanovs_slam_tpu.train.train_step import \
    make_optimizer as jax_make_optimizer
from nanovs_slam_tpu.train.train_step import \
    make_train_step as jax_make_train_step
from nanovs_slam_torch import quant
from nanovs_slam_torch.configs import get_config
from nanovs_slam_torch.inference import make_infer_fn
from nanovs_slam_torch.models.inlier_net import InlierNet
from nanovs_slam_torch.models.kp2dtiny import build_model
from nanovs_slam_torch.modules.blocks import ConvBNAct
from nanovs_slam_torch.train.schedules import DEFAULT_LOSS_WEIGHTS
from nanovs_slam_torch.train.train_step import (create_train_state,
                                                make_optimizer,
                                                make_train_step)
from nanovs_slam_torch.utils.checkpoint import load_npz_checkpoint
from nanovs_slam_torch.utils.convert import (_flatten, convert_variables,
                                             load_jax_inlier_net,
                                             load_jax_variables,
                                             to_jax_variables)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PINNED = os.path.join(REPO, "pinned", "extractor_S8.npz")
H, W, LR = 48, 64, 5e-4
CONFIGS = {"S": dict(), "S_mcu": dict(to_mcu=True)}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads for this file's torch work (the suite runs
    files in parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _images(seed, b=2):
    return np.random.RandomState(seed).uniform(-1, 1, (b, H, W, 3)).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def _setup(name):
    """(name, JAX model, variables, port model in eval mode, the port's
    scales, the JAX package's scales) for config S or its MCU variant,
    calibrated on the same two images."""
    kw = CONFIGS[name]
    jm = jax_build_model(jax_get_config("S", n_classes=8, **kw))
    x = _images(0)
    params, bs = random_variables(jm, jnp.asarray(x[:1]), False)
    var = {"params": params, "batch_stats": bs}
    model = load_jax_variables(build_model(get_config("S", n_classes=8,
                                                      **kw)), params, bs)
    model.eval()
    scales = quant.calibrate_conv_scales(model, [x])
    calib = jax.jit(lambda v, b: jm.apply(v, b, False,
                                          mutable=["intermediates"]))
    jscales = jquant.calibrate_conv_scales(
        lambda v, b, mutable: calib(v, b), var, [jnp.asarray(x)])
    return name, jm, var, model, scales, jscales


@pytest.fixture(params=sorted(CONFIGS))
def setup(request):
    return _setup(request.param)


def test_calibration_matches_jax(setup):
    """The same keys (every ConvBNAct of every head: 23 in config S) and
    values within 1e-5 relative (the two forwards' float32 sums differ in
    order); conv1a's, whose input is the image, exactly."""
    _, _, _, _, scales, jscales = setup
    assert sorted(scales) == sorted(jscales)
    assert len(scales) == 23
    assert scales["backbone/conv1a"] == jscales["backbone/conv1a"]
    for k, v in jscales.items():
        assert abs(scales[k] - v) <= 1e-5 * v, (k, scales[k], v)


def _block_inputs(model, x, scales, chain):
    """Every int8 block's input (a float map or a chained QTensor) in one
    int8 forward."""
    seen = {}
    hooks = [m.register_forward_pre_hook(
        lambda mod, a: seen.__setitem__(mod.path, a[0]))
        for m in model.modules() if isinstance(m, ConvBNAct)]
    try:
        with torch.no_grad(), quant.int8_execution(scales, chain=chain):
            out = model(nchw(x))
    finally:
        for h in hooks:
            h.remove()
    return out, seen


@pytest.mark.parametrize("name,chain", [("S", False), ("S", True),
                                        ("S_mcu", False)])
def test_int8_forward_matches_jax(name, chain):
    """The port's int8 forward (every head) against ``quant.
    int8_execution`` (chained and not; the MCU variant, whose heads differ
    and whose backbone does not, unchained: its chained forward equals its
    unchained one, test_chained_equals_unchained), the same scales on both
    sides:
    within 1e-5 (BatchNorm's float32 formula differs: ~1e-7 a block).
    Each block's input codes by the port's rule (an IEEE division by the
    scale) and by the JAX package's (XLA divides by a constant as a
    product with its reciprocal) differ by at most 1 where they differ;
    a code flip moves the outputs beyond 1e-5, so 1e-5 holds only where
    no code flipped (measured: none at this seed)."""
    _, jm, var, model, scales, _ = _setup(name)
    x = _images(1)
    with jquant.int8_execution(scales, chain=chain):
        want = jax.jit(lambda v, im: jm.apply(v, im, False))(
            var, jnp.asarray(x))
    got, inputs = _block_inputs(model, x, scales, chain)
    floats = {p: nhwc(v) for p, v in inputs.items()
              if not isinstance(v, quant.QTensor)}
    # the scales are constants of the trace, as in int8_execution
    jq = jax.jit(lambda d: {p: jnp.clip(jnp.round(t / scales[p]), -127, 127)
                            for p, t in d.items()})(
        {p: jnp.asarray(v) for p, v in floats.items()})
    flips = 0
    for path, v in floats.items():
        mine = np.clip(np.round(v / np.float32(scales[path])), -127, 127)
        d = np.abs(mine - np.asarray(jq[path]))
        assert d.max() <= 1, path
        flips += int((d > 0).sum())
    assert flips == 0
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(nhwc(got[k]), np.asarray(want[k]),
                                   atol=1e-5, err_msg=k)


def test_chained_equals_unchained(setup):
    """Chaining moves where a code is made (the producer quantises its
    output at its consumer's scale; the max-pool acts on codes), not its
    value: the two forwards are equal. The chain's edges carry int8
    QTensors, pooled after conv1b."""
    _, _, _, model, scales, _ = setup
    x = _images(2)
    plain, _ = _block_inputs(model, x, scales, False)
    chained, inputs = _block_inputs(model, x, scales, True)
    for k in plain:
        assert torch.equal(plain[k], chained[k]), k
    consumers = set(quant.BACKBONE_CHAIN.values())
    for path, xin in inputs.items():
        assert isinstance(xin, quant.QTensor) == (path in consumers), path
    assert tuple(inputs["backbone/conv2a"].values.shape) == (2, H // 2,
                                                             W // 2, 32)


def test_int8_close_to_float32_and_infer_fn(setup):
    """``make_infer_fn(int8_scales=...)`` runs int8 (it differs from
    float32) within tests/test_int8_execution.py's bounds on the raw
    outputs (mean relative gap: score < 0.02, feat < 0.15), and its
    answer equals the forward under ``int8_execution`` post-processed."""
    _, _, _, model, scales, _ = setup
    x = _images(3)
    with torch.no_grad():
        f32 = model(nchw(x))
    i8, _ = _block_inputs(model, x, scales, True)
    for k, lim in (("score", 0.02), ("feat", 0.15)):
        a, b = f32[k], i8[k]
        assert not torch.allclose(a, b)
        assert float((a - b).abs().mean() / a.abs().mean()) < lim, k
    frames = np.round((x + 1) * 127.5).astype(np.uint8)
    cfg = model.cfg
    out = make_infer_fn(model, cfg, H, W, device="cpu",
                        int8_scales=scales)(frames)
    ref = make_infer_fn(model, cfg, H, W, device="cpu")(frames)
    assert not torch.equal(out["score"], ref["score"])
    assert quant.active_int8_scale("backbone/conv1a") is None


def test_quantized_params_equal_jax(setup):
    """``quantize_params_int8``, ``dequantize_params``,
    ``fake_quant_params`` and ``int8_size_bytes`` on the port's flax-layout
    trees (``to_jax_variables``) equal the JAX package's on the JAX
    variables, bit for bit."""
    _, _, var, model, _, _ = setup
    params, _ = to_jax_variables(model)
    q, jq = quant.quantize_params_int8(params), jquant.quantize_params_int8(
        var["params"])
    for got, want in ((q, jq),
                      (quant.fake_quant_params(params),
                       jquant.fake_quant_params(var["params"])),
                      (quant.dequantize_params(q),
                       jquant.dequantize_params(jq))):
        g, w = _flatten(got), _flatten(want)
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k
    assert quant.int8_size_bytes(q) == jquant.int8_size_bytes(jq)


def test_fake_quant_ste_matches_jax():
    """``fake_quant_ste`` per dim 0 of a torch weight equals the JAX
    package's per the flax kernel's last axis (conv OIHW / HWIO, Linear
    (out, in) / Dense (in, out)) within 1e-6 (XLA divides the absmax by
    127 as a product with 1 / 127, which can move the scale by its last
    bit), and passes the gradient straight through."""
    rs = np.random.RandomState(4)
    for shape, perm in (((3, 3, 5, 7), (3, 2, 0, 1)), ((6, 9), (1, 0))):
        w = rs.randn(*shape).astype(np.float32)
        want = np.asarray(jax.jit(jquant.fake_quant_ste)(jnp.asarray(w)))
        t = torch.from_numpy(np.ascontiguousarray(w.transpose(perm)))
        t.requires_grad_(True)
        got = quant.fake_quant_ste(t)
        np.testing.assert_allclose(got.detach().numpy(),
                                   want.transpose(perm), rtol=0, atol=1e-6)
        got.sum().backward()
        assert torch.equal(t.grad, torch.ones_like(t))


# ------------------------------------------------------------------ QAT

@pytest.fixture(scope="module")
def qat_step():
    """One QAT step on both sides: config S, 48x64, batch 2, Adam 5e-4,
    pinned S8 with seeded NetVLAD centroids and its inlier net, dropout
    the identity on both sides (test_torch_port_train_step.py's set-up)."""
    from test_torch_port_train_step import _batch, _jax_step

    tree, _ = load_npz_checkpoint(PINNED)
    nv = tree["params"]["vlad_head"]["netvlad"]
    nv["centroids"] = np.random.RandomState(7).rand(
        *nv["centroids"].shape).astype(np.float32)
    jcfg = jax_get_config("S", n_classes=8)
    step = jax_make_train_step(jax_build_model(jcfg), jcfg, H, W,
                               io_net=JaxInlierNet(blocks=4), qat=True,
                               donate=False)
    batch = _batch()
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_blocks.Dropout2d, "__call__",
               lambda self, x, train=False: x)
    mp.setattr(port_blocks.Dropout2d, "forward", lambda self, x: x)
    try:
        jmet, want = _jax_step((step, jax_make_optimizer("adam", LR)),
                               tree["params"], tree["batch_stats"],
                               tree["io_params"], tree["io_batch_stats"],
                               batch)
        cfg = get_config("S", n_classes=8)
        model = load_jax_variables(build_model(cfg), tree["params"],
                                   tree["batch_stats"])
        io = load_jax_inlier_net(InlierNet(), tree["io_params"],
                                 tree["io_batch_stats"])
        pstate = create_train_state(model, make_optimizer("adam", LR),
                                    io_net=io)
        tbatch = {k: torch.tensor(v) for k, v in batch.items()}
        for k in ("seg", "seg_aug"):
            tbatch[k] = tbatch[k].long()
        pstate, pmet = make_train_step(cfg, H, W, qat=True)(
            pstate, tbatch, DEFAULT_LOSS_WEIGHTS)
    finally:
        mp.undo()
    return jmet, want, {k: float(v) for k, v in pmet.items()}, pstate


def test_qat_train_step_matches_jax(qat_step):
    """The QAT step (``make_train_step(qat=True)``: the model's kernels
    fake-quantised, not the inlier net's) against the JAX package's
    ``qat=True`` step: loss terms within 1e-5 relative to max(1, |term|),
    grad_norm within 1e-5 relative, and the updated parameters as
    test_torch_port_train_step.py's test_train_step_updated_params_
    match_jax holds them (1e-5 where the raw gradient is at least 1e-6,
    2 lr everywhere)."""
    jmet, want, pmet, pstate = qat_step
    assert set(jmet) == set(pmet)
    for k in jmet:
        lim = 1e-5 * (jmet[k] if k == "grad_norm"
                      else max(1.0, abs(jmet[k])))
        assert abs(pmet[k] - jmet[k]) <= lim, (k, pmet[k], jmet[k])
    for net, tree, dense in ((pstate.model, want["params"], False),
                             (pstate.io_net, want["io_params"], True)):
        ref = convert_variables(tree, {}, dense)
        for k, p in net.named_parameters():
            d = (p.detach() - ref[k]).abs()
            live = p.grad.abs() >= 1e-6
            if live.any():
                assert d[live].max().item() <= 1e-5, k
            assert d.max().item() <= 2 * LR, k


def test_qat_params_are_the_kernel_leaves():
    """``qat_params`` covers exactly the flax ``kernel`` leaves of the
    model (convs, transposed convs), each on the int8 grid of its output
    channels; NetVLAD's assign_w and centroids stay float."""
    model = build_model(get_config("S", n_classes=8, to_mcu=True))
    fq = quant.qat_params(model)
    params, _ = to_jax_variables(model)
    kernels = {k for k in convert_variables(params, {})
               if k.endswith(".weight")
               and not k.split(".")[-2].startswith("bn")}
    assert set(fq) == kernels
    assert "vlad_head.netvlad.assign_w" not in fq
    assert "desc_head.upsample1.transposed_conv.weight" in fq
    for k, w in fq.items():
        scale = w.detach().abs().amax(dim=tuple(range(1, w.dim())),
                                      keepdim=True) / 127.0
        codes = w.detach() / scale
        assert torch.allclose(codes, torch.round(codes), atol=1e-3), k
