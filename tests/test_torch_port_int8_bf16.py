"""Int8 execution of bfloat16 models: the port (``quant.int8_execution``
on a ``cfg.dtype="bfloat16"`` model, the int8 conv's bf16 twin) against the
JAX package's int8 execution at bf16 on the CPU.

The JAX block at bf16 quantises ``x.astype(float32)``, runs the int8 conv
to float32, its BatchNorm as a float32 affine rounded to bf16 and the
activation on bf16 (``nanovs_slam_tpu/modules/blocks.py``); a chained
producer quantises that bf16 value. The port's twin
(``kernels/int8conv.int8_conv3x3_plain`` with ``out_dtype=bfloat16``)
rounds at the same places, the card's kernel as its twin
(tests/test_torch_port_kernels.py, chip_smoke.py). Two things keep the
answers from being bit-equal: the BatchNorm's float32 formula (the port
folds it into a * y + b) and the codes: XLA quantises x / s as x * (1 / s)
inside a jit, the port divides (ROADMAP Queue 3), and bf16 inputs put
more quotients near a half-integer. Whole paths are therefore held as
tests/test_torch_port_bf16.py holds them: per output, the port's error
against the JAX float32 int8 answer is at most twice the JAX bf16 int8
answer's own plus 1e-3, with the same scales (JAX's) on every side."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from _torch_port_util import apply_jit, nhwc, random_variables
from nanovs_slam_tpu import quant as jquant
from nanovs_slam_tpu.configs import get_config as jax_get_config
from nanovs_slam_tpu.models.kp2dtiny import build_model as jax_build_model
from nanovs_slam_tpu.modules.blocks import ConvBNAct as JaxConvBNAct
from nanovs_slam_torch import quant
from nanovs_slam_torch.configs import get_config
from nanovs_slam_torch.kernels import int8_conv3x3_plain
from nanovs_slam_torch.models.kp2dtiny import build_model
from nanovs_slam_torch.modules.blocks import ConvBNAct, set_compute_dtype
from nanovs_slam_torch.utils.convert import (convert_variables,
                                             load_jax_variables)
from test_torch_port_int8 import _block_inputs  # the port's int8 forward

BF16 = torch.bfloat16
H, W, B = 48, 64, 2


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads for this file's torch work (the suite runs
    files in parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _ulp(v):
    """The spacing of bf16 values at |v| (subnormals at the least
    normal's)."""
    mag = np.maximum(np.abs(np.asarray(v, np.float32)),
                     np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(mag)) - 7).astype(np.float32)


def _err(a, b):
    return float(np.abs(np.asarray(a, np.float32)
                        - np.asarray(b, np.float32)).max())


# ------------------------------------------------------ the twin alone

class _Nest(fnn.Module):
    """A flax ``ConvBNAct`` at the path ``names`` ("backbone", "conv1b"),
    which is how ``int8_execution`` finds its scales."""
    names: tuple
    features: int
    dtype: object = jnp.bfloat16

    @fnn.compact
    def __call__(self, x):
        if len(self.names) == 1:
            return JaxConvBNAct(self.features, dtype=self.dtype,
                                name=self.names[0])(x)
        return _Nest(self.names[1:], self.features, self.dtype,
                     name=self.names[0])(x)


# (path, Cin, Cout, input): the image into conv1a, a middle block (bf16 in
# and out), a chained producer (codes in, pooled codes out at its
# consumer's scale) and a head block at config S's widths; and config N's
# widths that the kernel's strips are designed for: desc_head/convAa (72
# -> 48), seg_head/convs_4 (48 -> 96) and conv1b (16 -> 24, pooled codes)
BLOCKS = {"conv1a": ("backbone/conv1a", 3, 16, "image"),
          "middle": ("backbone/conv3b", 32, 64, "bf16"),
          "producer": ("backbone/conv1b", 16, 32, "codes"),
          "head": ("desc_head/convAa", 64, 64, "bf16"),
          "n_head": ("desc_head/convAa", 72, 48, "bf16"),
          "n_seg": ("seg_head/convs_4", 48, 96, "bf16"),
          "n_producer": ("backbone/conv1b", 16, 24, "codes")}
SCALES = {"backbone/conv1a": 1.0 / 127, "backbone/conv3b": 0.0123,
          "backbone/conv1b": 0.0211, "backbone/conv2a": 0.0371,
          "desc_head/convAa": 0.0157, "seg_head/convs_4": 0.0139}


@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_bf16_int8_twin_matches_the_jax_block(block):
    """One block at bf16 under ``int8_execution``, the same input on both
    sides (a bf16 map, or the same int8 codes for the chained producer),
    the flax block applied op by op (each op rounds to its dtype; a jit
    may keep excess precision between the BN and the activation): the
    port's ``int8_block`` (the twin on the CPU) against it.

    Codes (the producer's pooled output) equal: the input codes are equal
    (asserted for the bf16 maps: the scales are not absmax / 127 of these
    inputs and flax divides op by op).

    A bf16 output within one bf16 ulp of each element, counted where the
    rounding happens: one ulp of the pre-activation value (the two BN
    formulas differ by a float32 ulp or so, which can round to the
    neighbouring bf16 value), carried through the activation (times the
    slope for a negative value), plus one ulp of the output (the
    activation's product is rounded on each side, by 0.01 in float32 in
    the port and by bf16(0.01) in flax), plus 2^-21 of the BN affine's
    terms |acc m a| + |b| (near a cancelling zero the float32 formulas'
    difference is many bf16 ulps of the result). Measured: about a tenth
    of the elements one ulp apart, 5 of 885,000 beyond one ulp of their
    own magnitude, all within the bound. A share of the outputs is
    negative, so that the activation's product shows."""
    path, cin, cout, kind = BLOCKS[block]
    rs = np.random.RandomState(11)
    x32 = rs.uniform(-1, 1, (B, H, W, cin)).astype(np.float32)
    xb = torch.from_numpy(x32).to(BF16)
    codes = rs.randint(-127, 128, (B, H, W, cin)).astype(np.int8)
    mod = _Nest(tuple(path.split("/")), cout)
    params, bs = random_variables(mod, jnp.zeros((1, 8, 8, cin)), seed=12)
    inner = path.split("/")
    p, s = params, bs
    for k in inner:
        p, s = p[k], s[k]
    port = ConvBNAct(cin, cout)
    port.load_state_dict(convert_variables(p, s), strict=False)
    set_compute_dtype(port, BF16)
    port.path = path
    port.eval()
    var = {"params": params, "batch_stats": bs}
    if kind == "codes":
        jx = jquant.QTensor(jnp.asarray(codes), SCALES["backbone/conv1a"])
        tx = quant.QTensor(torch.from_numpy(codes),
                           SCALES["backbone/conv1a"])
    else:
        jx = jnp.asarray(xb.float().numpy(), jnp.bfloat16)
        tx = xb.permute(0, 3, 1, 2).contiguous()
        jq = np.asarray(jnp.clip(jnp.round(jx.astype(jnp.float32)
                                           / SCALES[path]), -127, 127))
        mine = np.clip(np.round(xb.float().numpy()
                                / np.float32(SCALES[path])), -127, 127)
        assert np.array_equal(jq, mine)
    chain = kind == "codes"
    with jquant.int8_execution(SCALES, chain=chain):
        want = mod.apply(var, jx)
    with torch.no_grad(), quant.int8_execution(SCALES, chain=chain):
        got = port(tx, pool=chain)
    if kind == "codes":
        assert isinstance(want, jquant.QTensor)
        w = np.asarray(fnn.max_pool(want.values, (2, 2), strides=(2, 2)))
        assert got.values.dtype == torch.int8
        assert np.array_equal(got.values.numpy(), w)
        assert got.scale == want.scale
        return
    assert want.dtype == jnp.bfloat16 and got.dtype == BF16
    g = nhwc(got.float())
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape
    # the pre-activation (slope 1) and the BN's terms, by the twin
    wq, m, a, b = port._int8_plan[1]
    s_in = SCALES[path]
    pre = nhwc(int8_conv3x3_plain(tx, wq, m, a, b, s_in, 1.0,
                                  out_dtype=BF16).float())
    terms = nhwc(int8_conv3x3_plain(tx, wq, m, a.abs(), torch.zeros_like(b),
                                    s_in, 1.0).abs()) + b.abs().numpy()
    act = np.where(pre > 0, np.float32(1), np.float32(0.01))
    bound = act * (_ulp(pre) + 2.0 ** -21 * terms) + _ulp(
        np.maximum(np.abs(g), np.abs(w)))
    assert np.all(np.abs(g - w) <= bound)
    assert 0.05 < float((w < 0).mean()) < 0.95


# ---------------------------------------------------------- whole paths

# (config, V3): N (V2), S (V2) and S_A (V3, attention), 8 classes
MODELS = {"N": ("N", False), "S": ("S", False), "S_A": ("S_A", True)}


def _images(seed, b=B):
    return np.random.RandomState(seed).uniform(-1, 1, (b, H, W, 3)).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def _setup(name):
    """(JAX float32 model, JAX bf16 model, variables, the port's bf16 model
    in eval mode, the JAX package's scales calibrated at bf16 (its int8
    deployment config), the port's scales calibrated at bf16) for one
    config, seeded random variables, calibrated on the same two images."""
    cfg_name, v3 = MODELS[name]
    kw = dict(v3=v3, n_classes=8)
    j32 = jax_build_model(jax_get_config(cfg_name, **kw))
    j16 = jax_build_model(jax_get_config(cfg_name, dtype="bfloat16", **kw))
    calib = _images(0)
    params, bs = random_variables(j32, calib[:1], False, seed=31)
    var = {"params": params, "batch_stats": bs}
    apply = jax.jit(lambda v, x: j16.apply(v, x, False,
                                           mutable=["intermediates"]))
    jscales = jquant.calibrate_conv_scales(
        lambda v, x, mutable: apply(v, x), var, [jnp.asarray(calib)])
    port = load_jax_variables(build_model(get_config(
        cfg_name, dtype="bfloat16", **kw)), params, bs).eval()
    scales = quant.calibrate_conv_scales(port, [calib])
    return j32, j16, var, port, jscales, scales


def _flips(inputs, scales):
    """(codes of the port's float block inputs that XLA's rule, x * (1 /
    s) with s a constant of the trace, puts one apart, codes compared):
    asserted at most one apart."""
    floats = {p: nhwc(v.float()) for p, v in inputs.items()
              if not isinstance(v, quant.QTensor)}
    jq = jax.jit(lambda d: {p: jnp.clip(jnp.round(t / scales[p]), -127, 127)
                            for p, t in d.items()})(
        {p: jnp.asarray(v) for p, v in floats.items()})
    flips = total = 0
    for path, v in floats.items():
        mine = np.clip(np.round(v / np.float32(scales[path])), -127, 127)
        d = np.abs(mine - np.asarray(jq[path]))
        assert d.max() <= 1, path
        flips += int((d > 0).sum())
        total += d.size
    return flips, total


@pytest.mark.parametrize("name,chain", [("N", True), ("S", True),
                                        ("S", False), ("S_A", True)])
def test_bf16_int8_forward_within_the_jax_bf16_error(name, chain):
    """The whole forward (every head) under ``int8_execution`` at bf16,
    chained (the deployment's default) and, for S, not; the JAX package's
    bf16 scales on every side: per output, the port's error against the
    JAX float32 model's int8 answer is at most twice the JAX bf16 int8
    answer's own plus 1e-3, and the output dtypes are the JAX bf16
    answer's. The port's block-input codes against XLA's rule for the
    same inputs: at most one apart, and at most 1 in 2,000 of them
    (measured: 0 to 5 in 1e5 here; each flip moves its block's output by
    one code times a weight, within the bound above)."""
    j32, j16, var, port, jscales, _ = _setup(name)
    x = _images(1)
    with jquant.int8_execution(jscales, chain=chain):
        ref = apply_jit(j32, var["params"], var["batch_stats"], x,
                        train=False)
        want = apply_jit(j16, var["params"], var["batch_stats"], x,
                         train=False)
    got, inputs = _block_inputs(port, x, jscales, chain)
    consumers = set(quant.BACKBONE_CHAIN.values())
    for path, xin in inputs.items():
        assert isinstance(xin, quant.QTensor) == (chain and path in
                                                  consumers), path
    flips, total = _flips(inputs, jscales)
    assert flips <= total / 2000, (flips, total)
    assert set(got) == set(want)
    for k in want:
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k
        g = nhwc(got[k].float())
        assert g.shape == want[k].shape, k
        assert _err(g, ref[k]) <= 2 * _err(want[k], ref[k]) + 1e-3, k


def test_bf16_calibration_matches_jax():
    """``calibrate_conv_scales`` on the bf16 model (its hooks read the bf16
    block inputs, as the JAX ``sow`` reads ``x.astype(float32)``): the
    same 23 keys as the JAX package's at bf16 (config S), each within
    2^-7 relative (the two bf16 forwards round at other places, so an
    absmax may sit a bf16 ulp apart), conv1a's (the image rounded to bf16
    on both sides) exactly."""
    _, _, _, _, jscales, scales = _setup("S")
    assert sorted(scales) == sorted(jscales)
    assert len(scales) == 23
    assert scales["backbone/conv1a"] == jscales["backbone/conv1a"]
    for k, v in jscales.items():
        assert abs(scales[k] - v) <= 2.0 ** -7 * v, (k, scales[k], v)


def _jax_infer(model, var, cfg, x, scales):
    """The JAX ``infer`` of an int8 model with the Pallas postprocess (its
    kernel branch, in interpret mode here): the model under chained
    ``int8_execution``, the fused postprocess decoding in float32, the
    class argmax."""
    from nanovs_slam_tpu.ops.pallas.postprocess_kernel import \
        fused_postprocess_pallas

    with jquant.int8_execution(scales, chain=True):
        out = apply_jit(model, var["params"], var["batch_stats"], x,
                        train=False)
    score, coord, feat = fused_postprocess_pallas(
        jnp.asarray(out["score"]), jnp.asarray(out["coord"]),
        jnp.asarray(out["feat"]), H, W, cfg.cell, cfg.cross_ratio,
        interpret=True)
    ans = {"score": score, "coord": coord, "feat": feat, "vlad": out["vlad"],
           "seg": np.argmax(np.asarray(out["seg"], np.float32), -1)[..., None]}
    return {k: np.asarray(v) for k, v in ans.items()}


def test_bf16_int8_infer_fn_within_the_jax_bf16_error():
    """``make_infer_fn(int8_scales=...)`` of config N at bf16 on uint8
    frames (int8 chained, the fused postprocess's twin): score, coord,
    descriptors and vlad within twice the JAX bf16 int8 answer's error
    against the JAX float32 int8 one plus 1e-3; the class map agrees with
    the JAX bf16 one no less than that one agrees with the float32 map,
    minus one point. Under the scales the fused stem is not allowed (the
    card would otherwise take its bf16 instance for conv1a / conv1b)."""
    from nanovs_slam_torch.inference import make_infer_fn
    from nanovs_slam_torch.modules import backbone

    j32, j16, var, port, jscales, _ = _setup("N")
    frames = np.random.RandomState(2).randint(0, 256, (B, H, W, 3)).astype(
        np.uint8)
    x = frames.astype(np.float32) / 127.5 - 1.0
    cfg = get_config("N", n_classes=8, dtype="bfloat16")
    ref = _jax_infer(j32, var, cfg, x, jscales)
    want = _jax_infer(j16, var, cfg, x, jscales)
    x16 = torch.zeros(1, 3, H, W, dtype=BF16)
    with torch.no_grad():
        assert backbone.stem_kernel_allowed(port.backbone, x16)
        with quant.int8_execution(jscales, chain=True):
            assert not backbone.stem_kernel_allowed(port.backbone, x16)
    got = make_infer_fn(port, cfg, H, W, device="cpu",
                        int8_scales=jscales)(frames)
    assert quant.active_int8_scale("backbone/conv1a") is None
    got = {k: v.float().numpy() if v.is_floating_point() else v.numpy()
           for k, v in got.items()}
    for k in ("score", "coord", "feat", "vlad"):
        assert got[k].shape == want[k].shape, k
        assert _err(got[k], ref[k]) <= 2 * _err(want[k], ref[k]) + 1e-3, k
    agree_jax = np.mean(want["seg"] == ref["seg"])
    assert np.mean(got["seg"] == want["seg"]) >= agree_jax - 0.01


def test_int8_conv_takes_the_blocks_own_dtype():
    """A block reads a map of its own dtype or int8 codes: a bf16 map into
    a float32 block and a float32 map into a bf16 block raise on the CPU
    as on the card (no cast is made for them), and int8 codes feed either
    block, whose float output is of the block's dtype."""
    from nanovs_slam_torch.kernels import int8_conv3x3
    from nanovs_slam_torch.kernels.int8conv import padded_k

    rs = np.random.RandomState(7)
    x = torch.from_numpy(rs.uniform(-1, 1, (1, 8, 6, 10)).astype(np.float32))
    wq = torch.from_numpy(rs.randint(-127, 128, (16, padded_k(8))).astype(
        np.int8))
    m, a, b = (torch.from_numpy(v.astype(np.float32)) for v in (
        rs.rand(16) * 1e-3, 1 + 0.1 * rs.randn(16), 0.1 * rs.randn(16)))
    for xin, dt in ((x.to(BF16), torch.float32), (x, BF16)):
        with pytest.raises(TypeError, match="own dtype"):
            int8_conv3x3(xin, wq, m, a, b, 0.01, 0.01, out_dtype=dt)
    codes = torch.from_numpy(rs.randint(-127, 128, (1, 6, 10, 8)).astype(
        np.int8))
    for dt in (torch.float32, BF16):
        assert int8_conv3x3(codes, wq, m, a, b, 0.01, 0.01,
                            out_dtype=dt).dtype == dt
