"""The port's attention block, segmentation heads and GeM / ConvAP
aggregators against the flax modules on the CPU: seeded random flax
variables carried across by nanovs_slam_torch.utils.convert, inputs made
with numpy. Tolerance atol 1e-5 (float32, sums in another order)."""

import numpy as np
import pytest
import torch

from _torch_port_util import apply_jit, nchw, nhwc, random_variables
from nanovs_slam_tpu.modules import aggregators as jagg
from nanovs_slam_tpu.modules import attention as jatt
from nanovs_slam_tpu.modules import segmentation as jseg
from nanovs_slam_torch.modules import aggregators as tagg
from nanovs_slam_torch.modules import attention as tatt
from nanovs_slam_torch.modules import segmentation as tseg
from nanovs_slam_torch.utils.convert import load_jax_variables

ATOL = 1e-5


def _parity(jax_mod, torch_mod, *inputs, seed=0, atol=ATOL):
    """Run both modules on the same NHWC numpy inputs with the same
    variables; returns the outputs (numpy, NHWC) after comparing them."""
    params, bs = random_variables(jax_mod, *inputs, seed=seed)
    want = apply_jit(jax_mod, params, bs, *inputs)
    load_jax_variables(torch_mod, params, bs).eval()
    with torch.no_grad():
        got = torch_mod(*(nchw(a) for a in inputs))
    if not isinstance(want, tuple):
        want, got = (want,), (got,)
    assert len(got) == len(want)
    for w, g in zip(want, got):
        np.testing.assert_allclose(nhwc(g), w, atol=atol)
    return want


def _x(*shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_channel_layer_norm_matches_flax():
    x = _x(2, 6, 8, 16) * 3 + 1
    _parity(jatt.ChannelLayerNorm(), tatt.ChannelLayerNorm(16), x)


@pytest.mark.parametrize("hw", [(6, 8), (7, 9)])
def test_efficient_self_attention_matches_flax(hw):
    """An odd map too: the 2x2 stride-2 VALID k/v conv drops the last row
    and column."""
    x = _x(2, *hw, 16)
    _parity(jatt.EfficientSelfAttention(16), tatt.EfficientSelfAttention(16),
            x)


def test_mix_feed_forward_matches_flax():
    _parity(jatt.MixFeedForward(16), tatt.MixFeedForward(16), _x(2, 6, 8, 16))


def test_segformer_block_matches_flax():
    """norm, attention, norm, mix-FF with no residual: the output is not
    the input plus anything."""
    x = _x(2, 6, 8, 16)
    (y,) = _parity(jatt.SegFormerAttentionModule(16),
                   tatt.SegFormerAttentionModule(16), x)
    assert np.abs(y - x).max() > 0.1


# c_in = c_skip = 16, c_hidden = 16, d1 = 32, 5 classes, 8 descriptor
# channels; x at 6x8, skip at 12x16, as a backbone hands them over
_HEAD_ARGS = dict(c_hidden=16, c_out=5, d1=32)


@pytest.mark.parametrize("kind,depth", [("att", False), ("light", False),
                                        ("light", True), ("light_att", False),
                                        ("light_att", True)])
def test_segmentation_heads_match_flax(kind, depth):
    x, skip = _x(2, 6, 8, 16, seed=2), _x(2, 12, 16, 16, seed=3)
    if kind == "att":
        j = jseg.SegmentationHeadATT(**_HEAD_ARGS)
        t = tseg.SegmentationHeadATT(16, 16, 16, 5, 32)
    else:
        jcls, tcls = ((jseg.SegmentationFeatHeadLight,
                       tseg.SegmentationFeatHeadLight) if kind == "light" else
                      (jseg.SegmentationFeatHeadLightATT,
                       tseg.SegmentationFeatHeadLightATT))
        j = jcls(16, 5, 8, 32, depth=depth)
        t = tcls(16, 16, 16, 5, 8, 32, depth=depth)
    out = _parity(j, t, x, skip, seed=4)
    assert len(out) == (1 if kind == "att" else 3 if depth else 2)


def test_gem_matches_flax():
    """Negative inputs too: GeM clamps to eps before the power."""
    x = _x(2, 12, 16, 8)
    (y,) = _parity(jagg.GeM(), tagg.GeM(), x, seed=5)
    assert y.shape == (2, 8 * 16)


def test_convap_matches_flax():
    x = _x(2, 12, 16, 8)
    (y,) = _parity(jagg.ConvAP(8, 4, 4), tagg.ConvAP(8, 8, 4, 4), x, seed=6)
    assert y.shape == (2, 8 * 4 * 4)
