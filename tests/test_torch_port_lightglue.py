"""The port's LightGlue pair-matching path against the JAX package on the
CPU, and the LightGlue transformer kernel against its plain twin on the
card.

The same numpy arrays (from seeds) go through both packages. The JAX
package is imported inside the tests that need it, so that this file also
runs where only the port is installed (on the card:
``python -m pytest --noconftest tests/test_torch_port_lightglue.py``);
there the JAX tests skip. The card tests skip where CUDA is absent.
Tolerance: matches equal; matching scores and log assignment atol 1e-4,
rtol 1e-3, as ``tests/test_lightglue_kernel.py`` holds the Pallas kernel.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from nanovs_slam_torch.kernels.lightglue import (lightglue_transformer,
                                                 lightglue_transformer_plain)
from nanovs_slam_torch.matching.configs import (LIGHTGLUE_CONFIGS,
                                                LightGlueConfig)
from nanovs_slam_torch.matching.lightglue import LightGlue, inference_forward
from nanovs_slam_torch.matching.synthetic import (HOMOGRAPHY, textured_frame,
                                                  warp_frame)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PINNED_LG = os.path.join(REPO, "pinned", "lightglue_S.npz")
PINNED_EX = os.path.join(REPO, "pinned", "extractor_S8.npz")
TOL = dict(atol=1e-4, rtol=1e-3)


def _jax():
    pytest.importorskip("jax")
    pytest.importorskip("flax")
    import jax
    return jax


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _pair_data(M, N, D, B=1, seed=0, pad0=0, pad1=0, empty1=False):
    """Normalised keypoints, descriptors and validity masks as numpy."""
    rs = np.random.RandomState(seed)
    data = {"keypoints0": rs.uniform(-1, 1, (B, M, 2)).astype(np.float32),
            "keypoints1": rs.uniform(-1, 1, (B, N, 2)).astype(np.float32),
            "descriptors0": rs.randn(B, M, D).astype(np.float32),
            "descriptors1": rs.randn(B, N, D).astype(np.float32)}
    if pad0 or pad1 or empty1:
        mask0 = np.ones((B, M), bool)
        mask1 = np.ones((B, N), bool)
        mask0[:, M - pad0:] = False
        mask1[:, N - pad1:] = False
        if empty1:
            mask1[0] = False
        data.update(mask0=mask0, mask1=mask1)
    return data


def _torch_data(data, dev="cpu"):
    return {k: torch.from_numpy(v).to(dev) for k, v in data.items()}


def _compare(got, want):
    for k in ("matches0", "matches1"):
        np.testing.assert_array_equal(got[k].cpu().numpy(),
                                      np.asarray(want[k]), err_msg=k)
    for k in ("matching_scores0", "matching_scores1", "log_assignment"):
        np.testing.assert_allclose(got[k].cpu().numpy(), np.asarray(want[k]),
                                   err_msg=k, **TOL)


def _flax_params(name, seed=1):
    """Random-init flax params with every head (train=True init)."""
    jax = _jax()
    import jax.numpy as jnp
    from nanovs_slam_tpu.matching.configs import LIGHTGLUE_CONFIGS as JC
    from nanovs_slam_tpu.matching.lightglue import LightGlue as JaxLightGlue

    d = JC[name].input_dim
    data = {k: jnp.asarray(v) for k, v in _pair_data(8, 8, d).items()}
    params = JaxLightGlue(JC[name]).init(jax.random.PRNGKey(seed), data,
                                         train=True)["params"]
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def flax_params():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _flax_params(name)
        return cache[name]
    return get


def _port(name, params, **overrides):
    from nanovs_slam_torch.utils.convert import load_jax_lightglue

    cfg = dataclasses.replace(LIGHTGLUE_CONFIGS[name], **overrides)
    return load_jax_lightglue(LightGlue(cfg), params).eval()


def _flax_apply(name, params, data, **overrides):
    _jax()
    import jax.numpy as jnp
    from nanovs_slam_tpu.matching.configs import LIGHTGLUE_CONFIGS as JC
    from nanovs_slam_tpu.matching.lightglue import LightGlue as JaxLightGlue

    cfg = dataclasses.replace(JC[name], **overrides)
    return JaxLightGlue(cfg).apply(
        {"params": params}, {k: jnp.asarray(v) for k, v in data.items()})


# ------------------------------------------------------ module against flax

CASES = {
    "no_mask": dict(M=48, N=48),
    "padded": dict(M=48, N=48, pad0=12, pad1=20),
    "m_ne_n": dict(M=48, N=40, pad1=5),
    "image1_empty": dict(M=48, N=40, empty1=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("name", ["kp2dtiny_S", "kp2dtiny_F"])
def test_lightglue_matches_flax(flax_params, name, case):
    params = flax_params(name)
    data = _pair_data(D=LIGHTGLUE_CONFIGS[name].input_dim, B=2, seed=3,
                      **CASES[case])
    want = _flax_apply(name, params, data)
    with torch.no_grad():
        got = _port(name, params)(_torch_data(data))
    _compare(got, want)
    np.testing.assert_allclose(got["ref_descriptors0"].numpy(),
                               np.asarray(want["ref_descriptors0"]), **TOL)
    if case == "image1_empty":
        assert (got["matches0"][0] == -1).all()


@pytest.mark.parametrize("name", ["kp2dtiny_S", "kp2dtiny_F"])
def test_lightglue_early_exit_matches_flax(flax_params, name):
    """depth_confidence 0.5 with token_confidence_1 biased to certainty:
    both stop after layer 1, so layers 2 and 3 are no-ops."""
    params = dict(flax_params(name))
    params["token_confidence_1"] = {"token": dict(
        params["token_confidence_1"]["token"],
        bias=np.full((1,), 20.0, np.float32))}
    data = _pair_data(48, 40, LIGHTGLUE_CONFIGS[name].input_dim, B=2, seed=4,
                      pad0=6)
    want = _flax_apply(name, params, data, depth_confidence=0.5)
    port = _port(name, params, depth_confidence=0.5)
    with torch.no_grad():
        got = port(_torch_data(data))
        full = _port(name, params)(_torch_data(data))
    _compare(got, want)
    assert not torch.allclose(got["ref_descriptors0"],
                              full["ref_descriptors0"])


def test_pinned_lightglue_loads_every_array_and_matches_flax():
    from nanovs_slam_torch.utils.checkpoint import load_npz_checkpoint

    with np.load(PINNED_LG) as z:
        assert len(z.files) == 112 and "__meta__" in z.files
    tree, meta = load_npz_checkpoint(PINNED_LG)
    assert meta["config"]["lg_config"] == "kp2dtiny_S"
    params = tree["params"]
    n_leaves = sum(1 for _ in _leaves(params))
    assert n_leaves == 111
    port = _port("kp2dtiny_S", params)
    assert len(port.state_dict()) == n_leaves  # every array used once
    data = _pair_data(64, 56, 32, seed=5, pad0=10)
    want = _flax_apply("kp2dtiny_S", params, data)
    with torch.no_grad():
        got = port(_torch_data(data))
    _compare(got, want)


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def test_load_jax_lightglue_rejects_unmatched_keys(flax_params):
    from nanovs_slam_torch.utils.convert import load_jax_lightglue

    params = flax_params("kp2dtiny_S")
    partial = {k: v for k, v in params.items() if k != "token_confidence_0"}
    with pytest.raises(KeyError, match="token_confidence_0"):
        load_jax_lightglue(LightGlue(LIGHTGLUE_CONFIGS["kp2dtiny_S"]),
                           partial)
    extra = dict(params, bogus={"kernel": np.zeros((4, 4), np.float32)})
    with pytest.raises(KeyError, match="bogus"):
        load_jax_lightglue(LightGlue(LIGHTGLUE_CONFIGS["kp2dtiny_S"]), extra)
    with pytest.raises(ValueError, match="shape"):
        load_jax_lightglue(LightGlue(LIGHTGLUE_CONFIGS["kp2dtiny_F"]), params)


def _reference_names(sd):
    """The port's state_dict -> the reference LightGlue's names."""
    out = {}
    for k, v in sd.items():
        if k == "posenc.Wr":
            out["posenc.Wr.weight"] = v.t().contiguous()
            continue
        head, rest = k.split(".", 1)
        if head.rsplit("_", 1)[-1].isdigit():
            head = head.rsplit("_", 1)[0] + "." + head.rsplit("_", 1)[1]
        k = (f"{head}.{rest}".replace("ffn.fc1", "ffn.0")
             .replace("ffn.norm", "ffn.1").replace("ffn.fc2", "ffn.3")
             .replace("token.", "token.0."))
        out[k] = v.clone()
    return out


def test_torch_import_matches_jax_torch_import():
    _jax()
    from nanovs_slam_tpu.matching.torch_import import \
        convert_lightglue_state_dict

    from nanovs_slam_torch.matching.torch_import import load_torch_lightglue

    cfg = LIGHTGLUE_CONFIGS["kp2dtiny_S"]
    torch.manual_seed(6)
    ref_sd = _reference_names(LightGlue(cfg).state_dict())
    assert any(k.startswith("transformers.0.self_attn.ffn.0.") for k in ref_sd)
    port = load_torch_lightglue(LightGlue(cfg), ref_sd).eval()
    params = convert_lightglue_state_dict(ref_sd)
    data = _pair_data(40, 40, 32, seed=7, pad1=8)
    want = _flax_apply("kp2dtiny_S", params, data)
    with torch.no_grad():
        got = port(_torch_data(data))
    _compare(got, want)
    with pytest.raises(RuntimeError, match="Unexpected"):
        load_torch_lightglue(LightGlue(cfg), dict(ref_sd, bogus=torch.ones(1)))


# ---------------------------------------------- the twin and Pallas kernel

def test_twin_matches_pallas_fused_transformer(flax_params):
    """lightglue_transformer_plain against fused_transformer in interpret
    mode, kp2dtiny_S at K=32 (one case: interpret mode is slow), with the
    Pallas weights packed from the same flax params."""
    _jax()
    import jax.numpy as jnp
    from nanovs_slam_tpu.matching.configs import LIGHTGLUE_CONFIGS as JC
    from nanovs_slam_tpu.matching.lightglue import LightGlue as JaxLightGlue
    from nanovs_slam_tpu.ops.pallas.lightglue_kernel import (
        fused_transformer, pack_weights)

    params = flax_params("kp2dtiny_S")
    K, D, L, H = 32, 32, 4, 4
    data = _pair_data(K, K, D, seed=8, pad1=8)
    jm = JaxLightGlue(JC["kp2dtiny_S"])
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    d0, d1, enc0, enc1 = jm.apply({"params": params}, jdata, method=jm.embed)
    tables = [np.array(e[i][0, 0, :, 0::2]) for e in (enc0, enc1)
              for i in (0, 1)]
    am = [np.where(data[m][0], 0.0, -1e9).astype(np.float32)[None]
          for m in ("mask0", "mask1")]
    o0, o1 = fused_transformer(d0[0], d1[0], *map(jnp.asarray, tables),
                               *map(jnp.asarray, am),
                               pack_weights(params, L, H, D), L, H,
                               interpret=True)
    port = _port("kp2dtiny_S", params)
    t = [torch.from_numpy(a)[None] for a in tables]
    g0, g1 = lightglue_transformer_plain(
        torch.from_numpy(np.array(d0)), torch.from_numpy(np.array(d1)),
        *t, torch.from_numpy(data["mask0"]), torch.from_numpy(data["mask1"]),
        port.packed_weights(), range(L))
    np.testing.assert_allclose(g0[0].numpy(), np.asarray(o0), atol=1e-4)
    np.testing.assert_allclose(g1[0].numpy(), np.asarray(o1), atol=1e-4)


def test_twin_matches_module_blocks():
    """The twin on packed weights equals the module's plain blocks layer by
    layer, for both widths and a fully masked image."""
    torch.manual_seed(9)
    for name in ("kp2dtiny_S", "kp2dtiny_F"):
        port = LightGlue(LIGHTGLUE_CONFIGS[name]).eval()
        data = _torch_data(_pair_data(24, 20, port.cfg.input_dim, B=2,
                                      seed=10, pad0=4, empty1=True))
        with torch.no_grad():
            d0, d1, e0, e1 = port.embed(data)
            tab = [t[:, 0, :, 0::2].contiguous() for t in (*e0, *e1)]
            for i in range(port.cfg.n_layers):
                want = port.run_layer(i, d0, d1, e0, e1, data["mask0"],
                                      data["mask1"])
                got = lightglue_transformer(d0, d1, *tab, data["mask0"],
                                            data["mask1"],
                                            port.packed_weights(),
                                            range(i, i + 1))
                for g, w in zip(got, want):
                    torch.testing.assert_close(g, w, atol=1e-5, rtol=0)
                d0, d1 = want


def test_lightglue_wrapper_checks_inputs():
    port = LightGlue(LIGHTGLUE_CONFIGS["kp2dtiny_S"]).eval()
    x0, x1 = torch.randn(1, 8, 32), torch.randn(1, 6, 32)
    tab0 = [torch.randn(1, 8, 4)] * 2
    tab1 = [torch.randn(1, 6, 4)] * 2
    packed = port.packed_weights()
    with pytest.raises(ValueError, match="layers"):
        lightglue_transformer(x0, x1, *tab0, *tab1, None, None, packed,
                              range(0, 5))
    with pytest.raises(ValueError, match="cs1"):
        lightglue_transformer(x0, x1, *tab0, *tab0, None, None, packed)
    with pytest.raises(ValueError, match="mask1"):
        lightglue_transformer(x0, x1, *tab0, *tab1, None,
                              torch.ones(1, 6, dtype=torch.uint8), packed)
    with pytest.raises(ValueError, match="packed"):
        lightglue_transformer(x0, x1, *tab0, *tab1, None, None, packed[:, 1:])
    before = lightglue_transformer.launches
    out = lightglue_transformer(x0, x1, *tab0, *tab1, None, None, packed,
                                range(2, 2))
    assert lightglue_transformer.launches == before  # the twin is no launch
    torch.testing.assert_close(out[0], x0)


def test_inference_forward_width_pruning_raises():
    cfg = dataclasses.replace(LIGHTGLUE_CONFIGS["kp2dtiny_S"],
                              width_confidence=0.99)
    data = _torch_data(_pair_data(8, 8, 32))
    with pytest.raises(NotImplementedError, match="width pruning"):
        inference_forward(LightGlue(cfg), data)
    with pytest.raises(NotImplementedError, match="training"):
        LightGlue(LIGHTGLUE_CONFIGS["kp2dtiny_S"])(data, train=True)
    with torch.no_grad():
        pred = inference_forward(LightGlue(LIGHTGLUE_CONFIGS["kp2dtiny_S"]),
                                 data)
    assert tuple(pred["log_assignment"].shape) == (1, 9, 9)


# ------------------------------------------------- extractor and pair path

def _pinned_models():
    """(flax model, variables, port extractor, cfg) for pinned S8."""
    _jax()
    from nanovs_slam_tpu.configs import get_config as jax_get_config
    from nanovs_slam_tpu.models.kp2dtiny import build_model as jax_build

    from nanovs_slam_torch.configs import get_config
    from nanovs_slam_torch.models.kp2dtiny import build_model
    from nanovs_slam_torch.utils.checkpoint import load_npz_checkpoint
    from nanovs_slam_torch.utils.convert import load_jax_variables

    tree, _ = load_npz_checkpoint(PINNED_EX)
    variables = {"params": tree["params"], "batch_stats": tree["batch_stats"]}
    jmodel = jax_build(jax_get_config("S", n_classes=8))
    cfg = get_config("S", n_classes=8)
    port = load_jax_variables(build_model(cfg), tree["params"],
                              tree["batch_stats"])
    return jmodel, variables, port, cfg


def test_make_extractor_matches_jax():
    jmodel, variables, port, cfg = _pinned_models()
    import jax.numpy as jnp
    from nanovs_slam_tpu.configs import get_config as jax_get_config
    from nanovs_slam_tpu.matching.extractor import \
        make_extractor as jax_make_extractor

    from nanovs_slam_torch.matching.extractor import make_extractor

    H, W, K = 120, 160, 128
    img = textured_frame(H, W, 11)[None] * 2 - 1
    want = jax_make_extractor(jmodel, jax_get_config("S", n_classes=8), H, W,
                              max_keypoints=K)(variables, jnp.asarray(img))
    got = make_extractor(port, cfg, H, W, max_keypoints=K,
                         device="cpu")(img)
    assert tuple(got["keypoints"].shape) == (1, K, 2)
    sets = []
    for out in (want, got):
        m = np.asarray(out["mask"][0])
        kp = np.round(np.asarray(out["keypoints"][0])[m], 3)
        d = np.asarray(out["descriptors"][0])[m]
        sets.append(dict(zip(map(tuple, kp), d)))
    assert len(sets[0]) > 0 and set(sets[0]) == set(sets[1])
    for key, d in sets[0].items():
        assert float(np.dot(d, sets[1][key])) > 0.9999


def test_pair_matcher_matches_jax_pipeline():
    """make_pair_matcher (cpu) against the pipeline of bench_latency.py
    written out here, on pinned S8 and pinned LightGlue at 120x160 with a
    homography-warped pair."""
    jmodel, variables, port, cfg = _pinned_models()
    import jax
    import jax.numpy as jnp
    from nanovs_slam_tpu.configs import get_config as jax_get_config
    from nanovs_slam_tpu.matching.configs import LIGHTGLUE_CONFIGS as JC
    from nanovs_slam_tpu.matching.extractor import \
        make_extractor as jax_make_extractor
    from nanovs_slam_tpu.matching.lightglue import LightGlue as JaxLightGlue
    from nanovs_slam_tpu.matching.lightglue import \
        normalize_keypoints as jax_normalize

    from nanovs_slam_torch.matching.extractor import \
        gt_matches_from_homography
    from nanovs_slam_torch.matching.pair import make_pair_matcher
    from nanovs_slam_torch.utils.checkpoint import load_npz_checkpoint

    H, W, K = 120, 160, 256
    lg_params = load_npz_checkpoint(PINNED_LG)[0]["params"]
    img0 = textured_frame(H, W, 12)
    img1 = warp_frame(img0)
    img0, img1 = img0[None] * 2 - 1, img1[None] * 2 - 1

    extract = jax_make_extractor(jmodel, jax_get_config("S", n_classes=8), H,
                                 W, max_keypoints=K)
    matcher = JaxLightGlue(JC["kp2dtiny_S"])

    @jax.jit
    def pipeline(variables, lg_params, img0, img1):
        e0 = extract(variables, img0)
        e1 = extract(variables, img1)
        data = {"keypoints0": jax_normalize(e0["keypoints"], (W, H)),
                "keypoints1": jax_normalize(e1["keypoints"], (W, H)),
                "descriptors0": e0["descriptors"],
                "descriptors1": e1["descriptors"],
                "mask0": e0["mask"], "mask1": e1["mask"]}
        return matcher.apply({"params": lg_params}, data)

    want = pipeline(variables, lg_params, jnp.asarray(img0),
                    jnp.asarray(img1))
    lg = _port("kp2dtiny_S", lg_params)
    got = make_pair_matcher(port, cfg, lg, H, W, max_keypoints=K,
                            device="cpu")(img0, img1)
    np.testing.assert_array_equal(got["matches0"].numpy(),
                                  np.asarray(want["matches0"]))
    np.testing.assert_allclose(got["matching_scores0"].numpy(),
                               np.asarray(want["matching_scores0"]), **TOL)
    m0 = got["matches0"][0].numpy()
    assert (m0 > -1).sum() > 20
    _, gt0, _ = gt_matches_from_homography(
        got["keypoints0"][0].numpy(), got["keypoints1"][0].numpy(),
        HOMOGRAPHY, got["mask0"][0].numpy(), got["mask1"][0].numpy())
    correct = (m0 > -1) & (m0 == gt0)
    assert correct.sum() > 0.5 * (m0 > -1).sum()


def test_homography_helpers_equal_jax():
    _jax()
    from nanovs_slam_tpu.matching import extractor as jx

    from nanovs_slam_torch.matching import extractor as tx

    rs = np.random.RandomState(13)
    kp0 = rs.uniform(0, 100, (60, 2))
    kp1 = np.concatenate([tx.warp_points_np(kp0[:40], HOMOGRAPHY)
                          + rs.normal(0, 1, (40, 2)),
                          rs.uniform(0, 100, (15, 2))])
    mask0 = np.arange(60) < 55
    mask1 = np.arange(55) < 50
    np.testing.assert_array_equal(tx.warp_points_np(kp0, HOMOGRAPHY),
                                  jx.warp_points_np(kp0, HOMOGRAPHY))
    for a, b in zip(tx.gt_matches_from_homography(kp0, kp1, HOMOGRAPHY,
                                                  mask0, mask1),
                    jx.gt_matches_from_homography(kp0, kp1, HOMOGRAPHY,
                                                  mask0, mask1)):
        np.testing.assert_array_equal(a, b)


def test_make_pair_matcher_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from nanovs_slam_torch.configs import get_config
    from nanovs_slam_torch.matching.pair import make_pair_matcher
    from nanovs_slam_torch.models.kp2dtiny import build_model

    cfg = get_config("S", n_classes=8)
    with pytest.raises(RuntimeError, match="cuda"):
        make_pair_matcher(build_model(cfg), cfg,
                          LightGlue(LIGHTGLUE_CONFIGS["kp2dtiny_S"]), 120,
                          160, 256, 0.0)


# --------------------------------------------------------- kernel on a card

def _kernel_inputs(B, M, N, D, dev, seed=0, pad0=0, pad1=0, empty1=False):
    cfg = LightGlueConfig(input_dim=D, descriptor_dim=D, n_layers=4,
                          num_heads=4)
    torch.manual_seed(seed)
    port = LightGlue(cfg).eval()
    data = _torch_data(_pair_data(M, N, D, B, seed, pad0, pad1, empty1))
    with torch.no_grad():
        d0, d1, e0, e1 = port.embed(data)
    tab = [t[:, 0, :, 0::2].contiguous() for t in (*e0, *e1)]
    args = [d0, d1, *tab, data.get("mask0"), data.get("mask1"),
            port.packed_weights()]
    return [None if a is None else a.to(dev) for a in args]


@pytest.mark.parametrize("B,M,N,D,pad0,pad1,empty1", [
    (1, 512, 512, 32, 0, 0, False),
    (2, 512, 384, 32, 0, 154, False),
    (1, 300, 200, 32, 120, 7, False),
    (2, 256, 192, 32, 30, 0, True),
    (2, 256, 320, 64, 20, 40, False),
])
def test_lightglue_kernel_matches_plain(cuda, B, M, N, D, pad0, pad1,
                                        empty1):
    args = _kernel_inputs(B, M, N, D, cuda, 1, pad0, pad1, empty1)
    if not (pad0 or pad1 or empty1):
        args[6] = args[7] = None
    want = lightglue_transformer_plain(*args, range(4))
    before = lightglue_transformer.launches
    got = lightglue_transformer(*args)
    torch.cuda.synchronize()
    assert lightglue_transformer.launches == before + 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=0)
    lightglue_transformer.pdl = False  # launches in plain stream order
    try:
        serial = lightglue_transformer(*args)
    finally:
        lightglue_transformer.pdl = True
    for g, s in zip(got, serial):
        assert torch.equal(g, s)
    for layers in (range(1, 3), *(range(l, l + 1) for l in range(4))):
        part = lightglue_transformer(*args, layers=layers)
        want = lightglue_transformer_plain(*args, layers)
        for g, w in zip(part, want):
            torch.testing.assert_close(g, w, atol=1e-4, rtol=0)


def test_lightglue_module_on_card_matches_cpu(cuda):
    torch.manual_seed(2)
    for depth_confidence in (-1.0, 0.5):
        cfg = dataclasses.replace(LIGHTGLUE_CONFIGS["kp2dtiny_S"],
                                  depth_confidence=depth_confidence)
        port = LightGlue(cfg).eval()
        data = _pair_data(256, 200, 32, B=2, seed=3, pad1=30)
        with torch.no_grad():
            want = port(_torch_data(data))
            got = port.to(cuda)(_torch_data(data, cuda))
        assert (got["matches0"].cpu() == want["matches0"]).float().mean() \
            >= 0.999
        torch.testing.assert_close(got["log_assignment"].cpu(),
                                   want["log_assignment"], **TOL)
