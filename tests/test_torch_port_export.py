"""The port's exports (``nanovs_slam_torch/export.py``) and export CLIs
(``python -m nanovs_slam_torch.export_model`` / ``export_onnx``) on the
CPU: ``make_export_fn`` against the JAX package's, a ``torch.export``
round trip, the ONNX files' contract (read with a minimal protobuf
reader: this environment has no ``onnx`` package), the int8 pickle read
by the JAX ``dequantize_params``, at 48x64."""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import random_variables
from nanovs_slam_tpu.configs import get_config as jax_get_config
from nanovs_slam_tpu.export import make_export_fn as jax_make_export_fn
from nanovs_slam_tpu.models.kp2dtiny import build_model as jax_build_model
from nanovs_slam_tpu.quant import dequantize_params as jax_dequantize
from nanovs_slam_tpu.quant import fake_quant_params as jax_fake_quant
from nanovs_slam_torch import export, export_model, export_onnx
from nanovs_slam_torch.configs import get_config
from nanovs_slam_torch.models.kp2dtiny import build_model, init_model
from nanovs_slam_torch.utils.convert import (_flatten, load_jax_variables,
                                             to_jax_variables)

H, W = 48, 64


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads for this file's torch work (the suite runs
    files in parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    """Config N (7 classes): JAX variables and the port model holding
    them, and an input in [-1, 1]."""
    jcfg = jax_get_config("N", n_classes=7)
    jm = jax_build_model(jcfg)
    x = np.random.RandomState(0).uniform(-1, 1, (1, H, W, 3)).astype(
        np.float32)
    params, bs = random_variables(jm, jnp.asarray(x), False)
    cfg = get_config("N", n_classes=7)
    model = load_jax_variables(build_model(cfg), params, bs).eval()
    return jm, jcfg, {"params": params, "batch_stats": bs}, cfg, model, x


def test_export_fn_matches_jax(setup):
    """``make_export_fn``'s (score, coord, feat, vlad, seg) against the JAX
    package's: score, coord and vlad within 1e-4, descriptor cosine above
    0.9999, classes equal on 99.9% of the pixels."""
    jm, jcfg, var, cfg, model, x = setup
    want = jax.jit(jax_make_export_fn(jm, jcfg, H, W))(var, jnp.asarray(x))
    got = export.make_export_fn(model, cfg, H, W)(torch.from_numpy(x))
    want = [np.asarray(w) for w in want]
    got = [g.numpy() for g in got]
    for i in (0, 1, 3):
        np.testing.assert_allclose(got[i], want[i], atol=1e-4)
    assert np.sum(got[2] * want[2], -1).min() > 0.9999
    assert got[4].shape == want[4].shape
    assert np.mean(got[4] == want[4]) >= 0.999


CLI_COMMON = ["--config", "N", "--n_classes", "7", "--im_h", str(H),
              "--im_w", str(W)]


@pytest.fixture(scope="module")
def cli_pt2(tmp_path_factory):
    """``export_model --format pt2`` (``export_program``) of config N (7
    classes, the CLI's seeded weights): the program's path, and the model
    and config that the CLI exported."""
    out = str(tmp_path_factory.mktemp("pt2") / "m")
    argv = CLI_COMMON + ["--out", out, "--format", "pt2"]
    path = export_model.main(argv)
    model, cfg = export_model.build(export_model.parse_args(argv))
    return path, model, cfg


def test_program_round_trip(setup, cli_pt2):
    """``export_program`` -> ``load_program``: the saved program's outputs
    equal ``make_export_fn``'s on the same model (1e-6: the same CPU
    kernels)."""
    x = setup[-1]
    path, model, cfg = cli_pt2
    with torch.no_grad():
        got = export.load_program(path).module()(torch.from_numpy(x))
    want = export.make_export_fn(model, cfg, H, W)(torch.from_numpy(x))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        torch.testing.assert_close(g, w, atol=1e-6, rtol=0)


def _varint(buf, i):
    v = s = 0
    while True:
        b = buf[i]
        i += 1
        v |= (b & 0x7F) << s
        s += 7
        if b < 0x80:
            return v, i


def _fields(buf):
    """(field number, value) of a protobuf message: an int for a varint,
    bytes for the other wire types."""
    i = 0
    while i < len(buf):
        key, i = _varint(buf, i)
        num, wire = key >> 3, key & 7
        if wire == 0:
            v, i = _varint(buf, i)
        elif wire == 2:
            n, i = _varint(buf, i)
            v, i = buf[i:i + n], i + n
        else:
            n = 8 if wire == 1 else 4
            v, i = buf[i:i + n], i + n
        yield num, v


def _onnx_contract(path):
    """(opset of the default domain, graph input names, output names) of
    an ONNX ModelProto: opset_import = 8 (domain 1, version 2), graph = 7
    (input 11, output 12, each a ValueInfoProto with name 1)."""
    with open(path, "rb") as f:
        model = f.read()
    opset, graph = None, None
    for num, v in _fields(model):
        if num == 8:
            entry = dict(_fields(v))
            if not entry.get(1):
                opset = entry[2]
        elif num == 7:
            graph = v

    def names(field):
        return [dict(_fields(v))[1].decode() for n, v in _fields(graph)
                if n == field]

    return opset, names(11), names(12)


@pytest.mark.parametrize("args,name,outputs", [
    ([], "KP2Dtiny_S.onnx", ["score", "coord", "desc", "vlad", "seg"]),
    (["--config", "N", "--to_mcu", "False", "--depth"], "KP2Dtiny_N.onnx",
     ["score", "coord", "desc", "vlad", "seg", "depth"]),
    (["--model_type", "KeypointFormer", "--config", "tiny", "--im_h",
      "64", "--im_w", "96"], "KeypointFormer.onnx",
     ["score", "coord", "desc", "vlad", "seg"])])
def test_onnx_contract(tmp_path, args, name, outputs):
    """``python -m nanovs_slam_torch.export_onnx``: opset 16, the one
    input "image" and the reference's output names (depth last where the
    config has it), for KP2DTiny (the MCU export variant by default) and
    KeypointFormer."""
    path = export_onnx.main(["--im_h", str(H), "--im_w", str(W),
                             "--model_path", str(tmp_path)] + args)
    assert os.path.basename(path) == name
    opset, inputs, outs = _onnx_contract(path)
    assert opset == 16
    assert inputs == ["image"]
    assert outs == outputs


def test_int8_pickle_reads_in_jax(tmp_path):
    """``export_model --format int8``: the JAX ``dequantize_params`` reads
    its ``qparams`` and gives the JAX ``fake_quant_params`` of the model's
    params, bit for bit; its batch_stats and config name ride beside."""
    path = export_model.main(["--config", "N", "--n_classes", "7",
                              "--format", "int8", "--out",
                              str(tmp_path / "m")])
    with open(path, "rb") as f:
        blob = pickle.load(f)
    assert set(blob) == {"qparams", "batch_stats", "config"}
    assert blob["config"] == "N"
    model = init_model(get_config("N", n_classes=7),
                       torch.Generator().manual_seed(0), "cpu")
    params, stats = to_jax_variables(model)
    got = _flatten(jax_dequantize(blob["qparams"]))
    want = _flatten(jax_fake_quant(params))
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    for k, v in _flatten(stats).items():
        assert np.array_equal(_flatten(blob["batch_stats"])[k], v), k


@pytest.mark.parametrize("args,match", [
    (["--format", "savedmodel"], "item 6"),
    (["--format", "stablehlo"], "item 6"),
    (["--format", "mcu"], "requires --to_mcu")])
def test_export_cli_refusals(args, match):
    with pytest.raises(SystemExit, match=match):
        export_model.main(args)


def test_export_cli_writes_pt2_and_mcu(cli_pt2, tmp_path):
    """``--format pt2`` writes a program that loads and runs; ``--format
    mcu --to_mcu`` (calibrated on the CPU) writes an int8 bundle whose
    numpy run is finite."""
    from nanovs_slam_torch import deploy

    with torch.no_grad():
        res = export.load_program(cli_pt2[0]).module()(
            torch.zeros(1, H, W, 3))
    assert all(torch.isfinite(r.float()).all() for r in res)
    common = CLI_COMMON + ["--out", str(tmp_path / "m")]
    nvsb = export_model.main(common + ["--format", "mcu", "--to_mcu",
                                       "--device", "cpu",
                                       "--calib_images", "2"])
    with open(nvsb, "rb") as f:
        assert b"conv8" in f.read()
    got = deploy.run_bundle_numpy(nvsb, np.zeros((H, W, 3), np.float32))
    assert all(np.isfinite(v).all() for v in got.values())
