"""The port's utilities against the JAX package's on the CPU:
``utils/plot.py``, ``utils/info.py``, ``utils/profiling.py``,
``ops/cell_sample.py``, and the demo CLI (``python -m
nanovs_slam_torch.demo``)."""

import os

import numpy as np
import pytest
import torch

from nanovs_slam_torch.configs import get_config
from nanovs_slam_torch.models.kp2dtiny import init_model
from nanovs_slam_torch.utils import info, plot, profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PINNED = os.path.join(REPO, "pinned", "extractor_S8.npz")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_colormaps_and_latex_table_equal_jax():
    """get_colormap (19 classes: Cityscapes', else the HSV walk) and
    colorize_segmentation equal the JAX package's exactly, as does
    latex_table's text."""
    from nanovs_slam_tpu.utils import plot as jplot

    for n in (1, 7, 19, 28):
        np.testing.assert_array_equal(plot.get_colormap(n),
                                      jplot.get_colormap(n))
    seg = np.random.RandomState(0).randint(-2, 30, (12, 16))
    np.testing.assert_array_equal(plot.colorize_segmentation(seg, 28),
                                  jplot.colorize_segmentation(seg, 28))
    rows = [{"config": "S", "repeatability": 0.7281, "mscore": 0.5},
            {"config": "N", "repeatability": 0.61, "mscore": 3}]
    assert plot.latex_table(rows, "cap") == jplot.latex_table(rows, "cap")
    assert plot.latex_table([]) == ""


def test_plots_are_written(tmp_path):
    """plot_trajectory (estimated and ground truth) and results_bar_chart
    write PNG files where they are asked to."""
    pytest.importorskip("matplotlib")
    traj = [np.array([i * 0.1, 0.0, i * 1.0]) for i in range(10)]
    gt = [np.array([[0.0], [0.0], [i * 1.1]]) for i in range(10)]
    for path in (plot.plot_trajectory(traj, gt, str(tmp_path / "t.png")),
                 plot.results_bar_chart({"a": 1.0, "b": 2, "c": "x"},
                                        str(tmp_path / "b.png"))):
        with open(path, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"


@pytest.mark.parametrize("name,kw", [("N", {}), ("S_A", dict(v3=True)),
                                     ("D", {})])
def test_gather_info_counts_equal_jax(name, kw):
    """gather_info of a port model equals the JAX gather_info of the same
    config on the flax tree shapes (counts exactly; the flax params
    counted from jax.eval_shape); n_params of a tree counts as the JAX
    one does."""
    import jax

    from nanovs_slam_tpu.configs import get_config as jget
    from nanovs_slam_tpu.models.kp2dtiny import build_model as jbuild
    from nanovs_slam_tpu.utils import info as jinfo

    cfg = get_config(name, n_classes=8, **kw)
    model = init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    jcfg = jget(name, n_classes=8, **kw)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jbuild(jcfg).init(
        {"params": key, "dropout": key}, np.zeros((1, 48, 64, 3),
                                                  np.float32), False))
    want = jinfo.gather_info(jcfg, shapes["params"])
    assert info.gather_info(cfg, model) == want
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape),
                                  dict(shapes["params"]))
    assert info.n_params(tree) == jinfo.n_params(tree) \
        == want["total_params"]


def test_profiling_tools(tmp_path, capsys):
    """trace writes a Chrome trace of the block; timing prints the call's
    wall time as the JAX decorator does; StepTimer's statistics; and
    chained_device_time (on the CPU, the host clock) recovers a step's
    cost from the slope of two chain lengths: a step that sleeps 3 ms
    reads within 1 ms of it."""
    import time

    with profiling.trace(str(tmp_path / "tr")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0

    @profiling.timing
    def work(x):
        return x * 2

    assert work(3) == 6
    assert capsys.readouterr().out.startswith("Execution time of work: ")
    timer = profiling.StepTimer()
    for _ in range(4):
        with timer.measure("step"):
            time.sleep(0.001)
    st = timer.stats()["step"]
    assert st["n"] == 4 and st["p50_ms"] >= 1.0 and st["fps"] > 0

    def step(x):
        time.sleep(0.003)
        return x.sum()

    dev, fixed = profiling.chained_device_time(step, torch.ones(8), n_lo=2,
                                               n_hi=8, repeats=2)
    assert abs(dev - 0.003) <= 1e-3 and fixed >= 0.0


def test_cell_sample_matches_jax_and_the_postprocess_twin():
    """sample_cell_descriptors_dense (36-tap stencil) within 1e-5 of the
    JAX function on the same inputs (normalised and not), and of the
    postprocess twin's sampling of the same map at the same decoded
    coordinates (its border cells included); feat_pixel_coords equal."""
    import jax.numpy as jnp

    from nanovs_slam_tpu.ops import cell_sample as jcs
    from nanovs_slam_torch.kernels.postprocess import fused_postprocess
    from nanovs_slam_torch.ops import cell_sample as cs

    rs = np.random.RandomState(1)
    B, Hc, Wc, C, cell = 2, 12, 16, 32, 4
    H, W = Hc * cell, Wc * cell
    feat = rs.randn(B, 2 * Hc, 2 * Wc, C).astype(np.float32)
    score = rs.rand(B, Hc, Wc, 1).astype(np.float32)
    shift = rs.uniform(-1, 1, (B, Hc, Wc, 2)).astype(np.float32)
    _, coord, desc = fused_postprocess(*(torch.from_numpy(a) for a in (
        score, shift, feat)), H, W, cell, 2.0)
    for norm in (True, False):
        got = cs.sample_cell_descriptors_dense(
            torch.from_numpy(feat), coord, H, W, normalize=norm).numpy()
        want = np.asarray(jcs.sample_cell_descriptors_dense(
            jnp.asarray(feat), jnp.asarray(coord.numpy()), H, W,
            normalize=norm))
        np.testing.assert_allclose(got, want, atol=1e-5)
        if norm:
            np.testing.assert_allclose(got, desc.numpy(), atol=1e-5)
    px, py = cs.feat_pixel_coords(coord, H, W, 2 * Hc, 2 * Wc)
    jx, jy = jcs.feat_pixel_coords(jnp.asarray(coord.numpy()), H, W,
                                   2 * Hc, 2 * Wc)
    np.testing.assert_allclose(px.numpy(), np.asarray(jx), rtol=1e-7)
    np.testing.assert_allclose(py.numpy(), np.asarray(jy), rtol=1e-7)


def test_demo_cli_draws_frames(tmp_path, capsys):
    """``python -m nanovs_slam_torch.demo`` on a folder of 3 synthetic
    frames (pinned S8, 48x64, --device cpu): a PNG a frame, the frame over
    its class map (96x64), each with keypoints; --tracks runs the VO's
    match tracks over the same frames."""
    cv2 = pytest.importorskip("cv2")
    from nanovs_slam_torch import demo
    from nanovs_slam_torch.dryrun import shifted_frames

    frames = tmp_path / "in"
    frames.mkdir()
    for i, f in enumerate(shifted_frames(3, 96, 128)):
        cv2.imwrite(str(frames / f"{i}.png"),
                    (f[..., ::-1] * 255).astype(np.uint8))
    args = ["--input", str(frames), "--config", "S", "--n_classes", "8",
            "--model_path", PINNED, "--im_h", "48", "--im_w", "64",
            "--conf", "0.0", "--top_k", "50", "--device", "cpu"]
    assert demo.main(args + ["--out_dir", str(tmp_path / "out")]) == 0
    shots = sorted(os.listdir(tmp_path / "out"))
    assert shots == [f"frame_{i:04d}.png" for i in range(3)]
    assert cv2.imread(str(tmp_path / "out" / shots[0])).shape == (96, 64, 3)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.endswith("keypoints")]
    assert len(lines) == 3 and all(int(ln.split()[-2]) > 0 for ln in lines)
    assert demo.main(args + ["--out_dir", str(tmp_path / "tracks"),
                             "--tracks"]) == 0
    assert len(os.listdir(tmp_path / "tracks")) == 3
