"""The port's training data path on the CPU against the JAX package:
homography sampling (bit for bit), the device-side pair batch, the host
augments (cv2's equalizeHist and GaussianBlur written in numpy), the
PairLoader's draws, and the numpy SyntheticShapesDataset against the cv2
one (cv2 is imported here only, as the JAX package's reference). Then the
trainer CLI on the CPU over that data: its runs, resume and flags."""

import json
import os
import subprocess
import sys

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanovs_slam_tpu.data import class_maps as jax_maps
from nanovs_slam_tpu.data import datasets as jax_datasets
from nanovs_slam_tpu.data import homography as jax_homo
from nanovs_slam_tpu.data import pipeline as jax_pipe
from nanovs_slam_torch.data import class_maps as port_maps
from nanovs_slam_torch.data import datasets as port_datasets
from nanovs_slam_torch.data import homography as port_homo
from nanovs_slam_torch.data import pipeline as port_pipe
from nanovs_slam_torch.configs import get_config
from nanovs_slam_torch.data.prefetch import device_prefetch
from nanovs_slam_torch.models.kp2dtiny import build_model
from nanovs_slam_torch.train.train_step import (create_train_state,
                                                make_optimizer)
from nanovs_slam_torch.utils.checkpoint import (load_npz_checkpoint,
                                                save_checkpoint)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads for this file's torch work: the suite runs
    files in parallel workers, and each worker's torch taking every core
    oversubscribes the machine many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("shape", [(48, 64), (120, 160), (240, 320)])
def test_sample_homography_is_bit_for_bit(shape):
    for seed in range(20):
        want = jax_homo.sample_homography(shape, np.random.RandomState(seed))
        got = port_homo.sample_homography(shape, np.random.RandomState(seed))
        assert got.dtype == want.dtype and np.array_equal(got, want), seed
    np.testing.assert_array_equal(
        port_homo.homography_to_pixel(want, shape),
        jax_homo.homography_to_pixel(want, shape))


def _pair_inputs(B=3, H=48, W=64, seed=0):
    rs = np.random.RandomState(seed)
    imgs = rs.rand(B, H, W, 3).astype(np.float32)
    segs = rs.randint(0, 9, (B, H, W)).astype(np.int32)
    depths = rs.rand(B, H, W, 1).astype(np.float32)
    homos = np.stack([jax_homo.sample_homography((H, W),
                                                 np.random.RandomState(i))
                      for i in range(B)]).astype(np.float32)
    return imgs, segs, homos, depths


def test_build_pair_batch_matches_jax():
    """Images and depth within 1e-5, the nearest-warped masks exactly
    (the destination grid is built with jnp.linspace's rounding)."""
    imgs, segs, homos, depths = _pair_inputs()
    want = jax_pipe.build_pair_batch(jnp.asarray(imgs), jnp.asarray(segs),
                                     jnp.asarray(homos), jnp.asarray(depths),
                                     d_f=2, with_depth=True)
    got = port_pipe.build_pair_batch(
        torch.from_numpy(imgs), torch.from_numpy(segs),
        torch.from_numpy(homos), torch.from_numpy(depths), d_f=2,
        with_depth=True)
    assert set(got) == set(want)
    for k in want:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.shape == w.shape, k
        if k.startswith("seg"):
            assert np.array_equal(g, w), (k, np.mean(g != w))
        else:
            np.testing.assert_allclose(g, w, atol=1e-5, err_msg=k)


def test_bilinear_homography_warp_matches_jax():
    imgs, _, homos, _ = _pair_inputs(seed=1)
    want = jax_homo.homography_warp_image(jnp.asarray(imgs),
                                          jnp.asarray(homos), "bilinear")
    got = port_homo.homography_warp_image(torch.from_numpy(imgs),
                                          torch.from_numpy(homos),
                                          "bilinear")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_equalize_hist_is_cv2s():
    rs = np.random.RandomState(2)
    for i in range(30):
        u8 = (rs.rand(48, 64) ** rs.uniform(0.3, 3) * 255).astype(np.uint8)
        if i == 0:
            u8[:] = 77  # a constant channel
        assert np.array_equal(port_pipe.equalize_hist(u8),
                              cv2.equalizeHist(u8)), i


def test_gaussian_blur_matches_cv2():
    """cv2.GaussianBlur 3x3 at the drawn sigma, BORDER_REFLECT_101: within
    1e-6 (measured 1.2e-7, one float32 ulp: cv2 sums in another order);
    the same draw from the RandomState."""
    rs = np.random.RandomState(3)
    for _ in range(10):
        img = rs.rand(48, 64, 3).astype(np.float32)
        seed = rs.randint(1 << 30)
        want = cv2.GaussianBlur(img, (3, 3),
                                np.random.RandomState(seed).uniform(0.1, 1))
        got = port_pipe.gaussian_blur(img, np.random.RandomState(seed))
        np.testing.assert_allclose(got, want, atol=1e-6)


def test_pair_loader_matches_jax_loader():
    """The JAX PairLoader (cv2 augments) and the port's (numpy augments,
    device "cpu") over a synthetic set with the same seed: the same
    shuffle, augment draws and homographies, so every batch's images
    within 1e-5 and its masks and homographies exactly, over two
    epochs."""
    ds = port_datasets.SyntheticShapesDataset((48, 64), 12, 6, seed=4)
    jl = jax_pipe.PairLoader(ds, 4, 48, 64, seed=7)
    pl = port_pipe.PairLoader(ds, 4, 48, 64, seed=7, device="cpu")
    for _ in range(2):
        n = 0
        for w, g in zip(jl, pl):
            n += 1
            for k in w:
                gv, wv = g[k].numpy(), np.asarray(w[k])
                if k.startswith("seg") or k == "homography":
                    assert np.array_equal(gv, wv), k
                else:
                    np.testing.assert_allclose(gv, wv, atol=1e-5,
                                               err_msg=k)
        assert n == len(pl) == 3
    assert np.array_equal(pl.rng.get_state()[1], jl.rng.get_state()[1])


def test_prefetch_on_cpu_is_the_identity():
    """device_prefetch hands CPU batches on as they are, and a loader's
    prefetched batches equal its plain ones."""
    ds = port_datasets.SyntheticShapesDataset((48, 64), 8, 6, seed=5)

    def loader():
        return port_pipe.PairLoader(ds, 4, 48, 64, seed=1, device="cpu")

    host = list(loader().host_batches())
    assert all(g is h for g, h in
               zip(device_prefetch(iter(host), "cpu"), host))
    pairs = list(zip(loader().batches(prefetch=2), loader().batches()))
    assert len(pairs) == 2
    for x, y in pairs:
        assert all(torch.equal(x[k], y[k]) for k in x)


@pytest.mark.parametrize("size", [(48, 64), (120, 160)])
def test_synthetic_shapes_match_the_cv2_version(size):
    """The numpy SyntheticShapesDataset against the JAX package's cv2 one
    (same seeds): masks and depth exactly (cv2's rectangle and
    filled-circle scanlines), images within 1e-5 (the bicubic's float32
    rounding; measured 4.2e-7)."""
    want_ds = jax_datasets.SyntheticShapesDataset(size, 6, 28, seed=2,
                                                  with_depth=True)
    got_ds = port_datasets.SyntheticShapesDataset(size, 6, 28, seed=2,
                                                  with_depth=True)
    for i in range(6):
        w, g = want_ds[i], got_ds[i]
        assert np.array_equal(g["seg"], w["seg"]), i
        assert np.array_equal(g["depth"], w["depth"]), i
        np.testing.assert_allclose(g["image"], w["image"], atol=1e-5)


def test_cubic_resize_and_filled_circles_are_cv2s():
    """resize_cubic against cv2.resize(INTER_CUBIC) within 1e-5 (measured
    2.2e-6 at 240x320); fill_circle against cv2.circle(thickness -1)
    exactly on 600 circles, many clipped by the frame."""
    rs = np.random.RandomState(6)
    for H, W in ((48, 64), (120, 160), (240, 320)):
        tex = rs.rand(H // 8 + 1, W // 8 + 1, 3).astype(np.float32)
        np.testing.assert_allclose(
            port_datasets.resize_cubic(tex, H, W),
            cv2.resize(tex, (W, H), interpolation=cv2.INTER_CUBIC),
            atol=1e-5)
    for t in range(600):
        H, W = ((48, 64), (120, 160))[t % 2]
        r, cx, cy = rs.randint(3, 60), rs.randint(-5, W + 5), \
            rs.randint(-5, H + 5)
        want = np.zeros((H, W), np.uint8)
        cv2.circle(want, (cx, cy), r, 1, -1)
        got = np.zeros((H, W), np.uint8)
        port_datasets.fill_circle(got, (cx, cy), r, 1)
        assert np.array_equal(got, want), (H, W, r, cx, cy)


def test_class_maps_are_the_jax_packages():
    assert np.array_equal(port_maps.cocostuff_lut(), jax_maps.cocostuff_lut())
    assert np.array_equal(port_maps.cityscapes_lut(),
                          jax_maps.cityscapes_lut())


# ------------------------------------------------------ the trainer CLI

def test_cli_trains_and_resumes_on_cpu(tmp_path):
    """``python -m nanovs_slam_torch.train_multitask --device cpu``: one
    epoch of 2 steps at the synthetic config's 96x128 (config S, 8
    classes, batch 2), the .npz written; then a resume from it, which
    prints the JAX trainer's "Restored model" line and counts its steps
    from 0."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="2")  # see _torch_threads
    base = [sys.executable, "-m", "nanovs_slam_torch.train_multitask",
            "--device", "cpu", "--no_eval", "--dataset_name", "synthetic",
            "--batch_size", "2", "--synthetic_items", "4",
            "--max_steps_per_epoch", "2", "--log_every", "1"]
    r = subprocess.run(base + ["--n_epochs", "1", "--out_model_path",
                               str(tmp_path / "a")], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "E0 it1/2" in r.stdout and (tmp_path / "a.npz").exists()
    r = subprocess.run(base + ["--n_epochs", "2", "--start_epoch", "1",
                               "--model_path", str(tmp_path / "a.npz"),
                               "--out_model_path", str(tmp_path / "b")],
                       cwd=tmp_path, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "(epoch 1)" in r.stdout, r.stdout
    # the resume starts the step count again, as the JAX trainer's fresh
    # optimizer state does: the resumed epoch's 2 steps
    _, meta = load_npz_checkpoint(str(tmp_path / "b.npz"))
    assert meta["step"] == 2 and meta["epoch"] == 2


@pytest.mark.parametrize("flags", [
    ["--depth", "--watch_gradients"],
    ["--only_segmentation", "--freeze_backbone", "--lr_scheduler", "step"],
    ["--no_vpr", "--model_type", "KP2DtinyV3", "--loss_schedule", "refined",
     "--lr_scheduler", "plateau"],
    ["--only_keypoints", "--ignore_seg_head", "--lr_scheduler", "none"]])
def test_cli_options_run_on_cpu(flags, tmp_path, monkeypatch):
    """The trainer's main() in-process on the CPU (synthetic 96x128, 8
    classes, config S, batch 2, 2 steps) under its task, schedule and
    head flags: each run logs finite losses to metrics.jsonl and writes a
    checkpoint; --watch_gradients logs per-module gradient norms,
    --only_segmentation trains no inlier net, --ignore_seg_head resumes
    from a checkpoint of another class count."""
    from nanovs_slam_torch import train_multitask

    monkeypatch.chdir(tmp_path)
    base = ["--device", "cpu", "--no_eval", "--dataset_name", "synthetic",
            "--batch_size", "2", "--synthetic_items", "4", "--n_epochs",
            "1", "--log_every", "1", "--out_model_path",
            str(tmp_path / "ck")]
    if "--ignore_seg_head" in flags:
        # a checkpoint of the same model with another class count
        cfg = get_config("S", n_classes=5)
        pstate = create_train_state(build_model(cfg),
                                    make_optimizer("adam", 5e-4))
        save_checkpoint(str(tmp_path / "other"), pstate)
        flags = flags + ["--model_path", str(tmp_path / "other.npz")]
    train_multitask.main(base + flags)
    rows = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    steps = [r for r in rows if "loss/total_loss" in r]
    assert len(steps) == 2
    assert all(np.isfinite(r["loss/total_loss"]) for r in steps)
    tree, meta = load_npz_checkpoint(str(tmp_path / "ck.npz"))
    assert meta["step"] == 2
    if "--watch_gradients" in flags:
        assert "loss/grad_norm/backbone" in steps[0]
        assert "loss/depth_loss" in steps[0]
    if "--only_segmentation" in flags:
        assert "io_params" not in tree and "loss/io_loss" not in steps[0]
    if "--no_vpr" in flags:
        assert "loss/vlad_loss" not in steps[0]
