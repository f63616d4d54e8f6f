"""The card-resident loader and the epoch loop on the CPU:
``data/device_cache.DeviceCachedPairLoader`` against the JAX package's
(the epoch's indices and homographies bit for bit, its batches with the
JAX photometric draws injected, the uint8 cache lossless, eval mode
deterministic), ``train/scan_epoch.make_epoch_fn`` against the loop over
``epoch()`` with the same step (as ``tests/test_scan_epoch.py`` holds the
JAX scan), and the trainer CLI with ``--device_cache``, ``--scan_epoch``
and ``--bf16``."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanovs_slam_tpu.data.device_cache import \
    DeviceCachedPairLoader as JaxLoader
from nanovs_slam_torch.configs import get_config
from nanovs_slam_torch.data import device_cache
from nanovs_slam_torch.data.datasets import SyntheticShapesDataset
from nanovs_slam_torch.data.device_cache import DeviceCachedPairLoader
from nanovs_slam_torch.models.kp2dtiny import init_model
from nanovs_slam_torch.modules.blocks import set_dropout
from nanovs_slam_torch.train.schedules import DEFAULT_LOSS_WEIGHTS
from nanovs_slam_torch.train.scan_epoch import (make_epoch_fn,
                                                shard_epoch_inputs,
                                                weights_as_arrays)
from nanovs_slam_torch.train.train_step import (create_train_state,
                                                make_optimizer,
                                                make_train_step)
from nanovs_slam_torch.utils.checkpoint import load_npz_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 48, 64


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads for this file's torch work: the suite runs
    files in parallel workers, and each worker's torch taking every core
    oversubscribes the machine many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class _U8Dataset:
    """Images of exact k/255 values (as decoded from 8-bit files) and
    class ids below 9."""

    def __init__(self, n=10, seed=0):
        rs = np.random.RandomState(seed)
        self.items = [{"image": rs.randint(0, 256, (H, W, 3)).astype(
                           np.float32) / 255.0,
                       "seg": rs.randint(0, 9, (H, W)).astype(np.int32)}
                      for _ in range(n)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def _dataset(kind):
    return (_U8Dataset() if kind == "u8"
            else SyntheticShapesDataset((H, W), 10, 6, seed=2))


def _jax_draws(seed, epoch, B):
    """photometric_draws replaced by the JAX loader's draws for the
    epoch's steps in order: the keys of ``_photometric``
    (``split(fold_in(PRNGKey(seed + epoch), s), 3)``) and its uniforms."""
    base = jax.random.PRNGKey(seed + epoch)
    step = iter(range(1 << 20))

    def draws(B_, generator, device):
        assert B_ == B
        r_gray, r_b, r_c = jax.random.split(
            jax.random.fold_in(base, next(step)), 3)
        shape = (B, 1, 1, 1)
        u = [jax.random.uniform(r_gray, shape),
             1.0 + jax.random.uniform(r_b, shape, minval=-0.1, maxval=0.1),
             1.0 + jax.random.uniform(r_c, shape, minval=-0.1, maxval=0.1)]
        return tuple(torch.from_numpy(np.array(a, np.float32)).to(device)
                     for a in u)

    return draws


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_epoch_arrays_are_the_jax_loaders(train):
    """(S, B) indices and (S, B, 3, 3) homographies of two epochs, bit for
    bit, and the same as the ones ``epoch()`` uses."""
    ds = _dataset("u8")
    want = JaxLoader(ds, 4, H, W, train=train, seed=11)
    got = DeviceCachedPairLoader(ds, 4, H, W, train=train, seed=11,
                                 device="cpu")
    assert len(got) == len(want) == 2
    for e in (0, 3):
        widx, whomo, _ = want.epoch_arrays(e)
        gidx, ghomo, gen = got.epoch_arrays(e)
        assert np.array_equal(gidx.numpy(), np.asarray(widx))
        assert ghomo.dtype == torch.float32
        assert np.array_equal(ghomo.numpy(), np.asarray(whomo))
        assert isinstance(gen, torch.Generator)
        for s, batch in enumerate(got.epoch(e)):
            assert np.array_equal(batch["homography"].numpy(),
                                  ghomo[s].numpy())


@pytest.mark.parametrize("kind", ["u8", "float"])
def test_batches_match_jax_under_injected_noise(kind, monkeypatch):
    """Every batch of an epoch against the JAX loader's with its own
    photometric draws handed to the port: images within 1e-5 (the luma
    dot and the mean sum in another order), masks and homographies
    exactly; the uint8 cache (k/255 images) and the float32 one."""
    ds = _dataset(kind)
    want = JaxLoader(ds, 4, H, W, train=True, seed=3)
    got = DeviceCachedPairLoader(ds, 4, H, W, train=True, seed=3,
                                 device="cpu")
    assert got.store_u8 == want.store_u8 == (kind == "u8")
    monkeypatch.setattr(device_cache, "photometric_draws",
                        _jax_draws(3, 1, 4))
    n = 0
    for w, g in zip(want.epoch(1), got.epoch(1)):
        n += 1
        assert set(w) == set(g)
        for k in w:
            gv, wv = g[k].numpy(), np.asarray(w[k])
            assert gv.shape == wv.shape, k
            if k.startswith("seg") or k == "homography":
                assert np.array_equal(gv, wv), k
            else:
                np.testing.assert_allclose(gv, wv, atol=1e-5, err_msg=k)
    assert n == 2


def test_uint8_cache_is_lossless():
    """k/255 images are kept as uint8 (a quarter of the bytes) and come
    back to the float32 values to an ulp; non-k/255 images stay
    float32 under "auto", and ``store_u8=False`` keeps both planes
    wide."""
    ds = _U8Dataset()
    u8 = DeviceCachedPairLoader(ds, 4, H, W, device="cpu")
    f32 = DeviceCachedPairLoader(ds, 4, H, W, store_u8=False, device="cpu")
    assert u8.images.dtype == torch.uint8 and u8.segs.dtype == torch.uint8
    assert f32.images.dtype == torch.float32
    assert f32.segs.dtype == torch.int32
    assert u8.nbytes() * 4 == f32.nbytes() == 10 * H * W * 4 * 4
    back = u8.images.float() / 255.0
    np.testing.assert_allclose(back.numpy(), f32.images.numpy(), rtol=0,
                               atol=6e-8)
    assert not DeviceCachedPairLoader(_dataset("float"), 4, H, W,
                                      device="cpu").store_u8


def test_eval_mode_is_deterministic_and_the_jax_loaders():
    """train=False: no shuffle and no augment, so two passes over an
    epoch give the same batches, which equal the JAX loader's (images
    1e-5, masks and homographies exactly)."""
    ds = _dataset("float")
    want = JaxLoader(ds, 4, H, W, train=False, seed=5)
    got = DeviceCachedPairLoader(ds, 4, H, W, train=False, seed=5,
                                 device="cpu")
    first = list(got.epoch(0))
    for a, b, w in zip(first, got.epoch(0), want.epoch(0)):
        for k in a:
            assert torch.equal(a[k], b[k]), k
            if k.startswith("seg") or k == "homography":
                assert np.array_equal(a[k].numpy(), np.asarray(w[k])), k
            else:
                np.testing.assert_allclose(a[k].numpy(), np.asarray(w[k]),
                                           atol=1e-5, err_msg=k)


def _state(seed=0):
    cfg = get_config("N", n_classes=9)
    model = init_model(cfg, torch.Generator().manual_seed(seed), "cpu")
    set_dropout(model, generator=torch.Generator().manual_seed(seed + 1))
    return cfg, create_train_state(model, make_optimizer("adam", 5e-4),
                                   with_io=False)


def test_epoch_fn_equals_the_step_loop():
    """One epoch (2 steps, config N at 48x64, dropout on, Adam) through
    ``make_epoch_fn`` and through the loop over ``epoch()``: the same
    per-step metrics and parameters, bit for bit (the same eager ops on
    the same inputs in the same order); the stacked metrics are (S,)
    tensors."""
    ds = _dataset("u8")
    loader = DeviceCachedPairLoader(ds, 4, H, W, seed=3, device="cpu")
    weights = DEFAULT_LOSS_WEIGHTS

    cfg, loop_state = _state()
    step = make_train_step(cfg, H, W)
    loop = []
    for batch in loader.epoch(0):
        loop_state, met = step(loop_state, batch, weights)
        loop.append({k: v.clone() for k, v in met.items()})

    cfg, scan_state = _state()
    epoch_fn = make_epoch_fn(make_train_step(cfg, H, W), d_f=cfg.cell // 2,
                             with_depth=False, augment=True)
    idx_all, homos_all, gen = loader.epoch_arrays(0)
    scan_state, stack = epoch_fn(scan_state, loader.cache_arrays(), idx_all,
                                 homos_all, weights_as_arrays(weights), gen)
    assert set(stack) == set(loop[0])
    for k, v in stack.items():
        assert v.shape == (2,), k
        assert torch.equal(v, torch.stack([m[k] for m in loop])), k
    assert scan_state.step == loop_state.step == 2
    for (k, a), b in zip(scan_state.model.named_parameters(),
                         loop_state.model.parameters()):
        assert torch.equal(a, b), k


def test_epoch_fn_takes_its_dropout_generator():
    """``step_gen`` becomes the model's dropout generator: two runs with
    generators of one seed agree, and another seed changes the losses."""
    ds = _dataset("u8")
    loader = DeviceCachedPairLoader(ds, 4, H, W, seed=3, device="cpu")
    losses = []
    for seed in (9, 9, 10):
        cfg, state = _state()
        fn = make_epoch_fn(make_train_step(cfg, H, W), cfg.cell // 2, False,
                           True)
        _, stack = fn(state, loader.cache_arrays(),
                      *loader.epoch_arrays(0)[:2], DEFAULT_LOSS_WEIGHTS,
                      loader.generator(0),
                      torch.Generator().manual_seed(seed))
        losses.append(stack["total_loss"])
    assert torch.equal(losses[0], losses[1])
    assert not torch.equal(losses[0], losses[2])


def test_shard_epoch_inputs_names_its_item():
    """shard_epoch_inputs is ported (it raised, naming ROADMAP Queue 1
    item 7): as the JAX one, it refuses a batch that the mesh's first axis
    does not divide, naming both (tests/test_torch_port_parallel.py runs
    its epoch on two ranks)."""
    from nanovs_slam_torch.parallel.mesh import Mesh

    mesh = Mesh(None, (0, 1), 0, torch.device("cpu"), ("data",), (2,))
    with pytest.raises(ValueError, match="batch 3 not divisible by mesh "
                       "axis 'data' size 2"):
        shard_epoch_inputs(mesh, None, None, torch.zeros(2, 3),
                           torch.zeros(2, 3, 3, 3))


@pytest.mark.parametrize("flags", [
    ["--device_cache"], ["--bf16", "--device_cache", "--scan_epoch"]],
    ids=["device_cache", "bf16-scan_epoch"])
def test_cli_trains_with_the_device_cache(flags, tmp_path):
    """``python -m nanovs_slam_torch.train_multitask --device cpu`` with
    the card-resident loader (and the epoch loop at bf16): one epoch of 2
    steps at the synthetic config's 96x128 (config S, batch 2), the cache
    reported, a finite loss logged, the .npz written with float32
    parameters."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="2")  # see _torch_threads
    r = subprocess.run(
        [sys.executable, "-m", "nanovs_slam_torch.train_multitask",
         "--device", "cpu", "--no_eval", "--dataset_name", "synthetic",
         "--batch_size", "2", "--synthetic_items", "4", "--n_epochs", "1",
         "--max_steps_per_epoch", "2", "--log_every", "1",
         "--out_model_path", str(tmp_path / "ck")] + flags,
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "device cache: 4 items" in r.stdout
    assert "E0 it1/2 loss" in r.stdout
    loss = float(r.stdout.split("E0 it1/2 loss ")[1].split()[0])
    assert np.isfinite(loss)
    tree, meta = load_npz_checkpoint(str(tmp_path / "ck.npz"))
    assert meta["step"] == 2
    assert tree["params"]["backbone"]["conv1a"]["conv"]["kernel"].dtype \
        == np.float32
