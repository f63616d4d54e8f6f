"""The rest of training's small modules on the CPU, against the JAX package
where it has them: the stem's kernel predicate (what autograd needs
decides whether the fused stem may run), ``losses/depth_extras``, the
port's k-means (against sklearn, by inertia), hard-negative mining
(``TripletMiningDataset``) and the secondary dataset readers (the
SceneParse150 LUT and folder reader, Tokyo 24/7, the HF readers on an
in-memory ``datasets.Dataset`` and a ``save_to_disk`` directory)."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanovs_slam_tpu.data import extra_datasets as jax_extra
from nanovs_slam_tpu.data import pittsburgh as jax_pitts
from nanovs_slam_tpu.losses import depth_extras as jax_dx
from nanovs_slam_torch.configs import get_config
from nanovs_slam_torch.data import extra_datasets as port_extra
from nanovs_slam_torch.data import pittsburgh as port_pitts
from nanovs_slam_torch.losses import depth_extras as port_dx
from nanovs_slam_torch.models.kp2dtiny import build_model, init_model
from nanovs_slam_torch.modules.backbone import stem_kernel_allowed
from nanovs_slam_torch.ops.kmeans import kmeans

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


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# ------------------------------------------------- the stem's predicate

@pytest.mark.parametrize("training,grad_mode,params_grad,x_grad,want", [
    (False, False, True, False, True),    # serving: no_grad
    (False, True, False, False, True),    # eval, nothing needs a gradient
    (False, True, True, False, False),    # VPR finetuning: eval under grad
    (False, True, False, True, False),    # a gradient to the input
    (True, False, True, False, False),    # train mode: BN's batch stats
], ids=["eval-no_grad", "eval-frozen", "eval-grad", "eval-x-grad", "train"])
def test_stem_kernel_allowed(training, grad_mode, params_grad, x_grad,
                             want):
    """The fused stem (no backward) may run only in eval mode with no
    gradient to flow through conv1a / conv1b: the VPR step, which
    differentiates an eval-mode forward, keeps the plain chain, so its
    stem gradients are never cut."""
    bb = build_model(get_config("N", n_classes=4)).backbone
    bb.train(training)
    for m in (bb.conv1a, bb.conv1b):
        for p in m.parameters():
            p.requires_grad_(params_grad)
    x = torch.zeros(1, 3, 8, 8, requires_grad=x_grad)
    with torch.set_grad_enabled(grad_mode):
        assert stem_kernel_allowed(bb, x) is want


def test_eval_mode_stem_gradients_reach_conv1():
    """An eval-mode forward under autograd gives conv1a and conv1b a
    gradient (on the CPU the chain is always plain; on the card the
    predicate above keeps it so)."""
    model = init_model(get_config("N", n_classes=4),
                       torch.Generator().manual_seed(0), "cpu")
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.uniform(-1, 1, (2, 3, 32, 32)).astype(
        np.float32))
    v = model(x, heads=("vlad",))["vlad"]
    (v * torch.from_numpy(rs.randn(*v.shape).astype(np.float32))).sum(
        ).backward()
    for name in ("conv1a", "conv1b"):
        g = getattr(model.backbone, name).conv.weight.grad
        assert g is not None and float(g.abs().sum()) > 0, name


# ------------------------------------------------------ depth extras

def _depth_inputs():
    rs = np.random.RandomState(3)
    pred = rs.uniform(0.05, 1.0, (2, 12, 16, 1)).astype(np.float32)
    gt = rs.uniform(0.05, 1.0, (2, 12, 16, 1)).astype(np.float32)
    gt[0, :3] = 0.0  # berhu's mask
    g2 = rs.randn(2, 40, 2).astype(np.float32)
    r2 = rs.randn(2, 40, 2).astype(np.float32)
    mask = rs.rand(2, 12, 16, 1) > 0.3
    return pred, gt, g2, r2, mask


def _extras_case(name):
    """(port function, JAX function, inputs) of a scalar of ``name``;
    the first input is the one differentiated."""
    pred, gt, g2, r2, mask = _depth_inputs()
    pos_gt = np.maximum(gt, 0.05)
    cases = {
        "jaccard_distance_loss": (lambda f, a, b: f(b, a).sum(), (pred, gt)),
        "rmse_log": (lambda f, a, b: f(a, b), (pred, pos_gt)),
        "l1": (lambda f, a, b: f(a, b), (pred, gt)),
        "l1_log": (lambda f, a, b: f(a, b), (pred, pos_gt)),
        "rmse": (lambda f, a, b: f(a, b), (pred, gt)),
        "berhu": (lambda f, a, b: f(a, b), (pred, gt)),
        "sobel_gradients": (lambda f, a: sum((t * t).sum() for t in f(a)),
                            (pred,)),
        "grad_loss": (lambda f, a, b, m: f(a, b, m), (pred, gt, mask)),
        "normal_loss": (lambda f, a, b: f(a, b), (g2, r2)),
    }
    wrap, inputs = cases[name]
    return (lambda *a: wrap(getattr(port_dx, name), *a),
            lambda *a: wrap(getattr(jax_dx, name), *a), inputs)


@pytest.mark.parametrize("name", [
    "jaccard_distance_loss", "rmse_log", "l1", "l1_log", "rmse", "berhu",
    "sobel_gradients", "grad_loss", "normal_loss"])
def test_depth_extras_match_jax(name):
    """Each function's value within 1e-5 relative and its gradient in the
    first input within 1e-5 of the gradient's largest magnitude (float32
    sums in another order)."""
    port_fn, jax_fn, inputs = _extras_case(name)
    t = [torch.from_numpy(np.asarray(a)) for a in inputs]
    t[0].requires_grad_()
    got = port_fn(*t)
    got.backward()
    got = got.detach()
    want, jgrad = jax.value_and_grad(jax_fn)(*[jnp.asarray(a)
                                               for a in inputs])
    want, jgrad = float(want), np.asarray(jgrad)
    assert abs(float(got) - want) <= 1e-5 * max(1.0, abs(want)), \
        (float(got), want)
    np.testing.assert_allclose(t[0].grad.numpy(), jgrad,
                               atol=1e-5 * max(1e-6, np.abs(jgrad).max()))


# ------------------------------------------------------------- k-means

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kmeans_inertia_matches_sklearn(seed):
    """L2-normalised descriptors of 16 seeded blobs (3,000 x 32), 32
    clusters, n_init 3: the port's k-means (k-means++ seeding from a
    RandomState, Lloyd) ends with an inertia no higher than sklearn's
    ``MiniBatchKMeans(n_init=3, random_state=seed)`` (the JAX package's
    call) and within 0.5% of sklearn's full-batch ``KMeans`` (measured:
    below MiniBatch's by 0.4-0.9%, within 0.2% of KMeans'). The centres
    differ: sklearn's draws are not the port's."""
    from sklearn.cluster import KMeans, MiniBatchKMeans

    rs = np.random.RandomState(seed)
    cen = rs.randn(16, 32) * 2
    x = (cen[rs.randint(16, size=3000)] + rs.randn(3000, 32))
    x = (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)
    centres, inertia = kmeans(torch.from_numpy(x), 32, seed=seed)
    assert centres.shape == (32, 32)
    d = ((x[:, None] - centres.numpy()[None]) ** 2).sum(-1).min(1).sum()
    assert abs(d - inertia) <= 1e-4 * d
    mb = MiniBatchKMeans(n_clusters=32, n_init=3,
                         random_state=seed).fit(x).cluster_centers_
    mb_inertia = ((x[:, None] - mb[None]) ** 2).sum(-1).min(1).sum()
    full = KMeans(n_clusters=32, n_init=3, random_state=seed).fit(x)
    assert inertia <= mb_inertia, (inertia, mb_inertia)
    assert inertia <= 1.005 * full.inertia_, (inertia, full.inertia_)


# --------------------------------------------------------------- mining

@pytest.fixture(scope="module")
def pitts(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pitts"))
    mat = _script("make_synthetic_pittsburgh").make_fixture(
        root, n_places=8, H=48, W=64)
    return root, mat


def test_triplet_mining_matches_jax(pitts):
    """The same descriptor cache (a seeded random one, close enough that
    negatives violate the margin) and seeds: every query's mined query,
    positive and negative images equal the JAX class's (sklearn's radius
    search there, scipy's here), over two passes (the negative caches
    grow), and so do the non-trivial positives and potential negatives."""
    root, mat = pitts
    want = jax_pitts.TripletMiningDataset(mat, root, (40, 56), n_neg=3,
                                          n_neg_sample=12, seed=5)
    got = port_pitts.TripletMiningDataset(mat, root, (40, 56), n_neg=3,
                                          n_neg_sample=12, seed=5)
    assert want.queries == got.queries and len(got) > 0
    for a, b in zip(want.nontrivial_positives, got.nontrivial_positives):
        assert np.array_equal(a, b)
    for a, b in zip(want.potential_negatives, got.potential_negatives):
        assert np.array_equal(a, b)
    n = want.dbStruct.numDb + want.dbStruct.numQ
    cache = np.random.RandomState(6).randn(n, 16).astype(np.float32) * 0.1
    want.cache, got.cache = cache, cache.copy()
    mined = 0
    for _ in range(2):
        for i in range(len(got)):
            w, g = want.mine(i), got.mine(i)
            assert (w is None) == (g is None), i
            if w is not None:
                mined += 1
                for a, b in zip(w, g):
                    assert np.array_equal(a, b), i
    assert mined > 0
    for a, b in zip(want.neg_cache, got.neg_cache):
        assert np.array_equal(a, b)
    assert np.array_equal(want.rng.get_state()[1], got.rng.get_state()[1])


def test_tokyo247_reads_the_struct_as_the_jax_package(pitts):
    """Tokyo 24/7's dbStruct through ``WholeDataset``: the same images
    and positives."""
    root, mat = pitts
    os.replace(mat, os.path.join(root, "datasets", "tokyo247.mat"))
    try:
        want = jax_extra.tokyo247_dataset(root, (40, 56))
        got = port_extra.tokyo247_dataset(root, (40, 56))
        assert len(got) == len(want)
        assert np.array_equal(got[3], want[3])
        for a, b in zip(want.get_positives(), got.get_positives()):
            assert sorted(a) == list(b)
    finally:
        os.replace(os.path.join(root, "datasets", "tokyo247.mat"), mat)


# ---------------------------------------------------- dataset readers

def test_scene_parse_lut_is_the_jax_packages():
    assert np.array_equal(port_extra.scene_parse_lut(),
                          jax_extra.scene_parse_lut())
    assert port_extra.SCENE_PARSE_CLASSES == jax_extra.SCENE_PARSE_CLASSES


def test_scene_parse_folder_reader_matches_jax(tmp_path):
    """An ADE20K-style folder (two images with annotations, one without):
    the same pairs and items (resized image, the LUT-mapped classes)."""
    import cv2

    rs = np.random.RandomState(0)
    for split in ("training",):
        (tmp_path / "images" / split).mkdir(parents=True)
        (tmp_path / "annotations" / split).mkdir(parents=True)
        for name in ("a", "b", "c"):
            cv2.imwrite(str(tmp_path / "images" / split / f"{name}.jpg"),
                        rs.randint(0, 255, (30, 44, 3), np.uint8))
            if name != "c":
                cv2.imwrite(str(tmp_path / "annotations" / split /
                                f"{name}.png"),
                            rs.randint(0, 151, (30, 44)).astype(np.uint8))
    want = jax_extra.SceneParse150Dataset(str(tmp_path), (24, 32))
    got = port_extra.SceneParse150Dataset(str(tmp_path), (24, 32))
    assert len(got) == len(want) == 2
    for i in range(2):
        for k in ("image", "seg"):
            assert np.array_equal(got[i][k], want[i][k]), (i, k)
    assert got[0]["seg"].max() <= 7


def _hf_sets():
    import datasets as hf

    H, W = 16, 24
    rs = np.random.RandomState(1)
    nyu = hf.Dataset.from_dict({
        "image": [rs.randint(0, 255, (H, W, 3), np.uint8).tolist()
                  for _ in range(3)],
        "depth_map": [(rs.rand(H, W) * 12).astype(np.float32).tolist()
                      for _ in range(3)]})
    ade = hf.Dataset.from_dict({
        "image": [rs.randint(0, 255, (H, W, 3), np.uint8).tolist()
                  for _ in range(2)],
        "annotation": [rs.randint(0, 151, (H, W)).astype(np.uint8).tolist()
                       for _ in range(2)]})
    return nyu, ade


@pytest.mark.parametrize("reader,kw", [
    ("NYUv2HFDataset", {"max_depth": 10.0}),
    ("SceneParse150HFDataset", {"n_classes": 7}),
    ("SceneParse150HFDataset", {"n_classes": 150})],
    ids=["nyuv2", "ade-lut", "ade-raw"])
def test_hf_readers_match_jax(reader, kw, tmp_path):
    """Each HF reader on an in-memory ``datasets.Dataset`` and on its
    ``save_to_disk`` copy gives the JAX reader's items; a source that is
    neither raises (the port never goes to the hub)."""
    nyu, ade = _hf_sets()
    ds = nyu if reader == "NYUv2HFDataset" else ade
    size = (12, 20)
    want = getattr(jax_extra, reader)(ds, size, **kw)
    got = getattr(port_extra, reader)(ds, size, **kw)
    ds.save_to_disk(str(tmp_path / "validation"))
    disk = getattr(port_extra, reader)(str(tmp_path), size,
                                       split="validation", **kw)
    assert len(got) == len(want) == len(disk)
    for i in range(len(want)):
        for k, v in want[i].items():
            assert np.array_equal(got[i][k], v), (i, k)
            assert np.array_equal(disk[i][k], v), (i, k)
    with pytest.raises(FileNotFoundError, match="hub"):
        getattr(port_extra, reader)(str(tmp_path), size, split="train",
                                    **kw)
