"""The port's evaluation CLI (``python -m nanovs_slam_torch.eval_multitask``)
on the CPU against the root CLI (the JAX package's): pinned S8 at 96x128
on fixtures the repo's scripts write (the synthetic HPatches and
Pittsburgh sets), the results JSON key by key; the flags it refuses,
each naming its ROADMAP item; the entries of tasks without data; and the
trainer's flags that the evaluation brought in."""

import json
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PINNED = os.path.join(REPO, "pinned", "extractor_S8.npz")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads for this file's torch work (the suite runs
    files in parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _fixtures(tmp_path) -> str:
    """A datasets.json naming a 1-sequence synthetic HPatches set (5
    pairs) and an 8-place synthetic Pittsburgh set (24 db, 16 queries),
    both written by the repo's scripts."""
    hp = tmp_path / "hpatches"
    script = os.path.join(REPO, "scripts", "make_synthetic_hpatches.py")
    subprocess.run([sys.executable, script, str(hp), "--n-seq", "1"],
                   check=True, capture_output=True)
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        from make_synthetic_pittsburgh import make_fixture
    finally:
        sys.path.pop(0)
    make_fixture(str(tmp_path / "pitts"), n_places=8, H=96, W=128)
    cfg = tmp_path / "datasets.json"
    cfg.write_text(json.dumps({"hpatches_data_path": str(hp),
                               "pittsburgh_data_path":
                               str(tmp_path / "pitts")}))
    return str(cfg)


ARGS = ["--model_path", PINNED, "--config", "S", "--n_classes", "8",
        "--im_h", "96", "--im_w", "128", "--keypoints", "--visloc",
        "--max_items", "4", "--top_k", "50"]


def _assert_results_match(got, want):
    """Two results JSONs of ``ARGS``: the same keys; repeatability,
    localisation error, matching score and the AUCs within 1e-4,
    correctness equal; Recall, AUC and MatchRatio of the retrieval
    equal; no error entry."""
    assert got.keys() == want.keys() == {"keypoints_top50", "visloc"}
    kp_w, kp_g = want["keypoints_top50"], got["keypoints_top50"]
    assert kp_g.keys() == kp_w.keys() and "error" not in kp_w
    for k in ("repeatability", "localization_error", "mscore"):
        assert abs(kp_g[k] - kp_w[k]) <= 1e-4, (k, kp_g[k], kp_w[k])
    for k in ("correctness1", "correctness3", "correctness5"):
        assert kp_g[k] == kp_w[k], k
    for t, v in kp_w["homography_auc"].items():
        assert abs(kp_g["homography_auc"][t] - v) <= 1e-4, t
    assert "error" not in want["visloc"]
    assert got["visloc"] == want["visloc"]


def _port_cli(tmp_path, cfg) -> dict:
    from nanovs_slam_torch import eval_multitask

    out = tmp_path / "port.json"
    eval_multitask.main(ARGS + ["--dataset_config", cfg, "--device", "cpu",
                                "--out", str(out)])
    return json.loads(out.read_text())


@pytest.mark.slow
def test_cli_matches_the_root_cli(tmp_path):
    """The port's CLI against the root CLI's JSON on the same fixtures.
    Slow (~47 s alone): the root CLI draws flax's initial variables before
    it loads the checkpoint (~25 s here); the tier-1 twin below computes
    what the root CLI computes without that."""
    cfg = _fixtures(tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, os.path.join(REPO,
                                                     "eval_multitask.py")]
                       + ARGS + ["--dataset_config", cfg, "--out",
                                 str(tmp_path / "jax.json")],
                       cwd=tmp_path, env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    _assert_results_match(_port_cli(tmp_path, cfg),
                          json.loads((tmp_path / "jax.json").read_text()))


def test_cli_matches_the_jax_evaluators(tmp_path):
    """The port's CLI against the root CLI's computation done in this
    process: the JAX infer of pinned S8 and the JAX package's readers and
    evaluators over the same fixtures (the root CLI's keypoint and visloc
    branches), their results through JSON as the CLI writes them."""
    import jax.numpy as jnp
    import numpy as np

    from nanovs_slam_tpu.configs import get_config
    from nanovs_slam_tpu.data.hpatches import HPatchesDataset
    from nanovs_slam_tpu.data.pittsburgh import WholeDataset
    from nanovs_slam_tpu.evaluation.global_descriptor import \
        evaluate_global_descriptor
    from nanovs_slam_tpu.evaluation.keypoints import evaluate_keypoint_net
    from nanovs_slam_tpu.inference import make_infer_fn
    from nanovs_slam_tpu.models.kp2dtiny import build_model
    from nanovs_slam_tpu.utils.checkpoint import load_npz_checkpoint

    cfg_path = _fixtures(tmp_path)
    got = _port_cli(tmp_path, cfg_path)

    tree, _ = load_npz_checkpoint(PINNED)
    variables = {"params": tree["params"],
                 "batch_stats": tree["batch_stats"]}
    cfg = get_config("S", n_classes=8)
    infer = make_infer_fn(build_model(cfg), cfg, 96, 128)

    def infer_np(images):
        out = infer(variables, jnp.asarray(images, jnp.float32))
        return {k: np.asarray(v) for k, v in out.items()}

    items = list(HPatchesDataset(str(tmp_path / "hpatches"), (128, 96)))[:4]
    want = {"keypoints_top50": evaluate_keypoint_net(
        items, infer_np, output_shape=(128, 96), top_k=50)}
    root = str(tmp_path / "pitts")
    ds = WholeDataset(os.path.join(root, "datasets", "pitts30k_train.mat"),
                      root, (96, 128))
    feats = np.stack([infer_np(ds[i][None])["vlad"][0]
                      for i in range(len(ds))])
    want["visloc"] = evaluate_global_descriptor(
        feats[: ds.dbStruct.numDb], feats[ds.dbStruct.numDb:],
        ds.get_positives())
    _assert_results_match(got, json.loads(json.dumps(want, default=str)))


@pytest.mark.parametrize("flags,item", [
    (["--int8"], "item 6"), (["--int8_weight_only"], "item 6"),
    (["--model_type", "KeypointFormer"], "item 7"),
    (["--model_path", "model.ckpt"], "item 7"), (["--wandb"], "item 7")])
def test_cli_refuses_deferred_flags(flags, item):
    """Each flag whose module the port lacks exits, naming its ROADMAP
    item."""
    from nanovs_slam_torch import eval_multitask

    with pytest.raises(SystemExit, match=item):
        eval_multitask.main(flags + ["--device", "cpu"])


def test_cli_tasks_without_data_store_the_root_clis_errors(tmp_path):
    """No dataset configured: segmentation, depth, visloc and VO store the
    root CLI's error entries; --use_pallas and --bf16 are accepted."""
    from nanovs_slam_torch import eval_multitask

    out = tmp_path / "r.json"
    res = eval_multitask.main(
        ["--config", "N", "--im_h", "48", "--im_w", "64", "--segmentation",
         "--depth", "--visloc", "--vo", "--use_pallas", "--bf16",
         "--device", "cpu", "--dataset_config", str(tmp_path / "none.json"),
         "--out", str(out)])
    assert res == json.loads(out.read_text()) == {
        "segmentation": {"error": "dataset missing"},
        "depth": {"error": "nyuv2_data_path missing"},
        "visloc": {"error": "pittsburgh_data_path missing"},
        "vo": {"error": "kitti_data_path missing"}}


def test_trainer_runs_its_evaluation_and_debug(tmp_path, monkeypatch):
    """The trainer's CLI without --no_eval and with --debug (config N,
    48x64 data of the synthetic fallback, one epoch of 1 step, the full
    evaluation on 3 items, VO on a 3-frame synthetic KITTI sequence): the
    checkpoint's results hold numbers for every task, the log its val/
    line, and the debug pictures are written."""
    from nanovs_slam_torch import train_multitask

    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        from make_synthetic_kitti import make_sequence
    finally:
        sys.path.pop(0)
    make_sequence(str(tmp_path / "kitti"), 3)
    (tmp_path / "datasets.json").write_text(
        json.dumps({"kitti_data_path": str(tmp_path / "kitti")}))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(train_multitask, "SYNTHETIC_CONFIG", dict(
        train_multitask.SYNTHETIC_CONFIG, im_h=48, im_w=64))
    train_multitask.main(
        ["--device", "cpu", "--dataset_name", "synthetic", "--config", "N",
         "--batch_size", "2", "--synthetic_items", "2", "--n_epochs", "1",
         "--max_steps_per_epoch", "1", "--full_eval", "1",
         "--max_eval_items", "3", "--top_k", "50", "--debug",
         "--lr_scheduler", "plateau", "--out_model_path",
         str(tmp_path / "ck")])
    from nanovs_slam_torch.utils.checkpoint import load_npz_checkpoint

    _, meta = load_npz_checkpoint(str(tmp_path / "ck.npz"))
    res = meta["results"]
    assert set(res) == {"segmentation", "keypoints", "visloc", "vo"}, res
    assert all("error" not in r for r in res.values()), res
    rows = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert any("val/segmentation/IoU" in r for r in rows)
    assert os.path.exists(tmp_path / "ck_media" / "debug_pair_e0.png")
