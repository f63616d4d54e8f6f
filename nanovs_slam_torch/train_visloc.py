"""VPR (visual place recognition) finetuning CLI of the port, the
counterpart of the root ``train_visloc.py``, with its flags and defaults:

    python -m nanovs_slam_torch.train_visloc [--device cuda] [--config S]
        [--model_type KP2DtinyV2] [--n_classes 28] [--model_path CK.npz]
        [--out_model_path visloc_ckpt] [--dataset_config datasets.json]
        [--lr 1e-5] [--n_epochs 5] [--margin 0.1] [--n_neg 10]
        [--im_h 240] [--im_w 320] [--freeze_backbone]
        [--cluster_samples 50000] [--cluster_images 500]
        [--max_queries N] [--seed 0] [--pittsburgh_path DIR] [--synthetic]
        [--eval_recall] [--recall_out FILE]

It runs on ``--device`` (default cuda; ``--device cpu`` where there is no
card). The loop is the JAX CLI's:
- NetVLAD's cluster init: dense encoder descriptors sampled from
  ``--cluster_images`` images (the same ``RandomState`` draws), k-means on
  the device (``ops/kmeans.py``: not sklearn's ``MiniBatchKMeans``, which
  the card's machine lacks), then ``NetVLAD.init_params_from_clusters``;
- each epoch: the descriptors of the whole set under ``no_grad`` (the
  stem, NetVLAD kernels on the card), hard-negative mining against them
  (``data/pittsburgh.TripletMiningDataset``), then one Adam step a mined
  query on the triplet loss (``triplet_margin_loss``: margin
  sqrt(``--margin``), summed over the negatives) with the model in eval
  mode, as the JAX step differentiates ``apply(..., False)`` (BN's running
  statistics, no dropout; the stem then runs unfused, since its kernel has
  no backward). ``--freeze_backbone`` zeroes the backbone's gradients.
``--eval_recall`` prints Recall@1/5 from each epoch's cache (and the
final model's) and ``--recall_out`` writes the curve as JSON. The
checkpoint is ``<out_model_path>.npz`` with the model's ``params`` and
``batch_stats``, which the JAX ``load_checkpoint`` reads. ``--model_path``
takes such an ``.npz`` or a reference PyTorch ``.ckpt``
(``utils/torch_import.load_model_weights``).
Without a dataset, ``--synthetic`` writes and trains on the seeded
Pittsburgh-format fixture (``scripts/make_synthetic_pittsburgh.py``, cv2).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE_BATCH = 16  # images a forward of the descriptor cache


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="VPR finetune (PyTorch port)")
    p.add_argument("--config", default="S")
    p.add_argument("--model_type", default="KP2DtinyV2")
    p.add_argument("--n_classes", type=int, default=28)
    p.add_argument("--model_path", default=None)
    p.add_argument("--out_model_path", default="visloc_ckpt")
    p.add_argument("--dataset_config", default="datasets.json")
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--n_epochs", type=int, default=5)
    p.add_argument("--margin", type=float, default=0.1)
    p.add_argument("--n_neg", type=int, default=10)
    p.add_argument("--im_h", type=int, default=240)
    p.add_argument("--im_w", type=int, default=320)
    p.add_argument("--freeze_backbone", action="store_true")
    p.add_argument("--cluster_samples", type=int, default=50000)
    p.add_argument("--cluster_images", type=int, default=500)
    p.add_argument("--max_queries", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--pittsburgh_path", default=None,
                   help="dataset root override (else datasets.json)")
    p.add_argument("--synthetic", action="store_true",
                   help="fall back to the seeded Pittsburgh-format fixture "
                        "when no real dataset is configured")
    p.add_argument("--eval_recall", action="store_true",
                   help="report Recall@1/5 from each epoch's descriptor "
                        "cache (init + per epoch) and save the curve to "
                        "--recall_out")
    p.add_argument("--recall_out", default=None,
                   help="JSON artifact path for the recall curve")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def check_supported(args) -> None:
    """Exit for a ``--model_path`` directory (the port reads files)."""
    path = args.model_path
    if path and os.path.isdir(path):
        raise SystemExit(f"--model_path {path}: the port reads .npz or "
                         "torch checkpoint files, not checkpoint "
                         "directories")


def _nchw(images: np.ndarray, dev) -> torch.Tensor:
    """(B, H, W, 3) numpy in [-1, 1] -> (B, 3, H, W) float32 on ``dev``."""
    return torch.from_numpy(np.ascontiguousarray(images)).to(dev).permute(
        0, 3, 1, 2)


def vlad_of(model, x: torch.Tensor) -> torch.Tensor:
    """The global descriptors (B, D) of NCHW images: only the vlad head
    where the model can skip the others (V2)."""
    from .models.kp2dtiny import KP2DTinyV2

    if isinstance(model, KP2DTinyV2):
        return model(x, heads=("vlad",))["vlad"]
    return model(x)["vlad"]


@torch.no_grad()
def get_clusters(model, dataset, cfg, n_images: int, n_samples: int,
                 seed: int = 0):
    """(centroids (K, C), the sampled descriptors (M, C)), numpy float32:
    dense encoder descriptors of ``n_images`` images chosen by
    ``RandomState(seed)``, ceil(n_samples / n_images) pixels an image by
    the same generator (the JAX CLI's draws), k-means'd on the model's
    device (``ops/kmeans.kmeans``, the best of 3, seeded with ``seed``)."""
    from .ops.kmeans import kmeans

    dev = next(model.parameters()).device
    rs = np.random.RandomState(seed)
    per_image = int(np.ceil(n_samples / n_images))
    idxs = rs.choice(len(dataset), min(n_images, len(dataset)),
                     replace=False)
    descs = []
    for i in idxs:
        d = model(_nchw(dataset[int(i)][None], dev), only_encoder=True)
        d = d.float().permute(0, 2, 3, 1).reshape(-1, d.shape[1])
        sel = rs.choice(len(d), min(per_image, len(d)), replace=False)
        descs.append(d[torch.as_tensor(sel, device=dev)])
    descs = torch.cat(descs)[:n_samples]
    centres, _ = kmeans(descs, cfg.num_clusters, seed=seed)
    return (centres.cpu().numpy().astype(np.float32),
            descs.cpu().numpy().astype(np.float32))


def init_netvlad(model, clsts: np.ndarray, descs: np.ndarray) -> None:
    """NetVLAD's assignment weights and centroids from k-means clusters
    (vladv1), in place."""
    from .modules.aggregators import NetVLAD

    assign_w, centroids = NetVLAD.init_params_from_clusters(clsts, descs)
    nv = model.vlad_head.netvlad
    with torch.no_grad():
        nv.assign_w.copy_(torch.from_numpy(assign_w))
        nv.centroids.copy_(torch.from_numpy(centroids))


def triplet_margin_loss(q: torch.Tensor, pos: torch.Tensor,
                        neg: torch.Tensor, margin: float) -> torch.Tensor:
    """torch ``TripletMarginLoss(margin, reduction="sum")`` of one query
    (1, D) and positive (1, D) against each negative (n, D), as the JAX
    CLI computes it (the distances with its 1e-6)."""
    d_pos = torch.linalg.norm(q - pos + 1e-6, dim=-1)
    d_neg = torch.linalg.norm(q - neg + 1e-6, dim=-1)
    return torch.sum(torch.clamp(d_pos - d_neg + margin, min=0.0))


def make_vpr_step(model, optimizer: torch.optim.Optimizer, margin: float,
                  freeze_backbone: bool = False):
    """step(q_img, pos_img, neg_imgs) -> the loss (a 0-d device tensor):
    one Adam step on the triplet loss of a mined triplet (numpy (H, W, 3),
    (H, W, 3), (n, H, W, 3) in [-1, 1]), the model in eval mode (the JAX
    step's ``apply(..., False)``), margin sqrt(``margin``). The raw
    gradients stay in the parameters' ``.grad`` (the backbone's zeroed
    under ``freeze_backbone``)."""
    dev = next(model.parameters()).device
    m = margin ** 0.5

    def step(q_img, pos_img, neg_imgs):
        model.eval()
        x = _nchw(np.concatenate([q_img[None], pos_img[None], neg_imgs]),
                  dev)
        optimizer.zero_grad(set_to_none=True)
        v = vlad_of(model, x)
        loss = triplet_margin_loss(v[0:1], v[1:2], v[2:], m)
        loss.backward()
        if freeze_backbone:
            for p in model.backbone.parameters():
                p.grad = torch.zeros_like(p)
        optimizer.step()
        return loss.detach()

    return step


@torch.no_grad()
def build_cache(model, dataset) -> np.ndarray:
    """The global descriptors (N, D) float32 of every image of
    ``dataset``, the model in eval mode, CACHE_BATCH images a forward."""
    dev = next(model.parameters()).device
    model.eval()
    feats = []
    for s in range(0, len(dataset), CACHE_BATCH):
        imgs = np.stack([dataset[i] for i in range(
            s, min(s + CACHE_BATCH, len(dataset)))])
        feats.append(vlad_of(model, _nchw(imgs, dev)).float().cpu().numpy())
    return np.concatenate(feats)


def _dataset_root(args):
    """The Pittsburgh root and its train struct: ``--pittsburgh_path``,
    else datasets.json, else (``--synthetic``) the seeded fixture; None
    where there is none."""
    from .data.datasets import load_datasets_json

    paths = load_datasets_json(args.dataset_config)
    root = args.pittsburgh_path or paths.get("pittsburgh_data_path")
    struct = os.path.join(root or "", "datasets", "pitts30k_train.mat")
    if root and os.path.exists(struct):
        return root, struct
    if not args.synthetic:
        return None
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_synthetic_pittsburgh",
        os.path.join(_REPO, "scripts", "make_synthetic_pittsburgh.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    root = script.ensure_synthetic_pittsburgh()
    return root, os.path.join(root, "datasets", "pitts30k_train.mat")


def main(argv=None) -> int:
    args = parse_args(argv)
    check_supported(args)
    from .configs import get_config
    from .data.pittsburgh import TripletMiningDataset, WholeDataset
    from .evaluation.global_descriptor import evaluate_global_descriptor
    from .models.kp2dtiny import init_model
    from .utils.checkpoint import save_model_checkpoint
    from .utils.device import resolve_device
    from .utils.torch_import import load_model_weights

    dev = resolve_device(args.device)
    H, W = args.im_h, args.im_w
    v3 = args.model_type in ("KP2DtinyV3", "DF")
    cfg = get_config(args.config, v3=v3, n_classes=args.n_classes)
    model = init_model(cfg, torch.Generator().manual_seed(args.seed), "cpu")
    if args.model_path:
        load_model_weights(model, args.model_path)
    model = model.to(dev).eval()

    found = _dataset_root(args)
    if found is None:
        print("pittsburgh_data_path missing — nothing to train on "
              "(pass --synthetic for the seeded fixture)")
        return 1
    root, train_struct = found
    whole = WholeDataset(train_struct, root, (H, W))
    miner = TripletMiningDataset(train_struct, root, (H, W),
                                 n_neg=args.n_neg, margin=args.margin,
                                 seed=args.seed)

    t0 = time.perf_counter()
    clsts, descs = get_clusters(model, whole, cfg, args.cluster_images,
                                args.cluster_samples, args.seed)
    init_netvlad(model, clsts, descs)
    print(f"NetVLAD initialized from k-means clusters "
          f"({time.perf_counter() - t0:.1f} s)")

    optimizer = torch.optim.Adam(model.parameters(), lr=args.lr,
                                 betas=(0.9, 0.999), eps=1e-8)
    step = make_vpr_step(model, optimizer, args.margin,
                         args.freeze_backbone)
    recall_curve = []

    def eval_recall(cache, tag):
        """Recall@1/5 from the epoch's cache: the db block against the
        query block (no extra forwards)."""
        n_db = whole.dbStruct.numDb
        r = evaluate_global_descriptor(
            torch.from_numpy(cache[:n_db]).to(dev),
            torch.from_numpy(cache[n_db:]).to(dev), whole.get_positives(),
            n_values=(1, 5))
        row = {"tag": tag, "recall@1": r["Recall"][1],
               "recall@5": r["Recall"][5], "auc@5": r["AUC"][5]}
        recall_curve.append(row)
        print(f"[recall] {tag}: R@1={row['recall@1']:.3f} "
              f"R@5={row['recall@5']:.3f} AUC@5={row['auc@5']:.3f}")

    for epoch in range(args.n_epochs):
        t0 = time.perf_counter()
        miner.cache = build_cache(model, whole)
        cache_s = time.perf_counter() - t0
        if args.eval_recall:
            eval_recall(miner.cache,
                        "init" if epoch == 0 else f"epoch{epoch - 1}")
        n_q = min(len(miner), args.max_queries or len(miner))
        total, used = 0.0, 0
        t0 = time.perf_counter()
        for qi in range(n_q):
            mined = miner.mine(qi)
            if mined is None:
                continue
            total += float(step(*mined))
            used += 1
        print(f"epoch {epoch}: {used}/{n_q} queries, "
              f"mean loss {total / max(used, 1):.4f} (cache "
              f"{1e3 * cache_s / len(whole):.2f} ms an image, steps "
              f"{time.perf_counter() - t0:.1f} s)", flush=True)
        save_model_checkpoint(args.out_model_path, model, config=vars(args),
                              epoch=epoch + 1)
    if args.eval_recall:
        eval_recall(build_cache(model, whole), "final")
        if args.recall_out:
            with open(args.recall_out, "w") as f:
                json.dump({"args": vars(args), "recall_curve": recall_curve},
                          f, indent=2)
            print(f"recall curve -> {args.recall_out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
