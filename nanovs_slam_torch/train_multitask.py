"""Multitask training CLI of the port, the counterpart of the JAX
package's ``train_multitask.py``, with its flags and defaults:

    python -m nanovs_slam_torch.train_multitask [--device cuda]
        [--config S] [--model_type KP2DtinyV2|KP2DtinyV3|KeypointFormer]
        [--dataset_name cocostuff|cityscapes|synthetic] [--batch_size 4]
        [--lr ...] [--n_epochs ...] [--seed 42069] [--model_path CK.npz]
        [--out_model_path model_ckpt] [--top_k 300] [--depth]
        [--freeze_backbone] [--ignore_seg_head] [--only_segmentation]
        [--only_keypoints] [--no_vpr] [--loss_schedule default]
        [--max_steps_per_epoch N] [--synthetic_items 64] [--log_every N]
        [--ckpt_every N] [--lr_scheduler none|step|cosine|plateau]
        [--watch_gradients] [--no_eval] [--eval_every 1] [--full_eval 3]
        [--max_eval_items 16] [--debug] [--bf16] [--device_cache]
        [--scan_epoch] [--qat] [--to_mcu] [--num_devices N]
        [--coordinator_address HOST:PORT --num_processes P --process_id I]
        [--dist_timeout 1800]

It runs on ``--device`` (default cuda; a machine without a card needs
``--device cpu``). Without the dataset named in datasets.json it trains
on ``SyntheticShapesDataset``, as the JAX trainer falls back. Checkpoints
are ``<out_model_path>.npz`` files in the format the JAX
``load_checkpoint`` reads (``utils/checkpoint.save_checkpoint``); metrics
go to ``metrics.jsonl``. Unless ``--no_eval``, ``evaluate_model`` runs
every ``--eval_every`` epoch on the model's device, as the JAX trainer's
does: segmentation (and depth) each time, keypoints, retrieval and VO
every ``--full_eval`` epoch, on synthetic pairs where the datasets are
absent; its results go to the log, the plateau controller and the
checkpoint. ``--debug`` writes its pictures beside the checkpoint (cv2).
``--bf16`` builds the model at ``dtype="bfloat16"`` as the JAX trainer
does (flax semantics: float32 parameters, BN statistics and Adam state,
bf16 compute, no loss scaling). ``--device_cache`` uploads the train set
to the card once (``data/device_cache.DeviceCachedPairLoader``: no host
equalize or blur, as in the JAX loader) and runs each epoch through
``train/scan_epoch.make_epoch_fn``: each batch built on the card, the
epoch's indices and homographies uploaded once, the metrics read once at
its end and logged at the ``--log_every`` steps. ``--scan_epoch`` is
the JAX CLI's name for that loop: it is accepted, and still requires
``--device_cache``.
``--model_type KeypointFormer`` trains ``models/keypoint_former.py`` at
``--config`` where it names one of its configs, else "tiny" (the JAX
trainer's rule), with the same losses and step; it needs a frame size
whose sides give ceil(side / 4) divisible by 8 (the synthetic 96x128
does; the COCO / Cityscapes 120x160 fails here as in the JAX trainer).
``--freeze_backbone`` freezes nothing there: the JAX optimizer's mask
freezes a top-level ``backbone``, which KeypointFormer's tree lacks.
``--qat`` trains with int8 fake-quantised kernels (``quant.qat_params``,
a straight-through gradient; the inlier net stays float), and ``--to_mcu``
trains the MCU export variant (convtranspose upsample, plain ReLU), whose
checkpoint ``python -m nanovs_slam_torch.export_model --to_mcu --format
mcu`` bundles. ``--wandb`` raises: wandb is not installed.

Data parallel (``parallel/data_parallel.py``): ``--num_devices N`` trains
on N ranks in all, each a process of its own (start method "spawn") with
one device; the step is the single-device step on the global batch
``--batch_size``. On one host the ranks take the cards in turn, and where
there are fewer cards than ranks they share them over gloo (the run says
so on its first line). ``--coordinator_address``, ``--num_processes`` and
``--process_id`` join P hosts (processes of this CLI), each spawning N / P
ranks (default N = P). Each host's loader is seeded with seed + 1000 *
process_id, as the JAX CLI seeds its processes, loads the host's share of
the global batch, and each rank takes its rows of it. Rank 0 alone
prints, writes ``metrics.jsonl``, evaluates and saves checkpoints.
``--device_cache`` runs the epoch through ``shard_epoch_inputs`` on one
host and exits with more than one process, as the JAX CLI does. A
collective that waits ``--dist_timeout`` seconds raises. Started by a
launcher (torchrun, SLURM or Open MPI) without these flags, every process
of the launch is one rank of its group, on the card of its local rank
(``parallel.distributed.initialize`` reads the layout and, from
MASTER_ADDR / MASTER_PORT, the address; NCCL on cards, so each process
needs a card of its own).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time

import numpy as np
import torch

COCOSTUFF_CONFIG = dict(lr=0.0005, n_classes=28, im_h=120, im_w=160,
                        n_epochs=20, optimizer="adam", lr_scheduler="cosine",
                        freeze_backbone=False)
CITYSCAPES_CONFIG = dict(lr=0.001, n_classes=19, im_h=120, im_w=160,
                         n_epochs=20, optimizer="adam", lr_scheduler="cosine",
                         freeze_backbone=True)
SYNTHETIC_CONFIG = dict(lr=0.0005, n_classes=8, im_h=96, im_w=128,
                        n_epochs=2, optimizer="adam", lr_scheduler="cosine",
                        freeze_backbone=False)

# flag -> why it raises
DEFERRED = {
    "wandb": "the port logs to metrics.jsonl only (wandb is not installed)",
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train KP2DTiny multitask "
                                "(PyTorch port)")
    p.add_argument("--config", default="S", help="model config name")
    p.add_argument("--model_type", default="KP2DtinyV2",
                   choices=["KP2DtinyV2", "KP2DtinyV3", "DD", "DF",
                            "KeypointFormer"])
    p.add_argument("--dataset_name", default="cocostuff",
                   choices=["cocostuff", "cityscapes", "synthetic"])
    p.add_argument("--dataset_config", default="datasets.json")
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--num_devices", type=int, default=None)
    p.add_argument("--coordinator_address", default=None)
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--n_epochs", type=int, default=None)
    p.add_argument("--seed", type=int, default=42069)
    p.add_argument("--model_path", default=None, help="checkpoint to resume")
    p.add_argument("--out_model_path", default="model_ckpt")
    p.add_argument("--start_epoch", type=int, default=0)
    p.add_argument("--top_k", type=int, default=300)
    p.add_argument("--depth", action="store_true")
    p.add_argument("--to_mcu", action="store_true")
    p.add_argument("--freeze_backbone", action="store_true")
    p.add_argument("--ignore_seg_head", action="store_true",
                   help="drop final seg conv on restore (class change)")
    p.add_argument("--only_segmentation", action="store_true")
    p.add_argument("--only_keypoints", action="store_true")
    p.add_argument("--no_vpr", action="store_true")
    p.add_argument("--loss_schedule", default="default",
                   choices=["default", "refined", "D", "none"])
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute, float32 parameters")
    p.add_argument("--qat", action="store_true",
                   help="int8 fake-quant QAT (straight-through estimator)")
    p.add_argument("--wandb", action="store_true")
    p.add_argument("--watch_gradients", action="store_true",
                   help="log per-module gradient norms")
    p.add_argument("--max_steps_per_epoch", type=int, default=None)
    p.add_argument("--eval_every", type=int, default=1)
    p.add_argument("--max_eval_items", type=int, default=16)
    p.add_argument("--synthetic_items", type=int, default=64,
                   help="synthetic train set size (synthetic dataset only)")
    p.add_argument("--log_every", type=int, default=None,
                   help="loss-fetch cadence in steps (default: 10x/epoch; "
                        "each fetch waits for the device)")
    p.add_argument("--device_cache", action="store_true",
                   help="upload the train set to the card once and build "
                        "batches there (no host blur / equalize)")
    p.add_argument("--scan_epoch", action="store_true",
                   help="the JAX CLI's epoch loop; --device_cache already "
                        "runs it here (requires --device_cache)")
    p.add_argument("--ckpt_every", type=int, default=None,
                   help="checkpoint cadence in epochs (default: "
                        "--eval_every, n_epochs/15 under --no_eval)")
    p.add_argument("--full_eval", type=int, default=3,
                   help="full keypoint/VPR/VO evaluation every n epochs")
    p.add_argument("--lr_scheduler", default=None,
                   choices=["none", "step", "cosine", "plateau"],
                   help="override the dataset config's LR scheduler")
    p.add_argument("--no_eval", action="store_true")
    p.add_argument("--debug", action="store_true",
                   help="save per-eval-epoch prediction visualizations "
                        "(training-pair keypoint overlays, seg panels) to "
                        "<out_model_path>_media/ (needs cv2)")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    p.add_argument("--dist_timeout", type=float, default=1800.0,
                   help="seconds a collective waits before it raises")
    return p.parse_args(argv)


def check_supported(args) -> None:
    """Raise for every flag whose module the port does not have yet."""
    for flag, why in DEFERRED.items():
        if getattr(args, flag) not in (None, False):
            raise SystemExit(f"--{flag}: not in the port yet; {why}")
    if args.scan_epoch and not args.device_cache:
        raise SystemExit("--scan_epoch assembles batches from the HBM "
                         "dataset cache; it requires --device_cache")
    ranks, procs = parallel_layout(args)
    if args.device_cache and procs > 1:
        raise SystemExit("--device_cache assembles batches on the local "
                         "device set and is single-process only; drop it "
                         "for multi-host runs")
    if args.batch_size % ranks:
        raise SystemExit(f"--batch_size {args.batch_size} does not split "
                         f"over {ranks} ranks")


def parallel_layout(args):
    """(ranks in all, processes): ``--num_devices`` (default: one rank a
    process) over ``--num_processes`` (default 1); the ranks must split
    evenly over the processes."""
    procs = args.num_processes or 1
    ranks = args.num_devices or procs
    if ranks % procs:
        raise SystemExit(f"--num_devices {ranks} does not split over "
                         f"{procs} processes")
    if procs > 1 and (args.coordinator_address is None
                      or args.process_id is None):
        raise SystemExit("--num_processes > 1 needs --coordinator_address "
                         "and --process_id")
    return ranks, procs


def launched(args) -> bool:
    """Whether a launcher (torchrun, SLURM, Open MPI) started this process
    as one rank of its group and the flags give no layout of their own."""
    from nanovs_slam_torch.parallel.distributed import _pod_env

    return _pod_env() is not None and args.num_devices is None \
        and args.num_processes is None and args.process_id is None


def build_config(args, n_classes: int):
    """(cfg, its ``init_model``) for ``--model_type`` and ``--config``: a
    KeypointFormer config where the model type says so (``--config`` if it
    names one, else "tiny", as the JAX trainer chooses), else KP2DTiny's;
    both at bfloat16 with ``--bf16``."""
    import dataclasses

    dtype = "bfloat16" if args.bf16 else "float32"
    if args.model_type == "KeypointFormer":
        from nanovs_slam_torch.models.keypoint_former import (
            KEYPOINTFORMER_CONFIGS, init_model)

        name = args.config if args.config in KEYPOINTFORMER_CONFIGS \
            else "tiny"
        return dataclasses.replace(KEYPOINTFORMER_CONFIGS[name],
                                   n_classes=n_classes, dtype=dtype), \
            init_model
    from nanovs_slam_torch.configs import get_config
    from nanovs_slam_torch.models.kp2dtiny import init_model

    v3 = args.model_type in ("KP2DtinyV3", "DF")
    return get_config(args.config, v3=v3, n_classes=n_classes,
                      to_mcu=getattr(args, "to_mcu", False),
                      depth=args.depth, dtype=dtype), init_model


def get_dataset(args, train_config, size):
    """(train, validation) datasets, as the JAX trainer's: the named
    dataset where datasets.json gives its path, else the synthetic
    fallback (the validation set 16 items of another seed)."""
    from nanovs_slam_torch.data.datasets import (COCOStuffDataset,
                                                 CityscapesDataset,
                                                 SyntheticShapesDataset,
                                                 load_datasets_json)

    paths = load_datasets_json(args.dataset_config)
    n_classes = train_config["n_classes"]
    if args.dataset_name == "cocostuff":
        root = paths.get("coco_data_path")
        if root and os.path.isdir(root):
            return (COCOStuffDataset(root, size, "train", n_classes,
                                     args.depth),
                    COCOStuffDataset(root, size, "val", n_classes,
                                     args.depth))
        print("WARNING: coco_data_path missing; falling back to synthetic")
    if args.dataset_name == "cityscapes":
        root = paths.get("cityscapes_data_path")
        if root and os.path.isdir(root):
            return (CityscapesDataset(root, size, "train"),
                    CityscapesDataset(root, size, "val"))
        print("WARNING: cityscapes_data_path missing; using synthetic")
    return (SyntheticShapesDataset(size, args.synthetic_items, n_classes,
                                   seed=0, with_depth=args.depth),
            SyntheticShapesDataset(size, 16, n_classes, seed=1,
                                   with_depth=args.depth))


def plateau_metric(results, losses) -> float:
    """Quality metric for the plateau controller (mode=max): val seg IoU,
    else keypoint repeatability, else -mean train loss."""
    seg = results.get("segmentation", {}) if results else {}
    if isinstance(seg, dict) and isinstance(seg.get("IoU"), (int, float)):
        return float(seg["IoU"])
    kp = results.get("keypoints", {}) if results else {}
    if isinstance(kp, dict) and isinstance(kp.get("repeatability"),
                                           (int, float)):
        return float(kp["repeatability"])
    return -float(np.mean(losses)) if losses else float("nan")


_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def evaluate_model(model, cfg, dataset_val, size, args, train_flags,
                   epoch) -> dict:
    """Per-epoch evaluation fan-out on the model's device, the JAX
    trainer's ``evaluate_model``: segmentation (+depth) every eval epoch;
    keypoints / VPR / VO every --full_eval epochs. Each task is guarded
    (an ``{"error": ...}`` entry) and runs on synthetic homography pairs
    where the real dataset is absent; the results go to the checkpoint.
    One difference: the depth examples (cv2 pictures) are guarded on
    their own, so that a machine without cv2 keeps the depth metrics. The
    model is in eval mode meanwhile and gets its training mode back."""
    from nanovs_slam_torch.inference import make_eval_fn
    from nanovs_slam_torch.ops.image import resize_nearest

    H, W = size
    dev = next(model.parameters()).device
    was_training = model.training
    infer_np = make_eval_fn(model, cfg, H, W)
    n_val = min(len(dataset_val), args.max_eval_items)
    hs, ws = 2 * (H // cfg.cell), 2 * (W // cfg.cell)
    results = {}
    try:
        if train_flags.get("segmentation"):
            from nanovs_slam_torch.evaluation.segmentation import \
                evaluate_segmentation

            def seg_iter():
                for i in range(n_val):
                    item = dataset_val[i]
                    yield {"image": item["image"][None] * 2 - 1,
                           "seg": resize_nearest(item["seg"], hs, ws)[None]}

            try:
                results["segmentation"] = evaluate_segmentation(
                    seg_iter(), infer_np, cfg.n_classes)
            except Exception as e:
                results["segmentation"] = {"error": str(e)}

        if train_flags.get("depth"):
            from nanovs_slam_torch.evaluation.depth import evaluate_depth

            def depth_iter():
                # GT depth downsampled (NEAREST) to the depth head's
                # resolution, like the reference transform_post_seg
                for i in range(n_val):
                    item = dataset_val[i]
                    if "depth" in item:
                        yield {"image": item["image"][None] * 2 - 1,
                               "depth": resize_nearest(item["depth"], hs,
                                                       ws)[None]}

            try:
                results["depth"] = evaluate_depth(depth_iter(), infer_np)
            except Exception as e:
                results["depth"] = {"error": str(e)}
            else:
                try:
                    save_depth_examples(dataset_val, infer_np, os.path.join(
                        args.out_model_path + "_media",
                        f"depth_examples_e{epoch}.png"))
                except ImportError as e:  # cv2 draws them
                    print(f"depth examples not written: {e}")

        if getattr(args, "debug", False):
            try:
                from nanovs_slam_torch.evaluation.detector import \
                    warp_keypoints
                from nanovs_slam_torch.utils.debug_viz import (
                    save_pair_debug, save_seg_debug)

                media = args.out_model_path + "_media"
                item = synthetic_homography_pairs(dataset_val, size, 1,
                                                  dev)[0]
                out0 = infer_np(item["image"])
                out1 = infer_np(item["image_aug"])
                kps0 = out0["coord"].reshape(-1, 2)
                save_pair_debug(
                    os.path.join(media, f"debug_pair_e{epoch}.png"),
                    item["image"], item["image_aug"], kps0,
                    out1["coord"].reshape(-1, 2),
                    kps0_warped=warp_keypoints(kps0, item["homography"]),
                    scores0=out0["score"].reshape(-1),
                    scores1=out1["score"].reshape(-1), top_k=args.top_k)
                if train_flags.get("segmentation"):
                    val0 = dataset_val[0]
                    gt = resize_nearest(val0["seg"], hs, ws)
                    pred = infer_np(val0["image"][None] * 2 - 1)["seg"][0]
                    save_seg_debug(
                        os.path.join(media, f"debug_seg_e{epoch}.png"),
                        val0["image"], pred, gt, n_classes=cfg.n_classes)
            except Exception as e:
                print(f"debug visualization failed: {e}")

        if (epoch + 1) % args.full_eval != 0:
            return results
        results.update(_full_eval(model, cfg, dataset_val, size, args,
                                  train_flags, infer_np, n_val, dev))
        return results
    finally:
        model.train(was_training)


def _full_eval(model, cfg, dataset_val, size, args, train_flags, infer_np,
               n_val, dev) -> dict:
    """The --full_eval tasks: keypoints (HPatches-format), VPR, VO."""
    from nanovs_slam_torch.data.datasets import load_datasets_json

    H, W = size
    paths = load_datasets_json(args.dataset_config)
    results = {}
    if train_flags.get("keypoints"):
        from nanovs_slam_torch.evaluation.keypoints import \
            evaluate_keypoint_net

        try:
            root = paths.get("hpatches_data_path")
            if root and os.path.isdir(root):
                from nanovs_slam_torch.data.hpatches import HPatchesDataset

                items = list(HPatchesDataset(root, (W, H)))[:n_val]
            else:
                items = synthetic_homography_pairs(dataset_val, size, n_val,
                                                   dev)
            r = evaluate_keypoint_net(items, infer_np, output_shape=(W, H),
                                      top_k=args.top_k)
            if r["repeatability"] == -1:
                # score head not yet calibrated to the reference's 0.7
                # operating point: fall back to pure top-k ranking so the
                # training trend stays visible (threshold recorded)
                r = evaluate_keypoint_net(items, infer_np,
                                          output_shape=(W, H),
                                          top_k=args.top_k,
                                          conf_threshold=0.0)
                r["conf_threshold_used"] = 0.0
            results["keypoints"] = r
        except Exception as e:
            results["keypoints"] = {"error": str(e)}

    if train_flags.get("visloc"):
        import torch

        from nanovs_slam_torch.evaluation.global_descriptor import \
            evaluate_global_descriptor

        try:
            # DB = val images, queries = homography-warped copies, the
            # positive of query i is db entry i; the search on the device
            items = synthetic_homography_pairs(dataset_val, size, n_val, dev)
            db = np.stack([infer_np(it["image"])["vlad"][0]
                           for it in items])
            q = np.stack([infer_np(it["image_aug"])["vlad"][0]
                          for it in items])
            positives = [np.array([i]) for i in range(len(items))]
            n_values = tuple(n for n in (1, 5, 10, 20)
                             if n <= len(items)) or (1,)
            results["visloc"] = evaluate_global_descriptor(
                torch.from_numpy(db).to(dev), torch.from_numpy(q).to(dev),
                positives, n_values=n_values)
        except Exception as e:
            results["visloc"] = {"error": str(e)}

    if train_flags.get("keypoints"):
        kitti = paths.get("kitti_data_path")
        if not (kitti and os.path.isdir(kitti)):
            # the seeded synthetic-KITTI fallback (an mp4 written with
            # cv2), repo-anchored as the JAX trainer's
            try:
                make_sequence = _script("make_synthetic_kitti").make_sequence
                kitti = os.path.join(_REPO, "fixtures", "kitti_synth")
                if not os.path.exists(os.path.join(kitti, "06.txt")):
                    make_sequence(kitti, 12)
            except Exception as e:
                results["vo"] = {"skipped": f"no kitti, fixture gen: {e}"}
                kitti = None
        if kitti:
            from nanovs_slam_torch.vo.frontend import KP2DTinyFrontend
            from nanovs_slam_torch.vo.visual_odometry import \
                evaluate_visual_odometry

            try:
                fe = KP2DTinyFrontend(model, cfg, (256, 1024), top_k=4000,
                                      device=dev)
                results["vo"] = evaluate_visual_odometry(
                    fe, kitti, "06.txt", "06.mp4", new_size=(256, 1024),
                    max_frames=n_val, device=dev)
            except Exception as e:
                results["vo"] = {"error": str(e)}
    return results


def _script(name: str):
    """The module of ``scripts/<name>.py``."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(_REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def save_depth_examples(dataset_val, infer_np, path, n: int = 4):
    """Grid of (input | predicted depth | GT depth) rows for the first n
    val items (wandb.Image analog; reference train_multitask.py:754-769),
    drawn and written with cv2."""
    import cv2

    rows = []
    for i in range(min(n, len(dataset_val))):
        item = dataset_val[i]
        if "depth" not in item:
            return
        out = infer_np(item["image"][None] * 2.0 - 1.0)
        pred = np.asarray(out["depth"])[0, ..., 0]
        gt = item["depth"][..., 0]
        H, W = item["image"].shape[:2]

        def colorize(d):
            d = (255 * (d - d.min()) / max(float(d.max() - d.min()), 1e-6))
            d8 = cv2.resize(d.astype(np.uint8), (W, H),
                            interpolation=cv2.INTER_NEAREST)
            return cv2.applyColorMap(d8, cv2.COLORMAP_MAGMA)

        img_u8 = cv2.cvtColor((item["image"] * 255).astype(np.uint8),
                              cv2.COLOR_RGB2BGR)
        rows.append(np.concatenate([img_u8, colorize(pred), colorize(gt)],
                                   axis=1))
    if rows:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        cv2.imwrite(path, np.concatenate(rows, axis=0))


def synthetic_homography_pairs(dataset, size, n_items, device=None):
    """HPatches-format eval pairs from any image dataset: a random
    homography per image (``RandomState(1000 + i)``, as the JAX trainer
    draws it), the bilinear warp on ``device`` (default "cuda"), and the
    PIXEL point-transfer matrix the evaluators expect. The images come
    back to the host in [-1, 1]."""
    import torch

    from nanovs_slam_torch.data.homography import (homography_to_pixel,
                                                   homography_warp_image,
                                                   sample_homography)
    from nanovs_slam_torch.utils.device import resolve_device

    dev = resolve_device(device)
    H, W = size
    items = []
    for i in range(min(len(dataset), n_items)):
        img = dataset[i]["image"]
        rs = np.random.RandomState(1000 + i)
        H_norm = sample_homography((H, W), rs)
        warped = homography_warp_image(
            torch.from_numpy(img[None]).to(dev),
            torch.from_numpy(H_norm[None]).to(dev), mode="bilinear")
        items.append({
            "image": img[None] * 2.0 - 1.0,
            "image_aug": warped.cpu().numpy() * 2.0 - 1.0,
            "homography": homography_to_pixel(H_norm, (H, W)),
        })
    return items


def main(argv=None):
    args = parse_args(argv)
    if launched(args):
        return train_launched(args)
    check_supported(args)
    ranks, procs = parallel_layout(args)
    if ranks == 1:
        return train(args)
    from nanovs_slam_torch.parallel.distributed import (free_port, spawn,
                                                        spawn_backend)
    from nanovs_slam_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    local = ranks // procs
    backend = spawn_backend(dev, local)
    shared = (dev.type == "cuda" and backend == "gloo")
    print(f"data parallel: {ranks} ranks, {local} on process "
          f"{args.process_id or 0} of {procs}, over {backend} on {dev.type}"
          + (f"; {local} ranks share {torch.cuda.device_count()} card(s)"
             if shared else ""), flush=True)
    if dev.type == "cuda":
        from nanovs_slam_torch.kernels import _build

        _build.load_library()  # once, before the ranks start
    spawn(train_rank, local, (args,), device=dev, backend=backend,
          timeout=args.dist_timeout,
          address=args.coordinator_address or f"127.0.0.1:{free_port()}",
          world=ranks, rank0=(args.process_id or 0) * local)


def train_launched(args) -> None:
    """This process as one rank of a launcher's group, joined by
    ``initialize`` from the launcher's environment: the process is the
    host of its one rank (``--process_id``, ``--num_processes`` and
    ``--num_devices`` from the launch, ``--coordinator_address`` from
    MASTER_ADDR / MASTER_PORT unless given)."""
    import torch.distributed as dist

    from nanovs_slam_torch.parallel.distributed import (_pod_env,
                                                        default_backend,
                                                        global_mesh,
                                                        initialize,
                                                        local_rank,
                                                        rank_device)
    from nanovs_slam_torch.utils.device import resolve_device

    args.process_id, args.num_processes = _pod_env()
    args.num_devices = args.num_processes
    if args.coordinator_address is None and os.environ.get("MASTER_ADDR"):
        args.coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                                    f"{os.environ.get('MASTER_PORT', '')}")
    check_supported(args)
    dev = rank_device(resolve_device(args.device), local_rank())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = default_backend(dev)
    initialize(args.coordinator_address, backend=backend, device=dev,
               timeout=args.dist_timeout)
    try:
        if args.process_id == 0:
            print(f"data parallel: {args.num_devices} ranks, 1 on process "
                  f"0 of {args.num_processes}, over {backend} on "
                  f"{dev.type}", flush=True)
        train_rank(global_mesh(device=dev), args)
    finally:
        dist.destroy_process_group()


def train_rank(mesh, args) -> None:
    """One rank of a data-parallel run: ranks other than 0 print
    nothing."""
    import sys

    if mesh.rank != 0:
        sys.stdout = open(os.devnull, "w")
    train(args, mesh)


def train(args, mesh=None):
    """The training run, on ``mesh``'s ranks (this process one of them)
    or, where None, in this process on ``--device``."""
    from nanovs_slam_torch.data.pipeline import PairLoader
    from nanovs_slam_torch.models.inlier_net import init_inlier_net
    from nanovs_slam_torch.modules.blocks import set_dropout
    from nanovs_slam_torch.train.schedules import (DEFAULT_LOSS_WEIGHTS,
                                                   PlateauController,
                                                   loss_weights_for_epoch,
                                                   make_lr_schedule)
    from nanovs_slam_torch.train.train_step import (create_train_state,
                                                    get_learning_rate,
                                                    make_optimizer,
                                                    make_train_step,
                                                    set_learning_rate)
    from nanovs_slam_torch.utils.checkpoint import (restore_train_state,
                                                    save_checkpoint)
    from nanovs_slam_torch.utils.device import resolve_device
    from nanovs_slam_torch.utils.logging import MetricLogger

    dev = mesh.device if mesh is not None else resolve_device(args.device)
    lead = mesh is None or mesh.rank == 0  # prints, logs, evaluates, saves
    procs = args.num_processes or 1
    host_bs = args.batch_size // procs  # this host's share of the batch
    local = 1 if mesh is None else mesh.size // procs
    local_rank = 0 if mesh is None else mesh.rank % local
    train_config = {"cocostuff": COCOSTUFF_CONFIG,
                    "cityscapes": CITYSCAPES_CONFIG,
                    "synthetic": SYNTHETIC_CONFIG}[args.dataset_name].copy()
    if args.lr is not None:
        train_config["lr"] = args.lr
    if args.n_epochs is not None:
        train_config["n_epochs"] = args.n_epochs
    if args.lr_scheduler is not None:
        train_config["lr_scheduler"] = args.lr_scheduler
    if args.freeze_backbone:
        train_config["freeze_backbone"] = True
    size = (train_config["im_h"], train_config["im_w"])
    H, W = size

    cfg, init_model = build_config(args, train_config["n_classes"])
    if args.model_type == "KeypointFormer":
        from nanovs_slam_torch.models.keypoint_former import \
            check_frame_size

        check_frame_size(H, W)
    train_flags = {"keypoints": True, "segmentation": True, "visloc": True,
                   "depth": args.depth}
    if args.only_segmentation:
        train_flags.update(keypoints=False, visloc=False, depth=False)
    elif args.only_keypoints:
        train_flags.update(segmentation=False, visloc=False, depth=False)
    if args.no_vpr:
        train_flags["visloc"] = False
    if args.dataset_name == "cityscapes":
        train_flags["depth"] = False

    dataset, dataset_val = get_dataset(args, train_config, size)
    if args.device_cache:
        from nanovs_slam_torch.data.device_cache import \
            DeviceCachedPairLoader

        loader = DeviceCachedPairLoader(dataset, host_bs, H, W,
                                        d_f=cfg.cell // 2, train=True,
                                        seed=args.seed,
                                        with_depth=args.depth, device=dev)
        print(f"device cache: {loader.n} items, "
              f"{loader.nbytes() / 1e6:.1f} MB resident on {dev}")
    else:
        # each host draws its own augments, as the JAX CLI seeds them
        loader = PairLoader(dataset, host_bs, H, W,
                            d_f=cfg.cell // 2, train=True,
                            seed=args.seed + 1000 * (args.process_id or 0),
                            with_depth=args.depth, device=dev,
                            rows=None if mesh is None else (local_rank,
                                                            local))
    steps_per_epoch = len(loader)
    if args.max_steps_per_epoch:
        steps_per_epoch = min(steps_per_epoch, args.max_steps_per_epoch)

    plateau_ctl = None
    if train_config["lr_scheduler"] == "plateau":
        plateau_ctl = PlateauController(train_config["lr"], mode="max",
                                        factor=0.1, patience=5)
        spec = make_optimizer(train_config["optimizer"],
                              lr=train_config["lr"],
                              freeze_backbone=train_config["freeze_backbone"],
                              plateau=True)
    else:
        spec = make_optimizer(
            train_config["optimizer"], lr=train_config["lr"],
            schedule=make_lr_schedule(train_config["lr_scheduler"],
                                      train_config["lr"], steps_per_epoch,
                                      train_config["n_epochs"]),
            freeze_backbone=train_config["freeze_backbone"])
    # every draw comes from the seed: weights (CPU generators, the same on
    # every device), dropout (a generator on the device), data (numpy)
    model = init_model(cfg, torch.Generator().manual_seed(args.seed), dev)
    set_dropout(model, generator=torch.Generator(dev).manual_seed(
        args.seed + 1))
    io_net = None
    if train_flags["keypoints"]:
        io_net = init_inlier_net(torch.Generator().manual_seed(args.seed + 2),
                                 device=dev)
    state = create_train_state(model, spec, with_io=io_net is not None,
                               io_net=io_net)
    if args.model_path:
        meta = restore_train_state(
            args.model_path, state,
            "seg_last" if args.ignore_seg_head else None)
        print(f"Restored model from {args.model_path} "
              f"(epoch {meta.get('epoch')})")

    step_kw = dict(train_flags=train_flags, io_top_k=args.top_k,
                   watch_gradients=args.watch_gradients, qat=args.qat)
    if mesh is not None:
        from nanovs_slam_torch.parallel.data_parallel import \
            make_dp_train_step
        from nanovs_slam_torch.parallel.mesh import (broadcast, replicate,
                                                     shard_batch)

        step_fn, _ = make_dp_train_step(mesh, cfg, H, W, **step_kw)
        state = replicate(mesh, state)
    else:
        step_fn = make_train_step(cfg, H, W, **step_kw)
    epoch_fn = None
    if args.device_cache:
        from nanovs_slam_torch.train.scan_epoch import (make_epoch_fn,
                                                        shard_epoch_inputs,
                                                        weights_as_arrays)

        epoch_fn = make_epoch_fn(step_fn, d_f=cfg.cell // 2,
                                 with_depth=args.depth, augment=True,
                                 mesh=mesh)
    config_blob = {"input_args": vars(args), "train_config": train_config,
                   "size": size,
                   "model_config": getattr(cfg, "name", args.config),
                   "variant": getattr(cfg, "variant", args.model_type),
                   "loss_weights_schedule": args.loss_schedule,
                   "device": str(dev),
                   "ranks": 1 if mesh is None else mesh.size}
    logger = MetricLogger(config=config_blob) if lead else None

    results = {}
    losses = []
    log_every = args.log_every or max(1, steps_per_epoch // 10)
    ckpt_every = args.ckpt_every or (
        args.eval_every if not args.no_eval
        else max(1, train_config["n_epochs"] // 15))

    def log_step(epoch, i, m):
        losses.append(m["total_loss"])
        if logger is not None:
            logger.log_dict("loss/", m, step=epoch * steps_per_epoch + i)
        print(f"E{epoch} it{i}/{steps_per_epoch} "
              f"loss {m['total_loss']:.4f} "
              f"seg {m.get('seg_loss', 0):.4f} "
              f"vlad {m.get('vlad_loss', 0):.4f}", flush=True)

    t_start = time.time()
    for epoch in range(args.start_epoch, train_config["n_epochs"]):
        weights = loss_weights_for_epoch(epoch, args.loss_schedule,
                                         DEFAULT_LOSS_WEIGHTS)
        if args.no_vpr:
            weights = weights._replace(vlad_loss=0.0)
        losses.clear()
        if epoch_fn is not None:
            # the epoch's indices and homographies go up once; its stacked
            # metrics come back once, at its end
            idx_all, homos_all, gen = loader.epoch_arrays(epoch)
            idx_all = idx_all[:steps_per_epoch]
            homos_all = homos_all[:steps_per_epoch]
            if mesh is None:
                cache = loader.cache_arrays()
            elif epoch == args.start_epoch:
                # the state and the cache replicated once (in place), each
                # rank its columns of the batch
                state, cache, idx_all, homos_all = shard_epoch_inputs(
                    mesh, state, loader.cache_arrays(), idx_all, homos_all)
            else:  # later epochs split only their indices and homographies
                idx_all, homos_all = shard_batch(mesh, (idx_all, homos_all),
                                                 dim=1)
            state, stack = epoch_fn(
                state, cache, idx_all, homos_all,
                weights_as_arrays(weights, dev), gen)
            stack = {k: v.tolist() for k, v in stack.items()}
            for i in range(steps_per_epoch):
                if (epoch * steps_per_epoch + i) % log_every == 0:
                    log_step(epoch, i, {k: v[i] for k, v in stack.items()})
        else:
            # 2-deep prefetch: host augments and homographies for the next
            # batches overlap the device's step
            for i, batch in enumerate(loader.batches(prefetch=2)):
                if i >= steps_per_epoch:
                    break
                state, metrics = step_fn(state, batch, weights)
                if (epoch * steps_per_epoch + i) % log_every == 0:
                    log_step(epoch, i,
                             {k: float(v) for k, v in metrics.items()})

        if lead and not args.no_eval and (epoch + 1) % args.eval_every == 0:
            results = evaluate_model(state.model, cfg, dataset_val, size,
                                     args, train_flags, epoch)
            flat = {f"{task}/{k}": v for task, r in results.items()
                    if isinstance(r, dict) for k, v in r.items()
                    if isinstance(v, (int, float))}
            logger.log_dict("val/", flat, step=state.step)
            print(f"E{epoch} val: {json.dumps(results, default=str)}",
                  flush=True)

        if plateau_ctl is not None:
            metric = plateau_metric(results, losses)
            if mesh is not None:  # rank 0's evaluation decides
                metric = float(broadcast(mesh, torch.tensor(
                    [metric], dtype=torch.float64, device=dev))[0])
            new_lr = plateau_ctl.step(metric)
            if not math.isclose(new_lr, get_learning_rate(state),
                                rel_tol=1e-5):
                print(f"E{epoch} plateau: metric {metric:.4f} stalled, "
                      f"lr -> {new_lr:.2e}")
                set_learning_rate(state, new_lr)
            if logger is not None:
                logger.log_dict("scheduler/", {"lr": new_lr},
                                step=state.step)

        if lead and ((epoch + 1) % ckpt_every == 0
                     or epoch + 1 == train_config["n_epochs"]):
            path = save_checkpoint(args.out_model_path, state,
                                   config=config_blob, epoch=epoch + 1,
                                   results=results)
            print(f"E{epoch} checkpoint {path}")
    if losses:
        print(f"done in {time.time() - t_start:.1f}s; "
              f"final loss {losses[-1]:.4f}")
    else:
        print(f"done in {time.time() - t_start:.1f}s "
              f"(no loss fetch in the final epoch; see metrics.jsonl)")


if __name__ == "__main__":
    main()
