"""Multitask training CLI of the port, the counterpart of the JAX
package's ``train_multitask.py``, with its flags and defaults:

    python -m nanovs_slam_torch.train_multitask --no_eval [--device cuda]
        [--config S] [--model_type KP2DtinyV2|KP2DtinyV3]
        [--dataset_name cocostuff|cityscapes|synthetic] [--batch_size 4]
        [--lr ...] [--n_epochs ...] [--seed 42069] [--model_path CK.npz]
        [--out_model_path model_ckpt] [--top_k 300] [--depth]
        [--freeze_backbone] [--ignore_seg_head] [--only_segmentation]
        [--only_keypoints] [--no_vpr] [--loss_schedule default]
        [--max_steps_per_epoch N] [--synthetic_items 64] [--log_every N]
        [--ckpt_every N] [--lr_scheduler none|step|cosine|plateau]
        [--watch_gradients]

It runs on ``--device`` (default cuda; a machine without a card needs
``--device cpu``). Without the dataset named in datasets.json it trains
on ``SyntheticShapesDataset``, as the JAX trainer falls back. Checkpoints
are ``<out_model_path>.npz`` files in the format the JAX
``load_checkpoint`` reads (``utils/checkpoint.save_checkpoint``); metrics
go to ``metrics.jsonl``. Flags whose modules the port does not have yet
raise, naming their ROADMAP item: the trainer's evaluation (so
``--no_eval`` is required), ``--bf16``, ``--qat``, ``--to_mcu``,
``KeypointFormer``, ``--device_cache``, ``--scan_epoch``, ``--debug``,
``--wandb`` and the multi-process flags.
"""

from __future__ import annotations

import argparse
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

# flag -> why it raises (the ROADMAP.md item its module waits in)
DEFERRED = {
    "bf16": "bfloat16 training waits in ROADMAP Queue 1 item 4",
    "qat": "QAT waits in ROADMAP Queue 1 item 6 (int8 and export)",
    "to_mcu": "the MCU export configs wait in ROADMAP Queue 1 item 6 "
              "(int8 and export)",
    "device_cache": "data/device_cache.py waits in ROADMAP Queue 1 item 4",
    "scan_epoch": "train/scan_epoch.py waits in ROADMAP Queue 1 item 4",
    "debug": "the debug visualisations need the trainer's evaluation, "
             "ROADMAP Queue 1 item 5",
    "wandb": "the port logs to metrics.jsonl only (wandb: ROADMAP Queue 1 "
             "item 7, utils)",
    "num_devices": "data parallel training waits in ROADMAP Queue 1 item 7 "
                   "(parallel)",
    "coordinator_address": "multi-process training waits in ROADMAP Queue 1 "
                           "item 7 (parallel)",
    "num_processes": "multi-process training waits in ROADMAP Queue 1 item "
                     "7 (parallel)",
    "process_id": "multi-process training waits in ROADMAP Queue 1 item 7 "
                  "(parallel)",
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
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--qat", action="store_true")
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
    p.add_argument("--device_cache", action="store_true")
    p.add_argument("--scan_epoch", action="store_true")
    p.add_argument("--ckpt_every", type=int, default=None,
                   help="checkpoint cadence in epochs (default: "
                        "n_epochs/15 under --no_eval)")
    p.add_argument("--full_eval", type=int, default=3)
    p.add_argument("--lr_scheduler", default=None,
                   choices=["none", "step", "cosine", "plateau"],
                   help="override the dataset config's LR scheduler")
    p.add_argument("--no_eval", action="store_true")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


def check_supported(args) -> None:
    """Raise for every flag whose module the port does not have yet."""
    for flag, why in DEFERRED.items():
        if getattr(args, flag) not in (None, False):
            raise SystemExit(f"--{flag}: not in the port yet; {why}")
    if args.model_type == "KeypointFormer":
        raise SystemExit("--model_type KeypointFormer: not in the port yet; "
                         "models/keypoint_former.py waits in ROADMAP Queue 1 "
                         "item 7")
    if not args.no_eval:
        raise SystemExit("the trainer's evaluation is not in the port yet "
                         "(ROADMAP Queue 1 item 5): pass --no_eval")


def get_dataset(args, train_config, size):
    from nanovs_slam_torch.data.datasets import (COCOStuffDataset,
                                                 CityscapesDataset,
                                                 SyntheticShapesDataset,
                                                 load_datasets_json)

    paths = load_datasets_json(args.dataset_config)
    n_classes = train_config["n_classes"]
    if args.dataset_name == "cocostuff":
        root = paths.get("coco_data_path")
        if root and os.path.isdir(root):
            return COCOStuffDataset(root, size, "train", n_classes,
                                    args.depth)
        print("WARNING: coco_data_path missing; falling back to synthetic")
    if args.dataset_name == "cityscapes":
        root = paths.get("cityscapes_data_path")
        if root and os.path.isdir(root):
            return CityscapesDataset(root, size, "train")
        print("WARNING: cityscapes_data_path missing; using synthetic")
    return SyntheticShapesDataset(size, args.synthetic_items, n_classes,
                                  seed=0, with_depth=args.depth)


def plateau_metric(losses) -> float:
    """Quality metric for the plateau controller (mode=max): without the
    evaluation, -mean train loss."""
    return -float(np.mean(losses)) if losses else float("nan")


def main(argv=None):
    args = parse_args(argv)
    check_supported(args)
    from nanovs_slam_torch.configs import get_config
    from nanovs_slam_torch.data.pipeline import PairLoader
    from nanovs_slam_torch.models.inlier_net import init_inlier_net
    from nanovs_slam_torch.models.kp2dtiny import init_model
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

    dev = resolve_device(args.device)
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

    v3 = args.model_type in ("KP2DtinyV3", "DF")
    cfg = get_config(args.config, v3=v3, n_classes=train_config["n_classes"],
                     depth=args.depth)
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

    dataset = get_dataset(args, train_config, size)
    loader = PairLoader(dataset, args.batch_size, H, W, d_f=cfg.cell // 2,
                        train=True, seed=args.seed, with_depth=args.depth,
                        device=dev)
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

    step_fn = make_train_step(cfg, H, W, train_flags=train_flags,
                              io_top_k=args.top_k,
                              watch_gradients=args.watch_gradients)
    config_blob = {"input_args": vars(args), "train_config": train_config,
                   "size": size, "model_config": cfg.name,
                   "variant": cfg.variant,
                   "loss_weights_schedule": args.loss_schedule,
                   "device": str(dev)}
    logger = MetricLogger(config=config_blob)

    losses = []
    log_every = args.log_every or max(1, steps_per_epoch // 10)
    ckpt_every = args.ckpt_every or max(1, train_config["n_epochs"] // 15)
    t_start = time.time()
    for epoch in range(args.start_epoch, train_config["n_epochs"]):
        weights = loss_weights_for_epoch(epoch, args.loss_schedule,
                                         DEFAULT_LOSS_WEIGHTS)
        if args.no_vpr:
            weights = weights._replace(vlad_loss=0.0)
        losses = []
        # 2-deep prefetch: host augments and homographies for the next
        # batches overlap the device's step
        for i, batch in enumerate(loader.batches(prefetch=2)):
            if i >= steps_per_epoch:
                break
            state, metrics = step_fn(state, batch, weights)
            if (epoch * steps_per_epoch + i) % log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                losses.append(m["total_loss"])
                logger.log_dict("loss/", m, step=epoch * steps_per_epoch + i)
                print(f"E{epoch} it{i}/{steps_per_epoch} "
                      f"loss {m['total_loss']:.4f} "
                      f"seg {m.get('seg_loss', 0):.4f} "
                      f"vlad {m.get('vlad_loss', 0):.4f}", flush=True)

        if plateau_ctl is not None:
            metric = plateau_metric(losses)
            new_lr = plateau_ctl.step(metric)
            if not math.isclose(new_lr, get_learning_rate(state),
                                rel_tol=1e-5):
                print(f"E{epoch} plateau: metric {metric:.4f} stalled, "
                      f"lr -> {new_lr:.2e}")
                set_learning_rate(state, new_lr)
            logger.log_dict("scheduler/", {"lr": new_lr}, step=state.step)

        if ((epoch + 1) % ckpt_every == 0
                or epoch + 1 == train_config["n_epochs"]):
            path = save_checkpoint(args.out_model_path, state,
                                   config=config_blob, epoch=epoch + 1)
            print(f"E{epoch} checkpoint {path}")
    if losses:
        print(f"done in {time.time() - t_start:.1f}s; "
              f"final loss {losses[-1]:.4f}")
    else:
        print(f"done in {time.time() - t_start:.1f}s "
              f"(no loss fetch in the final epoch; see metrics.jsonl)")


if __name__ == "__main__":
    main()
