"""Multitask evaluation CLI of the port, the counterpart of the JAX
package's root ``eval_multitask.py``, with its flags, defaults and
results JSON:

    python -m nanovs_slam_torch.eval_multitask [--device cuda]
        [--model_path CK.npz] [--config S] [--model_type KP2DtinyV2]
        [--n_classes 28] [--dataset_config datasets.json] [--keypoints]
        [--visloc] [--segmentation] [--depth] [--vo
        [--vo_matcher bf|flann|crosscheck|semantic|lightglue|dense]
        [--lg_ckpt LG.npz] [--device_pose] [--lg_threshold 0.0]
        [--lg_width -1]] [--top_k 300 1000] [--im_h 240] [--im_w 320]
        [--bf16] [--max_items N] [--out eval_results.json]
        [--debug --result_dir results]

The model and its postprocess run on ``--device`` (default cuda; a
machine without a card needs ``--device cpu``), the metric tail on the
host in numpy. Each task reads its dataset from datasets.json, as the JAX
CLI does: keypoints fall back to the synthetic HPatches fixture (written
with cv2 by ``scripts/make_synthetic_hpatches.py``), a task without its
data stores ``{"error": ...}``. ``--use_pallas`` is accepted and changes
nothing: the port runs its kernels for every CUDA tensor. Flags whose
modules the port does not have yet exit, naming their ROADMAP item:
``--int8`` and ``--int8_weight_only`` (item 6), ``--model_type
KeypointFormer`` and a torch ``.ckpt`` ``--model_path`` (item 7) and
``--wandb`` (item 7).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

# flag -> why it exits (the ROADMAP.md item its module waits in)
DEFERRED = {
    "int8": "int8 inference (quant.py) waits in ROADMAP Queue 1 item 6 "
            "(int8 and export)",
    "int8_weight_only": "fake-quantised weights (quant.py) wait in ROADMAP "
                        "Queue 1 item 6 (int8 and export)",
    "wandb": "the port writes its results JSON only (wandb: ROADMAP Queue "
             "1 item 7, utils)",
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Evaluate KP2DTiny multitask "
                                "(PyTorch port)")
    p.add_argument("--model_path", default=None,
                   help=".npz checkpoint (the JAX package's or the port's)")
    p.add_argument("--config", default="S")
    p.add_argument("--model_type", default="KP2DtinyV2")
    p.add_argument("--n_classes", type=int, default=28)
    p.add_argument("--dataset_config", default="datasets.json")
    p.add_argument("--keypoints", action="store_true")
    p.add_argument("--visloc", action="store_true")
    p.add_argument("--segmentation", action="store_true")
    p.add_argument("--depth", action="store_true")
    p.add_argument("--vo", action="store_true")
    p.add_argument("--vo_matcher", default="bf",
                   choices=["bf", "flann", "crosscheck", "semantic",
                            "lightglue", "dense"],
                   help="VO matching mode (vo_eval's --matcher)")
    p.add_argument("--lg_ckpt", default=None,
                   help="trained LightGlue .npz for --vo_matcher lightglue")
    p.add_argument("--device_pose", action="store_true",
                   help="the pose by the device RANSAC instead of the "
                        "host cv2 tail")
    p.add_argument("--lg_threshold", type=float, default=0.0,
                   help="LightGlue VO match filter threshold")
    p.add_argument("--lg_width", type=float, default=-1.0,
                   help="LightGlue adaptive width pruning confidence "
                        "(<=0 disables)")
    p.add_argument("--top_k", type=int, nargs="+", default=[300, 1000])
    p.add_argument("--im_h", type=int, default=240)
    p.add_argument("--im_w", type=int, default=320)
    p.add_argument("--bf16", action="store_true",
                   help="the model computes in bfloat16 (float32 weights)")
    p.add_argument("--use_pallas", action="store_true",
                   help="accepted for the JAX CLI's sake; changes nothing: "
                        "the port runs its CUDA kernels for every CUDA "
                        "tensor")
    p.add_argument("--int8", action="store_true")
    p.add_argument("--int8_weight_only", action="store_true")
    p.add_argument("--calib_batches", type=int, default=8,
                   help="int8 calibration batches (with --int8)")
    p.add_argument("--seed", type=int, default=42069)
    p.add_argument("--wandb", action="store_true")
    p.add_argument("--out", default="eval_results.json")
    p.add_argument("--max_items", type=int, default=None)
    p.add_argument("--debug", action="store_true",
                   help="save prediction visualizations (keypoint "
                        "overlays, seg panels) to --result_dir (needs cv2)")
    p.add_argument("--result_dir", default="results",
                   help="where --debug writes PNGs")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


def check_supported(args) -> None:
    """Exit for every flag whose module the port does not have yet."""
    for flag, why in DEFERRED.items():
        if getattr(args, flag):
            raise SystemExit(f"--{flag}: not in the port yet; {why}")
    if args.model_type == "KeypointFormer":
        raise SystemExit("--model_type KeypointFormer: not in the port yet; "
                         "models/keypoint_former.py waits in ROADMAP Queue 1 "
                         "item 7")
    path = args.model_path
    if path and not path.endswith(".npz"):
        if os.path.isdir(path):
            raise SystemExit(f"--model_path {path}: the port reads .npz "
                             "checkpoints (utils/checkpoint.py), not "
                             "checkpoint directories")
        raise SystemExit(f"--model_path {path}: torch checkpoints are not "
                         "read by the port yet; utils/torch_import waits in "
                         "ROADMAP Queue 1 item 7")


def build(args, dev):
    """(model on ``dev`` in eval mode, cfg): seeded init_model weights, or
    the ``--model_path`` checkpoint's."""
    import torch

    from .configs import get_config
    from .models.kp2dtiny import init_model

    v3 = args.model_type in ("KP2DtinyV3", "DF")
    cfg = get_config(args.config, v3=v3, n_classes=args.n_classes,
                     depth=args.depth,
                     dtype="bfloat16" if args.bf16 else "float32")
    model = init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    if args.model_path:
        from .utils.checkpoint import load_npz_checkpoint
        from .utils.convert import load_jax_variables

        tree, _ = load_npz_checkpoint(args.model_path)
        load_jax_variables(model, tree["params"], tree["batch_stats"])
    return model.to(dev).eval(), cfg


def eval_keypoints(args, paths, infer_np, results) -> None:
    from .data.hpatches import HPatchesDataset, ensure_synthetic_hpatches
    from .evaluation.keypoints import evaluate_keypoint_net
    from .utils.logging import print_table

    H, W = args.im_h, args.im_w
    root = paths.get("hpatches_data_path")
    if not (root and os.path.isdir(root)):
        print("hpatches_data_path missing; using the synthetic "
              "discriminative fixture (40 graded-warp pairs)")
        root = ensure_synthetic_hpatches()
    ds = HPatchesDataset(root, (W, H))
    items = list(ds)[: args.max_items] if args.max_items else ds
    if args.debug:
        from .evaluation.detector import warp_keypoints
        from .utils.debug_viz import save_pair_debug

        for i, item in enumerate(items):
            if i >= 4:
                break
            out0 = infer_np(item["image"])
            out1 = infer_np(item["image_aug"])
            kps0 = out0["coord"].reshape(-1, 2)
            save_pair_debug(
                os.path.join(args.result_dir, f"keypoints_{i}.png"),
                item["image"], item["image_aug"], kps0,
                out1["coord"].reshape(-1, 2),
                kps0_warped=warp_keypoints(kps0, item["homography"]),
                scores0=out0["score"].reshape(-1),
                scores1=out1["score"].reshape(-1))
    for k in args.top_k:
        try:
            r = evaluate_keypoint_net(items, infer_np, output_shape=(W, H),
                                      top_k=k)
            results[f"keypoints_top{k}"] = r
            print_table({kk: vv for kk, vv in r.items()
                         if not isinstance(vv, dict)}, f"keypoints top-{k}")
        except Exception as e:
            results[f"keypoints_top{k}"] = {"error": str(e)}


def eval_segmentation(args, paths, cfg, infer_np, results) -> None:
    from .data.datasets import COCOStuffDataset, CityscapesDataset
    from .evaluation.segmentation import evaluate_segmentation
    from .ops.image import resize_nearest
    from .utils.logging import print_table

    H, W = args.im_h, args.im_w
    ds = None
    if args.n_classes == 19 and paths.get("cityscapes_data_path"):
        ds = CityscapesDataset(paths["cityscapes_data_path"], (H, W), "val")
    elif paths.get("coco_data_path"):
        ds = COCOStuffDataset(paths["coco_data_path"], (H, W), "val",
                              args.n_classes)
    if ds is None or len(ds) == 0:
        results["segmentation"] = {"error": "dataset missing"}
        return
    hs, ws = 2 * (H // cfg.cell), 2 * (W // cfg.cell)

    def seg_iter():
        for i in range(min(len(ds), args.max_items or len(ds))):
            item = ds[i]
            yield {"image": item["image"][None] * 2 - 1,
                   "seg": resize_nearest(item["seg"], hs, ws)[None]}

    if args.debug:
        from .utils.debug_viz import save_seg_debug

        for i, batch in enumerate(seg_iter()):
            if i >= 4:
                break
            out = infer_np(batch["image"])
            save_seg_debug(os.path.join(args.result_dir, f"seg_{i}.png"),
                           batch["image"], out["seg"][0], batch["seg"][0],
                           n_classes=args.n_classes)
    try:
        r = evaluate_segmentation(seg_iter(), infer_np, args.n_classes)
        results["segmentation"] = r
        print_table(r, "segmentation")
    except Exception as e:
        results["segmentation"] = {"error": str(e)}


def eval_depth(args, paths, cfg, infer_np, results) -> None:
    from .data.extra_datasets import NYUv2Dataset
    from .evaluation.depth import evaluate_depth
    from .ops.image import resize_nearest
    from .utils.logging import print_table

    H, W = args.im_h, args.im_w
    root = paths.get("nyuv2_data_path")
    if not (root and os.path.isdir(root)):
        results["depth"] = {"error": "nyuv2_data_path missing"}
        return
    try:
        ds = NYUv2Dataset(root, (H, W), split="test")
        hs, ws = 2 * (H // cfg.cell), 2 * (W // cfg.cell)

        def depth_iter():
            for i in range(min(len(ds), args.max_items or len(ds))):
                item = ds[i]
                if "depth" in item:
                    yield {"image": item["image"][None] * 2 - 1,
                           "depth": resize_nearest(item["depth"], hs,
                                                   ws)[None]}

        r = evaluate_depth(depth_iter(), infer_np)
        results["depth"] = r
        print_table(r, "depth")
    except Exception as e:
        results["depth"] = {"error": str(e)}


def eval_visloc(args, paths, infer_np, dev, results) -> None:
    import torch

    from .data.pittsburgh import WholeDataset
    from .evaluation.global_descriptor import evaluate_global_descriptor

    root = paths.get("pittsburgh_data_path")
    struct = os.path.join(root or "", "datasets", "pitts30k_val.mat")
    if root and not os.path.exists(struct):
        # the synthetic fixture (scripts/make_synthetic_pittsburgh.py)
        # ships only the train split
        alt = os.path.join(root, "datasets", "pitts30k_train.mat")
        if os.path.exists(alt):
            print(f"pitts30k_val.mat missing; using {alt}")
            struct = alt
    if not (root and os.path.exists(struct)):
        results["visloc"] = {"error": "pittsburgh_data_path missing"}
        return
    try:
        ds = WholeDataset(struct, root, (args.im_h, args.im_w))
        feats = np.stack([infer_np(ds[i][None])["vlad"][0]
                          for i in range(len(ds))])
        feats = torch.from_numpy(feats).to(dev)  # the search on the device
        db, q = feats[: ds.dbStruct.numDb], feats[ds.dbStruct.numDb:]
        r = evaluate_global_descriptor(db, q, ds.get_positives())
        results["visloc"] = r
        print(r)
    except Exception as e:
        results["visloc"] = {"error": str(e)}


def eval_vo(args, paths, model, cfg, dev, results) -> None:
    from .vo.frontend import KP2DTinyFrontend
    from .vo.visual_odometry import evaluate_visual_odometry

    kitti = paths.get("kitti_data_path")
    if not (kitti and os.path.isdir(kitti)):
        results["vo"] = {"error": "kitti_data_path missing"}
        return
    for vo_h, vo_w in [(128, 256), (128, 512), (256, 1024)]:
        try:
            fe = KP2DTinyFrontend(model, cfg, (vo_h, vo_w), top_k=4000,
                                  with_seg=args.vo_matcher == "semantic",
                                  device=dev)
            # --vo_matcher dense: a DenseMatcher on the frontend's model
            r = evaluate_visual_odometry(
                fe, kitti, "06.txt", "06.mp4", new_size=(vo_h, vo_w),
                max_frames=args.max_items, verbose=True,
                matcher=args.vo_matcher,
                lightglue=(args.lg_ckpt if args.vo_matcher == "lightglue"
                           else None),
                device_pose=args.device_pose, lg_width=args.lg_width,
                lg_threshold=args.lg_threshold, device=dev)
            results[f"vo_{vo_h}x{vo_w}"] = r
            print(f"VO {vo_h}x{vo_w}: {r['total']}")
        except Exception as e:
            results[f"vo_{vo_h}x{vo_w}"] = {"error": str(e)}


def main(argv=None) -> dict:
    args = parse_args(argv)
    check_supported(args)
    from .data.datasets import load_datasets_json
    from .inference import make_eval_fn
    from .utils.device import resolve_device
    from .utils.seed import set_seed

    set_seed(args.seed)
    dev = resolve_device(args.device)
    model, cfg = build(args, dev)
    infer_np = make_eval_fn(model, cfg, args.im_h, args.im_w)
    paths = load_datasets_json(args.dataset_config)

    results = {}
    if args.keypoints:
        eval_keypoints(args, paths, infer_np, results)
    if args.segmentation:
        eval_segmentation(args, paths, cfg, infer_np, results)
    if args.depth:
        eval_depth(args, paths, cfg, infer_np, results)
    if args.visloc:
        eval_visloc(args, paths, infer_np, dev, results)
    if args.vo:
        eval_vo(args, paths, model, cfg, dev, results)

    with open(args.out, "w") as f:
        json.dump(results, f, indent=2, default=str)
    print(f"results written to {args.out}")
    return results


if __name__ == "__main__":
    main()
