"""VO trajectory evaluation on a KITTI-style sequence with the port:

    python -m nanovs_slam_torch.vo_eval --kitti_path DIR [--device cuda]
        [--model_path CKPT.npz] [--matcher bf|flann|crosscheck|semantic|
        lightglue --lg_ckpt LG.npz [--lg_width 0.99]|dense] [--device_pose]
        [--offline] ...

The counterpart of the root ``vo_eval.py``, with its flags and defaults and
the same JSON keys: runs the online VO (or, with ``--offline``, the
sequence-level offline VO: dense, bf or lightglue matching and the device
RANSAC) over ``kitti_path/video_name`` against ``kitti_path/gt_name``,
prints the results and writes them with the arguments to ``--out``.
``--device`` (default cuda) runs the frontend, the dense matcher,
LightGlue and the device RANSAC there. Reading the video needs cv2, as
does the default host pose tail (without ``--device_pose``).
``--model_path`` takes an ``.npz`` or a reference PyTorch ``.ckpt``
(``utils/torch_import.load_model_weights``). ``--plot`` writes the
estimated trajectory beside ``--out`` (``<out>_traj.png``,
``utils/plot.plot_trajectory``); it needs matplotlib, and exits naming it
where it is missing.
"""

from __future__ import annotations

import argparse
import json
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--kitti_path", required=True)
    p.add_argument("--gt_name", default="06.txt")
    p.add_argument("--video_name", default="06.mp4")
    p.add_argument("--model_path", default=None,
                   help=".npz checkpoint (flax tree with __meta__) or a "
                        "reference torch .ckpt")
    p.add_argument("--config", default="N")
    p.add_argument("--model_type", default="KP2DtinyV2")
    p.add_argument("--n_classes", type=int, default=28)
    p.add_argument("--im_h", type=int, default=128)
    p.add_argument("--im_w", type=int, default=512)
    p.add_argument("--top_k", type=int, default=4000)
    p.add_argument("--nn_thresh", type=float, default=0.7,
                   help="keypoint confidence threshold")
    p.add_argument("--matcher", default="bf",
                   choices=["bf", "flann", "crosscheck", "semantic",
                            "lightglue", "dense"])
    p.add_argument("--lg_ckpt", default=None,
                   help=".npz LightGlue checkpoint for --matcher lightglue")
    p.add_argument("--lg_threshold", type=float, default=0.0,
                   help="LightGlue match filter threshold")
    p.add_argument("--lg_width", type=float, default=-1.0,
                   help="LightGlue width pruning confidence, e.g. 0.99 (<= 0 "
                        "off; static-bucket compaction, "
                        "matching/width_pruning.py)")
    p.add_argument("--offline", action="store_true",
                   help="sequence-level offline VO (vo/offline.py): one "
                        "batched extraction, then the match and pose maps "
                        "over the pairs on the device")
    p.add_argument("--dense_rel_conf", type=float, default=0.1,
                   help="dense matcher: the per-pair threshold rel * "
                        "max(conf); 0 = the absolute 0.05")
    p.add_argument("--device_pose", action="store_true",
                   help="the device RANSAC (pose.ransac_essential_device) "
                        "in place of the host cv2 USAC_MSAC pose tail")
    p.add_argument("--pose_hypotheses", type=int, default=8192,
                   help="device-RANSAC hypotheses a stage")
    p.add_argument("--pose_restarts", type=int, default=3,
                   help="device-RANSAC streams; the largest final "
                        "consensus wins")
    p.add_argument("--semantic_filter", action="store_true")
    p.add_argument("--classes_to_filter", type=int, nargs="+", default=[21])
    p.add_argument("--max_frames", type=int, default=None)
    p.add_argument("--out", default="vo_results.json")
    p.add_argument("--plot", action="store_true",
                   help="save the estimated trajectory plot (needs "
                        "matplotlib)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.plot:
        import importlib.util

        if importlib.util.find_spec("matplotlib") is None:
            raise SystemExit("--plot needs matplotlib, which is not "
                             "installed")
    import torch

    from .configs import get_config
    from .models.kp2dtiny import init_model
    from .utils.device import resolve_device
    from .vo.frontend import KP2DTinyFrontend
    from .vo.visual_odometry import evaluate_visual_odometry

    dev = resolve_device(args.device)
    v3 = args.model_type in ("KP2DtinyV3", "DF")
    cfg = get_config(args.config, v3=v3, n_classes=args.n_classes)
    model = init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    if args.model_path:
        from .utils.torch_import import load_model_weights

        load_model_weights(model, args.model_path)
    H, W = args.im_h, args.im_w
    if args.offline:
        results = offline(args, model, cfg, dev)
    else:
        fe = KP2DTinyFrontend(
            model, cfg, (H, W), nn_thresh=args.nn_thresh, top_k=args.top_k,
            semantic_filter=args.semantic_filter,
            classes_to_filter=args.classes_to_filter,
            with_seg=args.matcher == "semantic", device=dev)
        # --matcher dense: a DenseMatcher on the frontend's model, k=top_k
        results = evaluate_visual_odometry(
            fe, args.kitti_path, args.gt_name, args.video_name,
            new_size=(H, W), max_frames=args.max_frames, verbose=True,
            matcher=args.matcher,
            lightglue=args.lg_ckpt if args.matcher == "lightglue" else None,
            device_pose=args.device_pose,
            dense_rel_conf=args.dense_rel_conf, lg_width=args.lg_width,
            lg_threshold=args.lg_threshold,
            pose_hypotheses=args.pose_hypotheses,
            pose_restarts=args.pose_restarts, device=dev)
    print(json.dumps(results, indent=2, default=str))
    with open(args.out, "w") as f:
        json.dump({"args": vars(args), "results": results}, f, indent=2,
                  default=str)
    if args.plot:
        from .utils.plot import plot_trajectory

        print("trajectory plot written to",
              plot_trajectory(results.get("trajectory", []),
                              path=args.out.replace(".json", "_traj.png")))
    return 0


def offline(args, model, cfg, dev) -> dict:
    """--offline: the offline VO's matchers are dense, bf and lightglue
    (another --matcher falls back to dense); the online-only flags are
    ignored with a warning, as the root vo_eval.py does."""
    from .vo.offline import evaluate_visual_odometry_offline
    from .vo.visual_odometry import load_lightglue_for_vo, read_video

    offline_matchers = ("dense", "bf", "lightglue")
    ignored = []
    if args.matcher not in offline_matchers:
        ignored.append(f"--matcher {args.matcher} (offline VO supports "
                       f"{'/'.join(offline_matchers)}; falling back to "
                       "dense)")
    for flag, default in (("device_pose", False), ("semantic_filter", False),
                          ("lg_width", -1.0)):
        if getattr(args, flag) != default:
            ignored.append(f"--{flag}")
    if args.lg_ckpt and args.matcher != "lightglue":
        ignored.append("--lg_ckpt")
    if ignored:
        print("WARNING: --offline ignores: " + ", ".join(ignored))
    matcher = args.matcher if args.matcher in offline_matchers else "dense"
    lightglue = None
    if matcher == "lightglue":
        if not args.lg_ckpt:
            raise ValueError("--offline --matcher lightglue needs --lg_ckpt")
        # normalised at the video's frame size, as the online loop does
        video = read_video(f"{args.kitti_path}/{args.video_name}")
        h, w = next(video).shape[:2]
        video.close()
        lightglue = load_lightglue_for_vo(args.lg_ckpt, cfg.nfeatures,
                                          (w, h),
                                          threshold=args.lg_threshold)[0]
    return evaluate_visual_odometry_offline(
        model, cfg, args.kitti_path, args.gt_name, args.video_name,
        (args.im_h, args.im_w), max_frames=args.max_frames, verbose=True,
        matcher=matcher, lightglue=lightglue,
        k=min(args.top_k, 1024) if matcher != "dense" else 512,
        dense_rel_conf=args.dense_rel_conf,
        n_hypotheses=args.pose_hypotheses, restarts=args.pose_restarts,
        device=dev)


if __name__ == "__main__":
    sys.exit(main())
