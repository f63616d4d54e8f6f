"""Keypoint, descriptor and segmentation inference on images or a video,
drawn, with the port (the counterpart of the root ``demo.py``):

    python -m nanovs_slam_torch.demo --input PATH [--model_path CK]
        [--config N] [--model_type KP2DtinyV2] [--n_classes 28]
        [--im_h 240] [--im_w 320] [--top_k 1000] [--conf 0.7]
        [--out_dir demo_out] [--video_out OUT.mp4] [--max_frames 50]
        [--tracks] [--device cuda]

``--input`` is an image, a folder of images (in name order) or a video
(.mp4 / .avi). Each frame goes through ``vo.frontend.KP2DTinyFrontend``
with the segmentation head on ``--device`` (default cuda); its top-K
keypoints above ``--conf`` are drawn on the frame (or, with ``--tracks``,
the frame-to-frame match tracks of ``vo.visual_odometry.VisualOdometry``,
a focal length of the frame width), stacked over the class map in cv2's
JET colours, and written as ``<out_dir>/frame_NNNN.png`` or as frames of
``--video_out``. The weights are seeded (``init_model``, seed 0) or the
``--model_path`` checkpoint's (an .npz or a reference PyTorch .ckpt).
Reading and drawing need cv2.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--input", required=True,
                   help="image file, folder of images, or video")
    p.add_argument("--model_path", default=None,
                   help=".npz checkpoint or reference torch .ckpt")
    p.add_argument("--config", default="N")
    p.add_argument("--model_type", default="KP2DtinyV2")
    p.add_argument("--n_classes", type=int, default=28)
    p.add_argument("--im_h", type=int, default=240)
    p.add_argument("--im_w", type=int, default=320)
    p.add_argument("--top_k", type=int, default=1000)
    p.add_argument("--conf", type=float, default=0.7)
    p.add_argument("--out_dir", default="demo_out")
    p.add_argument("--video_out", default=None,
                   help="write an mp4 of the overlays instead of PNGs")
    p.add_argument("--max_frames", type=int, default=50)
    p.add_argument("--tracks", action="store_true",
                   help="draw frame-to-frame match tracks instead of bare "
                        "keypoints")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def read_frames(path: str):
    """The BGR uint8 frames of an image, a folder of images or a video."""
    import cv2

    if os.path.isdir(path):
        return (cv2.imread(f) for f in sorted(glob.glob(
            os.path.join(path, "*"))))
    if path.endswith((".mp4", ".avi")):
        from .vo.visual_odometry import read_video

        return read_video(path)
    return iter([cv2.imread(path)])


def main(argv=None) -> int:
    import cv2
    import torch

    from .configs import get_config
    from .models.kp2dtiny import init_model
    from .utils.device import resolve_device
    from .vo.frontend import KP2DTinyFrontend

    args = parse_args(argv)
    dev = resolve_device(args.device)
    H, W = args.im_h, args.im_w
    cfg = get_config(args.config, n_classes=args.n_classes,
                     v3=args.model_type in ("KP2DtinyV3", "DF"))
    model = init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    if args.model_path:
        from .utils.torch_import import load_model_weights

        load_model_weights(model, args.model_path)
    fe = KP2DTinyFrontend(model, cfg, (H, W), nn_thresh=args.conf,
                          top_k=args.top_k, with_seg=True, device=dev)
    vo = None
    if args.tracks:
        from .vo.camera import PinholeCamera
        from .vo.visual_odometry import VisualOdometry

        vo = VisualOdometry(fe, PinholeCamera(W, H, W, W, W / 2, H / 2),
                            device=dev)

    os.makedirs(args.out_dir, exist_ok=True)
    writer = None
    for i, frame in enumerate(read_frames(args.input)):
        if frame is None or i >= args.max_frames:
            break
        vis = cv2.resize(frame, (W, H))
        img01 = cv2.cvtColor(vis, cv2.COLOR_BGR2RGB).astype(np.float32) / 255
        if vo is not None:
            if i == 0:
                vo.init(img01)
            else:
                vo.process_image(img01)
                vis = vo.draw_feature_tracks(vis)
            pts = vo.kps_prev
            seg = np.zeros((H, W), np.uint8)
        else:
            pts, _, out = fe.run(img01)
            for x, y in pts.astype(int):
                cv2.circle(vis, (int(x), int(y)), 2, (0, 0, 255), -1)
            seg = out["seg"][0, :, :, 0].astype(np.uint8)
        seg_vis = cv2.applyColorMap(
            (seg * (255 // max(args.n_classes - 1, 1))).astype(np.uint8),
            cv2.COLORMAP_JET)
        seg_vis = cv2.resize(seg_vis, (W, H),
                             interpolation=cv2.INTER_NEAREST)
        combined = np.vstack([vis, seg_vis])
        if args.video_out:
            if writer is None:
                writer = cv2.VideoWriter(
                    args.video_out, cv2.VideoWriter_fourcc(*"mp4v"), 10,
                    (combined.shape[1], combined.shape[0]))
            writer.write(combined)
            print(f"frame {i}: {len(pts)} keypoints")
        else:
            out_path = os.path.join(args.out_dir, f"frame_{i:04d}.png")
            cv2.imwrite(out_path, combined)
            print(f"{out_path}: {len(pts)} keypoints")
    if writer is not None:
        writer.release()
        print(f"video written to {args.video_out}")
    print("done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
