"""ONNX export CLI of the port, the counterpart of the JAX package's root
``export_onnx.py``, with its flags and defaults:

    python -m nanovs_slam_torch.export_onnx [--config S] [--im_h 120]
        [--im_w 160] [--n_classes 28]
        [--model_type KP2Dtiny|KP2DtinyV3|KeypointFormer]
        [--model_path ./checkpoints] [--weight_path CK.npz]
        [--to_mcu True] [--to_export True] [--depth]

It writes ``<model_path>/<model_type>_<config>.onnx`` (KeypointFormer:
``KeypointFormer.onnx``): opset 16, input "image" (1, 3, H, W), outputs
score, coord, desc, vlad, seg (+ depth), from the port's own modules
(``export.export_onnx``, traced on the CPU). The weights are seeded
(``init_model``, seed 0) or the ``--weight_path`` checkpoint's (.npz).
KeypointFormer takes ``--config`` where it names one of its configs, else
"default" (the reference's rule).
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import torch


def parse_args(argv=None):
    def flag(s):
        return s not in ("0", "False", "false")

    p = argparse.ArgumentParser(description="Export ONNX model (PyTorch "
                                "port)")
    p.add_argument("--config", type=str, default="S")
    p.add_argument("--im_h", type=int, default=120)
    p.add_argument("--im_w", type=int, default=160)
    p.add_argument("--n_classes", type=int, default=28)
    p.add_argument("--model_type", type=str, default="KP2Dtiny",
                   choices=["KP2Dtiny", "KP2DtinyV3", "KeypointFormer"])
    p.add_argument("--model_path", type=str, default="./checkpoints",
                   help="output directory")
    p.add_argument("--weight_path", type=str, default=None,
                   help=".npz checkpoint (seeded weights if absent)")
    p.add_argument("--to_mcu", default=True, type=flag)
    p.add_argument("--to_export", default=True, type=flag)
    p.add_argument("--depth", action="store_true")
    return p.parse_args(argv)


def main(argv=None) -> str:
    from .export import export_onnx

    args = parse_args(argv)
    gen = torch.Generator().manual_seed(0)
    if args.model_type == "KeypointFormer":
        from .models.keypoint_former import KEYPOINTFORMER_CONFIGS, init_model

        cfg = dataclasses.replace(
            KEYPOINTFORMER_CONFIGS.get(args.config,
                                       KEYPOINTFORMER_CONFIGS["default"]),
            n_classes=args.n_classes)
        name = "KeypointFormer.onnx"
    else:
        from .configs import get_config
        from .models.kp2dtiny import init_model

        cfg = get_config(args.config, v3=args.model_type == "KP2DtinyV3",
                         n_classes=args.n_classes, to_mcu=args.to_mcu,
                         to_export=args.to_export, depth=args.depth)
        name = f"{args.model_type}_{args.config}.onnx"
    model = init_model(cfg, gen, "cpu")
    if args.weight_path:
        from .utils.checkpoint import load_npz_checkpoint
        from .utils.convert import load_jax_variables

        tree, _ = load_npz_checkpoint(args.weight_path)
        load_jax_variables(model, tree["params"], tree["batch_stats"])
    os.makedirs(args.model_path, exist_ok=True)
    out = export_onnx(model, os.path.join(args.model_path, name), args.im_h,
                      args.im_w)
    print(f"Model exported to {out}")
    return out


if __name__ == "__main__":
    main()
