"""Export CLI of the port, the counterpart of the JAX package's root
``export_model.py``:

    python -m nanovs_slam_torch.export_model [--config S]
        [--model_type KP2DtinyV2|KP2DtinyV3|DF] [--n_classes 28]
        [--model_path CK.npz] [--im_h 240] [--im_w 320] [--to_mcu]
        [--to_export] [--format pt2|int8|mcu] [--out exported_model]
        [--calib_images 8] [--device cuda]

``pt2``: the inference program (outputs score, coord, feat, vlad, seg) as
a ``torch.export`` program, ``<out>.pt2`` (the JAX CLI writes StableHLO).
``int8``: per-output-channel int8 weights pickled as the JAX CLI pickles
them (``{"qparams", "batch_stats", "config"}``, flax layout),
``<out>.int8.pkl``. ``mcu``: the ``.nvsb`` bundle of the MCU graph
(requires ``--to_mcu``), int8 where ``--calib_images`` seeded uniform
images calibrate the score/loc/desc convs on ``--device`` (default cuda;
``--device cpu`` without a card), ``<out>.nvsb``. The weights are seeded
(``init_model``, seed 0) or the ``--model_path`` checkpoint's (an .npz or
a reference PyTorch .ckpt).
``--format stablehlo`` and ``savedmodel`` exit: they are the JAX
package's formats, and this package writes ``pt2``.
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Export KP2DTiny (PyTorch "
                                "port)")
    p.add_argument("--config", default="S")
    p.add_argument("--model_type", default="KP2DtinyV2",
                   choices=["KP2DtinyV2", "KP2DtinyV3", "DF"])
    p.add_argument("--n_classes", type=int, default=28)
    p.add_argument("--model_path", default=None,
                   help=".npz checkpoint or reference torch .ckpt")
    p.add_argument("--im_h", type=int, default=240)
    p.add_argument("--im_w", type=int, default=320)
    p.add_argument("--to_mcu", action="store_true")
    p.add_argument("--to_export", action="store_true",
                   help="strip the NetVLAD aggregation (reference contract)")
    p.add_argument("--format", default="pt2",
                   choices=["pt2", "int8", "mcu", "stablehlo",
                            "savedmodel"])
    p.add_argument("--out", default="exported_model")
    p.add_argument("--calib_images", type=int, default=8,
                   help="mcu format: random calibration batches for int8 "
                        "activation scales (0 = float32 bundle)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def build(args):
    """(model on the CPU in eval mode, cfg)."""
    from .configs import get_config
    from .models.kp2dtiny import init_model

    cfg = get_config(args.config, v3=args.model_type in ("KP2DtinyV3", "DF"),
                     n_classes=args.n_classes, to_mcu=args.to_mcu,
                     to_export=args.to_export)
    model = init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    if args.model_path:
        from .utils.torch_import import load_model_weights

        load_model_weights(model, args.model_path)
    return model, cfg


def main(argv=None) -> str:
    args = parse_args(argv)
    if args.format in ("stablehlo", "savedmodel"):
        raise SystemExit(f"--format {args.format}: a JAX / TensorFlow "
                         "artifact; the port exports --format pt2 "
                         "(torch.export), int8 or mcu (ROADMAP Queue 1 "
                         "item 6)")
    if args.format == "mcu" and not args.to_mcu:
        # the bundle's op set is the MCU variant's; a pixelshuffle model
        # has no transposed conv to bundle
        raise SystemExit("--format mcu requires --to_mcu (the bundle "
                         "serializes the convtranspose deploy graph)")
    model, cfg = build(args)
    H, W = args.im_h, args.im_w
    if args.format == "pt2":
        from .export import export_program

        path = export_program(model, cfg, H, W, args.out + ".pt2")
        print(f"torch.export program written to {path} "
              f"({os.path.getsize(path) / 1e6:.2f} MB)")
    elif args.format == "int8":
        from .quant import int8_size_bytes, quantize_params_int8
        from .utils.convert import to_jax_variables

        params, stats = to_jax_variables(model)
        q = quantize_params_int8(params)
        path = args.out + ".int8.pkl"
        with open(path, "wb") as f:
            pickle.dump({"qparams": q, "batch_stats": stats,
                         "config": cfg.name}, f)
        print(f"int8 weights written to {path} "
              f"({int8_size_bytes(q) / 1e6:.2f} MB)")
    else:
        from .deploy import export_mcu_bundle
        from .quant import calibrate_conv_scales
        from .utils.device import resolve_device

        scales = None
        if args.calib_images > 0:
            rs = np.random.RandomState(0)
            batches = [rs.rand(1, H, W, 3).astype(np.float32)
                       for _ in range(args.calib_images)]
            scales = calibrate_conv_scales(
                model.to(resolve_device(args.device)), batches,
                heads=("score", "loc", "desc"))
        path = export_mcu_bundle(model, cfg, args.out + ".nvsb",
                                 scales=scales)
        print(f"MCU bundle written to {path} "
              f"({os.path.getsize(path) / 1e6:.3f} MB, "
              f"{'int8' if scales else 'f32'})")
    return path


if __name__ == "__main__":
    main()
