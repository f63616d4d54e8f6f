"""LightGlue training CLI of the port, the counterpart of the JAX package's
root ``train_lightglue.py``, with its flags and defaults:

    python -m nanovs_slam_torch.train_lightglue [--device cuda]
        [--extractor_config N] [--extractor_path EX.npz] [--n_classes 28]
        [--lg_config kp2dtiny_S] [--dataset synthetic|DIR] [--im_h 120]
        [--im_w 160] [--max_keypoints 256] [--batch_size 2] [--lr 1e-4]
        [--n_steps 1000] [--seed 0] [--out_model_path lightglue_ckpt]
        [--log_every 50] [--save_every 1000]

A step: images (the synthetic shapes, or an image folder read with cv2)
and a random homography each (``sample_homography`` on a numpy
``RandomState(seed)``), the bilinear warp on the device, the frozen
KP2DTiny extractor on both (``matching/extractor.make_extractor``: the stem
and postprocess kernels on the card), the ground-truth assignment of the
fixed-K keypoints (``gt_matches_from_homography`` at 3 px, with the
normalised-to-pixel homography S Hn^-1 S^-1), then the mean over the
layers of ``nll_loss(...).mean()`` (gamma 1, no confidence term, as the
JAX CLI's step) and Adam at ``--lr``. The matcher's stack runs through its
plain blocks under autograd (``LightGlue.forward(train=True)``).

The extractor is seeded (``models/kp2dtiny.init_model``) or
``--extractor_path``'s ``.npz`` or reference PyTorch ``.ckpt``
(``utils/torch_import.load_model_weights``). The matcher is PyTorch's
initialisation drawn from ``--seed``: the weights differ from the JAX CLI's ``jax.random``
draw, so a run differs from the JAX CLI's unless the weights are carried
across. The trained matcher is written as ``<out_model_path>.npz``,
``{"params": ...}`` in flax names (``utils/convert.to_jax_lightglue``)
with the flags in its meta, which ``vo_eval --lg_ckpt`` and the JAX
``load_checkpoint`` read.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import os
import sys
from typing import Dict, Tuple

import numpy as np
import torch

Tensor = torch.Tensor


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train LightGlue on KP2DTiny "
                                "descriptors (PyTorch port)")
    p.add_argument("--extractor_config", default="N")
    p.add_argument("--extractor_path", default=None,
                   help="KP2DTiny .npz or reference torch .ckpt")
    p.add_argument("--n_classes", type=int, default=28)
    p.add_argument("--lg_config", default="kp2dtiny_S",
                   help="LightGlue config name (matching/configs.py)")
    p.add_argument("--dataset", default="synthetic",
                   help="'synthetic' or an image folder")
    p.add_argument("--im_h", type=int, default=120)
    p.add_argument("--im_w", type=int, default=160)
    p.add_argument("--max_keypoints", type=int, default=256)
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--n_steps", type=int, default=1000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out_model_path", default="lightglue_ckpt")
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--save_every", type=int, default=1000,
                   help="periodic checkpoint cadence in steps (0 = only "
                        "at the end)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def build_extractor(args, dev):
    """(KP2DTiny model on ``dev``, its config): seeded, or the
    ``--extractor_path`` checkpoint's."""
    from .configs import get_config
    from .models.kp2dtiny import init_model

    cfg = get_config(args.extractor_config, n_classes=args.n_classes)
    model = init_model(cfg, torch.Generator().manual_seed(args.seed), "cpu")
    if args.extractor_path:
        from .utils.torch_import import load_model_weights

        load_model_weights(model, args.extractor_path)
    return model.to(dev).eval(), cfg


def build_matcher(lg_config: str, nfeatures: int, seed: int, dev):
    """LightGlue of ``lg_config`` at the extractor's descriptor width, with
    PyTorch's initialisation drawn from ``seed`` (the global generator is
    left as it was)."""
    from .matching.configs import LIGHTGLUE_CONFIGS
    from .matching.lightglue import LightGlue

    cfg = LIGHTGLUE_CONFIGS[lg_config]
    if cfg.input_dim != nfeatures:
        cfg = dataclasses.replace(cfg, input_dim=nfeatures,
                                  descriptor_dim=nfeatures)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        matcher = LightGlue(cfg)
    return matcher.to(dev).train()


def image_source(args):
    """i -> (H, W, 3) float32 image in [0, 1]."""
    H, W = args.im_h, args.im_w
    if args.dataset == "synthetic":
        from .data.datasets import SyntheticShapesDataset

        dataset = SyntheticShapesDataset((H, W), 256, 8, seed=args.seed)
        return lambda i: dataset[i % len(dataset)]["image"]
    try:
        import cv2
    except ImportError as e:
        raise ImportError("an image folder is read with cv2, which is not "
                          "installed") from e
    files = sorted(glob.glob(os.path.join(args.dataset, "*")))
    if not files:
        raise SystemExit(f"no images in {args.dataset}")

    def get_image(i):
        img = cv2.cvtColor(cv2.imread(files[i % len(files)]),
                           cv2.COLOR_BGR2RGB)
        return cv2.resize(img, (W, H)).astype(np.float32) / 255.0

    return get_image


def pixel_homography(Hn: np.ndarray, H: int, W: int) -> np.ndarray:
    """The sampling homography in normalised coords -> the point transfer
    from the image to its warp in pixels, S Hn^-1 S^-1 (the JAX CLI's)."""
    S = np.array([[(W - 1) / 2, 0, (W - 1) / 2],
                  [0, (H - 1) / 2, (H - 1) / 2],
                  [0, 0, 1]], np.float64)
    return S @ np.linalg.inv(np.asarray(Hn, np.float64)) @ np.linalg.inv(S)


def make_batch_fn(args, extract, get_image, rs: np.random.RandomState, dev):
    """step -> (data, gt): the JAX CLI's ``make_batch``. The extractor's
    outputs are copied out of inference mode, so that autograd may save
    them."""
    from .data.homography import homography_warp_image, sample_homography
    from .matching.extractor import gt_matches_from_homography
    from .matching.lightglue import normalize_keypoints

    H, W, B = args.im_h, args.im_w, args.batch_size

    def make_batch(step: int) -> Tuple[Dict[str, Tensor], Dict[str, Tensor]]:
        imgs = np.stack([get_image(step * B + b) for b in range(B)])
        homos = np.stack([sample_homography((H, W), rs)
                          for _ in range(B)]).astype(np.float32)
        imgs_t = torch.from_numpy(np.ascontiguousarray(imgs,
                                                       np.float32)).to(dev)
        warped = homography_warp_image(imgs_t, torch.from_numpy(homos).to(
            dev), mode="bilinear")
        e0 = {k: v.clone() for k, v in extract(imgs_t * 2 - 1).items()}
        e1 = {k: v.clone() for k, v in extract(warped * 2 - 1).items()}
        kp0, kp1 = e0["keypoints"].cpu().numpy(), e1["keypoints"].cpu().numpy()
        m0, m1 = e0["mask"].cpu().numpy(), e1["mask"].cpu().numpy()
        gt = [gt_matches_from_homography(kp0[b], kp1[b],
                                         pixel_homography(homos[b], H, W),
                                         m0[b], m1[b], th=3.0)
              for b in range(B)]
        data = {"keypoints0": normalize_keypoints(e0["keypoints"], (W, H)),
                "keypoints1": normalize_keypoints(e1["keypoints"], (W, H)),
                "descriptors0": e0["descriptors"],
                "descriptors1": e1["descriptors"],
                "mask0": e0["mask"], "mask1": e1["mask"]}
        gt = {k: torch.from_numpy(np.stack([g[i] for g in gt])).to(dev)
              for i, k in enumerate(("gt_assignment", "gt_matches0",
                                     "gt_matches1"))}
        return data, gt

    return make_batch


def loss_fn(matcher, data: Dict[str, Tensor], gt: Dict[str, Tensor]):
    """(loss, pred): the mean over the layers of each layer's mean NLL
    (gamma 1, no confidence term), the JAX CLI's ``loss_fn``."""
    from .matching.loss import gt_weights_from_matches, nll_loss

    pred = matcher(data, train=True)
    weights = gt_weights_from_matches(pred["log_assignment"].shape,
                                      gt["gt_assignment"], gt["gt_matches0"],
                                      gt["gt_matches1"])
    la = pred["all_log_assignments"]
    n_layers = la.shape[1]
    total = sum(nll_loss(la[:, i], weights)[0].mean()
                for i in range(n_layers))
    return total / n_layers, pred


def make_optimizer(matcher, lr: float) -> torch.optim.Optimizer:
    """``optax.adam(lr)``: Adam with its defaults."""
    return torch.optim.Adam(matcher.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8)


def train_step(matcher, optimizer, data, gt):
    """One step in place; returns (loss, pred), both detached."""
    optimizer.zero_grad(set_to_none=True)
    loss, pred = loss_fn(matcher, data, gt)
    loss.backward()
    optimizer.step()
    return loss.detach(), {k: v.detach() for k, v in pred.items()}


def save(path: str, matcher, args) -> str:
    """``{"params": ...}`` in flax names, the flags in the meta."""
    from .utils.checkpoint import _write
    from .utils.convert import to_jax_lightglue

    return _write(path, {"params": to_jax_lightglue(matcher)},
                  {"config": vars(args)})


def main(argv=None) -> int:
    from .matching.extractor import make_extractor
    from .matching.loss import matcher_metrics
    from .utils.device import resolve_device

    args = parse_args(argv)
    dev = resolve_device(args.device)
    H, W = args.im_h, args.im_w
    rs = np.random.RandomState(args.seed)
    ex_model, cfg = build_extractor(args, dev)
    extract = make_extractor(ex_model, cfg, H, W,
                             max_keypoints=args.max_keypoints, device=dev)
    matcher = build_matcher(args.lg_config, cfg.nfeatures, args.seed, dev)
    optimizer = make_optimizer(matcher, args.lr)
    make_batch = make_batch_fn(args, extract, image_source(args), rs, dev)

    for step in range(args.n_steps):
        data, gt = make_batch(step)
        loss, pred = train_step(matcher, optimizer, data, gt)
        if step % args.log_every == 0:
            m = matcher_metrics(pred["matches0"], gt["gt_matches0"],
                                pred["matching_scores0"])
            print(f"step {step}: nll {float(loss):.4f} "
                  f"recall {float(m['match_recall'].mean()):.3f} "
                  f"precision {float(m['match_precision'].mean()):.3f}",
                  flush=True)
        if args.save_every and step and step % args.save_every == 0:
            save(args.out_model_path, matcher, args)
    path = save(args.out_model_path, matcher, args)
    print(f"saved LightGlue to {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
