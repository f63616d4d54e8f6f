"""Where the time of the port's paths goes on the card.

    python -m nanovs_slam_torch.profile_slice [--path slice match]
        [--config NAME [--v3] [--depth]] [--dtype bfloat16]
        [--batch 1 8] [--iters 20]

``slice``: serves a KP2DTiny config (default N, V2; 28 classes, seeded
random weights) at 240x320 through ``make_infer_fn(top_k=1000,
conf_threshold=0.7)``, per batch size, and prints the device time of the
top-K's stable sort beside that of ``torch.topk`` on the same scores, and,
where the config has attention, the device time of its attention blocks
(``EfficientSelfAttention``, run alone on the inputs they had in a
request). ``match``: matches one 240x320
pair (seeded random frames) through ``matching.pair.make_pair_matcher``
with the pinned S8 extractor and the pinned kp2dtiny_S LightGlue, at 512
and 1024 keypoints. ``--dtype`` is the extractor's compute dtype (float32
by default; LightGlue stays float32). Each traces ``--iters`` steady calls with
``torch.profiler`` and prints the host ms per call, the device busy share
(the sum of kernel times over the wall time), the device time of cuDNN's
convolutions and of its layout changes, and the kernels with the most
device time. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from .configs import get_config
from .inference import make_infer_fn
from .models.kp2dtiny import init_model

H, W = 240, 320
PINNED = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "pinned")


def device_events(call, iters: int):
    """(device kernel events, host wall ms) of ``iters`` steady calls."""
    for _ in range(5):
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA], wall_ms


def device_ms(events, iters: int) -> float:
    return sum(e.self_device_time_total for e in events) / 1e3 / iters


# device kernels of cuDNN's convolutions, and of its layout changes around
# them, by name
CONV_KERNELS = ("fprop", "winograd", "conv", "fft")
LAYOUT_KERNELS = ("nchwToNhwc", "nhwcToNchw")


def trace(label: str, call, iters: int) -> None:
    events, wall_ms = device_events(call, iters)
    dev_ms = device_ms(events, iters)
    n_kernels = sum(e.count for e in events) / iters
    print(f"{label}: {wall_ms / iters:.3f} ms per call (host), "
          f"device busy {dev_ms:.3f} ms per call "
          f"({100 * dev_ms * iters / wall_ms:.1f}% of wall), "
          f"{n_kernels:.0f} device ops per call")
    for what, keys in (("convolutions", CONV_KERNELS),
                       ("layout changes", LAYOUT_KERNELS)):
        sel = [e for e in events if any(k in e.key for k in keys)]
        ms = device_ms(sel, iters)
        print(f"  {what}: {ms:.3f} ms ({100 * ms / dev_ms:.1f}% of the "
              f"device time), {sum(e.count for e in sel) / iters:.0f} "
              "kernels per call")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3 / iters:8.4f} ms "
              f"x{e.count // iters:<3d} {e.key[:90]}")


def attention_inputs(model, call) -> list:
    """(block, input) of every attention block of ``model`` in one
    ``call``."""
    from .modules.attention import EfficientSelfAttention

    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda m, args: seen.append((m, args[0])))
        for m in model.modules() if isinstance(m, EfficientSelfAttention)]
    try:
        call()
    finally:
        for h in hooks:
            h.remove()
    return seen


def profile_slice(name: str, v3: bool, depth: bool, dtype: str, batches,
                  iters: int, rs) -> None:
    cfg = get_config(name, v3=v3, n_classes=28, depth=depth, dtype=dtype)
    model = init_model(cfg, torch.Generator().manual_seed(0), "cuda")
    infer = make_infer_fn(model, cfg, H, W, top_k=1000, conf_threshold=0.7,
                          device="cuda")
    label = (f"slice {name}{' V3' if v3 else ''}{' depth' if depth else ''}"
             f" {dtype}")
    for b in batches:
        frames = rs.randint(0, 256, (b, H, W, 3)).astype(np.uint8)
        trace(f"{label} B={b}", lambda: infer(frames), iters)
        blocks = attention_inputs(model, lambda: infer(frames))
        if blocks:
            with torch.inference_mode():
                att = device_ms(device_events(
                    lambda: [m(x) for m, x in blocks], iters)[0], iters)
            shapes = ", ".join(f"{x.shape[2]}x{x.shape[3]}" for _, x in blocks)
            print(f"{label} B={b}: attention, {len(blocks)} blocks at "
                  f"{shapes}: {att:.4f} ms device time per request")
        # the top-K's selection (ops/postprocess.top_k_keypoints) against
        # torch.topk, on this request's border-masked scores
        s = infer(frames)["score"].reshape(b, -1)
        sort = device_ms(device_events(lambda: torch.sort(
            s, dim=1, descending=True, stable=True), iters)[0], iters)
        topk = device_ms(device_events(lambda: torch.topk(s, 1000, dim=1),
                                       iters)[0], iters)
        print(f"{label} B={b}: top-K selection over {s.shape[1]} cells, "
              f"stable sort {sort:.4f} ms, torch.topk {topk:.4f} ms "
              f"(device time per request)")


def profile_match(dtype: str, iters: int, rs) -> None:
    from .matching.configs import LIGHTGLUE_CONFIGS
    from .matching.lightglue import LightGlue
    from .matching.pair import make_pair_matcher
    from .utils.checkpoint import load_npz_checkpoint
    from .utils.convert import load_jax_lightglue, load_jax_variables

    tree, _ = load_npz_checkpoint(os.path.join(PINNED, "extractor_S8.npz"))
    cfg = get_config("S", n_classes=8, dtype=dtype)
    ex = init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    load_jax_variables(ex, tree["params"], tree["batch_stats"])
    lg_tree, meta = load_npz_checkpoint(os.path.join(PINNED,
                                                     "lightglue_S.npz"))
    lg = load_jax_lightglue(
        LightGlue(LIGHTGLUE_CONFIGS[meta["config"]["lg_config"]]),
        lg_tree["params"])
    img0, img1 = (rs.uniform(-1, 1, (1, H, W, 3)).astype(np.float32)
                  for _ in range(2))
    for k in (512, 1024):
        match = make_pair_matcher(ex, cfg, lg, H, W, max_keypoints=k,
                                  conf_threshold=0.0, device="cuda")
        trace(f"match K={k} {dtype}", lambda: match(img0, img1), iters)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--path", nargs="+", choices=("slice", "match"),
                    default=["slice", "match"])
    ap.add_argument("--config", default="N",
                    help="the slice's config name (default N)")
    ap.add_argument("--v3", action="store_true",
                    help="the config from the V3 registry")
    ap.add_argument("--depth", action="store_true",
                    help="with the depth head")
    ap.add_argument("--dtype", choices=("float32", "bfloat16"),
                    default="float32", help="the extractor's compute dtype")
    ap.add_argument("--batch", type=int, nargs="+", default=[1, 8])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice needs a CUDA device")
    # float32 as chip_smoke.py times it: no TF32 in cuDNN or matmul
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rs = np.random.RandomState(0)
    if "slice" in args.path:
        profile_slice(args.config, args.v3, args.depth, args.dtype,
                      args.batch, args.iters, rs)
    if "match" in args.path:
        profile_match(args.dtype, args.iters, rs)


if __name__ == "__main__":
    main()
