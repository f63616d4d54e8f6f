"""Where the serving slice's time goes on the card.

    python -m nanovs_slam_torch.profile_slice [--batch 1 8] [--iters 20]

Serves KP2DTiny-N (28 classes, seeded random weights) at 240x320 through
``make_infer_fn(top_k=1000, conf_threshold=0.7)`` and traces ``--iters``
steady requests per batch size with ``torch.profiler``. Prints, per batch
size, the host ms per request, the device busy share (the sum of kernel
times over the wall time) and the kernels with the most device time.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from .configs import get_config
from .inference import make_infer_fn
from .models.kp2dtiny import init_model

H, W = 240, 320


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[1, 8])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice needs a CUDA device")
    # float32 as chip_smoke.py times it: no TF32 in cuDNN or matmul
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("N", n_classes=28)
    model = init_model(cfg, torch.Generator().manual_seed(0), "cuda")
    infer = make_infer_fn(model, cfg, H, W, top_k=1000, conf_threshold=0.7,
                          device="cuda")
    rs = np.random.RandomState(0)
    for b in args.batch:
        frames = rs.randint(0, 256, (b, H, W, 3)).astype(np.uint8)
        for _ in range(5):
            infer(frames)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(args.iters):
                infer(frames)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        dev_ms = sum(e.self_device_time_total for e in events) / 1e3
        n_kernels = sum(e.count for e in events) / args.iters
        print(f"B={b}: {wall_ms / args.iters:.3f} ms per request (host), "
              f"device busy {dev_ms / args.iters:.3f} ms per request "
              f"({100 * dev_ms / wall_ms:.1f}% of wall), "
              f"{n_kernels:.0f} device ops per request")
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
            print(f"  {e.self_device_time_total / 1e3 / args.iters:8.4f} ms "
                  f"x{e.count // args.iters:<3d} {e.key[:90]}")


if __name__ == "__main__":
    main()
