"""The stem, NetVLAD and the int8 conv of two source trees in turns on one
NVIDIA card.

    python3 tools/stem_turns.py PARENT_DIR CHANGE_DIR [--parts stem,int8,netvlad]

Each directory is a checkout of this repository (for example a commit's
``git archive`` unpacked into a directory that ``.gitignore`` lists). In
the order parent, change, change, parent, a subprocess imports that tree's
``nanovs_slam_torch`` (whose kernels build from its own ``csrc/``) and
``chip_smoke.py`` and measures the parts asked for (``stem`` and
``int8`` by default):

``stem``:

- the stem kernel on 240x320 frames at batch 1 and 8: config D's
  (64, 128) at float32 and bf16 and the narrow bf16 instances, N's
  (16, 24) and S's (16, 32); and the NetVLAD backward at the train shape
  (config S, 4x30x40, C = K = 64) and config N's (1x60x80, 48, 32):
  ``chip_smoke``'s cases (``kernel_cases``: the same seeded inputs and
  checks against the twins), timed by ``chip_smoke.cuda_ms`` (CUDA events
  behind a spin kernel, median of 15);
- one request of config D at float32 and bf16 and one of config N at
  bf16 (V2, 28 classes, seeded weights and BN statistics) through
  ``make_infer_fn``, batch 1 and 8: the host-clock median ms of 20 steady
  requests and the device ms of a request (``chip_smoke.busy_share``,
  torch.profiler);
- one train step of config S (``chip_smoke.train_state``, its fixed
  batch, dropout off): the host-clock median ms of 10 steps and the
  device ms of a step and of its NetVLAD backward kernels (torch.profiler).

``int8``:

- ``int8_conv3x3`` at every one of the int8 S8 request's 23 calls at
  batch 1 and 8 (pinned S8 calibrated as ``chip_smoke.py``'s int8 phase
  does; ``chip_smoke.int8_calls`` on the seeded input of
  ``int8_kernel_cases``), each held to its twin at 0 and timed by
  ``cuda_ms``; the sums over the request, over its float-input calls and
  over its two 120x160x96 calls (the float32 blocks: the control);
- the same at bf16 blocks: pinned S8 at bfloat16 (calibrated at bf16) at
  batch 1 and 8, and config N with 28 classes at bfloat16 (seeded weights
  and BN statistics, calibrated at bf16: ``chip_smoke.int8_bf16_n28``'s
  model) at batch 128, every call held to its twin at 0; the sums over
  each request, over its bf16-input calls and over the calls of each
  design (``launch_shape``'s ``design``; a tree without one has tiles);
- the int8 S8 request (``make_infer_fn(int8_scales=...)``, top_k 1000) at
  batch 1 and 8, float32 and bf16, and the N28 bf16 int8 request at batch
  128: host-clock median ms of 20 steady requests and the device ms of a
  request.

``netvlad``:

- the NetVLAD forward (``netvlad``) and backward (``netvlad_backward``)
  with the vladv2 bias at KeypointFormer's widths (C = 256, K = 64, x as
  NCHW memory): the forward on its head's 33x41 map at batch 1 and 8 and
  at its train shape (4 images of 13x17), the backward at the train
  shape, float32 and bf16; and, as the control that must not move, the
  C <= 128 instances: the forward at config N's (60x80, C = 48, K = 32)
  at batch 1 and 8, config S's (C = K = 64) and KeypointFormer "tiny"'s
  head (33x41, C = 64), the backward at config S's train shape (4x30x40,
  C = K = 64), config N's (1x60x80, C = 48, K = 32) and "tiny"'s train
  shape; each on seeded inputs of its own, held to its twin as
  ``chip_smoke.py`` holds it and timed by ``chip_smoke.cuda_ms``;
- one request of KeypointFormer "default" (28 classes, seeded, its
  scores spread) at 256x320 through ``make_infer_fn`` (top_k 1000) at
  batch 1 and 8, and one train step of it (96x128, batch 4, the
  synthetic set's 8 classes): host-clock median ms, the device ms of a
  request or a step and of its NetVLAD kernels (torch.profiler).

Prints the card's name and power limit, one JSON line a turn, and the
medians of each tree's two turns. It imports neither jax nor
nanovs_slam_tpu.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

CHILD = r"""
import json, statistics, sys, time
sys.path.insert(0, sys.argv[1])
PARTS = sys.argv[2].split(",")
import numpy as np
import torch
import chip_smoke as cs
from nanovs_slam_torch.configs import get_config
from nanovs_slam_torch.inference import make_infer_fn
from nanovs_slam_torch.models.kp2dtiny import build_model, init_model
from nanovs_slam_torch.modules.blocks import set_dropout
from nanovs_slam_torch.train.schedules import DEFAULT_LOSS_WEIGHTS
from nanovs_slam_torch.train.train_step import make_train_step

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")
out = {}


def request_ms(infer, frames, tag):
    times = []
    for _ in range(25):
        t0 = time.perf_counter()
        infer(frames)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    dev_ms, busy = cs.busy_share(lambda: infer(frames))
    out[f"request_{tag}"] = statistics.median(times[5:])
    out[f"request_device_{tag}"] = dev_ms


KEYS = {(cs.STEM_D, ""): "stem_d_float32", (cs.STEM_BF16, "_d"): "stem_d_bf16",
        (cs.STEM_BF16, ""): "stem_n_bf16", (cs.STEM_BF16, "_s"): "stem_s_bf16",
        ("netvlad_backward", ""): "netvlad_bwd_train",
        ("netvlad_backward", "_n"): "netvlad_bwd_n"}
for B in ((1, 8) if "stem" in PARTS else ()):
    b8 = "" if B == 1 else f"_b{B}"
    for c in cs.kernel_cases(B, dev):
        suffix = c.suffix[:-len(b8)] if b8 and c.suffix.endswith(b8) \
            else c.suffix
        key = KEYS.get((c.entry, suffix))
        if key is None or (B != 1 and c.entry == "netvlad_backward"):
            continue
        got, want = c.run(), c.plain()
        torch.cuda.synchronize()
        c.check(got, want)
        out[f"kernel_{key}" + ("" if c.entry == "netvlad_backward"
                               else f"_B{B}")] = cs.cuda_ms(c.run)
rs = np.random.RandomState(cs.SEED + 1300)
for name in (("D", "N") if "stem" in PARTS else ()):
    gen = torch.Generator().manual_seed(cs.SEED + 1300)
    cfg32 = get_config(name, n_classes=28)
    cfg16 = get_config(name, n_classes=28, dtype="bfloat16")
    model32 = init_model(cfg32, gen, "cpu")
    cs.randomize_bn(model32, gen)
    model16 = build_model(cfg16).eval()
    model16.load_state_dict(model32.state_dict())
    dtypes = (("float32", model32, cfg32), ("bf16", model16, cfg16))
    for B in (1, 8):
        frames = rs.randint(0, 256, (B, cs.H, cs.W, 3)).astype(np.uint8)
        for dt, model, cfg in dtypes[name == "N":]:
            infer = make_infer_fn(model, cfg, cs.H, cs.W, device=dev,
                                  top_k=1000, conf_threshold=0.7)
            request_ms(infer, frames, f"{name}_{dt}_B{B}")
if "int8" in PARTS:
    from nanovs_slam_torch.data.datasets import SyntheticShapesDataset
    from nanovs_slam_torch.kernels import int8_conv3x3, int8_conv3x3_plain
    from nanovs_slam_torch.kernels.int8conv import launch_shape
    from nanovs_slam_torch.quant import calibrate_conv_scales

    # each int8 call of a request of the model at batch B against its
    # twin, timed; the sums
    def int8_times(model, scales, B, tag, runs=(20, 15)):
        rs8 = np.random.RandomState(cs.SEED + 1800 + B)
        x = torch.from_numpy(rs8.uniform(-1, 1, (B, 3, cs.H, cs.W)).astype(
            np.float32)).to(dev)
        sums = {"all": 0.0, "float_in": 0.0, "wide": 0.0}
        for path, args in cs.int8_calls(model, x, scales):
            got, want = int8_conv3x3(*args), int8_conv3x3_plain(*args)
            torch.cuda.synchronize()
            cs.require(cs.max_err(got, want) == 0,
                       f"int8{tag} {path} B={B}")
            ms = cs.cuda_ms(lambda: int8_conv3x3(*args), *runs)
            out[f"int8{tag}_{path}_B{B}"] = ms
            sums["all"] += ms
            if args[0].dtype != torch.int8:
                sums["float_in"] += ms
                if args[0].shape[1:] == (96, 120, 160):
                    sums["wide"] += ms
            design = launch_shape(args[0], args[1].shape[0], args[7],
                                  args[8], args[9]).get("design", "tiles")
            sums[design] = sums.get(design, 0.0) + ms
        for k, v in sums.items():
            out[f"int8{tag}_sum_{k}_B{B}"] = v

    model, cfg = cs.int8_pinned(sys.argv[1], dev)
    calib = SyntheticShapesDataset((cs.H, cs.W), cs.INT8_CALIB, 8, seed=3)
    scales = calibrate_conv_scales(
        model, [calib[i]["image"][None] * 2.0 - 1.0
                for i in range(cs.INT8_CALIB)])
    for B in (1, 8):
        int8_times(model, scales, B, "")
    model16, cfg16 = cs.int8_pinned(sys.argv[1], dev, "bfloat16")
    scales16 = cs.int8_calibrate(model16, 8)
    for B in (1, 8):
        int8_times(model16, scales16, B, "_bf16")
    cfg_n32 = get_config("N", n_classes=28)
    cfg_n = get_config("N", n_classes=28, dtype="bfloat16")
    gen = torch.Generator().manual_seed(cs.SEED + 2200)
    model_n32 = init_model(cfg_n32, gen, "cpu")
    cs.randomize_bn(model_n32, gen)
    model_n = build_model(cfg_n)
    model_n.load_state_dict(model_n32.state_dict())
    model_n = model_n.to(dev).eval()
    del model_n32
    scales_n = cs.int8_calibrate(model_n, 28)
    int8_times(model_n, scales_n, 128, "_n28_bf16", runs=(5, 7))
    rs8 = np.random.RandomState(cs.SEED + 1900)
    for tag, m, c, sc in (("S8_int8", model, cfg, scales),
                          ("S8_bf16_int8", model16, cfg16, scales16)):
        infer = make_infer_fn(m, c, cs.H, cs.W, top_k=1000, device=dev,
                              int8_scales=sc)
        for B in (1, 8):
            frames = rs8.randint(0, 256, (B, cs.H, cs.W, 3)).astype(
                np.uint8)
            request_ms(infer, frames, f"{tag}_B{B}")
    frames = np.random.RandomState(cs.SEED + 2201).randint(
        0, 256, (128, cs.H, cs.W, 3)).astype(np.uint8)
    infer = make_infer_fn(model_n, cfg_n, cs.H, cs.W, top_k=1000,
                          device=dev, int8_scales=scales_n)
    request_ms(infer, frames, "N28_bf16_int8_B128")
if "netvlad" in PARTS:
    from nanovs_slam_torch.kernels import (netvlad, netvlad_backward,
                                           netvlad_backward_plain,
                                           netvlad_plain, netvlad_residuals)
    from nanovs_slam_torch.ops.image import to_model_input

    def nv_inputs(seed, B, h, w, C, K, bf16):
        r = np.random.RandomState(seed)
        x = torch.from_numpy(r.randn(B, C, h, w).astype(np.float32)).to(
            dev).permute(0, 2, 3, 1)
        if bf16:
            x = x.to(torch.bfloat16)
        f = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
        return (x, f(r.randn(C, K) * 0.3), f(r.rand(K, C)),
                f(r.randn(K) * 0.5), f(r.randn(B, K * C)))

    for i, (key, B, h, w, C, K, bias) in enumerate((
            ("fwd_kf_B1", 1, 33, 41, 256, 64, True),
            ("fwd_kf_B8", 8, 33, 41, 256, 64, True),
            ("fwd_kf_train", 4, 13, 17, 256, 64, True),
            ("fwd_n_B1", 1, 60, 80, 48, 32, False),
            ("fwd_n_B8", 8, 60, 80, 48, 32, False),
            ("fwd_s_B1", 1, 60, 80, 64, 64, False),
            ("fwd_kf_tiny_B1", 1, 33, 41, 64, 64, True))):
        for bf in (False, True):
            x, aw, cen, b, _ = nv_inputs(cs.SEED + 2100 + i, B, h, w, C, K,
                                         bf)
            args = (x, aw, cen) + ((b,) if bias else ())
            got, want = netvlad(*args), netvlad_plain(*args)
            torch.cuda.synchronize()
            cs.require(cs.max_err(got, want) <= 1e-5, f"netvlad {key}")
            out["kernel_nv_" + key + ("_bf16" if bf else "")] = cs.cuda_ms(
                lambda: netvlad(*args))
    for i, (key, B, h, w, C, K, bias) in enumerate((
            ("bwd_kf_train", 4, 13, 17, 256, 64, True),
            ("bwd_s_train", 4, 30, 40, 64, 64, False),
            ("bwd_n", 1, 60, 80, 48, 32, False),
            ("bwd_kf_tiny_train", 4, 13, 17, 64, 64, True))):
        for bf in (False, True):
            x, aw, cen, b, gy = nv_inputs(cs.SEED + 2200 + i, B, h, w, C, K,
                                          bf)
            bb = (b,) if bias else ()
            _, u, m = netvlad_residuals(x, aw, cen, *bb)
            got = netvlad_backward(gy, x, aw, cen, u, m, *bb)
            want = netvlad_backward_plain(gy, x, aw, cen, *bb)
            torch.cuda.synchronize()
            for j, (g, w_) in enumerate(zip(got, want)):
                if bf and j == 0:
                    cs.require(cs.bf16_ulps(g, w_) <= 2.0, f"{key} dx")
                    continue
                if j == 3:  # db against its terms' size (dl sums to 0)
                    b_full = b.expand(B, h * w, K).clone().requires_grad_()
                    with torch.enable_grad():
                        dl, = torch.autograd.grad(
                            netvlad_plain(x, aw, cen, b_full), b_full, gy)
                    scale = float(dl.abs().sum((0, 1)).max())
                else:
                    scale = float(w_.abs().max())
                cs.require(cs.max_err(g, w_) <= (1e-4 if bf else 1e-5)
                           * scale, f"{key} gradient {j}")
            again = netvlad_backward(gy, x, aw, cen, u, m, *bb)
            cs.require(all(torch.equal(p, q) for p, q in
                           zip(got[1:], again[1:])), f"{key} bits")
            out["kernel_nv_" + key + ("_bf16" if bf else "")] = cs.cuda_ms(
                lambda: netvlad_backward(gy, x, aw, cen, u, m, *bb))

    def nv_device(run, iters=10):
        parts = cs.device_breakdown(run, iters)
        return (sum(n * t for n, t in parts.values()),
                sum(n * t for k, (n, t) in parts.items() if "netvlad" in k))

    cfg, model = cs.kf_model("default", cs.SEED + 2300)
    h, w = cs.KF_HW
    rs2 = np.random.RandomState(cs.SEED + 2300)
    frames = {b: rs2.randint(0, 256, (b, h, w, 3)).astype(np.uint8)
              for b in (1, 8)}
    cs.kf_spread_scores(model, to_model_input(torch.from_numpy(frames[1])))
    infer = make_infer_fn(model, cfg, h, w, device=dev, top_k=1000,
                          conf_threshold=0.7)
    for b in (1, 8):
        request_ms(infer, frames[b], f"KF_default_B{b}")
        out[f"request_device_KF_default_B{b}"], \
            out[f"request_device_netvlad_KF_default_B{b}"] = nv_device(
                lambda: infer(frames[b]))
    kcfg, kstate = cs.kf_train_state("default", dev)
    kstep = make_train_step(kcfg, *cs.KF_TRAIN_HW, io_top_k=300)
    kbatch = {k: v.to(dev) for k, v in
              cs.kf_train_batch(cs.SEED + 1900).items()}
    times = []
    for _ in range(15):
        t0 = time.perf_counter()
        kstep(kstate, kbatch, DEFAULT_LOSS_WEIGHTS)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    out["kf_train_step"] = statistics.median(times[5:])
    out["kf_train_step_device"], out["kf_train_step_device_netvlad"] = \
        nv_device(lambda: kstep(kstate, kbatch, DEFAULT_LOSS_WEIGHTS))
if "stem" not in PARTS:
    print(json.dumps(out))
    sys.exit(0)
cfg, state = cs.train_state(dev)
set_dropout(state.model, rate=0.0)
step = make_train_step(cfg, *cs.TRAIN_HW, io_top_k=300)
batch = {k: v.to(dev) for k, v in cs.train_batch(cs.SEED).items()}
times = []
for _ in range(15):
    t0 = time.perf_counter()
    step(state, batch, DEFAULT_LOSS_WEIGHTS)
    torch.cuda.synchronize()
    times.append((time.perf_counter() - t0) * 1e3)
parts = cs.device_breakdown(lambda: step(state, batch, DEFAULT_LOSS_WEIGHTS),
                            10)
out["train_step"] = statistics.median(times[5:])
out["train_step_device"] = sum(n * t for n, t in parts.values())
out["train_step_device_netvlad_bwd"] = sum(
    n * t for k, (n, t) in parts.items() if "netvlad_bwd" in k)
print(json.dumps(out))
"""


def turn(tree: str, parts: str) -> dict:
    env = dict(os.environ, PYTHONPATH=tree)
    r = subprocess.run([sys.executable, "-c", CHILD, tree, parts], env=env,
                       cwd=tree, capture_output=True, text=True)
    if r.returncode != 0:
        raise SystemExit(f"{tree}: rc {r.returncode}\n{r.stdout[-4000:]}\n"
                         f"{r.stderr[-4000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def main(argv) -> int:
    parts = "stem,int8"
    if len(argv) == 4 and argv[2] == "--parts":
        parts, argv = argv[3], argv[:2]
    if len(argv) != 2 or not set(parts.split(",")) <= {"stem", "int8",
                                                       "netvlad"}:
        print(__doc__, file=sys.stderr)
        return 2
    trees = {"parent": os.path.abspath(argv[0]),
             "change": os.path.abspath(argv[1])}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    runs = {"parent": [], "change": []}
    for name in ("parent", "change", "change", "parent"):
        res = turn(trees[name], parts)
        runs[name].append(res)
        print(json.dumps({"turn": name, **res}), flush=True)
    summary = {name: {k: statistics.median(r[k] for r in rs)
                      for k in rs[0]} for name, rs in runs.items()}
    print(json.dumps({"medians": summary, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
