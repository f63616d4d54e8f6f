"""Smoke run of the PyTorch/CUDA port (nanovs_slam_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) on failure:
 1. print the card's name and power limit (nvidia-smi); TF32 off for cuDNN
    and matmul in every comparison;
 2. build the CUDA kernels from nanovs_slam_torch/csrc (nvcc, sm_90a);
 3. kernel phase: each kernel against its plain PyTorch twin on the card at
    the serving slice's shapes (KP2DTiny-N, 240x320) for batch 1 and 8,
    with CUDA-event medians of the kernel, the twin and, where one exists,
    a library call computing the same function;
 4. slice phase: KP2DTiny-N V2 (28 classes, seeded random weights and BN
    stats) served through make_infer_fn(top_k=1000, conf_threshold=0.7) on
    four uint8 requests (three at batch 1, one at batch 8), with every
    kernel's launch count read around those requests, and the batch-1
    answer compared with the same model on the CPU;
 5. weights phase: the pinned S8 checkpoint (config S, 8 classes) loaded
    through utils/convert.py answers one 96x128 request, compared with the
    CPU;
 6. one JSON line describing each kernel, the card's line before it, and
    as the last line {"ok": true, "device": {...}}.

It exits non-zero, printing no result, when torch.cuda.is_available() is
false. It imports neither jax nor nanovs_slam_tpu.
"""

from __future__ import annotations

import copy
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_FLOP_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
H, W = 240, 320
SEED = 0


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, inner: int = 20, trials: int = 15) -> float:
    """Median over ``trials`` of the CUDA-event time of ``inner`` calls,
    per call: the device's time, not the host's. A spin kernel of a few
    milliseconds runs first, so that the host has queued all ``inner``
    calls before the first starts. Warm L2: in the slice the producer has
    just written the inputs."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(5_000_000)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    import torch

    if isinstance(a, (tuple, list)):
        return max(max_err(x, y) for x, y in zip(a, b))
    return float(torch.max(torch.abs(a - b)).item())


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# --------------------------------------------------------------- kernel phase

def kernel_cases(B: int, dev):
    """(name, kernel call, plain call, library call or None, bytes, flops,
    check) at the slice's shapes. Inputs are NHWC views of NCHW memory, as
    the model hands them to the kernels."""
    import torch
    import torch.nn.functional as F

    from nanovs_slam_torch.kernels import (fused_postprocess,
                                           fused_stem_pair_pool, netvlad,
                                           netvlad_plain, postprocess_plain,
                                           stem_plain)

    rs = np.random.RandomState(SEED + B)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    def nhwc(a):  # NCHW memory, NHWC shape
        return t(a).permute(0, 2, 3, 1)

    cell, C = 4, 32
    Hc, Wc, Hf, Wf = H // cell, W // cell, H // 2, W // 2
    score = nhwc(rs.rand(B, 1, Hc, Wc))
    shift = nhwc(rs.uniform(-1, 1, (B, 2, Hc, Wc)))
    feat = nhwc(rs.randn(B, C, Hf, Wf))
    pp = (score, shift, feat, H, W, cell, 2.0)

    def pp_check(got, want):
        require(max_err(got[0], want[0]) <= 1e-5, "postprocess score")
        require(max_err(got[1], want[1]) <= 1e-5, "postprocess coord")
        cos = (got[2] * want[2]).sum(-1).min().item()
        require(cos > 0.99999, f"postprocess descriptor cosine {cos}")

    x = nhwc(rs.uniform(-1, 1, (B, 3, H, W)))
    C1, C2 = 16, 24
    w1, b1 = t(rs.randn(C1, 3, 3, 3) * 0.2), t(rs.randn(C1) * 0.1)
    w2, b2 = t(rs.randn(C2, C1, 3, 3) * 0.1), t(rs.randn(C2) * 0.1)
    st = (x, w1, b1, w2, b2)

    def st_check(got, want):
        require(max_err(got, want) <= 1e-4, "stem")

    def st_library():  # cuDNN's default: TF32 convolutions
        torch.backends.cudnn.allow_tf32 = True
        try:
            y = F.leaky_relu(F.conv2d(x.permute(0, 3, 1, 2), w1, b1,
                                      padding=1), 0.01)
            y = F.leaky_relu(F.conv2d(y, w2, b2, padding=1), 0.01)
            return F.max_pool2d(y, 2, 2)
        finally:
            torch.backends.cudnn.allow_tf32 = False

    K, Cv = 32, 48
    S = Hc * Wc
    xv = nhwc(rs.randn(B, Cv, Hc, Wc))
    aw, cen = t(rs.randn(Cv, K) * 0.2), t(rs.rand(K, Cv))
    nv = (xv, aw, cen)

    def nv_check(got, want):
        require(max_err(got, want) <= 1e-5, "netvlad")

    return [
        ("fused_postprocess", "nanovs_slam_torch/csrc/postprocess.cu",
         "nanovs_slam_tpu/ops/pallas/postprocess_kernel.py:104",
         fused_postprocess, lambda: fused_postprocess(*pp),
         lambda: postprocess_plain(*pp), None,
         4 * (B * Hc * Wc * 3 + B * Hf * Wf * C + B * Hc * Wc * (3 + C)),
         B * Hc * Wc * C * 14, pp_check),
        ("fused_stem_pair_pool", "nanovs_slam_torch/csrc/stem.cu",
         "nanovs_slam_tpu/ops/pallas/fused_stem.py:167",
         fused_stem_pair_pool, lambda: fused_stem_pair_pool(*st),
         lambda: stem_plain(*st), st_library,
         4 * (B * H * W * 3 + C1 * 28 + C2 * (C1 * 9 + 1)
              + B * (H // 2) * (W // 2) * C2),
         2 * B * H * W * (C1 * 27 + C2 * C1 * 9), st_check),
        ("netvlad", "nanovs_slam_torch/csrc/netvlad.cu",
         "nanovs_slam_tpu/ops/pallas/netvlad_kernel.py:59",
         netvlad, lambda: netvlad(*nv), lambda: netvlad_plain(*nv), None,
         4 * (B * S * Cv + 2 * Cv * K + B * K * Cv),
         B * S * (4 * Cv * K + 3 * Cv + 3 * K), nv_check),
    ]


def kernel_phase(dev):
    import torch

    results = {}
    for B in (1, 8):
        for (name, source, replaces, wrapper, run, plain, library, nbytes,
             flops, check) in kernel_cases(B, dev):
            got = run()
            want = plain()
            torch.cuda.synchronize()
            check(got, want)
            err = max_err(got, want)
            ms = cuda_ms(run)
            plain_ms = cuda_ms(plain)
            library_ms = cuda_ms(library) if library is not None else None
            b_ms, b_by = bound(nbytes, flops)
            log(f"kernel {name} B={B}: max_abs_err {err:.3g}, kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library "
                f"{'n/a' if library_ms is None else f'{library_ms:.4f} ms'}"
                f", bound {b_ms:.5f} ms ({b_by})")
            entry = results.setdefault(name, {
                "name": name, "route": "cuda", "source": source,
                "replaces": replaces, "wrapper": wrapper})
            keys = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": library_ms}
            if B == 1:
                entry.update(keys)
            else:
                entry.update({f"{k}_b{B}": v for k, v in keys.items()})
    return results


# ---------------------------------------------------------------- slice phase

def randomize_bn(model, gen) -> None:
    """Random BN affine parameters and running stats, so that the stem's
    BN folding changes the weights."""
    import torch

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.weight.copy_(1.0 + 0.1 * torch.randn(n, generator=gen))
                m.bias.copy_(0.1 * torch.randn(n, generator=gen))
                m.running_mean.copy_(0.1 * torch.randn(n, generator=gen))
                m.running_var.copy_(0.5 + torch.rand(n, generator=gen))


def check_answer(out, B, h, w, cfg, top_k) -> None:
    import torch

    hc, wc = h // cfg.cell, w // cfg.cell
    top_k = min(top_k, hc * wc)
    shapes = {"score": (B, hc, wc, 1), "coord": (B, hc, wc, 2),
              "feat": (B, hc, wc, cfg.nfeatures),
              "seg": (B, 2 * hc, 2 * wc, 1), "vlad": (B, cfg.global_desc_dim),
              "keypoints": (B, top_k, 2), "keypoint_scores": (B, top_k),
              "descriptors": (B, top_k, cfg.nfeatures),
              "keypoint_valid": (B, top_k)}
    for k, shape in shapes.items():
        require(tuple(out[k].shape) == shape,
                f"{k} shape {tuple(out[k].shape)} != {shape}")
        if out[k].is_floating_point():
            require(bool(torch.isfinite(out[k]).all()), f"{k} not finite")
    for k in ("feat", "descriptors"):
        n = torch.linalg.vector_norm(out[k], dim=-1)
        require(float((n - 1).abs().max()) < 1e-3, f"{k} norms not 1")
    kp = out["keypoints"]
    require(bool(((kp[..., 0] >= 0) & (kp[..., 0] <= w - 1)
                  & (kp[..., 1] >= 0) & (kp[..., 1] <= h - 1)).all()),
            "keypoints out of bounds")
    seg = out["seg"]
    require(bool(((seg >= 0) & (seg < cfg.n_classes)).all()),
            "seg classes out of range")


def compare_with_cpu(out, ref) -> dict:
    o = {k: v.cpu() for k, v in out.items()}
    errs = {"score": max_err(o["score"], ref["score"]),
            "coord": max_err(o["coord"], ref["coord"]),
            "vlad": max_err(o["vlad"], ref["vlad"]),
            "feat_cos_min": float((o["feat"] * ref["feat"]).sum(-1).min()),
            "seg_agree": float((o["seg"] == ref["seg"]).float().mean())}
    require(errs["score"] <= 1e-4, f"score vs CPU {errs['score']}")
    require(errs["coord"] <= 1e-4, f"coord vs CPU {errs['coord']}")
    require(errs["vlad"] <= 1e-4, f"vlad vs CPU {errs['vlad']}")
    require(errs["feat_cos_min"] > 0.9999,
            f"descriptor cosine vs CPU {errs['feat_cos_min']}")
    require(errs["seg_agree"] >= 0.999, f"seg agreement {errs['seg_agree']}")
    return errs


def slice_phase(dev, kernels):
    import torch

    from nanovs_slam_torch.configs import get_config
    from nanovs_slam_torch.inference import make_infer_fn
    from nanovs_slam_torch.kernels import reset_launches
    from nanovs_slam_torch.models.kp2dtiny import init_model
    from nanovs_slam_torch.ops.image import to_model_input

    cfg = get_config("N", n_classes=28)
    gen = torch.Generator().manual_seed(SEED)
    model = init_model(cfg, gen, "cpu")
    randomize_bn(model, gen)
    rs = np.random.RandomState(SEED + 100)
    requests = [rs.randint(0, 256, (b, H, W, 3)).astype(np.uint8)
                for b in (1, 1, 1, 8)]
    with torch.no_grad():
        # random weights put every score within a few hundredths of one
        # value; spread the score logits and shift them so that a tenth
        # of the cells of a frame (480, under top_k) pass the 0.7
        # threshold: the threshold and the top-K both select
        head = model.score_head.convDb
        head.weight.mul_(10.0)
        head.bias.zero_()
        x = to_model_input(torch.from_numpy(requests[0])).permute(0, 3, 1, 2)
        z = model.score_head(model.backbone(x)[0])
        head.bias.fill_(math.log(0.7 / 0.3) - float(torch.quantile(z, 0.9)))
    cpu_model = copy.deepcopy(model)
    top_k = 1000
    infer = make_infer_fn(model, cfg, H, W, top_k=top_k, conf_threshold=0.7,
                          device=dev)

    reset_launches()
    answers, req_ms = [], []
    for frames in requests:
        t0 = time.perf_counter()
        out = infer(frames)
        torch.cuda.synchronize()
        req_ms.append((time.perf_counter() - t0) * 1e3)
        answers.append(out)
    launches = {k.__name__: k.launches for k in kernels}
    log(f"slice: launches during the 4 requests {launches}")
    for name, n in launches.items():
        require(n > 0, f"kernel {name} was not launched on the main path")
    log("slice: ms per request (first call included) "
        + ", ".join(f"B={len(f)}: {ms:.2f}" for f, ms in
                    zip(requests, req_ms)))
    for frames, out in zip(requests, answers):
        check_answer(out, len(frames), H, W, cfg, top_k)
    ref = make_infer_fn(cpu_model, cfg, H, W, top_k=top_k,
                        conf_threshold=0.7, device="cpu")(requests[0])
    errs = compare_with_cpu(answers[0], ref)
    log(f"slice: B=1 vs CPU {json.dumps(errs)}")
    n_valid = [int(a["keypoint_valid"].sum()) for a in answers]
    log(f"slice: valid keypoints per request {n_valid} (CPU, first "
        f"request: {int(ref['keypoint_valid'].sum())})")
    require(min(n_valid) > 0, "a request has no valid keypoint")

    steady = {}
    for b in (1, 8):
        frames = requests[0] if b == 1 else requests[3]
        times = []
        for _ in range(30):
            t0 = time.perf_counter()
            infer(frames)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        steady[b] = statistics.median(times[5:])
    log("slice: steady-state median ms per request "
        + ", ".join(f"B={b}: {ms:.3f}" for b, ms in steady.items()))
    return launches, steady


# -------------------------------------------------------------- weights phase

def weights_phase(dev, repo: str) -> None:
    import torch

    from nanovs_slam_torch.configs import get_config
    from nanovs_slam_torch.inference import make_infer_fn
    from nanovs_slam_torch.models.kp2dtiny import init_model
    from nanovs_slam_torch.utils.checkpoint import load_npz_checkpoint
    from nanovs_slam_torch.utils.convert import load_jax_variables

    tree, meta = load_npz_checkpoint(
        os.path.join(repo, "pinned", "extractor_S8.npz"))
    cfg = get_config("S", n_classes=8)
    model = init_model(cfg, torch.Generator().manual_seed(SEED), "cpu")
    load_jax_variables(model, tree["params"], tree["batch_stats"])
    cpu_model = copy.deepcopy(model)
    h, w = meta["config"]["size"]
    frames = np.random.RandomState(SEED + 200).randint(
        0, 256, (1, h, w, 3)).astype(np.uint8)
    out = make_infer_fn(model, cfg, h, w, top_k=300, conf_threshold=0.7,
                        device=dev)(frames)
    torch.cuda.synchronize()
    check_answer(out, 1, h, w, cfg, 300)
    ref = make_infer_fn(cpu_model, cfg, h, w, top_k=300, conf_threshold=0.7,
                        device="cpu")(frames)
    errs = compare_with_cpu(out, ref)
    log(f"weights: pinned S8 at {h}x{w}, "
        f"{int(out['keypoint_valid'].sum())} valid keypoints, vs CPU "
        f"{json.dumps(errs)}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    from nanovs_slam_torch.kernels import KERNELS, _build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(card)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("tf32: off for cuDNN and matmul in every comparison")
    log(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    _build.load_library()
    log(f"build: {time.perf_counter() - t0:.1f} s"
        + ("" if _build.build_seconds is None else " (nvcc ran)"))
    if _build.build_log:
        for line in _build.build_log.splitlines():
            if "registers" in line or "spill" in line or line.startswith("=="):
                log("ptxas: " + line.strip())

    kernels = kernel_phase(dev)
    launches, _ = slice_phase(dev, KERNELS)
    weights_phase(dev, repo)

    lines = []
    for entry in kernels.values():
        wrapper = entry.pop("wrapper")
        entry["launches"] = launches[wrapper.__name__]
        lines.append(entry)
    print(f"{card}")
    print(json.dumps({"kernels": lines}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
