"""Smoke run of the PyTorch/CUDA port (nanovs_slam_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) on failure:
 1. print the card's name and power limit (nvidia-smi); TF32 off for cuDNN
    and matmul in every comparison;
 2. build the CUDA kernels from nanovs_slam_torch/csrc (nvcc, sm_90a);
 3. kernel phase: each kernel against its plain PyTorch twin on the card at
    the paths' shapes, with CUDA-event medians of the kernel, the twin and,
    where one exists, a library call: the stem, NetVLAD and postprocess
    kernels at the serving slice's shapes (KP2DTiny-N, 240x320) for batch 1
    and 8, the stem at the match path's config S widths (16, 32) and
    NetVLAD at config S's (C=64, K=64), with NetVLAD's device kernels a
    call (one) counted by the profiler; the LightGlue transformer kernel
    (pinned kp2dtiny_S weights) at
    K=512 and K=1024, at M=512/N=384 with padding masks and with a fully
    masked image, with its device kernels broken down by the profiler (4 a
    layer and 1 a call) with programmatic dependent launch off, so that
    the per-launch times do not overlap, and
    one scaled_dot_product_attention call as the attention's yardstick
    (its twin, ~600 launches a call, is timed by the profiler's summed
    device time: more launches than the device queues behind a spin);
 4. slice phase: KP2DTiny-N V2 (28 classes, seeded random weights and BN
    stats) served through make_infer_fn(top_k=1000, conf_threshold=0.7) on
    four uint8 requests (three at batch 1, one at batch 8), with its
    kernels' launch counts read around those requests, and the batch-1
    answer compared with the same model on the CPU;
 5. weights phase: the pinned S8 checkpoint (config S, 8 classes) loaded
    through utils/convert.py answers one 96x128 request, compared with the
    CPU;
 6. match phase: pinned S8 and pinned LightGlue (kp2dtiny_S) match a seeded
    textured 240x320 frame against a homography-warped copy through
    matching.pair.make_pair_matcher(max_keypoints=512), with its kernels'
    launch counts read around the pair; the matches are checked (in range,
    mutual) and compared with the same pipeline on the CPU; prints the
    precision against the homography, and the steady ms per pair and per
    match at K=512 and K=1024;
 7. one JSON line describing each kernel, the card's line before it, and
    as the last line {"ok": true, "device": {...}}. A kernel's unsuffixed
    keys hold the first path that runs it (the N slice, B=1; LightGlue:
    the match path, K=512), ``_b8`` / ``_k1024`` / ``_s`` another size of
    it (``_s``: NetVLAD at config S widths), and
    ``launches_match`` / ``*_match`` the match path where it runs the
    kernel too (its postprocess shapes are the N slice's B=1 ones).

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
TF32_FLOP_PER_S = 495e12  # H100 SXM TF32 tensor cores, dense
H, W = 240, 320
SEED = 0


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, inner: int = 20, trials: int = 15) -> float:
    """Median over ``trials`` of the CUDA-event time of ``inner`` calls,
    per call: the device's time, not the host's. A spin kernel runs first,
    so that the host has queued all ``inner`` calls before the first
    starts; a trial in which the device reached the start event while the
    host was still queueing is dropped and the spin doubled, so that a
    function of many small ops is not timed at the host's launch rate.
    Warm L2: in the slice the producer has just written the inputs."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    spin, times = 5_000_000, []  # ~2.5 ms of clock cycles to start with
    while len(times) < trials:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        for _ in range(inner):
            fn()
        late = start.query()
        end.record()
        end.synchronize()
        if late:  # a full launch queue also blocks the host: give up
            require(spin < 2 ** 30, "cuda_ms: the host never got ahead of "
                    "the device (more launches than the device queues?)")
            spin *= 2
            continue
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
    """(key suffix, name, source, replaces, wrapper, kernel call, plain
    call, library call or None, bytes, flops, check) at the paths' shapes.
    The N slice's shapes fill the unsuffixed keys at B=1 and the ``_b8``
    keys at B=8; the stem at config S widths, the match path's, fills the
    ``_match`` keys (the match path's postprocess has the N slice's B=1
    shapes). Inputs are NHWC views of NCHW memory, as the model hands them
    to the kernels."""
    import torch
    import torch.nn.functional as F

    from nanovs_slam_torch.kernels import (fused_postprocess,
                                           fused_stem_pair_pool, netvlad,
                                           netvlad_plain, postprocess_plain,
                                           stem_plain)

    rs = np.random.RandomState(SEED + B)
    suffix = "" if B == 1 else f"_b{B}"

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

    def stem_case(key, C1, C2):
        """The stem at widths 3 -> C1 -> C2 (N: 16, 24; S: 16, 32)."""
        x = nhwc(rs.uniform(-1, 1, (B, 3, H, W)))
        w1, b1 = t(rs.randn(C1, 3, 3, 3) * 0.2), t(rs.randn(C1) * 0.1)
        w2, b2 = t(rs.randn(C2, C1, 3, 3) * 0.1), t(rs.randn(C2) * 0.1)
        st = (x, w1, b1, w2, b2)

        def check(got, want):
            require(max_err(got, want) <= 1e-4, f"stem {C1}, {C2}")

        def library():  # cuDNN's default: TF32 convolutions
            torch.backends.cudnn.allow_tf32 = True
            try:
                y = F.leaky_relu(F.conv2d(x.permute(0, 3, 1, 2), w1, b1,
                                          padding=1), 0.01)
                y = F.leaky_relu(F.conv2d(y, w2, b2, padding=1), 0.01)
                return F.max_pool2d(y, 2, 2)
            finally:
                torch.backends.cudnn.allow_tf32 = False

        return (key, "fused_stem_pair_pool", "nanovs_slam_torch/csrc/stem.cu",
                "nanovs_slam_tpu/ops/pallas/fused_stem.py:167",
                fused_stem_pair_pool, lambda: fused_stem_pair_pool(*st),
                lambda: stem_plain(*st), library,
                4 * (B * H * W * 3 + C1 * 28 + C2 * (C1 * 9 + 1)
                     + B * (H // 2) * (W // 2) * C2),
                2 * B * H * W * (C1 * 27 + C2 * C1 * 9), check)

    S = Hc * Wc

    def netvlad_case(key, Cv, K):
        """NetVLAD at widths C, K (N: 48, 32; S: 64, 64)."""
        xv = nhwc(rs.randn(B, Cv, Hc, Wc))
        aw, cen = t(rs.randn(Cv, K) * 0.2), t(rs.rand(K, Cv))
        nv = (xv, aw, cen)

        def check(got, want):
            require(max_err(got, want) <= 1e-5, f"netvlad {Cv}, {K}")

        return (key, "netvlad", "nanovs_slam_torch/csrc/netvlad.cu",
                "nanovs_slam_tpu/ops/pallas/netvlad_kernel.py:59",
                netvlad, lambda: netvlad(*nv), lambda: netvlad_plain(*nv),
                None, 4 * (B * S * Cv + 2 * Cv * K + B * K * Cv),
                B * S * (4 * Cv * K + 3 * Cv + 3 * K), check)

    cases = [
        (suffix, "fused_postprocess", "nanovs_slam_torch/csrc/postprocess.cu",
         "nanovs_slam_tpu/ops/pallas/postprocess_kernel.py:104",
         fused_postprocess, lambda: fused_postprocess(*pp),
         lambda: postprocess_plain(*pp), None,
         4 * (B * Hc * Wc * 3 + B * Hf * Wf * C + B * Hc * Wc * (3 + C)),
         B * Hc * Wc * C * 14, pp_check),
        stem_case(suffix, 16, 24),
        netvlad_case(suffix, 48, 32),
    ]
    if B == 1:
        cases += [stem_case("_match", 16, 32), netvlad_case("_s", 64, 64)]
    return cases


def kernel_phase(dev):
    import torch

    results = {}
    for B in (1, 8):
        for (suffix, name, source, replaces, wrapper, run, plain, library,
             nbytes, flops, check) in kernel_cases(B, dev):
            got = run()
            want = plain()
            torch.cuda.synchronize()
            check(got, want)
            err = max_err(got, want)
            ms = cuda_ms(run)
            plain_ms = cuda_ms(plain)
            library_ms = cuda_ms(library) if library is not None else None
            b_ms, b_by = bound(nbytes, flops)
            if name == "netvlad":  # one launch a call
                n_dev, _ = kernels_a_call(run, 1)
                log(f"kernel netvlad{suffix or '_b1'}: {n_dev:g} device "
                    f"kernels a call")
                require(round(n_dev) == 1, f"netvlad: {n_dev} device "
                        f"kernels a call, expected 1")
            log(f"kernel {name}{suffix or '_b1'}: max_abs_err {err:.3g}, "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
                f"{'n/a' if library_ms is None else f'{library_ms:.4f} ms'}"
                f", bound {b_ms:.5f} ms ({b_by})")
            entry = results.setdefault(name, {
                "name": name, "route": "cuda", "source": source,
                "replaces": replaces, "wrapper": wrapper})
            keys = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": library_ms}
            entry.update({k + suffix: v for k, v in keys.items()})
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


# ------------------------------------------------- LightGlue kernel phase

def pinned_lightglue(repo: str):
    """The pinned kp2dtiny_S LightGlue, loaded through utils/convert.py."""
    from nanovs_slam_torch.matching.configs import LIGHTGLUE_CONFIGS
    from nanovs_slam_torch.matching.lightglue import LightGlue
    from nanovs_slam_torch.utils.checkpoint import load_npz_checkpoint
    from nanovs_slam_torch.utils.convert import load_jax_lightglue

    tree, meta = load_npz_checkpoint(
        os.path.join(repo, "pinned", "lightglue_S.npz"))
    cfg = LIGHTGLUE_CONFIGS[meta["config"]["lg_config"]]
    return load_jax_lightglue(LightGlue(cfg), tree["params"]).eval()


def lightglue_args(lg, dev, B, M, N, pad0, pad1, empty1, seed):
    """The wrapper's arguments for a pair of random keypoint sets with
    unit descriptors, embedded by the module on the CPU."""
    import torch

    rs = np.random.RandomState(seed)
    D = lg.cfg.input_dim

    def unit(*shape):
        d = rs.randn(*shape).astype(np.float32)
        return torch.from_numpy(d / np.linalg.norm(d, axis=-1, keepdims=True))

    data = {"keypoints0": torch.from_numpy(
                rs.uniform(-1, 1, (B, M, 2)).astype(np.float32)),
            "keypoints1": torch.from_numpy(
                rs.uniform(-1, 1, (B, N, 2)).astype(np.float32)),
            "descriptors0": unit(B, M, D), "descriptors1": unit(B, N, D)}
    masks = [None, None]
    if pad0 or pad1 or empty1:
        masks = [torch.arange(M)[None].repeat(B, 1) < M - pad0,
                 torch.arange(N)[None].repeat(B, 1) < N - pad1]
        if empty1:
            masks[1][:] = False
    with torch.no_grad():
        d0, d1, enc0, enc1 = lg.embed(data)
    tables = [t[:, 0, :, 0::2].contiguous() for t in (*enc0, *enc1)]
    args = [d0, d1, *tables, *masks, lg.packed_weights()]
    return [None if a is None else a.to(dev) for a in args]


def lightglue_work(B, M, N, D, L, P):
    """(bytes, flops, attention flops) of the stack: inputs read once,
    outputs written once; per layer 38 (M+N) D^2 flops of projections and
    FFNs, and 4 (M^2+N^2) D + 6 M N D of attention."""
    nbytes = 4 * (B * (M + N) * (2 * D + D // 4) + L * P) + B * (M + N)
    attn = B * L * (4 * (M * M + N * N) * D + 6 * M * N * D)
    return nbytes, B * L * 38 * (M + N) * D * D + attn, attn


def bound_3xtf32(nbytes: float, flops: float, attn_flops: float) -> float:
    """The stack's bound with its attention on the tensor cores in 3xTF32
    (three TF32 products a product) and the rest in float32, ms."""
    t_ops = 3 * attn_flops / TF32_FLOP_PER_S + (flops - attn_flops) \
        / FP32_FLOP_PER_S
    return max(nbytes / HBM_BYTES_PER_S, t_ops) * 1e3


def device_breakdown(run, iters: int = 20) -> dict:
    """torch.profiler over ``iters`` calls: {device kernel: (launches per
    call, ms per launch)}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
    return {e.key: (e.count / iters, e.self_device_time_total / e.count / 1e3)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.count}


def kernels_a_call(run, expected: int, windows: int = 5):
    """(device kernels a call, the window's breakdown): the profiler now
    and then loses kernel records (seen on the card with both launch plans,
    never an extra one), so windows are taken until one sees ``expected``
    kernels a call or more."""
    for _ in range(windows):
        parts = device_breakdown(run)
        n = sum(c for c, _ in parts.values())
        if round(n) >= expected:
            break
    return n, parts


def device_sum_ms(run, iters: int = 10) -> float:
    """The summed device time of one call's kernels, by the profiler: for a
    function of more small launches than the device queues behind a spin
    kernel (the LightGlue twin, ~600 a call), where ``cuda_ms`` would time
    the host. Gaps between the kernels are not counted."""
    return sum(n * t for n, t in device_breakdown(run, iters).values())


def lightglue_kernel_phase(dev, repo: str) -> dict:
    import torch
    import torch.nn.functional as F

    from nanovs_slam_torch.kernels.lightglue import (
        HEADS, KERNELS_PER_LAYER, device_kernels, lightglue_transformer,
        lightglue_transformer_plain)

    lg = pinned_lightglue(repo)
    D, L = lg.cfg.descriptor_dim, lg.cfg.n_layers
    P = lg.packed_weights().shape[1]
    log(f"kernel lightglue_transformer: one call enqueues "
        f"{device_kernels(L)} device kernels ({KERNELS_PER_LAYER} a "
        f"layer, {L} layers, and the first layer's self projection)")
    entry = {"name": "lightglue_transformer", "route": "cuda",
             "source": "nanovs_slam_torch/csrc/lightglue.cu",
             "replaces": "nanovs_slam_tpu/ops/pallas/lightglue_kernel.py:265",
             "wrapper": lightglue_transformer}
    cases = [("K512", 512, 512, 0, 0, False),
             ("K1024", 1024, 1024, 0, 0, False),
             ("M512_N384_masked", 512, 384, 51, 154, False),
             ("image1_empty", 512, 384, 0, 0, True)]
    for seed, (tag, M, N, pad0, pad1, empty1) in enumerate(cases):
        args = lightglue_args(lg, dev, 1, M, N, pad0, pad1, empty1,
                              SEED + 400 + seed)
        got = lightglue_transformer(*args)
        want = lightglue_transformer_plain(*args, range(L))
        torch.cuda.synchronize()
        err = max_err(got, want)
        require(err <= 1e-4, f"lightglue_transformer {tag}: max_abs_err {err}")
        require(all(bool(torch.isfinite(g).all()) for g in got),
                f"lightglue_transformer {tag}: not finite")
        if tag not in ("K512", "K1024"):
            log(f"kernel lightglue_transformer {tag}: max_abs_err {err:.3g}")
            entry[f"max_abs_err_{tag}"] = err
            continue
        ms = cuda_ms(lambda: lightglue_transformer(*args), inner=10)
        plain_ms = device_sum_ms(lambda: lightglue_transformer_plain(
            *args, range(L)))
        # yardstick: one SDPA call doing the work of one self-attention
        # launch (both images stacked as a batch)
        g = torch.Generator(device=dev).manual_seed(SEED)
        q, k, v = (torch.randn(2, HEADS, M, D // HEADS, device=dev,
                               generator=g) for _ in range(3))
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v))
        # under programmatic dependent launch a kernel's record starts
        # while it waits for the previous one: the breakdown is read with
        # it off (the same kernels and results, launched in stream order)
        lightglue_transformer.pdl = False
        try:
            per_call, parts = kernels_a_call(
                lambda: lightglue_transformer(*args), device_kernels(L))
        finally:
            lightglue_transformer.pdl = True
        require(round(per_call) == device_kernels(L),
                f"lightglue_transformer {tag}: {per_call} device kernels a "
                f"call, expected {device_kernels(L)}")
        attn = [t for name, (_, t) in parts.items() if "attn_kernel" in name]
        attn_ms = statistics.mean(attn) if attn else None
        work = lightglue_work(1, M, N, D, L, P)
        b_ms, b_by = bound(*work[:2])
        log(f"kernel lightglue_transformer {tag}: max_abs_err {err:.3g}, "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{b_ms:.5f} ms ({b_by}; with the attention in 3xTF32 on the "
            f"tensor cores {bound_3xtf32(*work):.5f} ms); attention launch "
            f"(PDL off) "
            f"{'n/a' if attn_ms is None else f'{attn_ms:.4f} ms'}, sdpa "
            f"{library_ms:.4f} ms")
        log("  per launch, PDL off:")
        for name, (n, t) in sorted(parts.items(), key=lambda kv: -kv[1][1]):
            log(f"  {t:.4f} ms x{n:g} a call  {name[:80]}")
        keys = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
                "attn_launch_ms": attn_ms}  # PDL off: one launch's own time
        suffix = "" if tag == "K512" else "_k1024"
        entry.update({k + suffix: v for k, v in keys.items()})
    entry["library"] = ("torch.nn.functional.scaled_dot_product_attention, "
                        "one call over the two images of one self-attention "
                        "launch; the stack has no single library call")
    return {"lightglue_transformer": entry}


# ---------------------------------------------------------------- match phase

def check_matches(out, K: int) -> None:
    import torch

    for i in (0, 1):
        m, other = out[f"matches{i}"], out[f"matches{1 - i}"]
        require(tuple(m.shape) == (1, K), f"matches{i} shape")
        require(bool(((m >= -1) & (m < K)).all()), f"matches{i} out of range")
        valid = m[0] >= 0
        idx = torch.nonzero(valid)[:, 0]
        require(bool((other[0][m[0][valid]] == idx).all()),
                f"matches{i} not mutual")
        require(bool(torch.isfinite(out[f"matching_scores{i}"]).all()),
                f"matching_scores{i} not finite")


def compare_matches_with_cpu(out, ref) -> dict:
    """matches0 entries that agree between the card and the CPU, with
    keypoints identified by their coordinates (so that a reordering of
    tied top-K scores is no disagreement)."""
    o = {k: v[0].cpu().numpy() for k, v in out.items()}
    r = {k: v[0].numpy() for k, v in ref.items()}

    def index_map(a, b):  # a's keypoint i -> b's within 0.01 px, else -2
        d = np.linalg.norm(a[:, None] - b[None], axis=-1)
        j = d.argmin(1)
        return np.where(d[np.arange(len(a)), j] < 0.01, j, -2)

    map0 = index_map(o["keypoints0"], r["keypoints0"])
    map1 = np.append(index_map(o["keypoints1"], r["keypoints1"]), -1)
    m0 = o["matches0"]
    ok = map0 >= 0
    mapped = np.where(ok, r["matches0"][np.maximum(map0, 0)], -3)
    agree = ok & (map1[m0] == mapped)
    err = np.abs(o["matching_scores0"][agree]
                 - r["matching_scores0"][map0[agree]])
    return {"agree": float(agree.mean()),
            "scores_max_err": float(err.max()) if err.size else 0.0,
            "keypoints_mapped": float(ok.mean())}


def match_phase(dev, repo: str, kernels) -> dict:
    import torch

    from nanovs_slam_torch.configs import get_config
    from nanovs_slam_torch.kernels import reset_launches
    from nanovs_slam_torch.matching.extractor import (
        gt_matches_from_homography, make_extractor)
    from nanovs_slam_torch.matching.lightglue import normalize_keypoints
    from nanovs_slam_torch.matching.pair import make_pair_matcher
    from nanovs_slam_torch.matching.synthetic import (HOMOGRAPHY,
                                                      textured_frame,
                                                      warp_frame)
    from nanovs_slam_torch.models.kp2dtiny import init_model
    from nanovs_slam_torch.utils.checkpoint import load_npz_checkpoint
    from nanovs_slam_torch.utils.convert import load_jax_variables

    tree, _ = load_npz_checkpoint(
        os.path.join(repo, "pinned", "extractor_S8.npz"))
    cfg = get_config("S", n_classes=8)
    ex = init_model(cfg, torch.Generator().manual_seed(SEED), "cpu")
    load_jax_variables(ex, tree["params"], tree["batch_stats"])
    lg = pinned_lightglue(repo)
    cpu_ex, cpu_lg = copy.deepcopy(ex), copy.deepcopy(lg)
    img0 = textured_frame(H, W, SEED + 300)
    img1 = warp_frame(img0, HOMOGRAPHY)
    x0, x1 = img0[None] * 2 - 1, img1[None] * 2 - 1
    K = 512
    match = make_pair_matcher(ex, cfg, lg, H, W, max_keypoints=K,
                              conf_threshold=0.0, device=dev)

    reset_launches()
    out = match(x0, x1)
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in kernels}
    log(f"match: launches during one pair {launches}")
    for name, n in launches.items():
        require(n > 0, f"kernel {name} was not launched on the match path")
    check_matches(out, K)
    ref = make_pair_matcher(cpu_ex, cfg, cpu_lg, H, W, max_keypoints=K,
                            conf_threshold=0.0, device="cpu")(x0, x1)
    cmp = compare_matches_with_cpu(out, ref)
    log(f"match: vs CPU {json.dumps(cmp)}")
    require(cmp["agree"] >= 0.999, f"matches0 agree with the CPU on "
            f"{cmp['agree']:.4f} of the entries")
    require(cmp["scores_max_err"] <= 1e-4,
            f"matching_scores0 vs CPU {cmp['scores_max_err']}")
    m0 = out["matches0"][0].cpu().numpy()
    _, gt0, _ = gt_matches_from_homography(
        out["keypoints0"][0].cpu().numpy(), out["keypoints1"][0].cpu().numpy(),
        HOMOGRAPHY, out["mask0"][0].cpu().numpy(),
        out["mask1"][0].cpu().numpy(), th=3.0)
    n_match = int((m0 > -1).sum())
    precision = float((m0[m0 > -1] == gt0[m0 > -1]).mean()) if n_match \
        else float("nan")
    log(f"match: {n_match} matches of {K} keypoints, precision "
        f"{precision:.4f} against the homography (3 px)")

    def host_ms(fn, n=30):
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times[5:])

    timing = {}
    for k in (512, 1024):
        pair = make_pair_matcher(ex, cfg, lg, H, W, max_keypoints=k,
                                 conf_threshold=0.0, device=dev)
        extract = make_extractor(ex, cfg, H, W, max_keypoints=k,
                                 conf_threshold=0.0, device=dev)
        e0, e1 = extract(x0), extract(x1)
        data = {"keypoints0": normalize_keypoints(e0["keypoints"], (W, H)),
                "keypoints1": normalize_keypoints(e1["keypoints"], (W, H)),
                "descriptors0": e0["descriptors"],
                "descriptors1": e1["descriptors"],
                "mask0": e0["mask"], "mask1": e1["mask"]}
        with torch.inference_mode():
            timing[k] = {"pair_ms": host_ms(lambda: pair(x0, x1)),
                         "match_ms": host_ms(lambda: lg(data))}
    log("match: steady-state median ms (host clock, synchronised) "
        + ", ".join(f"K={k}: per pair {t['pair_ms']:.3f}, match only "
                    f"{t['match_ms']:.3f}" for k, t in timing.items()))
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    from nanovs_slam_torch.kernels import (KERNELS, _build, fused_postprocess,
                                           fused_stem_pair_pool,
                                           lightglue_transformer, netvlad)

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
    kernels.update(lightglue_kernel_phase(dev, repo))
    paths = {"n_slice": slice_phase(dev, (fused_postprocess,
                                          fused_stem_pair_pool, netvlad))[0]}
    weights_phase(dev, repo)
    paths["match"] = match_phase(dev, repo, (fused_postprocess,
                                             fused_stem_pair_pool,
                                             lightglue_transformer))

    lines = []
    for entry in kernels.values():
        # `launches` is the count of the first path that runs the kernel,
        # whose shapes its unsuffixed keys carry; a later path's count goes
        # under `launches_<path>`, beside that path's `_<path>` keys
        name = entry.pop("wrapper").__name__
        first, *rest = [p for p in paths if name in paths[p]]
        entry["path"] = first
        entry["launches"] = paths[first][name]
        entry.update({f"launches_{p}": paths[p][name] for p in rest})
        lines.append(entry)
    require({k.__name__ for k in KERNELS} == set(kernels),
            "a kernel of KERNELS has no line")
    print(f"{card}")
    print(json.dumps({"kernels": lines}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
