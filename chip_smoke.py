"""Smoke run of the PyTorch/CUDA port (nanovs_slam_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) on failure:
 1. print the card's name and power limit (nvidia-smi); TF32 off for cuDNN
    and matmul in every comparison;
 2. build the CUDA kernels from nanovs_slam_torch/csrc (nvcc, sm_90a);
 3. kernel phase: each kernel against its plain PyTorch twin on the card at
    the paths' shapes, with CUDA-event medians of the kernel, the twin and,
    where one exists, a library call, and the least time for the work
    (bytes at 3.35 TB/s or operations at 67 TFLOP/s float32; the stem's
    operations at the 3xTF32 rate of the tensor cores, its float32 bound
    printed beside): the stem, NetVLAD and postprocess kernels at the
    serving slice's shapes (KP2DTiny-N, 240x320) for batch 1 and 8, the
    stem at config S widths (16, 32) and NetVLAD at config S's (C=64,
    K=64) (the match path's and the V3 S_A cell's; batch 8 only the
    latter's), the stem at config D's (64, 128) (an entry of its own in
    the kernels line) and the postprocess at config D's C=128, both for
    batch 1 and 8, each case's device kernels a call counted by the
    profiler (one; two for the stem at (64, 128), whose weights a kernel
    of their own splits and packs first), every stem case also bit for
    bit across two launches, and the stem at an odd frame
    size (241x321, floor pooling) at all three widths (an entry of its
    own); the LightGlue transformer kernel (pinned kp2dtiny_S weights, and
    config "default": D = 256, 9 layers, seeded weights, an entry of its
    own) at K=512 and K=1024, at
    M=512/N=384 with padding masks and with a fully masked image, with its
    device kernels broken down by the profiler (4 a layer and 1 a call)
    with programmatic dependent launch off, so that the per-launch times
    do not overlap (the mean row-stage and attention launch logged by
    name), and one scaled_dot_product_attention call as the attention's
    yardstick (its twin, ~600 launches a call, is timed by the profiler's
    summed device time: more launches than the device queues behind a
    spin); its bound is the least of three (all in float32 on the CUDA
    cores, the attention in 3xTF32, all in 3xTF32 on the tensor cores),
    the last; at D = 256 also the launch plan as the card takes it (grid,
    cluster, shared memory, occupancy; held to the design: 128 or more
    row-stage blocks at K = 512 in clusters of 4, the tiled row stage at
    K = 1024, two or more attention blocks an SM), the weights' TF32
    fragments (``split_weights``, an entry of its own: bit for bit against
    their plain layout, their one-time cost), and a float32 torch.matmul
    of fc1's shape ((M+N, 2D) x (2D, 2D), TF32 off) as the row stage's
    cuBLAS yardstick (``row_library_ms``); and the bfloat16
    instances against their bf16 twins at
    the bf16 cells' shapes, batch 1 and 8: the stem at (16, 24), (16, 32)
    and (64, 128) within one bf16 ulp (library: cuDNN's bf16 chain; bound
    at bf16 bytes and 989 TFLOP/s), the postprocess at C = 32 and 128 and
    NetVLAD at (48, 32) and (64, 64) within 1e-5 (bf16 inputs read, float32
    computed: bound at those bytes and the float32 rate);
 4. slice phase: KP2DTiny-N V2 (28 classes, seeded random weights and BN
    stats) served through make_infer_fn(top_k=1000, conf_threshold=0.7) on
    four uint8 requests (three at batch 1, one at batch 8), with its
    kernels' launch counts read around those requests, and the batch-1
    answer compared with the same model on the CPU;
 4b. bf16 phase: KP2DTiny-N as __graft_entry__.entry() runs it (28
    classes, dtype bfloat16, top_k 1000, conf 0.7), V3 S_A and V2 D, each
    at batch 1 and 8: the bf16 kernels launched once a request (and no
    float32 instance), the batch-1 answer held against the CPU's bf16
    answer relative to the card's float32 answer (the criteria of
    tests/test_torch_port_bf16.py), and the steady ms per request and
    device busy share at bf16 and float32, in turns;
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
 7. odd request: KP2DTiny-N at 241x321 (the stem pools with floor) through
    make_infer_fn, against the CPU;
 8. LightGlue default: one match of the "default" config (D = 256, 9
    layers, seeded weights) on the card against the CPU (the module makes
    the weights' fragments once, at its first match), and the steady ms
    of a default match through the module at K = 512 and 1024;
 9. vo phase: a corridor rendered on the card (KITTI's camera, 8 frames of
    forward motion with a small yaw) through the pinned S8 frontend at
    128x512 and nanovs_slam_torch.vo.visual_odometry.run_visual_odometry
    (the loop of the VO CLI) with the host BF matcher and with pinned
    LightGlue, both with the device RANSAC: every frame's features and
    every pair's BF matches against the CPU's, one pair's RANSAC on the
    card against the CPU under the same injected noise, the kernels'
    launch counts (stem and postprocess on every frame, LightGlue on every
    pair), no failed estimate; the error statistics beside the CPU's run
    and the ms per frame of extraction, matching and pose; the native BF
    matcher is required (its build messages printed); then VO-BF again with
    the extractor at bf16 and uint8 frames: the bf16 kernels on every
    frame, no failed estimate, the errors beside the float32 run's;
 10. family phase: V3 S_A (decoder fusion, attention, NetVLAD) and V2 D
    (attention, ConvAP, the stem at (64, 128)), 28 classes, seeded random
    weights and BN stats, served at 240x320 like the slice phase at batch
    1 and 8: the launch counts of the kernels on each path (one a
    request), the batch-1 answer against the CPU and the steady median ms
    per request; then one batch-1 request each of V2 N_A with depth, V2
    GEM_N and V3 D_A with depth, against the CPU, depth included (atol
    1e-4);
 11. dense VO phases on the vo phase's corridor (pinned S8, 128x512):
    VO-dense-128x512, the online VO with the dense matcher (k = top_k =
    4000, device RANSAC 8192 x 3): the stem on every frame, no failed
    estimate, every pair's kept matches against the CPU's, the errors
    beside the CPU run's and the ms a frame of extraction, match and pose;
    VO-offline-{dense,bf,lg}-128x512, vo.offline.OfflineVO.relative_poses
    over the 8 frames (one batch of 16 padded frames; k = 512 dense, 1024
    BF and LightGlue): the launch counts, finite poses and >= 8 matches a
    pair, the match map against the CPU's, the errors against the ground
    truth and the ms a sequence and of its extract / match-map / pose-map
    stages; and the kernel phase times the stem and the postprocess at
    that batch (``_vo_b16`` keys);
 12. LightGlue's adaptive paths at K = 1024 on the match phase's pair:
    LG-adaptive-K1024 (AdaptiveLightGlue, depth_confidence 0.95: the exit
    layer, one kernel call a layer) and LG-width-K1024 (width_confidence
    0.99: engaged_width_forward's keep counts and buckets, and
    width_pruned_forward with side 1 floored at 256, so that layers run at
    M != N), each against the CPU on the same inputs and timed beside the
    static forward; the kernel phase holds single-layer calls at (M, N) =
    (512, 256) and (128, 128) against the twin;
 13. train phase: the multitask training path of config S V2 (28
    classes, 120x160, batch 4, Adam 5e-4 on the cosine warm restarts,
    top_k 300; seeded init_model weights and inlier net; a batch of the
    trainer's synthetic fallback data): one train step on the card
    against one on the CPU with dropout at rate 0 on both sides (loss
    terms within 1e-4, grad_norm 1e-4 relative, gradients 5e-2 in
    relative L2, parameters 1e-5 where both gradients are at least 1e-6
    and agree in sign, BN buffers 1e-5: compare_train_steps says why);
    20 steps with dropout on through make_train_step on a fixed batch
    (finite losses; the loss without the gated IO term falls, and so does
    the IO term over the steps where it is open; NetVLAD's forward and
    backward kernels twice a step, the stem and postprocess kernels
    never), the steady ms a step, steps a second, peak memory and the
    device breakdown; then
    ``python -m nanovs_slam_torch.train_multitask --no_eval --n_epochs 1
    --max_steps_per_epoch 5`` in a subprocess on the card, whose .npz
    loads back into the port. The kernel phase holds ``netvlad_backward``
    (three device kernels a call: the images' prologue, the tiles, the
    reduction) against its twin, autograd through
    netvlad_plain, at the train shape (unsuffixed) and config N's
    (``_n``), its dW and dcen equal across two launches;
 14. eval phase: the evaluation path (``evaluation/*`` through
    ``inference.make_eval_fn``, the stem, postprocess and NetVLAD kernels
    once a request, the metric tail in numpy on the host) with pinned S8
    at 240x320 on 8 synthetic homography pairs made on the card by the
    trainer's ``synthetic_homography_pairs``: ``evaluate_keypoint_net``
    at top_k 300 and 1000, ``evaluate_segmentation`` over the 8 images,
    ``evaluate_global_descriptor`` (the originals the database, the warps
    the queries, ``knn_l2`` on the card), held against the same functions
    on the CPU (segmentation, repeatability, localisation error and
    matching score within 1e-3, each correctness threshold equal on 7 or
    more of the 8 pairs, retrieval equal; the largest gaps printed); the
    kernels' launch counts (one of each a request); ms a pair (requests,
    device, the host's tail and its homography estimator), a segmentation
    item and a ``knn_l2``; a seeded config S with depth through
    ``evaluate_depth`` against the CPU (1e-4 relative); then the trainer's
    ``main()`` with its evaluation on (1 epoch of 3 steps, ``--full_eval
    1 --max_eval_items 8``), timed, whose checkpoint must hold
    segmentation, keypoint and retrieval numbers and no error (VO may only
    be skipped for want of cv2);
 15. one JSON line describing each kernel, the card's line before it, and
    as the last line {"ok": true, "device": {...}}. A kernel's unsuffixed
    keys hold the first path that runs it (the N slice, B=1; LightGlue:
    the match path, K=512; the stem at (64, 128): the D cell; the odd
    stem: the odd request; LightGlue at D = 256: its default match),
    ``_b8`` /
    ``_k1024`` / ``_s`` / ``_d`` another size of it (``_s``: config S
    widths; ``_d``: the postprocess at config D's C=128; ``_vo``: the
    VO path's 128x512, config S), and
    ``launches_<path>`` / ``*_match`` a later path that runs the kernel
    too (the match path's postprocess shapes are the N slice's B=1 ones;
    the paths of phases 11 and 12: ``vo_dense``, ``vo_offline_dense``,
    ``vo_offline_bf``, ``vo_offline_lg``, ``lg_adaptive``,
    ``lg_width``, ``train`` and ``eval``; ``netvlad_backward``'s first
    path is ``train``).
    The bfloat16 instances have entries of their own (``*_bf16``, named
    ``...[bf16]``): unsuffixed the N cell's shapes, ``_s`` S_A's, ``_d``
    D's, and ``launches`` the bf16 N cell's.

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
from typing import Callable, NamedTuple

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_FLOP_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
TF32_FLOP_PER_S = 495e12  # H100 SXM TF32 tensor cores, dense
BF16_FLOP_PER_S = 989e12  # H100 SXM bf16 tensor cores, dense
# float32 accuracy on the tensor cores: 3xTF32, three TF32 products a product
TF32_3X_FLOP_PER_S = TF32_FLOP_PER_S / 3
H, W = 240, 320
SEED = 0
# the entry key of the stem at config D's widths, (C1, C2) = (64, 128),
# which has an entry of its own in the kernels line
STEM_D = "fused_stem_pair_pool_d"
# ... and of the stem on odd frame sizes (all three widths), and its size
STEM_ODD = "fused_stem_pair_pool_odd"
ODD_HW = (241, 321)
# the entry key of the LightGlue stack at D = 256 (config "default")
LG_D256 = "lightglue_d256"
# the entry keys of the bfloat16 instances (every width of a kernel under
# one key, as for the float32 instances' suffixes)
STEM_BF16 = "fused_stem_pair_pool_bf16"
# the offline VO extracts its 8 frames padded to one batch of 16
OFFLINE_BATCH = 16
PP_BF16 = "fused_postprocess_bf16"
NV_BF16 = "netvlad_bf16"


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


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


def bound(nbytes: float, flops: float, flop_rate: float = FP32_FLOP_PER_S):
    """(least ms, "bytes" or "operations") for ``nbytes`` moved once and
    ``flops`` done at ``flop_rate`` (float32 on the CUDA cores unless
    given)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    import torch

    if isinstance(a, (tuple, list)):
        return max(max_err(x, y) for x, y in zip(a, b))
    return float(torch.max(torch.abs(a.float() - b.float())).item())


def bf16_ulps(got, want) -> float:
    """max |got - want| in bfloat16 ulps of the output, the ulp of
    max |want|. Not each element's own ulp: a rounding of conv1's
    activation that the sums' order moves by one changes a near-zero
    output by several of its own ulps."""
    import math

    g, w = got.float(), want.float()
    _, e = math.frexp(float(w.abs().max()))
    return float((g - w).abs().max()) / 2.0 ** (e - 8)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# --------------------------------------------------------------- kernel phase

class Case(NamedTuple):
    """One kernel-phase case: ``entry`` is its entry's key in the kernels
    line (and in the paths' launch counts), ``name`` that entry's name,
    ``suffix`` the suffix of its keys there, ``device_kernels`` the device
    kernels one call enqueues, ``plain_inner`` the calls of the twin a
    timed run takes (fewer for a twin of many launches, so that they all
    queue behind the spin)."""
    entry: str
    name: str
    suffix: str
    source: str
    replaces: str
    run: Callable
    plain: Callable
    library: Callable | None
    nbytes: float
    flops: float
    rate: float
    check: Callable
    device_kernels: int = 1
    plain_inner: int = 20


def kernel_cases(B: int, dev) -> list[Case]:
    """The kernel phase's cases at the paths' shapes. The N slice's shapes
    fill the unsuffixed keys at B=1 and the ``_b8`` keys at B=8; the VO
    path's (config S at 128x512) the ``_vo`` keys of the stem and the
    postprocess; the stem
    at config S widths (16, 32) fills the ``_match`` keys at B=1 (the
    match path's, whose postprocess has the N slice's B=1 shapes) and,
    with NetVLAD at config S's (64, 64), the ``_s`` keys (``_s_b8`` at
    B=8: the V3 S_A cell's); the postprocess at config D's C=128 fills the
    ``_d`` / ``_d_b8`` keys; the stem at config D's (64, 128) has an entry
    of its own. Inputs are NHWC views of NCHW memory, as the model hands
    them to the kernels."""
    import torch
    import torch.nn.functional as F

    from nanovs_slam_torch.kernels import (fused_postprocess,
                                           fused_stem_pair_pool, netvlad,
                                           netvlad_backward,
                                           netvlad_backward_plain,
                                           netvlad_plain, netvlad_residuals,
                                           postprocess_plain, stem_plain)

    rs = np.random.RandomState(SEED + B)
    b8 = "" if B == 1 else f"_b{B}"

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    def nhwc(a):  # NCHW memory, NHWC shape
        return t(a).permute(0, 2, 3, 1)

    cell = 4

    def postprocess_case(suffix, C, h=H, w=W, bf16=False):
        """The postprocess with C descriptor channels (N: 32; D: 128) on
        h x w frames; with ``bf16``, bfloat16 inputs (float32 out)."""
        Hc, Wc, Hf, Wf = h // cell, w // cell, h // 2, w // 2
        score = nhwc(rs.rand(B, 1, Hc, Wc))
        shift = nhwc(rs.uniform(-1, 1, (B, 2, Hc, Wc)))
        feat = nhwc(rs.randn(B, C, Hf, Wf))
        nin = 2 if bf16 else 4  # bytes an input element
        if bf16:
            score, shift, feat = (a.to(torch.bfloat16)
                                  for a in (score, shift, feat))
        pp = (score, shift, feat, h, w, cell, 2.0)

        def check(got, want):
            require(max_err(got[0], want[0]) <= 1e-5, f"postprocess {C} score")
            require(max_err(got[1], want[1]) <= 1e-5, f"postprocess {C} coord")
            cos = (got[2] * want[2]).sum(-1).min().item()
            require(cos > 0.99999, f"postprocess {C} descriptor cosine {cos}")

        entry, name = (PP_BF16, "fused_postprocess[bf16]") if bf16 else (
            "fused_postprocess", "fused_postprocess")
        return Case(entry, name, suffix,
                    "nanovs_slam_torch/csrc/postprocess.cu",
                    "nanovs_slam_tpu/ops/pallas/postprocess_kernel.py:104",
                    lambda: fused_postprocess(*pp),
                    lambda: postprocess_plain(*pp), None,
                    nin * (B * Hc * Wc * 3 + B * Hf * Wf * C)
                    + 4 * B * Hc * Wc * (3 + C),
                    B * Hc * Wc * C * 14, FP32_FLOP_PER_S, check)

    def stem_case(suffix, C1, C2, entry="fused_stem_pair_pool",
                  device_kernels=1, h=H, w=W):
        """The stem at widths 3 -> C1 -> C2 (N: 16, 24; S: 16, 32; D: 64,
        128) on h x w frames, conv2's weights at 0.1 for C1 = 16 and
        scaled as 1/sqrt(C1) beyond, so that its outputs keep their
        spread. The entry STEM_BF16 takes a bfloat16 x (the bfloat16
        instances)."""
        bf16 = entry == STEM_BF16
        x = nhwc(rs.uniform(-1, 1, (B, 3, h, w)))
        w1, b1 = t(rs.randn(C1, 3, 3, 3) * 0.2), t(rs.randn(C1) * 0.1)
        w2 = t(rs.randn(C2, C1, 3, 3) * (0.1 * (16 / C1) ** 0.5))
        b2 = t(rs.randn(C2) * 0.1)
        if bf16:
            x = x.to(torch.bfloat16)
        st = (x, w1, b1, w2, b2)

        def check(got, want):
            if bf16:  # one rounding of conv1's activation or of the output
                ulps = bf16_ulps(got, want)
                require(ulps <= 1.0, f"stem[bf16] {C1}, {C2}: {ulps} ulps")
            else:  # 3xTF32 keeps float32 accuracy
                require(max_err(got, want) <= 1e-5, f"stem {C1}, {C2}")
            # no atomics, fixed sum orders: a second launch gives the bits
            require(torch.equal(got, fused_stem_pair_pool(*st)),
                    f"stem {C1}, {C2}: two launches differ")

        lib_w = [a.to(x.dtype) for a in (w1, b1, w2, b2)]

        def library():  # cuDNN's default: TF32 convolutions; or bf16 ones
            torch.backends.cudnn.allow_tf32 = True
            try:
                y = F.leaky_relu(F.conv2d(x.permute(0, 3, 1, 2), lib_w[0],
                                          lib_w[1], padding=1), 0.01)
                y = F.leaky_relu(F.conv2d(y, lib_w[2], lib_w[3], padding=1),
                                 0.01)
                return F.max_pool2d(y, 2, 2)
            finally:
                torch.backends.cudnn.allow_tf32 = False

        name = {"fused_stem_pair_pool": "fused_stem_pair_pool",
                STEM_D: f"fused_stem_pair_pool[{C1},{C2}]",
                STEM_ODD: f"fused_stem_pair_pool[{h}x{w}]",
                STEM_BF16: "fused_stem_pair_pool[bf16]"}[entry]
        nio = 2 if bf16 else 4  # bytes an element of x and of the output
        return Case(entry, name, suffix, "nanovs_slam_torch/csrc/stem.cu",
                    "nanovs_slam_tpu/ops/pallas/fused_stem.py:167",
                    lambda: fused_stem_pair_pool(*st),
                    lambda: stem_plain(*st), library,
                    nio * (B * h * w * 3 + B * (h // 2) * (w // 2) * C2)
                    + 4 * (C1 * 28 + C2 * (C1 * 9 + 1)),
                    2 * B * h * w * (C1 * 27 + C2 * C1 * 9),
                    BF16_FLOP_PER_S if bf16 else TF32_3X_FLOP_PER_S, check,
                    device_kernels)

    Hc, Wc = H // cell, W // cell
    S = Hc * Wc

    def netvlad_case(suffix, Cv, K, bf16=False):
        """NetVLAD at widths C, K (N: 48, 32; S: 64, 64); with ``bf16``, a
        bfloat16 x."""
        xv = nhwc(rs.randn(B, Cv, Hc, Wc))
        aw, cen = t(rs.randn(Cv, K) * 0.2), t(rs.rand(K, Cv))
        if bf16:
            xv = xv.to(torch.bfloat16)
        nv = (xv, aw, cen)

        def check(got, want):
            require(max_err(got, want) <= 1e-5, f"netvlad {Cv}, {K}")

        entry, name = (NV_BF16, "netvlad[bf16]") if bf16 else (
            "netvlad", "netvlad")
        return Case(entry, name, suffix,
                    "nanovs_slam_torch/csrc/netvlad.cu",
                    "nanovs_slam_tpu/ops/pallas/netvlad_kernel.py:59",
                    lambda: netvlad(*nv), lambda: netvlad_plain(*nv), None,
                    (2 if bf16 else 4) * B * S * Cv
                    + 4 * (2 * Cv * K + B * K * Cv),
                    B * S * (4 * Cv * K + 3 * Cv + 3 * K), FP32_FLOP_PER_S,
                    check)

    def netvlad_backward_case(suffix, Bb, h, w, Cv, K):
        """The NetVLAD backward at x (Bb, h, w, Cv) as NCHW memory (the
        VPR head's), K clusters: the train path's (4, 30, 40, 64) at
        K = 64 (config S, 120x160, batch 4) and config N's (1, 60, 80, 48)
        at K = 32, with inputs of their own draw. The forward's residuals
        come from its kernel (netvlad_residuals), as the train path's
        backward gets them. Each gradient within 1e-5 of its largest
        magnitude against the twin (autograd through netvlad_plain); dW and
        dcen equal across two launches (fixed-order reductions). Bound: five
        S x K x C products an image (logits, da, a du, dl W^T, x^T dl) and
        x, gy, u, m, W, cen read once, dx, dW, dcen written once."""
        rb = np.random.RandomState(SEED + 500 + Bb)
        xb = t(rb.randn(Bb, Cv, h, w)).permute(0, 2, 3, 1)
        aw, cen = t(rb.randn(Cv, K) * 0.3), t(rb.rand(K, Cv))
        gy = t(rb.randn(Bb, K * Cv))
        _, u, m = netvlad_residuals(xb, aw, cen)
        args = (gy, xb, aw, cen)

        def check(got, want):
            for g, w_, name in zip(got, want, ("dx", "dW", "dcen")):
                err = max_err(g, w_)
                lim = 1e-5 * float(w_.abs().max())
                require(err <= lim, f"netvlad_backward {name}: {err} > {lim}")
            again = netvlad_backward(*args, u, m)
            require(torch.equal(got[1], again[1])
                    and torch.equal(got[2], again[2]),
                    "netvlad_backward: dW or dcen differ across launches")

        S_b = h * w
        return Case("netvlad_backward", "netvlad_backward", suffix,
                    "nanovs_slam_torch/csrc/netvlad.cu",
                    "nanovs_slam_tpu/modules/aggregators.py:40",
                    lambda: netvlad_backward(*args, u, m),
                    lambda: netvlad_backward_plain(*args), None,
                    4 * (2 * Bb * S_b * Cv + 2 * Bb * K * Cv + Bb * K
                         + 4 * Cv * K),
                    10 * Bb * S_b * K * Cv, FP32_FLOP_PER_S, check, 3, 4)

    if B == OFFLINE_BATCH:  # the offline VO's batch of padded frames
        return [stem_case("_vo" + b8, 16, 32, h=VO_SIZE[0], w=VO_SIZE[1]),
                postprocess_case("_vo" + b8, 32, *VO_SIZE)]
    # the order of the draws from rs keeps earlier cases' inputs as they were
    cases = [postprocess_case(b8, 32), stem_case(b8, 16, 24),
             netvlad_case(b8, 48, 32)]
    if B == 1:
        cases += [stem_case("_match", 16, 32), netvlad_case("_s", 64, 64)]
    # the wide instance enqueues two device kernels: the weights' packing
    # and the stem
    cases.append(stem_case(b8, 64, 128, STEM_D, 2))
    cases.append(postprocess_case("_d" + b8, 128))
    if B != 1:
        cases += [stem_case("_s" + b8, 16, 32),
                  netvlad_case("_s" + b8, 64, 64)]
    else:  # odd frame sizes (floor pooling), an entry of their own
        cases += [stem_case(sfx, c1, c2, STEM_ODD, 1 + (c1 == 64), *ODD_HW)
                  for sfx, c1, c2 in (("", 16, 24), ("_s", 16, 32),
                                      ("_d", 64, 128))]
        # the VO path's shapes: pinned S8 at 128x512
        cases += [stem_case("_vo", 16, 32, h=VO_SIZE[0], w=VO_SIZE[1]),
                  postprocess_case("_vo", 32, *VO_SIZE)]
    # the bfloat16 instances at the bf16 cells' shapes: N (unsuffixed), S_A
    # (_s) and D (_d); the (64, 128) instance packs its weights first
    cases += [stem_case(b8, 16, 24, STEM_BF16),
              stem_case("_s" + b8, 16, 32, STEM_BF16),
              stem_case("_d" + b8, 64, 128, STEM_BF16, 2),
              postprocess_case(b8, 32, bf16=True),
              postprocess_case("_d" + b8, 128, bf16=True),
              netvlad_case(b8, 48, 32, bf16=True),
              netvlad_case("_s" + b8, 64, 64, bf16=True)]
    if B == 1:  # the train path's backward (unsuffixed) and config N's
        cases += [netvlad_backward_case("", 4, 30, 40, 64, 64),
                  netvlad_backward_case("_n", 1, 60, 80, 48, 32)]
    return cases


def kernel_phase(dev):
    import torch

    results = {}
    for B in (1, 8, OFFLINE_BATCH):
        for c in kernel_cases(B, dev):
            tag = f"{c.name}{c.suffix or '_b1'}"
            got = c.run()
            want = c.plain()
            torch.cuda.synchronize()
            c.check(got, want)
            err = max_err(got, want)
            ms = cuda_ms(c.run)
            plain_ms = cuda_ms(c.plain, inner=c.plain_inner)
            library_ms = cuda_ms(c.library) if c.library is not None else None
            b_ms, b_by = bound(c.nbytes, c.flops, c.rate)
            note = ""
            if c.rate == TF32_3X_FLOP_PER_S:  # the stem: print both bounds
                note = (f", 3xTF32 on the tensor cores; float32 on the CUDA "
                        f"cores {bound(c.nbytes, c.flops)[0]:.5f} ms")
            elif c.rate == BF16_FLOP_PER_S:
                note = ", bf16 on the tensor cores"
            n_dev, parts = kernels_a_call(c.run, c.device_kernels)
            log(f"kernel {tag}: {n_dev:g} device kernels a call, "
                + ", ".join(f"{t:.4f} ms {k[:48]}" for k, (_, t) in
                            sorted(parts.items(), key=lambda kv: -kv[1][1])))
            require(round(n_dev) == c.device_kernels,
                    f"{tag}: {n_dev} device kernels a call, expected "
                    f"{c.device_kernels}")
            log(f"kernel {tag}: max_abs_err {err:.3g}, "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
                f"{'n/a' if library_ms is None else f'{library_ms:.4f} ms'}"
                f", bound {b_ms:.5f} ms ({b_by}{note}), "
                f"{b_ms / ms:.1%} of it")
            entry = results.setdefault(c.entry, {
                "name": c.name, "route": "cuda", "source": c.source,
                "replaces": c.replaces})
            keys = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": library_ms}
            if c.entry == STEM_BF16:
                keys["max_bf16_ulps"] = bf16_ulps(got, want)
            entry.update({k + c.suffix: v for k, v in keys.items()})
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
    if cfg.depth:
        shapes["depth"] = (B, 2 * hc, 2 * wc, 1)
    require(set(out) == set(shapes), f"keys {sorted(out)}")
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
    if "depth" in ref:
        errs["depth"] = max_err(o["depth"], ref["depth"])
        require(errs["depth"] <= 1e-4, f"depth vs CPU {errs['depth']}")
    return errs


def spread_scores(model, frames) -> None:
    """Random weights put every score within a few hundredths of one
    value; spread the score logits and shift them so that a tenth of the
    cells of ``frames`` (480 at 240x320, under top_k) pass the 0.7
    threshold: the threshold and the top-K both select. The score is the
    score head's output (V2) or channel 0 of the score+loc head (V3)."""
    import torch

    from nanovs_slam_torch.ops.image import to_model_input

    head = (model.score_loc_head if hasattr(model, "score_loc_head")
            else model.score_head)
    with torch.no_grad():
        conv = head.convDb
        conv.weight[:1].mul_(10.0)
        conv.bias[:1].zero_()
        x = to_model_input(torch.from_numpy(frames)).permute(0, 3, 1, 2)
        z = head(model.backbone(x)[0])[:, :1]
        conv.bias[:1].fill_(math.log(0.7 / 0.3)
                            - float(torch.quantile(z, 0.9)))


def slice_phase(dev, kernels):
    import torch

    from nanovs_slam_torch.configs import get_config
    from nanovs_slam_torch.inference import make_infer_fn
    from nanovs_slam_torch.kernels import reset_launches
    from nanovs_slam_torch.models.kp2dtiny import init_model

    cfg = get_config("N", n_classes=28)
    gen = torch.Generator().manual_seed(SEED)
    model = init_model(cfg, gen, "cpu")
    randomize_bn(model, gen)
    rs = np.random.RandomState(SEED + 100)
    requests = [rs.randint(0, 256, (b, H, W, 3)).astype(np.uint8)
                for b in (1, 1, 1, 8)]
    spread_scores(model, requests[0])
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


def odd_request_phase(dev) -> dict:
    """One batch-1 request of KP2DTiny-N at an odd frame size (the stem
    pools with floor) through make_infer_fn, against the CPU. Returns its
    launch counts, the odd stem's under its own entry."""
    import torch

    from nanovs_slam_torch.configs import get_config
    from nanovs_slam_torch.inference import make_infer_fn
    from nanovs_slam_torch.kernels import (fused_postprocess,
                                           fused_stem_pair_pool, netvlad,
                                           reset_launches)
    from nanovs_slam_torch.models.kp2dtiny import init_model

    h, w = ODD_HW
    cfg = get_config("N", n_classes=28)
    gen = torch.Generator().manual_seed(SEED + 800)
    model = init_model(cfg, gen, "cpu")
    randomize_bn(model, gen)
    frames = np.random.RandomState(SEED + 800).randint(
        0, 256, (1, h, w, 3)).astype(np.uint8)
    spread_scores(model, frames)
    cpu_model = copy.deepcopy(model)
    infer = make_infer_fn(model, cfg, h, w, top_k=1000, conf_threshold=0.7,
                          device=dev)
    reset_launches()
    out = infer(frames)
    torch.cuda.synchronize()
    launches = {STEM_ODD: fused_stem_pair_pool.launches,
                "fused_postprocess": fused_postprocess.launches,
                "netvlad": netvlad.launches}
    require(all(n == 1 for n in launches.values()),
            f"odd request: launches {launches}")
    check_answer(out, 1, h, w, cfg, 1000)
    ref = make_infer_fn(cpu_model, cfg, h, w, top_k=1000, conf_threshold=0.7,
                        device="cpu")(frames)
    errs = compare_with_cpu(out, ref)
    log(f"odd request: N at {h}x{w}, launches {launches}, "
        f"{int(out['keypoint_valid'].sum())} valid keypoints, vs CPU "
        f"{json.dumps(errs)}")
    return launches


def lightglue_default_phase(dev) -> dict:
    """One LightGlue match at config "default" (D = 256, 9 layers; seeded
    weights) of 512 keypoints against a perturbed, shuffled copy, through
    the module on the card and on the CPU: matches0 agree on >= 99.9% of
    the entries."""
    import torch

    from nanovs_slam_torch.kernels import (lightglue_transformer,
                                           reset_launches, split_weights)

    lg = default_lightglue()
    cpu_lg = copy.deepcopy(lg)
    rs = np.random.RandomState(SEED + 900)
    K, D = 512, lg.cfg.input_dim
    kp0 = rs.uniform(-1, 1, (1, K, 2))
    d0 = rs.randn(1, K, D)
    perm = rs.permutation(K)
    kp1 = kp0[:, perm] + 0.01 * rs.randn(1, K, 2)
    d1 = d0[:, perm] + 0.3 * rs.randn(1, K, D)
    data = {k: torch.from_numpy(v.astype(np.float32)) for k, v in
            (("keypoints0", kp0), ("keypoints1", kp1),
             ("descriptors0", d0 / np.linalg.norm(d0, axis=-1, keepdims=True)),
             ("descriptors1", d1 / np.linalg.norm(d1, axis=-1,
                                                  keepdims=True)))}
    with torch.inference_mode():
        ref = cpu_lg(data)
        lg.to(dev)
        reset_launches()
        out = lg({k: v.to(dev) for k, v in data.items()})
        torch.cuda.synchronize()
    # the weights' fragments are made once, at the first match on the card
    launches = {LG_D256: lightglue_transformer.launches,
                "split_weights": split_weights.launches}
    require(launches == {LG_D256: 1, "split_weights": 1},
            f"lightglue default: {launches}")
    m0 = out["matches0"].cpu()
    agree = float((m0 == ref["matches0"]).float().mean())
    n = int((m0 >= 0).sum())
    right = int((m0[0][m0[0] >= 0] == torch.from_numpy(
        np.argsort(perm))[m0[0] >= 0]).sum())
    log(f"lightglue default: {n} matches of {K} ({right} to the true "
        f"keypoint), matches0 agree with the CPU on {agree:.4f} of the "
        f"entries, launches {launches}")
    require(agree >= 0.999, f"lightglue default: matches0 agree {agree}")
    # the steady ms of a default match through the module, K = 512, 1024
    timed = {}
    for k in (512, 1024):
        cdata = {"keypoints0": torch.from_numpy(
                     rs.uniform(-1, 1, (1, k, 2)).astype(np.float32)),
                 "keypoints1": torch.from_numpy(
                     rs.uniform(-1, 1, (1, k, 2)).astype(np.float32))}
        for i in (0, 1):
            d = rs.randn(1, k, D).astype(np.float32)
            cdata[f"descriptors{i}"] = torch.from_numpy(
                d / np.linalg.norm(d, axis=-1, keepdims=True))
        cdata = {key: v.to(dev) for key, v in cdata.items()}
        with torch.inference_mode():
            times = host_ms(lambda i: lg(cdata), 30)
        timed[k] = steady(times)
    log("lightglue default: steady ms a match "
        + ", ".join(f"K={k} {v:.4f}" for k, v in timed.items()))
    return launches


# ------------------------------------------------------------------ vo phase

KITTI_HW = (376, 1241)  # KITTI's grayscale frames
VO_SIZE = (128, 512)  # vo_eval's default model input
VO_FRAMES = 8


def corridor_frames(dev, n: int, seed: int, step: float = 0.4,
                    yaw_rate: float = 0.006):
    """A corridor rendered on ``dev`` in torch: rays of the KITTI camera
    (376x1241) meet two walls (x = +-7 m), the floor (y = 1.65 m, y down),
    the ceiling (y = -6 m) and a far wall (z = 80 m); each plane's seeded
    numpy texture (noise of several octaves) is sampled there with
    F.grid_sample. The camera moves 0.4 m forward a frame and turns by a
    small yaw. -> (BGR uint8 frames (n, 376, 1241, 3) on dev, camera-to-
    world [R | t] poses (n, 3, 4) float64)."""
    import torch
    import torch.nn.functional as F

    from nanovs_slam_torch.vo.camera import kitti_params

    rs = np.random.RandomState(seed)
    fx, fy, cx, cy = kitti_params()
    hh, ww = KITTI_HW
    ppm = 36.0  # texels a metre

    def texture(th=512, tw=2048):
        t = torch.zeros(1, 1, th, tw)
        for div, amp in ((64, 1.0), (16, 0.6), (4, 0.45), (1, 0.3)):
            lo = torch.from_numpy(rs.rand(1, 1, th // div + 1,
                                          tw // div + 1).astype(np.float32))
            t += amp * F.interpolate(lo, size=(th, tw), mode="bilinear",
                                     align_corners=True)
        return ((t - t.min()) / (t.max() - t.min())).to(dev)

    # (axis of the normal, its value, the two texture axes)
    planes = [(0, -7.0, (2, 1)), (0, 7.0, (2, 1)), (1, 1.65, (0, 2)),
              (1, -6.0, (0, 2)), (2, 80.0, (0, 1))]
    textures = [texture() for _ in planes]
    v, u = torch.meshgrid(torch.arange(hh, device=dev, dtype=torch.float64),
                          torch.arange(ww, device=dev, dtype=torch.float64),
                          indexing="ij")
    rays = torch.stack([(u - cx) / fx, (v - cy) / fy, torch.ones_like(u)],
                       -1)  # camera frame
    frames, poses = [], []
    R, p, yaw = np.eye(3), np.zeros(3), 0.0
    for i in range(n):
        c, s_ = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, 0, s_], [0, 1, 0], [-s_, 0, c]])
        poses.append(np.concatenate([R, p[:, None]], 1))
        d = rays @ torch.from_numpy(R.T).to(dev)  # world directions
        pt = torch.from_numpy(p).to(dev)
        best = torch.full((hh, ww), float("inf"), device=dev,
                          dtype=torch.float64)
        img = torch.zeros((hh, ww), device=dev)
        for (ax, val, (ta, tb)), tex in zip(planes, textures):
            t = (val - pt[ax]) / d[..., ax]
            t = torch.where(t > 0, t, torch.inf)
            hit = pt + t[..., None] * d
            th, tw = tex.shape[-2:]
            gx = torch.remainder(hit[..., ta] * ppm, tw - 1) / (tw - 1) * 2 - 1
            gy = torch.remainder(hit[..., tb] * ppm, th - 1) / (th - 1) * 2 - 1
            grid = torch.nan_to_num(torch.stack([gx, gy], -1)).float()
            val_ = F.grid_sample(tex, grid[None], mode="bilinear",
                                 padding_mode="border",
                                 align_corners=True)[0, 0]
            nearer = t < best
            img = torch.where(nearer, val_, img)
            best = torch.where(nearer, t, best)
        gray = torch.round(img * 255).clamp(0, 255).to(torch.uint8)
        frames.append(gray[..., None].expand(hh, ww, 3).contiguous())
        p = p + R @ np.array([0.0, 0.0, step])
        yaw += yaw_rate * np.sin(2 * np.pi * i / max(n - 1, 1))
    return torch.stack(frames), np.stack(poses)


def compare_features(card, cpu) -> dict:
    """Two frontends' (pts, feat) of one frame: the share of kept
    keypoints (over the longer list) that the other device kept within
    1e-4, wherever in the score order (near-equal scores may swap), and
    the least descriptor cosine over those pairs."""
    (p0, f0), (p1, f1) = (card[0], card[1]), (cpu[0], cpu[1])
    d = np.abs(p0[:, None] - p1[None]).max(-1)
    j = d.argmin(1)
    same = d[np.arange(len(p0)), j] <= 1e-4
    cos = float((f0[same] * f1[j[same]]).sum(-1).min()) if same.any() \
        else float("nan")
    return {"n_card": len(p0), "n_cpu": len(p1),
            "kept_equal": float(same.sum() / max(len(p0), len(p1), 1)),
            "cos_min": cos}


def matched_pairs(m):
    """A matcher's (kps0, kps1) as a set of coordinate pairs at 1e-3 px."""
    return {tuple(np.round(np.concatenate([a, b]), 3)) for a, b in zip(*m)}


def injected_noise(seed: int):
    """A stand-in for vo.pose.gumbel_noise that draws the noise with numpy
    from ``seed`` and copies it to the generator's device: the card and the
    CPU then solve with the same samples."""
    import torch

    rs = np.random.RandomState(seed)

    def draw(shape, generator):
        return torch.from_numpy(rs.gumbel(size=shape).astype(
            np.float32)).to(generator.device)
    return draw


def host_ms(fn, n: int) -> list:
    """Host-clock ms of ``n`` calls of fn(i), each ending in a
    synchronise."""
    import torch

    times = []
    for i in range(n):
        t0 = time.perf_counter()
        fn(i)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


class Corridor(NamedTuple):
    """The VO phases' input: the corridor frames on the card and the CPU,
    its ground truth, pinned S8 on the card and a copy on the CPU, and
    KITTI's camera at the frames' size."""
    frames: object
    cpu_frames: object
    gt: object
    cfg: object
    ex: object
    cpu_ex: object
    cam: object


def corridor_setup(dev, repo: str) -> Corridor:
    """Renders the corridor (8 frames at 376x1241, on the card), writes and
    reads its ground truth, and loads pinned S8 (config S, 8 classes)."""
    import shutil
    import tempfile

    import torch

    from nanovs_slam_torch.configs import get_config
    from nanovs_slam_torch.models.kp2dtiny import init_model
    from nanovs_slam_torch.utils.checkpoint import load_npz_checkpoint
    from nanovs_slam_torch.utils.convert import load_jax_variables
    from nanovs_slam_torch.vo.camera import PinholeCamera, kitti_params
    from nanovs_slam_torch.vo.groundtruth import KittiVideoGroundTruth

    t_start = time.perf_counter()
    frames, poses = corridor_frames(dev, VO_FRAMES, SEED + 700)
    torch.cuda.synchronize()
    log(f"vo: {VO_FRAMES} corridor frames {tuple(frames.shape[1:])} "
        f"rendered on the card in {time.perf_counter() - t_start:.2f} s")
    tmp = tempfile.mkdtemp()
    try:
        np.savetxt(os.path.join(tmp, "06.txt"), poses.reshape(len(poses), 12))
        gt = KittiVideoGroundTruth(tmp, "06.txt")
    finally:
        shutil.rmtree(tmp)
    tree, _ = load_npz_checkpoint(
        os.path.join(repo, "pinned", "extractor_S8.npz"))
    cfg = get_config("S", n_classes=8)
    ex = init_model(cfg, torch.Generator().manual_seed(SEED), "cpu")
    load_jax_variables(ex, tree["params"], tree["batch_stats"])
    cpu_ex = copy.deepcopy(ex)
    fx, fy, cx, cy = kitti_params()
    cam = PinholeCamera(KITTI_HW[1], KITTI_HW[0], fx, fy, cx, cy)
    return Corridor(frames, frames.cpu(), gt, cfg, ex.to(dev), cpu_ex, cam)


def vo_phase(dev, repo: str, cor: Corridor) -> dict:
    """The visual-odometry path: the corridor (8 frames at 376x1241, on the
    card) through the pinned S8 frontend at 128x512 (top_k 4000, nn_thresh
    0.7) and run_visual_odometry, the loop the CLI drives, twice: the host
    BF matcher (native where it builds) and pinned LightGlue (max_n 1024),
    each with the device RANSAC (8192 hypotheses, 3 restarts). Checks:
    every frame's keypoints and descriptors against the CPU frontend's,
    the BF matches against the CPU's, one pair's RANSAC on the card
    against the CPU with the same injected noise, the launch counts (the
    stem and postprocess on every frame, LightGlue on every pair), no
    failed estimate and finite poses. Prints the error statistics beside
    the CPU's run and the ms per frame of each stage. Returns the launch
    counts by path."""
    import torch

    from nanovs_slam_torch.configs import get_config
    from nanovs_slam_torch.kernels import (fused_postprocess,
                                           fused_stem_pair_pool,
                                           lightglue_transformer,
                                           reset_launches)
    from nanovs_slam_torch.models.kp2dtiny import build_model
    from nanovs_slam_torch.ops.image import quantize_u8
    from nanovs_slam_torch.vo import native
    from nanovs_slam_torch.vo import pose as vo_pose
    from nanovs_slam_torch.vo.frontend import KP2DTinyFrontend
    from nanovs_slam_torch.vo.matcher import match_keypoints
    from nanovs_slam_torch.vo.visual_odometry import (VisualOdometry,
                                                      load_lightglue_for_vo,
                                                      prep_frame,
                                                      run_visual_odometry)

    frames, cpu_frames, gt, cfg, ex, cpu_ex, cam = cor
    # the host BF matcher must be the native one: the numpy fallback is a
    # different program to time
    built = native.native_available()
    if native.build_log:
        log(f"vo: native matcher build messages:\n{native.build_log}")
    require(built, "vo: the native matcher did not build")
    log(f"vo: host matcher native, {native.SOURCE.name} built into "
        f"{native.BUILD_ROOT}")
    kw = dict(nn_thresh=0.7, top_k=4000)
    fe = KP2DTinyFrontend(ex, cfg, VO_SIZE, device=dev, **kw)
    cpu_fe = KP2DTinyFrontend(cpu_ex, cfg, VO_SIZE, device="cpu", **kw)

    # the frontend on every frame, and the BF matches of every pair
    feats = [fe.run(prep_frame(f, VO_SIZE)) for f in frames]
    cpu_feats = [cpu_fe.run(prep_frame(f, VO_SIZE)) for f in cpu_frames]
    for i, (a, b) in enumerate(zip(feats, cpu_feats)):
        c = compare_features(a, b)
        require(c["kept_equal"] >= 0.999 and c["cos_min"] > 0.9999,
                f"vo frame {i}: card vs CPU frontend {c}")
    log(f"vo: frontend card vs CPU on every frame, e.g. the last "
        f"{json.dumps(c)}")
    agree = []
    for i in range(1, VO_FRAMES):
        m, mc = (matched_pairs(match_keypoints(f[i - 1][0], f[i - 1][1],
                                               f[i][0], f[i][1]))
                 for f in (feats, cpu_feats))
        agree.append(len(m & mc) / max(len(m), len(mc), 1))
        require(agree[-1] >= 0.99 and len(m) >= 8,
                f"vo pair {i}: {len(m)} BF matches, {agree[-1]:.4f} "
                "equal to the CPU's")
    log(f"vo: BF matches equal to the CPU's on "
        f"{', '.join(f'{a:.4f}' for a in agree)} of the entries")

    # one pair's RANSAC, card against CPU, with the same injected noise
    sx, sy = KITTI_HW[1] / VO_SIZE[1], KITTI_HW[0] / VO_SIZE[0]
    m0, m1 = match_keypoints(feats[3][0] * [sx, sy], feats[3][1],
                             feats[4][0] * [sx, sy], feats[4][1])
    got = []
    draw = vo_pose.gumbel_noise
    try:
        for d in (dev, torch.device("cpu")):
            vo_pose.gumbel_noise = injected_noise(SEED + 1000)
            vo = VisualOdometry(None, cam, device_pose=True, device=d)
            got.append(vo._estimate_pose_on_device(m0, m1))
        # the same in float32 (the JAX package's dtype), printed only: the
        # Sampson residual keeps ~3 digits there, and the devices' answers
        # can part (why VisualOdometry solves in float64)
        n, slots = len(m0), max(512, 1 << int(np.ceil(np.log2(len(m0)))))
        a, b = (np.zeros((slots, 2), np.float32) for _ in range(2))
        a[:n] = cam.unproject_points(m0)
        b[:n] = cam.unproject_points(m1)
        f32 = []
        for d in (dev, torch.device("cpu")):
            vo_pose.gumbel_noise = injected_noise(SEED + 1000)
            out = vo_pose.ransac_essential_device(
                torch.from_numpy(a).to(d), torch.from_numpy(b).to(d),
                torch.Generator(device=d),
                valid=torch.arange(slots, device=d) < n)
            f32.append([x.cpu().numpy() for x in out])
    finally:
        vo_pose.gumbel_noise = draw
    (R, t, inl), (Rc, tc, inlc) = got
    r_err, t_err = float(np.abs(R - Rc).max()), float(np.abs(t - tc).max())
    log(f"vo: RANSAC on pair 3-4 ({len(m0)} matches, {int(inl.sum())} "
        f"inliers), card vs CPU with the same noise: R {r_err:.3g}, t "
        f"{t_err:.3g}, inlier masks equal {bool((inl == inlc).all())} "
        f"(float64; in float32: R {np.abs(f32[0][0] - f32[1][0]).max():.3g},"
        f" t {np.abs(f32[0][1] - f32[1][1]).max():.3g}, inlier masks equal "
        f"{bool((f32[0][2] == f32[1][2]).all())})")
    require(r_err <= 1e-4 and t_err <= 1e-4 and bool((inl == inlc).all()),
            "vo: the card's RANSAC differs from the CPU's")

    paths, runs = {}, {}
    for mode in ("bf", "lightglue"):
        run_kw = dict(new_size=VO_SIZE, verbose=True, matcher=mode,
                      device_pose=True, pose_hypotheses=8192,
                      pose_restarts=3)

        def lightglue():
            return (load_lightglue_for_vo(
                os.path.join(repo, "pinned", "lightglue_S.npz"),
                cfg.nfeatures, KITTI_HW[::-1], max_n=1024)
                if mode == "lightglue" else None)

        reset_launches()
        t0 = time.perf_counter()
        res = run_visual_odometry(fe, frames, gt, lightglue=lightglue(),
                                  device=dev, **run_kw)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / VO_FRAMES
        launches = {"fused_stem_pair_pool": fused_stem_pair_pool.launches,
                    "fused_postprocess": fused_postprocess.launches}
        want = {"fused_stem_pair_pool": VO_FRAMES,
                "fused_postprocess": VO_FRAMES}
        if mode == "lightglue":
            launches["lightglue_transformer"] = lightglue_transformer.launches
            want["lightglue_transformer"] = VO_FRAMES - 1
        log(f"vo {mode}: launches over {VO_FRAMES} frames {launches}")
        require(launches == want, f"vo {mode}: launches {launches}, "
                f"expected {want}")
        require(res["estimation_fails"] == 0,
                f"vo {mode}: {res['estimation_fails']} failed estimates")
        require(bool(np.isfinite(res["trajectory"]).all())
                and len(res["trajectory"]) == VO_FRAMES,
                f"vo {mode}: trajectory {res['trajectory']}")
        cpu = run_visual_odometry(cpu_fe, cpu_frames, gt,
                                  lightglue=lightglue(), device="cpu",
                                  **run_kw)
        for part in ("translation", "rotation", "total"):
            log(f"vo {mode}: {part} error mean {res[part]['mean']:.6f} max "
                f"{res[part]['max']:.6f} (CPU run: mean "
                f"{cpu[part]['mean']:.6f} max {cpu[part]['max']:.6f})")
        log(f"vo {mode}: matches per pair mean "
            f"{res['stats']['n_matches']['mean']:.1f}, inliers "
            f"{res['stats']['n_inliers']['mean']:.1f}; the loop "
            f"{wall:.2f} ms a frame (first calls included)")

        # ms per frame of each stage, steady: extraction (frame in, trimmed
        # keypoints out), matching (host BF or LightGlue on the card) and
        # the device RANSAC
        vo = VisualOdometry(None, cam, matcher=mode, lightglue=lightglue(),
                            device_pose=True, device=dev)
        scaled = [(f[0] * [sx, sy], f[1]) for f in feats]
        ext = host_ms(lambda i: fe.run(prep_frame(frames[i % VO_FRAMES],
                                                  VO_SIZE)), 2 * VO_FRAMES)
        pairs = []

        def match(i):
            j = 1 + i % (VO_FRAMES - 1)
            vo.kps_prev, vo.feat_prev = scaled[j - 1]
            pairs.append(vo._match(*scaled[j], None))

        mat = host_ms(match, 2 * (VO_FRAMES - 1))
        pos = host_ms(lambda i: vo._estimate_pose_on_device(*pairs[i]),
                      2 * (VO_FRAMES - 1))
        med = {k: statistics.median(v[len(v) // 2:]) for k, v in
               (("extract_ms", ext), ("match_ms", mat), ("pose_ms", pos))}
        log(f"vo {mode}: steady median ms a frame (host clock, "
            f"synchronised) {json.dumps(med)}")
        paths[f"vo_{mode}"] = launches
        runs[mode] = res

    # VO-BF with the extractor at bfloat16, frames in as uint8 (the JAX
    # VO's transfer for a bf16 model)
    cfg16 = get_config("S", n_classes=8, dtype="bfloat16")
    ex16 = build_model(cfg16)
    ex16.load_state_dict(cpu_ex.state_dict())
    fe16 = KP2DTinyFrontend(ex16, cfg16, VO_SIZE, device=dev, **kw)
    reset_launches()
    res = run_visual_odometry(fe16, frames, gt, device=dev, new_size=VO_SIZE,
                              verbose=True, matcher="bf", device_pose=True,
                              pose_hypotheses=8192, pose_restarts=3)
    torch.cuda.synchronize()
    launches = {STEM_BF16: fused_stem_pair_pool.launches_bf16,
                PP_BF16: fused_postprocess.launches_bf16}
    f32 = (fused_stem_pair_pool.launches, fused_postprocess.launches)
    log(f"vo bf bf16: launches over {VO_FRAMES} frames {launches}, float32 "
        f"instances {f32}")
    require(all(n == VO_FRAMES for n in launches.values()) and f32 == (0, 0),
            f"vo bf bf16: launches {launches}, float32 instances {f32}")
    require(res["estimation_fails"] == 0
            and bool(np.isfinite(res["trajectory"]).all()),
            f"vo bf bf16: {res['estimation_fails']} failed estimates")
    require(res["stats"]["n_matches"]["min"] >= 8,
            f"vo bf bf16: matches {res['stats']['n_matches']}")
    for part in ("translation", "rotation", "total"):
        log(f"vo bf bf16: {part} error mean {res[part]['mean']:.6f} max "
            f"{res[part]['max']:.6f} (float32 run: mean "
            f"{runs['bf'][part]['mean']:.6f} max "
            f"{runs['bf'][part]['max']:.6f})")
    f16 = [fe16.run(quantize_u8(prep_frame(f, VO_SIZE))) for f in frames]
    ext = host_ms(lambda i: fe16.run(quantize_u8(prep_frame(
        frames[i % VO_FRAMES], VO_SIZE))), 2 * VO_FRAMES)
    log(f"vo bf bf16: matches per pair mean "
        f"{res['stats']['n_matches']['mean']:.1f}, inliers "
        f"{res['stats']['n_inliers']['mean']:.1f}, keypoints a frame "
        f"{statistics.mean(len(f[0]) for f in f16):.1f} (float32 "
        f"{statistics.mean(len(f[0]) for f in feats):.1f}); steady median "
        f"extract ms a frame {statistics.median(ext[len(ext) // 2:]):.3f}")
    paths["vo_bf_bf16"] = launches
    return paths


# ------------------------------------------------------- dense VO phases

def steady(times: list) -> float:
    """The median of the second half of host-clock times."""
    return statistics.median(times[len(times) // 2:])


def log_breakdown(name: str, run, wall_ms: float, iters: int = 10) -> None:
    """Prints the profiler's device time of one call of ``run`` beside its
    steady host-clock ms: the device busy share of the call, its device
    kernels and the four that take the most time."""
    parts = device_breakdown(run, iters)
    dev_ms = sum(n * t for n, t in parts.values())
    top = sorted(parts.items(), key=lambda kv: -kv[1][0] * kv[1][1])[:4]
    log(f"{name}: device {dev_ms:.3f} ms a call, {100 * dev_ms / wall_ms:.1f}"
        f"% of {wall_ms:.3f} ms wall, "
        f"{sum(n for n, _ in parts.values()):g} device kernels a call; "
        + ", ".join(f"{n * t:.3f} ms x{n:g} {k[:40]}"
                    for k, (n, t) in top))


def vo_dense_phase(dev, cor: Corridor) -> dict:
    """VO-dense-128x512: the online VO with the dense matcher (pinned S8,
    k = top_k = 4000 match slots, relative threshold 0.1 topped up to 400)
    through run_visual_odometry with the device RANSAC (8192 hypotheses, 3
    restarts), on the card and on the CPU. Checks: the stem kernel on every
    frame and no other kernel, no failed estimate, finite poses, and every
    pair's kept matches against the CPU's (as sets at 1e-3 px). Prints the
    errors beside the CPU run's and the steady ms a frame of the
    extraction, the match and the pose."""
    import torch

    from nanovs_slam_torch.kernels import (fused_postprocess,
                                           fused_stem_pair_pool,
                                           lightglue_transformer,
                                           reset_launches)
    from nanovs_slam_torch.matching.dense import DenseMatcher
    from nanovs_slam_torch.vo.frontend import KP2DTinyFrontend
    from nanovs_slam_torch.vo.visual_odometry import (VisualOdometry,
                                                      _ScaledDense,
                                                      prep_frame,
                                                      run_visual_odometry)

    frames, cpu_frames, gt, cfg, ex, cpu_ex, cam = cor
    kw = dict(nn_thresh=0.7, top_k=4000)
    run_kw = dict(new_size=VO_SIZE, verbose=True, matcher="dense",
                  device_pose=True, pose_hypotheses=8192, pose_restarts=3)
    fe = KP2DTinyFrontend(ex, cfg, VO_SIZE, device=dev, **kw)
    reset_launches()
    t0 = time.perf_counter()
    res = run_visual_odometry(fe, frames, gt, device=dev, **run_kw)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / VO_FRAMES
    launches = {"fused_stem_pair_pool": fused_stem_pair_pool.launches}
    others = (fused_postprocess.launches, lightglue_transformer.launches)
    log(f"vo dense: launches over {VO_FRAMES} frames {launches}, "
        f"postprocess and lightglue {others}")
    require(launches["fused_stem_pair_pool"] == VO_FRAMES
            and others == (0, 0), f"vo dense: launches {launches} {others}")
    require(res["estimation_fails"] == 0
            and bool(np.isfinite(res["trajectory"]).all())
            and len(res["trajectory"]) == VO_FRAMES,
            f"vo dense: {res['estimation_fails']} failed estimates")
    cpu = run_visual_odometry(
        KP2DTinyFrontend(cpu_ex, cfg, VO_SIZE, device="cpu", **kw),
        cpu_frames, gt, device="cpu", **run_kw)
    for part in ("translation", "rotation", "total"):
        log(f"vo dense: {part} error mean {res[part]['mean']:.6f} max "
            f"{res[part]['max']:.6f} (CPU run: mean {cpu[part]['mean']:.6f} "
            f"max {cpu[part]['max']:.6f})")
    log(f"vo dense: matches per pair mean "
        f"{res['stats']['n_matches']['mean']:.1f}, inliers "
        f"{res['stats']['n_inliers']['mean']:.1f}; the loop {wall:.2f} ms a "
        "frame (first calls included)")

    # every pair's kept matches, card against CPU: the VO's own filter
    sx, sy = KITTI_HW[1] / VO_SIZE[1], KITTI_HW[0] / VO_SIZE[0]
    vos, imgs = [], []
    for d, m, fr in ((dev, ex, frames), ("cpu", cpu_ex, cpu_frames)):
        dm = _ScaledDense(DenseMatcher(m, cfg, VO_SIZE, k=4000, device=d),
                          sx, sy)
        vos.append(VisualOdometry(None, cam, matcher="dense", dense=dm,
                                  device_pose=True, device=d))
        imgs.append([prep_frame(f, VO_SIZE) for f in fr])
    agree, pairs = [], []
    for i in range(1, VO_FRAMES):
        got = []
        for vo, im in zip(vos, imgs):
            vo.fmap_prev = vo.dense.extract(im[i - 1])
            got.append(vo._match_dense(im[i]))
        m, mc = (matched_pairs(g) for g in got)
        agree.append(len(m & mc) / max(len(m), len(mc), 1))
        require(agree[-1] >= 0.99 and len(m) >= 8,
                f"vo dense pair {i}: {len(m)} matches, {agree[-1]:.4f} "
                "equal to the CPU's")
        pairs.append(got[0])
    log(f"vo dense: kept matches equal to the CPU's on "
        f"{', '.join(f'{a:.4f}' for a in agree)} of the entries")

    vo, im = vos[0], imgs[0]
    maps = [vo.dense.extract(x) for x in im]
    ext = host_ms(lambda i: vo.dense.extract(im[i % VO_FRAMES]),
                  2 * VO_FRAMES)

    def match(i):
        j = 1 + i % (VO_FRAMES - 1)
        [t.cpu() for t in vo.dense.dm.match_maps(maps[j - 1], maps[j])]

    mat = host_ms(match, 2 * (VO_FRAMES - 1))
    pos = host_ms(lambda i: vo._estimate_pose_on_device(
        *pairs[i % (VO_FRAMES - 1)]), 2 * (VO_FRAMES - 1))
    med = {"extract_ms": steady(ext), "match_ms": steady(mat),
           "pose_ms": steady(pos)}
    log(f"vo dense: steady median ms a frame (host clock, synchronised) "
        f"{json.dumps(med)}")
    log_breakdown("vo dense extract", lambda: vo.dense.extract(im[1]),
                  med["extract_ms"])
    log_breakdown("vo dense match", lambda: vo.dense.dm.match_maps(
        maps[0], maps[1]), med["match_ms"])
    return {"vo_dense": launches}


def match_map_agreement(card, cpu) -> float:
    """The least share, over the pairs of two match maps (kpn0, kpn1,
    valid), of the valid correspondences that the other side has within
    1e-4 (normalised image-plane units), over the larger count: compared as
    sets, since near-equal scores may swap two slots."""
    shares = []
    for i in range(card[0].shape[0]):
        a, b = (np.concatenate([k0[i][v[i]], k1[i][v[i]]], -1)
                for k0, k1, v in ([x.cpu().numpy() for x in mm]
                                  for mm in (card, cpu)))
        n = max(len(a), len(b), 1)
        if not len(a) or not len(b):
            shares.append(float(len(a) == len(b)))
            continue
        d = np.abs(a[:, None] - b[None]).max(-1)
        shares.append(float((d.min(1) <= 1e-4).sum()) / n)
    return min(shares)


def vo_offline_phase(dev, repo: str, cor: Corridor) -> dict:
    """VO-offline-{dense,bf,lg}-128x512: vo.offline.OfflineVO on the
    corridor's 8 frames at 128x512 (pinned S8; dense: k = 512, bf and
    lightglue: k = min(top_k 4000, 1024) = 1024, pinned LightGlue on
    keypoints scaled to KITTI's frame; device RANSAC 8192 hypotheses, 3
    restarts). relative_poses on the card: the launch counts (the stem once
    for the batch of 16 padded frames; the postprocess once for the sparse
    modes; LightGlue once a pair), finite poses and at least 8 matches a
    pair; the match map against the CPU's (every pair, as sets); the
    errors against the ground truth; and the steady ms a sequence and of
    its extract, match-map and pose-map stages."""
    import torch

    from nanovs_slam_torch.kernels import (fused_postprocess,
                                           fused_stem_pair_pool,
                                           lightglue_transformer,
                                           reset_launches)
    from nanovs_slam_torch.vo.offline import OfflineVO, offline_results
    from nanovs_slam_torch.vo.visual_odometry import (load_lightglue_for_vo,
                                                      prep_frame)

    frames, cpu_frames, gt, cfg, ex, cpu_ex, cam = cor
    stack = torch.stack([prep_frame(f, VO_SIZE) for f in frames])
    cpu_stack = stack.cpu()
    paths = {}
    for mode, tag in (("dense", "dense"), ("bf", "bf"), ("lightglue", "lg")):
        name = f"vo offline {tag}"
        kw = dict(k=512 if mode == "dense" else 1024, matcher=mode,
                  n_hypotheses=8192, restarts=3)

        def lightglue():
            return (load_lightglue_for_vo(
                os.path.join(repo, "pinned", "lightglue_S.npz"),
                cfg.nfeatures, KITTI_HW[::-1], max_n=1024)
                if mode == "lightglue" else None)

        vo = OfflineVO(ex, cfg, VO_SIZE, cam, lightglue=lightglue(),
                       device=dev, **kw)
        reset_launches()
        t0 = time.perf_counter()
        R, t, ninl, nmat = vo.relative_poses(stack)
        first = (time.perf_counter() - t0) * 1e3
        launches = {"fused_stem_pair_pool": fused_stem_pair_pool.launches}
        want = {"fused_stem_pair_pool": 1}
        if mode != "dense":
            launches["fused_postprocess"] = fused_postprocess.launches
            want["fused_postprocess"] = 1
        if mode == "lightglue":
            launches["lightglue_transformer"] = lightglue_transformer.launches
            want["lightglue_transformer"] = VO_FRAMES - 1
        log(f"{name}: launches over a sequence of {VO_FRAMES} frames "
            f"{launches}")
        require(launches == want, f"{name}: launches {launches}, expected "
                f"{want}")
        require(bool(np.isfinite(R).all() and np.isfinite(t).all())
                and int(nmat.min()) >= 8 and int(ninl.min()) >= 8,
                f"{name}: a failed pair, matches {nmat}, inliers {ninl}")
        res = offline_results(gt, R, t, ninl, nmat, verbose=True)
        log(f"{name}: total error mean {res['total']['mean']:.6f} max "
            f"{res['total']['max']:.6f}; matches a pair {nmat.tolist()}, "
            f"inliers {ninl.tolist()}; the first sequence {first:.1f} ms")

        reps = vo.extract(stack)
        mm = vo.match_map(reps)
        cvo = OfflineVO(cpu_ex, cfg, VO_SIZE, cam, lightglue=lightglue(),
                        device="cpu", **kw)
        agree = match_map_agreement(mm, cvo.match_map(cvo.extract(cpu_stack)))
        log(f"{name}: match map vs CPU, every pair's correspondences equal "
            f"on {agree:.4f} or more")
        require(agree >= 0.99, f"{name}: match map vs CPU {agree:.4f}")

        seq = host_ms(lambda i: vo.relative_poses(stack), 4)
        ext = host_ms(lambda i: vo.extract(stack), 6)
        mat = host_ms(lambda i: vo.match_map(reps), 6)
        pos = host_ms(lambda i: vo.pose_map(*mm), 4)
        med = {"sequence_ms": steady(seq), "extract_ms": steady(ext),
               "match_map_ms": steady(mat), "pose_map_ms": steady(pos),
               "pose_ms_a_pair": steady(pos) / (VO_FRAMES - 1)}
        log(f"{name}: steady median (host clock, synchronised) "
            f"{json.dumps(med)}")
        log_breakdown(f"{name} extract", lambda: vo.extract(stack),
                      med["extract_ms"], 4)
        log_breakdown(f"{name} match map", lambda: vo.match_map(reps),
                      med["match_map_ms"], 4)
        paths[f"vo_offline_{tag}"] = launches
    return paths


def lightglue_depth_width_phase(dev, repo: str) -> dict:
    """LG-adaptive-K1024 and LG-width-K1024: pinned S8 extracts 1024
    keypoints from the textured 240x320 frame and its homography-warped
    copy on the card; pinned LightGlue matches them (the CPU matches the
    same inputs) with
    - AdaptiveLightGlue at depth_confidence 0.95: the exit layer equal to
      the CPU's, one kernel call a layer run;
    - engaged_width_forward at width_confidence 0.99: the keep counts and
      the buckets they choose;
    - width_pruned_forward at 0.99 with side 1 floored at 256: the halving
      schedule 1024 -> 512 -> 256 -> 128 on side 0, so that the last layer
      runs at (M, N) = (128, 256), one kernel call a layer;
    each with matches0 equal to the CPU's on >= 99.9% of the entries,
    scores within 1e-4 (and prune0 / prune1 on >= 99.9%), and its steady
    ms a pair beside the static forward's."""
    import torch

    from nanovs_slam_torch.configs import get_config
    from nanovs_slam_torch.kernels import lightglue_transformer, \
        reset_launches
    from nanovs_slam_torch.matching import width_pruning as wp
    from nanovs_slam_torch.matching.adaptive import AdaptiveLightGlue
    from nanovs_slam_torch.matching.extractor import make_extractor
    from nanovs_slam_torch.matching.lightglue import normalize_keypoints
    from nanovs_slam_torch.matching.synthetic import textured_frame, \
        warp_frame
    from nanovs_slam_torch.models.kp2dtiny import init_model
    from nanovs_slam_torch.utils.checkpoint import load_npz_checkpoint
    from nanovs_slam_torch.utils.convert import load_jax_variables

    K = 1024
    tree, _ = load_npz_checkpoint(
        os.path.join(repo, "pinned", "extractor_S8.npz"))
    cfg = get_config("S", n_classes=8)
    ex = init_model(cfg, torch.Generator().manual_seed(SEED), "cpu")
    load_jax_variables(ex, tree["params"], tree["batch_stats"])
    img0 = textured_frame(H, W, SEED + 300)
    img1 = warp_frame(img0)
    extract = make_extractor(ex, cfg, H, W, max_keypoints=K, device=dev)
    e0, e1 = extract(img0[None] * 2 - 1), extract(img1[None] * 2 - 1)
    data = {"keypoints0": normalize_keypoints(e0["keypoints"], (W, H)),
            "keypoints1": normalize_keypoints(e1["keypoints"], (W, H)),
            "descriptors0": e0["descriptors"],
            "descriptors1": e1["descriptors"],
            "mask0": e0["mask"], "mask1": e1["mask"]}
    cpu_data = {k: v.cpu() for k, v in data.items()}
    lg = pinned_lightglue(repo).to(dev)
    cpu_lg = pinned_lightglue(repo)
    L = lg.cfg.n_layers

    def hold(name, out, ref, keys=()):
        agree = float((out["matches0"].cpu() == ref["matches0"]).float()
                      .mean())
        err = max_err(out["matching_scores0"].cpu(), ref["matching_scores0"])
        same = {k: float((out[k].cpu() == ref[k]).float().mean())
                for k in keys}
        log(f"{name}: vs CPU matches0 agree {agree:.4f}, scores max err "
            f"{err:.3g}, {json.dumps(same)}, "
            f"{int((out['matches0'] >= 0).sum())} matches")
        require(agree >= 0.999 and err <= 1e-4
                and all(v >= 0.999 for v in same.values()),
                f"{name}: card vs CPU {agree}, {err}, {same}")

    def timed(fn):
        with torch.inference_mode():
            return steady(host_ms(lambda i: fn(), 30))

    static_ms = timed(lambda: lg(data))
    paths = {}

    alg = AdaptiveLightGlue(lg, 0.95)
    reset_launches()
    out = alg(data)
    torch.cuda.synchronize()
    n = lightglue_transformer.launches
    ref = AdaptiveLightGlue(cpu_lg, 0.95)(cpu_data)
    log(f"lg adaptive: exit layer {out['exit_layer']} (CPU "
        f"{ref['exit_layer']}) of {L}, {n} kernel calls")
    require(out["exit_layer"] == ref["exit_layer"]
            and n == out["exit_layer"] + 1,
            f"lg adaptive: exit {out['exit_layer']} vs {ref['exit_layer']}, "
            f"{n} launches")
    hold("lg adaptive", out, ref)
    ms = timed(lambda: alg(data))
    log(f"lg adaptive: steady median ms a pair {ms:.3f}, the static "
        f"forward {static_ms:.3f} (host clock, synchronised)")
    with torch.inference_mode():
        log_breakdown("lg static", lambda: lg(data), static_ms)
        log_breakdown("lg adaptive", lambda: alg(data), ms)
    paths["lg_adaptive"] = {"lightglue_transformer": n}

    counts = wp._keep_count_probe(lg, data, 0.99).tolist()
    floors = [wp._pow2_at_least(int(c), 128) for c in counts]
    buckets = [wp.prune_schedule(K, L, 128, None, min(f, K)) for f in floors]
    reset_launches()
    out = wp.engaged_width_forward(lg, data, 0.99)
    torch.cuda.synchronize()
    n_engaged = lightglue_transformer.launches
    ref = wp.engaged_width_forward(cpu_lg, cpu_data, 0.99)
    log(f"lg width engaged: keep counts {counts}, floors {floors}, buckets "
        f"{buckets} ({'plain forward' if min(floors) >= K else 'pruned'}), "
        f"{n_engaged} kernel calls")
    hold("lg width engaged", out, ref, ("prune0", "prune1"))
    engaged_ms = timed(lambda: wp.engaged_width_forward(lg, data, 0.99))

    sched = [wp.prune_schedule(K, L, 128), wp.prune_schedule(K, L, 128, None,
                                                             256)]
    reset_launches()
    out = wp.width_pruned_forward(lg, data, 0.99, floor1=256)
    torch.cuda.synchronize()
    n_pruned = lightglue_transformer.launches
    ref = wp.width_pruned_forward(cpu_lg, cpu_data, 0.99, floor1=256)
    log(f"lg width pruned: buckets {sched}, {n_pruned} kernel calls")
    require(n_pruned == L, f"lg width pruned: {n_pruned} launches")
    hold("lg width pruned", out, ref, ("prune0", "prune1"))
    pruned_ms = timed(lambda: wp.width_pruned_forward(lg, data, 0.99,
                                                      floor1=256))
    log(f"lg width: steady median ms a pair engaged {engaged_ms:.3f}, "
        f"pruned {pruned_ms:.3f}, the static forward {static_ms:.3f} (host "
        "clock, synchronised)")
    log_breakdown("lg width engaged", lambda: wp.engaged_width_forward(
        lg, data, 0.99), engaged_ms)
    log_breakdown("lg width pruned", lambda: wp.width_pruned_forward(
        lg, data, 0.99, floor1=256), pruned_ms)
    paths["lg_width"] = {"lightglue_transformer": n_engaged + n_pruned}
    return paths


# --------------------------------------------------------------- family phase

def family_cell(dev, name: str, v3: bool, depth: bool, kernels: dict,
                steady: bool):
    """Serves one config (28 classes, seeded random weights and BN stats,
    scores spread as in the slice phase) through make_infer_fn(top_k=1000,
    conf_threshold=0.7) on a batch-1 and, with ``steady``, a batch-8
    request: the kernels' launch counts around them (one a request each),
    the batch-1 answer against the same model on the CPU, and the steady
    median ms per request. ``kernels``: {entry key: wrapper} of the kernels
    on this config's path. Returns (launches by entry key, {B: ms})."""
    import torch

    from nanovs_slam_torch.configs import get_config
    from nanovs_slam_torch.inference import make_infer_fn
    from nanovs_slam_torch.kernels import reset_launches
    from nanovs_slam_torch.models.kp2dtiny import init_model

    label = f"{name}{' V3' if v3 else ''}{' depth' if depth else ''}"
    gen = torch.Generator().manual_seed(SEED + 500)
    cfg = get_config(name, v3=v3, n_classes=28, depth=depth)
    model = init_model(cfg, gen, "cpu")
    randomize_bn(model, gen)
    rs = np.random.RandomState(SEED + 600)
    requests = [rs.randint(0, 256, (b, H, W, 3)).astype(np.uint8)
                for b in ((1, 8) if steady else (1,))]
    spread_scores(model, requests[0])
    cpu_model = copy.deepcopy(model)
    top_k = 1000
    infer = make_infer_fn(model, cfg, H, W, top_k=top_k, conf_threshold=0.7,
                          device=dev)
    reset_launches()
    answers = [infer(frames) for frames in requests]
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in kernels.items()}
    log(f"family {label}: launches during {len(requests)} requests "
        f"{launches}")
    for k, n in launches.items():  # one launch a request
        require(n == len(requests), f"family {label}: kernel {k} launched "
                f"{n} times in {len(requests)} requests")
    for frames, out in zip(requests, answers):
        check_answer(out, len(frames), H, W, cfg, top_k)
    ref = make_infer_fn(cpu_model, cfg, H, W, top_k=top_k,
                        conf_threshold=0.7, device="cpu")(requests[0])
    errs = compare_with_cpu(answers[0], ref)
    n_valid = [int(a["keypoint_valid"].sum()) for a in answers]
    log(f"family {label}: B=1 vs CPU {json.dumps(errs)}; valid keypoints "
        f"{n_valid} (CPU {int(ref['keypoint_valid'].sum())})")
    require(min(n_valid) > 0, f"family {label}: a request has no valid "
            "keypoint")
    ms = {}
    if steady:
        for frames in requests:
            times = []
            for _ in range(30):
                t0 = time.perf_counter()
                infer(frames)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            ms[len(frames)] = statistics.median(times[5:])
        log(f"family {label}: steady-state median ms per request "
            + ", ".join(f"B={b}: {t:.3f}" for b, t in ms.items()))
    return launches, ms


def family_phase(dev) -> dict:
    """The rest of the KP2DTiny family at 240x320: the cells V3 S_A (the
    reference's smoke-test model: decoder fusion, attention, NetVLAD) and
    V2 D (attention, ConvAP, the stem at (64, 128)), then one request each
    of V2 N_A and V3 D_A with depth and of V2 GEM_N. Returns the cells'
    launch counts by path."""
    from nanovs_slam_torch.kernels import (fused_postprocess,
                                           fused_stem_pair_pool, netvlad)

    s_a = {"fused_stem_pair_pool": fused_stem_pair_pool, "netvlad": netvlad,
           "fused_postprocess": fused_postprocess}
    # D's only stem has (C1, C2) = (64, 128): its stem launches are the
    # wide instance's
    d = {STEM_D: fused_stem_pair_pool,
         "fused_postprocess": fused_postprocess}
    gem = {k: s_a[k] for k in ("fused_stem_pair_pool", "fused_postprocess")}
    paths = {
        "family_s_a_v3": family_cell(dev, "S_A", True, False, s_a, True)[0],
        "family_d": family_cell(dev, "D", False, False, d, True)[0]}
    family_cell(dev, "N_A", False, True, s_a, False)
    family_cell(dev, "GEM_N", False, False, gem, False)
    family_cell(dev, "D_A", True, True, d, False)
    return paths


# ---------------------------------------------------------------- bf16 phase

def hold_bf16(label: str, got, peer, ref, conf: float) -> dict:
    """The card's bfloat16 answer ``got`` against the CPU's bfloat16 answer
    ``peer``, both measured from the card's float32 answer ``ref`` (all on
    the CPU), with the criteria of tests/test_torch_port_bf16.py: per
    output, got's error against ref is at most twice peer's plus 1e-3; the
    class map agrees with peer's no less than peer's agrees with ref's,
    minus one point; a cell that one side's top-K selects and the other's
    does not scores within the score tolerance of a cut."""
    import torch

    from nanovs_slam_torch.ops.postprocess import top_k_keypoints

    errs = {}
    for k in ("score", "coord", "feat", "vlad", "depth"):
        if k in ref:
            e, e_peer = max_err(got[k], ref[k]), max_err(peer[k], ref[k])
            errs[k] = {"card": e, "cpu": e_peer}
            require(e <= 2 * e_peer + 1e-3, f"{label}: {k} error against "
                    f"float32 {e} > 2 x the CPU's {e_peer} + 1e-3")
    agree = float((got["seg"] == peer["seg"]).float().mean())
    agree_peer = float((peer["seg"] == ref["seg"]).float().mean())
    errs["seg_agree"] = {"card_cpu": agree, "cpu_f32": agree_peer}
    require(agree >= agree_peer - 0.01, f"{label}: class maps agree on "
            f"{agree}, the CPU's with float32 on {agree_peer}")
    tol = 2 * errs["score"]["cpu"] + 1e-3
    k = got["keypoints"].shape[1]
    sides = [top_k_keypoints(a["score"], a["coord"], a["feat"], k, conf,
                             with_indices=True) for a in (got, peer)]
    n_diff = 0
    for b in range(got["score"].shape[0]):
        cells = [set(s[4][b][s[3][b]].tolist()) for s in sides]
        kth = min(float(s[1][b][-1]) for s in sides)
        for cell in cells[0] ^ cells[1]:
            n_diff += 1
            for a in (got, peer):
                sc = float(a["score"][b].reshape(-1)[cell])
                require(min(abs(sc - conf), abs(sc - kth)) <= tol,
                        f"{label}: cell {cell} (score {sc}) selected on "
                        "one side only, away from the cuts")
    errs["top_k_cells_one_side"] = n_diff
    errs["valid"] = {"card": int(got["keypoint_valid"].sum()),
                     "cpu": int(peer["keypoint_valid"].sum())}
    require(bool(torch.isfinite(got["descriptors"]).all()),
            f"{label}: descriptors")
    return errs


def busy_share(call, iters: int = 10) -> tuple:
    """(device ms a call, its share of the host's wall time) over ``iters``
    steady calls, by torch.profiler."""
    from nanovs_slam_torch.profile_slice import device_events, device_ms

    events, wall_ms = device_events(call, iters)
    dev_ms = device_ms(events, iters)
    return dev_ms, dev_ms * iters / wall_ms


def bf16_cell(dev, name: str, v3: bool, kernels: dict, seed: int):
    """One config at 240x320, 28 classes, seeded random weights and BN
    stats (scores spread as in the slice phase), served at bfloat16 through
    make_infer_fn(top_k=1000, conf_threshold=0.7) as entry() serves config
    N, on a batch-1 and a batch-8 uint8 request: the bfloat16 kernels'
    launch counts around them (one a request each; no float32 instance),
    the batch-1 answer held against the CPU's bfloat16 answer and the
    card's float32 answer (hold_bf16), and the steady median ms per request
    and device busy share at bfloat16 and float32, timed in turns.
    ``kernels``: {entry key: wrapper} of the bf16 kernels on the path.
    Returns the launches by entry key."""
    import torch

    from nanovs_slam_torch.configs import get_config
    from nanovs_slam_torch.inference import make_infer_fn
    from nanovs_slam_torch.kernels import KERNELS, reset_launches
    from nanovs_slam_torch.models.kp2dtiny import build_model, init_model

    label = f"bf16 {name}{' V3' if v3 else ''}"
    cfg32 = get_config(name, v3=v3, n_classes=28)
    cfg16 = get_config(name, v3=v3, n_classes=28, dtype="bfloat16")
    gen = torch.Generator().manual_seed(seed)
    model32 = init_model(cfg32, gen, "cpu")
    randomize_bn(model32, gen)
    rs = np.random.RandomState(seed)
    requests = [rs.randint(0, 256, (b, H, W, 3)).astype(np.uint8)
                for b in (1, 8)]
    spread_scores(model32, requests[0])
    model16 = build_model(cfg16).eval()
    model16.load_state_dict(model32.state_dict())
    cpu16 = copy.deepcopy(model16)
    kw = dict(top_k=1000, conf_threshold=0.7)
    infer16 = make_infer_fn(model16, cfg16, H, W, device=dev, **kw)
    infer32 = make_infer_fn(model32, cfg32, H, W, device=dev, **kw)

    reset_launches()
    answers = [infer16(frames) for frames in requests]
    torch.cuda.synchronize()
    launches = {k: w.launches_bf16 for k, w in kernels.items()}
    f32 = {k.__name__: k.launches for k in KERNELS if k.launches}
    log(f"{label}: launches during {len(requests)} requests {launches}, "
        f"float32 instances {f32}")
    require(all(n == len(requests) for n in launches.values()) and not f32,
            f"{label}: launches {launches}, float32 instances {f32}")
    for frames, out in zip(requests, answers):
        check_answer(out, len(frames), H, W, cfg16, kw["top_k"])
    ref = {k: v.cpu() for k, v in infer32(requests[0]).items()}
    peer = make_infer_fn(cpu16, cfg16, H, W, device="cpu",
                         **kw)(requests[0])
    errs = hold_bf16(label, {k: v.cpu() for k, v in answers[0].items()},
                     peer, ref, kw["conf_threshold"])
    log(f"{label}: B=1 vs the CPU at bf16 and the card at float32 "
        f"{json.dumps(errs)}")

    ms = {}
    for frames in requests:
        times = {"float32": [], "bfloat16": []}
        for dt in ("float32", "bfloat16", "bfloat16", "float32") * 8:
            infer = infer16 if dt == "bfloat16" else infer32
            t0 = time.perf_counter()
            infer(frames)
            torch.cuda.synchronize()
            times[dt].append((time.perf_counter() - t0) * 1e3)
        for dt, infer in (("float32", infer32), ("bfloat16", infer16)):
            dev_ms, share = busy_share(lambda: infer(frames))
            ms[f"{dt}_B{len(frames)}"] = {
                "ms": statistics.median(times[dt][4:]), "device_ms": dev_ms,
                "busy": share}
    log(f"{label}: steady median ms per request (host clock, float32 and "
        f"bf16 in turns) and device busy share {json.dumps(ms)}")
    return launches


def bf16_phase(dev) -> dict:
    """The bfloat16 cells: KP2DTiny-N as entry() runs it, V3 S_A and V2 D,
    each at batch 1 and 8 (bf16_cell). Returns their launches by path."""
    from nanovs_slam_torch.kernels import (fused_postprocess,
                                           fused_stem_pair_pool, netvlad)

    n = {STEM_BF16: fused_stem_pair_pool, PP_BF16: fused_postprocess,
         NV_BF16: netvlad}
    d = {STEM_BF16: fused_stem_pair_pool, PP_BF16: fused_postprocess}
    return {"n_bf16": bf16_cell(dev, "N", False, n, SEED + 1100),
            "s_a_v3_bf16": bf16_cell(dev, "S_A", True, n, SEED + 1200),
            "d_bf16": bf16_cell(dev, "D", False, d, SEED + 1300)}


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
    and the rest in float32, ms."""
    t_ops = attn_flops / TF32_3X_FLOP_PER_S + (flops - attn_flops) \
        / FP32_FLOP_PER_S
    return max(nbytes / HBM_BYTES_PER_S, t_ops) * 1e3


def lightglue_bounds(B, M, N, D, L, P) -> dict:
    """The stack's three bounds, ms: float32 on the CUDA cores
    (``float32``), its attention in 3xTF32 on the tensor cores
    (``attn_3xtf32``), and all of it in 3xTF32 (``all_3xtf32``); the
    least, the kernels line's ``bound_ms``, is the last (operations)."""
    work = lightglue_work(B, M, N, D, L, P)
    return {"float32": bound(*work[:2])[0],
            "attn_3xtf32": bound_3xtf32(*work),
            "all_3xtf32": bound(*work[:2], TF32_3X_FLOP_PER_S)[0]}


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


def default_lightglue():
    """LightGlue at config "default" (D = 256, 9 layers, 4 heads) with
    PyTorch's initialisation drawn from the seed."""
    import torch

    from nanovs_slam_torch.matching.configs import LIGHTGLUE_CONFIGS
    from nanovs_slam_torch.matching.lightglue import LightGlue

    torch.manual_seed(SEED)
    return LightGlue(LIGHTGLUE_CONFIGS["default"]).eval()


def lightglue_kernel_phase(dev, lg, key: str, name: str) -> dict:
    """The LightGlue stack of ``lg`` against its twin at K = 512 and 1024,
    padded and with image 1 fully masked, timed at the two K; and one
    layer a call (the adaptive-depth and width-pruning paths' calls) at
    the buckets (M, N) = (512, 256) and (128, 128), timed; the kernels
    line's entry ``key`` named ``name``."""
    import torch
    import torch.nn.functional as F

    from nanovs_slam_torch.kernels import lightglue as lg_kernel
    from nanovs_slam_torch.kernels.lightglue import (
        HEADS, KERNELS_PER_LAYER, device_kernels, lightglue_transformer,
        lightglue_transformer_plain)

    D, L = lg.cfg.descriptor_dim, lg.cfg.n_layers
    P = lg.packed_weights().shape[1]
    log(f"kernel {name}: one call enqueues "
        f"{device_kernels(L)} device kernels ({KERNELS_PER_LAYER} a "
        f"layer, {L} layers, and the first layer's self projection)")
    if D == 256:  # the plan as the card takes it, once, against the design
        for K in (512, 1024):
            plan = lg_kernel.device_plan(1, K, K)
            log(f"kernel {name} plan at K={K}: {json.dumps(plan)}")
            attn_blocks = plan["attn_grid_x"] * plan["attn_grid_y"] \
                * plan["attn_grid_z"]
            require(plan["attn_blocks_per_sm"] >= 2
                    and (K != 512 or attn_blocks >= 128),
                    f"{name}: attention plan at K={K}: {plan}")
            require(bool(plan["row_tiled"]) == (K == 1024)
                    and (K != 512 or (plan["row_grid"] >= 128
                                      and plan["row_cluster"] == 4)),
                    f"{name}: row-stage plan at K={K}: {plan}")
    entry = {"name": name, "route": "cuda",
             "source": "nanovs_slam_torch/csrc/lightglue.cu",
             "replaces": "nanovs_slam_tpu/ops/pallas/lightglue_kernel.py:265"}
    every = range(L)
    cases = [("K512", 512, 512, 0, 0, False, every),
             ("K1024", 1024, 1024, 0, 0, False, every),
             ("M512_N384_masked", 512, 384, 51, 154, False, every),
             ("image1_empty", 512, 384, 0, 0, True, every),
             ("layer1_M512_N256", 512, 256, 0, 40, False, range(1, 2)),
             ("layer3_M128_N128", 128, 128, 9, 0, False, range(3, 4))]
    for seed, (tag, M, N, pad0, pad1, empty1, layers) in enumerate(cases):
        args = lightglue_args(lg, dev, 1, M, N, pad0, pad1, empty1,
                              SEED + 400 + seed)
        # D = 256: the weights' TF32 fragments, which the row stage reads
        split = lg_kernel.split_weights(args[8]) if D == 256 else None
        got = lightglue_transformer(*args, layers, split)
        want = lightglue_transformer_plain(*args, layers)
        torch.cuda.synchronize()
        err = max_err(got, want)
        require(err <= 1e-4, f"{name} {tag}: max_abs_err {err}")
        require(all(bool(torch.isfinite(g).all()) for g in got),
                f"{name} {tag}: not finite")
        if layers != every:  # one layer a call: checked and timed
            ms = cuda_ms(lambda: lightglue_transformer(*args, layers, split))
            bounds = lightglue_bounds(1, M, N, D, 1, P)
            b_ms, b_by = bounds["all_3xtf32"], "operations"
            log(f"kernel {name} {tag}: max_abs_err {err:.3g}, kernel "
                f"{ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}; float32 "
                f"{bounds['float32']:.5f}, attention in 3xTF32 "
                f"{bounds['attn_3xtf32']:.5f})")
            entry.update({f"max_abs_err_{tag}": err, f"ms_{tag}": ms,
                          f"bound_ms_{tag}": b_ms})
            continue
        if tag not in ("K512", "K1024"):
            log(f"kernel {name} {tag}: max_abs_err {err:.3g}")
            entry[f"max_abs_err_{tag}"] = err
            continue
        ms = cuda_ms(lambda: lightglue_transformer(*args, split=split),
                     inner=10)
        plain_ms = device_sum_ms(lambda: lightglue_transformer_plain(
            *args, range(L)))
        keys = {}
        if D == 256:
            if tag == "K512":
                split_entry = split_weights_entry(dev, args[8])
            # the row stage's cuBLAS yardstick: fc1's product in float32
            g = torch.Generator(device=dev).manual_seed(SEED)
            xa = torch.randn(M + N, 2 * D, device=dev, generator=g)
            wa = torch.randn(2 * D, 2 * D, device=dev, generator=g)
            keys["row_library_ms"] = cuda_ms(lambda: torch.matmul(xa, wa))
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
                lambda: lightglue_transformer(*args, split=split),
                device_kernels(L))
        finally:
            lightglue_transformer.pdl = True
        require(round(per_call) == device_kernels(L),
                f"{name} {tag}: {per_call} device kernels a "
                f"call, expected {device_kernels(L)}")
        def launch_ms(part):  # PDL off: one launch's own time, mean
            t = [t for k, (_, t) in parts.items() if part in k]
            return statistics.mean(t) if t else None
        attn_ms, row_ms = launch_ms("attn_kernel"), launch_ms("row_")
        bounds = lightglue_bounds(1, M, N, D, L, P)
        b_ms, b_by = bounds["all_3xtf32"], "operations"
        log(f"kernel {name} {tag}: max_abs_err {err:.3g}, "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{b_ms:.5f} ms ({b_by}, all in 3xTF32 on the tensor cores; "
            f"with the attention in 3xTF32 and the rest in float32 "
            f"{bounds['attn_3xtf32']:.5f} ms, all in float32 "
            f"{bounds['float32']:.5f} ms); per launch (PDL off): attention "
            f"{'n/a' if attn_ms is None else f'{attn_ms:.4f} ms'}, row "
            f"stage {'n/a' if row_ms is None else f'{row_ms:.4f} ms'}; sdpa "
            f"{library_ms:.4f} ms"
            + (f"; fc1 in cuBLAS (float32) {keys['row_library_ms']:.4f} ms"
               if "row_library_ms" in keys else ""))
        log("  per launch, PDL off, by kernel:")
        for kname, (n, t) in sorted(parts.items(), key=lambda kv: -kv[1][1]):
            log(f"  {t:.4f} ms x{n:g} a call  {kname[:80]}")
        keys.update({"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "bound_ms_attn_3xtf32": bounds["attn_3xtf32"],
                     "bound_ms_float32": bounds["float32"],
                     "library_ms": library_ms, "attn_launch_ms": attn_ms,
                     "row_launch_ms": row_ms})
        suffix = "" if tag == "K512" else "_k1024"
        entry.update({k + suffix: v for k, v in keys.items()})
    entry["library"] = ("torch.nn.functional.scaled_dot_product_attention, "
                        "one call over the two images of one self-attention "
                        "launch; the stack has no single library call")
    if D == 256:
        entry["row_library"] = ("torch.matmul, float32 (TF32 off): fc1's "
                                "product (M+N, 2D) x (2D, 2D), the row "
                                "stage's cuBLAS yardstick")
        return {key: entry, "split_weights": split_entry}
    return {key: entry}


def split_weights_entry(dev, packed) -> dict:
    """The D = 256 weights' TF32 fragments (made once with the packed
    weights, on the default match's path) against their plain version,
    bit for bit, timed; their bound is the bytes (packed read, fragments
    written)."""
    import torch

    from nanovs_slam_torch.kernels.lightglue import (split_weights,
                                                     split_weights_plain)

    got = split_weights(packed)
    want = split_weights_plain(packed, 256)
    torch.cuda.synchronize()
    require(torch.equal(got.view(torch.int32), want.view(torch.int32)),
            "split_weights: not the plain layout bit for bit")
    ms = cuda_ms(lambda: split_weights(packed))
    plain_ms = device_sum_ms(lambda: split_weights_plain(packed, 256))
    b_ms, b_by = bound(4 * (packed.numel() + got.numel()), 0)
    log(f"kernel split_weights: (L, P) {tuple(packed.shape)} -> "
        f"{tuple(got.shape)}, equal to the plain bit for bit, kernel "
        f"{ms:.4f} ms (once a weight load), plain {plain_ms:.4f} ms summed "
        f"device time, bound {b_ms:.5f} ms ({b_by})")
    return {"name": "split_weights", "route": "cuda",
            "source": "nanovs_slam_torch/csrc/lightglue.cu",
            "replaces": "nanovs_slam_tpu/ops/pallas/lightglue_kernel.py:265",
            "max_abs_err": max_err(got, want), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None}


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


# ---------------------------------------------------------------- train phase

TRAIN_HW, TRAIN_B = (120, 160), 4  # the COCO-Stuff train config's


def train_batch(seed: int) -> dict:
    """One training batch of the trainer's fallback data at its size:
    SyntheticShapesDataset (28 classes) through the PairLoader's host
    augments and homographies, the pair built on the CPU."""
    from nanovs_slam_torch.data.datasets import SyntheticShapesDataset
    from nanovs_slam_torch.data.pipeline import PairLoader

    h, w = TRAIN_HW
    loader = PairLoader(SyntheticShapesDataset((h, w), 64, 28, seed=0),
                        TRAIN_B, h, w, seed=seed, device="cpu")
    return next(iter(loader))


def train_state(device):
    """Config S V2 (28 classes) with init_model's seeded weights and a
    seeded inlier net, Adam at 5e-4 on the cosine warm-restart schedule,
    as the CLI builds them."""
    import torch

    from nanovs_slam_torch.configs import get_config
    from nanovs_slam_torch.models.inlier_net import init_inlier_net
    from nanovs_slam_torch.models.kp2dtiny import init_model
    from nanovs_slam_torch.train.schedules import make_lr_schedule
    from nanovs_slam_torch.train.train_step import (create_train_state,
                                                    make_optimizer)

    cfg = get_config("S", n_classes=28)
    model = init_model(cfg, torch.Generator().manual_seed(SEED), device)
    io = init_inlier_net(torch.Generator().manual_seed(SEED + 2),
                         device=device)
    spec = make_optimizer("adam", schedule=make_lr_schedule(
        "cosine", 5e-4, 16, 20))  # 64 synthetic items at batch 4
    return cfg, create_train_state(model, spec, io_net=io)


def compare_train_steps(card, cpu, lr: float) -> dict:
    """One step's results on the card against the CPU's: loss terms within
    1e-4 of max(1, |term|), grad_norm within 1e-4 relative, BN buffers
    within 1e-5, the raw gradients within 5e-2 in relative L2, and the
    parameters within 1e-5 wherever both gradients are at least 1e-6 and
    agree in sign. Elementwise the gradients are not float32-close: the
    keypoint losses pick nearest neighbours, hardest negatives and
    associations by argmin, and LeakyReLU kinks and max-pools select too,
    so float32 noise flips near-tied choices (on the CPU alone, 1e-6 of
    input noise moves the keypoint terms' gradient by 1.4% in L2, the
    segmentation term's by 0.13%). Adam's first step, lr g / (|g| + 1e-8),
    turns a flipped sign into up to 2 lr: those weights (counted) are held
    to 2 lr."""
    import torch

    (c_state, c_met), (p_state, p_met) = card, cpu
    errs = {}
    for k, v in p_met.items():
        err = abs(c_met[k] - v)
        lim = 1e-4 * (abs(v) if k == "grad_norm" else max(1.0, abs(v)))
        require(err <= lim, f"train: {k} card {c_met[k]} cpu {v}")
        errs[k] = err
    p_max = b_max = 0.0
    n_flip = 0
    g_diff = g_ref = 0.0
    for c_net, p_net in ((c_state.model, p_state.model),
                         (c_state.io_net, p_state.io_net)):
        cpu_params = dict(p_net.named_parameters())
        for k, p in c_net.named_parameters():
            q = cpu_params[k]
            d = (p.detach().cpu() - q.detach()).abs()
            gc = p.grad.cpu() if p.grad is not None else torch.zeros_like(q)
            gp = q.grad if q.grad is not None else torch.zeros_like(q)
            g_diff += float(((gc - gp) ** 2).sum())
            g_ref += float((gp ** 2).sum())
            agree = ((gc.abs() >= 1e-6) & (gp.abs() >= 1e-6)
                     & (torch.sign(gc) == torch.sign(gp)))
            if agree.any():
                p_max = max(p_max, d[agree].max().item())
            require(d.max().item() <= 2 * lr, f"train: parameter {k}")
            n_flip += int((torch.sign(gc) != torch.sign(gp)).sum())
        cpu_bufs = dict(p_net.named_buffers())
        for k, b in c_net.named_buffers():
            if b.is_floating_point():
                b_max = max(b_max, max_err(b.cpu(), cpu_bufs[k]))
    g_rel = (g_diff / g_ref) ** 0.5
    errs.update(params=p_max, bn_buffers=b_max, grad_rel_l2=g_rel,
                grad_sign_flips=n_flip)
    log(f"train: one step, card vs CPU {json.dumps(errs)}")
    require(g_rel <= 5e-2, f"train: gradients {g_rel} apart (relative L2)")
    require(p_max <= 1e-5, f"train: parameters {p_max} apart")
    require(b_max <= 1e-5, f"train: BN buffers {b_max} apart")
    return errs


def train_phase(dev, repo: str) -> dict:
    """The multitask training path on the card (config S V2, 28 classes,
    120x160, batch 4, Adam 5e-4 cosine, top_k 300, all heads but depth):
    one step against the CPU with dropout at rate 0 on both sides; 20
    steps with dropout on through make_train_step as the CLI builds it (a
    fixed batch: finite losses; the loss without the IO term falls, and
    so does the IO term over the steps where its gate (more than 10
    inliers) is open; NetVLAD's forward and backward
    kernels twice a step, the stem and postprocess kernels never), timed
    (host clock, synchronised); its device breakdown; then the CLI in a
    subprocess on the card, whose .npz loads back into the port. Returns
    the path's launch counts."""
    import tempfile

    import torch

    from nanovs_slam_torch.configs import get_config
    from nanovs_slam_torch.kernels import (KERNELS, netvlad, netvlad_backward,
                                           reset_launches)
    from nanovs_slam_torch.models.inlier_net import InlierNet
    from nanovs_slam_torch.models.kp2dtiny import build_model
    from nanovs_slam_torch.modules.blocks import set_dropout
    from nanovs_slam_torch.train.schedules import DEFAULT_LOSS_WEIGHTS
    from nanovs_slam_torch.train.train_step import make_train_step
    from nanovs_slam_torch.utils.checkpoint import load_npz_checkpoint
    from nanovs_slam_torch.utils.convert import (load_jax_inlier_net,
                                                 load_jax_variables)

    h, w = TRAIN_HW
    batch = train_batch(SEED)
    weights = DEFAULT_LOSS_WEIGHTS
    results = []  # the card's step, then the CPU's
    for device in (dev, torch.device("cpu")):
        cfg, state = train_state(device)
        set_dropout(state.model, rate=0.0)
        step = make_train_step(cfg, h, w, io_top_k=300)
        state, met = step(state, {k: v.to(device) for k, v in batch.items()},
                          weights)
        results.append((state, {k: float(v) for k, v in met.items()}))
    log(f"train: one step's terms on the card {json.dumps(results[0][1])}")
    compare_train_steps(*results, 5e-4)

    cfg, state = train_state(dev)
    set_dropout(state.model, generator=torch.Generator(dev).manual_seed(
        SEED + 1))
    step = make_train_step(cfg, h, w, io_top_k=300)
    dbatch = {k: v.to(dev) for k, v in batch.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, io_terms, step_ms = [], [], []
    for _ in range(20):
        t0 = time.perf_counter()
        state, met = step(state, dbatch, weights)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(met["total_loss"]))
        io_terms.append(float(met["io_loss"]))
    launches = {k.__name__: k.launches for k in KERNELS}
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    log(f"train: launches during 20 steps {launches}")
    require(launches["netvlad"] == 40 and launches["netvlad_backward"] == 40,
            "train: NetVLAD forward and backward should launch twice a step")
    require(all(n == 0 for k, n in launches.items()
                if k not in ("netvlad", "netvlad_backward")),
            "train: a serving kernel launched on the train path")
    require(all(math.isfinite(v) for v in losses), f"train: losses {losses}")
    # the IO term is gated by its inlier count (> 10), which opens and
    # shuts from step to step: the loss without it, and the IO term over
    # the steps where it is open, must fall
    rest = [t - weights.keypoint_loss * io for t, io in zip(losses, io_terms)]
    opened = [io for io in io_terms if io > 0]
    log(f"train: 20 steps on a fixed batch (dropout on): total loss "
        + ", ".join(f"{v:.3f}" for v in losses) + "; without the IO term "
        + ", ".join(f"{v:.3f}" for v in rest) + f"; the IO term open in "
        f"{len(opened)} steps: " + ", ".join(f"{v:.3f}" for v in opened))
    require(rest[-1] < rest[0], "train: the loss without the IO term did "
            "not fall")
    require(len(opened) < 2 or opened[-1] < opened[0],
            "train: the IO term did not fall")
    ms = steady(step_ms)
    log(f"train: ms a step {ms:.3f} (steady median of the 20, host clock, "
        f"synchronised), {1e3 / ms:.2f} steps a second; first step "
        f"{step_ms[0]:.1f} ms; peak memory {peak:.1f} MiB")
    log_breakdown("train: a step", lambda: step(state, dbatch, weights), ms)

    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, PYTHONPATH=repo)
        out = os.path.join(tmp, "ck")
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "nanovs_slam_torch.train_multitask",
             "--no_eval", "--n_epochs", "1", "--max_steps_per_epoch", "5",
             "--log_every", "1", "--out_model_path", out], cwd=tmp, env=env,
            capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t0
        log("train: CLI " + " | ".join(r.stdout.strip().splitlines()[-3:]))
        require(r.returncode == 0, f"train: the CLI failed\n{r.stdout}\n"
                f"{r.stderr}")
        tree, meta = load_npz_checkpoint(out + ".npz")
    cfg = get_config("S", n_classes=28)
    model = load_jax_variables(build_model(cfg), tree["params"],
                               tree["batch_stats"]).to(dev).eval()
    load_jax_inlier_net(InlierNet(), tree["io_params"],  # strict: raises
                        tree["io_batch_stats"])           # on any mismatch
    with torch.no_grad():
        out = model(batch["image"][:1].permute(0, 3, 1, 2).to(dev))
    require(all(torch.isfinite(v).all() for v in out.values()),
            "train: the CLI's checkpoint gives a non-finite forward")
    log(f"train: CLI 5 steps in {cli_s:.1f} s (process start and data "
        f"included); its .npz loads back (step {meta['step']}, epoch "
        f"{meta['epoch']}) and serves a finite forward")
    require(meta["step"] == 5, f"train: the CLI saved step {meta['step']}")
    return {"train": launches}


# ---------------------------------------------------------------- eval phase

EVAL_PAIRS = 8


class _Recorder:
    """Replaces ``module.name`` by a wrapper that records each call's
    host-clock ms (synchronised) and result, until ``restore``."""

    def __init__(self, module, name: str):
        import torch

        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.ms, self.results = [], []

        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            out = self.fn(*args, **kwargs)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.ms.append((time.perf_counter() - t0) * 1e3)
            self.results.append(out)
            return out

        setattr(module, name, wrapper)

    def restore(self) -> None:
        setattr(self.module, self.name, self.fn)


def eval_tasks(model, cfg, device, pairs, seg_items) -> tuple:
    """The evaluation tasks of the CLI's keypoint, segmentation and visloc
    branches on ``pairs`` and ``seg_items`` with ``model`` on ``device``:
    (results, per-pair compute_homography answers, host ms of the
    keypoint evaluation, of its requests and of its homography estimates,
    of the segmentation, and the retrieval's database and queries)."""
    import torch

    from nanovs_slam_torch.evaluation import descriptor, keypoints
    from nanovs_slam_torch.evaluation.global_descriptor import \
        evaluate_global_descriptor
    from nanovs_slam_torch.evaluation.segmentation import \
        evaluate_segmentation
    from nanovs_slam_torch.inference import make_eval_fn

    infer = make_eval_fn(model, cfg, H, W)
    request_ms = []

    def timed_infer(images):  # numpy out: the copy back synchronises
        t0 = time.perf_counter()
        out = infer(images)
        request_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    homs = _Recorder(keypoints, "compute_homography")
    ransac = _Recorder(descriptor, "find_homography_ransac")
    res, times = {}, {}
    try:
        for k in (300, 1000):
            t0 = time.perf_counter()
            res[f"keypoints_top{k}"] = keypoints.evaluate_keypoint_net(
                pairs, timed_infer, (W, H), k)
            times[f"kp{k}"] = (time.perf_counter() - t0) * 1e3
    finally:
        homs.restore()
        ransac.restore()
    t0 = time.perf_counter()
    res["segmentation"] = evaluate_segmentation(iter(seg_items), infer,
                                                cfg.n_classes)
    times["seg"] = (time.perf_counter() - t0) * 1e3
    db = torch.from_numpy(np.stack([infer(p["image"])["vlad"][0]
                                    for p in pairs])).to(device)
    q = torch.from_numpy(np.stack([infer(p["image_aug"])["vlad"][0]
                                   for p in pairs])).to(device)
    positives = [np.array([i]) for i in range(len(pairs))]
    res["visloc"] = evaluate_global_descriptor(db, q, positives, (1, 5))
    times.update(requests=sum(request_ms), ransac=sum(ransac.ms))
    return res, homs.results, times, (db, q)


def eval_phase(dev, repo: str) -> dict:
    """The evaluation path (``evaluation/*`` through ``inference.make_
    eval_fn``) on the card against the CPU: pinned S8 at 240x320 on 8
    synthetic homography pairs made on the card by the trainer's
    ``synthetic_homography_pairs`` (``SyntheticShapesDataset`` images),
    ``evaluate_keypoint_net`` at top_k 300 and 1000, ``evaluate_
    segmentation`` over the 8 images, ``evaluate_global_descriptor`` (the
    originals the database, the warps the queries; the search on the
    card): segmentation, repeatability, localisation error and matching
    score within 1e-3, each threshold's correctness equal on at least 7
    of the 8 pairs, retrieval equal; the kernels' launches (one of each a
    request); ms a pair (requests, and the host's metric tail with its
    homography estimator), a segmentation item, a ``knn_l2``. Then a
    seeded config S with depth through ``evaluate_depth``, card against
    CPU within 1e-4 relative, and the trainer's CLI (``main()`` in
    process, 1 epoch of 3 steps, ``--full_eval 1 --max_eval_items 8``),
    whose checkpoint must hold numbers for segmentation, keypoints and
    visloc (VO is skipped without cv2, and only so). Returns the eval
    path's launch counts."""
    import tempfile

    import torch

    from nanovs_slam_torch import train_multitask
    from nanovs_slam_torch.configs import get_config
    from nanovs_slam_torch.data.datasets import SyntheticShapesDataset
    from nanovs_slam_torch.evaluation.depth import evaluate_depth
    from nanovs_slam_torch.evaluation.global_descriptor import knn_l2
    from nanovs_slam_torch.inference import make_eval_fn
    from nanovs_slam_torch.kernels import KERNELS, reset_launches
    from nanovs_slam_torch.models.kp2dtiny import build_model, init_model
    from nanovs_slam_torch.ops.image import resize_nearest
    from nanovs_slam_torch.utils.checkpoint import load_npz_checkpoint
    from nanovs_slam_torch.utils.convert import load_jax_variables

    import importlib.util

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    log(f"eval: numpy {np.__version__}; cv2 "
        + ("installed" if importlib.util.find_spec("cv2") else "absent")
        + " (the metric tail does not use it)")
    tree, _ = load_npz_checkpoint(os.path.join(repo, "pinned",
                                               "extractor_S8.npz"))
    cfg = get_config("S", n_classes=8)
    models = {d: load_jax_variables(build_model(cfg), tree["params"],
                                    tree["batch_stats"]).to(d).eval()
              for d in (dev, cpu)}
    ds = SyntheticShapesDataset((H, W), EVAL_PAIRS, 8, seed=SEED + 13)
    pairs = train_multitask.synthetic_homography_pairs(ds, (H, W),
                                                       EVAL_PAIRS, dev)
    hs, ws = 2 * (H // cfg.cell), 2 * (W // cfg.cell)
    seg_items = [{"image": ds[i]["image"][None] * 2 - 1,
                  "seg": resize_nearest(ds[i]["seg"], hs, ws)[None]}
                 for i in range(EVAL_PAIRS)]

    make_eval_fn(models[dev], cfg, H, W)(pairs[0]["image"])  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    card, card_homs, t, (db, q) = eval_tasks(models[dev], cfg, dev, pairs,
                                             seg_items)
    launches = {k.__name__: k.launches for k in KERNELS}
    requests = EVAL_PAIRS * 2 * 2 + EVAL_PAIRS + 2 * EVAL_PAIRS
    log(f"eval: launches {launches} over {requests} requests (8 pairs x 2 "
        f"x 2 top_k, 8 segmentation items, 16 retrieval images)")
    for k in ("fused_stem_pair_pool", "fused_postprocess", "netvlad"):
        require(launches[k] == requests,
                f"eval: {k} launched {launches[k]} times, not one a request")
    require(all(launches[k] == 0 for k in launches if k not in (
        "fused_stem_pair_pool", "fused_postprocess", "netvlad")),
        "eval: a kernel off the eval path launched")
    cpu_res, cpu_homs, _, _ = eval_tasks(models[cpu], cfg, cpu, pairs,
                                         seg_items)
    log("eval: card " + json.dumps(card, default=str))
    log("eval: cpu  " + json.dumps(cpu_res, default=str))

    gaps = {}
    for task, keys in (("segmentation", ("IoU", "IoU_macro", "accuracy",
                                         "f1")),
                       ("keypoints_top300", ("repeatability",
                                             "localization_error", "mscore")),
                       ("keypoints_top1000", ("repeatability",
                                              "localization_error",
                                              "mscore"))):
        for k in keys:
            gap = abs(card[task][k] - cpu_res[task][k])
            gaps[f"{task}/{k}"] = gap
            require(gap <= 1e-3, f"eval: {task} {k} card {card[task][k]} "
                    f"cpu {cpu_res[task][k]}")
    require(card["visloc"] == cpu_res["visloc"],
            f"eval: retrieval {card['visloc']} against {cpu_res['visloc']}")
    n = len(card_homs) // 2
    for i, top_k in enumerate((300, 1000)):
        a, b = card_homs[i * n:(i + 1) * n], cpu_homs[i * n:(i + 1) * n]
        for j, thr in enumerate((1, 3, 5)):
            same = sum(x[j] == y[j] for x, y in zip(a, b))
            require(same >= EVAL_PAIRS - 1, f"eval: correctness{thr} at "
                    f"top_k {top_k} equal on {same} of {EVAL_PAIRS} pairs")
        dists = [abs(x[3] - y[3]) for x, y in zip(a, b)]
        gaps[f"keypoints_top{top_k}/mean_dist (largest)"] = max(dists)
        log(f"eval: top_k {top_k} mean corner distance a pair, card "
            + ", ".join(f"{x[3]:.4f}" for x in a) + "; cpu "
            + ", ".join(f"{y[3]:.4f}" for y in b))
    log("eval: card against CPU, largest gaps " + json.dumps(gaps))
    repeat = card["keypoints_top300"]["repeatability"]
    require(repeat > 0, f"eval: repeatability {repeat}: no keypoint above "
            "the 0.7 threshold")

    card_name = card_line()
    n_req = EVAL_PAIRS * 4
    kp_ms = (t["kp300"] + t["kp1000"]) / (2 * EVAL_PAIRS)
    req_ms = t["requests"] / (2 * EVAL_PAIRS)
    infer = make_eval_fn(models[dev], cfg, H, W)
    dev_ms, share = busy_share(lambda: infer(pairs[0]["image"]))
    log(f"eval ({card_name}): ms a keypoint pair {kp_ms:.3f} (host clock, "
        f"mean of {n_req // 2} pair evaluations): its two requests "
        f"{req_ms:.3f} (upload, forward, download; device {2 * dev_ms:.3f} "
        f"ms by the profiler, {100 * share:.1f}% busy), the host's metric "
        f"tail {kp_ms - req_ms:.3f}, of it the homography estimator "
        f"{t['ransac'] / (2 * EVAL_PAIRS):.3f}")
    log(f"eval ({card_name}): ms a segmentation item "
        f"{t['seg'] / EVAL_PAIRS:.3f} (host clock)")
    knn = host_ms(lambda i: knn_l2(q, db, 5), 20)
    knn_dev = device_sum_ms(lambda: knn_l2(q, db, 5))
    log(f"eval ({card_name}): ms a knn_l2 (8 queries, 8 entries, D "
        f"{db.shape[1]}) {steady(knn):.3f} (host clock, with the indices' "
        f"copy back; steady median of 20), device {knn_dev:.4f} (the "
        f"profiler's summed kernel time)")

    # depth: a seeded config S with the depth head
    dcfg = get_config("S", n_classes=8, depth=True)
    dmodel = init_model(dcfg, torch.Generator().manual_seed(SEED), "cpu")
    randomize_bn(dmodel, torch.Generator().manual_seed(SEED + 1))
    dds = SyntheticShapesDataset((H, W), 4, 8, seed=SEED + 14,
                                 with_depth=True)
    ditems = [{"image": dds[i]["image"][None] * 2 - 1,
               "depth": resize_nearest(dds[i]["depth"], hs, ws)[None]}
              for i in range(len(dds))]
    depth = {}
    for name, d in (("card", dev), ("cpu", cpu)):
        m = copy.deepcopy(dmodel).to(d).eval()
        depth[name] = evaluate_depth(iter(ditems),
                                     make_eval_fn(m, dcfg, H, W))
    rel = {k: abs(depth["card"][k] - v) / max(abs(v), 1e-12)
           for k, v in depth["cpu"].items()}
    log(f"eval: depth card {json.dumps(depth['card'])}; largest relative "
        f"gap to the CPU {max(rel.values()):.2e} ({max(rel, key=rel.get)})")
    require(all(math.isfinite(v) for v in depth["card"].values()),
            "eval: depth metrics not finite")
    require(max(rel.values()) <= 1e-4, f"eval: depth against the CPU {rel}")

    # the trainer with its evaluation on
    timed = _Recorder(train_multitask, "evaluate_model")
    reset_launches()
    cwd = os.getcwd()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            os.chdir(tmp)
            out = os.path.join(tmp, "ck")
            train_multitask.main(
                ["--n_epochs", "1", "--max_steps_per_epoch", "3",
                 "--log_every", "1", "--full_eval", "1",
                 "--max_eval_items", "8", "--out_model_path", out])
            _, meta = load_npz_checkpoint(out + ".npz")
    finally:
        os.chdir(cwd)
        timed.restore()
    results = meta["results"]
    trained = {k.__name__: k.launches for k in KERNELS}
    log(f"eval: the trainer's evaluation ({card_name}) "
        f"{timed.ms[0]:.1f} ms (host clock, synchronised; 120x160, 8 items)"
        f"; launches in the run (3 steps and the evaluation) {trained}")
    for task in ("segmentation", "keypoints", "visloc"):
        r = results.get(task)
        require(isinstance(r, dict) and "error" not in r and r,
                f"eval: the trainer's {task} result {r}")
    require(isinstance(results["keypoints"]["repeatability"], (int, float)),
            f"eval: keypoints {results['keypoints']}")
    vo = results.get("vo", {})
    if "skipped" in vo:
        require("cv2" in vo["skipped"], f"eval: VO skipped: {vo}")
        log(f"eval: the trainer's VO skipped: {vo['skipped']}")
    else:
        require("error" not in vo and math.isfinite(vo.get("mean", math.nan)),
                f"eval: the trainer's VO {vo}")
    log("eval: the trainer's results " + json.dumps(results, default=str))
    log(f"eval: phase {time.perf_counter() - t_phase:.1f} s")
    return {"eval": launches}


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

    card = card_line()
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
    kernels.update(lightglue_kernel_phase(dev, pinned_lightglue(repo),
                                          "lightglue_transformer",
                                          "lightglue_transformer"))
    kernels.update(lightglue_kernel_phase(dev, default_lightglue(), LG_D256,
                                          "lightglue_transformer[256]"))
    paths = {"n_slice": slice_phase(dev, (fused_postprocess,
                                          fused_stem_pair_pool, netvlad))[0]}
    paths.update(bf16_phase(dev))
    weights_phase(dev, repo)
    paths["match"] = match_phase(dev, repo, (fused_postprocess,
                                             fused_stem_pair_pool,
                                             lightglue_transformer))
    paths["odd_request"] = odd_request_phase(dev)
    paths["lightglue_default"] = lightglue_default_phase(dev)
    cor = corridor_setup(dev, repo)
    paths.update(vo_phase(dev, repo, cor))
    paths.update(family_phase(dev))
    paths.update(vo_dense_phase(dev, cor))
    paths.update(vo_offline_phase(dev, repo, cor))
    paths.update(lightglue_depth_width_phase(dev, repo))
    paths.update(train_phase(dev, repo))
    paths.update(eval_phase(dev, repo))

    lines = []
    for key, entry in kernels.items():
        # `launches` is the count of the first path that runs the kernel,
        # whose shapes its unsuffixed keys carry; a later path's count goes
        # under `launches_<path>`, beside that path's `_<path>` keys
        first, *rest = [p for p in paths if key in paths[p]]
        entry["path"] = first
        entry["launches"] = paths[first][key]
        entry.update({f"launches_{p}": paths[p][key] for p in rest})
        lines.append(entry)
    require(all(k.__name__ in kernels for k in KERNELS)
            and all(k in kernels for k in (STEM_BF16, PP_BF16, NV_BF16)),
            "a kernel of KERNELS, or a bfloat16 instance, has no line")
    print(f"{card}")
    print(json.dumps({"kernels": lines}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
