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
    that batch (``_vo_b16`` keys); then the three modes again at
    pair_batch 1, 2, 4 and 8 (chunks of P pairs: one batched matcher
    call, LightGlue at batch P, and one batched device RANSAC a chunk):
    each P's match map against pair_batch 1's (valid equal, within
    1e-5), its poses within relative_poses_sharded's criterion, a
    LightGlue sequence's launches at 2, 4 and 8 (LightGlue once a chunk;
    at 8 the ``vo_offline_batched`` path), and in turns the ms a
    sequence, the pose map's ms a pair and its peak memory; the kernel
    phase holds the LightGlue stack at batch 8, K = 1024, every pair's
    masks its own, against its twin (``_b8_k1024`` keys, with its bound
    and an SDPA call);
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
    (three device kernels a call at C <= 128: the images' prologue, the
    tiles, the reduction; two above: the wide tiles and the reduction)
    against its twin, autograd through
    netvlad_plain, at the train shape (unsuffixed), config N's
    (``_n``) and the VPR step's (``_visloc``: 12 images at 240x320), its
    dW and dcen equal across two launches, and its bf16 instance at the
    train shape (an entry of its own, ``netvlad_backward_bf16``: dx within
    two bf16 ulps). bf16 training (``--bf16``) in the same phase: one bf16
    step on the card against the CPU's, both relative to the CPU's
    float32 step (compare_bf16_steps says how); 20 bf16 steps with
    dropout on (finite, the loss without the IO term falling, NetVLAD's
    bf16 forward and backward kernels twice a step, nothing else), timed
    with the device breakdown, and the two dtypes' steps in turns; the CLI
    again with ``--bf16 --device_cache --scan_epoch`` for 5 steps;
 13b. train cache phase: ``DeviceCachedPairLoader`` (the trainer's 64
    synthetic items on the card) driving 16 steps through its ``epoch``
    (twice) and through ``train/scan_epoch.make_epoch_fn`` from the same
    state and inputs: the first step's terms bit for bit, the first 4
    steps and the epoch within ``CACHE_GAP`` (the step loop run again
    drifts alike: the card's backward is not bit-reproducible), a control
    on other inputs failing both, the same launches, ms a step of each
    over its whole epoch;
 13c. visloc phase: VPR finetuning (config S, 240x320, the seeded
    synthetic Pittsburgh fixture, which needs cv2): the stem kernel
    refusing a gradient, the cluster init, the descriptor cache (the stem
    and NetVLAD once a forward of 16 images), one VPR step (12 images) on
    the card against the CPU, conv1a / conv1b's gradients included, 12
    mined steps (the stem never, NetVLAD's forward and backward once a
    step), ms a step and a cached image, then ``python -m
    nanovs_slam_torch.train_visloc --synthetic`` for 4 queries;
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
 15. KeypointFormer phase: "tiny" and "default" (28 classes, seeded
    weights and BN stats, scores spread) served at 256x320 through
    make_infer_fn(top_k=1000, conf_threshold=0.7) at B=1 and 8, float32
    and bf16: the postprocess (C = 64 / 256, cell 8) and the vladv2
    NetVLAD launched once a request each and nothing else, B=1 against
    the CPU (compare_with_cpu; hold_bf16 at bf16), ms per request in
    turns; ``eval_multitask --model_type KeypointFormer --config default
    --im_h 256 --im_w 320 --keypoints`` (and ``--bf16``) on a seeded
    synthetic HPatches set written in the run (cv2), card against CPU
    within 1e-3 at float32; training at 96x128, batch 4, for both
    configs: one step against the CPU (compare_train_steps, grad_norm to
    1e-3; bf16 by compare_bf16_steps over the VPR head), 20 steps at each
    dtype (falling losses; NetVLAD's forward and backward with the bias
    twice a step and nothing else; ms a step), and ``train_multitask
    --model_type KeypointFormer`` for 3 steps at each config and dtype,
    whose checkpoints load back; the kernel phase holds the postprocess
    and the vladv2 NetVLAD at KeypointFormer's shapes (``_kf``: C = 256,
    ``_kf_tiny``: 64; B=1 and 8; float32 and bf16) and the backward with
    the bias and db at its train shape (batch 4, 13x17; C = 256 in the
    wide kernel);
 16. LightGlue training phase: ``train_lightglue``'s defaults (extractor
    N, kp2dtiny_S, 120x160, K = 256, batch 2): one step on the card
    against the CPU on the same batch, 20 steps (the NLL falling; the
    stem and postprocess kernels twice a step, the LightGlue kernel never:
    the stack trains through its plain blocks), ms a step, then ``main()``
    for 3 steps, whose ``.npz`` matches a pair through make_pair_matcher;
 17. int8 phase: pinned S8 at 240x320 calibrated on the card as
    ``eval_multitask --int8`` does (8 synthetic-shapes images), then the
    int8 conv kernel against its twin at every one of the chained int8
    request's 23 calls at B=1 and 8 (float and int8 in; float, int8 and
    pooled int8 out: codes and floats equal), each timed beside its
    bound (bytes at 3.35 TB/s or operations at 1,979 int8 TOP/s) and
    ``torch._int_mm`` over an im2col of the same codes, with its launch
    shape (persistent blocks, SMs covered, weights resident or in K
    chunks; ``int8conv.launch_shape``), the entry's keys
    the sums over the request's calls; the int8 request
    (make_infer_fn(int8_scales=...), top_k 1000) at B=1 and 8: one int8
    launch a calibrated conv, one postprocess and one NetVLAD a request,
    no stem, B=1 against the CPU (compare_with_cpu), int8 against float32
    by tests/test_int8_execution.py's rule (scales calibrated on the
    frame), ms a request beside float32's; a ``to_mcu`` bundle exported
    from a seeded card model, its numpy and C runs against the card's
    int8 score / loc / desc (tests/test_deploy_bundle.py's rule); 3
    ``--qat`` and 3 ``--to_mcu`` trainer steps (finite losses); ``eval_
    multitask --int8`` and ``--int8_weight_only`` on a synthetic HPatches
    set, card against CPU within 1e-3 (each also with ``--bf16``, within
    the CPU test's bf16 bounds); ``export_model --format
    pt2|int8|mcu`` and ``export_onnx``, the pt2 program against
    make_export_fn; int8 execution of bfloat16 models (the JAX package's
    int8 deployment config): pinned S8 at bf16 (B=1 and 8) and config N
    with 28 classes and seeded weights at bf16 (B=128, bench.py's int8
    stage), each calibrated at bf16 on the card, every one of the request's
    23 int8 calls held against its twin (bf16 bits and codes equal) and
    timed as above, the requests' launches (23 int8 at bf16, 1 postprocess
    and 1 NetVLAD at bf16, no stem, no float32 instance), S8's B=1 answer
    against the CPU's bf16 int8 answer and the card's float32 int8 one
    (hold_bf16), and ms a request in turns: bf16 float, bf16 int8 and
    float32 int8;
 17b. parallel phase: two ranks sharing the card over gloo (start method
    "spawn", the library built once before) run 3 data-parallel steps of
    config S (120x160, global batch 4) against the single-process steps
    on the card, pinned S8's offline VO over the corridor with its pairs
    split over the ranks (BF and LightGlue) against ``relative_poses``,
    pinned S8's eval fan-out at 240x320, and head-parallel LightGlue S and
    "default" at K = 512 against the module's kernel forward; then the dp
    step at world size 1 over NCCL and ``train_multitask --num_devices
    2`` for 3 steps; ms a step (per rank, the gradient all-reduce's
    share), a sequence, a pair, a batch and a forward, beside the card;
    the kernels' launches on the ranks are the ``parallel`` path's;
 17c. spatial phase: four ranks sharing the card over gloo run pinned
    S8's 240x320 request (make_spatial_infer_fn, batch 1) with its height
    split over 2 ranks and over 4 (slabs at multiples of 8 rows, halos
    exchanged by all-reduces, the stem kernel on each rank's extended
    slab, NetVLAD and the postprocess on the gathered maps) against the
    single-process make_infer_fn request on the card (score, coord, the
    sampled descriptors and vlad within 1e-4, classes equal on 99.9%), ms
    a request beside it; 2 steps of config S (120x160, global batch 4) on
    a 2x2 ("data", "model") mesh (uneven slabs of 56 and 64 rows) against
    the single-process steps (check_dp); a reference-named ``.ckpt`` of
    pinned S8 written by ``utils/torch_export`` and evaluated by
    ``python -m nanovs_slam_torch.eval_multitask --model_path x.ckpt``,
    equal to the ``.npz``'s evaluation; ``python -m
    nanovs_slam_torch.demo`` on 4 synthetic frames; and a bf16 LightGlue
    pair (pinned S, K = 512: the plain blocks, no kernel) against the
    CPU's bf16 pair and the card's float32 kernel pair (the CPU test's
    criterion); the kernels' launches on the ranks are the ``spatial``
    path's; then KeypointFormer "default" (8 classes, seeded) at 256x320,
    B=1, its height over 2 and 4 ranks (slabs of 128 / 64 rows: the MiT's
    strided embeds and heads writing the rows whose window centre is
    theirs, its attention and NetVLAD on gathered maps) against the
    single-process request (the S8 request's criteria), ms a request
    beside it, and 2 of its steps at 96x128 (global batch 4, slabs of 32
    and 64 rows) on the 2x2 mesh against the single-process steps
    (check_dp); the postprocess, NetVLAD and its backward launched on
    every rank (the ``kf_spatial`` path, summed over the ranks); the
    kernel phase holds NetVLAD's forward and backward at a rank's shape
    of that step (2 images, the 13x17 map gathered: ``_kf_sp_train``);
 18. one JSON line describing each kernel, the card's line before it, and
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
    ``lg_width``, ``train``, ``train_bf16``, ``scan_epoch``, ``visloc``
    and ``eval``; of phases 15 and 16: ``kf_tiny``, ``kf_default`` (and
    ``_bf16``), ``kf_eval``, ``kf_train_tiny``, ``kf_train_default`` (and
    ``_bf16``), ``lg_train``; of phase 17: ``int8``; of phase 17b:
    ``parallel``, of phase 17c ``spatial`` and ``kf_spatial``, summed
    over the ranks; of phase 11 ``vo_offline_batched``; ``_kf`` /
    ``_kf_tiny`` keys KeypointFormer's shapes, ``_kf_train`` the forward
    at its train shape); ``int8_conv3x3``'s first
    path is ``int8``, its bf16 entry's ``int8_bf16`` (unsuffixed pinned S8
    at bf16, B=1; ``_b8``; ``_n28_b128`` config N at bf16, B=128, whose
    path is ``int8_n28_bf16``); ``netvlad_backward``'s first path is
    ``train``, its bf16
    entry's ``train_bf16``; ``_visloc`` the VPR step's shape).
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
NVB_BF16 = "netvlad_backward_bf16"
INT8_BF16 = "int8_conv3x3_bf16"
# KeypointFormer: served at 256x320 (its sides must be multiples of 32),
# trained on the synthetic set at 96x128, batch 4; its VPR head's map is
# 33x41 at 256x320 (a 1x1 conv with stride 2 and pad 1 on the 64x80 fused
# map) and 13x17 at 96x128
KF_HW = (256, 320)
KF_TRAIN_HW, KF_TRAIN_B = (96, 128), 4
KF_VLAD_HW, KF_TRAIN_VLAD_HW = (33, 41), (13, 17)
KF_CLASSES = 8  # the synthetic train config's


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
    queue behind the spin), ``launch`` (where given) a line on the launch
    the kernel makes."""
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
    launch: Callable | None = None


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

    def postprocess_case(suffix, C, h=H, w=W, bf16=False, cell=cell):
        """The postprocess with C descriptor channels (N: 32; D: 128;
        KeypointFormer at cell 8: 256 and 64) on h x w frames; with
        ``bf16``, bfloat16 inputs (float32 out)."""
        Hc, Wc = h // cell, w // cell
        Hf, Wf = 2 * Hc, 2 * Wc
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

    def netvlad_case(suffix, Cv, K, bf16=False, hw=(Hc, Wc), bias=False,
                     Bn=B):
        """NetVLAD at widths C, K (N: 48, 32; S: 64, 64) on an hw map of
        batch Bn; with ``bf16``, a bfloat16 x; with ``bias``, the vladv2
        bias (KeypointFormer's head: C = 256 and 64, K = 64 on 33x41, and
        at its train shape, 4 images of 13x17)."""
        xv = nhwc(rs.randn(Bn, Cv, *hw))
        aw, cen = t(rs.randn(Cv, K) * 0.2), t(rs.rand(K, Cv))
        if bf16:
            xv = xv.to(torch.bfloat16)
        nv = (xv, aw, cen) + ((t(rs.randn(K) * 0.5),) if bias else ())
        S = hw[0] * hw[1]

        def check(got, want):
            require(max_err(got, want) <= 1e-5, f"netvlad {Cv}, {K}")

        entry, name = (NV_BF16, "netvlad[bf16]") if bf16 else (
            "netvlad", "netvlad")
        return Case(entry, name, suffix,
                    "nanovs_slam_torch/csrc/netvlad.cu",
                    "nanovs_slam_tpu/ops/pallas/netvlad_kernel.py:59",
                    lambda: netvlad(*nv), lambda: netvlad_plain(*nv), None,
                    (2 if bf16 else 4) * Bn * S * Cv
                    + 4 * (2 * Cv * K + Bn * K * Cv + bias * K),
                    Bn * S * (4 * Cv * K + 3 * Cv + 3 * K), FP32_FLOP_PER_S,
                    check, launch=wide_launch(Bn, S, Cv, bf16, False))

    def netvlad_backward_case(suffix, Bb, h, w, Cv, K, bf16=False,
                              bias=False):
        """The NetVLAD backward at x (Bb, h, w, Cv) as NCHW memory (the
        VPR head's), K clusters: the train path's (4, 30, 40, 64) at
        K = 64 (config S, 120x160, batch 4), config N's (1, 60, 80, 48)
        at K = 32 and the VPR step's (12, 60, 80, 64) (config S at
        240x320, a query, a positive and 10 negatives; ``_visloc``), with
        inputs of their own draw; with ``bf16`` a bfloat16 x (the bf16
        train path's, an entry of its own). The forward's residuals come
        from its kernel (netvlad_residuals), as the train path's backward
        gets them. Each gradient within 1e-5 of its largest magnitude
        against the twin (autograd through netvlad_plain); at bf16 dx
        within two bf16 ulps of its largest (dx^ and dx are each rounded
        to bf16 on both sides: a rounding on the other side of a midpoint
        moves an element by one ulp) and dW, dcen within 1e-4 (|x|^2 sums
        in other orders can round x^ one bf16 ulp apart); dW and dcen
        equal across two launches (fixed-order reductions). Bound: five
        S x K x C products an image (logits, da, a du, dl W^T, x^T dl)
        and x, gy, u, m, W, cen read once, dx, dW, dcen written once (x
        and dx at 2 bytes for bf16). With ``bias`` the vladv2 bias and its
        gradient db (KeypointFormer's train path: C = 256 in the wide
        kernel, 64 in the tiles; 13x17 at batch 4), db held within the
        same relative tolerance of its terms' size (max over k of the sum
        over the pixels of |dl|: a pixel's dl sums to 0 over k, so db's
        terms cancel) and equal across two launches too."""
        rb = np.random.RandomState(SEED + 500 + Bb + bf16 + Cv * bias)
        xb = t(rb.randn(Bb, Cv, h, w)).permute(0, 2, 3, 1)
        if bf16:
            xb = xb.to(torch.bfloat16)
        aw, cen = t(rb.randn(Cv, K) * 0.3), t(rb.rand(K, Cv))
        gy = t(rb.randn(Bb, K * Cv))
        bb = (t(rb.randn(K) * 0.5),) if bias else ()
        _, u, m = netvlad_residuals(xb, aw, cen, *bb)
        args = (gy, xb, aw, cen)
        name = "netvlad_backward[bf16]" if bf16 else "netvlad_backward"
        db_scale = None
        if bias:  # dl through the twin: the gradient of a per-pixel bias
            b_full = bb[0].expand(Bb, h * w, K).clone().requires_grad_()
            with torch.enable_grad():
                dl, = torch.autograd.grad(
                    netvlad_plain(xb, aw, cen, b_full), b_full, gy)
            db_scale = float(dl.abs().sum((0, 1)).max())

        def check(got, want):
            for g, w_, part in zip(got, want, ("dx", "dW", "dcen", "db")):
                require(g.dtype == w_.dtype, f"{name} {part}: {g.dtype}")
                if bf16 and part == "dx":
                    ulps = bf16_ulps(g, w_)
                    require(ulps <= 2.0, f"{name} dx: {ulps} bf16 ulps")
                    continue
                err = max_err(g, w_)
                scale = db_scale if part == "db" else float(w_.abs().max())
                lim = (1e-4 if bf16 else 1e-5) * scale
                require(err <= lim, f"{name} {part}: {err} > {lim}")
            again = netvlad_backward(*args, u, m, *bb)
            require(all(torch.equal(a, b) for a, b in zip(got[1:],
                                                          again[1:])),
                    f"{name}: dW, dcen or db differ across launches")

        S_b = h * w
        xbytes = 2 if bf16 else 4
        # above C = 128: the wide tiles and the reduction
        return Case(NVB_BF16 if bf16 else "netvlad_backward", name, suffix,
                    "nanovs_slam_torch/csrc/netvlad.cu",
                    "nanovs_slam_tpu/modules/aggregators.py:40",
                    lambda: netvlad_backward(*args, u, m, *bb),
                    lambda: netvlad_backward_plain(*args, *bb), None,
                    2 * xbytes * Bb * S_b * Cv
                    + 4 * (2 * Bb * K * Cv + Bb * K + 4 * Cv * K
                           + 2 * K * bias),
                    10 * Bb * S_b * K * Cv, FP32_FLOP_PER_S, check,
                    2 if Cv > 128 else 3, 4,
                    wide_launch(Bb, S_b, Cv, bf16, True))

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
    if B == 1:  # the train path's backward (unsuffixed), config N's, the
        # VPR step's and the bf16 train path's
        cases += [netvlad_backward_case("", 4, 30, 40, 64, 64),
                  netvlad_backward_case("_n", 1, 60, 80, 48, 32),
                  netvlad_backward_case("_visloc", 12, 60, 80, 64, 64),
                  netvlad_backward_case("", 4, 30, 40, 64, 64, bf16=True)]
    # KeypointFormer ("default": C = 256, "tiny": 64; cell 8 at 256x320):
    # the postprocess, the vladv2 NetVLAD on its head's 33x41 map, and at
    # B = 1 the backward with the bias at its train shape (batch 4, 13x17)
    # and, for "default", the forward there (``_kf_train``)
    for sfx, C in (("_kf", 256), ("_kf_tiny", 64)):
        for bf in (False, True):
            cases += [postprocess_case(sfx + b8, C, *KF_HW, bf16=bf,
                                       cell=8),
                      netvlad_case(sfx + b8, C, 64, bf16=bf, hw=KF_VLAD_HW,
                                   bias=True)]
            if B == 1:
                cases.append(netvlad_backward_case(
                    sfx, KF_TRAIN_B, *KF_TRAIN_VLAD_HW, C, 64, bf16=bf,
                    bias=True))
    if B == 1:
        cases += [netvlad_case("_kf_train", 256, 64, bf16=bf,
                               hw=KF_TRAIN_VLAD_HW, bias=True, Bn=KF_TRAIN_B)
                  for bf in (False, True)]
        # a rank's part of the spatial phase's KeypointFormer step on the
        # 2x2 mesh: 2 images, the VPR map gathered whole (``_kf_sp_train``)
        Bs = KF_TRAIN_B // 2
        cases += [netvlad_case("_kf_sp_train", 256, 64, hw=KF_TRAIN_VLAD_HW,
                               bias=True, Bn=Bs),
                  netvlad_backward_case("_kf_sp_train", Bs,
                                        *KF_TRAIN_VLAD_HW, 256, 64,
                                        bias=True)]
    return cases


def ptxas_report(kernel: str, bf16: bool) -> str:
    """ptxas's registers and spills for ``kernel``'s float32 or bf16
    instance, from this process's build of the kernels (empty where the
    library was built by an earlier process)."""
    from nanovs_slam_torch.kernels import _build

    mangled = f"{kernel}I{'13__nv_bfloat16' if bf16 else 'f'}E"
    lines = (_build.build_log or "").splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and mangled in line:
            out = []
            for nxt in lines[i + 1:i + 5]:
                if "Compiling entry function" in nxt:
                    break
                if "registers" in nxt or "spill" in nxt:
                    out.append(nxt.split(":", 1)[-1].strip())
            return "; ".join(out)
    return ""


def wide_launch(B: int, S: int, C: int, bf16: bool, backward: bool):
    """Above C = 128: a function giving a line on the launch of the
    forward's kernel or the backward's tiles (blocks, SMs used, shared
    memory, registers and spills); None at C <= 128."""
    if C <= 128:
        return None

    def line() -> str:
        from nanovs_slam_torch.kernels.netvlad import wide_launch_shape

        sh = wide_launch_shape(B, S, bf16, backward)
        name = "netvlad_bwd_wide" if backward else "netvlad_wide_kernel"
        held = ("" if backward else
                f", the card holding {sh['resident_clusters']} clusters")
        return (f"{name}<{'bf16' if bf16 else 'float'}> {sh['blocks']} "
                f"blocks of {sh['threads']} threads in clusters of "
                f"{sh['cluster']}{held}, {sh['blocks_per_sm']} an SM, "
                f"{sh['sms_covered']} of {sh['sms']} SMs, "
                f"{sh['smem_bytes']} B dynamic shared memory a block, "
                f"{sh['registers']} registers and {sh['local_bytes']} B "
                f"local a thread; ptxas: "
                f"{ptxas_report(name, bf16) or 'built by an earlier process'}")
    return line


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
            if c.launch is not None:
                log(f"kernel {tag}: launch {c.launch()}")
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
            if c.entry == NVB_BF16:
                keys["dx_bf16_ulps"] = bf16_ulps(got[0], want[0])
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


def answer_dims(cfg) -> tuple:
    """(descriptor width, global descriptor width, depth head) of a
    KP2DTiny or a KeypointFormer config."""
    if hasattr(cfg, "feat_dim"):  # KeypointFormer
        return cfg.feat_dim, cfg.num_clusters * cfg.feat_dim, False
    return cfg.nfeatures, cfg.global_desc_dim, cfg.depth


def check_answer(out, B, h, w, cfg, top_k) -> None:
    import torch

    hc, wc = h // cfg.cell, w // cfg.cell
    top_k = min(top_k, hc * wc)
    nfeat, gdim, depth = answer_dims(cfg)
    shapes = {"score": (B, hc, wc, 1), "coord": (B, hc, wc, 2),
              "feat": (B, hc, wc, nfeat),
              "seg": (B, 2 * hc, 2 * wc, 1), "vlad": (B, gdim),
              "keypoints": (B, top_k, 2), "keypoint_scores": (B, top_k),
              "descriptors": (B, top_k, nfeat),
              "keypoint_valid": (B, top_k)}
    if depth:
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


# the offline VO's pair_batch values, in turns; the last is the LightGlue
# kernel case's batch
VO_PAIR_BATCHES = (1, 2, 4, 8)


def vo_offline_batched_phase(dev, repo: str, cor: Corridor) -> dict:
    """VO-offline-{dense,bf,lg}-128x512 at pair_batch 1, 2, 4 and 8
    (vo.offline.OfflineVO's chunks of P pairs: one batched matcher call
    and one batched device RANSAC a chunk), the 7 pairs of the corridor's
    8 frames, the vo_offline phase's settings: each P's match map against
    pair_batch 1's (valid equal, the correspondences within 1e-5) and
    its poses within relative_poses_sharded's criterion (match counts
    equal, R and t within 1e-3); the launches of a LightGlue sequence at
    pair_batch 8 (stem and postprocess once, LightGlue once for the 7
    pairs: the ``vo_offline_batched`` path), and at 2 and 4 (4 and 2
    LightGlue launches); then, in turns (P = 1, 2, 4, 8, three rounds),
    the host ms of a sequence, of its match map and of its pose map, and
    the pose map's peak device memory."""
    import torch

    from nanovs_slam_torch.kernels import (fused_postprocess,
                                           fused_stem_pair_pool,
                                           lightglue_transformer,
                                           reset_launches)
    from nanovs_slam_torch.vo.offline import OfflineVO
    from nanovs_slam_torch.vo.visual_odometry import (load_lightglue_for_vo,
                                                      prep_frame)

    card = card_line()
    frames, cpu_frames, gt, cfg, ex, cpu_ex, cam = cor
    stack = torch.stack([prep_frame(f, VO_SIZE) for f in frames])
    pairs = VO_FRAMES - 1
    paths = {}
    for mode, tag in (("dense", "dense"), ("bf", "bf"), ("lightglue", "lg")):
        name = f"vo offline {tag} pair_batch"
        lg = (load_lightglue_for_vo(
            os.path.join(repo, "pinned", "lightglue_S.npz"), cfg.nfeatures,
            KITTI_HW[::-1], max_n=1024) if mode == "lightglue" else None)
        vos = {P: OfflineVO(ex, cfg, VO_SIZE, cam, lightglue=lg, device=dev,
                            k=512 if mode == "dense" else 1024,
                            matcher=mode, n_hypotheses=8192, restarts=3,
                            pair_batch=P) for P in VO_PAIR_BATCHES}
        reps = vos[1].extract(stack)
        mm1 = vos[1].match_map(reps)
        R1, t1, _, n1 = (a.cpu().numpy() for a in vos[1].pose_map(*mm1))
        for P in VO_PAIR_BATCHES[1:]:
            mm = vos[P].match_map(reps)
            same = bool(torch.equal(mm[2], mm1[2]))
            v = mm1[2]
            gap = max(float((a[v] - b[v]).abs().max())
                      for a, b in zip(mm[:2], mm1[:2]))
            R, t, _, n = (a.cpu().numpy() for a in vos[P].pose_map(*mm))
            dR, dt = float(np.abs(R - R1).max()), float(np.abs(t - t1).max())
            log(f"{name} {P}: match map against pair_batch 1's: valid "
                f"equal {same}, correspondences {gap:.3g} apart; poses R "
                f"{dR:.3g} t {dt:.3g} apart, match counts equal "
                f"{bool(np.array_equal(n, n1))}")
            require(same and gap <= 1e-5 and np.array_equal(n, n1)
                    and dR <= 1e-3 and dt <= 1e-3,
                    f"{name} {P}: not pair_batch 1's answer")
        if mode == "lightglue":
            for P in VO_PAIR_BATCHES[1:]:
                reset_launches()
                vos[P].relative_poses(stack)
                launches = {
                    "fused_stem_pair_pool": fused_stem_pair_pool.launches,
                    "fused_postprocess": fused_postprocess.launches,
                    "lightglue_transformer": lightglue_transformer.launches}
                want = {"fused_stem_pair_pool": 1, "fused_postprocess": 1,
                        "lightglue_transformer": -(-pairs // P)}
                log(f"{name} {P}: launches over a sequence of {VO_FRAMES} "
                    f"frames {launches}")
                require(launches == want, f"{name} {P}: launches "
                        f"{launches}, expected {want}")
            paths["vo_offline_batched"] = launches
        seq, match, pose = ({P: [] for P in VO_PAIR_BATCHES}
                            for _ in range(3))
        mms = {P: vos[P].match_map(reps) for P in VO_PAIR_BATCHES}
        for _ in range(3):
            for P in VO_PAIR_BATCHES:
                seq[P] += host_ms(lambda i: vos[P].relative_poses(stack), 1)
                match[P] += host_ms(lambda i: vos[P].match_map(reps), 1)
                pose[P] += host_ms(lambda i: vos[P].pose_map(*mms[P]), 1)
        peak = {}
        for P in VO_PAIR_BATCHES:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            vos[P].pose_map(*mms[P])
            torch.cuda.synchronize()
            peak[P] = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        res = {P: {"sequence_ms": statistics.median(seq[P][1:]),
                   "match_map_ms": statistics.median(match[P][1:]),
                   "pose_map_ms": statistics.median(pose[P][1:]),
                   "pose_ms_a_pair": statistics.median(pose[P][1:]) / pairs,
                   "pose_map_peak_mib": round(peak[P], 1)}
               for P in VO_PAIR_BATCHES}
        log(f"{name}: host ms in turns (medians of rounds 2-3, synchronised) "
            f"{json.dumps(res)} [{card}]")
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
    if D != 256:  # the offline VO's batched match map runs D = 32
        entry.update(lightglue_batched_case(dev, lg, name, P))
    if D == 256:
        entry["row_library"] = ("torch.matmul, float32 (TF32 off): fc1's "
                                "product (M+N, 2D) x (2D, 2D), the row "
                                "stage's cuBLAS yardstick")
        return {key: entry, "split_weights": split_entry}
    return {key: entry}


def lightglue_batched_case(dev, lg, name: str, P: int) -> dict:
    """The stack at batch ``VO_PAIR_BATCHES[-1]`` = 8 pairs and K = 1024
    (the offline VO's match map at pair_batch 8), every pair's masks its
    own (pair i pads 16 i slots of image 0 and 24 i of image 1), against
    its twin: timed (the twin by the profiler's summed device time), its
    bound (all in 3xTF32, as at batch 1) and one SDPA call over the 2 x 8
    images of one self-attention launch; keys ``_b8_k1024``."""
    import torch
    import torch.nn.functional as F

    from nanovs_slam_torch.kernels.lightglue import (
        HEADS, lightglue_transformer, lightglue_transformer_plain)

    B, K = VO_PAIR_BATCHES[-1], 1024
    D, L = lg.cfg.descriptor_dim, lg.cfg.n_layers
    args = lightglue_args(lg, dev, B, K, K, 1, 1, False, SEED + 450)
    slots = torch.arange(K, device=dev)
    for a, step in ((6, 16), (7, 24)):  # the masks: pair i its own padding
        args[a] = slots[None] < K - step * torch.arange(B, device=dev)[:, None]
    got = lightglue_transformer(*args)
    want = lightglue_transformer_plain(*args, range(L))
    torch.cuda.synchronize()
    err = max_err(got, want)
    require(err <= 1e-4, f"{name} B8_K1024: max_abs_err {err}")
    ms = cuda_ms(lambda: lightglue_transformer(*args), inner=10)
    plain_ms = device_sum_ms(lambda: lightglue_transformer_plain(
        *args, range(L)))
    g = torch.Generator(device=dev).manual_seed(SEED)
    q, k, v = (torch.randn(2 * B, HEADS, K, D // HEADS, device=dev,
                           generator=g) for _ in range(3))
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v))
    bounds = lightglue_bounds(B, K, K, D, L, P)
    log(f"kernel {name} B8_K1024: max_abs_err {err:.3g}, kernel {ms:.4f} "
        f"ms, plain {plain_ms:.4f} ms, bound {bounds['all_3xtf32']:.5f} ms "
        f"(operations, all in 3xTF32; attention in 3xTF32 and the rest in "
        f"float32 {bounds['attn_3xtf32']:.5f}, all in float32 "
        f"{bounds['float32']:.5f}); sdpa {library_ms:.4f} ms")
    return {"max_abs_err_b8_k1024": err, "ms_b8_k1024": ms,
            "plain_ms_b8_k1024": plain_ms,
            "bound_ms_b8_k1024": bounds["all_3xtf32"],
            "bound_by_b8_k1024": "operations",
            "library_ms_b8_k1024": library_ms}


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


def train_state(device, dtype: str = "float32"):
    """Config S V2 (28 classes, compute ``dtype``) with init_model's
    seeded weights and a seeded inlier net, Adam at 5e-4 on the cosine
    warm-restart schedule, as the CLI builds them."""
    import torch

    from nanovs_slam_torch.configs import get_config
    from nanovs_slam_torch.models.inlier_net import init_inlier_net
    from nanovs_slam_torch.models.kp2dtiny import init_model
    from nanovs_slam_torch.train.schedules import make_lr_schedule
    from nanovs_slam_torch.train.train_step import (create_train_state,
                                                    make_optimizer)

    cfg = get_config("S", n_classes=28, dtype=dtype)
    model = init_model(cfg, torch.Generator().manual_seed(SEED), device)
    io = init_inlier_net(torch.Generator().manual_seed(SEED + 2),
                         device=device)
    spec = make_optimizer("adam", schedule=make_lr_schedule(
        "cosine", 5e-4, 16, 20))  # 64 synthetic items at batch 4
    return cfg, create_train_state(model, spec, io_net=io)


def compare_train_steps(card, cpu, lr: float, grad_norm_rel: float = 1e-4
                        ) -> dict:
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
    to 2 lr. ``grad_norm_rel``: KeypointFormer's step is held to 1e-3 (a
    1e-7 relative perturbation of its images alone moves its grad_norm by
    6.4e-5 relative on the CPU; tests/test_torch_port_keypoint_former.py
    measured 2.3e-4 between the port and the JAX package)."""
    import torch

    (c_state, c_met), (p_state, p_met) = card, cpu
    errs = {}
    for k, v in p_met.items():
        err = abs(c_met[k] - v)
        lim = (grad_norm_rel * abs(v) if k == "grad_norm"
               else 1e-4 * max(1.0, abs(v)))
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


def _head_grads(state, heads: tuple, skip: tuple = ()) -> dict:
    """{parameter: raw gradient as float64 on the CPU} of the model's
    parameters under the modules ``heads``, but those named in ``skip``
    (zeros where one has none)."""
    import torch

    return {k: (p.grad if p.grad is not None else torch.zeros_like(p))
            .detach().double().cpu()
            for k, p in state.model.named_parameters()
            if k.startswith(tuple(h + "." for h in heads)) and k not in skip}


def leaf_distances(grads: dict, ref: dict) -> tuple:
    """(median, worst) over the leaves of each leaf's relative L2 distance
    ||g - r|| / ||r|| to ``ref``."""
    d = [float((grads[k] - r).norm() / r.norm()) for k, r in ref.items()]
    return statistics.median(d), max(d)


def compare_bf16_steps(card, cpu, ref, card_f32,
                       vpr_heads: tuple = ("vlad_head",),
                       recall_cells: int = 936, skip: tuple = (),
                       unit_floor: bool = False) -> dict:
    """One bf16 step on the card against the CPU's bf16 step, relative to
    the CPU's float32 step (``ref``), as tests/test_torch_port_train_bf16.py
    holds the port against the JAX package: the bf16 roundings of cuDNN
    and of PyTorch's CPU kernels differ, so the two bf16 answers are held
    to the float32 one instead of to each other.

    Loss terms: each one's distance to the float32 term at most twice the
    larger of the CPU bf16 one's and 2^-8 of the term (with
    ``unit_floor``, of max(1, |term|): KeypointFormer's ``usp_loss`` is a
    sum of O(1) parts that cancels to ~1e-2, and one bf16 rounding of a
    part moves it by ~4e-3), plus 1e-3 relative
    (``recall`` two of its ``recall_cells`` interior cells more, 936 at
    120x160, batch 4: an argmin flipped by bf16 noise).

    Gradients, leaf by leaf over the VPR head (``vlad_head``: 11 leaves
    whose gradient is the VPR loss's alone, through the bf16 NetVLAD
    backward kernel; nothing in it picks by argmin; ``vpr_heads`` names
    its modules, KeypointFormer's are ``vlad_conv0``, ``vlad_bn0``,
    ``vlad_conv1`` and ``netvlad``, less ``skip``: ``vlad_conv0.bias``,
    whose gradient is 0 but for float32 noise, a train-mode BN
    following it): each leaf's relative
    L2 distance to its float32 gradient. The card's median leaf at most
    twice the CPU bf16 step's and at least a quarter of it (the bf16
    roundings are there), its worst leaf at most three times the CPU's.
    The whole gradient is not held: the keypoint losses pick by argmin,
    and on the CPU alone the backbone's leaves are 0.54-1.32 from float32
    at bf16 (a zeroed gradient reads 1.0). Measured on the CPU at this
    step: median 0.0398, worst 0.0720. Two controls are read in the same
    run and must fail: a zeroed gradient (every leaf 1.0: above the
    limits) and the card's float32 step (the roundings left out: below
    the lower limit). Parameters, BN statistics and Adam's state
    float32."""
    import torch

    (c_state, c_met), (p_state, p_met), (r_state, r_met) = card, cpu, ref
    errs = {}
    for k, r in r_met.items():
        floor = 2 ** -8 * (max(1.0, abs(r)) if unit_floor else abs(r))
        tol = (2 * max(abs(p_met[k] - r), floor)
               + 1e-3 * max(1.0, abs(r))
               + (2 / recall_cells if k == "recall" else 0))
        err = abs(c_met[k] - r)
        require(err <= tol, f"train bf16: {k} card {c_met[k]} cpu "
                f"{p_met[k]} float32 {r}")
        errs[k] = [err, abs(p_met[k] - r)]
    g_ref = _head_grads(r_state, vpr_heads, skip)
    g_cpu = leaf_distances(_head_grads(p_state, vpr_heads, skip), g_ref)

    def holds(med_worst):
        med, worst = med_worst
        return g_cpu[0] / 4 <= med <= 2 * g_cpu[0] and worst <= 3 * g_cpu[1]

    g_card = leaf_distances(_head_grads(c_state, vpr_heads, skip), g_ref)
    zeroed = leaf_distances({k: torch.zeros_like(v)
                             for k, v in g_ref.items()}, g_ref)
    as_f32 = leaf_distances(_head_grads(card_f32, vpr_heads, skip), g_ref)
    errs["vlad_head_leaves_median_worst"] = [g_card, g_cpu]
    errs["controls_zeroed_card_f32"] = [zeroed, as_f32]
    log(f"train bf16: one step, [card, cpu] bf16 against the cpu's float32 "
        f"step {json.dumps(errs)}")
    require(holds(g_card), f"train bf16: the VPR head's gradients "
            f"{g_card} (median, worst leaf) from float32, the CPU's bf16 "
            f"step {g_cpu}")
    require(not holds(zeroed) and not holds(as_f32),
            f"train bf16: a control passed the gradient check: zeroed "
            f"{zeroed}, the card's float32 step {as_f32}")
    f32 = [t.dtype == torch.float32 for p in c_state.model.parameters()
           for t in (p, p.grad) if t is not None]
    f32 += [v.dtype == torch.float32 for st in c_state.optimizer.state.values()
            for v in st.values() if v.dim() > 0]
    require(all(f32), "train bf16: a parameter, gradient or Adam moment is "
            "not float32")
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
    bf16_steps = []  # the card's bf16 step, then the CPU's
    for device in (dev, torch.device("cpu")):
        cfg16, state16 = train_state(device, "bfloat16")
        set_dropout(state16.model, rate=0.0)
        step16 = make_train_step(cfg16, h, w, io_top_k=300)
        state16, met = step16(
            state16, {k: v.to(device) for k, v in batch.items()}, weights)
        bf16_steps.append((state16, {k: float(v) for k, v in met.items()}))
    compare_bf16_steps(*bf16_steps, results[1], results[0][0])

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
    launches16, step16 = train_bf16_run(dev, dbatch, weights)
    # the two dtypes in turns (float32, bf16, bf16, float32; 10 steps each)
    turns = {"float32": [], "bfloat16": []}
    for dtype in ("float32", "bfloat16", "bfloat16", "float32"):
        for _ in range(10):
            t0 = time.perf_counter()
            if dtype == "float32":
                state, _ = step(state, dbatch, weights)
            else:
                step16()
            torch.cuda.synchronize()
            turns[dtype].append((time.perf_counter() - t0) * 1e3)
    log("train: ms a step in turns (medians of 20, host clock), float32 "
        f"{statistics.median(turns['float32']):.3f}, bf16 "
        f"{statistics.median(turns['bfloat16']):.3f}")

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

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "ck16")
        flags = ["--bf16", "--device_cache", "--scan_epoch"]
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "nanovs_slam_torch.train_multitask",
             "--no_eval", "--n_epochs", "1", "--max_steps_per_epoch", "5",
             "--log_every", "1", "--out_model_path", out] + flags, cwd=tmp,
            env=env, capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t0
        log(f"train: CLI {' '.join(flags)} "
            + " | ".join(r.stdout.strip().splitlines()[-4:]))
        require(r.returncode == 0, f"train: the CLI failed with {flags}\n"
                f"{r.stdout}\n{r.stderr}")
        tree, meta = load_npz_checkpoint(out + ".npz")
    require(meta["step"] == 5 and "device cache: 64 items" in r.stdout,
            f"train: the {flags} CLI saved step {meta['step']}")
    require(tree["params"]["backbone"]["conv1a"]["conv"]["kernel"].dtype
            == np.float32, "train: the bf16 CLI saved bf16 parameters")
    log(f"train: CLI {' '.join(flags)}, 5 steps in {cli_s:.1f} s")
    return {"train": launches, "train_bf16": launches16}


def train_bf16_run(dev, dbatch, weights):
    """20 steps of config S at bf16 (``--bf16``: float32 parameters, bf16
    compute) with dropout on, on the fixed batch: finite losses, the loss
    without the IO term falling, NetVLAD's bf16 forward and backward
    kernels twice a step and no other kernel launched; the steady ms a
    step, peak memory and the device breakdown. Returns (the path's launch
    counts, a function that runs one more step)."""
    import torch

    from nanovs_slam_torch.kernels import (BF16_KERNELS, KERNELS, netvlad,
                                           netvlad_backward, reset_launches)
    from nanovs_slam_torch.modules.blocks import set_dropout
    from nanovs_slam_torch.train.train_step import make_train_step

    h, w = TRAIN_HW
    cfg, state = train_state(dev, "bfloat16")
    set_dropout(state.model, generator=torch.Generator(dev).manual_seed(
        SEED + 1))
    step = make_train_step(cfg, h, w, io_top_k=300)
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
    launches = {NV_BF16: netvlad.launches_bf16,
                NVB_BF16: netvlad_backward.launches_bf16}
    others = {k.__name__: k.launches for k in KERNELS}
    others.update({k.__name__ + "_bf16": k.launches_bf16
                   for k in BF16_KERNELS
                   if k not in (netvlad, netvlad_backward)})
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    log(f"train bf16: launches during 20 steps {launches}, others {others}")
    require(launches[NV_BF16] == 40 and launches[NVB_BF16] == 40,
            "train bf16: NetVLAD's bf16 forward and backward should launch "
            "twice a step")
    require(not any(others.values()), "train bf16: another kernel launched")
    require(all(math.isfinite(v) for v in losses),
            f"train bf16: losses {losses}")
    rest = [t - weights.keypoint_loss * io for t, io in zip(losses, io_terms)]
    log("train bf16: 20 steps on a fixed batch (dropout on): total loss "
        + ", ".join(f"{v:.3f}" for v in losses) + "; without the IO term "
        + ", ".join(f"{v:.3f}" for v in rest))
    require(rest[-1] < rest[0], "train bf16: the loss without the IO term "
            "did not fall")
    ms = steady(step_ms)
    log(f"train bf16: ms a step {ms:.3f} (steady median of the 20, host "
        f"clock, synchronised), {1e3 / ms:.2f} steps a second; first step "
        f"{step_ms[0]:.1f} ms; peak memory {peak:.1f} MiB")
    box = [state]

    def one():
        box[0], _ = step(box[0], dbatch, weights)

    log_breakdown("train bf16: a step", one, ms)
    return launches, one


CACHE_GAP = (1e-3, 5e-2)  # train cache: the loops' largest gap over the
#                            first 4 steps and over the epoch


def train_cache_phase(dev) -> dict:
    """The card-resident loader and the epoch loop (``--device_cache``,
    ``--scan_epoch``) at the train cell (config S, 28 classes, 120x160,
    batch 4, the trainer's 64 synthetic items): one epoch of 16 steps
    through ``DeviceCachedPairLoader.epoch`` twice (the step loop and its
    witness) and one through ``make_epoch_fn``, each from the same fresh
    state, seeds and inputs and timed alike (host clock: the whole epoch,
    metrics left on the card, one synchronisation at its end). The epoch
    loop against the step loop: the first step's loss terms equal bit for
    bit (the same forward on the same batch), its grad_norm within 1e-4
    relative, every loss finite, the same launches, and the largest
    relative gap a step of the segmentation, VPR, location and descriptor
    terms within ``CACHE_GAP``: 1e-3 over the first 4 steps, 5e-2 over
    all 16. The steps drift apart because the card's backward is not
    bit-reproducible (atomic sums, in grid_sample's backward among
    others, add in no fixed order, and Adam turns that noise into updates
    of up to lr): the witness, the step loop run again, drifts from the
    step loop as far. Measured on the card: the epoch loop up to 1.0e-4
    over the first 4 steps and 1.2e-2 over 16, the witness 5.4e-5 and
    1.3e-2. A control must fail both limits: the epoch loop on the next
    epoch's indices and homographies (measured 2.3e-2 at its first step,
    8.8e-2 over 16). Returns the epoch loop's launch counts."""
    import torch

    from nanovs_slam_torch.data.datasets import SyntheticShapesDataset
    from nanovs_slam_torch.data.device_cache import DeviceCachedPairLoader
    from nanovs_slam_torch.kernels import KERNELS, reset_launches
    from nanovs_slam_torch.modules.blocks import set_dropout
    from nanovs_slam_torch.train.schedules import DEFAULT_LOSS_WEIGHTS
    from nanovs_slam_torch.train.scan_epoch import (make_epoch_fn,
                                                    weights_as_arrays)
    from nanovs_slam_torch.train.train_step import make_train_step

    h, w = TRAIN_HW
    weights = DEFAULT_LOSS_WEIGHTS
    t0 = time.perf_counter()
    loader = DeviceCachedPairLoader(
        SyntheticShapesDataset((h, w), 64, 28, seed=0), TRAIN_B, h, w,
        seed=SEED, device=dev)
    torch.cuda.synchronize()
    log(f"train cache: {loader.n} items, {loader.nbytes() / 2 ** 20:.2f} "
        f"MiB on the card (uint8: {loader.store_u8}), built in "
        f"{time.perf_counter() - t0:.2f} s")
    S = len(loader)

    def fresh():
        cfg, state = train_state(dev)
        set_dropout(state.model, generator=torch.Generator(dev).manual_seed(
            SEED + 1))
        return cfg, state, make_train_step(cfg, h, w, io_top_k=300)

    def step_loop():
        cfg, state, step = fresh()
        reset_launches()
        mets = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for batch in loader.epoch(0):
            state, met = step(state, batch, weights)
            mets.append(met)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / S
        return ([{k: float(v) for k, v in m.items()} for m in mets], ms,
                {k.__name__: k.launches for k in KERNELS})

    def epoch_loop(epoch: int):
        cfg, state, step = fresh()
        epoch_fn = make_epoch_fn(step, cfg.cell // 2, False, True)
        idx_all, homos_all, gen = loader.epoch_arrays(epoch)
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, stack = epoch_fn(state, loader.cache_arrays(), idx_all,
                                homos_all, weights_as_arrays(weights, dev),
                                gen)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / S
        stack = {k: v.cpu().tolist() for k, v in stack.items()}
        return ([{k: v[i] for k, v in stack.items()} for i in range(S)], ms,
                {k.__name__: k.launches for k in KERNELS})

    terms = ("seg_loss", "vlad_loss", "loc_loss", "metric_loss")

    def gaps(a, b):
        return [max(abs(x[k] - y[k]) / max(1.0, abs(y[k])) for k in terms)
                for x, y in zip(a, b)]

    loop, loop_ms, loop_launches = step_loop()
    scan, scan_ms, launches = epoch_loop(0)
    again, again_ms, _ = step_loop()
    other, _, _ = epoch_loop(1)
    log(f"train cache: ms a step over the epoch of {S} (the first "
        f"included, one synchronisation at its end), the step loop "
        f"{loop_ms:.3f} and {again_ms:.3f}, the epoch loop {scan_ms:.3f}")
    log(f"train cache: launches, step loop {loop_launches}, epoch loop "
        f"{launches}")
    require(launches == loop_launches and launches["netvlad"] == 2 * S
            and launches["netvlad_backward"] == 2 * S,
            "train cache: NetVLAD should launch twice a step in both loops")
    first = {k: abs(scan[0][k] - loop[0][k]) for k in loop[0]}
    log(f"train cache: the first step, epoch loop against step loop "
        f"{json.dumps(first)}")
    require(all(v == 0 for k, v in first.items() if k != "grad_norm"),
            "train cache: the first step's terms differ between the loops")
    require(first["grad_norm"] <= 1e-4 * loop[0]["grad_norm"],
            "train cache: the first step's grad_norm differs")
    g_scan, g_again, g_other = gaps(scan, loop), gaps(again, loop), \
        gaps(other, loop)
    for name, g in (("the epoch loop", g_scan), ("the step loop again",
                                                 g_again),
                    ("control: the epoch loop on epoch 1", g_other)):
        log(f"train cache: {name} against the step loop, largest relative "
            f"gap a step of {terms} " + ", ".join(f"{v:.2g}" for v in g))
    require(all(math.isfinite(m["total_loss"]) for m in scan),
            "train cache: a non-finite loss")
    def holds(g):
        return max(g[:4]) <= CACHE_GAP[0] and max(g) <= CACHE_GAP[1]

    require(holds(g_scan), f"train cache: the loops {max(g_scan[:4])} apart "
            f"over the first 4 steps, {max(g_scan)} over the epoch (the "
            f"step loop again: {max(g_again[:4])}, {max(g_again)})")
    require(max(g_other[:4]) > CACHE_GAP[0] and max(g_other) > CACHE_GAP[1],
            f"train cache: the control (epoch 1's inputs) passed a limit, "
            f"{max(g_other[:4])} and {max(g_other)} apart")
    return {"scan_epoch": launches}


# -------------------------------------------------------------- visloc phase

VPR_NEG = 10  # train_visloc's default --n_neg: 12 images a step
VPR_GAP = 5e-3  # visloc: the step's gradients, card against CPU


def vpr_grad_gaps(card, cpu) -> tuple:
    """({parameter: (relative L2 gap, max gap over its largest magnitude)}
    of the card's gradients against the CPU's, the relative L2 gap of all
    of them)."""
    cpu_params = dict(cpu.named_parameters())
    gaps, num, den = {}, 0.0, 0.0
    for k, p in card.named_parameters():
        q = cpu_params[k]
        if q.grad is None:
            require(p.grad is None, f"visloc: {k} has a gradient on the "
                    "card only")
            continue
        d = p.grad.cpu().double() - q.grad.double()
        ref = q.grad.double()
        num += float((d * d).sum())
        den += float((ref * ref).sum())
        gaps[k] = (float(d.norm() / max(float(ref.norm()), 1e-30)),
                   float(d.abs().max() / max(float(ref.abs().max()),
                                             1e-30)))
    return gaps, (num / den) ** 0.5


def visloc_phase(dev, repo: str) -> dict:
    """VPR finetuning (``train_visloc``) on the card, config S V2 (28
    classes, seeded init_model weights) at 240x320 on the seeded synthetic
    Pittsburgh fixture (written with cv2, which this phase needs): the
    stem kernel refusing an input that needs a gradient; NetVLAD's
    cluster init (k-means on the card); the descriptor cache of the whole
    set (16 images a forward: the stem and NetVLAD kernels once a
    forward), timed an image; one VPR step (a mined query, its positive
    and 10 negatives: 12 images) on the card against the CPU's from the
    same weights (the loss within 1e-4 relative; the gradients within
    ``VPR_GAP`` in relative L2, all of them and each of conv1a's and
    conv1b's: the eval-mode forward differentiated keeps the stem
    unfused). Not 1e-5: the card sums in float32 in other orders than
    the CPU, and near-ties at the max-pools and LeakyReLU kinks move a
    gradient's element whole. cuDNN's FFT convolutions are not the cause:
    the witness, the same step on the card without cuDNN (no FFT
    convolution), is as far. Measured on two mined triplets: 2.3e-4 and
    4.2e-4 in all, a stem leaf up to 1.0e-3; the witness 2.3e-4 and
    1.5e-4, a stem leaf up to 5.2e-4; the control, which must fail the
    limit, the step with BN in train mode, 1.44-1.47 in all and 5.3-6.0
    at a stem leaf. Then steps on mined queries,
    timed: the stem launched 0 times a step, NetVLAD's forward and
    backward once; then ``python -m
    nanovs_slam_torch.train_visloc --synthetic`` for one epoch of 4
    queries in a subprocess, whose checkpoint loads back. Returns the
    path's launch counts (the cache and the steps)."""
    import importlib.util
    import tempfile

    import torch

    from nanovs_slam_torch import train_visloc
    from nanovs_slam_torch.configs import get_config
    from nanovs_slam_torch.data.pittsburgh import (TripletMiningDataset,
                                                   WholeDataset)
    from nanovs_slam_torch.kernels import (fused_stem_pair_pool, netvlad,
                                           netvlad_backward, reset_launches)
    from nanovs_slam_torch.models.kp2dtiny import build_model, init_model
    from nanovs_slam_torch.utils.checkpoint import load_npz_checkpoint
    from nanovs_slam_torch.utils.convert import load_jax_variables

    t_phase = time.perf_counter()
    require(importlib.util.find_spec("cv2") is not None,
            "visloc: cv2 is missing; the synthetic Pittsburgh fixture's "
            "JPEGs are written and read with it")
    w1 = torch.randn(16, 3, 3, 3, device=dev, requires_grad=True)
    try:
        fused_stem_pair_pool(torch.randn(1, 8, 8, 3, device=dev), w1,
                             torch.zeros(16, device=dev),
                             torch.randn(24, 16, 3, 3, device=dev),
                             torch.zeros(24, device=dev))
        raise AssertionError("visloc: the stem kernel took an input that "
                             "needs a gradient")
    except RuntimeError as e:
        log(f"visloc: the stem kernel refuses a gradient: {e}")

    spec = importlib.util.spec_from_file_location(
        "make_synthetic_pittsburgh",
        os.path.join(repo, "scripts", "make_synthetic_pittsburgh.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    root = script.ensure_synthetic_pittsburgh()
    struct = os.path.join(root, "datasets", "pitts30k_train.mat")
    whole = WholeDataset(struct, root, (H, W))
    miner = TripletMiningDataset(struct, root, (H, W), n_neg=VPR_NEG,
                                 seed=SEED)

    cfg = get_config("S", n_classes=28)
    model = init_model(cfg, torch.Generator().manual_seed(SEED), dev)
    t0 = time.perf_counter()
    clsts, descs = train_visloc.get_clusters(model, whole, cfg, 20, 5000,
                                             SEED)
    train_visloc.init_netvlad(model, clsts, descs)
    torch.cuda.synchronize()
    log(f"visloc: cluster init (20 images, {len(descs)} descriptors, "
        f"k-means of {cfg.num_clusters} on the card) "
        f"{time.perf_counter() - t0:.2f} s")

    reset_launches()
    t0 = time.perf_counter()
    miner.cache = train_visloc.build_cache(model, whole)
    cache_ms = (time.perf_counter() - t0) * 1e3 / len(whole)
    cache_launches = (fused_stem_pair_pool.launches, netvlad.launches)
    forwards = -(-len(whole) // train_visloc.CACHE_BATCH)
    log(f"visloc: cache of {len(whole)} images, {cache_ms:.3f} ms an image "
        f"(host clock, image reads included); stem / NetVLAD launches "
        f"{cache_launches} for {forwards} forwards")
    require(cache_launches == (forwards, forwards),
            "visloc: the cache should launch the stem and NetVLAD once a "
            "forward")

    mined = [m for m in (miner.mine(i) for i in range(len(miner)))
             if m is not None]
    require(len(mined) >= 4, f"visloc: {len(mined)} queries mined")
    require(all(len(m[2]) == VPR_NEG for m in mined[:4]),
            "visloc: fewer than 10 negatives")
    ref = {k: v.detach().cpu().clone() for k, v in
           model.state_dict().items()}

    def one_step(device, train_mode=False):
        m = build_model(cfg)
        m.load_state_dict(ref)
        m = m.to(device).eval()
        if train_mode:  # the control: the step's eval() made a no-op
            m.train()
            m.eval = lambda: m
        opt = torch.optim.Adam(m.parameters(), lr=1e-5)
        loss = train_visloc.make_vpr_step(m, opt, 0.1)(*mined[0])
        return m, float(loss)

    (c_model, c_loss), (p_model, p_loss) = one_step(dev), one_step("cpu")
    gaps, rel = vpr_grad_gaps(c_model, p_model)
    stem = {k: gaps[k] for k in gaps if k.startswith(("backbone.conv1a",
                                                      "backbone.conv1b"))}
    worst = max(gaps, key=lambda k: gaps[k][0])
    log(f"visloc: one step, card against CPU: loss {c_loss:.6f} / "
        f"{p_loss:.6f}; gradients {rel:.3g} apart in relative L2, the "
        f"largest a parameter's {gaps[worst][0]:.3g} ({worst}); the "
        f"stem's [relative L2, max over the largest] "
        + json.dumps({k: [float(f"{v:.3g}") for v in g]
                      for k, g in stem.items()}))
    with torch.backends.cudnn.flags(enabled=False):
        w_model, _ = one_step(dev)
    w_gaps, w_rel = vpr_grad_gaps(w_model, p_model)
    w_worst = max(w_gaps.values(), key=lambda g: g[0])[0]
    x_model, _ = one_step(dev, train_mode=True)
    x_gaps, x_rel = vpr_grad_gaps(x_model, p_model)
    x_stem = max(x_gaps[k][0] for k in stem)
    log(f"visloc: witness, the card's step without cuDNN (no FFT "
        f"convolutions): gradients {w_rel:.3g} from the CPU's, the largest "
        f"a parameter's {w_worst:.3g}, the stem's largest "
        f"{max(w_gaps[k][0] for k in stem):.3g}; control, BN in train "
        f"mode: {x_rel:.3g}, the stem's largest {x_stem:.3g}")
    require(p_loss > 0, "visloc: the mined triplet's loss is 0")
    require(abs(c_loss - p_loss) <= 1e-4 * max(1.0, p_loss),
            "visloc: the loss differs from the CPU's")
    require(len(stem) == 6 and rel <= VPR_GAP
            and all(g[0] <= VPR_GAP for g in stem.values()),
            "visloc: the gradients differ from the CPU's")
    require(x_rel > VPR_GAP and x_stem > VPR_GAP,
            "visloc: the control (BN in train mode) passed")

    opt = torch.optim.Adam(model.parameters(), lr=1e-5)
    step = train_visloc.make_vpr_step(model, opt, 0.1)
    reset_launches()
    step_ms = []
    for q, pos, negs in mined[:12]:
        t0 = time.perf_counter()
        step(q, pos, negs)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    n = len(step_ms)
    step_launches = {"fused_stem_pair_pool": fused_stem_pair_pool.launches,
                     "netvlad": netvlad.launches,
                     "netvlad_backward": netvlad_backward.launches}
    log(f"visloc: {n} steps of 12 images, ms a step {steady(step_ms):.3f} "
        f"(steady median, host clock, the images' transfer included; "
        f"first {step_ms[0]:.1f}); launches {step_launches}")
    require(step_launches == {"fused_stem_pair_pool": 0, "netvlad": n,
                              "netvlad_backward": n},
            "visloc: a step should launch NetVLAD's forward and backward "
            "once and the stem never")
    q, pos, negs = mined[0]
    log_breakdown("visloc: a step", lambda: step(q, pos, negs),
                  steady(step_ms))

    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, PYTHONPATH=repo)
        out = os.path.join(tmp, "vl")
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "nanovs_slam_torch.train_visloc",
             "--synthetic", "--n_epochs", "1", "--max_queries", "4",
             "--cluster_images", "20", "--cluster_samples", "5000",
             "--eval_recall", "--out_model_path", out], cwd=tmp, env=env,
            capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t0
        log("visloc: CLI " + " | ".join(r.stdout.strip().splitlines()[-4:]))
        require(r.returncode == 0, f"visloc: the CLI failed\n{r.stdout}\n"
                f"{r.stderr}")
        line = [v for v in r.stdout.splitlines() if v.startswith("epoch 0")]
        require(bool(line) and int(line[0].split()[2].split("/")[0]) > 0,
                "visloc: the CLI trained on no query")
        tree, meta = load_npz_checkpoint(out + ".npz")
    load_jax_variables(build_model(cfg), tree["params"], tree["batch_stats"])
    log(f"visloc: CLI one epoch of 4 queries in {cli_s:.1f} s (process "
        f"start, cluster init, two caches included); its .npz loads back "
        f"(epoch {meta['epoch']}); phase {time.perf_counter() - t_phase:.1f}"
        " s")
    return {"visloc": {"fused_stem_pair_pool": cache_launches[0],
                       "netvlad": cache_launches[1] + n,
                       "netvlad_backward": n}}


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


# ------------------------------------------------------ KeypointFormer phase

def all_launches() -> dict:
    """Every wrapper's launch count, the bf16 instances' under
    ``<name>_bf16``."""
    from nanovs_slam_torch.kernels import BF16_KERNELS, KERNELS

    every = {k.__name__: k.launches for k in KERNELS}
    every.update({k.__name__ + "_bf16": k.launches_bf16
                  for k in BF16_KERNELS})
    return every


def kf_model(name: str, seed: int, n_classes: int = 28, dtype="float32"):
    """(cfg, KeypointFormer ``name`` on the CPU in eval mode) with
    init_model's seeded weights and random BN statistics."""
    import dataclasses

    import torch

    from nanovs_slam_torch.models.keypoint_former import (
        KEYPOINTFORMER_CONFIGS, init_model)

    cfg = dataclasses.replace(KEYPOINTFORMER_CONFIGS[name],
                              n_classes=n_classes, dtype=dtype)
    gen = torch.Generator().manual_seed(seed)
    model = init_model(cfg, gen, "cpu")
    randomize_bn(model, gen)
    return cfg, model


def kf_spread_scores(model, x, gain: float = 10.0) -> None:
    """As spread_scores for KeypointFormer: the score head's last conv
    spread by ``gain`` and shifted so that a tenth of the cells of the
    model input ``x`` (B, H, W, 3) in [-1, 1] pass the 0.7 threshold."""
    import torch

    conv = model.score_conv1
    logits = []
    hook = conv.register_forward_hook(lambda m, i, o: logits.append(o))
    try:
        with torch.no_grad():
            conv.weight.mul_(gain)
            conv.bias.zero_()
            model(torch.as_tensor(x, dtype=torch.float32).permute(0, 3, 1, 2))
            z = logits[0].float()  # before the sigmoid, which saturates
            conv.bias.fill_(math.log(0.7 / 0.3)
                            - float(torch.quantile(z, 0.9)))
    finally:
        hook.remove()


def kf_serving_cell(dev, name: str, seed: int) -> dict:
    """KeypointFormer ``name`` (28 classes, seeded weights and BN stats,
    scores spread) served at 256x320 through make_infer_fn(top_k=1000,
    conf_threshold=0.7) on a batch-1 and a batch-8 uint8 request, at
    float32 and at bfloat16: the postprocess and NetVLAD kernels (the
    float32 or the bf16 instance, C = feat_dim) launched once a request
    each and no other kernel; the batch-1 answers against the CPU's
    (compare_with_cpu at float32, hold_bf16 at bf16); the steady median
    ms per request, float32 and bf16 in turns. Returns the launches by
    path."""
    import dataclasses

    import torch

    from nanovs_slam_torch.inference import make_infer_fn
    from nanovs_slam_torch.kernels import (fused_postprocess, netvlad,
                                           reset_launches)
    from nanovs_slam_torch.models.keypoint_former import build_model
    from nanovs_slam_torch.ops.image import to_model_input

    h, w = KF_HW
    cfg32, model32 = kf_model(name, seed)
    rs = np.random.RandomState(seed)
    requests = [rs.randint(0, 256, (b, h, w, 3)).astype(np.uint8)
                for b in (1, 8)]
    kf_spread_scores(model32, to_model_input(torch.from_numpy(
        requests[0])))
    cfg16 = dataclasses.replace(cfg32, dtype="bfloat16")
    model16 = build_model(cfg16).eval()
    model16.load_state_dict(model32.state_dict())
    cpu32, cpu16 = copy.deepcopy(model32), copy.deepcopy(model16)
    kw = dict(top_k=1000, conf_threshold=0.7)
    infers = {"float32": make_infer_fn(model32, cfg32, h, w, device=dev,
                                       **kw),
              "bfloat16": make_infer_fn(model16, cfg16, h, w, device=dev,
                                        **kw)}
    label = f"kf {name}"
    paths, answers = {}, {}
    for dt, cfg in (("float32", cfg32), ("bfloat16", cfg16)):
        bf = dt == "bfloat16"
        reset_launches()
        answers[dt] = [infers[dt](frames) for frames in requests]
        torch.cuda.synchronize()
        on_path = ({PP_BF16: fused_postprocess.launches_bf16,
                    NV_BF16: netvlad.launches_bf16} if bf else
                   {"fused_postprocess": fused_postprocess.launches,
                    "netvlad": netvlad.launches})
        every = all_launches()
        log(f"{label} {dt}: launches during {len(requests)} requests "
            f"{every}")
        require(all(n == len(requests) for n in on_path.values())
                and sum(every.values()) == 2 * len(requests),
                f"{label} {dt}: one launch a request of the postprocess "
                f"and NetVLAD, nothing else: {every}")
        for frames, out in zip(requests, answers[dt]):
            check_answer(out, len(frames), h, w, cfg, kw["top_k"])
        paths[f"kf_{name}" + ("_bf16" if bf else "")] = on_path
    ref = make_infer_fn(cpu32, cfg32, h, w, device="cpu",
                        **kw)(requests[0])
    errs = compare_with_cpu(answers["float32"][0], ref)
    n_valid = [int(a["keypoint_valid"].sum()) for a in answers["float32"]]
    log(f"{label}: B=1 vs CPU {json.dumps(errs)}; valid keypoints "
        f"{n_valid} (CPU {int(ref['keypoint_valid'].sum())})")
    require(min(n_valid) > 0, f"{label}: a request has no valid keypoint")
    peer = make_infer_fn(cpu16, cfg16, h, w, device="cpu",
                         **kw)(requests[0])
    errs16 = hold_bf16(f"{label} bf16",
                       {k: v.cpu() for k, v in
                        answers["bfloat16"][0].items()}, peer,
                       {k: v.cpu() for k, v in
                        answers["float32"][0].items()},
                       kw["conf_threshold"])
    log(f"{label} bf16: B=1 vs the CPU at bf16 and the card at float32 "
        f"{json.dumps(errs16)}")
    ms = {}
    for frames in requests:
        times = {"float32": [], "bfloat16": []}
        for dt in ("float32", "bfloat16", "bfloat16", "float32") * 6:
            t0 = time.perf_counter()
            infers[dt](frames)
            torch.cuda.synchronize()
            times[dt].append((time.perf_counter() - t0) * 1e3)
        for dt in times:
            ms[f"{dt}_B{len(frames)}"] = statistics.median(times[dt][4:])
    log(f"{label} ({card_line()}): steady median ms per request (host "
        f"clock, float32 and bf16 in turns) {json.dumps(ms)}; one launch "
        "of the postprocess and one of NetVLAD a request")
    return paths


def kf_eval_cli(dev, repo: str, tmp: str) -> dict:
    """``eval_multitask --model_type KeypointFormer --config default
    --im_h 256 --im_w 320 --keypoints`` (in process) on a seeded 1-sequence
    synthetic HPatches set written in this run
    (scripts/make_synthetic_hpatches.py, cv2), for a seeded checkpoint
    with scores spread on the set's first image, on the card at float32
    and with ``--bf16``, and
    on the CPU at float32: keypoint results without error, the
    postprocess and NetVLAD once a request on the card (their bf16
    instances with ``--bf16``), repeatability, localisation error and
    matching score within 1e-3 of the CPU's at float32 (the bf16 results
    printed beside them: the seeded model's bf16 scores may pass no cell
    of a pair at 0.7, a repeatability of -1). Returns the launches by
    path."""
    import torch

    from nanovs_slam_torch import eval_multitask
    from nanovs_slam_torch.data.hpatches import HPatchesDataset
    from nanovs_slam_torch.inference import make_eval_fn
    from nanovs_slam_torch.kernels import (fused_postprocess, netvlad,
                                           reset_launches)
    from nanovs_slam_torch.utils.checkpoint import save_model_checkpoint

    hp = os.path.join(tmp, "hpatches")
    r = subprocess.run([sys.executable, os.path.join(
        repo, "scripts", "make_synthetic_hpatches.py"), hp, "--n-seq", "1"],
        capture_output=True, text=True, timeout=300)
    require(r.returncode == 0, "kf eval: the HPatches fixture needs cv2: "
            f"{r.stderr[-400:]}")
    ds_cfg = os.path.join(tmp, "datasets.json")
    with open(ds_cfg, "w") as f:
        json.dump({"hpatches_data_path": hp}, f)
    h, w = KF_HW
    cfg, model = kf_model("default", SEED + 1700)
    items = list(HPatchesDataset(hp, (w, h)))[:4]
    first = items[0]
    # both sides of the pairs: with a spread of 10 the random score head
    # passes none of a darker warp's cells (seen with cv2 4.13's fixture)
    kf_spread_scores(model, np.concatenate(
        [it[k] for it in items for k in ("image", "image_aug")]), 1.0)
    ck = save_model_checkpoint(os.path.join(tmp, "kf_default"), model)
    above = {}
    for d in (dev, torch.device("cpu")):
        out = make_eval_fn(copy.deepcopy(model).to(d), cfg, h, w)(
            first["image"])
        above[d.type] = int((out["score"] > 0.7).sum())
    log(f"kf eval: cells above 0.7 in the set's first image {above}")
    require(above[dev.type] > 0, "kf eval: no cell above the threshold")
    n_items, top_k = 4, 300
    paths = {}
    res = {}
    for flags in ([], ["--bf16"]):
        for d in ("cuda",) if flags else ("cuda", "cpu"):
            out = os.path.join(tmp, f"kf_eval_{d}{len(flags)}.json")
            reset_launches()
            t0 = time.perf_counter()
            eval_multitask.main(
                ["--model_type", "KeypointFormer", "--config", "default",
                 "--n_classes", "28", "--model_path", ck, "--im_h", str(h),
                 "--im_w", str(w), "--keypoints", "--max_items",
                 str(n_items), "--top_k", str(top_k), "--dataset_config",
                 ds_cfg, "--device", d, "--out", out] + flags)
            secs = time.perf_counter() - t0
            with open(out) as f:
                res[d + "".join(flags)] = json.load(f)[
                    f"keypoints_top{top_k}"]
            if d == "cuda":
                bf = bool(flags)
                launches = ({PP_BF16: fused_postprocess.launches_bf16,
                             NV_BF16: netvlad.launches_bf16} if bf else
                            {"fused_postprocess": fused_postprocess.launches,
                             "netvlad": netvlad.launches})
                require(all(n == 2 * n_items for n in launches.values()),
                        f"kf eval {flags}: launches {launches} for "
                        f"{2 * n_items} requests")
                paths["kf_eval" + ("_bf16" if bf else "")] = launches
                log(f"kf eval {flags}: the CLI on the card in {secs:.1f} s "
                    f"({n_items} pairs); launches {launches}")
    require(res["cuda"]["repeatability"] >= 0, f"kf eval: {res['cuda']}")
    require("error" not in res["cuda--bf16"], f"kf eval --bf16: "
            f"{res['cuda--bf16']}")  # the seeded model's bf16 scores may
    # pass no cell of a pair at 0.7: repeatability -1 is a result there
    for k in ("repeatability", "localization_error", "mscore"):
        gap = abs(res["cuda"][k] - res["cpu"][k])
        require(gap <= 1e-3, f"kf eval: {k} card {res['cuda'][k]} cpu "
                f"{res['cpu'][k]}")
    log("kf eval: card, card --bf16, cpu " + json.dumps(res))
    return paths


def kf_train_batch(seed: int) -> dict:
    """A batch of the KeypointFormer trainer's synthetic data at 96x128
    (8 classes, batch 4, d_f = cell / 2 = 4), the pair built on the CPU."""
    from nanovs_slam_torch.data.datasets import SyntheticShapesDataset
    from nanovs_slam_torch.data.pipeline import PairLoader

    h, w = KF_TRAIN_HW
    loader = PairLoader(SyntheticShapesDataset((h, w), 64, KF_CLASSES,
                                               seed=0),
                        KF_TRAIN_B, h, w, d_f=4, seed=seed, device="cpu")
    return next(iter(loader))


def kf_train_state(name: str, device, dtype: str = "float32"):
    """KeypointFormer ``name`` (8 classes, compute ``dtype``) with
    init_model's seeded weights, a seeded inlier net and Adam at 5e-4 on
    the cosine schedule (16 steps an epoch, 2 epochs), as the CLI builds
    them on the synthetic set."""
    import torch

    from nanovs_slam_torch.models.inlier_net import init_inlier_net
    from nanovs_slam_torch.train.schedules import make_lr_schedule
    from nanovs_slam_torch.train.train_step import (create_train_state,
                                                    make_optimizer)

    cfg, model = kf_model(name, SEED + 1800, KF_CLASSES, dtype)
    io = init_inlier_net(torch.Generator().manual_seed(SEED + 2),
                         device=device)
    spec = make_optimizer("adam", schedule=make_lr_schedule(
        "cosine", 5e-4, 16, 2))
    return cfg, create_train_state(model.to(device), spec, io_net=io)


KF_VPR = ("vlad_conv0", "vlad_bn0", "vlad_conv1", "netvlad")


def kf_train_cell(dev, name: str) -> dict:
    """KeypointFormer ``name`` trained on the card (96x128, batch 4, the
    synthetic set's 8 classes): one float32 step against the CPU's
    (compare_train_steps, grad_norm to 1e-3 relative) and one bf16 step
    against the CPU's bf16 and float32 steps (compare_bf16_steps over the
    VPR head); then 20 steps at each dtype on a fixed batch: finite
    losses, the loss without the gated IO term falling, NetVLAD's forward
    and backward kernels (with the bias; at bf16 their bf16 instances)
    twice a step and nothing else; the steady ms a step. Returns the
    launches by path."""
    import torch

    from nanovs_slam_torch.kernels import (netvlad, netvlad_backward,
                                           reset_launches)
    from nanovs_slam_torch.train.schedules import DEFAULT_LOSS_WEIGHTS
    from nanovs_slam_torch.train.train_step import make_train_step

    h, w = KF_TRAIN_HW
    batch = kf_train_batch(SEED + 1900)
    weights = DEFAULT_LOSS_WEIGHTS
    label = f"kf train {name}"
    steps = {}  # (dtype, "card" or "cpu") -> (state, metrics)
    for dtype in ("float32", "bfloat16"):
        for where, device in (("card", dev), ("cpu", torch.device("cpu"))):
            cfg, state = kf_train_state(name, device, dtype)
            step = make_train_step(cfg, h, w, io_top_k=300)
            state, met = step(state, {k: v.to(device) for k, v in
                                      batch.items()}, weights)
            steps[(dtype, where)] = (state, {k: float(v) for k, v in
                                             met.items()})
    log(f"{label}: one step's terms on the card "
        f"{json.dumps(steps[('float32', 'card')][1])}")
    compare_train_steps(steps[("float32", "card")], steps[("float32", "cpu")],
                        5e-4, grad_norm_rel=1e-3)
    n_interior = (h // 8 - 2) * (w // 8 - 2) * KF_TRAIN_B
    compare_bf16_steps(steps[("bfloat16", "card")],
                       steps[("bfloat16", "cpu")], steps[("float32", "cpu")],
                       steps[("float32", "card")][0], KF_VPR, n_interior,
                       ("vlad_conv0.bias",), unit_floor=True)
    dbatch = {k: v.to(dev) for k, v in batch.items()}
    paths = {}
    for dtype in ("float32", "bfloat16"):
        bf = dtype == "bfloat16"
        cfg, state = kf_train_state(name, dev, dtype)
        step = make_train_step(cfg, h, w, io_top_k=300)
        torch.cuda.synchronize()
        reset_launches()
        losses, io_terms, step_ms = [], [], []
        for _ in range(20):
            t0 = time.perf_counter()
            state, met = step(state, dbatch, weights)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(met["total_loss"]))
            io_terms.append(float(met["io_loss"]))
        on_path = ({NV_BF16: netvlad.launches_bf16,
                    NVB_BF16: netvlad_backward.launches_bf16} if bf else
                   {"netvlad": netvlad.launches,
                    "netvlad_backward": netvlad_backward.launches})
        every = all_launches()
        log(f"{label} {dtype}: launches during 20 steps {every}")
        require(all(n == 40 for n in on_path.values())
                and sum(every.values()) == 80,
                f"{label} {dtype}: NetVLAD's forward and backward twice a "
                f"step and nothing else: {every}")
        require(all(math.isfinite(v) for v in losses),
                f"{label} {dtype}: losses {losses}")
        rest = [t - weights.keypoint_loss * io
                for t, io in zip(losses, io_terms)]
        log(f"{label} {dtype}: 20 steps on a fixed batch, without the IO "
            "term " + ", ".join(f"{v:.3f}" for v in rest))
        require(rest[-1] < rest[0], f"{label} {dtype}: the loss without "
                "the IO term did not fall")
        log(f"{label} {dtype} ({card_line()}): ms a step "
            f"{steady(step_ms):.3f} (steady median of the 20, host clock, "
            f"synchronised); first step {step_ms[0]:.1f} ms")
        paths[f"kf_train_{name}" + ("_bf16" if bf else "")] = on_path
    return paths


def kf_train_cli(repo: str, tmp: str) -> None:
    """``python -m nanovs_slam_torch.train_multitask --model_type
    KeypointFormer --dataset_name synthetic`` (in process) at "tiny" and
    "default", float32 and ``--bf16``, 1 epoch of 3 steps without the
    evaluation: each checkpoint loads back into the port's KeypointFormer
    (flax names, strict) and gives a finite forward."""
    import dataclasses

    import torch

    from nanovs_slam_torch import train_multitask
    from nanovs_slam_torch.models.keypoint_former import (
        KEYPOINTFORMER_CONFIGS, build_model)
    from nanovs_slam_torch.utils.checkpoint import load_npz_checkpoint
    from nanovs_slam_torch.utils.convert import load_jax_variables

    cwd = os.getcwd()
    try:
        os.chdir(tmp)
        for name in ("tiny", "default"):
            for flags in ([], ["--bf16"]):
                out = os.path.join(tmp, f"kf_{name}{len(flags)}")
                t0 = time.perf_counter()
                train_multitask.main(
                    ["--model_type", "KeypointFormer", "--config", name,
                     "--dataset_name", "synthetic", "--no_eval",
                     "--n_epochs", "1", "--max_steps_per_epoch", "3",
                     "--log_every", "1", "--out_model_path", out] + flags)
                secs = time.perf_counter() - t0
                tree, meta = load_npz_checkpoint(out + ".npz")
                cfg = dataclasses.replace(KEYPOINTFORMER_CONFIGS[name],
                                          n_classes=KF_CLASSES)
                model = load_jax_variables(build_model(cfg), tree["params"],
                                           tree["batch_stats"]).eval()
                with torch.no_grad():
                    o = model(torch.zeros(1, 3, *KF_TRAIN_HW))
                require(meta["step"] == 3 and all(
                    bool(torch.isfinite(v).all()) for v in o.values()),
                    f"kf train CLI {name} {flags}: step {meta['step']}")
                log(f"kf train CLI {name} {flags}: 3 steps in {secs:.1f} s; "
                    "its .npz loads back and serves a finite forward")
    finally:
        os.chdir(cwd)


def keypoint_former_phase(dev, repo: str) -> dict:
    """KeypointFormer on the card: serving ("tiny" and "default" at
    256x320, float32 and bf16), the evaluation CLI, training (both configs
    and dtypes) and the training CLI. Returns the launches by path."""
    import tempfile

    t_phase = time.perf_counter()
    paths = {}
    for i, name in enumerate(("tiny", "default")):
        paths.update(kf_serving_cell(dev, name, SEED + 1600 + i))
    with tempfile.TemporaryDirectory() as tmp:
        paths.update(kf_eval_cli(dev, repo, tmp))
    for name in ("tiny", "default"):
        paths.update(kf_train_cell(dev, name))
    with tempfile.TemporaryDirectory() as tmp:
        kf_train_cli(repo, tmp)
    log(f"kf: phase {time.perf_counter() - t_phase:.1f} s")
    return paths


# ---------------------------------------------------- LightGlue training

def lightglue_train_phase(dev, repo: str) -> dict:
    """LightGlue training at the CLI's defaults (extractor N seeded,
    kp2dtiny_S at D = 32, 120x160, K = 256, batch 2, Adam 1e-4): one
    step's batch made on the card, the step on the card against the same
    step on the CPU (loss within 1e-5 relative; parameters within 1e-5
    where both gradients are at least 1e-6 and agree in sign, 2 lr
    everywhere); 20 steps through the CLI's own pieces
    (``train_lightglue``'s build_extractor, build_matcher, make_batch_fn
    and train_step): finite NLLs whose mean over the last 5 steps is below
    that over the first 5, the stem and postprocess kernels twice a step
    (the frozen extractor on the pair) and nothing else (the stack trains
    through its plain blocks), ms a step; then ``main()`` for 3 steps,
    whose ``.npz`` loads into ``make_pair_matcher`` and matches a pair
    with the LightGlue kernel. Returns the launches by path."""
    import tempfile

    import torch

    from nanovs_slam_torch import train_lightglue as tl
    from nanovs_slam_torch.kernels import (fused_postprocess,
                                           fused_stem_pair_pool,
                                           lightglue_transformer,
                                           reset_launches)
    from nanovs_slam_torch.matching.configs import LIGHTGLUE_CONFIGS
    from nanovs_slam_torch.matching.extractor import make_extractor
    from nanovs_slam_torch.matching.lightglue import LightGlue
    from nanovs_slam_torch.matching.pair import make_pair_matcher
    from nanovs_slam_torch.matching.synthetic import (textured_frame,
                                                      warp_frame)
    from nanovs_slam_torch.utils.checkpoint import load_npz_checkpoint
    from nanovs_slam_torch.utils.convert import load_jax_lightglue

    t_phase = time.perf_counter()
    args = tl.parse_args(["--device", "cuda"])
    h, w = args.im_h, args.im_w
    ex_model, cfg = tl.build_extractor(args, dev)
    extract = make_extractor(ex_model, cfg, h, w,
                             max_keypoints=args.max_keypoints, device=dev)
    make_batch = tl.make_batch_fn(args, extract, tl.image_source(args),
                                  np.random.RandomState(args.seed), dev)
    data, gt = make_batch(0)
    results = []
    for device in (dev, torch.device("cpu")):
        m = tl.build_matcher(args.lg_config, cfg.nfeatures, args.seed, device)
        loss, _ = tl.train_step(m, tl.make_optimizer(m, args.lr),
                                {k: v.to(device) for k, v in data.items()},
                                {k: v.to(device) for k, v in gt.items()})
        results.append((m, float(loss)))
    (cm, closs), (pm, ploss) = results
    require(abs(closs - ploss) <= 1e-5 * abs(ploss),
            f"lg train: loss card {closs} cpu {ploss}")
    p_max, n_flip = 0.0, 0
    cpu_params = dict(pm.named_parameters())
    for k, p in cm.named_parameters():
        q = cpu_params[k]
        d = (p.detach().cpu() - q.detach()).abs()
        require(d.max().item() <= 2 * args.lr, f"lg train: parameter {k}")
        if p.grad is None:
            continue
        gc, gp = p.grad.cpu(), q.grad
        agree = ((gc.abs() >= 1e-6) & (gp.abs() >= 1e-6)
                 & (torch.sign(gc) == torch.sign(gp)))
        if agree.any():
            p_max = max(p_max, d[agree].max().item())
        n_flip += int((torch.sign(gc) != torch.sign(gp)).sum())
    log(f"lg train: one step, card vs CPU: loss {closs} / {ploss}, "
        f"parameters {p_max} apart where the gradients agree, "
        f"{n_flip} gradient signs differ")
    require(p_max <= 1e-5, f"lg train: parameters {p_max} apart")

    matcher = tl.build_matcher(args.lg_config, cfg.nfeatures, args.seed, dev)
    opt = tl.make_optimizer(matcher, args.lr)
    torch.cuda.synchronize()
    reset_launches()
    nll, step_ms = [], []
    for i in range(20):
        t0 = time.perf_counter()
        d_i, g_i = make_batch(i)
        loss, _ = tl.train_step(matcher, opt, d_i, g_i)
        nll.append(float(loss))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    on_path = {"fused_stem_pair_pool": fused_stem_pair_pool.launches,
               "fused_postprocess": fused_postprocess.launches}
    every = all_launches()
    log(f"lg train: launches during 20 steps {every}")
    require(all(n == 40 for n in on_path.values())
            and sum(every.values()) == 80,
            f"lg train: the stem and postprocess twice a step and nothing "
            f"else: {every}")
    log("lg train: NLL over 20 steps " + ", ".join(f"{v:.4f}" for v in nll))
    require(all(math.isfinite(v) for v in nll), f"lg train: NLL {nll}")
    require(np.mean(nll[-5:]) < np.mean(nll[:5]),
            "lg train: the NLL did not fall")
    log(f"lg train ({card_line()}): ms a step {steady(step_ms):.3f} (steady "
        f"median of 20, host clock: the batch (2 images, their warps, "
        f"extraction, ground truth on the host) and the step); first step "
        f"{step_ms[0]:.1f} ms; 2 stem and 2 postprocess launches a step")

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "lg")
        t0 = time.perf_counter()
        require(tl.main(["--n_steps", "3", "--log_every", "1",
                         "--out_model_path", out]) == 0, "lg train: main")
        secs = time.perf_counter() - t0
        tree, meta = load_npz_checkpoint(out + ".npz")
    lg = load_jax_lightglue(LightGlue(LIGHTGLUE_CONFIGS[
        meta["config"]["lg_config"]]), tree["params"])
    match = make_pair_matcher(ex_model, cfg, lg, h, w, args.max_keypoints,
                              device=dev)
    img0 = textured_frame(h, w, SEED + 2000)
    img1 = warp_frame(img0)
    reset_launches()
    pair = match(torch.from_numpy(img0[None] * 2 - 1).to(dev),
                 torch.from_numpy(img1[None] * 2 - 1).to(dev))
    torch.cuda.synchronize()
    m0 = pair["matches0"]
    require(lightglue_transformer.launches == 1
            and bool(((m0 >= -1) & (m0 < args.max_keypoints)).all()),
            f"lg train: the trained matcher's pair: "
            f"{lightglue_transformer.launches} kernel launches")
    log(f"lg train: main() 3 steps in {secs:.1f} s; its .npz matches a "
        f"pair through make_pair_matcher ({int((m0 >= 0).sum())} matches, "
        "one LightGlue kernel launch)")
    log(f"lg train: phase {time.perf_counter() - t_phase:.1f} s")
    return {"lg_train": on_path}


# --------------------------------------------------------------- int8 phase

INT8 = "int8_conv3x3"
INT8_OPS_PER_S = 1979e12  # H100 SXM int8 tensor cores, dense
INT8_CALIB = 8  # eval_multitask's --calib_batches default
INT8_REPLACES = ("none: XLA's int8 conv in nanovs_slam_tpu/quant.py:124 "
                 "(int8_conv); no Pallas kernel")


def int8_pinned(repo: str, device, dtype: str = "float32"):
    """Pinned S8 (config S, 8 classes) computing in ``dtype`` on
    ``device`` in eval mode."""
    from nanovs_slam_torch.configs import get_config
    from nanovs_slam_torch.models.kp2dtiny import build_model
    from nanovs_slam_torch.utils.checkpoint import load_npz_checkpoint
    from nanovs_slam_torch.utils.convert import load_jax_variables

    tree, _ = load_npz_checkpoint(os.path.join(repo, "pinned",
                                               "extractor_S8.npz"))
    cfg = get_config("S", n_classes=8, dtype=dtype)
    model = load_jax_variables(build_model(cfg), tree["params"],
                               tree["batch_stats"])
    return model.to(device).eval(), cfg


def int8_calls(model, x, scales) -> list:
    """The int8 kernel's calls of one chained int8 forward of ``x`` (B, 3,
    H, W), in order: (path, the wrapper's arguments), read off the
    blocks' inputs, outputs and cached weight plans."""
    import torch
    import torch.nn as nn

    from nanovs_slam_torch import quant
    from nanovs_slam_torch.modules.blocks import ConvBNAct

    seen = {}
    blocks = [m for m in model.modules()
              if isinstance(m, ConvBNAct) and m.path in scales]
    hooks = [b.register_forward_hook(
        lambda mod, a, o: seen.__setitem__(mod.path, (a[0], o)))
        for b in blocks]
    try:
        with torch.no_grad(), quant.int8_execution(scales, chain=True):
            model(x)
    finally:
        for h in hooks:
            h.remove()
    calls = []
    for b in blocks:
        xin, out = seen[b.path]
        pre_q, emits = isinstance(xin, quant.QTensor), \
            isinstance(out, quant.QTensor)
        s_in = xin.scale if pre_q else scales[b.path]
        wq, m, a, bb = b._int8_plan[1]
        xv = xin.values if pre_q else xin.contiguous()
        h_in = xv.shape[1] if pre_q else xv.shape[2]
        pool = emits and out.values.shape[1] < h_in
        slope = 0.01 if isinstance(b.act, nn.LeakyReLU) else 0.0
        calls.append((b.path, (xv, wq, m, a, bb, s_in, slope,
                               out.scale if emits else None, pool,
                               b.conv.compute_dtype)))
    return calls


def int8_work(args) -> tuple:
    """(bytes, operations) of one int8 conv call: each input read once
    (x, the int8 weights, m, a, b), the output written once; 2 operations
    a multiply-add of the 9 Cin (unpadded) products an output."""
    from nanovs_slam_torch.kernels.int8conv import in_channels

    x, wq, m, a, b, _, _, out_scale, pool, out_dtype = args
    B, cin = x.shape[0], in_channels(x)
    H, W = (x.shape[1], x.shape[2]) if x.dtype.itemsize == 1 \
        else (x.shape[2], x.shape[3])
    cout = wq.shape[0]
    out_elems = B * cout * ((H // 2) * (W // 2) if pool else H * W)
    nbytes = (x.numel() * x.element_size() + wq.numel() + 12 * cout
              + out_elems * (out_dtype.itemsize if out_scale is None
                             else 1))
    return nbytes, 2.0 * B * H * W * cout * 9 * cin


def int8_im2col(args):
    """(A (M, Kpad) int8, B (Kpad, Cout) int8) of the call's codes: the
    same int8 product as one ``torch._int_mm`` (the library yardstick)."""
    import torch
    import torch.nn.functional as F

    from nanovs_slam_torch.kernels.int8conv import in_channels, true_divide

    x, wq, _, _, _, s_in = args[:6]
    cin = in_channels(x)
    if x.dtype == torch.int8:
        q = x.permute(0, 3, 1, 2).float()
    else:
        q = torch.clamp(torch.round(true_divide(x.float(), s_in)), -127,
                        127)
    B, _, H, W = q.shape
    cols = F.unfold(q, 3, padding=1)  # (B, Cin*9, H*W), (c, tap) order
    cols = cols.view(B, cin, 9, H * W).permute(0, 3, 2, 1).reshape(
        B * H * W, 9 * cin)
    A = torch.zeros(B * H * W, wq.shape[1], device=x.device,
                    dtype=torch.int8)
    A[:, :9 * cin] = cols.to(torch.int8)
    return A, wq.t()


def int8_kernel_cases(dev, model, scales, B: int, name: str = INT8,
                      sfx: str = None, runs: tuple = (20, 15),
                      plain_runs: tuple = (3, 5)) -> dict:
    """The int8 kernel against its twin at every call of a chained int8
    request of ``model`` at batch ``B`` (float32, bf16 or int8 in; the
    block's dtype, int8 or pooled int8 out): codes and float outputs
    equal; each call's kernel and ``torch._int_mm`` (im2col) time
    (``runs``: calls a trial and trials), its twin's (``plain_runs``) and
    its bound. Returns the
    kernels-line keys, suffixed ``sfx`` (default ``_b<B>`` beyond B=1):
    times and bounds summed over the request's calls."""
    import torch

    from nanovs_slam_torch.kernels import int8_conv3x3, int8_conv3x3_plain
    from nanovs_slam_torch.kernels.int8conv import launch_shape

    rs = np.random.RandomState(SEED + 1800 + B)
    x = torch.from_numpy(rs.uniform(-1, 1, (B, 3, H, W)).astype(
        np.float32)).to(dev)
    calls = int8_calls(model, x, scales)
    sums = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
            "t_bytes": 0.0, "t_ops": 0.0}
    err = 0.0
    for path, args in calls:
        got = int8_conv3x3(*args)
        want = int8_conv3x3_plain(*args)
        torch.cuda.synchronize()
        e = max_err(got, want)
        kind = "float" if args[7] is None else (
            "int8+pool" if args[8] else "int8")
        require(got.dtype == want.dtype and e == 0,
                f"{name} {path} B={B}: {kind} out {e} from the twin")
        err = max(err, e)
        A, Bm = int8_im2col(args)
        ms = cuda_ms(lambda: int8_conv3x3(*args), *runs)
        plain_ms = cuda_ms(lambda: int8_conv3x3_plain(*args),
                           inner=plain_runs[0], trials=plain_runs[1])
        try:  # cuBLASLt's int8 GEMM takes B column-major (wq's rows)
            torch._int_mm(A, Bm)
        except RuntimeError:
            Bm = Bm.contiguous()
        lib_ms = cuda_ms(lambda: torch._int_mm(A, Bm), *runs)
        nbytes, ops = int8_work(args)
        tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT8_OPS_PER_S * 1e3
        sums["ms"] += ms
        sums["plain_ms"] += plain_ms
        sums["library_ms"] += lib_ms
        sums["t_bytes"] += tb
        sums["t_ops"] += to
        xin = {torch.int8: "int8", torch.bfloat16: "bf16"}.get(
            args[0].dtype, "float")
        if kind == "float" and args[9] == torch.bfloat16:
            kind = "bf16"
        staged = ""
        if xin == "bf16":  # the same call as a float32 block
            a32 = (args[0].float(),) + args[1:9] + (torch.float32,)
            f_ms = cuda_ms(lambda: int8_conv3x3(*a32), *runs)
            f_sh = launch_shape(a32[0], args[1].shape[0], args[7],
                                args[8])
            staged = (f"; as a float32 block {f_ms:.4f} ms "
                      f"({f_sh['staged_channels']} x "
                      f"{f_sh['chunks_a_tile']} staged, "
                      f"{f_sh['blocks_per_sm']} an SM)")
        sh = launch_shape(args[0], args[1].shape[0], args[7], args[8],
                          args[9])
        d = sh["design"]
        for k, v in (("ms", ms), ("library_ms", lib_ms),
                     ("bound_ms", max(tb, to)), ("calls", 1)):
            sums[f"{k}_{d}"] = sums.get(f"{k}_{d}", 0) + v
        if d == "strips":
            launch = (
                f"strips: {sh['blocks_x']} persistent blocks of "
                f"{32 * (4 * sh['warpgroups'] + 2)} threads "
                f"({sh['warpgroups']} consumer warpgroups in two pipes, each "
                f"pipe fed by a producer warp), cluster 1, "
                f"{sh['blocks_per_sm']} an SM, "
                f"{sh['smem_bytes']} B shared, {sh['sms_covered']} of "
                f"{sh['sms']} SMs; {sh['tile_rows']}x{sh['tile_cols']} pixel"
                f" strips ({sh['m_blocks']} m-blocks of 64), bulk-copied "
                f"into {sh['stages']} stages of {sh['staged_channels']} "
                + ("rows" if xin == "int8" else "channels")
                + f"; wgmma m64n{args[1].shape[0]}k32, A and B from shared "
                f"memory, {sh['k_chunk'] // 32} k-steps; weights resident")
        else:
            launch = (
                f"tiles: {sh['blocks_x']}x{sh['blocks_y']} persistent "
                f"blocks of 256 threads, cluster 1, {sh['blocks_per_sm']} "
                f"an SM, {sh['smem_bytes']} B shared, {sh['sms_covered']} "
                f"of {sh['sms']} SMs; {sh['tile_rows']}x{sh['tile_cols']} "
                f"pixel tiles, {sh['stages']} stages, "
                f"{sh['channels_a_warp']} channels a warp; weights "
                + ("resident" if sh["weights_resident"]
                   else f"in K chunks of {sh['k_chunk']}")
                + (f"; {sh['staged_channels']} channels staged x "
                   f"{sh['chunks_a_tile']}" if xin != "int8" else ""))
        log(f"kernel {name} B={B} {path} ({xin} in, {kind} out, "
            f"{tuple(args[0].shape)} -> Cout {args[1].shape[0]}): "
            f"max_abs_err {e:.3g}, kernel {ms:.4f} ms, plain {plain_ms:.4f}"
            f" ms, _int_mm {lib_ms:.4f} ms, bound {max(tb, to):.5f} ms "
            f"({'bytes' if tb >= to else 'operations'}), "
            f"{max(tb, to) / ms:.1%} of it; launch {launch}" + staged)
    b_ms = max(sums["t_bytes"], sums["t_ops"])
    by = "bytes" if sums["t_bytes"] >= sums["t_ops"] else "operations"
    designs = {k: v for k, v in sums.items() if k.split("_")[-1] in
               ("tiles", "strips")}
    log(f"kernel {name} B={B} ({card_line()}): {len(calls)} calls a "
        f"request, summed kernel {sums['ms']:.4f} ms, plain "
        f"{sums['plain_ms']:.4f} ms, _int_mm {sums['library_ms']:.4f} ms, "
        f"bound {b_ms:.5f} ms ({by}), {b_ms / sums['ms']:.1%} of it; by "
        f"design {json.dumps(designs)}")
    if sfx is None:
        sfx = "" if B == 1 else f"_b{B}"
    return {"max_abs_err" + sfx: err, "ms" + sfx: sums["ms"],
            "plain_ms" + sfx: sums["plain_ms"], "bound_ms" + sfx: b_ms,
            "bound_by" + sfx: by, "library_ms" + sfx: sums["library_ms"],
            "calls_a_request" + sfx: len(calls),
            **{k + sfx: v for k, v in designs.items()}}


def int8_raw_gaps(model, x) -> dict:
    """tests/test_int8_execution.py's rule: scales calibrated on ``x``
    itself, the int8 forward's score and feat differ from float32's (the
    path is active) by a mean relative error under 0.02 and 0.15."""
    import torch

    from nanovs_slam_torch import quant

    scales = quant.calibrate_conv_scales(model, [x.permute(0, 2, 3, 1)])
    with torch.no_grad():
        f32 = model(x)
        with quant.int8_execution(scales, chain=True):
            i8 = model(x)
    rel = {}
    for k, lim in (("score", 0.02), ("feat", 0.15)):
        a, b = f32[k], i8[k]
        require(not torch.allclose(a, b), f"int8: {k} equals float32's")
        rel[k] = float((a - b).abs().mean() / (a.abs().mean() + 1e-9))
        require(rel[k] < lim, f"int8: {k} mean relative gap {rel[k]}")
    return rel


def int8_calibrate(model, n_classes: int, n: int = INT8_CALIB) -> dict:
    """eval_multitask --int8's calibration on the model's device: ``n``
    synthetic-shapes images (seed 3) through every head."""
    import torch

    from nanovs_slam_torch.data.datasets import SyntheticShapesDataset
    from nanovs_slam_torch.quant import calibrate_conv_scales

    calib = SyntheticShapesDataset((H, W), n, n_classes, seed=3)
    dev = next(model.parameters()).device
    t0 = time.perf_counter()
    scales = calibrate_conv_scales(
        model, [calib[i]["image"][None] * 2.0 - 1.0 for i in range(n)])
    if dev.type == "cuda":
        torch.cuda.synchronize()
    log(f"int8: {len(scales)} convs calibrated on {dev} in "
        f"{time.perf_counter() - t0:.2f} s ({n} images, compute "
        f"{model.cfg.compute_dtype})")
    return scales


def int8_serving(dev, repo: str, kernels: dict) -> dict:
    """The int8 S8 request at 240x320 (make_infer_fn with the scales of
    eval_multitask --int8's calibration, chained), B=1 and 8: launch counts
    (one int8 launch a calibrated conv, one postprocess and one NetVLAD a
    request, no stem), B=1 against the CPU, int8 against float32, ms a
    request. Returns its launches, its ``infer`` and its requests."""
    import torch

    from nanovs_slam_torch.inference import make_infer_fn
    from nanovs_slam_torch.kernels import (fused_postprocess,
                                           fused_stem_pair_pool,
                                           int8_conv3x3, netvlad,
                                           reset_launches)
    from nanovs_slam_torch.ops.image import to_model_input

    model, cfg = int8_pinned(repo, dev)
    cpu_model, _ = int8_pinned(repo, "cpu")
    scales = int8_calibrate(model, 8)
    cpu_scales = int8_calibrate(cpu_model, 8, 2)
    require(set(cpu_scales) == set(scales), "int8: calibration keys differ "
            "between the card and the CPU")

    kernels[INT8].update(int8_kernel_cases(dev, model, scales, 1))
    kernels[INT8].update(int8_kernel_cases(dev, model, scales, 8))

    rs = np.random.RandomState(SEED + 1900)
    requests = [rs.randint(0, 256, (b, H, W, 3)).astype(np.uint8)
                for b in (1, 8)]
    top_k = 1000
    infer = make_infer_fn(model, cfg, H, W, top_k=top_k, device=dev,
                          int8_scales=scales)
    infer(requests[0])
    torch.cuda.synchronize()
    reset_launches()
    answers = [infer(f) for f in requests]
    torch.cuda.synchronize()
    launches = {INT8: int8_conv3x3.launches,
                "fused_postprocess": fused_postprocess.launches,
                "netvlad": netvlad.launches,
                "fused_stem_pair_pool": fused_stem_pair_pool.launches}
    log(f"int8: launches during 2 requests {launches}")
    require(launches[INT8] == 2 * len(scales), f"int8: {launches[INT8]} "
            f"int8 launches for 2 requests of {len(scales)} convs")
    require(launches["fused_postprocess"] == 2 and launches["netvlad"] == 2,
            "int8: the postprocess or NetVLAD not once a request")
    require(launches["fused_stem_pair_pool"] == 0,
            "int8: the float stem ran on the int8 path")
    for frames, out in zip(requests, answers):
        check_answer(out, len(frames), H, W, cfg, top_k)
    ref = make_infer_fn(cpu_model, cfg, H, W, top_k=top_k, device="cpu",
                        int8_scales=scales)(requests[0])
    errs = compare_with_cpu(answers[0], ref)
    log(f"int8: B=1 vs CPU {json.dumps(errs)}")
    x = to_model_input(torch.from_numpy(requests[0]).to(dev))
    rel = int8_raw_gaps(model, x.permute(0, 3, 1, 2))
    log(f"int8: against float32, scales calibrated on the frame (mean "
        f"relative gap) {json.dumps(rel)}")

    f32 = make_infer_fn(model, cfg, H, W, top_k=top_k, device=dev)
    steady_ms = {}
    # in turns: int8, float32, float32, int8
    for name, fn in (("int8", infer), ("float32", f32), ("float32", f32),
                     ("int8", infer)):
        for frames in requests:
            times = []
            for _ in range(30):
                t0 = time.perf_counter()
                fn(frames)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            steady_ms.setdefault(f"{name} B={len(frames)}", []).append(
                statistics.median(times[5:]))
    dev_ms, share = busy_share(lambda: infer(requests[0]))
    log(f"int8 ({card_line()}): steady-state median ms per request, in "
        "turns, "
        + "; ".join(f"{k}: " + ", ".join(f"{v:.3f}" for v in t)
                    for k, t in steady_ms.items())
        + f"; int8 B=1 device {dev_ms:.3f} ms by the profiler, "
        f"{100 * share:.1f}% busy")
    return launches, infer, requests


def int8_bf16_launches(label: str, infer, requests, n_convs: int) -> tuple:
    """(launches, answers) of ``requests`` served by the bf16 int8
    ``infer``, the counts set to 0 just before: one int8 launch at bf16 a
    calibrated conv, one bf16 postprocess and one bf16 NetVLAD a request,
    no stem and no float32 instance."""
    import torch

    from nanovs_slam_torch.kernels import (KERNELS, fused_postprocess,
                                           fused_stem_pair_pool,
                                           int8_conv3x3, netvlad,
                                           reset_launches)

    infer(requests[0][:1])
    torch.cuda.synchronize()
    reset_launches()
    answers = [infer(f) for f in requests]
    torch.cuda.synchronize()
    n = len(requests)
    launches = {INT8_BF16: int8_conv3x3.launches_bf16,
                PP_BF16: fused_postprocess.launches_bf16,
                NV_BF16: netvlad.launches_bf16,
                STEM_BF16: fused_stem_pair_pool.launches_bf16}
    f32 = {k.__name__: k.launches for k in KERNELS if k.launches}
    log(f"{label}: launches during {n} requests {launches}, float32 "
        f"instances {f32}")
    require(launches[INT8_BF16] == n * n_convs and launches[PP_BF16] == n
            and launches[NV_BF16] == n and launches[STEM_BF16] == 0
            and not f32, f"{label}: launches {launches}, float32 {f32}")
    return launches, answers


def int8_turns(label: str, fns: dict, requests, rounds: int) -> None:
    """Steady median ms a request (host clock around a synchronised call)
    of each of ``fns`` on each request, taken in turns (A B C C B A), and
    each one's device ms and busy share (profiler) on the first."""
    import torch

    order = list(fns) + list(fns)[::-1]
    times = {}
    for frames in requests:
        for name in fns:
            fns[name](frames)
        torch.cuda.synchronize()
        for _ in range(rounds):
            for name in order:
                t0 = time.perf_counter()
                fns[name](frames)
                torch.cuda.synchronize()
                times.setdefault(f"{name} B={len(frames)}", []).append(
                    (time.perf_counter() - t0) * 1e3)
    busy = {}
    for name, fn in fns.items():
        dev_ms, share = busy_share(lambda: fn(requests[0]), 5)
        busy[f"{name} B={len(requests[0])}"] = (round(dev_ms, 3),
                                                round(100 * share, 1))
    log(f"{label} ({card_line()}): steady-state median ms a request, in "
        "turns, " + "; ".join(f"{k}: {statistics.median(t):.3f}"
                              for k, t in times.items())
        + f"; device ms and % busy (profiler) {json.dumps(busy)}")


def int8_bf16_s8(dev, repo: str, kernels: dict, infer_i8,
                 requests) -> dict:
    """Pinned S8 at bfloat16, int8 (the JAX package's int8 deployment
    config at the S8 request's sizes): calibrated at bf16 on the card, its
    23 int8 calls held against the twin at B=1 and 8, the request at B=1
    and 8 (launches; B=1 held against the CPU's bf16 int8 answer and the
    card's float32 int8 answer, hold_bf16's rule), and ms a request in
    turns beside the bf16 float request and the float32 int8 request
    (``infer_i8``). Returns its launches."""
    from nanovs_slam_torch.inference import make_infer_fn

    model, cfg = int8_pinned(repo, dev, "bfloat16")
    cpu_model, _ = int8_pinned(repo, "cpu", "bfloat16")
    model32, cfg32 = int8_pinned(repo, dev)
    scales = int8_calibrate(model, 8)
    for B in (1, 8):
        kernels[INT8_BF16].update(int8_kernel_cases(
            dev, model, scales, B, "int8_conv3x3[bf16]"))
    top_k = 1000
    infer = make_infer_fn(model, cfg, H, W, top_k=top_k, device=dev,
                          int8_scales=scales)
    label = "int8 bf16 S8"
    launches, answers = int8_bf16_launches(label, infer, requests,
                                           len(scales))
    for frames, out in zip(requests, answers):
        check_answer(out, len(frames), H, W, cfg, top_k)
    ref = make_infer_fn(model32, cfg32, H, W, top_k=top_k, device=dev,
                        int8_scales=scales)(requests[0])
    peer = make_infer_fn(cpu_model, cfg, H, W, top_k=top_k, device="cpu",
                         int8_scales=scales)(requests[0])
    errs = hold_bf16(label, {k: v.cpu() for k, v in answers[0].items()},
                     peer, {k: v.cpu() for k, v in ref.items()}, 0.0)
    log(f"{label}: B=1 vs the CPU's bf16 int8 answer and the card's "
        f"float32 int8 answer {json.dumps(errs)}")
    plain = make_infer_fn(model, cfg, H, W, top_k=top_k, device=dev)
    int8_turns(label, {"bf16": plain, "bf16 int8": infer,
                       "float32 int8": infer_i8}, requests, 8)
    return launches


def int8_bf16_n28(dev, kernels: dict) -> dict:
    """Config N, 28 classes, seeded weights and BN stats, at bfloat16 and
    int8 at B=128 (bench.py's int8 stage): calibrated at bf16 on the card,
    its 23 int8 calls held against the twin, the request's launches, and
    ms a request in turns beside the bf16 float request and the float32
    int8 request (the same scales). Returns its launches."""
    import torch

    from nanovs_slam_torch.configs import get_config
    from nanovs_slam_torch.inference import make_infer_fn
    from nanovs_slam_torch.models.kp2dtiny import build_model, init_model

    cfg32 = get_config("N", n_classes=28)
    cfg16 = get_config("N", n_classes=28, dtype="bfloat16")
    gen = torch.Generator().manual_seed(SEED + 2200)
    model32 = init_model(cfg32, gen, "cpu")
    randomize_bn(model32, gen)
    model16 = build_model(cfg16)
    model16.load_state_dict(model32.state_dict())
    model16 = model16.to(dev).eval()
    model32 = model32.to(dev).eval()
    scales = int8_calibrate(model16, 28)
    B = 128
    kernels[INT8_BF16].update(int8_kernel_cases(
        dev, model16, scales, B, "int8_conv3x3[bf16]", "_n28_b128",
        runs=(3, 5), plain_runs=(1, 1)))
    frames = np.random.RandomState(SEED + 2201).randint(
        0, 256, (B, H, W, 3)).astype(np.uint8)
    top_k = 1000
    infer = make_infer_fn(model16, cfg16, H, W, top_k=top_k, device=dev,
                          int8_scales=scales)
    label = "int8 bf16 N28"
    launches, answers = int8_bf16_launches(label, infer, [frames],
                                           len(scales))
    check_answer(answers[0], B, H, W, cfg16, top_k)
    del answers
    fns = {"bf16": make_infer_fn(model16, cfg16, H, W, top_k=top_k,
                                 device=dev),
           "bf16 int8": infer,
           "float32 int8": make_infer_fn(model32, cfg32, H, W, top_k=top_k,
                                         device=dev, int8_scales=scales)}
    int8_turns(label, fns, [frames], 3)
    return launches


def int8_bundle(dev) -> None:
    """A to_mcu S model (seeded weights and BN stats) calibrated on the
    card (heads score/loc/desc), exported as an .nvsb bundle; the numpy
    and C runtimes against the card's int8 forward (unchained, as the
    bundle runs): max error under 2e-2 and mean error under 2e-3 of the
    output's mean magnitude (tests/test_deploy_bundle.py's rule); the C
    runtime's largest gap to numpy printed beside (their float32 sums
    differ in order, which can move a code)."""
    import tempfile

    import torch

    from nanovs_slam_torch import deploy, quant
    from nanovs_slam_torch.configs import get_config
    from nanovs_slam_torch.models.kp2dtiny import init_model

    cfg = get_config("S", n_classes=8, to_mcu=True, to_export=True)
    gen = torch.Generator().manual_seed(SEED + 2000)
    model = init_model(cfg, gen, "cpu")
    randomize_bn(model, gen)
    model = model.to(dev).eval()
    img = np.random.RandomState(SEED + 2001).rand(H, W, 3).astype(
        np.float32)
    heads = ("score", "loc", "desc")
    scales = quant.calibrate_conv_scales(model, [img[None]], heads=heads)
    with torch.no_grad(), quant.int8_execution(scales):
        card = model(torch.from_numpy(img[None]).to(dev).permute(
            0, 3, 1, 2), heads=heads)
    card = {k: v[0].permute(1, 2, 0).cpu().numpy() for k, v in card.items()}
    with tempfile.TemporaryDirectory() as tmp:
        path = deploy.export_mcu_bundle(model, cfg,
                                        os.path.join(tmp, "s.nvsb"), scales)
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        got_np = deploy.run_bundle_numpy(path, img)
        t_np = time.perf_counter() - t0
        t0 = time.perf_counter()
        got_c = deploy.run_bundle_c(path, img)
        t_c = time.perf_counter() - t0
    gaps = {}
    for name, got in (("numpy", got_np), ("c", got_c)):
        require(set(got) == set(card), f"bundle {name}: keys {sorted(got)}")
        for k, r in card.items():
            g = got[k]
            require(g.shape == r.shape, f"bundle {name} {k}: {g.shape}")
            scale = np.abs(r).mean() + 1e-6
            mx, mean = np.abs(g - r).max() / scale, \
                np.abs(g - r).mean() / scale
            gaps[f"{name}/{k}"] = (float(mx), float(mean))
            require(mx < 2e-2 and mean < 2e-3,
                    f"bundle {name} {k}: {mx} / {mean} of the mean")
    c_np = max(float(np.abs(got_c[k] - got_np[k]).max()) for k in got_np)
    log(f"int8: bundle of {len(scales)} int8 convs, {size} bytes; numpy "
        f"{t_np:.2f} s, C {t_c:.2f} s (host, {H}x{W}); C against numpy "
        f"{c_np:.3g}; (max, mean) gap to the card / mean |output| "
        + json.dumps(gaps))


def int8_train() -> None:
    """3 steps of the trainer with --qat and 3 with --to_mcu (config S,
    the cocostuff config's 120x160 on its synthetic fallback, batch 4) on
    the card: every logged loss finite."""
    import tempfile

    from nanovs_slam_torch import train_multitask

    cwd = os.getcwd()
    for flag in ("--qat", "--to_mcu"):
        with tempfile.TemporaryDirectory() as tmp:
            try:
                os.chdir(tmp)
                t0 = time.perf_counter()
                train_multitask.main(
                    ["--no_eval", "--n_epochs", "1", "--max_steps_per_epoch",
                     "3", "--log_every", "1", "--out_model_path",
                     os.path.join(tmp, "ck"), flag])
                secs = time.perf_counter() - t0
                with open("metrics.jsonl") as f:
                    rows = [json.loads(line) for line in f]
            finally:
                os.chdir(cwd)
        losses = [r["loss/total_loss"] for r in rows
                  if "loss/total_loss" in r]
        require(len(losses) == 3 and all(map(math.isfinite, losses)),
                f"int8: {flag} losses {losses}")
        log(f"int8: train {flag} 3 steps in {secs:.1f} s, losses "
            + ", ".join(f"{v:.4f}" for v in losses))


def int8_eval_cli(repo: str) -> None:
    """eval_multitask --int8 and --int8_weight_only, and each with --bf16
    (pinned S8, 120x160, --keypoints on a seeded 1-sequence synthetic
    HPatches set, 2 pairs, --calib_batches 4) on the card and on the CPU:
    keypoint results within 1e-3; at bf16, whose card and CPU answers
    round at other places (cuDNN's bf16 convolutions and the CPU's), within
    test_torch_port_eval_cli.py's bf16 bounds (repeatability 0.03,
    localisation error 0.05 px, matching score 0.02)."""
    import tempfile

    from nanovs_slam_torch import eval_multitask

    with tempfile.TemporaryDirectory() as tmp:
        hp = os.path.join(tmp, "hpatches")
        r = subprocess.run([sys.executable, os.path.join(
            repo, "scripts", "make_synthetic_hpatches.py"), hp, "--n-seq",
            "1"], capture_output=True, text=True, timeout=300)
        require(r.returncode == 0, "int8 eval: the HPatches fixture needs "
                f"cv2: {r.stderr[-400:]}")
        ds_cfg = os.path.join(tmp, "datasets.json")
        with open(ds_cfg, "w") as f:
            json.dump({"hpatches_data_path": hp}, f)
        res = {}
        for flag in ("--int8", "--int8_weight_only", "--bf16 --int8",
                     "--bf16 --int8_weight_only"):
            tol = 1e-3
            tols = ({"repeatability": 0.03, "localization_error": 0.05,
                     "mscore": 0.02} if "--bf16" in flag else {})
            for d in ("cuda", "cpu"):
                out = os.path.join(tmp, f"r{flag.replace(' ', '')}{d}.json")
                t0 = time.perf_counter()
                eval_multitask.main(
                    ["--config", "S", "--n_classes", "8", "--model_path",
                     os.path.join(repo, "pinned", "extractor_S8.npz"),
                     "--im_h", "120", "--im_w", "160", "--keypoints",
                     "--max_items", "2", "--top_k", "300",
                     "--calib_batches", "4", "--dataset_config", ds_cfg,
                     "--device", d, "--out", out] + flag.split())
                with open(out) as f:
                    res[flag + " " + d] = json.load(f)["keypoints_top300"]
                log(f"int8: eval_multitask {flag} on {d} in "
                    f"{time.perf_counter() - t0:.1f} s")
            card, cpu = res[flag + " cuda"], res[flag + " cpu"]
            require("error" not in card, f"int8 eval {flag}: {card}")
            for k in ("repeatability", "localization_error", "mscore"):
                require(abs(card[k] - cpu[k]) <= tols.get(k, tol),
                        f"int8 eval {flag}: {k} card {card[k]} cpu {cpu[k]}")
    log("int8: eval_multitask keypoints " + json.dumps(res))


def int8_exports(repo: str) -> None:
    """export_model --format pt2 / int8 / mcu (--to_mcu, --device cuda
    calibration) and export_onnx on this machine's torch; the pt2 program
    against make_export_fn on the CPU."""
    import tempfile

    import torch

    from nanovs_slam_torch import export, export_model, export_onnx

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "m")
        common = ["--config", "S", "--n_classes", "8", "--model_path",
                  os.path.join(repo, "pinned", "extractor_S8.npz")]
        paths = [export_model.main(common + ["--format", f, "--out", out])
                 for f in ("pt2", "int8")]
        paths.append(export_model.main(
            ["--config", "S", "--n_classes", "8", "--to_mcu", "--format",
             "mcu", "--out", out]))
        paths.append(export_onnx.main(["--model_path", tmp]))
        sizes = {os.path.basename(p): os.path.getsize(p) for p in paths}
        require(all(n > 0 for n in sizes.values()), f"exports {sizes}")
        model, cfg = int8_pinned(repo, "cpu")
        x = torch.from_numpy(np.random.RandomState(SEED + 2100).uniform(
            -1, 1, (1, H, W, 3)).astype(np.float32))
        with torch.no_grad():
            got = export.load_program(paths[0]).module()(x)
        want = export.make_export_fn(model, cfg, H, W)(x)
        err = max_err(got, want)
        require(err <= 1e-5, f"exports: the pt2 program against "
                f"make_export_fn {err}")
    log(f"int8: exports {json.dumps(sizes)} (torch {torch.__version__}); "
        f"the pt2 program against make_export_fn {err:.3g}")


def int8_phase(dev, repo: str, kernels: dict) -> dict:
    """Phase 17: int8 serving (the int8 kernel against its twin at every
    call of the S8 request, the request itself), the MCU bundle, QAT and
    to_mcu training, the eval CLI's int8 flags and the exports."""
    t_phase = time.perf_counter()
    for key, name, src in ((INT8, INT8, "int8conv.cu"),
                           (INT8_BF16, "int8_conv3x3[bf16]",
                            "int8conv_bf16.cu")):
        kernels[key] = {"name": name, "route": "cuda",
                        "source": f"nanovs_slam_torch/csrc/{src}",
                        "replaces": INT8_REPLACES}
    launches, infer_i8, requests = int8_serving(dev, repo, kernels)
    t0 = time.perf_counter()
    paths = {"int8": launches,
             "int8_bf16": int8_bf16_s8(dev, repo, kernels, infer_i8,
                                       requests),
             "int8_n28_bf16": int8_bf16_n28(dev, kernels)}
    log(f"int8: the bf16 models in {time.perf_counter() - t0:.1f} s")
    int8_bundle(dev)
    int8_train()
    int8_eval_cli(repo)
    int8_exports(repo)
    log(f"int8: phase {time.perf_counter() - t_phase:.1f} s")
    return paths


# ------------------------------------------------------------ parallel phase

PARALLEL_RANKS = 2  # two ranks sharing the one card over gloo
# the dp steps' later loss terms and final model BN statistics: the first
# step moves weights whose gradient is near 0 by up to lr either way, and
# the gated IO term's inputs are argmin associations (ROADMAP Queue 3)
DP_LATER_GAP = 1e-2
DP_LR = 5e-4  # the dp job's Adam learning rate


def parallel_jobs(cor: Corridor) -> list:
    """The parallel phase's jobs (``nanovs_slam_torch.dryrun.JOBS``) at
    the slice's widths: 3 dp steps of config S (28 classes, 120x160,
    global batch 4, Adam 5e-4 cosine, dropout on, top_k 300) on the train
    phase's batch; pinned S8's offline VO over the corridor's 8 frames at
    128x512 (BF and LightGlue, k = 1024, 8192 hypotheses x 3 restarts);
    pinned S8's fan-out of 16 frames at 240x320 in batches of 8; LightGlue
    S (pinned) and "default" (seeded) at K = 512, head parallel."""
    import torch

    from nanovs_slam_torch.vo.visual_odometry import prep_frame

    h, w = TRAIN_HW
    batch = {k: v.numpy() for k, v in train_batch(SEED).items()}
    stack = torch.stack([prep_frame(f, VO_SIZE) for f in cor.frames])
    vo = dict(frames=stack.cpu().numpy(), k=1024, n_hypotheses=8192,
              restarts=3, cam=KITTI_HW[::-1], extract_chunk=OFFLINE_BATCH)
    return [
        ("dp", "dp_steps", dict(config="S", n_classes=28, H=h, W=w, steps=3,
                                lr=DP_LR, cosine=(16, 20), batch=batch,
                                grads=True, timing=True)),
        ("vo_bf", "sharded_vo", dict(vo, matcher="bf")),
        ("vo_lg", "sharded_vo", dict(vo, matcher="lightglue")),
        ("fanout", "fanout", dict(pinned=True, H=H, W=W, n_items=16,
                                  batch_size=8)),
        ("tp_s", "tp_lightglue", dict(lg="pinned", K=512)),
        ("tp_default", "tp_lightglue", dict(lg="default", K=512)),
    ]


def check_dp(name: str, got: dict, want: dict) -> dict:
    """A data-parallel run against the single-process steps on the card.
    The first step: its loss terms within 1e-4 of max(1, |term|) and
    grad_norm within 1e-4 relative, its raw gradients within 5e-2 in
    relative L2 (compare_train_steps's bounds); the state after it: the
    BN statistics within 1e-5 of max(1, |value|) (the model's and the
    inlier net's, as compare_train_steps holds BN buffers), the
    parameters within 1e-5 where the single-process gradient is at least
    1e-6 but for 1% of a tensor's such weights
    (``dryrun.adam_step_offenders``). Later steps: their terms and the
    final state's model BN statistics within DP_LATER_GAP (the first Adam
    step sends a weight whose gradient is near 0 either way by lr, and the
    steps after it drift from there), the parameters within 2 lr a
    step."""
    from nanovs_slam_torch.dryrun import (adam_step_offenders,
                                          compare_states, compare_steps,
                                          grad_rel_l2)

    gaps, norms = compare_steps(got["metrics"], want["metrics"])
    g_rel = grad_rel_l2(got["first"]["grads"], want["first"]["grads"])
    first = compare_states(got["first"]["state"], want["first"]["state"])
    off = adam_step_offenders(got["first"]["state"], want["first"]["state"],
                              want["first"]["grads"])
    st = compare_states(got["state"], want["state"])
    res = {"loss_gaps": gaps, "grad_norm_gaps": norms, "grad_rel_l2": g_rel,
           "first_state": first, "first_offenders": off, "state": st}
    log(f"parallel {name}: against the single-process steps "
        f"{json.dumps(res)}")
    require(gaps[0] <= 1e-4 and norms[0] <= 1e-4,
            f"parallel {name}: the first step {gaps[0]}, {norms[0]} apart")
    require(g_rel <= 5e-2, f"parallel {name}: gradients {g_rel} apart")
    require(first["model_bn"] <= 1e-5 and first["io_bn"] <= 1e-5 and not off,
            f"parallel {name}: the states after the first step apart")
    require(max(gaps) <= DP_LATER_GAP,
            f"parallel {name}: later steps {gaps} apart")
    require(st["params"] <= 2 * DP_LR * len(gaps)
            and st["model_bn"] <= DP_LATER_GAP,
            f"parallel {name}: final states {st} apart")
    require(all(math.isfinite(m["total_loss"]) for m in got["metrics"]),
            f"parallel {name}: a non-finite loss")
    return res


def nccl_dp_step(dev, job: tuple) -> dict:
    """The dp job's first step at world size 1 over NCCL, in this
    process: the group made and destroyed around it."""
    import torch.distributed as dist

    from nanovs_slam_torch.dryrun import run_jobs
    from nanovs_slam_torch.parallel.distributed import free_port, initialize
    from nanovs_slam_torch.parallel.mesh import make_mesh

    name, kind, spec = job
    initialize(f"127.0.0.1:{free_port()}", 1, 0, backend="nccl",
               device=dev, timeout=120)
    try:
        return run_jobs(make_mesh(device=dev), [(name, kind, dict(
            spec, steps=1))])[name]
    finally:
        dist.destroy_process_group()


def parallel_trainer_clis(repo: str, card: str) -> None:
    """``train_multitask --num_devices 2`` on the card (the synthetic set,
    config S), two runs at once: 3 steps through the host loader, and 2
    epochs of 3 steps through the card-resident one (``--device_cache``:
    the state and the cache replicated once, each epoch's indices split).
    Each run's first line says the ranks share the card over gloo; finite
    losses; a checkpoint."""
    import tempfile

    runs = {"host loader": ([], 1), "device cache": (["--device_cache"], 2)}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        procs = {}
        for tag, (flags, epochs) in runs.items():
            out = os.path.join(tmp, tag.replace(" ", "_"))
            os.makedirs(out)
            procs[tag] = subprocess.Popen(
                [sys.executable, "-m", "nanovs_slam_torch.train_multitask",
                 "--num_devices", str(PARALLEL_RANKS), "--dataset_name",
                 "synthetic", "--no_eval", "--batch_size", "4",
                 "--synthetic_items", "12", "--max_steps_per_epoch", "3",
                 "--n_epochs", str(epochs), "--log_every", "1",
                 "--dist_timeout", "120", "--out_model_path",
                 os.path.join(out, "ck")] + flags,
                cwd=out, env={**os.environ,
                              "PYTHONPATH": os.path.abspath(repo)},
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            done = {tag: p.communicate(timeout=300)
                    for tag, p in procs.items()}
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
        secs = time.perf_counter() - t0
        for tag, (stdout, stderr) in done.items():
            name = f"parallel trainer CLI ({tag})"
            code = procs[tag].returncode
            require(code == 0, f"{name}: exit {code}\n{stdout[-2000:]}\n"
                    f"{stderr[-3000:]}")
            out = stdout.splitlines()
            steps = [x for x in out if x.startswith("E") and " it" in x]
            log(f"{name}: {out[0]!r}; {steps} [{card}]")
            require(out[0].startswith(f"data parallel: {PARALLEL_RANKS} "
                                      f"ranks") and "over gloo on cuda" in
                    out[0] and "share" in out[0],
                    f"{name}: first line {out[0]!r}")
            require(len(steps) == 3 * runs[tag][1] and all(
                math.isfinite(float(x.split()[3])) for x in steps),
                f"{name}: steps {steps}")
            require(os.path.exists(os.path.join(
                tmp, tag.replace(" ", "_"), "ck.npz")),
                f"{name}: no checkpoint")
        log(f"parallel trainer CLI: both runs at once in {secs:.1f} s "
            f"[{card}]")


def parallel_phase(dev, repo: str, cor: Corridor) -> dict:
    """Phase 18: the parallel layer on the card. Two ranks share it over
    gloo (NCCL refuses two ranks on one card) and run ``parallel_jobs``;
    this process runs the same jobs on one device as the reference: the
    dp steps (check_dp, every rank's metrics and state alike), the sharded
    VO against ``relative_poses`` (match and inlier counts equal, poses
    within 1e-4), the fan-out against the plain infer (float outputs
    within 1e-4, segmentation ids equal on 99.9%), TP LightGlue against
    the module's kernel forward (the last layer's descriptors within 1e-4,
    as the kernel to its twin; the log assignment within 1e-4 of max(1,
    |value|): its terms reach tens, and the kernel's 3xTF32 against the
    blocks' float32 moved it by 2.0e-4 absolute; matches equal on 99.9%).
    Then the dp step at world size 1 over NCCL, and the trainer
    CLI with two ranks (the host loader and, at the same time, the
    card-resident one over two epochs). Prints the ms a step per rank and the gradient
    all-reduce's share, the ms a sequence and a pair, a fan-out batch and
    a TP forward, beside the card. Returns the ranks' launch counts (both
    ranks, every job, the NCCL step too) as the ``parallel`` path."""
    from nanovs_slam_torch.dryrun import (compare_outputs, compare_vo,
                                          run_jobs)
    from nanovs_slam_torch.parallel.distributed import (same_on_every_rank,
                                                        spawn)

    t_phase = time.perf_counter()
    card = card_line()
    jobs = parallel_jobs(cor)
    t0 = time.perf_counter()
    ranks = spawn(run_jobs, PARALLEL_RANKS, (jobs,), device=dev,
                  backend="gloo", timeout=120, deadline=400)
    log(f"parallel: {PARALLEL_RANKS} ranks over gloo sharing the card, "
        f"their jobs in {time.perf_counter() - t0:.1f} s")
    got = same_on_every_rank(ranks)
    want = run_jobs(None, jobs, dev)
    launches = {}
    for r in ranks:
        for job in r.values():
            for k, n in job["launches"].items():
                launches[k] = launches.get(k, 0) + n

    check_dp("dp", got["dp"], want["dp"])
    for i, r in enumerate(ranks):
        step, red = r["dp"]["step_ms"], r["dp"]["reduce_ms"]
        log(f"parallel dp: rank {i} ms a step {[round(x, 3) for x in step]},"
            f" the gradient all-reduce {[round(x, 3) for x in red]} "
            f"(share {sum(red[1:]) / sum(step[1:]):.3f} after the first) "
            f"[{card}]")
    log(f"parallel dp: one process ms a step "
        f"{[round(x, 3) for x in want['dp']['step_ms']]} [{card}]")
    for tag in ("vo_bf", "vo_lg"):
        c = compare_vo(got[tag], want[tag])
        pairs = len(want[tag]["n_matches"])
        log(f"parallel {tag}: sharded against relative_poses {json.dumps(c)}"
            f"; matches {got[tag]['n_matches'].tolist()}; ms a sequence "
            f"{ranks[0][tag]['ms']:.1f} and {ranks[1][tag]['ms']:.1f} "
            f"(ranks), {want[tag]['ms']:.1f} (one process), ms a pair "
            f"{ranks[0][tag]['ms'] / pairs:.2f} [{card}]")
        require(c["matches_equal"] and c["inliers_equal"]
                and c["R"] <= 1e-4 and c["t"] <= 1e-4,
                f"parallel {tag}: {c}")
    gf, wf = got["fanout"]["out"], want["fanout"]["out"]
    floats = {k: v for k, v in wf.items() if v.dtype.kind == "f"}
    gap = compare_outputs({k: gf[k] for k in floats}, floats)
    seg = float((gf["seg"] == wf["seg"]).mean())
    log(f"parallel fanout: {len(wf['score'])} frames, floats {gap:.3g} "
        f"apart, seg ids equal on {seg:.5f}; ms a batch of 8 "
        f"{ranks[0]['fanout']['ms']:.2f} (ranks), "
        f"{want['fanout']['ms']:.2f} (one process) [{card}]")
    require(gap <= 1e-4 and seg >= 0.999, "parallel fanout: outputs apart")
    for tag in ("tp_s", "tp_default"):
        g, wt = got[tag], want[tag]
        desc = max(float(np.abs(g[k] - wt[k]).max())
                   for k in ("descriptors0", "descriptors1"))
        la = float((np.abs(g["log_assignment"] - wt["log_assignment"])
                    / np.maximum(1.0, np.abs(wt["log_assignment"]))).max())
        same = float((g["matches0"] == wt["matches0"]).mean())
        log(f"parallel {tag}: against the kernel forward, descriptors "
            f"{desc:.3g} apart, log assignment {la:.3g} (relative), "
            f"matches equal on {same:.4f}; ms a forward "
            f"{ranks[0][tag]['ms']:.2f} (2 ranks, plain blocks), "
            f"{wt['ms']:.2f} (the kernel) [{card}]")
        require(desc <= 1e-4 and la <= 1e-4 and same >= 0.999,
                f"parallel {tag}: apart")

    nccl = nccl_dp_step(dev, jobs[0])
    gaps = {k: abs(nccl["metrics"][0][k] - want["dp"]["metrics"][0][k])
            for k in want["dp"]["metrics"][0]}
    log(f"parallel dp over NCCL at world size 1: first step against one "
        f"process {json.dumps(gaps)}; ms {nccl['step_ms'][0]:.3f} (the "
        f"first step of a new group) [{card}]")
    require(all(v <= 1e-4 * max(1.0, abs(want["dp"]["metrics"][0][k]))
                for k, v in gaps.items()), "parallel NCCL step: apart")
    for k, n in nccl["launches"].items():
        launches[k] = launches.get(k, 0) + n
    parallel_trainer_clis(repo, card)

    path = {k: launches[k] for k in ("fused_stem_pair_pool",
                                     "fused_postprocess", "netvlad",
                                     "netvlad_backward",
                                     "lightglue_transformer")}
    log(f"parallel: launches on the ranks {json.dumps(path)}")
    require(all(n > 0 for n in path.values()),
            f"parallel: a kernel of the path never launched {path}")
    log(f"parallel: phase {time.perf_counter() - t_phase:.1f} s")
    return {"parallel": path}


# ------------------------------------------------------------- spatial phase

SPATIAL_RANKS = 4  # ranks sharing the card; the 2-rank request uses two


def spatial_jobs() -> list:
    """The spatial phase's jobs (``nanovs_slam_torch.dryrun.JOBS``):
    pinned S8's 240x320 request at batch 1 (a synthetic-shapes frame,
    five timed calls after one) with its height over 2 and over 4 ranks;
    2 steps of config S (28 classes, 120x160, global batch 4, Adam 5e-4,
    dropout on) on a (2, 2) ("data", "model") mesh."""
    from nanovs_slam_torch.dryrun import shifted_frames

    req = dict(pinned=True, frames=shifted_frames(1, H, W), request=True,
               repeats=5)
    h, w = TRAIN_HW
    batch = {k: v.numpy() for k, v in train_batch(SEED).items()}
    kf = dict(keypoint_former=True, config="default", n_classes=KF_CLASSES)
    kf_req = dict(kf, frames=shifted_frames(1, *KF_HW), request=True,
                  repeats=5)
    kh, kw = KF_TRAIN_HW
    return [("sp2", "sp_forward", dict(req, ranks=2)),
            ("sp4", "sp_forward", dict(req, ranks=4)),
            ("sp_train", "dp_steps", dict(
                config="S", n_classes=28, H=h, W=w, steps=2, lr=DP_LR,
                batch=batch, grads=True, timing=True, spatial=True)),
            ("kf_sp2", "sp_forward", dict(kf_req, ranks=2)),
            ("kf_sp4", "sp_forward", dict(kf_req, ranks=4)),
            ("kf_sp_train", "dp_steps", dict(
                kf, H=kh, W=kw, steps=2, lr=DP_LR,
                batch={k: np.asarray(v) for k, v in kf_train_batch(
                    SEED).items()}, grads=True, timing=True,
                spatial=True))]

# the spatial phase's jobs that have no single-process run of their own
SPATIAL_ONLY = ("sp4", "kf_sp4")


def spatial_clis(repo: str, card: str) -> None:
    """At once: ``eval_multitask --keypoints`` (120x160, a synthetic
    HPatches sequence, 2 pairs, top_k 300) of pinned S8 from a
    reference-named ``.ckpt`` that ``utils/torch_export`` writes and from
    the ``.npz``, whose results must agree within 1e-6; and ``python -m
    nanovs_slam_torch.demo`` (pinned S8, 240x320) on 4 synthetic frames,
    which must write 4 frames of keypoints over classes."""
    import tempfile

    import cv2
    import torch

    from nanovs_slam_torch.configs import get_config
    from nanovs_slam_torch.dryrun import shifted_frames
    from nanovs_slam_torch.models.kp2dtiny import build_model
    from nanovs_slam_torch.utils.torch_export import save_torch_checkpoint
    from nanovs_slam_torch.utils.torch_import import (load_model_weights,
                                                      read_torch_checkpoint)

    repo = os.path.abspath(repo)
    pinned = os.path.join(repo, "pinned", "extractor_S8.npz")
    with tempfile.TemporaryDirectory() as tmp:
        hp = os.path.join(tmp, "hpatches")
        r = subprocess.run([sys.executable, os.path.join(
            repo, "scripts", "make_synthetic_hpatches.py"), hp, "--n-seq",
            "1"], capture_output=True, text=True, timeout=300)
        require(r.returncode == 0, f"spatial CLIs: the HPatches fixture "
                f"needs cv2: {r.stderr[-400:]}")
        ds_cfg = os.path.join(tmp, "datasets.json")
        with open(ds_cfg, "w") as f:
            json.dump({"hpatches_data_path": hp}, f)
        model = load_model_weights(build_model(get_config("S", n_classes=8)),
                                   pinned)
        ckpt = save_torch_checkpoint(os.path.join(tmp, "s8.ckpt"), model,
                                     {"config": "S", "n_classes": 8})
        names = sorted(read_torch_checkpoint(ckpt)[0])
        log(f"ckpt: {len(names)} reference-named entries, e.g. "
            f"{[n for n in names if 'conf' in n or 'convs.' in n][:3]}")
        frames = os.path.join(tmp, "frames")
        os.makedirs(frames)
        for i, f in enumerate(shifted_frames(4, H, W)):
            cv2.imwrite(os.path.join(frames, f"{i:02d}.png"),
                        (f[..., ::-1] * 255).astype(np.uint8))
        env = {**os.environ, "PYTHONPATH": repo}
        evals = ["--config", "S", "--n_classes", "8", "--im_h", "120",
                 "--im_w", "160", "--keypoints", "--max_items", "2",
                 "--top_k", "300", "--dataset_config", ds_cfg]
        cmds = {tag: [sys.executable, "-m",
                      "nanovs_slam_torch.eval_multitask", "--model_path",
                      path, "--out", os.path.join(tmp, f"{tag}.json")]
                + evals for tag, path in (("ckpt", ckpt), ("npz", pinned))}
        cmds["demo"] = [sys.executable, "-m", "nanovs_slam_torch.demo",
                        "--input", frames, "--config", "S", "--n_classes",
                        "8", "--model_path", pinned, "--out_dir",
                        os.path.join(tmp, "demo"), "--max_frames", "4"]
        t0 = time.perf_counter()
        procs = {tag: subprocess.Popen(cmd, cwd=tmp, env=env,
                                       stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True)
                 for tag, cmd in cmds.items()}
        try:
            done = {tag: p.communicate(timeout=300)
                    for tag, p in procs.items()}
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for tag, (out, err) in done.items():
            require(procs[tag].returncode == 0, f"spatial CLI {tag}: exit "
                    f"{procs[tag].returncode}\n{out[-2000:]}\n{err[-3000:]}")
        res = {}
        for tag in ("ckpt", "npz"):
            with open(os.path.join(tmp, f"{tag}.json")) as f:
                res[tag] = json.load(f)["keypoints_top300"]
        gap = max(abs(res["ckpt"][k] - v) for k, v in res["npz"].items()
                  if isinstance(v, float))
        log(f"ckpt: eval_multitask on the .ckpt {json.dumps(res['ckpt'])}; "
            f"the .npz's {gap:.3g} apart")
        require("error" not in res["npz"] and gap <= 1e-6
                and res["ckpt"].keys() == res["npz"].keys(),
                "ckpt: its evaluation is not the .npz's")
        shots = sorted(os.listdir(os.path.join(tmp, "demo")))
        img = cv2.imread(os.path.join(tmp, "demo", shots[-1]))
        kps = [ln for ln in done["demo"][0].splitlines() if "keypoints" in ln]
        log(f"demo: {shots}, {img.shape}, {kps}")
        require(len(shots) == 4 and img.shape == (2 * H, W, 3)
                and all(int(ln.split()[-2]) > 0 for ln in kps),
                "demo: frames not written")
        log(f"spatial CLIs: the three runs at once in "
            f"{time.perf_counter() - t0:.1f} s [{card}]")
    torch.cuda.synchronize()


def lightglue_bf16_pair(dev, repo: str, card: str) -> None:
    """Pinned LightGlue S at bf16 on one pair of K = 512 keypoints (a
    seeded pair, the last 4 and 6 masked): the card's log assignment (of
    the valid keypoints and the dustbins) and last-layer descriptors no
    further from the card's float32 kernel
    forward than 1.5x the CPU bf16 forward's distance from the CPU float32
    forward, plus one bf16 ulp of the largest value (the CPU test's
    criterion with the CPU's bf16 in the JAX bf16's place), and within as
    much of the CPU bf16 forward; the LightGlue kernel not launched at
    bf16 (the blocks run: a choice by dtype); ms a forward at bf16 and
    float32."""
    import dataclasses

    import torch

    from nanovs_slam_torch.dryrun import lightglue_data
    from nanovs_slam_torch.kernels import lightglue_transformer
    from nanovs_slam_torch.matching.lightglue import LightGlue

    lg32 = pinned_lightglue(repo)
    lg16 = LightGlue(dataclasses.replace(lg32.cfg, dtype="bfloat16"))
    lg16.load_state_dict(lg32.state_dict())
    data = lightglue_data(32, 512, SEED + 9)
    keys = ("log_assignment", "ref_descriptors0", "ref_descriptors1")
    # the log assignment's entries of valid keypoints and the dustbins (a
    # masked keypoint's sit near -1e9)
    rows, cols = (np.append(data[k][0].numpy(), True)
                  for k in ("mask0", "mask1"))
    out = {}
    with torch.inference_mode():
        for tag, m, d in (("cpu32", lg32, "cpu"), ("cpu16", lg16, "cpu"),
                          ("card32", lg32, dev), ("card16", lg16, dev)):
            m.to(d).eval()
            x = {k: v.to(d) for k, v in data.items()}
            before = lightglue_transformer.launches
            pred = m(x)
            out[tag] = {k: pred[k].float().cpu().numpy() for k in keys}
            out[tag]["log_assignment"] = \
                out[tag]["log_assignment"][:, rows][:, :, cols]
            out[tag + "_launches"] = lightglue_transformer.launches - before
            if d != "cpu":
                out[tag + "_ms"] = statistics.median(host_ms(
                    lambda i: m(x), 10))
    lg32.to("cpu")
    res = {}
    for k in keys:
        ulp = 2.0 ** (float(np.floor(np.log2(np.abs(
            out["cpu32"][k]).max()))) - 7)
        lim = 1.5 * float(np.abs(out["cpu16"][k] - out["cpu32"][k]).max()) \
            + ulp
        res[k] = {"vs_card32": float(np.abs(out["card16"][k]
                                            - out["card32"][k]).max()),
                  "vs_cpu16": float(np.abs(out["card16"][k]
                                           - out["cpu16"][k]).max()),
                  "limit": lim}
    log(f"lightglue bf16: pinned S, K=512 {json.dumps(res)}; kernel "
        f"launches bf16 {out['card16_launches']}, float32 "
        f"{out['card32_launches']}; ms a forward bf16 "
        f"{out['card16_ms']:.3f}, float32 {out['card32_ms']:.3f} [{card}]")
    require(all(r["vs_card32"] <= r["limit"] and r["vs_cpu16"] <= r["limit"]
                for r in res.values()), "lightglue bf16: apart")
    require(out["card16_launches"] == 0 and out["card32_launches"] == 1,
            "lightglue bf16: the kernel's launches")


def spatial_phase(dev, repo: str) -> dict:
    """Phase 17c (see the module doc). Returns the ranks' launch counts
    (every rank, every job) as the ``spatial`` path."""
    from nanovs_slam_torch.dryrun import compare_outputs, run_jobs
    from nanovs_slam_torch.parallel.distributed import (same_on_every_rank,
                                                        spawn)

    t_phase = time.perf_counter()
    card = card_line()
    jobs = spatial_jobs()
    t0 = time.perf_counter()
    ranks = spawn(run_jobs, SPATIAL_RANKS, (jobs,), device=dev,
                  backend="gloo", timeout=120, deadline=400)
    log(f"spatial: {SPATIAL_RANKS} ranks over gloo sharing the card, their "
        f"jobs in {time.perf_counter() - t0:.1f} s")
    want = run_jobs(None, [(n, k, s) for n, k, s in jobs
                           if n not in SPATIAL_ONLY], dev)
    kf_jobs = ("kf_sp2", "kf_sp4", "kf_sp_train")
    launches, kf_launches = {}, []
    for r in ranks:
        kf_rank = {}
        for name, job in r.items():
            total = kf_rank if name in kf_jobs else launches
            for k, n in job["launches"].items():
                total[k] = total.get(k, 0) + n
        kf_launches.append(kf_rank)
    for tag, n, ref, what in (("sp2", 2, "sp2", "pinned S8 240x320"),
                              ("sp4", 4, "sp2", "pinned S8 240x320"),
                              ("kf_sp2", 2, "kf_sp2", "KeypointFormer "
                               "default 256x320"),
                              ("kf_sp4", 4, "kf_sp2", "KeypointFormer "
                               "default 256x320")):
        wf = want[ref]["out"]
        got = [r[tag]["out"] for r in ranks[:n]]
        same_on_every_rank(got)
        g = got[0]
        floats = {k: v for k, v in wf.items() if v.dtype.kind == "f"}
        gap = compare_outputs({k: g[k] for k in floats}, floats)
        seg = float((g["seg"] == wf["seg"]).mean())
        log(f"spatial {tag}: {what} over {n} ranks against one "
            f"process, floats {gap:.3g} apart ({sorted(floats)}), seg ids "
            f"equal on {seg:.5f}; ms a request "
            f"{[round(r[tag]['ms'], 3) for r in ranks[:n]]} (ranks), "
            f"{want[ref]['ms']:.3f} (one process) [{card}]")
        require(gap <= 1e-4 and seg >= 0.999, f"spatial {tag}: apart")
    for tag, what in (("sp_train", "spatial train"),
                      ("kf_sp_train", "spatial kf train")):
        check_dp(tag, same_on_every_rank([r[tag] for r in ranks]), want[tag])
        for i, r in enumerate(ranks):
            step, red = r[tag]["step_ms"], r[tag]["reduce_ms"]
            log(f"{what}: rank {i} ms a step "
                f"{[round(x, 3) for x in step]}, the gradient all-reduce "
                f"{[round(x, 3) for x in red]} [{card}]")
        log(f"{what}: one process ms a step "
            f"{[round(x, 3) for x in want[tag]['step_ms']]} [{card}]")
    path = {k: launches[k] for k in ("fused_stem_pair_pool",
                                     "fused_postprocess", "netvlad",
                                     "netvlad_backward")}
    log(f"spatial: launches on the ranks {json.dumps(path)}")
    require(all(n > 0 for n in path.values()),
            f"spatial: a kernel of the path never launched {path}")
    kf_keys = ("fused_postprocess", "netvlad", "netvlad_backward")
    log(f"spatial kf: launches by rank {json.dumps(kf_launches)}")
    require(all(r.get(k, 0) > 0 for r in kf_launches for k in kf_keys),
            "spatial kf: a kernel of the path never launched on a rank")
    kf_path = {k: sum(r.get(k, 0) for r in kf_launches) for k in kf_keys}
    spatial_clis(repo, card)
    lightglue_bf16_pair(dev, repo, card)
    log(f"spatial: phase {time.perf_counter() - t_phase:.1f} s")
    return {"spatial": path, "kf_spatial": kf_path}


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
    for phase, args in ((vo_phase, (dev, repo, cor)), (family_phase, (dev,)),
                        (vo_dense_phase, (dev, cor)),
                        (vo_offline_phase, (dev, repo, cor)),
                        (vo_offline_batched_phase, (dev, repo, cor)),
                        (lightglue_depth_width_phase, (dev, repo)),
                        (train_phase, (dev, repo)),
                        (train_cache_phase, (dev,)),
                        (visloc_phase, (dev, repo)),
                        (eval_phase, (dev, repo)),
                        (keypoint_former_phase, (dev, repo)),
                        (lightglue_train_phase, (dev, repo)),
                        (int8_phase, (dev, repo, kernels)),
                        (parallel_phase, (dev, repo, cor)),
                        (spatial_phase, (dev, repo))):
        t_phase = time.perf_counter()
        paths.update(phase(*args))
        log(f"{phase.__name__}: {time.perf_counter() - t_phase:.1f} s, "
            f"{time.perf_counter() - t0:.1f} s since the build began")

    lines = []
    for key, entry in kernels.items():
        # `launches` is the count of the first path that launches the
        # kernel, whose shapes its unsuffixed keys carry; another path's
        # count goes under `launches_<path>`, beside that path's `_<path>`
        # keys
        counted = [p for p in paths if key in paths[p]]
        first = next((p for p in counted if paths[p][key]), counted[0])
        entry["path"] = first
        entry["launches"] = paths[first][key]
        entry.update({f"launches_{p}": paths[p][key] for p in counted
                      if p != first})
        lines.append(entry)
    require(all(k.__name__ in kernels for k in KERNELS)
            and all(k in kernels for k in (STEM_BF16, PP_BF16, NV_BF16,
                                           NVB_BF16, INT8_BF16)),
            "a kernel of KERNELS, or a bfloat16 instance, has no line")
    print(f"{card}")
    print(json.dumps({"kernels": lines}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
