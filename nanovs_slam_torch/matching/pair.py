"""The learned-matcher path for one pair of frames: extract keypoints on
both, normalise them and match them with LightGlue.

The port's counterpart of the inline pipeline of ``bench_latency.py``
(``kp_extract_plus_lightglue_match_latency``) and of the step that the JAX
VO loop runs with ``matcher="lightglue"``. On a CUDA device it runs the
stem and postprocess kernels (twice, once per frame) and the LightGlue
transformer kernel (once for all layers; once a layer where the config
sets ``depth_confidence`` or ``width_confidence``).
"""

from __future__ import annotations

import functools
from typing import Callable, Dict

import torch
import torch.nn as nn

from ..configs import KP2DTinyConfig
from ..utils.device import resolve_device
from .adaptive import AdaptiveLightGlue
from .extractor import make_extractor
from .lightglue import LightGlue, inference_forward, normalize_keypoints

Tensor = torch.Tensor


def make_pair_matcher(extractor: nn.Module, cfg: KP2DTinyConfig,
                      matcher: LightGlue, H: int, W: int,
                      max_keypoints: int = 512, conf_threshold: float = 0.0,
                      device=None) -> Callable[..., Dict[str, Tensor]]:
    """Returns ``match(img0, img1) -> {keypoints0/1 (B,K,2), mask0/1 (B,K),
    matches0/1 (B,K) (-1: none), matching_scores0/1 (B,K)}`` on ``device``
    (default "cuda"; a CUDA device without a card raises).

    ``extractor`` is a KP2DTiny model of config ``cfg``; ``matcher`` a
    LightGlue whose input width is the extractor's descriptor width. Both
    are moved to the device and put in eval mode. img0/img1: (B, H, W, 3)
    model input in [-1, 1].

    The matcher's config picks its runner: ``width_confidence > 0``
    prunes the width (``inference_forward``), else ``depth_confidence >
    0`` exits early, host-staged (``AdaptiveLightGlue``; the result gains
    "exit_layer"), else all layers run in one call."""
    dev = resolve_device(device)
    extract = make_extractor(extractor, cfg, H, W, max_keypoints,
                             conf_threshold, dev)
    matcher.to(dev).eval()
    if matcher.cfg.width_confidence > 0:
        run = functools.partial(inference_forward, matcher)
    elif matcher.cfg.depth_confidence > 0:
        run = AdaptiveLightGlue(matcher, matcher.cfg.depth_confidence)
    else:
        run = matcher

    @torch.inference_mode()
    def match(img0, img1) -> Dict[str, Tensor]:
        e0, e1 = extract(img0), extract(img1)
        pred = run({
            "keypoints0": normalize_keypoints(e0["keypoints"], (W, H)),
            "keypoints1": normalize_keypoints(e1["keypoints"], (W, H)),
            "descriptors0": e0["descriptors"],
            "descriptors1": e1["descriptors"],
            "mask0": e0["mask"], "mask1": e1["mask"]})
        out = {k: pred[k] for k in ("matches0", "matches1",
                                    "matching_scores0", "matching_scores1",
                                    "exit_layer") if k in pred}
        out.update(keypoints0=e0["keypoints"], keypoints1=e1["keypoints"],
                   mask0=e0["mask"], mask1=e1["mask"])
        return out

    return match
