"""The learned-matcher path for one pair of frames: extract keypoints on
both, normalise them and match them with LightGlue.

The port's counterpart of the inline pipeline of ``bench_latency.py``
(``kp_extract_plus_lightglue_match_latency``) and of the step that the JAX
VO loop runs with ``matcher="lightglue"``. On a CUDA device it runs the
stem and postprocess kernels (twice, once per frame) and the LightGlue
transformer kernel (once).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn as nn

from ..configs import KP2DTinyConfig
from ..utils.device import resolve_device
from .extractor import make_extractor
from .lightglue import LightGlue, normalize_keypoints

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
    model input in [-1, 1]."""
    dev = resolve_device(device)
    extract = make_extractor(extractor, cfg, H, W, max_keypoints,
                             conf_threshold, dev)
    matcher.to(dev).eval()

    @torch.inference_mode()
    def match(img0, img1) -> Dict[str, Tensor]:
        e0, e1 = extract(img0), extract(img1)
        pred = matcher({
            "keypoints0": normalize_keypoints(e0["keypoints"], (W, H)),
            "keypoints1": normalize_keypoints(e1["keypoints"], (W, H)),
            "descriptors0": e0["descriptors"],
            "descriptors1": e1["descriptors"],
            "mask0": e0["mask"], "mask1": e1["mask"]})
        out = {k: pred[k] for k in ("matches0", "matches1",
                                    "matching_scores0", "matching_scores1")}
        out.update(keypoints0=e0["keypoints"], keypoints1=e1["keypoints"],
                   mask0=e0["mask"], mask1=e1["mask"])
        return out

    return match
