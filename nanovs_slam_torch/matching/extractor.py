"""KP2DTiny as a keypoint extractor for LightGlue, and the homography
ground truth; the counterpart of ``nanovs_slam_tpu/matching/extractor.py``
(reference: gluefactory/models/extractors/kp2dtiny.py, top-k selection
:38-42 and threshold masking :43-52).

Only the keypoint heads run: the stem kernel in the backbone and the fused
postprocess kernel on a CUDA device, then the fixed-K top-k.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..configs import KP2DTinyConfig
from ..inference import forward_post_process
from ..ops.postprocess import top_k_keypoints
from ..utils.device import resolve_device

Tensor = torch.Tensor
KEYPOINT_HEADS = ("score", "loc", "desc")


def make_extractor(model: nn.Module, cfg: KP2DTinyConfig, H: int, W: int,
                   max_keypoints: int = 512, conf_threshold: float = 0.0,
                   device=None) -> Callable[[Tensor], Dict[str, Tensor]]:
    """Returns ``extract(images) -> {keypoints (B,K,2), keypoint_scores
    (B,K), descriptors (B,K,C), mask (B,K)}`` on ``device`` (default
    "cuda"; a CUDA device without a card raises). ``model`` is moved to the
    device and put in eval mode.

    images: (B, H, W, 3) model input, float in [-1, 1] (a tensor or a
    numpy array), as the JAX extractor takes it."""
    dev = resolve_device(device)
    model.to(dev).eval()

    @torch.inference_mode()
    def extract(images) -> Dict[str, Tensor]:
        x = torch.as_tensor(images).to(dev, torch.float32, non_blocking=True)
        if tuple(x.shape[1:]) != (H, W, 3):
            raise ValueError(f"images must be (B, {H}, {W}, 3), got "
                             f"{tuple(x.shape)}")
        post = forward_post_process(model, cfg, x, H, W, KEYPOINT_HEADS)
        kp, score, desc, valid = top_k_keypoints(
            post["score"], post["coord"], post["feat"], max_keypoints,
            conf_threshold)
        return {"keypoints": kp, "keypoint_scores": score,
                "descriptors": desc, "mask": valid}

    return extract


def warp_points_np(pts: np.ndarray, H: np.ndarray) -> np.ndarray:
    homo = np.concatenate([pts, np.ones_like(pts[..., :1])], -1)
    w = homo @ H.T
    return w[..., :2] / w[..., 2:]


def gt_matches_from_homography(kp0: np.ndarray, kp1: np.ndarray,
                               H: np.ndarray, mask0: np.ndarray,
                               mask1: np.ndarray, th: float = 3.0
                               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Ground-truth assignment for a homography pair: kp0 warped by H vs
    kp1, mutual nearest within th px -> positive; else unmatched (-1).
    Invalid (padded) keypoints are unmatchable and excluded from the
    negatives too (marked -2)."""
    M, N = len(kp0), len(kp1)
    warped0 = warp_points_np(kp0, H)
    d = np.linalg.norm(warped0[:, None] - kp1[None], axis=-1)
    d = np.where(mask0[:, None] & mask1[None], d, np.inf)
    nn0 = d.argmin(1)
    nn1 = d.argmin(0)
    min0 = d.min(1) if N else np.full(M, np.inf)
    mutual = np.arange(M) == nn1[nn0]
    pos = mutual & (min0 < th)

    assignment = np.zeros((M, N), np.float32)
    assignment[np.arange(M)[pos], nn0[pos]] = 1.0
    gt_m0 = np.where(pos, nn0, -1)
    gt_m1 = np.full(N, -1, np.int64)
    gt_m1[nn0[pos]] = np.arange(M)[pos]
    gt_m0 = np.where(mask0, gt_m0, -2)
    gt_m1 = np.where(mask1, gt_m1, -2)
    return assignment, gt_m0, gt_m1
