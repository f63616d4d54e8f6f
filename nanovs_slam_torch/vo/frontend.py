"""The VO feature-extraction frontend, the counterpart of
``nanovs_slam_tpu/vo/frontend.py`` (reference:
src/visual_odometry/frontend.py:11-129).

Per frame: normalise ((x - 0.5) * 2), forward and postprocess (the stem
and postprocess kernels on a CUDA device), the optional semantic filter
(the argmax class map nearest-sampled at the keypoints; a keypoint of a
class in ``classes_to_filter`` gets score 0), then a fixed-K top-K with
the confidence mask ``score > nn_thresh``. Invalid slots keep their place
behind a False validity flag; ``fetch`` trims them on the host.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..configs import KP2DTinyConfig
from ..inference import forward_post_process
from ..ops.grid_sample import grid_sample_nearest
from ..ops.image import to_model_input
from ..ops.postprocess import top_k_keypoints
from ..utils.device import resolve_device

Tensor = torch.Tensor


class KP2DTinyFrontend:
    """``model`` (weights loaded) is moved to ``device`` (default "cuda";
    a CUDA device without a card raises) and put in eval mode.
    ``with_seg`` runs the segmentation head without the filter (for the
    semantic matcher, which needs per-keypoint classes)."""

    def __init__(self, model: nn.Module, cfg: KP2DTinyConfig,
                 new_size: Tuple[int, int], nn_thresh: float = 0.7,
                 top_k: int = 4000, semantic_filter: bool = False,
                 classes_to_filter: Sequence[int] = (21,),
                 with_seg: bool = False, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.cfg = cfg
        self.H, self.W = new_size
        self.nn_thresh = nn_thresh
        self.top_k = top_k
        self.semantic_filter = semantic_filter
        self.classes_to_filter = tuple(classes_to_filter)
        self.with_seg = with_seg
        # head gating: no seg head without the filter (or with_seg), and
        # never the vlad head
        self.need_seg = semantic_filter and len(self.classes_to_filter) > 0
        self.heads = ("score", "loc", "desc") + (
            ("seg",) if self.need_seg or with_seg else ())

    @torch.inference_mode()
    def _infer(self, raw: Tensor):
        H, W, cfg = self.H, self.W, self.cfg
        post = forward_post_process(self.model, cfg, to_model_input(raw),
                                    H, W, self.heads)
        score, coord, feat = post["score"], post["coord"], post["feat"]
        B, Hc, Wc, _ = score.shape
        if "seg" in self.heads:
            # the class at each keypoint: the map at the seg head's
            # resolution, read align-corners over the image's (W-1, H-1)
            gx = coord[..., 0] / ((W - 1) / 2.0) - 1.0
            gy = coord[..., 1] / ((H - 1) / 2.0) - 1.0
            seg_at_kp = grid_sample_nearest(
                post["seg"].to(torch.float32),
                torch.stack([gx, gy], dim=-1))[..., 0]
            if self.need_seg:
                bad = torch.zeros_like(seg_at_kp, dtype=torch.bool)
                for c in self.classes_to_filter:
                    bad = bad | (seg_at_kp == c)
                score = torch.where(bad[..., None], 0.0, score)
        else:
            seg_at_kp = torch.zeros((B, Hc, Wc), device=score.device)
        kp, s, d, valid, idx = top_k_keypoints(
            score, coord, feat, self.top_k, self.nn_thresh,
            with_indices=True)
        kp_class = torch.gather(seg_at_kp.reshape(B, Hc * Wc), 1,
                                idx).to(torch.int32)
        return kp, s, d, valid, kp_class, post

    def run_async(self, img):
        """Enqueue one frame's extraction on the device's stream and return
        its device tensors at once; ``fetch`` waits for them. img (H, W, 3)
        uint8, or float in [0, 1], at ``new_size``: numpy, or a tensor on
        any device."""
        x = img if isinstance(img, Tensor) else torch.from_numpy(
            np.asarray(img))
        if x.dtype != torch.uint8:
            x = x.to(torch.float32)
        if tuple(x.shape) != (self.H, self.W, 3):
            raise ValueError(f"frame must be ({self.H}, {self.W}, 3), got "
                             f"{tuple(x.shape)}")
        return self._infer(x[None].to(self.device, non_blocking=True))

    def fetch(self, handle):
        """A handle from ``run_async`` -> (pts (N, 2), feat (N, C), out)
        numpy, trimmed to the valid slots; out["kp_class"] (N,) when the
        seg head runs."""
        kp, s, d, valid, kp_class, post = handle
        valid = valid[0].cpu().numpy()
        kp, d = kp[0].cpu().numpy(), d[0].cpu().numpy()
        out = {k: v.cpu().numpy() for k, v in post.items()}
        if self.semantic_filter or self.with_seg:
            out["kp_class"] = kp_class[0].cpu().numpy()[valid]
        return kp[valid], d[valid], out

    def run(self, img):
        """``fetch(run_async(img))``."""
        return self.fetch(self.run_async(img))
