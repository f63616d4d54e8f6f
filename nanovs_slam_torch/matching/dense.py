"""Detector-free dense matching (the reference's LoFTR mode), the
counterpart of ``nanovs_slam_tpu/matching/dense.py`` (reference:
src/visual_odometry/visual_odometry.py:134-136, 296-310).

A raw image pair in, {keypoints0, keypoints1, confidence} out, built on
the model's own dense descriptor map (LoFTR's recipe):
- the fine map is the desc head's (H/2, W/2) output, L2-normalised; the
  coarse map its 2x average pool, one cell a 4x4 pixel block;
- coarse dual-softmax mutual matching over all cell pairs (an (N, N)
  matmul, N = Hc * Wc), border cells dropped, and a fixed-K selection of
  the most confident cells (a stable sort, so the many exact zeros keep
  ``lax.top_k``'s order: lower cell index first);
- fine refinement of image 1's point: a soft-argmax over the correlation
  of a zero-padded (w, w) window of image 1's fine map, centred on the
  rounded and clipped point, with image 0's descriptor sampled bilinearly
  at its exact point.

On a CUDA device the extraction runs the stem kernel in the backbone; the
matching is plain PyTorch on the device (the JAX package computes it in
XLA, outside any Pallas kernel).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..configs import KP2DTinyConfig
from ..ops.grid_sample import sample_descriptors
from ..ops.image import to_model_input
from ..ops.postprocess import stable_top_k
from ..utils.device import resolve_device

Tensor = torch.Tensor


def _l2n(x: Tensor, dim: int = -1) -> Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=dim, keepdim=True),
                           min=1e-12)


def coarse_match(d0: Tensor, d1: Tensor, temperature: float = 0.1
                 ) -> Tuple[Tensor, Tensor]:
    """Dual-softmax mutual matching over flattened coarse descriptors.

    d0, d1: (..., N, C) L2-normalised (leading dims: pairs) -> (j (..., N)
    the best match in d1 of every cell of d0, conf (..., N) its
    dual-softmax probability, 0 where the match is not mutual).
    ``torch.argmax`` returns the first of equal maxima, as ``jnp.argmax``
    does.

    The column softmax runs on the transposed copy: PyTorch's softmax over
    the first of two dims of a contiguous matrix is its slow spatial
    kernel (4.45 of 5.06 device ms a match at N = 4096 on an H100)."""
    s = (d0 @ d1.transpose(-1, -2)) / temperature
    p = torch.softmax(s, -1) * torch.softmax(
        s.transpose(-1, -2).contiguous(), -1).transpose(-1, -2)
    j = torch.argmax(p, -1)
    i_back = torch.argmax(p, -2)
    mutual = torch.gather(i_back, -1, j) == torch.arange(
        d0.shape[-2], device=d0.device)
    conf = torch.gather(p, -1, j[..., None])[..., 0]
    return j, torch.where(mutual, conf, 0.0)


def _gather_windows(fmap: Tensor, cy: Tensor, cx: Tensor, w: int) -> Tensor:
    """fmap ([P,] H, W, C), integer centres cy / cx ([P,] K) inside the
    map -> ([P,] K, w, w, C) windows centred on them, zero outside the
    map."""
    r = w // 2
    padded = F.pad(fmap, (0, 0, r, r, r, r))
    offs = torch.arange(w, device=fmap.device)
    # row cy + r of the padded map is row cy of the map
    rows = (cy[..., None] + offs)[..., :, :, None]
    cols = (cx[..., None] + offs)[..., :, None, :]
    if fmap.dim() == 3:
        return padded[rows, cols]
    pairs = torch.arange(fmap.shape[0], device=fmap.device)
    return padded[pairs[:, None, None, None], rows, cols]


def fine_refine(f1: Tensor, d0c: Tensor, py: Tensor, px: Tensor, w: int,
                temperature: float = 0.05) -> Tuple[Tensor, Tensor]:
    """Soft-argmax local correlation refinement (LoFTR's fine stage).

    f1 ([P,] Hf, Wf, C) image 1's fine map; d0c ([P,] K, C) image 0's
    descriptors; (py, px) ([P,] K) image 1's points on the fine grid. The window's centre
    is the point rounded half to even (``jnp.round``) and clipped to the
    map. -> (dy, dx) offsets in fine-grid units, the centre's rounding
    folded in."""
    Hf, Wf = f1.shape[-3:-1]
    r = w // 2
    iy = torch.clamp(torch.round(py).long(), 0, Hf - 1)
    ix = torch.clamp(torch.round(px).long(), 0, Wf - 1)
    win = _l2n(_gather_windows(f1, iy, ix, w))  # centres at (r, r)
    # a product and a sum over C per window pixel, not a batched matmul:
    # each pair's arithmetic is then the same in a batch of any size
    corr = (win * _l2n(d0c)[..., None, None, :]).sum(-1) / temperature
    prob = torch.softmax(corr.reshape(corr.shape[:-2] + (-1,)), -1
                         ).reshape(corr.shape)
    offs = torch.arange(w, dtype=torch.float32, device=f1.device) - r
    dy = (prob * offs[:, None]).sum((-2, -1))
    dx = (prob * offs[None, :]).sum((-2, -1))
    return dy + (iy - py), dx + (ix - px)


def dense_maps(model: nn.Module, cfg: KP2DTinyConfig, raw: Tensor) -> Tensor:
    """(B, H, W, 3) uint8 or float [0, 1] frames on the model's device ->
    the L2-normalised fine maps (B, H/2, W/2, C). Only the desc head runs
    (V2; V3 computes every head)."""
    x = to_model_input(raw).permute(0, 3, 1, 2).contiguous()
    kw = {} if cfg.variant == "v3" else {"heads": ("desc",)}
    return _l2n(model(x, **kw)["feat"].permute(0, 2, 3, 1))


def as_frames(img, dev) -> Tensor:
    """Frames (numpy or a tensor; uint8, or float in [0, 1]) on ``dev``:
    uint8 stays uint8 (normalised after the copy), the rest float32."""
    x = img if isinstance(img, Tensor) else torch.from_numpy(
        np.ascontiguousarray(img))
    if x.dtype != torch.uint8:
        x = x.to(torch.float32)
    return x.to(dev, non_blocking=True)


class DenseMatcher:
    """Detector-free image-pair matcher on a KP2DTiny model's dense
    descriptor map (reference LoFTR-mode surface,
    visual_odometry.py:296-310).

    ``model`` (weights loaded) is moved to ``device`` (default "cuda"; a
    CUDA device without a card raises) and put in eval mode. size: (H, W)
    input size; k: the match slots (fixed-K selection); window: the fine
    correlation window (odd). ``__call__`` filters on the host."""

    def __init__(self, model: nn.Module, cfg: KP2DTinyConfig,
                 size: Tuple[int, int], k: int = 512, window: int = 5,
                 coarse_temperature: float = 0.1,
                 fine_temperature: float = 0.05, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.cfg = cfg
        self.H, self.W = size
        self.cell = cfg.cell
        self.k = k
        self.window = window
        self.ct = coarse_temperature
        self.ft = fine_temperature

    # -- stage 1: the dense map, kept on the device between frames
    @torch.inference_mode()
    def extract(self, img) -> Tensor:
        """(H, W, 3) uint8 or float [0, 1] frame -> its fine map (Hf, Wf,
        C) on the device (uint8 is a 4x smaller copy, normalised after
        it)."""
        return dense_maps(self.model, self.cfg,
                          as_frames(img, self.device)[None])[0]

    # -- stage 2: coarse dual-softmax and fine refinement
    @torch.inference_mode()
    def match_maps(self, f0: Tensor, f1: Tensor):
        """Two fine maps -> (kp0 (K, 2), kp1 (K, 2), conf (K,)) on their
        device, K = min(k, Hc * Wc), in descending confidence. Maps of P
        pairs (P, Hf, Wf, C) give (P, K, 2), (P, K, 2) and (P, K)."""
        H, W, cell, w = self.H, self.W, self.cell, self.window
        *lead, Hf, Wf, C = f0.shape
        Hc, Wc = Hf // 2, Wf // 2
        n = Hc * Wc
        dev = f0.device

        def coarse(f):  # 2x average pool of the fine map
            return _l2n(f.reshape(*lead, Hc, 2, Wc, 2, C).mean(
                dim=(-4, -2))).reshape(*lead, n, C)

        j, conf = coarse_match(coarse(f0), coarse(f1), self.ct)
        # drop the border cells (the model's border mask removes the
        # outermost ring)
        ar = torch.arange(n, device=dev)
        ii, jj = ar // Wc, ar % Wc
        inner = (ii > 0) & (ii < Hc - 1) & (jj > 0) & (jj < Wc - 1)
        conf = torch.where(inner, conf, 0.0)
        top_conf, idx0 = stable_top_k(conf, min(self.k, n))
        idx1 = torch.gather(j, -1, idx0)

        step = (cell - 1) / 2.0  # cell centres (decode_coords)

        def to_xy(idx):
            return torch.stack([(idx % Wc).to(torch.float32) * cell + step,
                                (idx // Wc).to(torch.float32) * cell + step],
                               -1)

        kp0, kp1 = to_xy(idx0), to_xy(idx1)
        # image 1's point refined on the fine grid (align corners); image
        # 0's anchor descriptor sampled bilinearly at kp0 itself
        rx, ry = (Wf - 1) / (W - 1), (Hf - 1) / (H - 1)
        d0c = (sample_descriptors(f0, kp0, H, W) if lead else
               sample_descriptors(f0[None], kp0[None], H, W)[0])
        dy, dx = fine_refine(f1, d0c, kp1[..., 1] * ry, kp1[..., 0] * rx,
                             w, self.ft)
        kp1 = kp1 + torch.stack([dx / rx, dy / ry], -1)
        kp1 = torch.stack([torch.clamp(kp1[..., 0], 0.0, W - 1.0),
                           torch.clamp(kp1[..., 1], 0.0, H - 1.0)], -1)
        return kp0, kp1, top_conf

    def __call__(self, img0, img1, conf_threshold: float = 0.05,
                 rel_threshold: float = 0.0) -> Dict[str, np.ndarray]:
        """The reference's LoFTR output dict for one pair, numpy, kept
        where conf > conf_threshold (visual_odometry.py:305-309); with
        rel_threshold > 0 where conf > rel_threshold * max(conf), the
        per-pair rule of the VO paths."""
        kp0, kp1, conf = (t.cpu().numpy() for t in self.match_maps(
            self.extract(img0), self.extract(img1)))
        thr = rel_threshold * conf.max() if rel_threshold > 0 \
            else conf_threshold
        keep = conf > thr
        return {"keypoints0": kp0[keep], "keypoints1": kp1[keep],
                "confidence": conf[keep]}
