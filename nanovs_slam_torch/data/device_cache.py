"""A dataset resident on the card, batches assembled there: the counterpart
of ``nanovs_slam_tpu/data/device_cache.py``.

``PairLoader`` augments every sample on the host and copies each batch to
the device. For a dataset that fits in device memory (synthetic sets,
extracted subsets, cached shards), ``DeviceCachedPairLoader`` uploads the
whole set once and builds each batch on the device: an index gather, the
``/255`` of uint8 planes, the photometric augment, then the homography
pair of ``data/pipeline.build_pair_batch``. A step uploads only its (B,)
indices and (B, 3, 3) homographies.

Image and segmentation planes are kept as uint8 when that is lossless
(``store_u8="auto"``): an image decoded from an 8-bit source is exactly
k/255, so uint8 and the in-graph ``/255`` give the float32 cache back to an
ulp, in a quarter of the memory and of the one-time upload.

The photometric augment is the device analog of the host pipeline's random
grayscale (p = 0.2) and brightness / contrast jitter (+-0.1); the host's
equalize and blur are left out on this path, as in the JAX loader. Its
three uniform draws come from ``photometric_draws`` on an explicit
``torch.Generator``: PyTorch's numbers, not ``jax.random``'s (ROADMAP
Queue 3); the tests swap that function to hand both sides the same draws.
Indices and homographies come from ``np.random.RandomState(seed + epoch)``
in the JAX loader's order, bit for bit.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device
from .homography import sample_homography
from .pipeline import build_pair_batch

Tensor = torch.Tensor
_LUMA = (0.299, 0.587, 0.114)


def photometric_draws(B: int, generator: torch.Generator, device
                      ) -> Tuple[Tensor, Tensor, Tensor]:
    """The augment's per-sample randomness, each (B, 1, 1, 1) float32 on
    ``device``: a uniform [0, 1) for the grayscale choice, the brightness
    factor 1 + U(-0.1, 0.1) and the contrast factor 1 + U(-0.1, 0.1)."""
    u = torch.rand((3, B, 1, 1, 1), generator=generator, device=device)
    return u[0], 1.0 + (u[1] * 0.2 - 0.1), 1.0 + (u[2] * 0.2 - 0.1)


def _photometric(images: Tensor, generator: Optional[torch.Generator],
                 augment: bool = True, shard=None) -> Tensor:
    """Per-sample random grayscale (p = 0.2), then brightness and contrast
    jitter (contrast about the image's mean); (B, H, W, 3) in [0, 1] in and
    out. ``shard`` = (rank, n): the images are rows rank of n equal shards
    of a global batch, and take those rows of the global batch's draws."""
    if not augment:
        return images
    B = images.shape[0]
    rank, n = shard or (0, 1)
    u_gray, b, c = (d[rank * B:(rank + 1) * B] for d in photometric_draws(
        B * n, generator, images.device))
    luma = torch.tensor(_LUMA, dtype=images.dtype, device=images.device)
    gray = (images @ luma)[..., None]
    images = torch.where(u_gray < 0.2, gray, images)
    images = images * b
    mean = images.mean(dim=(1, 2, 3), keepdim=True)
    images = (images - mean) * c + mean
    return torch.clamp(images, 0.0, 1.0)


def _assemble(images: Tensor, segs: Tensor, depths: Optional[Tensor],
              idx: Tensor, homos: Tensor,
              generator: Optional[torch.Generator], d_f: int,
              with_depth: bool, augment: bool, shard=None
              ) -> Dict[str, Tensor]:
    """One training batch from the cache, on its device: the gather of
    ``idx`` (B,), uint8 planes decoded, the photometric augment, the
    homography pair for ``homos`` (B, 3, 3). ``shard`` = (rank, n): the
    batch is rows rank of n equal shards of a global batch (its augment
    draws are those rows of the global batch's)."""
    imgs = images[idx]
    if imgs.dtype == torch.uint8:
        imgs = imgs.to(torch.float32) / 255.0
    imgs = _photometric(imgs, generator, augment, shard)
    return build_pair_batch(imgs, segs[idx].to(torch.int64), homos,
                            depths[idx] if with_depth else None,
                            d_f=d_f, with_depth=with_depth)


def _lossless_u8(stack: np.ndarray) -> bool:
    """True iff every value is exactly k/255 (an image decoded from an
    8-bit source), where uint8 caching loses nothing."""
    scaled = stack * 255.0
    return bool(np.abs(scaled - np.rint(scaled)).max() < 1e-4)


class DeviceCachedPairLoader:
    """``PairLoader``'s batches from a dataset held on ``device`` (default
    "cuda"), for datasets that fit there."""

    def __init__(self, dataset, batch_size: int, H: int, W: int,
                 d_f: int = 2, train: bool = True, seed: int = 0,
                 with_depth: bool = False, store_u8="auto", device=None):
        """store_u8: keep image (and segmentation id) planes as uint8.
        "auto" does it only where lossless: images whose values are all
        k/255 (a resize happens in float first, so interpolated values keep
        their precision) and ids that fit in a byte. True quantises images
        whatever they hold; False keeps float32 / int32."""
        self.batch_size = batch_size
        self.H, self.W, self.d_f = H, W, d_f
        self.train = train
        self.with_depth = with_depth
        self.seed = seed
        self.device = resolve_device(device)

        imgs, segs, depths = [], [], []
        for i in range(len(dataset)):
            item = dataset[i]
            img = item["image"]
            if img.shape[:2] != (H, W):
                img = _resize(img, W, H)
            seg = item.get("seg")
            if seg is None:
                seg = np.zeros((H, W), np.int32)
            elif seg.shape[:2] != (H, W):
                seg = _resize(seg, W, H, nearest=True)
            imgs.append(img.astype(np.float32))
            segs.append(seg.astype(np.int32))
            if with_depth:
                d = item.get("depth", np.zeros((H, W, 1), np.float32))
                if d.shape[:2] != (H, W):
                    d = _resize(d, W, H)[..., None]
                depths.append(d.astype(np.float32))

        img_stack = np.stack(imgs)  # (N, H, W, 3) in [0, 1]
        seg_stack = np.stack(segs)
        u8_imgs = (store_u8 is True
                   or (store_u8 == "auto" and _lossless_u8(img_stack)))
        if u8_imgs:
            img_stack = np.clip(np.rint(img_stack * 255.0), 0,
                                255).astype(np.uint8)
        if store_u8 and seg_stack.min() >= 0 and seg_stack.max() <= 255:
            seg_stack = seg_stack.astype(np.uint8)
        self.store_u8 = u8_imgs
        # one upload each
        self.images = torch.from_numpy(img_stack).to(self.device)
        self.segs = torch.from_numpy(seg_stack).to(self.device)
        self.depths = (torch.from_numpy(np.stack(depths)).to(self.device)
                       if with_depth else None)
        self.n = len(imgs)

    def __len__(self):
        return max(self.n // self.batch_size, 1)

    def nbytes(self) -> int:
        """Bytes of the resident planes."""
        return sum(t.numel() * t.element_size()
                   for t in self.cache_arrays() if t is not None)

    def _draws(self, epoch_idx: int):
        """The epoch's host randomness in the JAX loader's order: the
        permutation, then B homographies a step; yields (indices (B,),
        homographies (B, 3, 3) float32) as numpy arrays."""
        rs = np.random.RandomState(self.seed + epoch_idx)
        order = rs.permutation(self.n) if self.train else np.arange(self.n)
        B = self.batch_size
        for s in range(len(self)):
            idx = order[s * B:(s + 1) * B]
            if len(idx) < B:  # fixed shapes: wrap around
                idx = np.concatenate([idx, order[:B - len(idx)]])
            homos = np.stack([sample_homography((self.H, self.W), rs)
                              for _ in range(B)]).astype(np.float32)
            yield idx, homos

    def generator(self, epoch_idx: int) -> torch.Generator:
        """The photometric augment's generator of an epoch, on the cache's
        device, seeded with seed + epoch."""
        return torch.Generator(self.device).manual_seed(self.seed + epoch_idx)

    def epoch(self, epoch_idx: int) -> Iterator[Dict[str, Tensor]]:
        """The epoch's batches, built on the device; a step uploads its
        indices and homographies only."""
        gen = self.generator(epoch_idx)
        for idx, homos in self._draws(epoch_idx):
            yield _assemble(*self.cache_arrays(),
                            torch.from_numpy(idx).to(self.device),
                            torch.from_numpy(homos).to(self.device), gen,
                            self.d_f, self.with_depth, self.train)

    def epoch_arrays(self, epoch_idx: int
                     ) -> Tuple[Tensor, Tensor, torch.Generator]:
        """The epoch's randomness for ``train/scan_epoch.py``: (S, B)
        indices and (S, B, 3, 3) homographies on the device (one upload
        each), drawn from the same stream in the same order as ``epoch``,
        and the augment's generator, seeded as ``epoch`` seeds it."""
        draws = list(self._draws(epoch_idx))
        idx_all = np.stack([d[0] for d in draws]).astype(np.int64)
        homos = np.stack([d[1] for d in draws])
        return (torch.from_numpy(idx_all).to(self.device),
                torch.from_numpy(homos).to(self.device),
                self.generator(epoch_idx))

    def cache_arrays(self) -> Tuple[Tensor, Tensor, Optional[Tensor]]:
        """The resident planes (images, segs, depths)."""
        return self.images, self.segs, self.depths

    def __iter__(self):
        self._epoch_counter = getattr(self, "_epoch_counter", -1) + 1
        return self.epoch(self._epoch_counter)


def _resize(a: np.ndarray, W: int, H: int, nearest: bool = False):
    """cv2's resize of one plane, for items not at the loader's size."""
    import cv2

    return cv2.resize(a, (W, H), interpolation=cv2.INTER_NEAREST
                      if nearest else cv2.INTER_LINEAR)
