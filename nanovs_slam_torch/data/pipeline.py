"""Training data pipeline, the counterpart of
``nanovs_slam_tpu/data/pipeline.py``: host-side photometric augments in
numpy, the homography pair built on the device.

Per sample (train): random grayscale, random equalize, color jitter and a
3x3 Gaussian blur on the host, then a random homography; the warped pair
(nearest-mode homography warp), masks at H/d_f and images in [-1, 1] are
built on the loader's device by ``build_pair_batch``. The augments draw
from the loader's ``np.random.RandomState`` in the JAX loader's order, so
that the same seed gives the same indices, augment parameters and
homographies. ``equalize_hist`` and ``gaussian_blur`` are cv2's
``equalizeHist`` and ``GaussianBlur`` (3x3, BORDER_REFLECT_101) written in
numpy: the card's machine has no cv2.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device
from .homography import homography_warp_image, sample_homography
from .prefetch import device_prefetch

Tensor = torch.Tensor


def nearest_downsample(x: Tensor, factor: int) -> Tensor:
    """(B, H, W, ...) -> (B, H/f, W/f, ...) nearest (stride) downsample."""
    return x[:, ::factor, ::factor]


def build_pair_batch(images: Tensor, segs: Tensor, homographies: Tensor,
                     depths: Optional[Tensor] = None, d_f: int = 2,
                     with_depth: bool = False) -> Dict[str, Tensor]:
    """images (B,H,W,3) in [0,1]; segs (B,H,W) int; homographies (B,3,3);
    optional depths (B,H,W,1) -> the training batch on their device:
    image/image_aug (B,H,W,3) in [-1,1], seg/seg_aug (B,H/d_f,W/d_f)
    int64, homography, and with ``with_depth`` depth/depth_aug
    (B,H/d_f,W/d_f,1)."""
    seg_f = segs[..., None].to(torch.float32)
    img_aug = homography_warp_image(images, homographies, mode="nearest")
    seg_aug = homography_warp_image(seg_f, homographies, mode="nearest")
    batch = {
        "image": images * 2.0 - 1.0,
        "image_aug": img_aug * 2.0 - 1.0,
        "seg": nearest_downsample(seg_f, d_f)[..., 0].to(torch.int64),
        "seg_aug": nearest_downsample(seg_aug, d_f)[..., 0].to(torch.int64),
        "homography": homographies,
    }
    if with_depth and depths is not None:
        depth_aug = homography_warp_image(depths, homographies,
                                          mode="nearest")
        batch["depth"] = nearest_downsample(depths, d_f)
        batch["depth_aug"] = nearest_downsample(depth_aug, d_f)
    return batch


_LUMA = np.array([0.299, 0.587, 0.114], np.float32)


def random_grayscale(img: np.ndarray, rng: np.random.RandomState,
                     p: float = 0.2) -> np.ndarray:
    if rng.rand() < p:
        g = img @ _LUMA
        return np.repeat(g[..., None], 3, axis=-1)
    return img


def equalize_hist(u8: np.ndarray) -> np.ndarray:
    """``cv2.equalizeHist`` of one uint8 channel: the cumulative histogram
    above the first occupied bin, scaled by 255 / (count - that bin's) in
    float32 and rounded half to even."""
    hist = np.bincount(u8.ravel(), minlength=256)
    first = int(np.argmax(hist > 0))
    if hist[first] == u8.size:
        return np.full_like(u8, first)
    scale = np.float32(255.0) / np.float32(u8.size - hist[first])
    cum = (np.cumsum(hist) - hist[first]).astype(np.float32)
    lut = np.clip(np.rint(cum * scale), 0, 255).astype(np.uint8)
    lut[:first + 1] = 0
    return lut[u8]


def random_equalize(img: np.ndarray, rng: np.random.RandomState,
                    p: float = 0.2) -> np.ndarray:
    if rng.rand() < p:
        u8 = (img * 255).astype(np.uint8)
        for c in range(3):
            u8[..., c] = equalize_hist(u8[..., c])
        return u8.astype(np.float32) / 255.0
    return img


def color_jitter(img: np.ndarray, rng: np.random.RandomState,
                 brightness=0.1, contrast=0.1, saturation=0.1,
                 hue=0.1) -> np.ndarray:
    b = 1.0 + rng.uniform(-brightness, brightness)
    c = 1.0 + rng.uniform(-contrast, contrast)
    img = img * b
    mean = img.mean()
    img = (img - mean) * c + mean
    g = img @ _LUMA
    s = 1.0 + rng.uniform(-saturation, saturation)
    img = g[..., None] + (img - g[..., None]) * s
    return np.clip(img, 0.0, 1.0)


def gaussian_blur(img: np.ndarray, rng: np.random.RandomState,
                  sigma=(0.1, 1.0)) -> np.ndarray:
    """``cv2.GaussianBlur(img, (3, 3), s)`` with s drawn from ``sigma``:
    cv2's kernel exp(-x^2 / (2 s^2)) normalised (float64, stored float32),
    rows then columns, centre tap times k1 plus the outer pair's sum times
    k0 (cv2's symmetric small filter), BORDER_REFLECT_101."""
    s = rng.uniform(*sigma)
    t = np.exp(-0.5 / (s * s) * np.array([1.0, 0.0, 1.0]))
    k = (t / t.sum()).astype(np.float32)
    img = np.asarray(img, np.float32)
    p = np.pad(img, ((0, 0), (1, 1), (0, 0)), mode="reflect")
    rows = p[:, 1:-1] * k[1] + (p[:, :-2] + p[:, 2:]) * k[0]
    p = np.pad(rows, ((1, 1), (0, 0), (0, 0)), mode="reflect")
    return p[1:-1] * k[1] + (p[:-2] + p[2:]) * k[0]


class PairLoader:
    """Batches of a base dataset (items: image (H,W,3) [0,1] float32, seg
    (H,W) int, optional depth (H,W,1), all at (im_h, im_w)): host augments
    and homographies on the host, the pair built on ``device`` (default
    "cuda"). ``rows`` = (r, n): only the r-th of n equal parts of each
    batch (a data-parallel rank's rows of its host's batch) goes to the
    device and is paired; the host still loads and draws for the whole
    batch, from its one stream, so that the n parts together are the
    batch one process would build."""

    def __init__(self, dataset, batch_size: int, im_h: int, im_w: int,
                 d_f: int = 2, train: bool = True, seed: int = 42069,
                 with_depth: bool = False, drop_last: bool = True,
                 device=None, rows: Optional[Tuple[int, int]] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.im_h, self.im_w = im_h, im_w
        self.d_f = d_f
        self.train = train
        self.rng = np.random.RandomState(seed)
        self.with_depth = with_depth
        self.drop_last = drop_last
        self.device = resolve_device(device)
        if rows is not None and batch_size % rows[1]:
            raise ValueError(f"batch {batch_size} does not split into "
                             f"{rows[1]} parts")
        self.rows = rows

    def __len__(self):
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n

    def _host_augment(self, img: np.ndarray) -> np.ndarray:
        if not self.train:
            return img
        img = random_grayscale(img, self.rng)
        img = random_equalize(img, self.rng)
        img = color_jitter(img, self.rng)
        img = gaussian_blur(img, self.rng)
        return img.astype(np.float32)

    def host_batches(self) -> Iterator[Dict[str, Tensor]]:
        """The host half: per batch, CPU tensors images (B,H,W,3), segs
        (B,H,W) int64, homographies (B,3,3) and, with depth, depths (B / n
        rows each with ``rows``)."""
        order = np.arange(len(self.dataset))
        if self.train:
            self.rng.shuffle(order)
        B = self.batch_size
        for bi in range(len(self)):
            idxs = order[bi * B: (bi + 1) * B]
            imgs, segs, depths, homos = [], [], [], []
            for i in idxs:
                item = self.dataset[int(i)]
                imgs.append(self._host_augment(item["image"]))
                segs.append(item["seg"])
                if self.with_depth:
                    depths.append(item.get(
                        "depth", np.zeros((self.im_h, self.im_w, 1),
                                          np.float32)))
                homos.append(sample_homography((self.im_h, self.im_w),
                                               self.rng))
            hb = {"images": torch.from_numpy(np.stack(imgs).astype(
                      np.float32)),
                  "segs": torch.from_numpy(np.stack(segs).astype(np.int64)),
                  "homographies": torch.from_numpy(np.stack(homos).astype(
                      np.float32))}
            if self.with_depth:
                hb["depths"] = torch.from_numpy(np.stack(depths).astype(
                    np.float32))
            if self.rows is not None:
                r, n = self.rows
                hb = {k: v[r * B // n:(r + 1) * B // n]
                      for k, v in hb.items()}
            yield hb

    def batches(self, prefetch: int = 0) -> Iterator[Dict[str, Tensor]]:
        """Training batches on the device; with ``prefetch`` > 0 the host
        half runs that many batches ahead in a thread and its copies to a
        card go on a side stream (``data/prefetch.device_prefetch``)."""
        host = self.host_batches()
        if prefetch:
            host = device_prefetch(host, self.device, prefetch)
        for hb in host:
            hb = {k: v.to(self.device) for k, v in hb.items()}
            yield build_pair_batch(hb["images"], hb["segs"],
                                   hb["homographies"], hb.get("depths"),
                                   d_f=self.d_f, with_depth=self.with_depth)

    def __iter__(self) -> Iterator[Dict[str, Tensor]]:
        return self.batches()
