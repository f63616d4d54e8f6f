"""Dataset loaders (host side), the counterparts of
``nanovs_slam_tpu/data/datasets.py``.

``SimpleFolderDataset``, ``COCOStuffDataset`` and ``CityscapesDataset``
are copies that read files with cv2, imported inside the functions that
read (the card's machine has no cv2; nothing imports it at the top).
``SyntheticShapesDataset`` draws the JAX package's procedural images and
masks in numpy alone: cv2's bicubic upsample (A = -0.75, half-pixel
centres, edge taps clamped), filled rectangles and cv2's filled-circle
scanlines (``cv::Circle`` for LINE_8, thickness -1) are written out here.
The same seed gives the same shapes, masks and depth as the cv2 version;
the image differs by the bicubic's float32 rounding (~1e-6).

All return dicts {image (H,W,3) float32 [0,1], seg (H,W) uint8, optional
depth (H,W,1) float32} pre-resized to the requested size. Dataset paths
come from datasets.json.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from .class_maps import cityscapes_lut, cocostuff_lut, remap_mask


def load_datasets_json(path: str = "datasets.json") -> Dict[str, str]:
    """Dataset-name -> local-path registry (datasets_template.json:1-12)."""
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def _imread_rgb(path: str, size: Tuple[int, int]) -> np.ndarray:
    import cv2

    img = cv2.imread(path, cv2.IMREAD_COLOR)
    img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    img = cv2.resize(img, (size[1], size[0]))
    return img.astype(np.float32) / 255.0


def _imread_mask(path: str, size: Tuple[int, int]) -> np.ndarray:
    import cv2

    m = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    return cv2.resize(m, (size[1], size[0]),
                      interpolation=cv2.INTER_NEAREST)


class SimpleFolderDataset:
    """images/ + segmentation/ + depth/ folder layout (dataset.py:143)."""

    def __init__(self, root: str, size: Tuple[int, int],
                 with_depth: bool = False):
        self.size = size
        self.with_depth = with_depth
        self.images = sorted(
            glob.glob(os.path.join(root, "images", "*")))
        self.segs = sorted(
            glob.glob(os.path.join(root, "segmentation", "*")))
        self.depths = sorted(glob.glob(os.path.join(root, "depth", "*")))
        assert len(self.images) == len(self.segs), (
            f"{len(self.images)} images vs {len(self.segs)} masks")

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        out = {"image": _imread_rgb(self.images[i], self.size),
               "seg": _imread_mask(self.segs[i], self.size)}
        if self.with_depth and i < len(self.depths):
            import cv2

            d = cv2.imread(self.depths[i], cv2.IMREAD_UNCHANGED)
            d = cv2.resize(d, (self.size[1], self.size[0]))
            out["depth"] = (np.clip(d, 10, 65000) / 65000.0
                            ).astype(np.float32)[..., None]
        return out


class COCOStuffDataset:
    """COCO-Stuff with 183->28 remap and optional MiDaS depth pseudo-GT."""

    def __init__(self, root: str, size: Tuple[int, int], split: str = "train",
                 n_classes: int = 28, with_depth: bool = False):
        self.size = size
        self.with_depth = with_depth
        self.lut = cocostuff_lut() if n_classes == 28 else None
        img_dir = os.path.join(root, "images", f"{split}2017")
        ann_dir = os.path.join(root, "annotations", f"{split}2017")
        depth_dir = os.path.join(root, "depth", f"{split}2017")
        self.items: List[Tuple[str, str, Optional[str]]] = []
        for img_path in sorted(glob.glob(os.path.join(img_dir, "*.jpg"))):
            stem = os.path.splitext(os.path.basename(img_path))[0]
            ann = os.path.join(ann_dir, stem + ".png")
            dep = os.path.join(depth_dir, stem + ".png")
            if os.path.exists(ann):
                self.items.append(
                    (img_path, ann, dep if os.path.exists(dep) else None))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        img_path, ann_path, dep_path = self.items[i]
        seg = _imread_mask(ann_path, self.size)
        if self.lut is not None:
            seg = remap_mask(seg, self.lut)
        out = {"image": _imread_rgb(img_path, self.size), "seg": seg}
        if self.with_depth and dep_path:
            import cv2

            d = cv2.imread(dep_path, cv2.IMREAD_UNCHANGED).astype(np.float32)
            d = cv2.resize(d, (self.size[1], self.size[0]))
            out["depth"] = (np.clip(d, 10, 65000) / 65000.0
                            ).astype(np.float32)[..., None]
        return out


class CityscapesDataset:
    """Cityscapes leftImg8bit/gtFine with trainId remap (19 classes)."""

    def __init__(self, root: str, size: Tuple[int, int],
                 split: str = "train"):
        self.size = size
        self.lut = cityscapes_lut()
        img_glob = os.path.join(root, "leftImg8bit", split, "*", "*.png")
        self.images = sorted(glob.glob(img_glob))
        self.masks = [
            p.replace(os.sep + "leftImg8bit" + os.sep,
                      os.sep + "gtFine" + os.sep)
            .replace("_leftImg8bit.png", "_gtFine_labelIds.png")
            for p in self.images
        ]
        pairs = [(i, m) for i, m in zip(self.images, self.masks)
                 if os.path.exists(m)]
        self.images = [p[0] for p in pairs]
        self.masks = [p[1] for p in pairs]

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        seg = remap_mask(_imread_mask(self.masks[i], self.size), self.lut)
        return {"image": _imread_rgb(self.images[i], self.size), "seg": seg}


def _cubic_taps(n_src: int, n_dst: int):
    """cv2's INTER_CUBIC taps along one axis: for each destination index
    its four source indices (clamped to the edge) and float32 weights,
    with src = (dst + 0.5) * n_src / n_dst - 0.5 and A = -0.75."""
    f = ((np.arange(n_dst) + 0.5) * (n_src / n_dst) - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    x = (f - s).astype(np.float32)
    a, one = np.float32(-0.75), np.float32(1.0)
    c0 = ((a * (x + one) - 5 * a) * (x + one) + 8 * a) * (x + one) - 4 * a
    c1 = ((a + 2) * x - (a + 3)) * x * x + one
    c2 = ((a + 2) * (one - x) - (a + 3)) * (one - x) * (one - x) + one
    c3 = one - c0 - c1 - c2
    idx = np.clip(s[:, None] + np.arange(-1, 3), 0, n_src - 1)
    return idx, np.stack([c0, c1, c2, c3], axis=1).astype(np.float32)


def resize_cubic(img: np.ndarray, H: int, W: int) -> np.ndarray:
    """(h, w, C) float32 -> (H, W, C): ``cv2.resize(img, (W, H),
    interpolation=cv2.INTER_CUBIC)``, rows first, then columns."""
    h, w = img.shape[:2]
    ix, ax = _cubic_taps(w, W)
    iy, ay = _cubic_taps(h, H)
    rows = np.zeros((h, W) + img.shape[2:], np.float32)
    for j in range(4):
        rows = rows + img[:, ix[:, j]] * ax[:, j, None]
    out = np.zeros((H, W) + img.shape[2:], np.float32)
    for j in range(4):
        out = out + rows[iy[:, j]] * ay[:, j, None, None]
    return out


def fill_rectangle(img: np.ndarray, p0, p1, value) -> None:
    """``cv2.rectangle(img, p0, p1, value, -1)`` for corners inside the
    image: rows y0..y1 and columns x0..x1, both ends included."""
    (x0, y0), (x1, y1) = p0, p1
    img[min(y0, y1):max(y0, y1) + 1, min(x0, x1):max(x0, x1) + 1] = value


def fill_circle(img: np.ndarray, center, r: int, value) -> None:
    """``cv2.circle(img, center, r, value, -1)``: OpenCV's filled circle
    for LINE_8 (``cv::Circle``), four clipped scanlines a step of its
    midpoint walk, so the edge pixels are OpenCV's."""
    H, W = img.shape[:2]
    cx, cy = center

    def hline(y, x0, x1):
        if 0 <= y < H:
            x0, x1 = max(x0, 0), min(x1, W - 1)
            if x0 <= x1:
                img[y, x0:x1 + 1] = value

    err, dx, dy, plus, minus = 0, r, 0, 1, 2 * r - 1
    while dx >= dy:
        if cx - dx < W and cx + dx >= 0 and cy - dx < H and cy + dx >= 0:
            hline(cy - dy, cx - dx, cx + dx)
            hline(cy + dy, cx - dx, cx + dx)
            if cx - dy < W and cx + dy >= 0:
                hline(cy - dx, cx - dy, cx + dy)
                hline(cy + dx, cx - dy, cx + dy)
        dy += 1
        err += plus
        plus += 2
        step = 0 if err <= 0 else -1
        err -= minus & step
        dx += step
        minus -= step & 2


class SyntheticShapesDataset:
    """Procedural corners-rich images + consistent masks for smoke
    training/tests without any external data (numpy only)."""

    def __init__(self, size: Tuple[int, int], n_items: int = 64,
                 n_classes: int = 8, seed: int = 0,
                 with_depth: bool = False):
        self.size = size
        self.n_items = n_items
        self.n_classes = n_classes
        self.seed = seed
        self.with_depth = with_depth

    def __len__(self):
        return self.n_items

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        H, W = self.size
        rs = np.random.RandomState(self.seed * 10007 + i)
        # low-frequency texture so descriptors have local signal
        tex = rs.rand(H // 8 + 1, W // 8 + 1, 3).astype(np.float32)
        tex = resize_cubic(tex, H, W)
        img = np.clip(tex * 0.35 + rs.rand(3) * 0.25 + 0.1, 0, 1
                      ).astype(np.float32)
        seg = np.zeros((H, W), np.uint8)
        depth = np.full((H, W, 1), 0.8, np.float32)
        for _ in range(12):
            cls = rs.randint(1, self.n_classes)
            color = rs.rand(3).astype(np.float32)
            shape_mask = np.zeros((H, W), np.uint8)
            x0, y0 = rs.randint(0, W - 8), rs.randint(0, H - 8)
            w, h = rs.randint(6, W // 2), rs.randint(6, H // 2)
            x1, y1 = min(x0 + w, W - 1), min(y0 + h, H - 1)
            if rs.rand() < 0.5:
                fill_rectangle(shape_mask, (x0, y0), (x1, y1), 1)
                fill_rectangle(seg, (x0, y0), (x1, y1), int(cls))
                fill_rectangle(depth, (x0, y0), (x1, y1),
                               np.float32(rs.rand() * 0.8 + 0.1))
            else:
                r = max(3, min(w, h) // 2)
                c = (min(x0 + r, W - 1), min(y0 + r, H - 1))
                fill_circle(shape_mask, c, r, 1)
                fill_circle(seg, c, r, int(cls))
                fill_circle(depth, c, r, np.float32(rs.rand() * 0.8 + 0.1))
            # alpha-blend the shape so the background texture persists
            # inside it (descriptors need local signal everywhere)
            m = shape_mask[..., None].astype(np.float32) * 0.65
            img = img * (1 - m) + color[None, None] * m
        noise = rs.randn(H, W, 3).astype(np.float32) * 0.02
        out = {"image": np.clip(img + noise, 0, 1).astype(np.float32),
               "seg": seg}
        if self.with_depth:
            out["depth"] = depth
        return out
