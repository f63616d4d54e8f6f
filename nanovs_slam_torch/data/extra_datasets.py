"""Secondary dataset loaders, the counterparts of
``nanovs_slam_tpu/data/extra_datasets.py`` (copies; cv2 imported where
images are read, HF ``datasets`` where a dataset is resolved):

- NYUv2 (reference src/data/nyuv2.py:339-373 extracted-files variant +
  get_nyuv2_transforms :12-75): image|depth|seg{13,40}/{train,test} PNG
  layout, depth clamp(min,max)/max with fixed max_depth. ``NYUv2HFDataset``
  reads the HF variant (nyuv2.py:301-338, ``sayakpaul/nyu_depth_v2``).
- SceneParse150 (src/data/scene_parse_150.py): ADE20K-style images +
  annotations with the 150 -> 8 super-class remap (the reference's table,
  scene_parse_mapping.py:3-182); ``SceneParse150HFDataset`` reads the HF
  variant.
- Tokyo 24/7 (src/data/tokyo247.py): a NetVLAD dbStruct .mat read by
  ``data/pittsburgh.WholeDataset``, the root taken as an argument.

The HF readers take a live ``datasets.Dataset`` or a ``save_to_disk``
directory. Unlike the JAX package, the port does not download: a source
that is neither raises (``_resolve_hf_dataset``).
"""

from __future__ import annotations

import glob
import os
from typing import Dict, Tuple

import numpy as np


# ADE20K/SceneParse150 annotation ids (1-based; 0 = unlabeled) -> 8 super
# classes. This is DATA copied from the reference's table
# (src/data/scene_parse_mapping.py:3-182, class_to_index :158-167): every one
# of the 150 ids is explicitly assigned; there is no catch-all bucket.
SCENE_PARSE_CLASSES = ("None", "Person", "Vehicles", "Architecture",
                       "Furniture", "Nature", "Dynamic Stuff", "Static Stuff")
_SCENE_PARSE_GROUPS: Dict[int, Tuple[int, ...]] = {
    # Person
    1: (13,),
    # Vehicles
    2: (21, 77, 81, 84, 91, 103, 104, 117, 128),
    # Architecture
    3: (1, 2, 4, 6, 7, 9, 12, 15, 26, 33, 39, 43, 49, 53, 54, 55, 59, 60,
        62, 80, 92, 96, 122, 141),
    # Furniture
    4: (8, 11, 16, 19, 20, 24, 25, 28, 29, 31, 32, 34, 36, 37, 38, 40, 45,
        46, 48, 50, 51, 57, 58, 63, 64, 65, 66, 70, 71, 72, 74, 76, 86, 98,
        111, 118, 119, 134, 135, 136, 140, 146, 147, 148),
    # Nature
    5: (3, 5, 10, 14, 17, 18, 22, 27, 30, 35, 47, 61, 67, 69, 73, 95, 114,
        126, 129),
    # Dynamic Stuff
    6: (75, 79, 82, 90, 93, 97, 99, 106, 108, 109, 110, 112, 113, 115, 116,
        120, 121, 125, 127, 130, 132),
    # Static Stuff
    7: (23, 41, 42, 44, 52, 56, 68, 78, 83, 85, 87, 88, 89, 94, 100, 101,
        102, 105, 107, 123, 124, 131, 133, 137, 138, 139, 142, 143, 144,
        145, 149, 150),
}


def scene_parse_lut() -> np.ndarray:
    """256-entry LUT indexed by raw annotation id (only 0..150 occur).

    Matches reference get_mapping() (scene_parse_mapping.py:170-182):
    id 0 ("None") -> 0, every id 1..150 -> its super class; each id appears
    in exactly one group (asserted)."""
    lut = np.zeros(256, np.uint8)
    seen = set()
    for cls, ids in _SCENE_PARSE_GROUPS.items():
        for i in ids:
            assert i not in seen, f"duplicate scene-parse id {i}"
            seen.add(i)
            lut[i] = cls
    assert len(seen) == 150, f"expected 150 mapped ids, got {len(seen)}"
    return lut


class NYUv2Dataset:
    """NYUv2 extracted-files dataset (reference NYUv2Dataset_extracted,
    nyuv2.py:339-373): image/{split}, depth/{split}, seg{13|40}/{split}
    PNG folders; n_classes in (13, 40).

    Value transforms mirror get_nyuv2_transforms (nyuv2.py:12-75):
    - image resized bilinear, scaled to [0, 1] (the [-1,1] shift and
      homography-pair generation happen in the shared device pipeline).
    - seg resized NEAREST, raw class ids.
    - depth resized NEAREST, then clamp(min_depth, max_depth)/max_depth
      (nyuv2.py:70 — a FIXED max_depth of 5000 for the uint16 millimetre
      PNGs, not per-image normalization).
    """

    def __init__(self, root: str, size: Tuple[int, int],
                 n_seg_classes: int = 13, split: str = "train",
                 max_depth: float = 5000.0, min_depth: float = 0.0):
        assert n_seg_classes in (13, 40), n_seg_classes
        assert split in ("train", "test"), split
        self.size = size
        self.max_depth = max_depth
        self.min_depth = min_depth

        def listing(kind):
            p = os.path.join(root, kind, split)
            if not os.path.isdir(p):  # flat layout fallback
                p = os.path.join(root, kind)
            return sorted(glob.glob(os.path.join(p, "*.png")) or
                          glob.glob(os.path.join(p, "*")))

        self.rgb = listing("image") or listing("rgb")
        self.seg = listing(f"seg{n_seg_classes}")
        self.depth = listing("depth")

    def __len__(self):
        return len(self.rgb)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        import cv2

        H, W = self.size
        img = cv2.cvtColor(cv2.imread(self.rgb[i]), cv2.COLOR_BGR2RGB)
        img = cv2.resize(img, (W, H)).astype(np.float32) / 255.0
        out = {"image": img}
        if i < len(self.seg):
            seg = cv2.imread(self.seg[i], cv2.IMREAD_GRAYSCALE)
            out["seg"] = cv2.resize(seg, (W, H),
                                    interpolation=cv2.INTER_NEAREST)
        else:
            out["seg"] = np.zeros((H, W), np.uint8)
        if i < len(self.depth):
            d = cv2.imread(self.depth[i], cv2.IMREAD_UNCHANGED)
            d = cv2.resize(d.astype(np.float32), (W, H),
                           interpolation=cv2.INTER_NEAREST)
            d = np.clip(d, self.min_depth, self.max_depth) / self.max_depth
            out["depth"] = d[..., None].astype(np.float32)
        return out


class SceneParse150Dataset:
    """ADE20K/SceneParse150 images/ + annotations/ with the 150->8 remap."""

    def __init__(self, root: str, size: Tuple[int, int],
                 split: str = "training"):
        self.size = size
        self.lut = scene_parse_lut()
        self.images = sorted(glob.glob(
            os.path.join(root, "images", split, "*.jpg")))
        self.masks = [p.replace(os.sep + "images" + os.sep,
                                os.sep + "annotations" + os.sep)
                      .replace(".jpg", ".png") for p in self.images]
        pairs = [(i, m) for i, m in zip(self.images, self.masks)
                 if os.path.exists(m)]
        self.images = [p[0] for p in pairs]
        self.masks = [p[1] for p in pairs]

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        import cv2

        H, W = self.size
        img = cv2.cvtColor(cv2.imread(self.images[i]), cv2.COLOR_BGR2RGB)
        img = cv2.resize(img, (W, H)).astype(np.float32) / 255.0
        seg = cv2.imread(self.masks[i], cv2.IMREAD_GRAYSCALE)
        seg = cv2.resize(seg, (W, H), interpolation=cv2.INTER_NEAREST)
        return {"image": img, "seg": self.lut[seg]}


def _resolve_hf_dataset(source, hub_name: str, split: str):
    """The reference's caching protocol (nyuv2.py:309-326) without its
    download: a live ``datasets.Dataset`` is used as it is, a directory
    that ``save_to_disk`` wrote (``<source>/<split>``) is loaded from disk;
    anything else raises, where the JAX package would fetch ``hub_name``
    from the hub."""
    if not isinstance(source, (str, os.PathLike)):
        return source  # already a datasets.Dataset
    local = os.path.join(str(source), split)
    if not os.path.isdir(local):
        raise FileNotFoundError(
            f"{local}: no save_to_disk copy of {hub_name} ({split}); the "
            "port does not download datasets from the hub")
    import datasets as hf_datasets

    return hf_datasets.load_from_disk(local)


def _to_float_image(img, size: Tuple[int, int]) -> np.ndarray:
    """PIL image or HWC array -> float32 RGB HxWx3 in [0, 1], resized."""
    import cv2

    H, W = size
    arr = np.asarray(img)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, -1)
    arr = cv2.resize(arr.astype(np.float32), (W, H))
    if arr.max() > 1.5:  # uint8-scaled input
        arr = arr / 255.0
    return arr.astype(np.float32)


class NYUv2HFDataset:
    """HF-hub NYUv2 (reference NYUv2Dataset, nyuv2.py:301-338:
    `sayakpaul/nyu_depth_v2`, splits train/validation, fields image +
    depth_map). `source` is either the reference's save_to_disk directory
    or a live `datasets.Dataset`. depth_map is renamed to depth
    (nyuv2.py:336) and normalized clamp(min,max)/max like
    get_nyuv2_transforms (nyuv2.py:70); the hub depth is float metres, so
    the metre-scale default max_depth is 10.0."""

    def __init__(self, source, size: Tuple[int, int], split: str = "train",
                 max_depth: float = 10.0, min_depth: float = 0.0):
        assert split in ("train", "validation"), split
        self.dataset = _resolve_hf_dataset(source, "sayakpaul/nyu_depth_v2",
                                           split)
        self.size = size
        self.max_depth = max_depth
        self.min_depth = min_depth

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        import cv2

        H, W = self.size
        sample = self.dataset[int(i)]
        out = {"image": _to_float_image(sample["image"], self.size)}
        d = np.asarray(sample["depth_map"], np.float32)
        d = cv2.resize(d, (W, H), interpolation=cv2.INTER_NEAREST)
        d = np.clip(d, self.min_depth, self.max_depth) / self.max_depth
        out["depth"] = d[..., None].astype(np.float32)
        if "annotation" in sample:  # hub NYUv2 has no seg; keep schema stable
            seg = np.asarray(sample["annotation"], np.uint8)
            out["seg"] = cv2.resize(seg, (W, H),
                                    interpolation=cv2.INTER_NEAREST)
        else:
            out["seg"] = np.zeros((H, W), np.uint8)
        return out


class SceneParse150HFDataset:
    """HF-hub SceneParse150 (reference scene_parse_150.py:183-259:
    `load_dataset("scene_parse_150")`, fields image + annotation, splits
    train/validation; n_classes 150 keeps raw ids, 7 applies the
    get_mapping() LUT — the same 8-super-class table as the folder
    variant; the reference's photometric/affine augmentation lives in the
    shared device pipeline here, not in the loader)."""

    def __init__(self, source, size: Tuple[int, int], split: str = "train",
                 n_classes: int = 7):
        assert split in ("train", "validation"), split
        assert n_classes in (150, 7), n_classes
        self.dataset = _resolve_hf_dataset(source, "scene_parse_150", split)
        self.size = size
        self.lut = scene_parse_lut() if n_classes == 7 else None

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        import cv2

        H, W = self.size
        sample = self.dataset[int(i)]
        img = _to_float_image(sample["image"], self.size)
        seg = np.asarray(sample["annotation"], np.uint8)
        seg = cv2.resize(seg, (W, H), interpolation=cv2.INTER_NEAREST)
        if self.lut is not None:
            seg = self.lut[seg]
        return {"image": img, "seg": seg}


def tokyo247_dataset(root: str, size: Tuple[int, int],
                     struct_name: str = "tokyo247.mat"):
    """Tokyo 24/7 via the shared NetVLAD dbStruct machinery."""
    from .pittsburgh import WholeDataset

    struct = os.path.join(root, "datasets", struct_name)
    return WholeDataset(struct, root, size)
