"""Secondary dataset loaders, the counterparts of
``nanovs_slam_tpu/data/extra_datasets.py``: ``NYUv2Dataset`` (a copy, cv2
imported where images are read), for the depth evaluation. SceneParse150,
Tokyo 24/7 and the HF readers wait in ROADMAP Queue 1 item 4.

NYUv2 (reference src/data/nyuv2.py:339-373 extracted-files variant +
get_nyuv2_transforms :12-75): image|depth|seg{13,40}/{train,test} PNG
layout, depth clamp(min,max)/max with fixed max_depth.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, Tuple

import numpy as np


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
