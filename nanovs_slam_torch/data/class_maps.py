"""Class-remapping tables, a copy of ``nanovs_slam_tpu/data/class_maps.py``
(numpy only), so that the port does not import the JAX package.

- COCOSTUFF_183_TO_28: the reference's 183-class COCO-Stuff -> 28
  super-class lookup (data values from src/data/cocostuff_mapping.json,
  applied via a 256-entry LUT like dataset_utils.py:151-158; unmapped ids
  -> 0).
- CITYSCAPES_ID_TO_TRAIN_ID: the standard Cityscapes labelIds -> 19
  train ids (public cityscapesScripts table; reference uses
  torchvision's classes with non-train ids mapped to 255,
  cityscapes.py:11-20,194-203).
"""

from __future__ import annotations

import numpy as np

COCOSTUFF_183_TO_28 = [
    0, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 2, 3, 3, 3, 3, 3, 3, 3, 3, 3,
    3, 4, 4, 4, 4, 4, 4, 4, 4, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 6, 6, 6, 6, 6,
    6, 6, 6, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 11, 11, 20, 11, 11, 11, 14, 11,
    11, 26, 10, 10, 10, 10, 10, 10, 9, 9, 9, 9, 9, 9, 8, 8, 8, 8, 8, 10, 8,
    8, 13, 13, 20, 19, 19, 20, 11, 19, 12, 15, 16, 16, 13, 13, 21, 11, 11,
    13, 11, 22, 26, 19, 15, 15, 15, 15, 15, 20, 23, 7, 7, 11, 22, 22, 22,
    24, 18, 20, 11, 13, 12, 25, 20, 24, 22, 13, 19, 12, 22, 13, 20, 12, 22,
    22, 19, 24, 23, 22, 24, 18, 13, 7, 22, 23, 11, 21, 18, 22, 24, 27, 24,
    6, 19, 11, 18, 13, 13, 20, 7, 17, 17, 17, 17, 17, 17, 17, 23, 23, 23,
    23, 24, 25,
]


def cocostuff_lut() -> np.ndarray:
    """256-entry uint8 LUT for mask remapping (unmapped ids -> 0)."""
    lut = np.zeros(256, np.uint8)
    lut[: len(COCOSTUFF_183_TO_28)] = COCOSTUFF_183_TO_28
    return lut


# labelId -> trainId (255 = ignore), from the public Cityscapes label spec
CITYSCAPES_ID_TO_TRAIN_ID = {
    7: 0, 8: 1, 11: 2, 12: 3, 13: 4, 17: 5, 19: 6, 20: 7, 21: 8, 22: 9,
    23: 10, 24: 11, 25: 12, 26: 13, 27: 14, 28: 15, 31: 16, 32: 17, 33: 18,
}


def cityscapes_lut() -> np.ndarray:
    lut = np.full(256, 255, np.uint8)
    for k, v in CITYSCAPES_ID_TO_TRAIN_ID.items():
        lut[k] = v
    return lut


def remap_mask(mask: np.ndarray, lut: np.ndarray) -> np.ndarray:
    return lut[mask.astype(np.int64).clip(0, 255)]
