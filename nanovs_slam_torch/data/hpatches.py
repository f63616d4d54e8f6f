"""HPatches homography-pair dataset for keypoint evaluation, a copy of
``nanovs_slam_tpu/data/hpatches.py`` (cv2 is imported where images are
read, and ``ensure_synthetic_hpatches`` names cv2 where it is missing).

Behavioral contract (reference: src/data/patches_dataset.py:38-195):
per sequence folder (i_* illumination / v_* viewpoint), 5 pairs
(1.ppm vs {2..6}.ppm) with ground-truth H_1_N homographies; homographies
rescaled to the eval resolution via scale_homography (post-multiply the
inverse source scale, pre-multiply the target scale, :100-109); images
resized and normalized to [-1, 1] (:15-35).
"""

from __future__ import annotations

import glob
import os
from typing import Dict, Iterator, Tuple

import numpy as np


def scale_homography(homography: np.ndarray, original_scale, new_scale,
                     pre: bool) -> np.ndarray:
    scales = np.divide(new_scale, original_scale)
    if pre:
        s = np.diag(np.append(scales, 1.0))
        return s @ homography
    sinv = np.diag(np.append(1.0 / scales, 1.0))
    return homography @ sinv


_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def ensure_synthetic_hpatches(root: str = "fixtures/hpatches_synth",
                              seed: int = 0) -> str:
    """Generate (once, deterministically) the discriminative synthetic
    HPatches fixture — 8 texture families x 5 graded-strength warps = 40
    pairs (scripts/make_synthetic_hpatches.py). Used as the keypoint-eval
    fallback when no real HPatches checkout is configured; the fixture is
    seeded so every machine regenerates identical data."""
    # anchor relative roots to the repo dir, not the CWD — running eval
    # from elsewhere would silently regenerate the fixture (ADVICE r3)
    if not os.path.isabs(root):
        root = os.path.join(_REPO, root)
    marker = os.path.join(root, "v_synth07", "H_1_6")
    if not os.path.exists(marker):
        import subprocess
        import sys as _sys

        try:
            import cv2  # noqa: F401  (the script draws and writes with it)
        except ImportError as e:
            raise RuntimeError(
                "the synthetic HPatches fixture needs cv2 "
                "(scripts/make_synthetic_hpatches.py), which is not "
                f"installed ({e}); configure hpatches_data_path instead"
                ) from e
        script = os.path.join(_REPO, "scripts", "make_synthetic_hpatches.py")
        subprocess.run([_sys.executable, script, root, "--seed", str(seed)],
                       check=True)
    return root


class HPatchesDataset:
    """Yields {image, image_aug (1,H,W,3) in [-1,1], homography (3,3)}."""

    def __init__(self, root: str, output_shape: Tuple[int, int],
                 seq_type: str = "a"):
        """output_shape = (W, H) like the reference's img_shape;
        seq_type: 'i' | 'v' | 'a' (all)."""
        self.output_shape = output_shape  # (W, H)
        self.items = []
        for path in sorted(glob.glob(os.path.join(root, "*"))):
            if not os.path.isdir(path):
                continue
            stem = os.path.basename(path)
            if seq_type in ("i", "v") and not stem.startswith(seq_type):
                continue
            for i in range(2, 7):
                img1 = os.path.join(path, "1.ppm")
                imgN = os.path.join(path, f"{i}.ppm")
                h = os.path.join(path, f"H_1_{i}")
                if all(os.path.exists(p) for p in (img1, imgN, h)):
                    self.items.append((img1, imgN, h))

    def __len__(self):
        return len(self.items)

    def _load(self, path: str) -> Tuple[np.ndarray, Tuple[int, int]]:
        import cv2

        img = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
        orig = img.shape[:2][::-1]  # (W, H)
        W, H = self.output_shape
        img = cv2.resize(img, (W, H)).astype(np.float32) / 255.0
        return img * 2.0 - 1.0, orig

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        img1_p, imgN_p, h_p = self.items[idx]
        img, orig1 = self._load(img1_p)
        warped, orig2 = self._load(imgN_p)
        H = np.loadtxt(h_p)
        H = scale_homography(H, orig1, self.output_shape, pre=False)
        H = scale_homography(H, orig2, self.output_shape, pre=True)
        return {"image": img[None], "image_aug": warped[None],
                "homography": H, "index": idx}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        for i in range(len(self)):
            yield self[i]
