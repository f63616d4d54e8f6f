"""Debug visualization for eval runs, a copy of
``nanovs_slam_tpu/utils/debug_viz.py`` (cv2 imported inside the functions
that draw; the class colormap, from the JAX ``utils/plot.py``, is copied
here) (reference `--debug` flag surface,
eval_multitask "Use the debug flag to get a visual output of the model's
predictions", README.md:127-131).

The reference pops cv2.imshow windows; this framework runs headless on
accelerator hosts, so --debug SAVES the same content to --result_dir instead:
keypoint overlays and colorized segmentation prediction/GT panels.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

# standard Cityscapes train-class colors (public label spec)
CITYSCAPES_COLORS = np.array([
    [128, 64, 128], [244, 35, 232], [70, 70, 70], [102, 102, 156],
    [190, 153, 153], [153, 153, 153], [250, 170, 30], [220, 220, 0],
    [107, 142, 35], [152, 251, 152], [70, 130, 180], [220, 20, 60],
    [255, 0, 0], [0, 0, 142], [0, 0, 70], [0, 60, 100], [0, 80, 100],
    [0, 0, 230], [119, 11, 32]], np.uint8)


def _to_uint8_rgb(image: np.ndarray) -> np.ndarray:
    """Accepts (H, W, 3) float in [0,1] or [-1,1] (model input range),
    or uint8; returns uint8 RGB."""
    img = np.asarray(image)
    if img.ndim == 4:
        img = img[0]
    if img.dtype == np.uint8:
        return img
    img = img.astype(np.float32)
    if img.min() < -0.01:  # [-1, 1] model input range
        img = (img + 1.0) / 2.0
    return (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)


def get_colormap(n_classes: int) -> np.ndarray:
    """(n_classes, 3) uint8 distinct colors (HSV walk; Cityscapes' own
    colors for 19 classes), the JAX ``utils/plot.get_colormap``."""
    if n_classes == 19:
        return CITYSCAPES_COLORS
    import colorsys

    colors = []
    for i in range(n_classes):
        h = (i * 0.618033988749895) % 1.0
        r, g, b = colorsys.hsv_to_rgb(h, 0.75, 0.95 if i else 0.3)
        colors.append([int(r * 255), int(g * 255), int(b * 255)])
    return np.array(colors, np.uint8)


def colorize_segmentation(seg: np.ndarray, n_classes: int) -> np.ndarray:
    """(H, W) class map -> (H, W, 3) uint8 color image."""
    cmap = get_colormap(n_classes)
    return cmap[np.clip(seg, 0, n_classes - 1)]


def save_keypoint_debug(path: str, image, kps: np.ndarray,
                        scores: Optional[np.ndarray] = None,
                        top_k: int = 300) -> str:
    """Draw keypoints (red dots, reference demo style) on the image and
    write a PNG. kps (N, 2) in image pixels; optionally ranked by score."""
    import cv2

    vis = cv2.cvtColor(_to_uint8_rgb(image), cv2.COLOR_RGB2BGR).copy()
    kps = np.asarray(kps).reshape(-1, 2)
    if scores is not None and len(kps) > top_k:
        kps = kps[np.argsort(-np.asarray(scores).reshape(-1))[:top_k]]
    h, w = vis.shape[:2]
    for x, y in kps.astype(int):
        if 0 <= x < w and 0 <= y < h:
            cv2.circle(vis, (int(x), int(y)), 2, (0, 0, 255), -1)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    cv2.imwrite(path, vis)
    return path


def save_pair_debug(path: str, image0, image1, kps0: np.ndarray,
                    kps1: np.ndarray,
                    kps0_warped: Optional[np.ndarray] = None,
                    scores0: Optional[np.ndarray] = None,
                    scores1: Optional[np.ndarray] = None,
                    top_k: int = 300) -> str:
    """Training-pair panel (reference trainer debug,
    KeypointNetwithIOLoss.py:607-779): source | target side by side,
    detected keypoints in red on each; source keypoints warped by the pair
    homography drawn as green circles on the target, so detector/homography
    alignment is visible at a glance."""
    import cv2

    def draw(img, kps, scores):
        vis = cv2.cvtColor(_to_uint8_rgb(img), cv2.COLOR_RGB2BGR).copy()
        kps = np.asarray(kps).reshape(-1, 2)
        if scores is not None and len(kps) > top_k:
            kps = kps[np.argsort(-np.asarray(scores).reshape(-1))[:top_k]]
        h, w = vis.shape[:2]
        for x, y in kps.astype(int):
            if 0 <= x < w and 0 <= y < h:
                cv2.circle(vis, (int(x), int(y)), 2, (0, 0, 255), -1)
        return vis

    left = draw(image0, kps0, scores0)
    right = draw(image1, kps1, scores1)
    if kps0_warped is not None:
        h, w = right.shape[:2]
        warped = np.asarray(kps0_warped).reshape(-1, 2)
        if scores0 is not None and len(warped) > top_k:
            order = np.argsort(-np.asarray(scores0).reshape(-1))[:top_k]
            warped = warped[order]
        for x, y in warped.astype(int):
            if 0 <= x < w and 0 <= y < h:
                cv2.circle(right, (int(x), int(y)), 3, (0, 255, 0), 1)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    cv2.imwrite(path, np.hstack([left, right]))
    return path


def save_seg_debug(path: str, image, seg_pred: np.ndarray,
                   seg_gt: Optional[np.ndarray] = None,
                   n_classes: int = 28) -> str:
    """Side-by-side panel: input | colorized prediction [| colorized GT]
    (ignore label 255 shown black)."""
    import cv2

    img = cv2.cvtColor(_to_uint8_rgb(image), cv2.COLOR_RGB2BGR)
    h, w = img.shape[:2]

    def colorize(seg):
        seg = np.asarray(seg).squeeze()
        col = colorize_segmentation(np.where(seg == 255, 0, seg), n_classes)
        col = np.where((seg == 255)[..., None], 0, col).astype(np.uint8)
        col = cv2.resize(col, (w, h), interpolation=cv2.INTER_NEAREST)
        return cv2.cvtColor(col, cv2.COLOR_RGB2BGR)

    panels = [img, colorize(seg_pred)]
    if seg_gt is not None:
        panels.append(colorize(seg_gt))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    cv2.imwrite(path, np.hstack(panels))
    return path
