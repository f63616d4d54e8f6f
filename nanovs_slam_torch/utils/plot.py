"""Colormaps and result plots, the counterpart of
``nanovs_slam_tpu/utils/plot.py`` (numpy; matplotlib imported where a
figure is drawn, on its Agg backend):

- ``get_colormap`` / ``colorize_segmentation``: the segmentation colours
  (Cityscapes' for 19 classes, a golden-ratio HSV walk otherwise);
- ``results_bar_chart``: a bar chart of scalar metrics;
- ``plot_trajectory``: the estimated (and ground-truth) trajectory in the
  x-z plane, as ``vo_eval --plot`` writes it;
- ``latex_table``: a results table in LaTeX.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

# standard Cityscapes train-class colors (public label spec)
CITYSCAPES_COLORS = np.array([
    [128, 64, 128], [244, 35, 232], [70, 70, 70], [102, 102, 156],
    [190, 153, 153], [153, 153, 153], [250, 170, 30], [220, 220, 0],
    [107, 142, 35], [152, 251, 152], [70, 130, 180], [220, 20, 60],
    [255, 0, 0], [0, 0, 142], [0, 0, 70], [0, 60, 100], [0, 80, 100],
    [0, 0, 230], [119, 11, 32]], np.uint8)


def get_colormap(n_classes: int) -> np.ndarray:
    """(n_classes, 3) uint8 distinct colors (HSV walk)."""
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


def results_bar_chart(results: Dict[str, float], path: str,
                      title: str = "results"):
    """Bar chart of scalar metrics (plot_script.py analog)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    keys = [k for k, v in results.items() if isinstance(v, (int, float))]
    vals = [results[k] for k in keys]
    fig, ax = plt.subplots(figsize=(max(6, len(keys)), 4))
    ax.bar(range(len(keys)), vals)
    ax.set_xticks(range(len(keys)))
    ax.set_xticklabels(keys, rotation=45, ha="right")
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def plot_trajectory(trajectory, gt_trajectory=None, path: str = "traj.png"):
    """3D/2D trajectory plot (reference vo_eval.py trajectory plotting).
    trajectory: list of (3,1) or (3,) translations."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    t = np.asarray([np.asarray(p).reshape(3) for p in trajectory])
    fig = plt.figure(figsize=(7, 6))
    ax = fig.add_subplot(111)
    ax.plot(t[:, 0], t[:, 2], "-o", ms=2, label="estimated")
    if gt_trajectory is not None:
        g = np.asarray([np.asarray(p).reshape(3) for p in gt_trajectory])
        ax.plot(g[:, 0], g[:, 2], "-", label="ground truth")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.axis("equal")
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def latex_table(rows: List[Dict[str, float]], caption: str = "") -> str:
    """LaTeX results table (plot_script.py analog)."""
    if not rows:
        return ""
    keys = list(rows[0])
    lines = ["\\begin{table}[h]", "\\centering",
             "\\begin{tabular}{" + "l" * len(keys) + "}", "\\toprule",
             " & ".join(keys) + " \\\\", "\\midrule"]
    for r in rows:
        cells = [f"{r[k]:.4f}" if isinstance(r[k], float) else str(r[k])
                 for k in keys]
        lines.append(" & ".join(cells) + " \\\\")
    lines += ["\\bottomrule", "\\end{tabular}",
              f"\\caption{{{caption}}}", "\\end{table}"]
    return "\n".join(lines)
