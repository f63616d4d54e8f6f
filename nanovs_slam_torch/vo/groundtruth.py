"""KITTI poses ground truth, a copy of ``nanovs_slam_tpu/vo/groundtruth.py``
(reference: src/visual_odometry/groundtruth.py): KITTI pose files (12 floats
a line, a 3x4 [R|t]), frame-to-frame absolute scale and (t, R).
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np


class KittiVideoGroundTruth:
    def __init__(self, path: str, name: str):
        self.scale = 1.0
        self.filename = os.path.join(path, name)
        with open(self.filename) as f:
            self.data = f.readlines()

    def _line(self, frame_id: int):
        return self.data[frame_id].strip().split()

    def get_pose_and_absolute_scale(self, frame_id: int):
        """(groundtruth.py:48-62): scale = |t(frame) - t(frame-1)|."""
        ss = self._line(frame_id - 1)
        prev = np.array([float(ss[3]), float(ss[7]), float(ss[11])])
        ss = self._line(frame_id)
        cur = np.array([float(ss[3]), float(ss[7]), float(ss[11])])
        cur = cur * self.scale
        prev = prev * self.scale
        abs_scale = float(np.linalg.norm(cur - prev))
        return cur[0], cur[1], cur[2], abs_scale

    # reference-compatible alias
    getPoseAndAbsoluteScale = get_pose_and_absolute_scale

    def extract_pose_values(self, frame_id: int
                            ) -> Tuple[np.ndarray, np.ndarray]:
        vals = [float(v) for v in self._line(frame_id)]
        pose = np.reshape(vals, (3, 4))
        return pose[:, 3] * self.scale, pose[:, :3]

    def __len__(self):
        return len(self.data)
