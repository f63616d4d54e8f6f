"""VO input sources (frame streams), a copy of
``nanovs_slam_tpu/vo/datasets.py``; cv2 is imported inside the classes.

Behavioral contract (reference: src/visual_odometry/dataset.py):
- VideoDataset (:127): cv2.VideoCapture stream.
- FolderDataset (:183): ordered image files.
- FolderDatasetParallel (:229): background-thread prefetch of the folder
  stream (queue-based double buffering).
- Webcam (:299): live capture with a reader thread.
- KittiDataset (:346-425): sequences/NN/image_{0,2}/*.png + times.txt.
- TumDataset (:428): rgb/ folder + rgb.txt timestamps.
- dataset_factory (:41): name -> class.
All yield RGB uint8 frames (H, W, 3) plus optional timestamps.
"""

from __future__ import annotations

import glob
import os
import queue
import threading
from typing import Iterator, Optional

import numpy as np


class VideoDataset:
    def __init__(self, path: str):
        import cv2

        self.cap = cv2.VideoCapture(path)
        if not self.cap.isOpened():
            raise FileNotFoundError(path)
        self.fps = self.cap.get(cv2.CAP_PROP_FPS) or 30.0

    def __iter__(self) -> Iterator[np.ndarray]:
        import cv2

        while True:
            ret, frame = self.cap.read()
            if not ret:
                break
            yield cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)


class FolderDataset:
    def __init__(self, path: str, pattern: str = "*"):
        self.files = sorted(glob.glob(os.path.join(path, pattern)))
        if not self.files:
            raise FileNotFoundError(f"no frames in {path}")

    def __len__(self):
        return len(self.files)

    def __iter__(self) -> Iterator[np.ndarray]:
        import cv2

        for f in self.files:
            img = cv2.imread(f)
            if img is not None:
                yield cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


class FolderDatasetParallel(FolderDataset):
    """Background-thread prefetch (reference dataset.py:229-298) — decodes
    frame t+1 while the device processes frame t."""

    def __init__(self, path: str, pattern: str = "*", queue_size: int = 4):
        super().__init__(path, pattern)
        self.queue_size = queue_size

    def __iter__(self) -> Iterator[np.ndarray]:
        import cv2

        q: "queue.Queue" = queue.Queue(maxsize=self.queue_size)
        SENTINEL = object()

        def reader():
            for f in self.files:
                img = cv2.imread(f)
                if img is not None:
                    q.put(cv2.cvtColor(img, cv2.COLOR_BGR2RGB))
            q.put(SENTINEL)

        t = threading.Thread(target=reader, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is SENTINEL:
                break
            yield item


class KittiDataset:
    """KITTI odometry: <root>/sequences/<seq>/image_{cam}/*.png."""

    def __init__(self, root: str, sequence: str = "06", cam: int = 0):
        seq_dir = os.path.join(root, "sequences", sequence)
        self.files = sorted(glob.glob(
            os.path.join(seq_dir, f"image_{cam}", "*.png")))
        if not self.files:
            raise FileNotFoundError(seq_dir)
        times_path = os.path.join(seq_dir, "times.txt")
        self.times: Optional[np.ndarray] = None
        if os.path.exists(times_path):
            self.times = np.loadtxt(times_path)

    def __len__(self):
        return len(self.files)

    def __iter__(self) -> Iterator[np.ndarray]:
        import cv2

        for f in self.files:
            img = cv2.imread(f)
            yield cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


class TumDataset:
    """TUM RGB-D: <root>/rgb.txt listing 'timestamp path' per line."""

    def __init__(self, root: str):
        self.root = root
        list_path = os.path.join(root, "rgb.txt")
        self.items: list = []
        with open(list_path) as f:
            for line in f:
                if line.startswith("#"):
                    continue
                parts = line.split()
                if len(parts) >= 2:
                    self.items.append((float(parts[0]), parts[1]))

    def __len__(self):
        return len(self.items)

    def __iter__(self) -> Iterator[np.ndarray]:
        import cv2

        for _, rel in self.items:
            img = cv2.imread(os.path.join(self.root, rel))
            if img is not None:
                yield cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


class Webcam:
    def __init__(self, device: int = 0, queue_size: int = 2):
        import cv2

        self.cap = cv2.VideoCapture(device)
        self.queue_size = queue_size

    def __iter__(self) -> Iterator[np.ndarray]:
        import cv2

        q: "queue.Queue" = queue.Queue(maxsize=self.queue_size)

        def reader():
            while True:
                ret, frame = self.cap.read()
                if not ret:
                    break
                try:
                    q.put_nowait(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
                except queue.Full:
                    pass

        threading.Thread(target=reader, daemon=True).start()
        while True:
            yield q.get()


def dataset_factory(kind: str, path: str, **kw):
    """(reference dataset.py:41)"""
    return {"video": VideoDataset, "folder": FolderDataset,
            "folder_parallel": FolderDatasetParallel,
            "kitti": KittiDataset, "tum": TumDataset,
            "webcam": Webcam}[kind](path, **kw)
