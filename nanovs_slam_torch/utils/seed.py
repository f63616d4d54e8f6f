"""Deterministic seeding, the counterpart of
``nanovs_slam_tpu/utils/seed.py`` (reference set_seed, utils/utils.py:40-47:
torch/cuda/numpy/random/cv2): Python's ``random``, numpy's global
generator, torch's generators (every device's) and cv2's where cv2 is
installed."""

from __future__ import annotations

import random

import numpy as np
import torch


def set_seed(seed: int) -> torch.Generator:
    """Seeds the global generators; returns a CPU ``torch.Generator``
    seeded with ``seed``, the counterpart of the JAX root key."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)  # the CUDA generators too
    try:
        import cv2
    except ImportError:  # the card's machine has no cv2
        pass
    else:
        cv2.setRNGSeed(seed)
    return torch.Generator().manual_seed(seed)
