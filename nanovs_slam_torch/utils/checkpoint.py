"""Reading pinned ``.npz`` checkpoints with numpy alone.

A pinned checkpoint (``pinned/extractor_S8.npz``) stores a flax pytree with
``/``-joined keys plus a ``__meta__`` JSON blob. This is a copy of the
JAX package's ``load_npz_checkpoint`` and ``_unflatten``, so that the port
reads the same files without importing JAX.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Tuple

import numpy as np


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict:
    tree: Dict[str, Any] = {}
    for k, v in flat.items():
        parts = k.split("/")
        d = tree
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return tree


def load_npz_checkpoint(path: str) -> Tuple[Dict, Dict]:
    """Returns (tree, meta) of a pinned ``.npz`` checkpoint."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    meta = {}
    raw = flat.pop("__meta__", None)
    if raw is not None:
        meta = json.loads(raw.tobytes().decode())
    return _unflatten(flat), meta
