"""Metric logging to ``metrics.jsonl``, the counterpart of
``nanovs_slam_tpu/utils/logging.py`` without its wandb sink (the CLIs
refuse ``--wandb``), and its ``print_table`` (a copy)."""

from __future__ import annotations

import json
import time
from typing import Dict, Optional


class MetricLogger:
    def __init__(self, config: Optional[Dict] = None,
                 jsonl_path: str = "metrics.jsonl"):
        self.jsonl_path = jsonl_path
        if config is not None:
            self._append({"_config": config, "_t": time.time()})

    def _append(self, blob: Dict):
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(blob, default=str) + "\n")

    def log_dict(self, prefix: str, metrics: Dict, step: int = 0):
        flat = {f"{prefix}{k}": (float(v) if hasattr(v, "__float__") else v)
                for k, v in metrics.items()}
        self._append({"step": step, **flat, "_t": time.time()})


def print_table(results: Dict, title: str = "results"):
    """Markdown-style results table (utils/utils.py:68-83 analog)."""
    keys = list(results)
    print(f"\n### {title}")
    print("| " + " | ".join(keys) + " |")
    print("|" + "---|" * len(keys))
    vals = []
    for k in keys:
        v = results[k]
        vals.append(f"{v:.4f}" if isinstance(v, float) else str(v))
    print("| " + " | ".join(vals) + " |\n")
