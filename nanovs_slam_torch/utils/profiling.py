"""Profiling and timing, the counterpart of
``nanovs_slam_tpu/utils/profiling.py``:

- ``trace``: a context around ``torch.profiler`` (CPU and, where there is
  one, the card) that writes a Chrome / Perfetto trace into ``logdir``;
- ``timing``: a wall-time decorator that waits for the card's queued work
  before it reads the clock (the reference's ``timing_decorator``, honest
  on an asynchronous device);
- ``StepTimer``: per-step latency samples with their mean, p50, p95 and
  rate;
- ``chained_device_time``: the device time of a step by the slope of two
  chain lengths, each chain queued behind a spin kernel and timed by CUDA
  events (as ``chip_smoke.cuda_ms`` times kernels), so that neither the
  host's launches nor a fixed cost enter it; on the CPU the same
  differential on the host's clock.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(logdir: str = "torch-trace"):
    """Profile the block (CPU activity, and the card's where CUDA is
    available); yields the profiler. On exit the trace is written to
    ``logdir/trace.json`` (open it in Perfetto or chrome://tracing)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        _sync()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def timing(func: Callable) -> Callable:
    """Print the wall time of each call of ``func``, after the card has
    finished the work it queued."""

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        result = func(*args, **kwargs)
        _sync()
        print(f"Execution time of {func.__name__}: "
              f"{time.perf_counter() - t0:.4f} seconds")
        return result

    return wrapper


class StepTimer:
    """Latency samples by name (``measure``) and their statistics."""

    def __init__(self):
        self._samples: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def measure(self, name: str):
        t0 = time.perf_counter()
        yield
        self._samples.setdefault(name, []).append(
            time.perf_counter() - t0)

    def stats(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, s in self._samples.items():
            a = np.asarray(s)
            out[name] = {"mean_ms": float(a.mean() * 1e3),
                         "p50_ms": float(np.percentile(a, 50) * 1e3),
                         "p95_ms": float(np.percentile(a, 95) * 1e3),
                         "fps": float(1.0 / max(a.mean(), 1e-9)),
                         "n": len(s)}
        return out


def _chain_seconds(step_fn, example: torch.Tensor, n: int) -> float:
    """Seconds of ``n`` chained steps: CUDA events behind a spin kernel
    on the card (the spin doubled until the host has queued the chain
    before the device reaches it), the host's clock on the CPU."""
    carry = torch.zeros((), dtype=example.dtype, device=example.device)
    if example.device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(n):
            carry = step_fn(example + carry * 1e-20)
        float(carry)
        return time.perf_counter() - t0
    spin = 5_000_000
    while True:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        c = carry
        for _ in range(n):
            c = step_fn(example + c * 1e-20)
        late = start.query()
        end.record()
        end.synchronize()
        if not late:
            return start.elapsed_time(end) / 1e3
        if spin >= 2 ** 30:
            raise RuntimeError("chained_device_time: the host never got "
                               "ahead of the device")
        spin *= 2


def chained_device_time(step_fn: Callable[[torch.Tensor], torch.Tensor],
                        example: torch.Tensor, n_lo: int = 5,
                        n_hi: int = 30, repeats: int = 3
                        ) -> Tuple[float, float]:
    """(device seconds a step, the chain's fixed seconds) of
    ``step_fn(x) -> scalar tensor`` (depending on all its outputs),
    chained as ``x = example + carry * 1e-20`` so that each step waits for
    the last: the slope between ``n_lo`` and ``n_hi`` steps (the least of
    ``repeats`` timings each) cancels whatever a chain costs once."""
    for _ in range(2):
        _chain_seconds(step_fn, example, 1)  # warm-up
    t_lo = min(_chain_seconds(step_fn, example, n_lo)
               for _ in range(repeats))
    t_hi = min(_chain_seconds(step_fn, example, n_hi)
               for _ in range(repeats))
    dev = (t_hi - t_lo) / (n_hi - n_lo)
    return dev, max(t_lo - n_lo * dev, 0.0)
