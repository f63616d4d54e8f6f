"""Device prefetch, the counterpart of ``nanovs_slam_tpu/data/prefetch.py``:
a background thread runs the host pipeline (augments, homography sampling)
a few batches ahead, stages each batch in pinned host memory and copies it
to the card on a side stream, while the current step runs. On the CPU it
is the identity."""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterable, Iterator

import torch


def device_prefetch(iterator: Iterable[Dict[str, torch.Tensor]], device,
                    size: int = 2) -> Iterator[Dict[str, torch.Tensor]]:
    """Dicts of CPU tensors in, the same dicts on ``device`` out, ``size``
    batches ahead. A CUDA batch is handed over once its copy is ordered
    before the consumer's stream (an event), and its tensors are recorded
    on that stream, so the caching allocator does not reuse them early."""
    device = torch.device(device)
    if device.type != "cuda":
        yield from iterator
        return
    side = torch.cuda.Stream(device)
    q: "queue.Queue" = queue.Queue(maxsize=size)
    done = object()
    err: list = []

    def producer():
        try:
            for batch in iterator:
                pinned = {k: v.pin_memory() for k, v in batch.items()}
                with torch.cuda.stream(side):
                    moved = {k: v.to(device, non_blocking=True)
                             for k, v in pinned.items()}
                    ready = torch.cuda.Event()
                    ready.record(side)
                q.put((moved, ready, pinned))
        except Exception as e:  # surface producer failures to the consumer
            err.append(e)
        finally:
            q.put(done)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    while True:
        item = q.get()
        if item is done:
            thread.join()
            if err:
                raise err[0]
            return
        moved, ready, _ = item  # the pinned source lives until here
        stream = torch.cuda.current_stream(device)
        stream.wait_event(ready)
        for v in moved.values():
            v.record_stream(stream)
        yield moved
