"""Bringing up a group of ranks, the counterpart of
``nanovs_slam_tpu/parallel/distributed.py``.

JAX runs one process a host over all of its chips; here every rank is a
process with one device (several ranks may share a card over gloo). The
pieces:

1. ``initialize``: ``torch.distributed.init_process_group`` with a finite
   timeout (a lost rank raises instead of hanging), a no-op for one
   process; torchrun, SLURM and Open MPI environments are read as the JAX
   ``_pod_env_detected`` recognises them;
2. ``global_mesh``: the mesh over every rank;
3. ``host_local_batch_to_global``: each rank passes its own shard of the
   global batch and gets it on its device (no data moves between ranks);
4. ``spawn``: runs a function on N local ranks (start method "spawn", as
   CUDA needs), each with its process group and mesh, and returns what
   each rank returned; a failed rank, or a group past its deadline, fails
   the call.
"""

from __future__ import annotations

import datetime
import os
import queue as queue_mod
import socket
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh, _tree_map, make_mesh

DEFAULT_TIMEOUT_S = 300.0


def _env_int(name: str) -> Optional[int]:
    try:
        return int(os.environ[name])
    except (KeyError, ValueError):
        return None


def _pod_env() -> Optional[tuple]:
    """(rank, world size) from a multi-process launcher's environment:
    torchrun (RANK / WORLD_SIZE), SLURM (SLURM_PROCID / SLURM_NTASKS) or
    Open MPI (OMPI_COMM_WORLD_RANK / _SIZE); None for a single process.
    Empty or malformed leftovers do not count, as in the JAX package."""
    for rank_var, size_var in (("RANK", "WORLD_SIZE"),
                               ("SLURM_PROCID", "SLURM_NTASKS"),
                               ("OMPI_COMM_WORLD_RANK",
                                "OMPI_COMM_WORLD_SIZE")):
        size = _env_int(size_var)
        if size is not None and size > 1:
            return _env_int(rank_var) or 0, size
    return None


def local_rank() -> int:
    """This process's index on its host under a launcher (torchrun's
    LOCAL_RANK, SLURM_LOCALID, OMPI_COMM_WORLD_LOCAL_RANK), else 0."""
    for var in ("LOCAL_RANK", "SLURM_LOCALID", "OMPI_COMM_WORLD_LOCAL_RANK"):
        v = _env_int(var)
        if v is not None:
            return v
    return 0


def default_backend(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               backend: Optional[str] = None, device=None,
               timeout: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the process group of ``num_processes`` ranks at
    ``coordinator_address`` ("host:port") as rank ``process_id``, or the
    one a launcher's environment describes (torchrun's MASTER_ADDR /
    MASTER_PORT; under SLURM or Open MPI the address comes from the
    argument or MASTER_ADDR / MASTER_PORT). A no-op, returning False, for a
    single process without a coordinator or where the group is already
    up; with a coordinator, a group of one is made. ``backend``: NCCL for
    a CUDA ``device`` (default), gloo for the CPU. Collectives that wait
    longer than ``timeout`` seconds raise."""
    if dist.is_initialized():
        return False
    pod = _pod_env()
    if num_processes in (None, 1) and coordinator_address is None \
            and pod is None:
        return False
    if num_processes is None or process_id is None:
        if pod is None:
            raise ValueError("a coordinator address needs num_processes and "
                             "process_id (or a launcher's environment)")
        process_id, num_processes = pod
    if coordinator_address is None:
        addr, port = os.environ.get("MASTER_ADDR"), os.environ.get(
            "MASTER_PORT")
        if not (addr and port):
            raise ValueError("no coordinator address: pass one or set "
                             "MASTER_ADDR and MASTER_PORT")
        coordinator_address = f"{addr}:{port}"
    if device is None:
        device = "cuda"
    dist.init_process_group(
        backend or default_backend(device),
        init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=timeout))
    return True


def global_mesh(axis_names: Sequence[str] = ("data",),
                shape: Optional[Sequence[int]] = None, device=None) -> Mesh:
    """The mesh over every rank of the group (after ``initialize``)."""
    return make_mesh(None, axis_names, shape, device)


def host_local_batch_to_global(mesh: Mesh, batch):
    """This rank's shard of the global batch (global batch / mesh size
    samples, which the rank loaded itself) on its device; the batch stays
    sharded, nothing moves between ranks. With one rank the shard is the
    global batch."""
    return _tree_map(lambda x: torch.as_tensor(x).to(mesh.device), batch)


def process_local_batch_size(global_batch_size: int) -> int:
    """How many samples this rank's loader produces a step: the global
    batch over the group's size. Raises ValueError where it does not
    divide."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if global_batch_size % n:
        raise ValueError(f"global batch {global_batch_size} not divisible "
                         f"by {n} ranks")
    return global_batch_size // n


# ---------------------------------------------------------------- spawning

def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_device(device, local_rank: int) -> torch.device:
    """Local rank ``local_rank``'s device: the CPU, or card
    local_rank mod the card count (ranks share cards where there are
    fewer)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def spawn_backend(device, n_local: int) -> str:
    """The backend of ``n_local`` ranks on this host: NCCL where every
    rank has a card of its own, else gloo (NCCL refuses two ranks on one
    card; gloo serves CUDA tensors for all_reduce and broadcast)."""
    dev = torch.device(device)
    if dev.type == "cuda" and n_local > torch.cuda.device_count():
        return "gloo"
    return default_backend(dev)


def to_host(tree):
    """Every tensor of a tree as a numpy array (16-bit floats as
    float32, which numpy lacks)."""
    def host(x):
        if not isinstance(x, torch.Tensor):
            return x
        x = x.detach().cpu()
        if x.dtype in (torch.bfloat16, torch.float16):
            x = x.float()
        return x.numpy()

    return _tree_map(host, tree)


def _rank_main(local_rank: int, fn, world: int, rank0: int, address: str,
               backend: str, device, timeout: float, threads: Optional[int],
               inbox, queue) -> None:
    rank = rank0 + local_rank
    try:
        args = inbox.get()
        torch.set_num_threads(threads)
        dev = rank_device(device, local_rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        initialize(address, world, rank, backend=backend, device=dev,
                   timeout=timeout)
        try:
            result = fn(make_mesh(device=dev), *args)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            queue.put((local_rank, "ok", to_host(result)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # reported to the parent, which raises
        queue.put((local_rank, "error", traceback.format_exc()))
        raise


def spawn(fn: Callable[..., Any], n_local: int, args: tuple = (),
          device="cuda", backend: Optional[str] = None,
          timeout: float = DEFAULT_TIMEOUT_S, threads: Optional[int] = None,
          address: Optional[str] = None, world: Optional[int] = None,
          rank0: int = 0, deadline: Optional[float] = None) -> List[Any]:
    """Run ``fn(mesh, *args)`` on ``n_local`` new processes (start method
    "spawn"), local rank i being global rank ``rank0 + i`` of a group of
    ``world`` (default ``n_local``) ranks at ``address`` (default a free
    localhost port), on ``rank_device(device, i)``, over ``backend``
    (default ``spawn_backend``). Returns every local rank's result in rank
    order, tensors as numpy arrays (``fn`` must be importable by name, and
    return picklable values). A rank that raises makes this raise with its
    traceback. A collective that waits ``timeout`` seconds raises in its
    rank; a group that has not answered ``deadline`` seconds after the
    ranks started (default: no limit while every rank lives) is
    terminated and raises TimeoutError. ``threads``: torch's intra-op
    threads a rank (default: this process's cores shared out over the
    ranks; more oversubscribe them, which slowed a CPU step 25-fold)."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    address = address or f"127.0.0.1:{free_port()}"
    backend = backend or spawn_backend(device, n_local)
    # the arguments travel by a queue, not in the process object: a rank
    # that dies before reading its start-up pipe would leave this process
    # blocked writing a large one
    inbox, queue = ctx.Queue(), ctx.Queue()
    for _ in range(n_local):
        inbox.put(args)
    threads = threads or max(1, len(os.sched_getaffinity(0)) // n_local)
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(i, fn, world or n_local, rank0, address,
                               backend, device, timeout, threads, inbox,
                               queue))
             for i in range(n_local)]
    for p in procs:
        p.start()
    results: List[Any] = [None] * n_local
    errors = []
    end = None if deadline is None else time.monotonic() + deadline
    try:
        got = 0
        while got < n_local:
            left = 5.0 if end is None else end - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"spawn: {n_local - got} of {n_local} "
                                   f"ranks did not answer within "
                                   f"{deadline:.0f} s")
            try:
                i, status, value = queue.get(timeout=min(left, 5.0))
            except queue_mod.Empty:
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                if dead:
                    time.sleep(1.0)  # let a dying rank's report arrive
                    if queue.empty():
                        raise RuntimeError(f"spawn: a rank died with exit "
                                           f"code {dead[0]} and no report")
                continue
            got += 1
            if status == "ok":
                results[i] = value
            else:
                errors.append(f"rank {rank0 + i}:\n{value}")
                break
        if errors:
            raise RuntimeError("spawn: " + "\n".join(errors))
    finally:
        for p in procs:
            p.join(timeout=30.0 if not errors else 5.0)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10.0)
        for q in (inbox, queue):
            q.cancel_join_thread()  # what no rank read is dropped
            q.close()
    bad = [p.exitcode for p in procs if p.exitcode not in (0, None)]
    if bad:
        raise RuntimeError(f"spawn: ranks exited with codes {bad}")
    return results


def same_on_every_rank(results: List[Any]) -> Any:
    """The one value every rank returned (numpy trees compared exactly,
    but for what each rank counts of its own: keys ending in "ms", its
    host times, or in "launches", its kernel launches); raises where two
    ranks disagree."""
    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                if not str(k).endswith(("ms", "launches")):
                    yield from flat(v, f"{prefix}/{k}")
        elif isinstance(tree, (list, tuple)):
            for k, v in enumerate(tree):
                yield from flat(v, f"{prefix}/{k}")
        else:
            yield prefix, tree

    first = dict(flat(results[0]))
    for r, other in enumerate(results[1:], 1):
        for k, v in flat(other):
            if not np.array_equal(np.asarray(v), np.asarray(first[k]),
                                  equal_nan=np.asarray(v).dtype.kind == "f"):
                raise AssertionError(f"ranks 0 and {r} differ at {k}")
    return results[0]
