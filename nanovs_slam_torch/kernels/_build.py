"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into an object
(all files at once, one ``nvcc`` process each), and the objects are linked
into one shared library with a plain C interface, loaded with ``ctypes``.
The build happens at first use, from the checkout's sources only, into
``nanovs_slam_torch/_build/<hash of the sources and flags>/``; a later
process with the same sources loads the library that is there.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
LIB_NAME = "libnanovs_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_bound: dict = {}
# what the last build printed (ptxas register/shared-memory report) and
# how long it took; None when the library was already built
build_log: Optional[str] = None
build_seconds: Optional[float] = None


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                           "kernels are built from csrc/ at first use")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    cu, cuh = _sources()
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _build(out_dir: Path) -> Path:
    global build_log, build_seconds
    nvcc = _nvcc()
    cu, _ = _sources()
    t0 = time.perf_counter()
    out_dir.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir.parent) as tmp:
        procs = []
        for src in cu:
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
                   "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for src, _, p in procs:
            out, _ = p.communicate()
            logs.append(f"== {src.name}\n{out}")
            if p.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n"
                               + "\n".join(logs))
        lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
             "-o", str(lib), *[str(o) for _, o, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking {LIB_NAME} failed:\n{link.stdout}")
        staged = Path(tmp) / "done"
        staged.mkdir()
        os.replace(lib, staged / LIB_NAME)
        try:
            os.replace(staged, out_dir)
        except OSError:
            if not (out_dir / LIB_NAME).exists():  # not a concurrent build
                raise
    build_seconds = time.perf_counter() - t0
    build_log = "\n".join(logs)
    return out_dir / LIB_NAME


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built first if the sources changed."""
    global _lib
    with _lock:
        if _lib is None:
            out_dir = BUILD_ROOT / _digest()
            path = out_dir / LIB_NAME
            if not path.exists():
                path = _build(out_dir)
            lib = ctypes.CDLL(str(path))
            lib.nvs_error_string.argtypes = [ctypes.c_int]
            lib.nvs_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def bind(name: str, argtypes) -> ctypes._CFuncPtr:
    """A launcher of the library with its C signature declared; every
    launcher returns the ``cudaError_t`` of its launch as an int."""
    fn = _bound.get(name)
    if fn is None:
        fn = getattr(load_library(), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _bound[name] = fn
    return fn


def check(err: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if err != 0:
        msg = load_library().nvs_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def strides(t) -> ctypes.Array:
    """A tensor's element strides as a C ``long long`` array."""
    return (ctypes.c_longlong * t.dim())(*t.stride())


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
