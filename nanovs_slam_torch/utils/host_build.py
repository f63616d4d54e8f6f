"""Build a shared library from one C or C++ source of ``native/`` with the
host's compiler, into ``nanovs_slam_torch/_build/<name>-<hash of the
source, compiler and flags>/``. ``native/`` is only read. A later process
with the same source loads the library that is there."""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Iterable, List, Sequence

_PKG = Path(__file__).resolve().parent.parent
NATIVE = _PKG.parent / "native"
BUILD_ROOT = _PKG / "_build"


def compilers(env: str, names: Iterable[str]) -> List[str]:
    """``$env``, then ``names``, as paths, each once, in that order."""
    found: List[str] = []
    for name in (os.environ.get(env), *names):
        path = shutil.which(name) if name else None
        if path and os.path.realpath(path) not in map(os.path.realpath,
                                                      found):
            found.append(path)
    return found


def build_library(source: Path, compiler: str, flags: Sequence[str],
                  name: str, lib: str, libs: Sequence[str] = (),
                  root: Path = BUILD_ROOT) -> Path:
    """The library ``lib`` built from ``source`` by ``compiler flags
    source -o lib libs`` into ``root/name-<hash>/`` (or already there);
    raises RuntimeError with the compiler's output if the build fails."""
    h = hashlib.sha256(" ".join([compiler, *flags, *libs]).encode())
    h.update(source.read_bytes())
    out_dir = root / f"{name}-{h.hexdigest()[:16]}"
    so = out_dir / lib
    if so.exists():
        return so
    root.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        staged = Path(tmp) / "done"
        staged.mkdir()
        cmd = [compiler, *flags, str(source), "-o", str(staged / lib),
               *libs]
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        if r.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} exited with {r.returncode}:"
                               f"\n{r.stdout}{r.stderr}")
        try:
            os.replace(staged, out_dir)
        except OSError:
            if not so.exists():  # not a concurrent build
                raise
    return so
