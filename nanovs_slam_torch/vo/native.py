"""ctypes bindings for the native C++ matcher (``native/matcher.cpp``), a
copy of ``nanovs_slam_tpu/vo/native.py``'s bindings.

The library is built on first use by a C++ compiler itself, with the
flags of ``native/Makefile``, into ``nanovs_slam_torch/_build/matcher-<hash
of the source, compiler and flags>/``; ``native/`` is only read. The
compilers are tried in turn, ``$CXX``, then ``c++``, then ``g++``, until
one builds: a ``$CXX`` installed without its OpenMP runtime (``-fopenmp``
finds no ``libgomp.spec``) makes ``make -C native`` fail where the
system's ``c++`` builds. A later process with the same source loads the library
that is there. Where none builds or loads, ``ratio_match_native`` runs the
numpy matcher (``vo/matcher.py``), whose results are the same;
``native_available`` says which one runs, and ``build_log`` keeps what the
compilers (or the loader) said.
"""

from __future__ import annotations

import ctypes
import subprocess
from typing import Optional, Tuple

import numpy as np

from ..utils.host_build import BUILD_ROOT, NATIVE, build_library, compilers

SOURCE = NATIVE / "matcher.cpp"
# native/Makefile's CXXFLAGS
CXXFLAGS = ["-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
            "-std=c++17"]

_LIB = None
_TRIED = False
# each failed compiler's command and output (or the loader's error); None
# when the first compiler built the library and it loaded
build_log: Optional[str] = None


def _compilers() -> list:
    """$CXX, c++ and g++ as paths, each once, in that order."""
    return compilers("CXX", ("c++", "g++"))


def _build(cxx: str):
    """The library built from SOURCE (or already there); raises
    RuntimeError with the compiler's output if the build fails."""
    return build_library(SOURCE, cxx, CXXFLAGS, "matcher", "libmatcher.so",
                         root=BUILD_ROOT)


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED, build_log
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    failures, lib = [], None
    for cxx in _compilers():
        try:
            lib = ctypes.CDLL(str(_build(cxx)))
            break
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            failures.append(str(e))
    if failures or lib is None:
        build_log = "\n".join(failures) or (
            "no C++ compiler: $CXX, c++ and g++ are not on PATH")
    if lib is None:
        return None
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.knn2_l2.argtypes = [f32p, ctypes.c_int, f32p, ctypes.c_int,
                            ctypes.c_int, i32p, f32p]
    lib.knn2_l2.restype = None
    lib.ratio_match_one_to_one.argtypes = [
        f32p, ctypes.c_int, f32p, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, i32p, i32p, f32p]
    lib.ratio_match_one_to_one.restype = ctypes.c_int
    _LIB = lib
    return _LIB


def native_available() -> bool:
    return _load() is not None


def knn2_native(desc1: np.ndarray, desc2: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray]:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the native matcher could not be built or "
                           f"loaded:\n{build_log}")
    d1 = np.ascontiguousarray(desc1, np.float32)
    d2 = np.ascontiguousarray(desc2, np.float32)
    n1 = len(d1)
    idx = np.empty(2 * n1, np.int32)
    dist = np.empty(2 * n1, np.float32)
    lib.knn2_l2(d1, n1, d2, len(d2), d1.shape[1], idx, dist)
    return idx.reshape(n1, 2), dist.reshape(n1, 2)


def ratio_match_native(desc_query: np.ndarray, desc_train: np.ndarray,
                       ratio: float = 0.7
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    lib = _load()
    if lib is None:  # the numpy matcher, same results
        from .matcher import ratio_test_match_one_to_one

        return ratio_test_match_one_to_one(desc_query, desc_train, ratio)
    d1 = np.ascontiguousarray(desc_query, np.float32)
    d2 = np.ascontiguousarray(desc_train, np.float32)
    n1 = len(d1)
    if n1 < 2 or len(d2) < 2:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                np.zeros(0, np.float32))
    i1 = np.empty(n1, np.int32)
    i2 = np.empty(n1, np.int32)
    dd = np.empty(n1, np.float32)
    n = lib.ratio_match_one_to_one(d1, n1, d2, len(d2), d1.shape[1],
                                   ctypes.c_float(ratio), i1, i2, dd)
    return i1[:n].astype(np.int64), i2[:n].astype(np.int64), dd[:n]
