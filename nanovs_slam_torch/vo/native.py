"""ctypes bindings for the native C++ matcher (``native/matcher.cpp``), a
copy of ``nanovs_slam_tpu/vo/native.py``.

The library is framework-neutral; it is built with ``make -C native`` on
first use when ``native/libmatcher.so`` is missing. Where it cannot be
built or loaded, ``ratio_match_native`` runs the numpy matcher
(``vo/matcher.py``), whose results are the same; ``native_available``
says which one runs.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_LIB = None
_TRIED = False


def _native_dir() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))), "native")


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    d = _native_dir()
    so = os.path.join(d, "libmatcher.so")
    if not os.path.exists(so):
        try:
            subprocess.run(["make", "-C", d], check=True,
                           capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
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
        raise RuntimeError("native/libmatcher.so could not be built or "
                           "loaded")
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
