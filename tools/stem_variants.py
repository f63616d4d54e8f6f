"""Versions of ``csrc/stem.cu`` side by side on one NVIDIA card: config D's
(64, 128) instances held against ``stem_plain`` and timed in turns.

    python3 tools/stem_variants.py NAME=DIR [NAME=DIR ...]

Each DIR holds a ``stem.cu`` (for example the file at another commit, from
``git show``); it is compiled with this checkout's ``csrc/common.cuh``
into a library of its own (nvcc, sm_90a, ``-Xptxas -v``: registers and
spills are printed). Every version is held, float32 and bf16, against
``stem_plain`` (TF32 off) at 240x320 for B 1 and 8, at 241x321, at B 3
with slope 0, on NHWC memory at 70x90, at 2x2 and at 33x47: float32
within 1e-5, bf16 within one bf16 ulp of the output, two launches bit for
bit. Then the versions that pass are timed at 240x320, B 1 and 8, in the
order given and back (a, b, ..., b, a), by CUDA events behind a spin
kernel (median of 11 runs of 20 calls, the weights' packing included), and
the card's name and power limit printed beside them.
"""

from __future__ import annotations

import ctypes
import math
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from nanovs_slam_torch.kernels._build import NVCC_FLAGS, _nvcc  # noqa: E402
from nanovs_slam_torch.kernels.stem import stem_plain  # noqa: E402

CSRC = os.path.join(REPO, "nanovs_slam_torch", "csrc")
C1, C2 = 64, 128
# (B, H, W, NCHW memory, slope)
SHAPES = [(1, 240, 320, True, 0.01), (8, 240, 320, True, 0.01),
          (1, 241, 321, True, 0.01), (3, 240, 320, True, 0.0),
          (2, 70, 90, False, 0.01), (1, 2, 2, True, 0.01),
          (5, 33, 47, True, 0.0)]


def build(dirs: dict) -> dict:
    """{name: ctypes library} of the versions that compile (all at once)."""
    out = tempfile.mkdtemp(prefix="stem_variants_")
    procs = {}
    for name, d in dirs.items():
        so = os.path.join(out, f"{name}.so")
        procs[name] = (so, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-shared", "-I", CSRC, "-o", so,
             os.path.join(d, "stem.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    P, S, I = ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong), ctypes.c_int
    for name, (so, p) in procs.items():
        log, _ = p.communicate()
        print(f"== {name}: nvcc rc {p.returncode}")
        for line in log.splitlines():
            if "error" in line or "Used" in line or "spill" in line:
                print("  ", line.strip()[:200])
        if p.returncode == 0:
            lib = ctypes.CDLL(so)
            for fn in ("nvs_stem_pair_pool", "nvs_stem_pair_pool_bf16"):
                getattr(lib, fn).argtypes = ([P, S] + [P] * 6 + [I] * 5
                                             + [ctypes.c_float, P])
                getattr(lib, fn).restype = I
            libs[name] = lib
    return libs


def inputs(B, H, W, bf16, nchw, dev):
    rs = np.random.RandomState(B + H)
    a = rs.uniform(-1, 1, (B, 3, H, W)).astype(np.float32)
    x = (torch.from_numpy(a).to(dev).permute(0, 2, 3, 1) if nchw else
         torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 3, 1)))
         .to(dev))
    w = [torch.from_numpy(v.astype(np.float32)).to(dev) for v in (
        rs.randn(C1, 3, 3, 3) * 0.2, rs.randn(C1) * 0.1,
        rs.randn(C2, C1, 3, 3) * 0.05, rs.randn(C2) * 0.1)]
    return [x.to(torch.bfloat16) if bf16 else x] + w


def call(lib, x, w1, b1, w2, b2, slope=0.01):
    B, H, W, _ = x.shape
    bf16 = x.dtype == torch.bfloat16
    out = torch.empty((B, C2, H // 2, W // 2), device=x.device,
                      dtype=x.dtype)
    # room for every version's packed weights
    scratch = torch.empty(2 * 9 * C1 * C2 + 64 * C1, device=x.device)
    fn = lib.nvs_stem_pair_pool_bf16 if bf16 else lib.nvs_stem_pair_pool
    err = fn(x.data_ptr(), (ctypes.c_longlong * 4)(*x.stride()),
             w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
             out.data_ptr(), scratch.data_ptr(), B, H, W, C1, C2, slope,
             ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err:
        raise RuntimeError(f"launch error {err}")
    return out


def ulps(got, want) -> float:
    _, e = math.frexp(float(want.float().abs().max()))
    return float((got.float() - want.float()).abs().max()) / 2.0 ** (e - 8)


def ms(fn, inner=20, trials=11) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(5_000_000)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return float(np.median(times))


def main(argv) -> int:
    if not argv or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    dirs = dict(a.split("=", 1) for a in argv)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    libs = build(dirs)
    good = []
    for name, lib in libs.items():
        ok = True
        for bf16 in (False, True):
            for B, H, W, nchw, slope in SHAPES:
                args = inputs(B, H, W, bf16, nchw, dev)
                got, again = call(lib, *args, slope), call(lib, *args, slope)
                want = stem_plain(*args, slope).permute(0, 3, 1, 2)
                err = float((got.float() - want.float()).abs().max())
                u = ulps(got, want)
                fine = ((u <= 1.0) if bf16 else (err <= 1e-5)) and \
                    torch.equal(got, again)
                ok &= fine
                print(f"  {name} {'bf16' if bf16 else 'f32 '} B={B} "
                      f"{H}x{W} nchw={nchw} slope={slope}: err {err:.3g}, "
                      f"{u:.3f} ulps, {'ok' if fine else 'FAILED'}")
        if ok:
            good.append(name)
    order = good + good[::-1]
    for bf16 in (False, True):
        for B in (1, 8):
            args = inputs(B, 240, 320, bf16, True, dev)
            t = {}
            for name in order:
                t.setdefault(name, []).append(
                    ms(lambda: call(libs[name], *args)))
            print(f"TIME {'bf16' if bf16 else 'float32'} B={B} ms: "
                  + "; ".join(f"{k} {v}" for k, v in t.items()))
    print("held:", good, "failed:", [n for n in dirs if n not in good])
    return 0 if len(good) == len(dirs) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
