"""The int8 conv kernel as committed (csrc/int8conv.cuh: its plan picks
16-pixel tiles or strips by shape) against the same kernel with every
call on tiles and with every call the strips take on strips, on one
NVIDIA card.

    python3 tools/int8_variants.py

Builds the three from this checkout's ``csrc/`` with nvcc into
``nanovs_slam_torch/_build/int8_variants/`` (the variants change the
header's ``kStripMinQuarters``; each variant's header sits beside copies of
``int8conv.cu`` and ``int8conv_bf16.cu``, which include it), prints what
ptxas reports, then at every int8 call of four requests (``chip_smoke.
int8_calls`` on ``int8_kernel_cases``' seeded input): pinned S8 at
float32 and at bf16 (calibrated as ``chip_smoke.py``'s int8 phase does)
at batch 1 and 8, and config N with 28 classes at bf16 at batch 128
(``chip_smoke.int8_bf16_n28``'s seeded model and calibration), holds each
variant to the twin at 0 and times them with ``chip_smoke.cuda_ms`` in
the order kernel, tiles, strips, strips, tiles, kernel. Prints the card's
name and power limit, a line a call (with the design the committed plan
picks) and the sums over each request. Imports neither jax nor
nanovs_slam_tpu.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "nanovs_slam_torch", "csrc")
OUT = os.path.join(REPO, "nanovs_slam_torch", "_build", "int8_variants")
RULE = "constexpr int kStripMinQuarters = "
ORDER = ("kernel", "tiles", "strips", "strips", "tiles", "kernel")


def variants(src: str) -> dict:
    """{name: source}: as committed, every call on tiles, every call the
    strips take on strips."""
    assert src.count(RULE) == 1
    line = src[src.index(RULE):].split("\n", 1)[0]
    return {"kernel": src,
            "tiles": src.replace(line, RULE + "1 << 20;"),
            "strips": src.replace(line, RULE + "0;")}


def build() -> dict:
    src = open(os.path.join(CSRC, "int8conv.cuh")).read()
    procs = {}
    for name, text in variants(src).items():
        d = os.path.join(OUT, name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "int8conv.cuh"), "w") as f:
            f.write(text)
        cus = []
        for cu in ("int8conv.cu", "int8conv_bf16.cu"):
            with open(os.path.join(CSRC, cu)) as f, \
                    open(os.path.join(d, cu), "w") as g:
                g.write(f.read())
            cus.append(os.path.join(d, cu))
        cmd = ["/usr/local/cuda/bin/nvcc", "-gencode",
               "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-Xcompiler", "-fPIC", "-shared", "-Xptxas", "-v", "-I", CSRC,
               "-o", os.path.join(OUT, f"lib{name}.so")] + cus
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, p in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{out}")
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "C75" in line:
                print(f"{name} ptxas: {line.strip()}")
        fns[name] = ctypes.CDLL(
            os.path.join(OUT, f"lib{name}.so")).nvs_int8_conv3x3
    return fns


def main() -> int:
    sys.path.insert(0, REPO)
    import numpy as np
    import torch

    import chip_smoke as cs
    from nanovs_slam_torch.configs import get_config
    from nanovs_slam_torch.kernels import int8conv as ic
    from nanovs_slam_torch.models.kp2dtiny import build_model, init_model

    if not torch.cuda.is_available():
        print("int8_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    fns = build()
    for fn in fns.values():
        fn.argtypes = ic._ARGTYPES
        fn.restype = ctypes.c_int
    print(cs.card_line(), flush=True)
    dev = torch.device("cuda")

    def call(fn, args):
        x, wq, m, a, b, s_in, slope, out_scale, pool, dt = args
        int8_in = x.dtype == torch.int8
        B, cin = x.shape[0], ic.in_channels(x)
        H, W = x.shape[1:3] if int8_in else x.shape[2:]
        cout = wq.shape[0]
        if out_scale is None:
            mode, out = 0, torch.empty((B, cout, H, W), device=dev, dtype=dt)
        else:
            mode = 2 if pool else 1
            ho, wo = (H // 2, W // 2) if pool else (H, W)
            out = torch.empty((B, ho, wo, cout), device=dev,
                              dtype=torch.int8)
        ic._build.check(fn(
            x.data_ptr(), ic._X_TYPES[x.dtype], wq.data_ptr(), m.data_ptr(),
            a.data_ptr(), b.data_ptr(), out.data_ptr(), mode,
            int(dt == torch.bfloat16), B, H, W, cin, cout,
            ic.padded_k(cin), s_in, 0.0 if out_scale is None else out_scale,
            slope, ic._build.stream_ptr(dev)), "int8_variants")
        return out

    def request(label, model, scales, B, runs):
        rs = np.random.RandomState(cs.SEED + 1800 + B)
        x = torch.from_numpy(rs.uniform(-1, 1, (B, 3, cs.H, cs.W)).astype(
            np.float32)).to(dev)
        sums = [0.0] * len(ORDER)
        for path, args in cs.int8_calls(model, x, scales):
            want = ic.int8_conv3x3_plain(*args)
            for name, fn in fns.items():
                got = call(fn, args)
                torch.cuda.synchronize()
                cs.require(cs.max_err(got, want) == 0,
                           f"{name} {label} {path}: differs from the twin")
            ms = [cs.cuda_ms(lambda f=fns[n]: call(f, args), *runs)
                  for n in ORDER]
            sums = [s + m for s, m in zip(sums, ms)]
            design = ic.launch_shape(args[0], args[1].shape[0], args[7],
                                     args[8], args[9])["design"]
            print(f"{label} {path} ({design}): " + ", ".join(
                f"{n} {m:.4f}" for n, m in zip(ORDER, ms)) + " ms",
                flush=True)
        print(f"{label} summed over the request: " + ", ".join(
            f"{n} {s:.4f}" for n, s in zip(ORDER, sums)) + " ms", flush=True)

    for dtype in ("float32", "bfloat16"):
        model, _ = cs.int8_pinned(REPO, dev, dtype)
        scales = cs.int8_calibrate(model, 8)
        for B in (1, 8):
            request(f"S8 {dtype} B={B}", model, scales, B, (20, 15))
    gen = torch.Generator().manual_seed(cs.SEED + 2200)
    model32 = init_model(get_config("N", n_classes=28), gen, "cpu")
    cs.randomize_bn(model32, gen)
    model = build_model(get_config("N", n_classes=28, dtype="bfloat16"))
    model.load_state_dict(model32.state_dict())
    model = model.to(dev).eval()
    request("N28 bfloat16 B=128", model, cs.int8_calibrate(model, 28), 128,
            (5, 7))
    return 0


if __name__ == "__main__":
    sys.exit(main())
