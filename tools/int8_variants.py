"""The int8 conv kernel's products as committed (csrc/int8conv.cuh: Hopper's
warpgroup products, wgmma.mma_async m64nNk32 s32.s8.s8, for the instances
with 64 or more channels a warp, mma.sync m16n8k32 for the narrower ones)
against the same kernel with every instance on mma.sync and with every
instance on wgmma, on one NVIDIA card.

    python3 tools/int8_variants.py

Builds the three from this checkout's ``csrc/`` with nvcc into
``nanovs_slam_torch/_build/int8_variants/`` (the variants change the
header's ``kWgmmaMinN``; the all-wgmma one adds the N = 8, 16, 32 atoms;
each variant's header sits beside copies of ``int8conv.cu`` and
``int8conv_bf16.cu``, which include it), prints what ptxas reports, then
at every one of the float32 int8 S8 request's 23 calls at batch 1 and 8
(``chip_smoke.int8_calls`` on
``int8_kernel_cases``' seeded input, pinned S8 calibrated as
``chip_smoke.py``'s int8 phase does) holds each to the twin at 0 and times
them with ``chip_smoke.cuda_ms`` in the order kernel, mma, wgmma, wgmma,
mma, kernel. Prints the card's name and power limit, a line a call and the
sums over each batch's request. Imports neither jax nor nanovs_slam_tpu.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "nanovs_slam_torch", "csrc")
OUT = os.path.join(REPO, "nanovs_slam_torch", "_build", "int8_variants")
MIN_N = "constexpr int kWgmmaMinN = 64;"
ATOMS_AT = "// ... the same on Hopper's warpgroup products (wgmma)"
ORDER = ("kernel", "mma", "wgmma", "wgmma", "mma", "kernel")


def wgmma_atoms(widths) -> str:
    """wgmma_s8<N> for the given N, in the source's form."""
    out = []
    for n in widths:
        nd = n // 2
        regs = ", ".join(f"%{i}" for i in range(nd))
        cons = ", ".join(f'"+r"(d[{i}])' for i in range(nd))
        out.append(
            f"template <>\n__device__ __forceinline__ void wgmma_s8<{n}>("
            f"int (&d)[{nd}], const uint32_t (&a)[4], uint64_t desc) {{\n"
            f'  asm volatile("{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{nd + 5}, '
            f'0;\\n"\n      "wgmma.mma_async.sync.aligned.m64n{n}k32.s32.s8'
            f'.s8 {{{regs}}}, {{%{nd}, %{nd + 1}, %{nd + 2}, %{nd + 3}}}, '
            f'%{nd + 4}, p;\\n}}\\n"\n      : {cons}\n      : "r"(a[0]), '
            f'"r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));\n}}')
    return "\n\n".join(out) + "\n\n"


def variants(src: str) -> dict:
    """{name: source}: as committed, every instance on mma.sync, every
    instance on wgmma."""
    assert src.count(MIN_N) == 1 and src.count(ATOMS_AT) == 1
    wgmma = src.replace(MIN_N, "constexpr int kWgmmaMinN = 8;").replace(
        ATOMS_AT, wgmma_atoms((8, 16, 32)) + ATOMS_AT)
    return {"kernel": src,
            "mma": src.replace(MIN_N, "constexpr int kWgmmaMinN = 1 << 30;"),
            "wgmma": wgmma}


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
    from nanovs_slam_torch.data.datasets import SyntheticShapesDataset
    from nanovs_slam_torch.kernels import int8conv as ic
    from nanovs_slam_torch.quant import calibrate_conv_scales

    if not torch.cuda.is_available():
        print("int8_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    fns = build()
    for fn in fns.values():
        fn.argtypes = ic._ARGTYPES
        fn.restype = ctypes.c_int
    print(cs.card_line(), flush=True)
    dev = torch.device("cuda")
    model, _ = cs.int8_pinned(REPO, dev)
    calib = SyntheticShapesDataset((cs.H, cs.W), cs.INT8_CALIB, 8, seed=3)
    scales = calibrate_conv_scales(
        model, [calib[i]["image"][None] * 2.0 - 1.0
                for i in range(cs.INT8_CALIB)])

    def call(fn, args):  # a float32 block
        x, wq, m, a, b, s_in, slope, out_scale, pool = args[:9]
        int8_in = x.dtype == torch.int8
        B, cin = x.shape[0], ic.in_channels(x)
        H, W = x.shape[1:3] if int8_in else x.shape[2:]
        cout = wq.shape[0]
        if out_scale is None:
            mode, out = 0, torch.empty((B, cout, H, W), device=dev)
        else:
            mode = 2 if pool else 1
            ho, wo = (H // 2, W // 2) if pool else (H, W)
            out = torch.empty((B, ho, wo, cout), device=dev,
                              dtype=torch.int8)
        ic._build.check(fn(
            x.data_ptr(), int(int8_in), wq.data_ptr(), m.data_ptr(),
            a.data_ptr(), b.data_ptr(), out.data_ptr(), mode, 0, B, H, W,
            cin, cout, ic.padded_k(cin), s_in,
            0.0 if out_scale is None else out_scale, slope,
            ic._build.stream_ptr(dev)), "int8_variants")
        return out

    for B in (1, 8):
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
                           f"{name} {path} B={B}: differs from the twin")
            ms = [cs.cuda_ms(lambda f=fns[n]: call(f, args)) for n in ORDER]
            sums = [s + m for s, m in zip(sums, ms)]
            print(f"B={B} {path}: " + ", ".join(
                f"{n} {m:.4f}" for n, m in zip(ORDER, ms)) + " ms",
                flush=True)
        print(f"B={B} summed over the request: " + ", ".join(
            f"{n} {s:.4f}" for n, s in zip(ORDER, sums)) + " ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
