"""MCU deployment bundles (``.nvsb``), the counterpart of
``nanovs_slam_tpu/deploy.py``, with the same format byte for byte.

- ``export_mcu_bundle`` serialises the KP2DTiny MCU-export graph
  (``configs.to_mcu``: convtranspose upsample, plain ReLU; heads
  score/loc/desc) of a port model into one self-describing file: an ASCII
  op manifest, then raw little-endian blobs, each 4-byte aligned. Its
  weights are the model's flax-layout trees (``utils/convert.
  to_jax_variables``); ConvBNAct convs with a calibrated input scale
  (``quant.calibrate_conv_scales``) carry int8 weights
  (``quant._quantize_kernel``) and that scale, BatchNorm folded to a
  per-channel affine; the rest stays float32.
- ``run_bundle_numpy`` interprets a bundle with numpy (a copy of the JAX
  package's interpreter).
- ``run_bundle_c`` runs it with ``native/mcu_runtime.c``, which the host's
  C compiler builds into ``nanovs_slam_torch/_build/mcu-<hash>/`` at first
  use (``native/`` is only read); without a compiler that builds it, it
  raises.
"""

from __future__ import annotations

import ctypes
import io
import subprocess
from typing import Dict, List, Optional, Tuple

import numpy as np

from .quant import _quantize_kernel
from .utils.convert import to_jax_variables
from .utils.fuse import fold_bn_affine
from .utils.host_build import BUILD_ROOT, NATIVE, build_library, compilers

_ACT_NONE, _ACT_RELU, _ACT_LEAKY = 0, 1, 2
_BN_EPS = 1e-5


class _Writer:
    """Accumulates manifest lines + data blobs; blob offsets are relative
    to the start of the DATA section."""

    def __init__(self):
        self.lines: List[str] = []
        self.blobs = io.BytesIO()

    def blob(self, arr: np.ndarray) -> int:
        # 4-byte-align every blob (part of the .nvsb format): the C
        # runtime casts data+off to const float*, which is UB / a hard
        # fault on strict-alignment MCU cores if an f32 blob follows an
        # int8 weight blob of non-multiple-of-4 size.
        pad = (-self.blobs.tell()) % 4
        if pad:
            self.blobs.write(b"\x00" * pad)
        off = self.blobs.tell()
        self.blobs.write(np.ascontiguousarray(arr).tobytes())
        return off

    def emit(self, line: str):
        self.lines.append(line)


def _fold_bn(bn_p, bn_s) -> Tuple[np.ndarray, np.ndarray]:
    """Inference BatchNorm folded to a*x + b (float32)."""
    return fold_bn_affine(*(np.asarray(v, np.float32) for v in (
        bn_p["scale"], bn_p["bias"], bn_s["mean"], bn_s["var"])), _BN_EPS)


def _conv_w_oi(kernel: np.ndarray) -> np.ndarray:
    """flax HWIO -> runtime [O][kh][kw][I] (contiguous-I inner loop)."""
    return np.ascontiguousarray(
        np.asarray(kernel, np.float32).transpose(3, 0, 1, 2))


def _tconv_w_oi(kernel: np.ndarray) -> np.ndarray:
    """flax transpose-kernel (kh, kw, O, I) -> runtime [O][kh][kw][I]
    (torch ConvTranspose2d semantics; see blocks.TransposedConvKernel)."""
    return np.ascontiguousarray(
        np.asarray(kernel, np.float32).transpose(2, 0, 1, 3))


def _emit_convbnact(w: _Writer, path: str, p, s, scales, act: int,
                    tin: int, tout: int) -> None:
    """ConvBNAct: int8 when `scales` has a calibrated input scale for
    `path` (mirrors quant.int8_execution's consult point), else f32."""
    kernel = _conv_w_oi(p["conv"]["kernel"])  # (O, 3, 3, I)
    cout, _, _, cin = kernel.shape
    a, b = _fold_bn(p["bn"], s["bn"])
    scale_in = scales.get(path) if scales else None
    if scale_in is not None:
        # identical rule to quant._quantize_kernel, applied on the
        # runtime layout (per-O axis is axis 0 here)
        hwio = np.asarray(p["conv"]["kernel"], np.float32)
        q, ws = _quantize_kernel(hwio)              # HWIO int8, (1,1,1,O)
        q_oi = np.ascontiguousarray(q.transpose(3, 0, 1, 2))
        off_w = w.blob(q_oi)
        off_s = w.blob(ws.reshape(-1).astype(np.float32))
        off_a, off_b = w.blob(a), w.blob(b)
        w.emit(f"conv8 {tin} {tout} {cin} {cout} {scale_in:.9e} {act} "
               f"{off_w} {off_s} {off_a} {off_b}")
    else:
        off_w = w.blob(kernel)
        off_a, off_b = w.blob(a), w.blob(b)
        w.emit(f"convbn {tin} {tout} {cin} {cout} {act} "
               f"{off_w} {off_a} {off_b}")


def _emit_conv_bias(w: _Writer, p, tin: int, tout: int) -> None:
    kernel = _conv_w_oi(p["kernel"])
    cout, _, _, cin = kernel.shape
    off_w = w.blob(kernel)
    off_b = w.blob(np.asarray(p["bias"], np.float32))
    w.emit(f"convf {tin} {tout} {cin} {cout} {off_w} {off_b}")


def export_mcu_bundle(model, cfg, path: str,
                      scales: Optional[Dict[str, float]] = None) -> str:
    """Serialise the MCU-export KP2DTinyV2 graph (heads score/loc/desc) of
    ``model`` (its parameters and BN statistics) to one ``.nvsb`` file.

    cfg: the model's ``KP2DTinyConfig``, an MCU variant (convtranspose
    upsample); a pixelshuffle config is refused. scales: calibrated
    per-conv input scales ({flax path: absmax/127}); convs with a scale
    run int8 on the target, and without any the bundle is float32.
    """
    params, batch_stats = to_jax_variables(model)
    if cfg.upscale_method != "convtranspose":
        raise ValueError(
            "MCU bundles require the convtranspose upsample "
            "(cfg.to_mcu(); pixelshuffle is the training path)")
    missing = [k for k in ("backbone", "score_head", "loc_head",
                           "desc_head") if k not in params]
    if missing:
        raise ValueError(
            "MCU bundles support the KP2DTinyV2 score/loc/desc graph "
            f"only (dedicated heads); params are missing {missing} — "
            "V3/DF fused-head checkpoints cannot be exported with "
            "--format mcu")
    c1, c2, c3, c4, c5, d1 = cfg.channel_dims
    act = _ACT_LEAKY if cfg.leaky_relu else _ACT_RELU
    P, S = params, batch_stats
    w = _Writer()
    w.emit("input 3")
    t = 0          # current tensor id
    next_t = 1

    def fresh():
        nonlocal next_t
        next_t += 1
        return next_t - 1

    def convbn(scope, name, tin):
        tout = fresh()
        _emit_convbnact(w, f"{scope}/{name}", P[scope][name],
                        S[scope][name], scales or {}, act, tin, tout)
        return tout

    def pool(tin, c):
        tout = fresh()
        w.emit(f"pool {tin} {tout} {c}")
        return tout

    # backbone (modules/backbone.py flow; encoders.py:110-123 schedule)
    t = convbn("backbone", "conv1a", t)
    t = convbn("backbone", "conv1b", t)
    if cfg.downsample >= 2:
        t = pool(t, c2)
    t = convbn("backbone", "conv2a", t)
    t = convbn("backbone", "conv2b", t)
    if cfg.downsample >= 3:
        t = pool(t, c3)
    t = convbn("backbone", "conv3a", t)
    skip = convbn("backbone", "conv3b", t)
    t = pool(skip, c4) if cfg.downsample >= 1 else skip
    t = convbn("backbone", "conv4a", t)
    featx = convbn("backbone", "conv4b", t)

    outs = []
    # score head: convDa (ConvBNAct) -> convDb (bias conv) -> sigmoid
    h = convbn("score_head", "convDa", featx)
    raw = fresh()
    _emit_conv_bias(w, P["score_head"]["convDb"], h, raw)
    score = fresh()
    w.emit(f"sigmoid {raw} {score} 1")
    outs.append(("score", score))

    # loc head: -> tanh
    h = convbn("loc_head", "convDa", featx)
    raw = fresh()
    _emit_conv_bias(w, P["loc_head"]["convDb"], h, raw)
    coord = fresh()
    w.emit(f"tanh {raw} {coord} 2")
    outs.append(("coord", coord))

    # desc head: convA -> convB -> tconv(+bn+act) -> concat skip ->
    # convAa -> convBb (heads.py UpscaleHead, kp2dtiny.py:377-388)
    h = convbn("desc_head", "convA", featx)
    hb = fresh()
    _emit_conv_bias(w, P["desc_head"]["convB"], h, hb)
    up = fresh()
    dp = P["desc_head"]["upsample1"]
    ds = S["desc_head"]["upsample1"]
    tw = _tconv_w_oi(dp["transposed_conv"]["kernel"])
    ta, tb = _fold_bn(dp["bn"], ds["bn"])
    off_w, off_a, off_b = w.blob(tw), w.blob(ta), w.blob(tb)
    w.emit(f"tconv {hb} {up} {c3 * 4} {c3} {act} {off_w} {off_a} {off_b}")
    cat = fresh()
    w.emit(f"concat {up} {skip} {cat} {c3} {c4}")
    h = convbn("desc_head", "convAa", cat)
    feat = fresh()
    _emit_conv_bias(w, P["desc_head"]["convBb"], h, feat)
    outs.append(("feat", feat))

    for name, tid in outs:
        w.emit(f"out {name} {tid}")

    with open(path, "wb") as f:
        f.write(b"NVSBNDL1\n")
        f.write(("\n".join(w.lines) + "\nDATA\n").encode())
        f.write(w.blobs.getvalue())
    return path


# ---------------------------------------------------------------------------
# numpy interpreter (the format's documentation)
# ---------------------------------------------------------------------------

def _parse(path: str):
    with open(path, "rb") as f:
        raw = f.read()
    if not raw.startswith(b"NVSBNDL1\n"):
        raise ValueError("not an NVSB bundle")
    head, data = raw.split(b"\nDATA\n", 1)
    lines = head.decode().split("\n")[1:]
    return lines, data


def _rd(data: bytes, off: int, n: int, dt) -> np.ndarray:
    return np.frombuffer(data, dtype=dt, count=n, offset=off)


def _np_conv3x3(x: np.ndarray, w_oi: np.ndarray) -> np.ndarray:
    """x (H, W, I) f32/int32-able; w (O, 3, 3, I). SAME padding, im2col."""
    H, W, I = x.shape
    O = w_oi.shape[0]
    xp = np.zeros((H + 2, W + 2, I), x.dtype)
    xp[1:-1, 1:-1] = x
    cols = np.empty((H, W, 9 * I), x.dtype)
    for kh in range(3):
        for kw in range(3):
            cols[:, :, (kh * 3 + kw) * I:(kh * 3 + kw + 1) * I] = \
                xp[kh:kh + H, kw:kw + W]
    acc_dt = np.int32 if x.dtype == np.int8 else np.float32
    return cols.reshape(H * W, 9 * I).astype(acc_dt) @ \
        w_oi.reshape(O, 9 * I).astype(acc_dt).T


def _np_act(v: np.ndarray, act: int) -> np.ndarray:
    if act == _ACT_RELU:
        return np.maximum(v, 0.0)
    if act == _ACT_LEAKY:
        return np.where(v > 0, v, np.float32(0.01) * v)
    return v


def run_bundle_numpy(path: str, image: np.ndarray) -> Dict[str, np.ndarray]:
    """Execute a .nvsb bundle with numpy only. image: (H, W, 3) f32."""
    lines, data = _parse(path)
    H, W, _ = image.shape
    ts: Dict[int, np.ndarray] = {0: image.astype(np.float32)}
    outs: Dict[str, np.ndarray] = {}
    for line in lines:
        p = line.split()
        if not p:
            continue
        op = p[0]
        if op == "input":
            continue
        if op == "conv8":
            tin, tout, cin, cout = map(int, p[1:5])
            s_in = np.float32(p[5])
            act = int(p[6])
            ow, os_, oa, ob = map(int, p[7:11])
            x = ts[tin]
            xq = np.clip(np.round(x / s_in), -127, 127).astype(np.int8)
            wq = _rd(data, ow, cout * 9 * cin, np.int8).reshape(
                cout, 3, 3, cin)
            sw = _rd(data, os_, cout, np.float32)
            a = _rd(data, oa, cout, np.float32)
            b = _rd(data, ob, cout, np.float32)
            y = _np_conv3x3(xq, wq).astype(np.float32) * (s_in * sw)
            y = a * y + b
            ts[tout] = _np_act(y, act).reshape(x.shape[0], x.shape[1],
                                               cout).astype(np.float32)
        elif op == "convbn":
            tin, tout, cin, cout, act = map(int, p[1:6])
            ow, oa, ob = map(int, p[6:9])
            x = ts[tin]
            wf = _rd(data, ow, cout * 9 * cin, np.float32).reshape(
                cout, 3, 3, cin)
            a = _rd(data, oa, cout, np.float32)
            b = _rd(data, ob, cout, np.float32)
            y = a * _np_conv3x3(x, wf) + b
            ts[tout] = _np_act(y, act).reshape(
                x.shape[0], x.shape[1], cout).astype(np.float32)
        elif op == "convf":
            tin, tout, cin, cout = map(int, p[1:5])
            ow, ob = map(int, p[5:7])
            x = ts[tin]
            wf = _rd(data, ow, cout * 9 * cin, np.float32).reshape(
                cout, 3, 3, cin)
            b = _rd(data, ob, cout, np.float32)
            ts[tout] = (_np_conv3x3(x, wf) + b).reshape(
                x.shape[0], x.shape[1], cout).astype(np.float32)
        elif op == "pool":
            tin, tout, _c = map(int, p[1:4])
            x = ts[tin]
            h2, w2 = x.shape[0] // 2, x.shape[1] // 2
            ts[tout] = x[:h2 * 2, :w2 * 2].reshape(
                h2, 2, w2, 2, -1).max(axis=(1, 3))
        elif op == "tconv":
            tin, tout, cin, cout, act = map(int, p[1:6])
            ow, oa, ob = map(int, p[6:9])
            x = ts[tin]
            h, wdt = x.shape[0], x.shape[1]
            wf = _rd(data, ow, cout * 9 * cin, np.float32).reshape(
                cout, 3, 3, cin)
            a = _rd(data, oa, cout, np.float32)
            b = _rd(data, ob, cout, np.float32)
            y = np.zeros((2 * h, 2 * wdt, cout), np.float32)
            contrib = np.einsum("hwi,okli->hwklo", x, wf)
            for kh in range(3):
                for kw in range(3):
                    oh = np.arange(h) * 2 + kh - 1
                    ow_ = np.arange(wdt) * 2 + kw - 1
                    mh = (oh >= 0) & (oh < 2 * h)
                    mw = (ow_ >= 0) & (ow_ < 2 * wdt)
                    y[np.ix_(oh[mh], ow_[mw])] += \
                        contrib[np.ix_(np.arange(h)[mh],
                                       np.arange(wdt)[mw])][:, :, kh, kw]
            ts[tout] = _np_act(a * y + b, act).astype(np.float32)
        elif op == "concat":
            t0, t1, tout = map(int, p[1:4])
            ts[tout] = np.concatenate([ts[t0], ts[t1]], axis=-1)
        elif op == "sigmoid":
            tin, tout = int(p[1]), int(p[2])
            ts[tout] = 1.0 / (1.0 + np.exp(-ts[tin]))
        elif op == "tanh":
            tin, tout = int(p[1]), int(p[2])
            ts[tout] = np.tanh(ts[tin])
        elif op == "out":
            outs[p[1]] = ts[int(p[2])]
    return outs


# ---------------------------------------------------------------------------
# C runtime driver (ctypes)
# ---------------------------------------------------------------------------

SOURCE = NATIVE / "mcu_runtime.c"
# native/Makefile's CFLAGS, and its -lm
CFLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c99"]

_LIB = None
_TRIED = False
# each failed compiler's command and output (or the loader's error); None
# when the first compiler built the library and it loaded
build_log: Optional[str] = None


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED, build_log
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    failures, lib = [], None
    for cc in compilers("CC", ("cc", "gcc")):
        try:
            lib = ctypes.CDLL(str(build_library(
                SOURCE, cc, CFLAGS, "mcu", "libmcu.so", ("-lm",),
                root=BUILD_ROOT)))
            break
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            failures.append(str(e))
    if failures or lib is None:
        build_log = "\n".join(failures) or (
            "no C compiler: $CC, cc and gcc are not on PATH")
    if lib is None:
        return None
    lib.nvsb_load.restype = ctypes.c_void_p
    lib.nvsb_load.argtypes = [ctypes.c_char_p]
    lib.nvsb_free.argtypes = [ctypes.c_void_p]
    lib.nvsb_n_outputs.argtypes = [ctypes.c_void_p]
    lib.nvsb_n_outputs.restype = ctypes.c_int
    lib.nvsb_output_name.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.nvsb_output_name.restype = ctypes.c_char_p
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.nvsb_run.argtypes = [
        ctypes.c_void_p,
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        i32p, i32p, i32p]
    lib.nvsb_run.restype = ctypes.c_int
    _LIB = lib
    return _LIB


def c_runtime_available() -> bool:
    return _load() is not None


def run_bundle_c(path: str, image: np.ndarray) -> Dict[str, np.ndarray]:
    """Execute a .nvsb bundle with the native C runtime
    (native/mcu_runtime.c). image: (H, W, 3) float32. Raises where no C
    compiler built the runtime (``build_log`` says why)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the C MCU runtime could not be built or "
                           f"loaded:\n{build_log}")
    bd = lib.nvsb_load(path.encode())
    if not bd:
        raise ValueError(f"failed to load bundle {path}")
    try:
        n = lib.nvsb_n_outputs(bd)
        H, W, _ = image.shape
        oh = np.zeros(n, np.int32)
        ow = np.zeros(n, np.int32)
        oc = np.zeros(n, np.int32)
        img = np.ascontiguousarray(image, np.float32)
        # metadata pass (out=NULL)
        rc = lib.nvsb_run(bd, img, H, W, None, oh, ow, oc)
        if rc != 0:
            raise RuntimeError(
                f"nvsb_run metadata pass rc={rc} (input {H}x{W} not "
                "divisible by the downsample cell, or concat shape "
                "mismatch)")
        bufs = [np.zeros((int(oh[i]), int(ow[i]), int(oc[i])), np.float32)
                for i in range(n)]
        arr = (ctypes.POINTER(ctypes.c_float) * n)(
            *[b.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
              for b in bufs])
        rc = lib.nvsb_run(bd, img, H, W, arr, oh, ow, oc)
        if rc != 0:
            raise RuntimeError(f"nvsb_run rc={rc}")
        return {lib.nvsb_output_name(bd, i).decode(): bufs[i]
                for i in range(n)}
    finally:
        lib.nvsb_free(bd)
