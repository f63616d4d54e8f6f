"""Model export, the counterpart of ``nanovs_slam_tpu/export.py``.

- ``make_export_fn``: images -> (score, coord, feat, vlad, seg), the model
  forward (every head) and the eval ``post_process``, the JAX package's
  export function.
- ``export_program`` / ``load_program``: that function as a
  ``torch.export`` program (``.pt2``), where the JAX package writes
  StableHLO.
- ``export_onnx``: the reference's ONNX contract (opset 16, input "image"
  (1, 3, H, W), outputs score, coord, desc, vlad, seg (+ depth) of the
  model forward) for KP2DTiny and KeypointFormer, through
  ``torch.onnx.export(dynamo=False)``.

The port's kernels are bound by ``ctypes``, which neither tracer can pass
through, so every export traces a CPU copy of the model, where each
kernel wrapper runs its plain twin (as the JAX export traces XLA's
``post_process``, not the Pallas kernel).
"""

from __future__ import annotations

import copy
from typing import Tuple

import torch
import torch.nn as nn

from .ops.postprocess import post_process

# the reference's ONNX output names (export_onnx.py:70-79), depth after
ONNX_OUTPUTS = ("score", "coord", "desc", "vlad", "seg")


class ExportModule(nn.Module):
    """images (B, H, W, 3) model input in [-1, 1] -> (score (B,Hc,Wc,1),
    coord (B,Hc,Wc,2), feat (B,Hc,Wc,C), vlad (B,D), seg (B,Hs,Ws,1)
    int32): every head of ``model`` (eval mode), then ``post_process``."""

    def __init__(self, model: nn.Module, cfg, H: int, W: int):
        super().__init__()
        self.model, self.cfg, self.H, self.W = model.eval(), cfg, H, W

    def forward(self, images: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        out = self.model(images.permute(0, 3, 1, 2))
        nhwc = {k: v.permute(0, 2, 3, 1) if v.dim() == 4 else v
                for k, v in out.items()}
        post = post_process(nhwc, self.H, self.W, self.cfg.cell,
                            self.cfg.cross_ratio, eval_mode=True)
        return tuple(post[k] for k in ("score", "coord", "feat", "vlad",
                                       "seg"))


def make_export_fn(model: nn.Module, cfg, H: int, W: int):
    """fn(images) -> (score, coord, feat, vlad, seg) on the model's
    device, under ``torch.inference_mode``."""
    module = ExportModule(model, cfg, H, W)

    @torch.inference_mode()
    def fn(images: torch.Tensor):
        return module(images)

    return fn


def _cpu_copy(model: nn.Module) -> nn.Module:
    return copy.deepcopy(model).cpu().eval()


def export_program(model: nn.Module, cfg, H: int, W: int, path: str,
                   batch: int = 1) -> str:
    """``make_export_fn``'s function for (batch, H, W, 3) float32 input as
    a ``torch.export`` program saved to ``path`` (``.pt2``)."""
    module = ExportModule(_cpu_copy(model), cfg, H, W)
    with torch.no_grad():
        program = torch.export.export(
            module, (torch.zeros(batch, H, W, 3),))
    torch.export.save(program, path)
    return path


def load_program(path: str) -> torch.export.ExportedProgram:
    """An ``export_program`` file; ``load_program(p).module()(images)``
    runs it."""
    return torch.export.load(path)


class _OnnxModule(nn.Module):
    """(1, 3, H, W) -> the model's raw (score, coord, feat, vlad, seg[,
    depth]) NCHW, the reference export tuple."""

    def __init__(self, model: nn.Module, names: Tuple[str, ...]):
        super().__init__()
        self.model, self.keys = model, tuple(
            "feat" if n == "desc" else n for n in names)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        out = self.model(x)
        return tuple(out[k] for k in self.keys)


def _skip_onnxscript_pass() -> None:
    """Without the ``onnx`` package the TorchScript exporter's last step,
    which adds onnxscript functions (none in a plain ATen graph), cannot
    run: make it return the model bytes as they are. Its module moved
    between torch releases; raise if neither place has it."""
    try:
        import onnx  # noqa: F401
        return
    except ImportError:
        pass
    import importlib

    for name in ("torch.onnx._internal.torchscript_exporter."
                 "onnx_proto_utils", "torch.onnx.utils"):
        try:
            mod = importlib.import_module(name)
        except ImportError:
            continue
        if hasattr(mod, "_add_onnxscript_fn"):
            mod._add_onnxscript_fn = \
                lambda model_bytes, custom_opsets: model_bytes
            return
    raise RuntimeError("the onnx package is missing and this torch has no "
                       "_add_onnxscript_fn to skip (looked in torch.onnx."
                       "_internal.torchscript_exporter.onnx_proto_utils and "
                       "torch.onnx.utils)")


def export_onnx(model: nn.Module, path: str, im_h: int, im_w: int,
                opset: int = 16) -> str:
    """``model`` (KP2DTiny or KeypointFormer) as an ONNX file with the
    reference's contract: opset ``opset``, input "image" (1, 3, H, W),
    outputs score, coord, desc, vlad, seg and, where the config has it,
    depth."""
    _skip_onnxscript_pass()
    names = ONNX_OUTPUTS + (
        ("depth",) if getattr(model.cfg, "depth", False) else ())
    module = _OnnxModule(_cpu_copy(model), names).eval()
    with torch.no_grad():
        torch.onnx.export(module, torch.randn(1, 3, im_h, im_w), path,
                          opset_version=opset, input_names=["image"],
                          output_names=list(names),
                          do_constant_folding=False, dynamo=False)
    return path
