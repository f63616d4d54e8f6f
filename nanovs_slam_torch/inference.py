"""The inference pipeline (the serving product): model forward, fused
postprocess (border mask, coordinate decode, descriptor sampling + L2),
segmentation argmax and optional fixed-K keypoint selection. The counterpart
of ``nanovs_slam_tpu/inference.py::make_infer_fn``.

The model is a KP2DTiny (``configs.KP2DTinyConfig``) or a KeypointFormer
(``models.keypoint_former.KeypointFormerConfig``). A KeypointFormer, like
KP2DTiny V3, takes no ``heads=`` and computes every head; its config has no
``variant`` or ``depth``, and none is read from it.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from . import quant
from .configs import KP2DTinyConfig
from .ops.image import to_model_input
from .ops.postprocess import post_process, top_k_keypoints
from .utils.device import resolve_device

Tensor = torch.Tensor


def has_depth(cfg) -> bool:
    """Whether the model has a depth head (a KP2DTiny config with depth)."""
    return isinstance(cfg, KP2DTinyConfig) and cfg.depth


def int8_context(int8_scales: Optional[Dict[str, float]]):
    """Chained ``quant.int8_execution`` where scales are given, else no
    context."""
    if int8_scales is None:
        return contextlib.nullcontext()
    return quant.int8_execution(int8_scales, chain=True)


def forward_post_process(model: nn.Module, cfg, x: Tensor,
                         H: int, W: int, heads) -> Dict[str, Tensor]:
    """x (B, H, W, 3) model input in [-1, 1] on the model's device -> the
    eval ``post_process`` of the asked-for heads (V2; V3 and KeypointFormer
    compute every head), NHWC."""
    v2 = isinstance(cfg, KP2DTinyConfig) and cfg.variant != "v3"
    kw = {"heads": heads} if v2 else {}
    out = model(x.permute(0, 3, 1, 2).contiguous(), **kw)
    nhwc = {k: v.permute(0, 2, 3, 1) if v.dim() == 4 else v
            for k, v in out.items()}
    return post_process(nhwc, H, W, cfg.cell, cfg.cross_ratio, eval_mode=True)


def request_heads(cfg, with_seg: bool, with_vlad: bool) -> tuple:
    """The heads a request computes (V2; V3 computes them all)."""
    return ("score", "loc", "desc") + (("seg",) if with_seg else ()) \
        + (("vlad",) if with_vlad else ()) \
        + (("depth",) if has_depth(cfg) else ())


def request_result(post: Dict[str, Tensor], with_seg: bool, with_vlad: bool,
                   top_k: Optional[int], conf_threshold: float
                   ) -> Dict[str, Tensor]:
    """An ``infer`` result from the eval ``post_process`` of a request:
    its keys as ``make_infer_fn`` says, keypoints with ``top_k``."""
    result = {k: post[k] for k in ("score", "coord", "feat")}
    if with_seg:
        result["seg"] = post["seg"]
    if with_vlad:
        result["vlad"] = post["vlad"]
    if "depth" in post:
        result["depth"] = post["depth"]
    if top_k is not None:
        kp, s, d, valid = top_k_keypoints(
            post["score"], post["coord"], post["feat"], top_k,
            conf_threshold)
        result.update(keypoints=kp, keypoint_scores=s, descriptors=d,
                      keypoint_valid=valid)
    return result


def make_infer_fn(model: nn.Module, cfg, H: int, W: int,
                  top_k: Optional[int] = None, conf_threshold: float = 0.0,
                  with_seg: bool = True, with_vlad: bool = True,
                  device=None,
                  int8_scales: Optional[Dict[str, float]] = None
                  ) -> Callable[[Tensor], Dict[str, Tensor]]:
    """Returns ``infer(images) -> dict`` on ``device`` (default "cuda"; a
    CUDA device without a card raises). ``model`` is moved to the device and
    put in eval mode.

    images: (B, H, W, 3) uint8 frames or float frames in [0, 1] (a tensor
    or a numpy array), normalised to [-1, 1] on the device.

    The result has the keys of the JAX ``infer``: score (B,Hc,Wc,1), coord
    (B,Hc,Wc,2), feat (B,Hc,Wc,C); seg (B,Hs,Ws,1) int32 if ``with_seg``;
    vlad (B,D) if ``with_vlad``; depth (B,Hs,Ws,1) where the config has
    it; and with ``top_k`` keypoints (B,K,2), keypoint_scores (B,K),
    descriptors (B,K,C), keypoint_valid (B,K). V2 computes only the heads
    whose output is asked for; V3 and KeypointFormer, like the JAX models,
    compute them all.

    ``int8_scales`` (``quant.calibrate_conv_scales``): every calibrated
    ``ConvBNAct`` runs int8 (``quant.int8_execution``), chained over
    ``quant.BACKBONE_CHAIN``, as the JAX ``make_infer_fn``'s default.
    """
    dev = resolve_device(device)
    model.to(dev).eval()
    heads = request_heads(cfg, with_seg, with_vlad)

    @torch.inference_mode()
    def infer(images) -> Dict[str, Tensor]:
        if isinstance(images, np.ndarray):
            images = torch.from_numpy(images)
        if tuple(images.shape[1:]) != (H, W, 3):
            raise ValueError(f"images must be (B, {H}, {W}, 3), got "
                             f"{tuple(images.shape)}")
        x = to_model_input(images.to(dev, non_blocking=True))
        with int8_context(int8_scales):
            post = forward_post_process(model, cfg, x, H, W, heads)
        return request_result(post, with_seg, with_vlad, top_k,
                              conf_threshold)

    return infer


def make_eval_fn(model: nn.Module, cfg, H: int, W: int,
                 int8_scales: Optional[Dict[str, float]] = None
                 ) -> Callable[[np.ndarray], Dict[str, np.ndarray]]:
    """The evaluators' ``infer_np`` on the model's device: model input
    (B, H, W, 3) already in [-1, 1] (numpy; taken as it is, as the JAX
    ``infer`` takes it, not normalised again) -> numpy score, coord, feat,
    seg, vlad (and depth where the config has it), as ``make_infer_fn``
    with its defaults computes them (int8 as there, with ``int8_scales``).
    The model is put in eval mode at each call; the caller restores
    training mode."""
    dev = next(model.parameters()).device
    heads = ("score", "loc", "desc", "seg", "vlad") + (
        ("depth",) if has_depth(cfg) else ())

    @torch.inference_mode()
    def infer_np(images: np.ndarray) -> Dict[str, np.ndarray]:
        x = torch.from_numpy(np.ascontiguousarray(images, np.float32))
        if tuple(x.shape[1:]) != (H, W, 3):
            raise ValueError(f"images must be (B, {H}, {W}, 3), got "
                             f"{tuple(x.shape)}")
        model.eval()
        with int8_context(int8_scales):
            post = forward_post_process(model, cfg, x.to(dev), H, W, heads)
        return {k: (v.float() if v.is_floating_point() else v).cpu().numpy()
                for k, v in post.items()
                if k in ("score", "coord", "feat", "seg", "vlad", "depth")}

    return infer_np
