"""Host-selected adaptive-depth LightGlue (a real early exit), the
counterpart of ``nanovs_slam_tpu/matching/adaptive.py`` (reference
lightglue/lightglue.py:560-638).

The embedding, each layer, the confident-token ratio and the final
assignment run as separate stages, and the host decides how deep to go:
after each non-final layer it reads one scalar (the ratio) and stops once
that exceeds ``depth_confidence``. Layers after the exit are never
launched. On a CUDA device each layer is one call of the LightGlue kernel
(``LightGlue.run_layers(range(i, i + 1), ...)``); on the CPU the plain
blocks run.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .lightglue import LightGlue

Tensor = torch.Tensor


class AdaptiveLightGlue:
    """Runs a LightGlue module (weights loaded, on its device) stage by
    stage.

    Usage:
        alg = AdaptiveLightGlue(model, depth_confidence=0.95)
        pred = alg(data)   # data as for LightGlue.forward
        pred["exit_layer"] -> the 0-based layer whose assigner finalized
    """

    def __init__(self, model: LightGlue, depth_confidence: float = 0.95):
        self.model = model.eval()
        self.depth_confidence = depth_confidence
        self.n_layers = model.cfg.n_layers

    @torch.inference_mode()
    def __call__(self, data: Dict[str, Tensor],
                 max_depth: Optional[int] = None) -> Dict[str, Tensor]:
        m = self.model
        mask0, mask1 = data.get("mask0"), data.get("mask1")
        desc0, desc1, enc0, enc1 = m.embed(data)
        depth = self.n_layers if max_depth is None else max_depth
        exit_layer = depth - 1
        for i in range(depth):
            desc0, desc1 = m.run_layers(range(i, i + 1), desc0, desc1, enc0,
                                        enc1, mask0, mask1)
            # the one host read a layer
            if i < depth - 1 and float(m.stop_ratio(i, desc0, desc1)) \
                    > self.depth_confidence:
                exit_layer = i
                break
        pred = dict(m.finalize(exit_layer, desc0, desc1, mask0, mask1))
        pred["exit_layer"] = exit_layer
        return pred


def early_exit_forward(model: LightGlue, data: Dict[str, Tensor],
                       depth_confidence: float = 0.95) -> Dict[str, Tensor]:
    """The early exit as one call: the finalize dict of the exit layer
    plus "exit_layer" (0-based).

    The JAX function runs it inside one XLA program (a ``lax.while_loop``
    over the layers with the predicate in its carry). PyTorch has no
    in-graph loop, so this runs the same host loop as
    ``AdaptiveLightGlue``, with the same result. A one-layer config runs
    its layer 0 here; the JAX function finalizes the embedded descriptors
    without running it."""
    return AdaptiveLightGlue(model, depth_confidence)(data)
