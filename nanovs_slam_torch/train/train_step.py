"""The multitask train step, the counterpart of
``nanovs_slam_tpu/train/train_step.py``.

A step is two train-mode forwards (the augmented view first, then the
clean one, so the BN running statistics update in that order),
``post_process(eval_mode=False)`` (decode only: no kernel), the multitask
loss, backward, then the optimizer chain of the JAX package: NaN gradients
zeroed (``optax.zero_nans``), clipped by value at ``grad_clip``
(``optax.clip``), then adam / adamw / sgd at ``lr(step)``, with the
schedule read at the step count before the update (as optax does).
``metrics["grad_norm"]`` is the global norm of the raw gradients.

``qat`` (quantisation-aware training) runs both forwards on
``quant.qat_params``: every flax ``kernel`` leaf of the model (not of the
inlier net) fake-quantised to int8 per output channel, with a
straight-through gradient to the float weights.

``parallel`` (``parallel.data_parallel.DataParallel``) makes the step a
data-parallel one: each rank forwards its shard of the global batch and
the step equals the single-device step on the global batch (see there).

``freeze_backbone`` keeps the backbone out of the optimizer (the JAX
package zeroes its updates after the optimizer, which for adamw also
skips the weight decay; leaving the parameters out does the same). Its
gradients are still computed and counted in ``grad_norm``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Dict, List, Optional

import torch
import torch.nn as nn

from .. import quant
from ..configs import KP2DTinyConfig
from ..models.inlier_net import InlierNet
from ..ops.postprocess import post_process
from .multitask_loss import LossWeights, multitask_loss


@dataclasses.dataclass
class OptimizerSpec:
    """What ``make_optimizer`` chose; ``create_train_state`` builds the
    ``torch.optim`` optimizer from it over the trainable parameters."""
    name: str = "adam"
    lr: float = 3e-4
    weight_decay: float = 1e-5
    grad_clip: float = 1.0
    schedule: Optional[Callable[[int], float]] = None
    freeze_backbone: bool = False
    plateau: bool = False

    def build(self, params: List[nn.Parameter]) -> torch.optim.Optimizer:
        lr = self.schedule(0) if self.schedule is not None else self.lr
        if self.name == "adam":
            return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999),
                                    eps=1e-8)
        if self.name == "adamw":
            return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999),
                                     eps=1e-8, weight_decay=self.weight_decay)
        if self.name == "sgd":
            return torch.optim.SGD(params, lr=lr, momentum=0.9)
        raise ValueError(self.name)


def make_optimizer(name: str = "adam", lr=3e-4, weight_decay: float = 1e-5,
                   grad_clip: float = 1.0, schedule=None,
                   freeze_backbone: bool = False, plateau: bool = False
                   ) -> OptimizerSpec:
    """The optimizer choice (adam | adamw | sgd with momentum 0.9), its
    LR (``schedule`` of the step, or constant ``lr``; ``plateau`` makes
    the LR a value ``set_learning_rate`` changes between epochs), the
    clip by value and ``freeze_backbone``."""
    if name not in ("adam", "adamw", "sgd"):
        raise ValueError(name)
    if plateau:
        schedule = None
    return OptimizerSpec(name, float(lr), weight_decay, grad_clip, schedule,
                         freeze_backbone, plateau)


@dataclasses.dataclass
class TrainState:
    """The model and the inlier net (their parameters and BN buffers),
    the optimizer over the trainable parameters, and the step count."""
    model: nn.Module
    io_net: Optional[InlierNet]
    optimizer: torch.optim.Optimizer
    spec: OptimizerSpec
    param_names: List[str]  # the optimizer's parameters, in its order
    step: int = 0

    def named_parameters(self):
        """Every parameter with a gradient: the model's under ``model.``,
        the inlier net's under ``io.``."""
        yield from (("model." + k, p)
                    for k, p in self.model.named_parameters())
        if self.io_net is not None:
            yield from (("io." + k, p)
                        for k, p in self.io_net.named_parameters())


def create_train_state(model: nn.Module, spec: OptimizerSpec,
                       with_io: bool = True,
                       io_net: Optional[InlierNet] = None) -> TrainState:
    """A train state over ``model`` (already on its device) and, with
    ``with_io``, ``io_net`` (a new ``InlierNet(blocks=4)`` with PyTorch's
    initialisation where None), moved to the model's device."""
    dev = next(model.parameters()).device
    if with_io:
        io_net = (io_net or InlierNet(blocks=4)).to(dev)
    else:
        io_net = None
    state = TrainState(model, io_net, None, spec, [])
    named = [(k, p) for k, p in state.named_parameters()
             if not (spec.freeze_backbone
                     and k.startswith("model.backbone."))]
    state.param_names = [k for k, _ in named]
    state.optimizer = spec.build([p for _, p in named])
    return state


def set_learning_rate(state: TrainState, lr: float) -> TrainState:
    """Set a plateau optimizer's learning rate."""
    if not state.spec.plateau:
        raise ValueError("optimizer was not built with plateau=True")
    for group in state.optimizer.param_groups:
        group["lr"] = float(lr)
    return state


def get_learning_rate(state: TrainState) -> float:
    return float(state.optimizer.param_groups[0]["lr"])


def _nhwc(out: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.permute(0, 2, 3, 1) if v.dim() == 4 else v
            for k, v in out.items()}


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of all ``tensors`` (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(t.float() ** 2) for t in tensors))


def make_train_step(cfg: KP2DTinyConfig, H: int, W: int,
                    train_flags: Optional[Dict[str, bool]] = None,
                    io_top_k: int = 300, watch_gradients: bool = False,
                    qat: bool = False, parallel=None):
    """Returns train_step(state, batch, weights) -> (state, metrics) for
    the state's model and inlier net (no IO loss where it has none), with
    int8 fake-quantised kernels in the forwards where ``qat``.

    batch: image / image_aug (B,H,W,3) in [-1,1], seg / seg_aug (B,hs,ws)
    int, homography (B,3,3), optional depth / depth_aug (B,hs,ws,1), on
    the model's device (with ``parallel``: this rank's rows of the global
    batch). The state is updated in place and returned; metrics are 0-d
    tensors on the device (no host sync)."""
    n_cells = (H // cfg.cell) * (W // cfg.cell)
    dp = parallel

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   weights: LossWeights):
        state.model.train()
        if state.io_net is not None:
            state.io_net.train()
        fq = quant.qat_params(state.model) if qat else {}
        with (dp.forwards(state.model) if dp else contextlib.nullcontext()):
            out_aug = _nhwc(torch.func.functional_call(
                state.model, fq, (batch["image_aug"].permute(0, 3, 1, 2),)))
            out = _nhwc(torch.func.functional_call(
                state.model, fq, (batch["image"].permute(0, 3, 1, 2),)))
        if dp:  # the loss tail runs on the global batch on every rank
            out_aug, out = dp.gather_outputs(out_aug), dp.gather_outputs(out)
            batch = dp.gather_labels(batch)
        out_aug = post_process(out_aug, H, W, cfg.cell, cfg.cross_ratio,
                               eval_mode=False)
        out = post_process(out, H, W, cfg.cell, cfg.cross_ratio,
                           eval_mode=False)
        total, loss_dict = multitask_loss(
            out, out_aug, batch, H, W, weights,
            io_net=state.io_net,
            train_flags=train_flags, io_top_k=min(io_top_k, n_cells))

        opt = state.optimizer
        named = list(state.named_parameters())
        for _, p in named:
            p.grad = None
        total.backward()
        grads = [(k, p.grad) for k, p in named if p.grad is not None]
        if dp:
            dp.reduce_gradients(grads)
        metrics = {k: v.detach() for k, v in loss_dict.items()}
        metrics["grad_norm"] = global_norm(g for _, g in grads)
        if watch_gradients:
            for mod, _ in state.model.named_children():
                sub = [g for k, g in grads
                       if k.startswith(f"model.{mod}.")]
                if sub:
                    metrics[f"grad_norm/{mod}"] = global_norm(sub)
        clip = state.spec.grad_clip
        for _, g in grads:
            torch.nan_to_num_(g, nan=0.0, posinf=math.inf, neginf=-math.inf)
            g.clamp_(-clip, clip)
        if state.spec.schedule is not None:
            lr = state.spec.schedule(state.step)
            for group in opt.param_groups:
                group["lr"] = lr
        opt.step()
        state.step += 1
        return state, metrics

    return train_step
