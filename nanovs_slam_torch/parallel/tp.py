"""Head-parallel LightGlue (tensor parallelism over the attention heads),
the counterpart of ``nanovs_slam_tpu/parallel/tp.py``: the Megatron
pattern over a mesh's ranks.

- Column-parallel (the rank keeps its rows of the torch weight (out, in)
  and of the bias): ``Wqkv``, ``to_qk``, ``to_v``, ``fc1``. The packed
  ``Wqkv`` is head-major (channel = h * 3 dh + i * 3 + {q, k, v},
  ``matching/lightglue.py``), so a contiguous chunk is whole heads, as
  are ``to_qk`` and ``to_v``'s.
- Row-parallel (the rank keeps its columns of the weight; the bias is
  whole and added once): ``out_proj``, ``to_out``, ``fc2``; their partial
  products are all-reduced.
- The FFN's LayerNorm normalises over the whole 2D hidden of which
  ``fc1`` gives each rank a slice: its mean and variance are all-reduced
  (two passes), its scale and bias are split like the hidden.

Each rank holds only its heads' share of the transformer weights and runs
the plain ``TransformerLayer`` of ``matching/lightglue.py`` (its self,
cross and FFN blocks unchanged) on its heads, with the row-parallel
layers and the FFN's LayerNorm swapped for the synced ones here; the
embedding, the token confidences and the assignment are replicated. The JAX TP also runs flax's plain blocks (GSPMD never reaches
the Pallas kernel), and so does this module on the card; the result is
the replicated forward's. Use: latency-bound matching of one pair, where
data parallelism has no batch to split.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..matching.lightglue import TransformerLayer
from .mesh import Mesh, all_reduce

Tensor = torch.Tensor

COLUMN = ("Wqkv", "to_qk", "to_v", "fc1")
ROW = ("out_proj", "to_out", "fc2")


def lightglue_param_specs(state: Mapping[str, Tensor]
                          ) -> Dict[str, Optional[int]]:
    """The dim of each LightGlue weight (torch names, ``state_dict``
    layout) that is split over the ranks: 0 for a column-parallel layer's
    weight and bias and for the FFN LayerNorm's scale and bias (they live
    on fc1's split hidden), 1 for a row-parallel layer's weight, None for
    everything replicated (row-parallel biases, the positional encoding,
    the assignment and confidence heads)."""
    specs: Dict[str, Optional[int]] = {}
    for name in state:
        parts = name.split(".")
        spec = None
        if parts[0].startswith("transformers_"):
            if any(p in COLUMN for p in parts):
                spec = 0
            elif any(p in ROW for p in parts):
                spec = 1 if parts[-1] == "weight" else None
            elif "norm" in parts:
                spec = 0
        specs[name] = spec
    return specs


def _torch_state(variables) -> Dict[str, Tensor]:
    """A LightGlue module, its ``state_dict``, or the JAX package's
    LightGlue ``params`` (flax names) -> a torch ``state_dict``."""
    if isinstance(variables, nn.Module):
        return variables.state_dict()
    first = next(iter(variables.values()))
    if isinstance(first, Tensor):
        return dict(variables)
    from ..utils.convert import _flatten, _torch_entry

    tree = variables.get("params", variables)
    return dict(_torch_entry(p, v, dense=True)
                for p, v in _flatten(tree).items())


def tp_shard_variables(mesh: Mesh, variables) -> Dict[str, Tensor]:
    """This rank's shard of the transformer weights (``variables``: a
    LightGlue, its ``state_dict`` or the JAX params), on the mesh's
    device: every split weight cut into ``mesh.size`` equal chunks along
    its spec's dim (the heads must divide), the rank's chunk kept; the
    replicated transformer weights (row-parallel biases) whole. Weights
    outside the transformer layers are left out: they stay with the
    module."""
    state = _torch_state(variables)
    specs = lightglue_param_specs(state)
    out = {}
    for k, t in state.items():
        if not k.startswith("transformers_"):
            continue
        d = specs[k]
        if d is not None:
            if t.shape[d] % mesh.size:
                raise ValueError(f"{k}: dim {d} of {tuple(t.shape)} does "
                                 f"not split over {mesh.size} ranks")
            t = t.chunk(mesh.size, d)[mesh.rank]
        out[k] = t.detach().to(mesh.device).contiguous()
    return out


class RowParallelLinear(nn.Module):
    """A row-parallel layer: the rank's columns of the weight over its
    slice of the input, the partial products summed over the ranks, then
    the whole bias."""

    def __init__(self, mesh: Mesh, weight: Tensor, bias: Tensor):
        super().__init__()
        self.mesh = mesh
        self.weight = nn.Parameter(weight, requires_grad=False)
        self.bias = nn.Parameter(bias, requires_grad=False)

    def forward(self, x: Tensor) -> Tensor:
        return all_reduce(self.mesh, F.linear(x, self.weight)) + self.bias


class SyncedLayerNorm(nn.Module):
    """LayerNorm over a hidden that is split over the ranks (the rank holds
    its slice of it, of the scale and of the bias): the mean, then the
    variance, all-reduced."""

    def __init__(self, mesh: Mesh, weight: Tensor, bias: Tensor,
                 eps: float):
        super().__init__()
        self.mesh, self.eps = mesh, eps
        self.weight = nn.Parameter(weight, requires_grad=False)
        self.bias = nn.Parameter(bias, requires_grad=False)

    def forward(self, y: Tensor) -> Tensor:
        width = y.shape[-1] * self.mesh.size
        mean = all_reduce(self.mesh, y.sum(-1, keepdim=True)) / width
        var = all_reduce(self.mesh, ((y - mean) ** 2).sum(-1, keepdim=True)
                         ) / width
        return (y - mean) * torch.rsqrt(var + self.eps) * self.weight \
            + self.bias


def tp_layer(mesh: Mesh, shard: Dict[str, Tensor], i: int, dim: int,
             heads: int) -> TransformerLayer:
    """Layer ``i`` of the stack as the plain ``TransformerLayer`` over this
    rank's ``heads / mesh.size`` heads, from its ``shard``: the
    column-parallel layers are plain ``nn.Linear``s of the rank's rows,
    the row-parallel ones ``RowParallelLinear``, the FFN's LayerNorm
    ``SyncedLayerNorm``."""
    if heads % mesh.size:
        raise ValueError(f"{heads} heads do not split over {mesh.size} "
                         f"ranks")
    with torch.device("meta"):
        layer = TransformerLayer(dim, heads // mesh.size)
    for name, mod in list(layer.named_modules()):
        parent, _, leaf = name.rpartition(".")
        w = shard.get(f"transformers_{i}.{name}.weight")
        b = shard.get(f"transformers_{i}.{name}.bias")
        if leaf in COLUMN:
            new = nn.Linear(w.shape[1], w.shape[0], device="meta")
            new.load_state_dict({"weight": w, "bias": b}, assign=True)
        elif leaf in ROW:
            new = RowParallelLinear(mesh, w, b)
        elif leaf == "norm":
            new = SyncedLayerNorm(mesh, w, b, mod.eps)
        else:
            continue
        setattr(layer.get_submodule(parent), leaf, new)
    return layer.eval()


def tp_lightglue_forward(mesh: Mesh, model, variables=None):
    """``run(data) -> pred``: LightGlue's inference forward (``model``'s
    config, its embedding, confidences and assignment, replicated) with
    the transformer layers head-parallel over ``mesh`` (its last axis),
    from this rank's shard of ``variables`` (default: the model's own
    weights). Inputs and outputs are whole on every rank, on the mesh's
    device; the result equals ``model(data)``."""
    mesh = mesh.axis(mesh.axis_names[-1])
    cfg = model.cfg
    model.to(mesh.device).eval()
    shard = tp_shard_variables(mesh, model if variables is None
                               else variables)
    L = cfg.n_layers
    layers = [tp_layer(mesh, shard, i, cfg.descriptor_dim, cfg.num_heads)
              for i in range(L)]

    @torch.inference_mode()
    def run(data: Dict[str, Tensor]) -> Dict[str, Tensor]:
        data = {k: v.to(mesh.device) for k, v in data.items()}
        mask0, mask1 = data.get("mask0"), data.get("mask1")
        desc0, desc1, enc0, enc1 = model.embed(data)
        stopped = torch.zeros((), dtype=torch.bool, device=desc0.device)
        for i in range(L):
            new0, new1 = layers[i](desc0, desc1, enc0, enc1, mask0, mask1)
            if cfg.depth_confidence > 0:  # value-level early exit
                desc0 = torch.where(stopped, desc0, new0)
                desc1 = torch.where(stopped, desc1, new1)
                if i < L - 1:
                    stopped = stopped | (model.stop_ratio(i, desc0, desc1)
                                         > cfg.depth_confidence)
            else:
                desc0, desc1 = new0, new1
        pred = model.finalize(L - 1, desc0, desc1, mask0, mask1)
        pred["ref_descriptors0"] = desc0[:, None]
        pred["ref_descriptors1"] = desc1[:, None]
        return pred

    return run
