"""Carry JAX (flax) weights across into the port's ``state_dict``.

The port's modules keep the flax module names, so a flax path maps to a
torch key by joining with ``.`` and renaming the leaf:

- conv ``kernel`` HWIO -> ``weight`` OIHW (``permute(3, 2, 0, 1)``);
- transposed-conv ``kernel`` (kH, kW, O, I) -> ConvTranspose2d ``weight``
  (I, O, kH, kW), the same permutation (the layout rule of the JAX
  package's inference mirror);
- BN ``scale``/``bias`` -> ``weight``/``bias``; batch stats ``mean``/``var``
  -> ``running_mean``/``running_var``;
- NetVLAD ``assign_w`` (C, K) and ``centroids`` (K, C) carry over as they are.

LightGlue (``load_jax_lightglue``) has Dense layers instead of convs:

- Dense ``kernel`` (in, out) -> ``Linear.weight`` (out, in);
- LayerNorm ``scale``/``bias`` -> ``weight``/``bias``;
- ``posenc/Wr`` (2, head_dim/2) carries over as it is: the port's module
  keeps the flax layout.

The inlier net (``load_jax_inlier_net``) has Dense layers too, and BNs.
KeypointFormer (``models/keypoint_former.py``) keeps the flax names as
KP2DTiny does, so ``load_jax_variables`` loads its tree as it is
(ChannelLayerNorm ``g`` / ``b`` and NetVLAD's ``assign_b`` carry over as
they are). ``to_jax_variables`` is the way back (port -> flax-layout
numpy trees), which ``utils/checkpoint.save_checkpoint`` writes, for
KP2DTiny and KeypointFormer alike; ``to_jax_lightglue`` is
``load_jax_lightglue``'s.

Inputs are nested dicts of numpy arrays (flax ``params``/``batch_stats``) or
flat dicts with ``/``-joined keys as stored in a pinned ``.npz``.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn

_LEAF = {"scale": "weight", "mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, key + "/"))
        else:
            out[key] = np.asarray(v)
    return out


def _torch_entry(path: str, value: np.ndarray, dense: bool = False):
    """One flax leaf -> (torch key, tensor). ``kernel`` leaves are conv
    kernels (4-D), or Dense kernels (2-D) where ``dense``."""
    parts = path.split("/")
    leaf = parts[-1]
    t = torch.from_numpy(np.array(value, np.float32))
    if leaf == "kernel" and dense:
        if t.dim() != 2:
            raise ValueError(f"{path}: expected a 2-D Dense kernel, got "
                             f"{tuple(t.shape)}")
        t = t.t().contiguous()
        leaf = "weight"
    elif leaf == "kernel":
        if t.dim() != 4:
            raise ValueError(f"{path}: expected a 4-D conv kernel, got "
                             f"{tuple(t.shape)}")
        t = t.permute(3, 2, 0, 1).contiguous()
        leaf = "weight"
    parts[-1] = _LEAF.get(leaf, leaf)
    return ".".join(parts), t


def convert_variables(params: Mapping, batch_stats: Mapping,
                      dense: bool = False) -> Dict[str, torch.Tensor]:
    """flax ``params`` and ``batch_stats`` -> torch state_dict entries
    (``kernel`` leaves of Dense layers where ``dense``)."""
    out: Dict[str, torch.Tensor] = {}
    for tree in (params, batch_stats):
        for path, value in _flatten(tree).items():
            key, t = _torch_entry(path, value, dense)
            if key in out:
                raise ValueError(f"duplicate key {key} from {path}")
            out[key] = t
    return out


def load_state_strict(model: nn.Module, sd: Dict[str, torch.Tensor],
                      absent: tuple = ()) -> nn.Module:
    """``sd`` into ``model`` in place: every key of the model but BN's
    ``num_batches_tracked`` must receive a value of its shape, and every
    key of ``sd`` must exist in the model (keys starting with one of
    ``absent`` are exempt on both sides)."""
    target = {k: v for k, v in model.state_dict().items()
              if not k.endswith("num_batches_tracked")}
    missing = sorted(k for k in target.keys() - sd.keys()
                     if not k.startswith(absent))
    unexpected = sorted(k for k in sd.keys() - target.keys()
                        if not k.startswith(absent))
    if missing or unexpected:
        raise KeyError(f"unmatched keys: missing {missing}, "
                       f"unexpected {unexpected}")
    load = {k: v for k, v in sd.items() if k in target}
    for k, v in load.items():
        if tuple(v.shape) != tuple(target[k].shape):
            raise ValueError(f"{k}: shape {tuple(v.shape)} does not match "
                             f"the model's {tuple(target[k].shape)}")
    model.load_state_dict(load, strict=False)
    return model


def load_jax_variables(model: nn.Module, params: Mapping,
                       batch_stats: Mapping,
                       absent_heads: Iterable[str] = ()) -> nn.Module:
    """Load flax variables into ``model`` in place and return it.

    Every key of the model (apart from BN's ``num_batches_tracked``) must
    receive a value and every converted key must exist in the model, with
    the same shape. Keys under a head named in ``absent_heads`` (e.g.
    ``"vlad_head"``) are exempt on both sides: the model keeps its own
    values there.
    """
    return load_state_strict(model, convert_variables(params, batch_stats),
                        tuple(f"{h}." for h in absent_heads))


def merge_jax_variables(model: nn.Module, params: Mapping,
                        batch_stats: Mapping, dense: bool = False
                        ) -> nn.Module:
    """Overlay flax variables on ``model`` in place (a partial restore:
    the model's keys that the trees lack keep their values). Every
    converted key must exist in the model with the same shape. ``dense``
    for Dense layers (the inlier net)."""
    sd = convert_variables(params, batch_stats, dense)
    target = model.state_dict()
    unexpected = sorted(sd.keys() - target.keys())
    if unexpected:
        raise KeyError(f"unmatched keys: unexpected {unexpected}")
    for k, v in sd.items():
        if tuple(v.shape) != tuple(target[k].shape):
            raise ValueError(f"{k}: shape {tuple(v.shape)} does not match "
                             f"the model's {tuple(target[k].shape)}")
    model.load_state_dict(sd, strict=False)
    return model


def load_jax_lightglue(model: nn.Module, params: Mapping) -> nn.Module:
    """Load flax LightGlue ``params`` into the port's ``LightGlue`` in
    place and return it; raises on any unmatched key on either side and on
    any shape mismatch."""
    sd: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(params).items():
        key, t = _torch_entry(path, value, dense=True)
        sd[key] = t
    return load_state_strict(model, sd)


def load_jax_inlier_net(net: nn.Module, params: Mapping,
                        batch_stats: Mapping) -> nn.Module:
    """Load flax InlierNet ``io_params`` / ``io_batch_stats`` (Dense
    layers) into the port's ``InlierNet`` in place and return it; strict
    as ``load_jax_variables``."""
    return load_state_strict(net, convert_variables(params, batch_stats, True))


def to_jax_lightglue(model: nn.Module) -> Dict:
    """The reverse of ``load_jax_lightglue``: a ``LightGlue``'s flax
    ``params`` as nested dicts of numpy arrays (Linear -> Dense kernel (in,
    out), LayerNorm ``weight`` -> ``scale``, ``posenc/Wr`` as it is)."""
    params, stats = to_jax_variables(model)
    if stats:
        raise ValueError("to_jax_lightglue: the matcher has no BN "
                         f"statistics, got {sorted(stats)}")
    return params


def to_jax_variables(model: nn.Module) -> Tuple[Dict, Dict]:
    """The reverse of ``convert_variables`` / ``load_jax_inlier_net``:
    ``model``'s parameters and BN statistics as flax-layout nested dicts
    of numpy arrays (params, batch_stats). Conv weights OIHW -> HWIO and
    ConvTranspose2d (I, O, kH, kW) -> (kH, kW, O, I) (both
    ``permute(2, 3, 1, 0)``), Linear (out, in) -> Dense kernel (in, out),
    BN and LayerNorm ``weight`` -> ``scale``, running stats -> ``mean`` /
    ``var``; other leaves keep their names."""
    params: Dict = {}
    stats: Dict = {}

    def put(tree, key, value):
        *path, leaf = key.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = value.detach().cpu().numpy()

    modules = dict(model.named_modules())
    for key, value in model.state_dict(keep_vars=True).items():
        owner, _, leaf = key.rpartition(".")
        mod = modules[owner]
        if leaf == "num_batches_tracked":
            continue
        if leaf in ("running_mean", "running_var"):
            put(stats, f"{owner}.{leaf[len('running_'):]}", value)
            continue
        flax = _flax_leaf(mod, leaf)
        if flax == "kernel":
            value = value.t() if isinstance(mod, nn.Linear) \
                else value.permute(2, 3, 1, 0)
        put(params, f"{owner}.{flax}" if owner else flax, value)
    return params, stats


def _flax_leaf(mod: nn.Module, leaf: str) -> str:
    """The flax name of parameter ``leaf`` of ``mod``: a conv's,
    transposed conv's or Linear's ``weight`` is a ``kernel``, another
    module's ``weight`` (BatchNorm, LayerNorm) a ``scale``; the rest keep
    their names."""
    if leaf != "weight":
        return leaf
    if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
        return "kernel"
    return "scale"


def kernel_parameters(model: nn.Module) -> Dict[str, nn.Parameter]:
    """The parameters of ``model`` that are flax ``kernel`` leaves (conv,
    transposed-conv and Linear weights; ``to_jax_variables``'s map), by
    name. Their dim 0 is the flax kernel's last axis (OIHW O; the
    transposed conv's (I, O, kH, kW) I; Linear's out)."""
    modules = dict(model.named_modules())
    out = {}
    for key, p in model.named_parameters():
        owner, _, leaf = key.rpartition(".")
        if _flax_leaf(modules[owner], leaf) == "kernel":
            out[key] = p
    return out
