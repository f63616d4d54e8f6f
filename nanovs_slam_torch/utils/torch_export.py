"""The port's KP2DTiny weights as a reference PyTorch state_dict, the
counterpart of ``nanovs_slam_tpu/utils/torch_export.py``: the inverse of
``torch_import.convert_state_dict``.

``export_state_dict(model, template)``: with ``template`` (the reference
model's own state_dict) its names, shapes and bookkeeping entries
(``num_batches_tracked``, quantisation stubs) are kept, every other entry
taking the port's value under ``torch_import``'s map. Without one the
names are the reference's as that map inverts them: ``convAa`` /
``convBb`` -> ``confAa`` / ``confBb``, ``convs_N`` -> ``convs.N``, the
descriptor head's ``upsample1`` (an ``UpscaleHead`` has no second) ->
``upsample``, the attention's PreNorm paths (``norm_att`` -> ``att.norm``,
``att`` -> ``att.fn``, ``mff.dw`` -> ``mff.fn.net.1.net.0``, ...), NetVLAD's
``assign_w`` (C, K) -> ``conv.weight`` (K, C, 1, 1) and a LayerNorm's
``g`` / ``b`` -> (1, C, 1, 1); ``num_batches_tracked`` is kept.

``save_torch_checkpoint`` writes a reference ``.ckpt``: ``torch.save`` of
``{"state_dict": {"keypoint_net." + name: tensor}, "config": ...}``, which
``torch_import.load_torch_checkpoint`` (and the JAX package's) reads.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import torch
import torch.nn as nn

from .torch_import import REFERENCE_PREFIX, convert_entry

Tensor = torch.Tensor
MODULE_NAMES = {"convAa": ["confAa"], "convBb": ["confBb"],
                "norm_att": ["att", "norm"], "att": ["att", "fn"],
                "norm_mff": ["mff", "norm"], "mff": ["mff", "fn"]}
MFF_NAMES = {"expand": ["net", "0"], "dw": ["net", "1", "net", "0"],
             "pw": ["net", "1", "net", "1"], "project": ["net", "3"]}


def reference_name(key: str, keys) -> str:
    """The reference's name of the port's state_dict ``key`` (``keys``:
    all of them, which tell a lone upsampler)."""
    *parts, leaf = key.split(".")
    out = []
    for i, p in enumerate(parts):
        parent = parts[i - 1] if i else ""
        if p.startswith("convs_") and p[6:].isdigit():
            out += ["convs", p[6:]]
        elif parent == "mff" and p in MFF_NAMES:
            out += MFF_NAMES[p]
        elif p == "upsample1" and not any(
                k.startswith(".".join(parts[:i] + ["upsample2"]) + ".")
                for k in keys):
            out.append("upsample")
        else:
            out += MODULE_NAMES.get(p, [p])
    if leaf == "assign_w":
        out, leaf = out + ["conv"], "weight"
    return ".".join(out + [leaf])


def _reference_value(key: str, value: Tensor, shape=None) -> Tensor:
    """The port's ``value`` of ``key`` in the reference's layout."""
    value = value.detach().cpu()
    if key.endswith(".assign_w"):
        return value.t()[:, :, None, None].contiguous()
    if key.endswith((".g", ".b")):
        return value.reshape(shape or (1, -1, 1, 1)).contiguous()
    return value.clone()


def export_state_dict(model: nn.Module,
                      template: Optional[Mapping[str, Any]] = None
                      ) -> Dict[str, Tensor]:
    """``model``'s (a KP2DTiny) weights as a reference state_dict (see
    the module doc)."""
    sd = model.state_dict()
    if template is None:
        keys = list(sd)
        return {reference_name(k, keys): _reference_value(k, v)
                for k, v in sd.items()}
    out: Dict[str, Tensor] = {}
    for name, tv in template.items():
        tv = torch.as_tensor(tv)
        entry = convert_entry(name, tv)
        if entry is None:
            out[name] = tv.clone()  # bookkeeping, no counterpart here
            continue
        key = entry[0]
        value = _reference_value(key, sd[key], tuple(tv.shape))
        if tuple(value.shape) != tuple(tv.shape):
            raise ValueError(f"{name}: exported shape {tuple(value.shape)} "
                             f"!= the template's {tuple(tv.shape)}")
        out[name] = value
    return out


def save_torch_checkpoint(path: str, model: nn.Module,
                          config: Optional[Dict] = None) -> str:
    """``model``'s weights as a reference ``.ckpt`` at ``path`` (the names
    inverted from the import's map); returns ``path``."""
    sd = export_state_dict(model)
    torch.save({"state_dict": {REFERENCE_PREFIX + k: v
                               for k, v in sd.items()},
                "config": dict(config or {})}, path)
    return path
