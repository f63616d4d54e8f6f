"""Reference PyTorch KP2DTiny checkpoints into the port, the counterpart of
``nanovs_slam_tpu/utils/torch_import.py``.

The reference's module tree differs from the port's (which keeps the flax
names) by a few quirks, so its names map onto the port's modules by
rule, for every config (V2 / V3, attention, GeM / ConvAP, depth, MCU):

- ``confAa`` / ``confBb`` -> ``convAa`` / ``convBb``; ``convs.N`` ->
  ``convs_N``; the descriptor head's ``upsample`` -> ``upsample1``;
- the attention's PreNorm wrapping: ``att.norm`` -> ``norm_att``,
  ``att.fn`` -> ``att``, ``mff.norm`` -> ``norm_mff``, ``mff.fn`` ->
  ``mff``; the mix-FF's sequential ``net.0`` / ``net.1.net.0`` /
  ``net.1.net.1`` / ``net.3`` -> ``expand`` / ``dw`` / ``pw`` /
  ``project``;
- NetVLAD's soft-assign 1x1 ``conv.weight`` (K, C, 1, 1) -> ``assign_w``
  (C, K) (KP2DTiny's vladv1 head has no bias, and a bias is dropped, as
  the JAX importer drops it); a LayerNorm's ``g`` / ``b`` (1, C, 1, 1) ->
  (C,);
- everything else keeps its name and PyTorch layout (the port's convs,
  transposed convs, BNs and Linears are PyTorch's); BN's
  ``num_batches_tracked`` and quantisation stubs are skipped.

``load_torch_checkpoint`` reads a reference ``.ckpt`` (``torch.save`` of a
dict with ``state_dict``, whose keys the training wrapper prefixes with
``keypoint_net.``, and ``config``); ``convert_inlier_net_state_dict``
maps the reference inlier net (1x1 convs in ``p_in`` / ``{i}s{j}`` /
``p_out``) onto ``models/inlier_net.InlierNet``'s Linears and BNs;
``load_model_weights`` loads either checkpoint kind into a model, as the
port's CLIs take them.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

Tensor = torch.Tensor
REFERENCE_PREFIX = "keypoint_net."
# attention renames, nested DsConv2d paths first
ATTENTION_RENAMES = (
    ("att.norm.", "norm_att."), ("mff.norm.", "norm_mff."),
    ("att.fn.", "att."), ("mff.fn.", "mff."),
    ("mff.net.1.net.0.", "mff.dw."), ("mff.net.1.net.1.", "mff.pw."),
    ("mff.net.0.", "mff.expand."), ("mff.net.3.", "mff.project."),
)
MODULE_RENAMES = {"confAa": "convAa", "confBb": "convBb",
                  "upsample": "upsample1"}


def _array(v: Any) -> np.ndarray:
    return v.detach().cpu().numpy() if hasattr(v, "detach") \
        else np.asarray(v)


def port_module_path(name: str) -> Tuple[list, str]:
    """A reference state-dict name -> (the port's module path as a list,
    the leaf)."""
    for a, b in ATTENTION_RENAMES:
        name = name.replace(a, b)
    *parts, leaf = name.split(".")
    out, i = [], 0
    while i < len(parts):
        p = parts[i]
        if p == "convs" and i + 1 < len(parts) and parts[i + 1].isdigit():
            out.append(f"convs_{parts[i + 1]}")
            i += 2
            continue
        out.append(MODULE_RENAMES.get(p, p))
        i += 1
    return out, leaf


def convert_entry(name: str, value: Any
                  ) -> Optional[Tuple[str, np.ndarray]]:
    """One reference entry -> (the port's key, its float32 array), or
    None for an entry the port has no counterpart of."""
    if name.endswith("num_batches_tracked") or ".quant." in name \
            or ".dequant." in name:
        return None
    mods, leaf = port_module_path(name)
    if not mods:
        return None
    arr = _array(value).astype(np.float32)
    if len(mods) >= 2 and mods[-2] == "netvlad" and mods[-1] == "conv":
        if leaf != "weight":
            return None  # a vladv1 head has no assignment bias
        return ".".join(mods[:-1] + ["assign_w"]), arr[:, :, 0, 0].T.copy()
    if leaf in ("g", "b"):
        arr = arr.reshape(-1)
    return ".".join(mods + [leaf]), arr


def convert_state_dict(state_dict: Mapping[str, Any]
                       ) -> Dict[str, Tensor]:
    """A reference KP2DTiny state_dict (tensor or array values) -> the
    port's state_dict entries (float32 tensors; no
    ``num_batches_tracked``)."""
    out: Dict[str, Tensor] = {}
    for name, value in state_dict.items():
        entry = convert_entry(name, value)
        if entry is not None:
            key, arr = entry
            if key in out:
                raise ValueError(f"duplicate key {key} from {name}")
            out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def read_torch_checkpoint(path: str) -> Tuple[Dict[str, Any], Dict]:
    """(the state_dict without the training wrapper's ``keypoint_net.``
    prefix, the config) of a reference ``.ckpt`` (or of a bare
    state_dict saved with ``torch.save``)."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    sd = blob.get("state_dict", blob)
    sd = {k[len(REFERENCE_PREFIX):] if k.startswith(REFERENCE_PREFIX)
          else k: v for k, v in sd.items()}
    config = blob.get("config", {}) if "state_dict" in blob else {}
    return sd, config


def load_torch_checkpoint(path: str) -> Tuple[Dict[str, Tensor], Dict]:
    """A reference ``.ckpt`` -> (the port's state_dict entries, the
    checkpoint's config)."""
    sd, config = read_torch_checkpoint(path)
    return convert_state_dict(sd), config


def convert_inlier_net_state_dict(sd: Mapping[str, Any], blocks: int = 4
                                  ) -> Dict[str, Tensor]:
    """The reference inlier net's state_dict (1x1 convs and BNs) -> the
    port's ``InlierNet`` entries (Linear weights (out, in))."""
    def t(name, dense=False):
        a = _array(sd[name]).astype(np.float32)
        return torch.from_numpy(np.ascontiguousarray(
            a[:, :, 0, 0] if dense else a))

    def bn(ours, ref):
        return {f"{ours}.{leaf}": t(f"{ref}.{leaf}")
                for leaf in ("weight", "bias", "running_mean",
                             "running_var")}

    out = {"p_in_conv.weight": t("p_in.0.weight", True),
           "p_out.weight": t("p_out.weight", True),
           "p_out.bias": t("p_out.bias")}
    out.update(bn("p_in_bn", "p_in.1"))
    for i in range(blocks):
        for j in range(2):
            out[f"b{i}_conv{j}.weight"] = t(f"{i}s{2 * j}.weight", True)
            out[f"b{i}_conv{j}.bias"] = t(f"{i}s{2 * j}.bias")
            out.update(bn(f"b{i}_bn{j}", f"{i}s{2 * j + 1}"))
    return out


def load_model_weights(model: torch.nn.Module, path: str
                       ) -> torch.nn.Module:
    """A checkpoint into ``model`` in place, as the port's CLIs take them:
    an ``.npz`` (the JAX package's or the port's flax tree) or a reference
    PyTorch checkpoint (``.ckpt`` / ``.pt`` / ``.pth``: KP2DTiny, or
    KeypointFormer for that model). Raises ValueError for a checkpoint
    directory."""
    if os.path.isdir(path):
        raise ValueError(f"{path}: the port reads .npz or torch checkpoint "
                         "files, not checkpoint directories")
    if path.endswith(".npz"):
        from .checkpoint import load_npz_checkpoint
        from .convert import load_jax_variables

        tree, _ = load_npz_checkpoint(path)
        return load_jax_variables(model, tree["params"], tree["batch_stats"])
    from ..models.keypoint_former import KeypointFormer
    from .convert import load_state_strict

    if isinstance(model, KeypointFormer):
        from .torch_import_former import convert_keypoint_former_state_dict

        sd, _ = read_torch_checkpoint(path)
        return load_state_strict(model, convert_keypoint_former_state_dict(
            sd, model.cfg.num_layers))
    return load_state_strict(model, load_torch_checkpoint(path)[0])
