"""Reference PyTorch KeypointFormer checkpoints into the port, the
counterpart of ``nanovs_slam_tpu/utils/torch_import_former.py``.

Name map (the reference's ``kp2d_former.py`` / ``segformer.py`` module
tree -> ``models/keypoint_former.py``, which keeps the flax names):

- ``mit.stages.{s}.1`` (Unfold + a 1x1 embedding, weight (out, in*k*k, 1,
  1)) -> ``mit.stage{s}_embed``, a k x k conv (out, in, k, k);
- ``mit.stages.{s}.2.{l}.0.norm`` / ``.0.fn`` -> ``mit.stage{s}_l{l}_
  norm_att`` / ``_att``; ``.1.norm`` / ``.1.fn.net.{0, 1.net.0, 1.net.1,
  3}`` -> ``_norm_mff`` / ``_mff.{expand, dw, pw, project}``;
- ``to_fused.{i}.0`` / ``.1`` -> ``to_fused{i}_conv`` / ``_bn``;
- the heads' sequentials (``segmentation_head``, ``score_head``,
  ``loc_head``, ``feat_head``, ``vlad_head``: conv, BN, ReLU, conv, ...)
  -> ``{seg,score,loc,feat,vlad}_conv{j}`` / ``_bn{j}``;
- ``netvlad.conv`` (K, C, 1, 1) and its bias -> ``netvlad.assign_w`` (C,
  K) and ``assign_b``; ``netvlad.centroids`` as it is.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

STAGE_KERNELS = (7, 3, 3, 3)
HEADS = (("segmentation_head", "seg"), ("score_head", "score"),
         ("loc_head", "loc"), ("feat_head", "feat"), ("vlad_head", "vlad"))
MFF_LAYERS = (("0", "expand"), ("1.net.0", "dw"), ("1.net.1", "pw"),
              ("3", "project"))
BN_LEAVES = ("weight", "bias", "running_mean", "running_var")


def convert_keypoint_former_state_dict(sd: Mapping[str, Any],
                                       num_layers: int = 2
                                       ) -> Dict[str, torch.Tensor]:
    """A reference KeypointFormer state_dict -> the port's state_dict
    entries (float32 tensors; no ``num_batches_tracked``)."""
    sd = {k: (v.detach().cpu().numpy() if hasattr(v, "detach")
              else np.asarray(v)) for k, v in sd.items()}
    out: Dict[str, torch.Tensor] = {}

    def put(key, arr):
        out[key] = torch.from_numpy(np.ascontiguousarray(
            np.asarray(arr, np.float32)))

    def conv(ours, ref):
        put(f"{ours}.weight", sd[f"{ref}.weight"])
        if sd.get(f"{ref}.bias") is not None:
            put(f"{ours}.bias", sd[f"{ref}.bias"])

    def bn(ours, ref):
        for leaf in BN_LEAVES:
            put(f"{ours}.{leaf}", sd[f"{ref}.{leaf}"])

    for s, k in enumerate(STAGE_KERNELS):
        w = sd[f"mit.stages.{s}.1.weight"]
        put(f"mit.stage{s}_embed.weight",
            w[:, :, 0, 0].reshape(w.shape[0], w.shape[1] // (k * k), k, k))
        put(f"mit.stage{s}_embed.bias", sd[f"mit.stages.{s}.1.bias"])
        for layer in range(num_layers):
            base, ours = f"mit.stages.{s}.2.{layer}", f"mit.stage{s}_l{layer}"
            for i, part in ((0, "norm_att"), (1, "norm_mff")):
                for leaf in ("g", "b"):
                    put(f"{ours}_{part}.{leaf}",
                        sd[f"{base}.{i}.norm.{leaf}"].reshape(-1))
            for name in ("to_q", "to_kv", "to_out"):
                conv(f"{ours}_att.{name}", f"{base}.0.fn.{name}")
            for ref, name in MFF_LAYERS:
                conv(f"{ours}_mff.{name}", f"{base}.1.fn.net.{ref}")
    for i in range(4):
        conv(f"to_fused{i}_conv", f"to_fused.{i}.0")
        bn(f"to_fused{i}_bn", f"to_fused.{i}.1")
    for ref, ours in HEADS:
        j = 0  # conv, BN, ReLU, conv ...: a BN follows its conv
        for seq in range(10):
            if f"{ref}.{seq}.running_mean" in sd:
                bn(f"{ours}_bn{j - 1}", f"{ref}.{seq}")
            elif f"{ref}.{seq}.weight" in sd:
                conv(f"{ours}_conv{j}", f"{ref}.{seq}")
                j += 1
    put("netvlad.assign_w", sd["netvlad.conv.weight"][:, :, 0, 0].T)
    if sd.get("netvlad.conv.bias") is not None:
        put("netvlad.assign_b", sd["netvlad.conv.bias"])
    put("netvlad.centroids", sd["netvlad.centroids"])
    return out
