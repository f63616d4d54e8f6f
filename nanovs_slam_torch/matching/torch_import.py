"""Load a reference LightGlue ``state_dict`` (lightglue/lightglue.py module
names) into the port's ``LightGlue``; the counterpart of
``nanovs_slam_tpu/matching/torch_import.py``.

Name mapping:
  transformers.{i}.…                  -> transformers_{i}.…
  log_assignment.{i}.…                -> log_assignment_{i}.…
  token_confidence.{i}.token.0        -> token_confidence_{i}.token
  ….ffn.0 / ffn.1 (LayerNorm) / ffn.3 -> ….ffn.fc1 / ffn.norm / ffn.fc2
  posenc.Wr.weight (head_dim/2, 2)    -> posenc.Wr (2, head_dim/2)
Linear and LayerNorm tensors keep their torch layout.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import torch
import torch.nn as nn

_RULES = ((re.compile(r"^(transformers|log_assignment|token_confidence)"
                      r"\.(\d+)\."), r"\1_\2."),
          (re.compile(r"\.ffn\.0\."), ".ffn.fc1."),
          (re.compile(r"\.ffn\.1\."), ".ffn.norm."),
          (re.compile(r"\.ffn\.3\."), ".ffn.fc2."),
          (re.compile(r"\.token\.0\."), ".token."))


def convert_lightglue_state_dict(state_dict: Mapping[str, torch.Tensor]
                                 ) -> Dict[str, torch.Tensor]:
    """Reference names -> the port's ``state_dict`` names."""
    out: Dict[str, torch.Tensor] = {}
    for name, v in state_dict.items():
        t = torch.as_tensor(v).detach().float()
        if name == "posenc.Wr.weight":
            out["posenc.Wr"] = t.t().contiguous()
            continue
        for pattern, repl in _RULES:
            name = pattern.sub(repl, name)
        out[name] = t
    return out


def load_torch_lightglue(model: nn.Module,
                         state_dict: Mapping[str, torch.Tensor]) -> nn.Module:
    """Load a reference-named ``state_dict`` into ``model`` strictly (no key
    left over on either side) and return it."""
    model.load_state_dict(convert_lightglue_state_dict(state_dict),
                          strict=True)
    return model
