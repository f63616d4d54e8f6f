"""Checkpoints as ``.npz`` files, read and written with numpy alone.

A checkpoint stores a flax pytree with ``/``-joined keys plus a
``__meta__`` JSON blob: the format of the JAX package's
``save_npz_checkpoint`` / ``load_npz_checkpoint``, which its
``load_checkpoint`` reads for any regular file. ``load_npz_checkpoint``
and ``_unflatten`` are copies of the JAX package's, so that the port reads
the pinned files without importing JAX.

``save_checkpoint`` writes a train state: ``params``, ``batch_stats``,
``io_params`` and ``io_batch_stats`` in flax layout
(``utils/convert.to_jax_variables``), and the port's optimizer state under
keys of its own (``torch_optimizer/<parameter>/<slot>``, its param groups
and step count in the meta); the JAX trainer ignores them on read, and so
does ``restore_train_state``. ``save_model_checkpoint`` writes a model's
variables alone (``train_visloc``). ``filter_params`` is the JAX package's
partial-restore filter.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np

OPT_KEY = "torch_optimizer"


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict:
    tree: Dict[str, Any] = {}
    for k, v in flat.items():
        parts = k.split("/")
        d = tree
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return tree


def load_npz_checkpoint(path: str) -> Tuple[Dict, Dict]:
    """Returns (tree, meta) of a pinned ``.npz`` checkpoint."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    meta = {}
    raw = flat.pop("__meta__", None)
    if raw is not None:
        meta = json.loads(raw.tobytes().decode())
    return _unflatten(flat), meta


def save_checkpoint(path: str, state, config: Optional[Dict] = None,
                    epoch: int = 0, results: Optional[Dict] = None,
                    start_results: Optional[Dict] = None) -> str:
    """A ``train.train_step.TrainState`` -> ``path`` (``.npz``); returns
    the path written."""
    from .convert import to_jax_variables

    params, batch_stats = to_jax_variables(state.model)
    tree = {"params": params, "batch_stats": batch_stats}
    if state.io_net is not None:
        tree["io_params"], tree["io_batch_stats"] = to_jax_variables(
            state.io_net)
    opt = state.optimizer.state_dict()
    names = state.param_names
    tree[OPT_KEY] = {
        names[i]: {slot: v.detach().cpu().numpy()
                   for slot, v in slots.items()}
        for i, slots in opt["state"].items()}
    groups = [{k: v for k, v in g.items() if k != "params"}
              for g in opt["param_groups"]]
    meta = {"epoch": epoch, "config": config or {},
            "results": results or {}, "start_results": start_results or {},
            "step": state.step,
            "optimizer": {"param_groups": groups,
                          "group_params": [[names[i] for i in g["params"]]
                                           for g in opt["param_groups"]]}}
    return _write(path, tree, meta)


def save_model_checkpoint(path: str, model, config: Optional[Dict] = None,
                          epoch: int = 0) -> str:
    """A model's ``params`` and ``batch_stats`` alone -> ``path``
    (``.npz``), as the JAX ``train_visloc`` saves; returns the path
    written."""
    from .convert import to_jax_variables

    params, batch_stats = to_jax_variables(model)
    return _write(path, {"params": params, "batch_stats": batch_stats},
                  {"epoch": epoch, "config": config or {}})


def _write(path: str, tree: Dict, meta: Dict) -> str:
    from .convert import _flatten

    flat = _flatten(tree)
    flat["__meta__"] = np.frombuffer(json.dumps(meta, default=str).encode(),
                                     np.uint8)
    if not path.endswith(".npz"):
        path += ".npz"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flat)  # uncompressed: float weights barely compress
    return path


def filter_params(params: Dict, mode: Optional[str] = None) -> Dict:
    """Partial-restore filtering, as the JAX package's ``filter_params``:
    mode 'seg' drops the whole seg head, 'vlad' the vlad head, 'seg_last'
    only the seg head's final class conv (for class-count changes)."""
    if mode is None:
        return params
    params = dict(params)
    if mode in ("seg", "vlad"):
        params.pop(f"{mode}_head", None)
        return params
    if mode != "seg_last":
        raise NotImplementedError(mode)
    if "seg_head" in params:
        seg = dict(params["seg_head"])
        for k in ("convs_8", "convs_7"):
            if k in seg and "kernel" in seg[k]:
                seg.pop(k)
                break
        params["seg_head"] = seg
    return params


def restore_train_state(path: str, state, mode: Optional[str] = None
                        ) -> Dict:
    """Load a checkpoint (``save_checkpoint``'s, or any ``.npz`` with
    flax ``params``) into a fresh ``TrainState`` in place, as the JAX
    trainer does (``train_multitask.py``): the params filtered by ``mode``
    (``filter_params``) and the BN statistics overlaid on the model, whose
    keys absent from the file keep their init. The inlier net, the
    optimizer and the step count stay as the fresh state has them, so the
    learning-rate schedule starts again from step 0. Returns the meta."""
    from .convert import merge_jax_variables

    tree, meta = load_npz_checkpoint(path)
    merge_jax_variables(state.model, filter_params(tree["params"], mode),
                        tree.get("batch_stats", {}))
    return meta
