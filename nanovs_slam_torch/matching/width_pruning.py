"""Adaptive width pruning for LightGlue by static bucket compaction, the
counterpart of ``nanovs_slam_tpu/matching/width_pruning.py`` (reference
lightglue/lightglue.py:564-594, 613-624).

After each non-final layer the reference drops the confident-and-
unmatchable keypoints (keep = matchability > 1 - width_confidence, or
token confidence <= the layer's threshold), shrinks the attention to the
survivors and scatters the matches back at the end. Here the keypoint
axis instead halves on a fixed schedule (``prune_schedule``), floored at
``min_bucket``:
- at a prune point every keypoint gets a rank: keep-flagged points above
  the others, matchability as the tiebreak, padded slots last; the bucket
  is the top of that order (a stable sort: equal ranks keep the lower
  slot first, as ``lax.top_k`` does), gathered in the original order;
- a non-keep point that lands in the bucket only because fewer points
  were keep-flagged is masked out, so attention and assignment treat it
  as the reference treats a pruned point; when more points are
  keep-flagged than the bucket holds, the lowest-matchability keeps go.

``engaged_width_forward`` reads the keep counts once (one host read of
two integers) and floors the schedule at them, so a fully matchable pair
runs the plain forward. On a CUDA device every layer is one call of the
LightGlue kernel at the bucket's shapes (M and N may differ).

Exactness (tested): when every valid keypoint is keep-flagged and fits
the last bucket (width_confidence = 1), the result equals the unpruned
forward; compaction then only drops padding.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from ..ops.postprocess import stable_top_k
from .lightglue import LightGlue, confidence_threshold

Tensor = torch.Tensor


def _take_points(t: Tensor, sel: Tensor) -> Tensor:
    """Gather along the keypoint axis: t (B, N, ...) or a rotary table
    (B, 1, N, dh); sel (B, k)."""
    if t.dim() == 4:  # rotary cos/sin
        return torch.gather(t, 2, sel[:, None, :, None].expand(
            t.shape[0], t.shape[1], sel.shape[1], t.shape[3]))
    if t.dim() == 3:  # descriptors
        return torch.gather(t, 1, sel[:, :, None].expand(-1, -1,
                                                         t.shape[2]))
    return torch.gather(t, 1, sel)  # masks and indices


def prune_schedule(n: int, n_layers: int, min_bucket: int = 128,
                   n_prunes: Optional[int] = None,
                   floor: Optional[int] = None) -> List[int]:
    """The bucket after each non-final layer (n_layers - 1 entries): halve
    after each of the first ``n_prunes`` layers (None: as long as the
    floor allows), never below max(min_bucket, floor). ``floor`` is how
    ``engaged_width_forward`` passes the measured keep count: a fully
    matchable pair (floor >= n) gets the identity schedule."""
    eff_min = max(min_bucket, floor or 0)
    buckets = []
    cur = n
    prunes = 0
    for _ in range(n_layers - 1):
        nxt = cur // 2
        if nxt >= eff_min and (n_prunes is None or prunes < n_prunes):
            cur = nxt
            prunes += 1
        buckets.append(cur)
    return buckets


def _keep(model: LightGlue, i: int, s: Tensor, conf: Tensor,
          width_confidence: float) -> Tensor:
    """The reference's keep rule after layer i (:619-624) on the
    matchability ``s``: matchable, or not confident (a low-confidence
    point is never pruned)."""
    return (s > 1.0 - width_confidence) | (
        conf <= confidence_threshold(i, model.cfg.n_layers))


def _masks(data: Dict[str, Tensor], B: int, M: int, N: int, dev):
    """mask0 / mask1 of ``data``, all True where absent."""
    return tuple(torch.ones((B, n), dtype=torch.bool, device=dev)
                 if data.get(k) is None else data[k]
                 for k, n in (("mask0", M), ("mask1", N)))


@torch.inference_mode()
def width_pruned_forward(model: LightGlue, data: Dict[str, Tensor],
                         width_confidence: float = 0.99,
                         min_bucket: int = 128,
                         n_prunes: Optional[int] = None,
                         floor0: Optional[int] = None,
                         floor1: Optional[int] = None) -> Dict[str, Tensor]:
    """LightGlue inference with static-bucket width pruning.

    data: as for LightGlue.forward (normalised keypoints0/1,
    descriptors0/1, optional bool mask0/1). Returns the matches and
    scores in the original (B, M) / (B, N) index space, plus prune0 /
    prune1: the layers each keypoint survived (pruned after layer i:
    i + 1; kept to the end: n_layers; reference :543-544, 579)."""
    n_layers = model.cfg.n_layers
    desc0, desc1, enc0, enc1 = model.embed(data)
    B, M = desc0.shape[:2]
    N = desc1.shape[1]
    dev = desc0.device
    mask0, mask1 = _masks(data, B, M, N, dev)
    ind0 = torch.arange(M, device=dev)[None].expand(B, M)
    ind1 = torch.arange(N, device=dev)[None].expand(B, N)
    prune0 = torch.full((B, M), n_layers, dtype=torch.int32, device=dev)
    prune1 = torch.full((B, N), n_layers, dtype=torch.int32, device=dev)
    sched0 = prune_schedule(M, n_layers, min_bucket, n_prunes, floor0)
    sched1 = prune_schedule(N, n_layers, min_bucket, n_prunes, floor1)

    def compact(i, desc, enc, mask, ind, conf, bucket):
        """One side's prune after layer i: rank, select, gather."""
        s = model.matchability(i, desc)
        keep = _keep(model, i, s, conf, width_confidence)
        rank = torch.where(mask, keep.to(s.dtype) * 2.0 + s, -1.0)
        sel = torch.sort(stable_top_k(rank, bucket)[1], dim=-1).values
        return (_take_points(desc, sel),
                tuple(_take_points(e, sel) for e in enc),
                _take_points(mask & keep, sel), _take_points(ind, sel))

    def alive(ind, mask, n):
        """The bucket's validity scattered back to the original slots."""
        return torch.zeros((B, n), dtype=torch.int32, device=dev
                           ).scatter_reduce(1, ind, mask.to(torch.int32),
                                            "amax").bool()

    for i in range(n_layers):
        desc0, desc1 = model.run_layers(range(i, i + 1), desc0, desc1, enc0,
                                        enc1, mask0, mask1)
        if i == n_layers - 1:
            break
        do0 = sched0[i] < desc0.shape[1]
        do1 = sched1[i] < desc1.shape[1]
        if not (do0 or do1):
            continue
        conf0, conf1 = model.token_confidence(i, desc0, desc1)
        if do0:
            before = alive(ind0, mask0, M)
            desc0, enc0, mask0, ind0 = compact(i, desc0, enc0, mask0, ind0,
                                               conf0, sched0[i])
            # valid before the prune and not after: pruned after layer i
            prune0 = torch.where(before & ~alive(ind0, mask0, M),
                                 torch.clamp(prune0, max=i + 1), prune0)
        if do1:
            before = alive(ind1, mask1, N)
            desc1, enc1, mask1, ind1 = compact(i, desc1, enc1, mask1, ind1,
                                               conf1, sched1[i])
            prune1 = torch.where(before & ~alive(ind1, mask1, N),
                                 torch.clamp(prune1, max=i + 1), prune1)

    pred_c = model.finalize(n_layers - 1, desc0, desc1, mask0, mask1)
    return _scatter_back(pred_c, ind0, ind1, prune0, prune1, B, M, N)


def _scatter_back(pred_c, ind0, ind1, prune0, prune1, B, M, N):
    """Compacted-space matches back to the original (B, M) / (B, N) index
    space (reference :585-594). The indices of a side are distinct slots,
    so a plain scatter places each once."""
    m0c, m1c = pred_c["matches0"], pred_c["matches1"]
    ms0c, ms1c = pred_c["matching_scores0"], pred_c["matching_scores1"]
    m0_orig = torch.where(m0c >= 0, torch.gather(ind1, 1, m0c.clamp(min=0)),
                          -1)
    m1_orig = torch.where(m1c >= 0, torch.gather(ind0, 1, m1c.clamp(min=0)),
                          -1)
    m0 = torch.full((B, M), -1, dtype=m0c.dtype, device=m0c.device
                    ).scatter_(1, ind0, m0_orig)
    m1 = torch.full((B, N), -1, dtype=m1c.dtype, device=m1c.device
                    ).scatter_(1, ind1, m1_orig)
    ms0 = ms0c.new_zeros((B, M)).scatter_(1, ind0, ms0c)
    ms1 = ms1c.new_zeros((B, N)).scatter_(1, ind1, ms1c)
    return {"matches0": m0, "matches1": m1,
            "matching_scores0": ms0, "matching_scores1": ms1,
            "prune0": prune0, "prune1": prune1}


@torch.inference_mode()
def _keep_count_probe(model: LightGlue, data: Dict[str, Tensor],
                      width_confidence: float) -> Tensor:
    """The keep counts after layer 0 (the largest over the batch) of both
    sides, stacked so that the caller reads them in one transfer: the
    reference's keep rule where the first prune would happen."""
    desc0, desc1, enc0, enc1 = model.embed(data)
    B, M = desc0.shape[:2]
    N = desc1.shape[1]
    mask0, mask1 = _masks(data, B, M, N, desc0.device)
    d0, d1 = model.run_layers(range(0, 1), desc0, desc1, enc0, enc1, mask0,
                              mask1)
    conf0, conf1 = model.token_confidence(0, d0, d1)
    return torch.stack([
        (_keep(model, 0, model.matchability(0, d), c, width_confidence)
         & m).sum(1).max()
        for d, m, c in ((d0, mask0, conf0), (d1, mask1, conf1))])


def _pow2_at_least(k: int, min_bucket: int) -> int:
    b = max(min_bucket, 1)
    while b < k:
        b *= 2
    return b


@torch.inference_mode()
def engaged_width_forward(model: LightGlue, data: Dict[str, Tensor],
                          width_confidence: float = 0.99,
                          min_bucket: int = 128,
                          n_prunes: Optional[int] = None
                          ) -> Dict[str, Tensor]:
    """Width pruning with the reference's automatic engagement
    (lightglue.py:613-624): probe the keep counts where the first prune
    would happen (embed and layer 0, one host read of both counts), round
    each up to a power of two >= min_bucket and pass it as the schedule's
    floor, so that compaction never goes below what the keep rule
    retains. A pair with nothing to prune on either side runs the plain
    forward. The buckets form the power-of-two ladder between min_bucket
    and the slot count."""
    counts = _keep_count_probe(model, data, width_confidence).tolist()
    B, M = data["descriptors0"].shape[:2]
    N = data["descriptors1"].shape[1]
    f0 = _pow2_at_least(int(counts[0]), min_bucket)
    f1 = _pow2_at_least(int(counts[1]), min_bucket)
    if f0 >= M and f1 >= N:
        # nothing prunable anywhere: the reference keeps every point
        pred = dict(model(data))
        dev = pred["matches0"].device
        pred["prune0"] = torch.full((B, M), model.cfg.n_layers,
                                    dtype=torch.int32, device=dev)
        pred["prune1"] = torch.full((B, N), model.cfg.n_layers,
                                    dtype=torch.int32, device=dev)
        return pred
    return width_pruned_forward(model, data, width_confidence, min_bucket,
                                n_prunes, min(f0, M), min(f1, N))
