"""VPR retrieval metrics: Recall@N, AUC@N, MatchRatio@N, the counterpart of
``nanovs_slam_tpu/evaluation/global_descriptor.py``.

``knn_l2`` is the exact L2 search as one (Q, D) x (D, N) float32 matmul on
the descriptors' device (TF32 off for it), then a stable ascending sort of
the squared distances, so that ties keep ``lax.top_k``'s order (the lower
database index first). ``retrieval_metrics`` and
``evaluate_global_descriptor`` are copies.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch


def knn_l2(queries, database, k: int) -> np.ndarray:
    """Exact L2 top-k database indices (Q, k), nearest first. queries
    (Q, D), database (N, D): tensors (on any one device) or numpy arrays
    (on the CPU). k may not exceed N, as for ``lax.top_k``."""
    q = torch.as_tensor(queries).to(torch.float32)
    db = torch.as_tensor(database).to(device=q.device, dtype=torch.float32)
    if k > db.shape[0]:
        raise ValueError(f"k = {k} exceeds the database's {db.shape[0]} "
                         "entries")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        d2 = ((q * q).sum(1)[:, None] - 2.0 * (q @ db.T)
              + (db * db).sum(1)[None, :])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    idx = torch.sort(d2, dim=1, stable=True).indices[:, :k]
    return idx.cpu().numpy()


def retrieval_metrics(predictions: np.ndarray, positives: Sequence[np.ndarray],
                      num_queries: int,
                      n_values: Sequence[int] = (1, 5, 10, 20)
                      ) -> Dict[str, Dict[int, float]]:
    """predictions (Q, max_n) ranked db indices; positives[q] = GT indices."""
    n_max = max(n_values)
    match_ratio_at_n = np.zeros(len(n_values))
    count_n = np.zeros(len(n_values))
    correct_hist = np.zeros(n_max)

    for q_ix, pred in enumerate(predictions):
        correct = np.isin(pred[:n_max], positives[q_ix])
        total = len(positives[q_ix])
        if np.any(correct):
            first_hit = np.where(correct)[0].min()
            correct_hist[first_hit:] += 1
        for i, n in enumerate(n_values):
            if total > 0:
                match_ratio_at_n[i] += correct[:n].sum() / min(total, n)
                count_n[i] += 1

    match_ratio_at_n = match_ratio_at_n / np.maximum(count_n, 1)
    recall_hist = correct_hist / num_queries

    recalls, auc, match_ratio = {}, {}, {}
    for i, n in enumerate(n_values):
        recalls[n] = float(recall_hist[n - 1])
        auc[n] = float(np.sum(recall_hist[:n]) / n)
        match_ratio[n] = float(match_ratio_at_n[i])
    return {"Recall": recalls, "AUC": auc, "MatchRatio": match_ratio}


def evaluate_global_descriptor(db_features, query_features,
                               positives: Sequence[np.ndarray],
                               n_values: Sequence[int] = (1, 5, 10, 20)
                               ) -> Dict[str, Dict[int, float]]:
    """db_features (N, D), query_features (Q, D): tensors on the device
    that searches, or numpy arrays."""
    predictions = knn_l2(query_features, db_features, max(n_values))
    return retrieval_metrics(predictions, positives, len(query_features),
                             n_values)
