"""LightGlue's NLL training loss with deep supervision, the counterpart of
``nanovs_slam_tpu/matching/loss.py`` (reference: lightglue/lightglue.py
:10-77, 646-695).

- ``gt_weights_from_matches``: positives from the ground-truth assignment;
  an unmatched keypoint (gt match -1) weights its dustbin column / row;
- ``weight_loss`` / ``nll_loss``: the positive NLL over the number of
  positives, the negative one over the number of negatives, mixed by
  ``nll_balancing``;
- ``confidence_loss``: the token-confidence heads' BCE toward "this layer's
  argmax already equals the last layer's" (pre-sigmoid logits; both
  assignments detached);
- ``matcher_metrics``: recall, precision and accuracy of ``matches0``;
- ``lightglue_loss``: the last layer's NLL plus the earlier layers'
  (their assignments recomputed from the stacked descriptors, with the
  shared gt weights) weighted by gamma^(N-i-1), over the weights' sum,
  plus the confidence term in training.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def gt_weights_from_matches(log_assignment_shape, gt_assignment: Tensor,
                            gt_matches0: Tensor, gt_matches1: Tensor
                            ) -> Tensor:
    B, Mp1, Np1 = log_assignment_shape
    M, N = Mp1 - 1, Np1 - 1
    weights = gt_assignment.new_zeros((B, Mp1, Np1), dtype=torch.float32)
    weights[:, :M, :N] = gt_assignment.float()
    weights[:, :M, -1] = (gt_matches0 == -1).float()
    weights[:, -1, :N] = (gt_matches1 == -1).float()
    return weights


def weight_loss(log_assignment: Tensor, weights: Tensor
                ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    B, Mp1, Np1 = log_assignment.shape
    m, n = Mp1 - 1, Np1 - 1
    loss_sc = log_assignment * weights
    num_neg0 = weights[:, :m, -1].sum(-1).clamp(min=1.0)
    num_neg1 = weights[:, -1, :n].sum(-1).clamp(min=1.0)
    num_pos = weights[:, :m, :n].sum((-1, -2)).clamp(min=1.0)
    nll_pos = -loss_sc[:, :m, :n].sum((-1, -2)) / num_pos
    nll_neg0 = -loss_sc[:, :m, -1].sum(-1)
    nll_neg1 = -loss_sc[:, -1, :n].sum(-1)
    nll_neg = (nll_neg0 + nll_neg1) / (num_neg0 + num_neg1)
    return nll_pos, nll_neg, num_pos, (num_neg0 + num_neg1) / 2.0


def nll_loss(log_assignment: Tensor, weights: Tensor,
             nll_balancing: float = 0.5) -> Tuple[Tensor, Dict[str, Tensor]]:
    nll_pos, nll_neg, num_pos, num_neg = weight_loss(log_assignment, weights)
    nll = nll_balancing * nll_pos + (1.0 - nll_balancing) * nll_neg
    return nll, {"nll_pos": nll_pos, "nll_neg": nll_neg,
                 "num_matchable": num_pos, "num_unmatchable": num_neg}


def confidence_loss(token_logit0: Tensor, token_logit1: Tensor,
                    la_now: Tensor, la_final: Tensor) -> Tensor:
    """TokenConfidence BCE supervision (:187-200); token_logit* are the
    pre-sigmoid logits."""
    la_now, la_final = la_now.detach(), la_final.detach()
    correct0 = (la_final[:, :-1, :].argmax(-1)
                == la_now[:, :-1, :].argmax(-1)).float()
    correct1 = (la_final[:, :, :-1].argmax(-2)
                == la_now[:, :, :-1].argmax(-2)).float()

    def bce(logit, target):
        return (torch.clamp(logit, min=0) - logit * target
                + torch.log1p(torch.exp(-logit.abs())))

    return (bce(token_logit0, correct0).mean(-1)
            + bce(token_logit1, correct1).mean(-1)) / 2.0


def matcher_metrics(matches0: Tensor, gt_matches0: Tensor,
                    matching_scores0: Tensor) -> Dict[str, Tensor]:
    def rate(mask):
        mask = mask.float()
        return ((matches0 == gt_matches0) * mask).sum(1) / (1e-8
                                                             + mask.sum(1))

    return {"match_recall": rate(gt_matches0 > -1),
            "match_precision": rate((matches0 > -1) & (gt_matches0 >= -1)),
            "accuracy": rate(gt_matches0 >= -1)}


def lightglue_loss(model, pred: Dict[str, Tensor], data: Dict[str, Tensor],
                   nll_balancing: float = 0.5, gamma: float = 1.0,
                   training: bool = True) -> Dict[str, Tensor]:
    """The full deep-supervision loss (:646-695) of the port's ``LightGlue``
    ``model``. ``pred`` holds ref_descriptors0/1 stacked over the layers
    and log_assignment; ``data`` gt_assignment (B,M,N), gt_matches0/1 and
    optional mask0/mask1. (The JAX function's ``params`` and ``n_layers``
    are the module and its stack here.)"""
    from .lightglue import assignment_at_layer

    la_final = pred["log_assignment"]
    weights = gt_weights_from_matches(la_final.shape, data["gt_assignment"],
                                      data["gt_matches0"],
                                      data["gt_matches1"])
    nll, metrics = nll_loss(la_final, weights, nll_balancing)
    losses = {"total": nll, "last": nll.detach(), **metrics}
    losses["row_norm"] = la_final.exp()[:, :-1].sum(2).mean(1)

    sum_weights = 1.0
    conf_total = torch.zeros_like(nll)
    N = pred["ref_descriptors0"].shape[1]
    for i in range(N - 1):
        d0 = pred["ref_descriptors0"][:, i]
        d1 = pred["ref_descriptors1"][:, i]
        la_i = assignment_at_layer(model, i, d0, d1, data.get("mask0"),
                                   data.get("mask1"))
        nll_i, _ = nll_loss(la_i, weights, nll_balancing)
        w = gamma ** (N - i - 1) if gamma > 0 else i + 1
        sum_weights += w
        losses["total"] = losses["total"] + nll_i * w

        token = getattr(model, f"token_confidence_{i}").token
        conf_total = conf_total + confidence_loss(
            F.linear(d0.detach(), token.weight, token.bias)[..., 0],
            F.linear(d1.detach(), token.weight, token.bias)[..., 0],
            la_i, la_final) / (N - 1)

    losses["total"] = losses["total"] / sum_weights
    losses["confidence"] = conf_total
    if training:
        losses["total"] = losses["total"] + conf_total
    return losses
