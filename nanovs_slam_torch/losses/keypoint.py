"""Self-supervised keypoint losses (loc / descriptor triplet / USP score /
IO), the counterpart of ``nanovs_slam_tpu/losses/keypoint.py`` on NHWC
tensors.

- ``warp_coords_homography``: a 3x3 homography on normalised uv coords
  with the perspective divide.
- loc loss: pairwise L2 between warped source and target coords over all
  cells, the per-source minimum; masked mean over (min < 4 px) and the
  interior cells.
- descriptor triplet loss: dense descriptors sampled at the source coords
  and the warped source coords, the reference's eps-in-norm
  normalisation, sqrt(2 - 2 cos) distances floored at 1e-6 inside the
  sqrt, the hardest negative outside a relax_field box, torch's
  triplet_margin_loss (margin 0.2, p = 2, pairwise eps 1e-6); recall = the
  exact-NN rate.
- USP score loss and the resampled-score MSE over the interior.
- IO loss: the bottom-K scoring cells (in index order), descriptor NN
  association, the inlier net's prediction against the geometric label
  2 (err < 4 px) - 1, MSE gated by (#inliers > 10).

Tie rules follow JAX: ``torch.maximum`` (half the gradient each way at a
tie), ``amin`` / ``amax`` (the gradient split over tied minima),
``argmin`` (the first), the bottom-K by ``ops/postprocess.stable_top_k``
(``lax.top_k``'s order); ``safe_norm`` adds eps inside the sqrt. The
descriptor loss's coordinates and the resampled target score's sampling
coordinates are detached, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..ops.grid_sample import grid_sample_bilinear
from ..ops.postprocess import stable_top_k

Tensor = torch.Tensor


def normalize_uv(coords: Tensor, H: int, W: int) -> Tensor:
    """Image coords (..., 2) -> normalised [-1, 1]."""
    x = coords[..., 0] / ((W - 1) / 2.0) - 1.0
    y = coords[..., 1] / ((H - 1) / 2.0) - 1.0
    return torch.stack([x, y], dim=-1)


def denormalize_uv(coords: Tensor, H: int, W: int) -> Tensor:
    x = (coords[..., 0] + 1.0) * ((W - 1) / 2.0)
    y = (coords[..., 1] + 1.0) * ((H - 1) / 2.0)
    return torch.stack([x, y], dim=-1)


def warp_coords_homography(coords: Tensor, homography: Tensor) -> Tensor:
    """coords (B, ..., 2) normalised, homography (B, 3, 3) -> warped."""
    B = coords.shape[0]
    lead = coords.shape[1:-1]
    pts = coords.reshape(B, -1, 2)
    homo = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)
    warped = torch.einsum("bnc,bdc->bnd", homo, homography)
    warped = warped[..., :2] / warped[..., 2:3]
    return warped.reshape((B,) + tuple(lead) + (2,))


def _interior(x: Tensor) -> Tensor:
    """The interior cells of (B, Hc, Wc, ...)."""
    return x[:, 1:-1, 1:-1]


def _relu(x: Tensor) -> Tensor:
    """max(x, 0) with ``jnp.maximum``'s half gradient at 0."""
    return torch.maximum(x, torch.zeros_like(x))


def masked_mean(x: Tensor, mask: Tensor, eps: float = 1e-12) -> Tensor:
    """sum(x m) / (sum(m) + eps), the mask broadcast to x's shape first."""
    m = torch.broadcast_to(mask, x.shape).to(x.dtype)
    return torch.sum(x * m) / (torch.sum(m) + eps)


def safe_norm(x: Tensor, dim: int = -1, keepdim: bool = False,
              eps: float = 1e-12) -> Tensor:
    """sqrt(sum(x^2) + eps): a finite gradient at x == 0."""
    return torch.sqrt(torch.sum(x * x, dim=dim, keepdim=keepdim) + eps)


def _cos_distance(a: Tensor, b: Tensor) -> Tensor:
    """sqrt(max(2 - 2 a.b, 1e-6)) over the last dim, all pairs."""
    d = 2.0 - 2.0 * torch.einsum("bmc,bnc->bmn", a, b)
    return torch.sqrt(torch.maximum(d, torch.full_like(d, 1e-6)))


def _take(x: Tensor, idx: Tensor) -> Tensor:
    """x (B, N, C), idx (B, M) -> (B, M, C)."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def descriptor_loss(source_feat: Tensor, target_feat: Tensor,
                    source_uv_norm: Tensor, source_uv_warped_norm: Tensor,
                    source_uv_warped: Tensor, relax_field: int = 4,
                    margin: float = 0.2, epsilon: float = 1e-8,
                    ) -> Tuple[Tensor, Tensor]:
    """Per-pixel triplet loss and recall over the interior cells.

    source_feat / target_feat: (B, Hf, Wf, C) dense maps.
    source_uv_norm / source_uv_warped_norm: (B, Hc, Wc, 2) normalised.
    source_uv_warped: (B, Hc, Wc, 2) image coords.
    """
    B = source_uv_norm.shape[0]
    src_pts = _interior(source_uv_norm).reshape(B, -1, 2)
    tgt_pts = _interior(source_uv_warped_norm).reshape(B, -1, 2)
    tgt_raw = _interior(source_uv_warped).reshape(B, -1, 2)

    def ref_norm(d):  # the reference's norm(x + eps) + eps
        return d / (safe_norm(d + epsilon, keepdim=True) + epsilon)

    ref_desc = ref_norm(grid_sample_bilinear(source_feat.float(), src_pts))
    tar_desc = ref_norm(grid_sample_bilinear(target_feat.float(), tgt_pts))
    dmat = _cos_distance(ref_desc, tar_desc)

    nn_idx = torch.argmin(dmat, dim=2)
    nn_xy = _take(tgt_raw, nn_idx)
    exact = (nn_xy[..., 0] == tgt_raw[..., 0]) & \
        (nn_xy[..., 1] == tgt_raw[..., 1])
    recall = exact.float().mean()

    # the hardest negative outside the relax_field box around the truth
    dx = torch.abs(tgt_raw[:, :, None, 0] - tgt_raw[:, None, :, 0])
    dy = torch.abs(tgt_raw[:, :, None, 1] - tgt_raw[:, None, :, 1])
    correct_box = (dx <= relax_field) & (dy <= relax_field)
    neg_idx = torch.argmin(torch.where(correct_box, 2.0, dmat), dim=2)
    neg_desc = _take(tar_desc, neg_idx)

    eps_pd = 1e-6  # torch's pairwise_distance eps, per element
    d_pos = safe_norm(ref_desc - tar_desc + eps_pd)
    d_neg = safe_norm(ref_desc - neg_desc + eps_pd)
    return _relu(d_pos - d_neg + margin).mean(), recall


def keypoint_losses(out: Dict[str, Tensor], out_aug: Dict[str, Tensor],
                    homography: Tensor, H: int, W: int,
                    relax_field: int = 4) -> Dict[str, Tensor]:
    """loc and USP score terms, and the coordinates the descriptor and IO
    losses take. out / out_aug are post-processed (train-mode) dicts:
    score (B,Hc,Wc,1) border-masked, coord (B,Hc,Wc,2) image coords, feat
    dense (B,Hf,Wf,C). The aug view is the source, the clean view the
    target."""
    source_score = out_aug["score"].float()
    source_uv = out_aug["coord"].float()
    target_score = out["score"].float()
    target_uv = out["coord"].float()
    B, Hc, Wc, _ = target_score.shape

    target_uv_norm = normalize_uv(target_uv, H, W)
    source_uv_norm = normalize_uv(source_uv, H, W)
    source_uv_warped_norm = warp_coords_homography(source_uv_norm, homography)
    source_uv_warped = denormalize_uv(source_uv_warped_norm, H, W)

    border = torch.zeros((Hc, Wc), dtype=torch.bool,
                         device=target_score.device)
    border[1:-1, 1:-1] = True
    border_flat = border.reshape(1, Hc * Wc)

    src = source_uv_warped.reshape(B, Hc * Wc, 2)
    tgt = target_uv.reshape(B, Hc * Wc, 2)
    d2 = torch.sum((src[:, :, None] - tgt[:, None, :]) ** 2, dim=-1)
    dmat = torch.sqrt(torch.maximum(d2, torch.full_like(d2, 1e-12)))
    d_min = torch.amin(dmat, dim=2)
    d_min_idx = torch.argmin(dmat, dim=2)

    valid = (d_min < 4.0) & border_flat
    loc_loss = masked_mean(d_min, valid)

    tgt_assoc = torch.gather(target_score.reshape(B, Hc * Wc), 1, d_min_idx)
    src_score_flat = source_score.reshape(B, Hc * Wc)
    usp = (tgt_assoc + src_score_flat) * (d_min - masked_mean(d_min, valid))
    usp_loss = masked_mean(usp, valid)

    tgt_score_resampled = grid_sample_bilinear(
        target_score, source_uv_warped_norm.detach())
    mse = ((tgt_score_resampled - source_score) ** 2)[..., 0]
    score_mse = masked_mean(mse, border[None])

    return {
        "loc_loss": loc_loss,
        "usp_loss": usp_loss,
        "score_mse": score_mse,
        "source_uv_norm": source_uv_norm,
        "source_uv_warped_norm": source_uv_warped_norm,
        "source_uv_warped": source_uv_warped,
        "target_uv_norm": target_uv_norm,
    }


def io_loss(source_score: Tensor, source_feat: Tensor, target_feat: Tensor,
            target_score: Tensor, source_uv_norm: Tensor,
            target_uv_norm: Tensor, source_uv_warped_norm: Tensor, H: int,
            W: int, io_net, top_k: int = 300, epsilon: float = 1e-8
            ) -> Tensor:
    """The IO-Net loss; ``io_net`` maps point pairs (B, K, 5) =
    [source uv, associated target uv, descriptor distance] to logits."""
    source_feat = source_feat.float()
    target_feat = target_feat.float()
    B, Hc, Wc, _ = source_uv_norm.shape

    def bottom_k_sorted(score):  # the K lowest, in index order
        _, idx = stable_top_k(-score.float().reshape(B, Hc * Wc), top_k)
        return torch.sort(idx, dim=1).values

    idx1 = bottom_k_sorted(source_score)
    idx2 = bottom_k_sorted(target_score)
    src_uv_topk = _take(source_uv_norm.reshape(B, Hc * Wc, 2), idx1)
    tgt_uv_topk = _take(target_uv_norm.reshape(B, Hc * Wc, 2), idx2)
    src_warped_topk = _take(source_uv_warped_norm.reshape(B, Hc * Wc, 2),
                            idx1)

    src_desc = grid_sample_bilinear(source_feat, src_uv_topk)
    tgt_desc = grid_sample_bilinear(target_feat, tgt_uv_topk)
    src_desc = src_desc / (safe_norm(src_desc, keepdim=True) + epsilon)
    tgt_desc = tgt_desc / (safe_norm(tgt_desc, keepdim=True) + epsilon)
    dmat = _cos_distance(src_desc, tgt_desc)
    dmat_min = torch.amin(dmat, dim=2)
    tgt_assoc = _take(tgt_uv_topk, torch.argmin(dmat, dim=2))
    point_pair = torch.cat([src_uv_topk, tgt_assoc, dmat_min[..., None]],
                           dim=-1)
    inlier_pred = io_net(point_pair)

    match_err = safe_norm(denormalize_uv(tgt_assoc, H, W)
                          - denormalize_uv(src_warped_topk, H, W))
    inlier_mask = match_err < 4.0
    inlier_gt = 2.0 * inlier_mask.float() - 1.0
    gate = (inlier_mask.sum() > 10).float()
    return gate * torch.mean((inlier_pred - inlier_gt) ** 2)
