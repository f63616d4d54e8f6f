"""The full multitask training loss, the counterpart of
``nanovs_slam_tpu/train/multitask_loss.py``, term for term:

  total = kp_w * [ loc_w * loc + 2 * desc_w * triplet + score_w * usp
                   + 2 * score_w * score_mse + io_w * io ]
        + seg_w * 0.5 * [ segloss(clean) + segloss(aug) ]
        + vlad_w * hard_triplet(cat(vlad, vlad_aug), paired labels)
        + depth_w * [ d(clean) + d(aug) + 0.5 * MSE(depth_aug,
                                                    warp(depth, H)) ]

where the aug view is the keypoint source and the clean view the target,
segloss = CE * 0.5 + Dice * 1.5 and d() = SILog + Huber * huber_factor.
Model outputs are post-processed (train mode) NHWC dicts.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from ..data.homography import homography_warp_image
from ..losses.depth import depth_loss as depth_loss_fn
from ..losses.keypoint import descriptor_loss, io_loss, keypoint_losses
from ..losses.segmentation import segmentation_loss
from ..losses.triplet import global_descriptor_loss

Tensor = torch.Tensor


class LossWeights(NamedTuple):
    keypoint_loss: float = 1.0
    descriptor_loss: float = 2.0
    score_loss: float = 1.0
    loc_loss: float = 1.0
    io_loss: float = 1.0
    segmentation_loss: float = 2.0
    vlad_loss: float = 1.0
    depth_loss: float = 0.0
    huber_loss: float = 1.0


def default_loss_weights() -> LossWeights:
    return LossWeights()


def multitask_loss(out: Dict[str, Tensor], out_aug: Dict[str, Tensor],
                   batch: Dict[str, Tensor], H: int, W: int,
                   weights: LossWeights, io_net=None,
                   train_flags: Optional[Dict[str, bool]] = None,
                   relax_field: int = 4, io_top_k: int = 300,
                   ) -> tuple:
    """out / out_aug: post-processed (train-mode) model outputs, NHWC.
    batch: seg / seg_aug (B,h,w) int, homography (B,3,3), optional depth /
    depth_aug (B,h,w,1). ``io_net``: the inlier net (in train mode), or
    None for no IO term. Returns (total, {term: value})."""
    flags = {"keypoints": True, "segmentation": True, "visloc": True,
             "depth": "depth" in out}
    if train_flags:
        flags.update(train_flags)

    loss_dict: Dict[str, Tensor] = {}
    total = torch.zeros((), device=batch["homography"].device)

    if flags["keypoints"]:
        kp = keypoint_losses(out, out_aug, batch["homography"], H, W,
                             relax_field)
        # the descriptor loss's sample coordinates are detached: its
        # gradient reaches the dense descriptor maps only
        metric_loss, recall = descriptor_loss(
            out_aug["feat"], out["feat"], kp["source_uv_norm"].detach(),
            kp["source_uv_warped_norm"].detach(),
            kp["source_uv_warped"].detach(), relax_field)
        keypoint_total = (weights.loc_loss * kp["loc_loss"]
                          + weights.descriptor_loss * 2.0 * metric_loss
                          + weights.score_loss * kp["usp_loss"]
                          + weights.score_loss * 2.0 * kp["score_mse"])
        if io_net is not None:
            io = io_loss(out_aug["score"], out_aug["feat"], out["feat"],
                         out["score"], kp["source_uv_norm"],
                         kp["target_uv_norm"], kp["source_uv_warped_norm"],
                         H, W, io_net, top_k=io_top_k)
            keypoint_total = keypoint_total + weights.io_loss * io
            loss_dict["io_loss"] = weights.io_loss * io
        total = total + weights.keypoint_loss * keypoint_total
        loss_dict.update(loc_loss=weights.loc_loss * kp["loc_loss"],
                         metric_loss=metric_loss,
                         usp_loss=weights.score_loss * kp["usp_loss"],
                         recall=recall)

    if flags["segmentation"]:
        seg_loss = (segmentation_loss(out["seg"].float(), batch["seg"]) * 0.5
                    + segmentation_loss(out_aug["seg"].float(),
                                        batch["seg_aug"]) * 0.5)
        total = total + weights.segmentation_loss * seg_loss
        loss_dict["seg_loss"] = weights.segmentation_loss * seg_loss

    if flags["visloc"]:
        vlad_loss = global_descriptor_loss(out["vlad"].float(),
                                           out_aug["vlad"].float())
        total = total + weights.vlad_loss * vlad_loss
        loss_dict["vlad_loss"] = weights.vlad_loss * vlad_loss

    if flags["depth"] and "depth" in out and "depth" in batch:
        d = depth_loss_fn(out["depth"], batch["depth"], weights.huber_loss)
        d = d + depth_loss_fn(out_aug["depth"], batch["depth_aug"],
                              weights.huber_loss)
        warped = homography_warp_image(out["depth"], batch["homography"],
                                       mode="nearest")
        d = d + 0.5 * torch.mean((out_aug["depth"] - warped) ** 2)
        total = total + weights.depth_loss * d
        loss_dict["depth_loss"] = weights.depth_loss * d

    loss_dict["total_loss"] = total
    return total, loss_dict
