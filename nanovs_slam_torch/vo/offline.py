"""Offline sequence VO, the counterpart of ``nanovs_slam_tpu/vo/offline.py``:
the whole trajectory in three device stages instead of a frame loop.

1. one batched forward extracts every frame (batch = frames, padded to a
   multiple of ``extract_chunk``): the dense fine maps, or the fixed-K
   keypoints of the sparse matchers. Frames may travel as uint8 and are
   normalised on the device;
2. the match map runs every consecutive pair's matching (the dense
   matcher, ``bf_match_device``, or LightGlue's fixed-shape masked
   forward) and the pinhole unprojection, and keeps the correspondences
   on the device;
3. the pose map runs the device RANSAC (``ransac_essential_device``) on
   each pair; pair i draws from its own generator, seeded from (seed, i),
   so that a pair's stream does not depend on which pairs ran before it
   (the property ``jax.random.fold_in(key, i)`` gives the JAX package).

Both maps run in chunks of ``pair_batch`` consecutive pairs (the last
chunk the remainder), as the JAX package's ``lax.map(..., batch_size)``
does: one batched call of each matcher (LightGlue at batch P) and one
batched RANSAC (the pairs folded into its restarts' axis) a chunk. Every
pair keeps its own generator, so any ``pair_batch`` gives the match sets
of 1, and its poses up to MSAC's ties between near-equal hypotheses.

``relative_poses_sharded`` splits the pairs over a mesh's ranks: each rank
extracts only its pairs' frames and runs their match and pose maps with
their global pair indices (so their RANSAC streams are those of
``relative_poses``), and every rank gets all the poses.

The host then integrates the relative poses with the ground truth's scale
and computes the reference's error statistics. The JAX package runs each
map as one ``lax.map`` program; here each is a loop of device calls that
never reads back to the host inside a stage. The RANSAC solves in
float64, as the online ``VisualOdometry`` does (the JAX package: float32).
Distortion is not modelled (KITTI's rectified frames have none).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..matching.dense import DenseMatcher, as_frames, dense_maps
from ..ops.image import quantize_u8, to_model_input
from ..utils.device import resolve_device
from .groundtruth import KittiVideoGroundTruth
from .pose import (assemble_vo_error_stats, calculate_error_stats,
                   calculate_relative_error, ransac_essential_device)

Tensor = torch.Tensor

def pair_generator(seed: int, i: int, device) -> torch.Generator:
    """The RANSAC generator of pair i: seeded from (seed, i) alone."""
    state = np.random.SeedSequence((seed, i)).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0]))


class OfflineVO:
    """Sequence-level VO with the dense (detector-free), BF or LightGlue
    matcher.

    model / cfg: a KP2DTiny model (weights loaded) and its config; the
    model is moved to ``device`` (default "cuda"; a CUDA device without a
    card raises). size: (H, W) inference size. cam: the host
    PinholeCamera of the original frames (keypoints are scaled to them
    before the unprojection, reference visual_odometry.py:310).

    matcher "dense" extracts dense maps (k match slots a pair; a pair
    keeps what passes ``dense_rel_conf`` * its largest confidence, or the
    absolute ``dense_conf`` at 0, topped up by rank to ``n_matches``);
    "bf" and "lightglue" extract the top-k keypoints (the online
    frontend's contract) and match with ``vo.matcher.bf_match_device`` or
    with LightGlue's masked forward on keypoints scaled to the camera's
    size. ``lightglue``: a LightGlue module, or the tuple of
    ``load_lightglue_for_vo``. The pose map: ``n_hypotheses`` and
    ``restarts`` of the device RANSAC. ``pair_batch``: the pairs of a
    chunk of the match and pose maps (the RANSAC's residuals take P x
    restarts x n_hypotheses x N float64 a chunk)."""

    def __init__(self, model, cfg, size: Tuple[int, int], cam,
                 k: int = 512, n_matches: int = 400,
                 dense_conf: float = 0.05, n_hypotheses: int = 8192,
                 extract_chunk: int = 16, matcher: str = "dense",
                 lightglue=None, ratio_test: float = 0.7,
                 dense_rel_conf: float = 0.1, restarts: int = 3,
                 pair_batch: int = 1, max_single_dispatch: int = 128,
                 device=None):
        if matcher not in ("dense", "bf", "lightglue"):
            raise ValueError(f"unsupported offline matcher: {matcher!r}")
        if matcher == "lightglue" and lightglue is None:
            raise ValueError("matcher='lightglue' needs lightglue= (a "
                             "LightGlue module)")
        self.pair_batch = max(1, pair_batch or 1)
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.cfg = cfg
        self.matcher = matcher
        self.H, self.W = size
        self.cam = cam
        self.k = k
        self.n_matches = n_matches
        self.dense_conf = dense_conf
        self.dense_rel_conf = dense_rel_conf
        self.ratio_test = ratio_test
        self.n_hypotheses = n_hypotheses
        self.restarts = restarts
        self.extract_chunk = extract_chunk
        self.max_single_dispatch = max_single_dispatch
        dev = self.device
        self._scale = torch.tensor([cam.width / self.W, cam.height / self.H],
                                   dtype=torch.float32, device=dev)
        self._c = torch.tensor([cam.cx, cam.cy], dtype=torch.float32,
                               device=dev)
        self._f = torch.tensor([cam.fx, cam.fy], dtype=torch.float32,
                               device=dev)
        if matcher == "dense":
            self.dm = DenseMatcher(model, cfg, size, k=k, device=dev)
        else:
            from ..matching.extractor import make_extractor

            self._sparse = make_extractor(model, cfg, self.H, self.W,
                                          max_keypoints=k, device=dev)
        self.lightglue = None
        if matcher == "lightglue":
            lg = lightglue[0] if isinstance(lightglue, tuple) else lightglue
            self.lightglue = lg.to(dev).eval()

    # ------------------------------------------------------------ stages

    def _unproject(self, kp: Tensor) -> Tensor:
        """Keypoints of the resized frame -> normalised image-plane
        coordinates of the camera frame (float32)."""
        return (kp * self._scale - self._c) / self._f

    def _extract_batch(self, raw: Tensor):
        if self.matcher == "dense":
            return dense_maps(self.model, self.cfg, raw)
        e = self._sparse(to_model_input(raw))
        return e["keypoints"], e["descriptors"], e["mask"]

    @torch.inference_mode()
    def extract(self, frames):
        """(T, H, W, 3) uint8 or float [0, 1] frames (numpy or a tensor)
        -> the frames' representations on the device: (T, Hf, Wf, C) dense
        maps, or (kp (T, k, 2), desc (T, k, C), mask (T, k)).

        T is padded (with the last frame) to a multiple of extract_chunk;
        up to max_single_dispatch padded frames run as one batch, longer
        sequences chunk by chunk."""
        x = as_frames(frames, self.device)
        T = x.shape[0]
        c = self.extract_chunk
        pad = (-T) % c
        if pad:
            x = torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])
        if x.shape[0] <= self.max_single_dispatch:
            chunks = [self._extract_batch(x)]
        else:
            chunks = [self._extract_batch(x[i:i + c])
                      for i in range(0, x.shape[0], c)]
        if self.matcher == "dense":
            return torch.cat(chunks)[:T]
        return tuple(torch.cat(parts)[:T] for parts in zip(*chunks))

    def _chunks(self, n: int):
        """The pair slices of the maps: ``pair_batch`` pairs each, the
        last the remainder."""
        return [slice(i, min(i + self.pair_batch, n))
                for i in range(0, n, self.pair_batch)]

    def _match_step(self, r0, r1):
        """A chunk of P pairs' representations (leading axis P) -> (kpn0
        (P, K, 2), kpn1 (P, K, 2), valid (P, K)) normalised
        correspondences and their validity."""
        if self.matcher == "dense":
            kp0, kp1, conf = self.dm.match_maps(r0, r1)
            # the online loop's dense policy without a host read: the
            # confidences are sorted, so the confident set is rank < n_over
            # and the top-up's union rank < max(n_over, n_matches)
            thr = self.dense_rel_conf * conf.max(-1, keepdim=True).values \
                if self.dense_rel_conf > 0 else self.dense_conf
            n_over = (conf > thr).sum(-1, keepdim=True)
            rank = torch.arange(conf.shape[-1], device=conf.device)
            keep = (rank < torch.clamp(n_over, min=self.n_matches)) \
                & (conf > 0.0)
            return self._unproject(kp0), self._unproject(kp1), keep
        (kp0, d0, m0), (kp1, d1, m1) = r0, r1
        if self.matcher == "bf":
            from .matcher import bf_match_device

            t_idx, valid = bf_match_device(d0, d1, m0, m1, self.ratio_test)
            t_idx = t_idx.long()
        else:
            from ..matching.lightglue import normalize_keypoints

            # the online loop matches keypoints scaled to the camera frame
            # (reference visual_odometry.py:119-121)
            size = (self.cam.width, self.cam.height)
            pred = self.lightglue({
                "keypoints0": normalize_keypoints(kp0 * self._scale, size),
                "keypoints1": normalize_keypoints(kp1 * self._scale, size),
                "descriptors0": d0, "descriptors1": d1,
                "mask0": m0, "mask1": m1})
            mtc = pred["matches0"]
            valid = mtc >= 0
            t_idx = torch.clamp(mtc, min=0)
        kp1m = torch.gather(kp1, 1, t_idx[..., None].expand(-1, -1, 2))
        return self._unproject(kp0), self._unproject(kp1m), valid

    @torch.inference_mode()
    def match_map(self, reps):
        """The representations of T frames -> (kpn0, kpn1 (T-1, K, 2),
        valid (T-1, K)): every consecutive pair's correspondences, a
        chunk of ``pair_batch`` pairs a call of the matcher."""
        dense = self.matcher == "dense"
        T = (reps if dense else reps[0]).shape[0]

        def frames(lo, hi):
            return reps[lo:hi] if dense else tuple(a[lo:hi] for a in reps)

        out = [self._match_step(frames(sl.start, sl.stop),
                                frames(sl.start + 1, sl.stop + 1))
               for sl in self._chunks(T - 1)]
        return tuple(torch.cat(parts) for parts in zip(*out))

    @torch.inference_mode()
    def pose_map(self, kpn0: Tensor, kpn1: Tensor, valid: Tensor,
                 seed: int = 0, pair_index=None):
        """Correspondences of T-1 pairs -> (R (T-1, 3, 3), t (T-1, 3),
        n_inliers (T-1,), n_matches (T-1,)) on the device, by the device
        RANSAC in float64 on chunks of ``pair_batch`` pairs, pair i from
        ``pair_generator(seed, pair_index[i])`` (default: i)."""
        out = []
        for sl in self._chunks(kpn0.shape[0]):
            gens = [pair_generator(seed, i if pair_index is None
                                   else int(pair_index[i]), self.device)
                    for i in range(sl.start, sl.stop)]
            R, t, inl = ransac_essential_device(
                kpn0[sl].double(), kpn1[sl].double(), gens, valid=valid[sl],
                n_hypotheses=self.n_hypotheses, restarts=self.restarts)
            out.append((R, t[..., 0], inl.sum(-1), valid[sl].sum(-1)))
        return tuple(torch.cat(parts) for parts in zip(*out))

    def relative_poses(self, frames, seed: int = 0):
        """(T, H, W, 3) uint8 or float [0, 1] frames -> (R (T-1, 3, 3),
        t (T-1, 3), n_inliers (T-1,), n_matches (T-1,)) numpy arrays."""
        out = self.pose_map(*self.match_map(self.extract(frames)), seed=seed)
        return tuple(a.cpu().numpy() for a in out)

    def relative_poses_sharded(self, frames, mesh, seed: int = 0):
        """``relative_poses`` with the pairs split over ``mesh``'s first
        axis (this VO on the rank's device). The pair count is padded to a
        multiple of the ranks by repeating the last pair; each rank takes
        a contiguous run of pairs, extracts only their frames, and runs
        their matches and poses, pair i drawing from ``pair_generator(seed,
        i)`` with its global index; the results are gathered on every rank
        and the pads dropped. Match sets equal ``relative_poses``'s; poses
        equal them up to MSAC's ties between near-equal hypotheses."""
        from ..parallel.mesh import all_gather_rows

        mesh = mesh.axis(mesh.axis_names[0])
        n_pairs = len(frames) - 1
        per = -(-n_pairs // mesh.size)
        index = [min(i, n_pairs - 1) for i in range(per * mesh.size)]
        mine = index[mesh.rank * per:(mesh.rank + 1) * per]
        lo = mine[0]
        kpn0, kpn1, valid = self.match_map(
            self.extract(frames[lo:mine[-1] + 2]))
        sel = torch.tensor([i - lo for i in mine], device=self.device)
        out = self.pose_map(kpn0[sel], kpn1[sel], valid[sel], seed=seed,
                            pair_index=mine)
        return tuple(all_gather_rows(mesh, a)[:n_pairs].cpu().numpy()
                     for a in out)


def offline_results(gt, R, t, n_inliers, n_matches,
                    verbose: bool = False) -> Dict:
    """The relative poses of pairs (i, i + 1) -> the reference's error
    statistics against ``gt`` (evaluation/visual_odometry.py:318-332);
    with ``verbose`` also the trajectory integrated at scale 1 (one entry
    a frame, as the online loop gives it), no failed estimate (every pair
    returns a pose; a starved pair shows as few inliers) and the match
    and inlier statistics."""
    t_errs, r_errs = [], []
    for i in range(len(R)):
        te, re = calculate_relative_error(gt, i + 1, R[i].astype(float),
                                          t[i].astype(float).reshape(3, 1))
        t_errs.append(te)
        r_errs.append(re)
    errs = assemble_vo_error_stats(t_errs, r_errs)
    if not verbose:
        return errs["total"]
    cur_R, cur_t = np.eye(3), np.zeros((3, 1))
    trajectory = [cur_t.reshape(3).tolist()]
    for i in range(len(R)):
        cur_t = cur_t + cur_R @ t[i].astype(float).reshape(3, 1)
        cur_R = cur_R @ R[i].astype(float)
        trajectory.append(cur_t.reshape(3).tolist())
    return {**errs, "trajectory": trajectory, "estimation_fails": 0,
            "stats": {"n_matches": calculate_error_stats(
                          np.asarray(n_matches, float)),
                      "n_inliers": calculate_error_stats(
                          np.asarray(n_inliers, float))}}


def evaluate_visual_odometry_offline(model, cfg, kitti_path: str,
                                     gt_name: str, video_name: str,
                                     new_size, cam=None,
                                     max_frames: Optional[int] = None,
                                     n_matches: int = 400,
                                     verbose: bool = False,
                                     matcher: str = "dense", lightglue=None,
                                     k: int = 512,
                                     dense_rel_conf: float = 0.1,
                                     n_hypotheses: int = 8192,
                                     restarts: int = 3,
                                     transfer_u8: Optional[bool] = None,
                                     device=None) -> Dict:
    """The sequence-level counterpart of ``evaluate_visual_odometry``
    (reference evaluation/visual_odometry.py:165-176, 318-332): read the
    frames of ``kitti_path/video_name`` (cv2), resize them in float, run
    ``OfflineVO`` and hold the poses against ``kitti_path/gt_name``.

    ``transfer_u8``: ship the resized frames as uint8; None turns it on
    when the model computes in bfloat16 (the 2/255 step equals the input
    cast's ulp there)."""
    from .camera import PinholeCamera, kitti_params
    from .visual_odometry import prep_frame, read_video

    dev = resolve_device(device)
    gt = KittiVideoGroundTruth(kitti_path, gt_name)
    frames = []
    for f in read_video(f"{kitti_path}/{video_name}"):
        if max_frames is not None and len(frames) >= max_frames:
            break
        frames.append(f)
    if len(frames) < 3:
        raise RuntimeError(f"need >= 3 frames, got {len(frames)}")
    H, W = new_size
    if cam is None:
        fx, fy, cx, cy = kitti_params()
        cam = PinholeCamera(frames[0].shape[1], frames[0].shape[0], fx, fy,
                            cx, cy)
    stack = torch.stack([prep_frame(f, (H, W), dev) for f in frames])
    if transfer_u8 is None:
        transfer_u8 = cfg.dtype == "bfloat16"
    if transfer_u8:
        stack = quantize_u8(stack)
    vo = OfflineVO(model, cfg, (H, W), cam, n_matches=n_matches,
                   matcher=matcher, lightglue=lightglue, k=k,
                   dense_rel_conf=dense_rel_conf, n_hypotheses=n_hypotheses,
                   restarts=restarts, device=dev)
    return offline_results(gt, *vo.relative_poses(stack), verbose=verbose)
