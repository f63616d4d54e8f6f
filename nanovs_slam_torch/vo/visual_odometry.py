"""Frame-to-frame visual odometry, the counterpart of
``nanovs_slam_tpu/vo/visual_odometry.py`` (reference:
src/visual_odometry/visual_odometry.py:75-472 and
src/evaluation/visual_odometry.py:200-332).

Per frame: resize -> extract keypoints and descriptors (the frontend, on
the device) -> match against the previous frame (host BF ratio test,
FLANN, crosscheck, per-class, or LightGlue on the device; or, detector-
free, the dense matcher on the device) -> essential-matrix pose (host cv2
USAC_MSAC, or ``ransac_essential_device``) ->
integrate ``cur_t += scale * cur_R @ t; cur_R = cur_R @ R``; then the
per-frame relative errors against the ground truth.

A failed estimate (cv2's error, or too few matches for the device solver)
gives an identity pose and counts in ``estimation_fails``, as in the
reference; any other exception (a kernel's build or launch error, a
missing cv2) propagates.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Dict, Iterable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.image import quantize_u8
from ..utils.device import resolve_device
from .camera import PinholeCamera, kitti_params
from .groundtruth import KittiVideoGroundTruth
from .matcher import (match_crosscheck_fundamental, match_keypoints,
                      match_keypoints_flann, match_semantic)
from .pose import (assemble_vo_error_stats, calculate_error_stats,
                   calculate_relative_error, estimate_pose,
                   ransac_essential_device)

class TooFewMatchesError(RuntimeError):
    """Fewer matches than the device solver's 8-point samples need."""


def _failed_estimate_errors():
    """What counts as a failed estimate: too few matches, and cv2's own
    error where cv2 is loaded (the host tail imports it when it runs)."""
    cv2 = sys.modules.get("cv2")
    return (TooFewMatchesError,) + ((cv2.error,) if cv2 is not None else ())


class VisualOdometryStats:
    def __init__(self):
        self.n_matches = []
        self.n_inliers = []
        self.network_inference_timing = []
        self.pose_estimation_timing = []

    def as_dict(self) -> Dict:
        def stats(v):
            a = np.asarray(v, np.float64)
            return calculate_error_stats(a) if len(a) else {}
        return {
            "n_matches": stats(self.n_matches),
            "n_inliers": stats(self.n_inliers),
            "network_inference_timing": stats(self.network_inference_timing),
            "pose_estimation_timing": stats(self.pose_estimation_timing),
        }


class VisualOdometry:
    """Matcher modes (reference visual_odometry.py:72-97): "bf" (exact kNN
    + ratio + one-to-one, the native matcher where it loads), "flann"
    (approximate kNN, same tail), "crosscheck" (mutual NN + fundamental
    fit), "semantic" (per-class BF; needs a frontend with with_seg or the
    semantic filter), "lightglue" (the port's LightGlue on the device),
    "dense" (detector-free image-pair matching, ``matching/dense.py``: the
    frontend is bypassed, and the previous frame's dense map stays on the
    device).

    Dense filtering: with ``dense_rel_conf`` > 0 a pair keeps the matches
    whose confidence exceeds dense_rel_conf * its largest (0: the absolute
    ``dense_conf``), topped up by rank to ``DENSE_MIN_MATCHES`` (never with
    a non-mutual, zero-confidence match).

    ``device`` (default "cuda"; a CUDA device without a card raises) runs
    LightGlue and, with ``device_pose``, the RANSAC; the frontend and the
    dense matcher run on their own."""

    MATCHERS = ("bf", "flann", "crosscheck", "semantic", "lightglue",
                "dense")
    DENSE_MIN_MATCHES = 400

    def __init__(self, frontend, cam: PinholeCamera, matcher: str = "bf",
                 lightglue=None, dense=None, top_k_matches: int = 1000,
                 ratio_test: float = 0.7, n_classes: int = 28,
                 dense_conf: float = 0.05, dense_rel_conf: float = 0.1,
                 device_pose: bool = False, pose_hypotheses: int = 8192,
                 pose_restarts: int = 3, device=None):
        if matcher not in self.MATCHERS:
            raise ValueError(f"matcher must be one of {self.MATCHERS}")
        if matcher == "dense" and dense is None:
            raise ValueError("matcher='dense' needs a DenseMatcher "
                             "(matching/dense.py) via dense=")
        if matcher == "lightglue" and lightglue is None:
            raise ValueError("matcher='lightglue' needs lightglue= (the "
                             "load_lightglue_for_vo tuple; CLI: pass "
                             "--lg_ckpt)")
        self.device = resolve_device(device)
        self.frontend = frontend
        self.cam = cam
        self.matcher = matcher
        # (model, frame size (W, H), max_n) from load_lightglue_for_vo
        self.lightglue = lightglue
        if lightglue is not None:
            lightglue[0].to(self.device).eval()
        self.dense = dense
        self.dense_conf = dense_conf
        self.dense_rel_conf = dense_rel_conf
        self.fmap_prev = None  # the previous dense map, on the device
        self.device_pose = device_pose
        self.pose_hypotheses = pose_hypotheses
        self.pose_restarts = pose_restarts
        self._frame_idx = 0
        self.top_k_matches = top_k_matches
        self.ratio_test = ratio_test
        self.n_classes = n_classes

        self.cur_R = np.eye(3)
        self.cur_t = np.zeros((3, 1))
        self.kps_prev = None
        self.feat_prev = None
        self.seg_prev = None
        self.stats = VisualOdometryStats()
        self.estimation_fails = 0
        self.trajectory = []
        # the last matched pair and its inlier mask, for track drawing
        self.m_kps0 = np.zeros((0, 2))
        self.m_kps1 = np.zeros((0, 2))
        self.mask_match = np.zeros((0,), bool)

    def _extract(self, img01, prefetched=None):
        """The timed frontend run; with ``prefetched`` (a handle from
        begin_extract) only the fetch is timed."""
        t0 = time.perf_counter()
        if prefetched is not None:
            kps, feat, out = self.frontend.fetch(prefetched)
        else:
            kps, feat, out = self.frontend.run(img01)
        self.stats.network_inference_timing.append(time.perf_counter() - t0)
        return kps, feat, out

    def begin_extract(self, img01):
        """Enqueue the frame's extraction without waiting; pass the handle
        to process_image(..., prefetched=). The device extracts frame t+1
        while the host matches and solves frame t. None in dense mode,
        which extracts as it matches."""
        if self.matcher == "dense":
            return None
        return self.frontend.run_async(img01)

    def init(self, img01):
        if self.matcher == "dense":
            t0 = time.perf_counter()
            self.fmap_prev = self.dense.extract(img01)
            self.stats.network_inference_timing.append(
                time.perf_counter() - t0)
        else:
            self.kps_prev, self.feat_prev, out = self._extract(img01)
            self.seg_prev = out.get("kp_class")
        self.trajectory.append(self.cur_t.copy())

    def _match_dense(self, img01):
        """Detector-free pair matching (reference LoFTR branch,
        visual_odometry.py:296-310): the new frame's dense map (timed as
        the extraction), matched against the previous one on the device,
        filtered on the host."""
        t0 = time.perf_counter()
        fmap = self.dense.extract(img01)
        self.stats.network_inference_timing.append(time.perf_counter() - t0)
        kp0, kp1, conf = (t.cpu().numpy() if isinstance(t, torch.Tensor)
                          else np.asarray(t)
                          for t in self.dense.match_maps(self.fmap_prev, fmap))
        thr = self.dense_rel_conf * conf.max() if self.dense_rel_conf > 0 \
            else self.dense_conf
        keep = conf > thr
        if keep.sum() < self.DENSE_MIN_MATCHES:
            # top up by rank to the pose budget; a zero confidence is a
            # pair that failed the mutual check, never admitted
            keep = np.argsort(-conf)[:self.DENSE_MIN_MATCHES]
            keep = keep[conf[keep] > 0.0]
        self.fmap_prev = fmap
        return kp0[keep], kp1[keep]

    def _match(self, kps, feat, seg):
        if self.matcher == "lightglue":
            return self._match_lightglue(kps, feat)
        if self.matcher == "semantic":
            if seg is None or self.seg_prev is None:
                raise ValueError(
                    "semantic matching needs per-keypoint classes; build "
                    "the frontend with with_seg=True or semantic_filter")
            return match_semantic(self.kps_prev, self.feat_prev,
                                  self.seg_prev, kps, feat, seg,
                                  self.n_classes, self.ratio_test)
        if self.matcher == "flann":
            return match_keypoints_flann(self.kps_prev, self.feat_prev,
                                         kps, feat, self.top_k_matches,
                                         self.ratio_test)
        if self.matcher == "crosscheck":
            return match_crosscheck_fundamental(self.kps_prev,
                                                self.feat_prev, kps, feat,
                                                self.ratio_test)
        return match_keypoints(self.kps_prev, self.feat_prev, kps, feat,
                               self.top_k_matches, self.ratio_test)

    def _match_lightglue(self, kps, feat):
        from ..matching.lightglue import inference_forward, normalize_keypoints

        model, size, max_n = self.lightglue
        dev = self.device

        def pad(a, n):
            # truncate first: the frontend's keypoints are score-sorted,
            # so the kept prefix is the strongest n
            a = a[:n]
            out = np.zeros((n,) + a.shape[1:], np.float32)
            out[:len(a)] = a
            return torch.from_numpy(out)[None].to(dev)

        kps_prev, feat_prev = self.kps_prev[:max_n], self.feat_prev[:max_n]
        kps, feat = kps[:max_n], feat[:max_n]
        n0, n1 = len(kps_prev), len(kps)
        ar = torch.arange(max_n, device=dev)[None]
        data = {"keypoints0": normalize_keypoints(pad(kps_prev, max_n), size),
                "keypoints1": normalize_keypoints(pad(kps, max_n), size),
                "descriptors0": pad(feat_prev, max_n),
                "descriptors1": pad(feat, max_n),
                "mask0": ar < n0, "mask1": ar < n1}
        with torch.inference_mode():
            m0 = inference_forward(model, data)["matches0"][0].cpu().numpy()
        valid = m0 > -1
        idx0 = np.nonzero(valid)[0]
        idx1 = m0[valid]
        return kps_prev[idx0[idx0 < n0]], kps[idx1[idx0 < n0]]

    def process_image(self, img01, absolute_scale: float = 1.0,
                      prefetched=None):
        """Returns (R, t, n_matches); updates the integrated pose.
        ``prefetched``: an optional handle from begin_extract(img01)."""
        dense = self.matcher == "dense"
        if dense:
            kps = feat = seg = None
            dense_kps = self._match_dense(img01)  # times its extraction
        else:
            kps, feat, out = self._extract(img01, prefetched)
            seg = out.get("kp_class")
        t0 = time.perf_counter()
        m_kps0, m_kps1 = dense_kps if dense else self._match(kps, feat, seg)
        try:
            if self.device_pose:
                R, t, mask_match = self._estimate_pose_on_device(m_kps0,
                                                                 m_kps1)
            else:
                R, t, mask_match, _ = estimate_pose(m_kps0, m_kps1,
                                                    self.cam)
            n_inliers = int(np.count_nonzero(mask_match))
            self.mask_match = np.asarray(mask_match).reshape(-1) != 0
        except _failed_estimate_errors():
            R, t = np.eye(3), np.zeros((3, 1))
            m_kps0 = np.zeros((0, 2))
            m_kps1 = np.zeros((0, 2))
            n_inliers = 0
            self.mask_match = np.zeros((0,), bool)
            self.estimation_fails += 1
        self.m_kps0, self.m_kps1 = m_kps0, m_kps1
        self.stats.pose_estimation_timing.append(time.perf_counter() - t0)

        self.stats.n_matches.append(len(m_kps0))
        self.stats.n_inliers.append(n_inliers)
        # pose integration (visual_odometry.py:336-337)
        self.cur_t = self.cur_t + absolute_scale * self.cur_R.dot(t)
        self.cur_R = self.cur_R.dot(R)
        self.trajectory.append(self.cur_t.copy())
        if not dense:
            self.kps_prev, self.feat_prev, self.seg_prev = kps, feat, seg
        return R, t, len(m_kps0)

    def _estimate_pose_on_device(self, m_kps0, m_kps1):
        """The device RANSAC tail: undistort and unproject on the host,
        pad the matches to a power-of-two slot count (at least 512) behind
        a validity mask, then ``ransac_essential_device`` in float64, its
        noise from a generator seeded with the frame's index. (The JAX
        package solves in float32; there the card's and the CPU's answers
        to the same samples differed by up to 0.027 in t, in float64 by
        1e-15.)"""
        if len(m_kps0) < 8:
            raise TooFewMatchesError("too few matches for the 8-point "
                                     "solver")
        kpn_ref = self.cam.unproject_points(self.cam.undistort_points(
            m_kps0)).astype(np.float64)
        kpn_cur = self.cam.unproject_points(self.cam.undistort_points(
            m_kps1)).astype(np.float64)
        n = len(kpn_ref)
        slots = max(512, 1 << int(np.ceil(np.log2(n))))
        pad = slots - n
        a = np.concatenate([kpn_ref, np.zeros((pad, 2))])
        b = np.concatenate([kpn_cur, np.zeros((pad, 2))])
        valid = np.arange(slots) < n
        gen = torch.Generator(device=self.device).manual_seed(self._frame_idx)
        self._frame_idx += 1
        with torch.inference_mode():
            R, t, inl = ransac_essential_device(
                torch.from_numpy(a).to(self.device),
                torch.from_numpy(b).to(self.device), gen,
                valid=torch.from_numpy(valid).to(self.device),
                n_hypotheses=self.pose_hypotheses,
                restarts=self.pose_restarts)
        return R.cpu().numpy(), t.cpu().numpy(), inl.cpu().numpy()[:n]

    def draw_feature_tracks(self, img: np.ndarray,
                            all_tracks: bool = False) -> np.ndarray:
        """Overlay prev->cur match tracks (green lines, red endpoint dots)
        on img; inliers only unless all_tracks (reference drawFeatureTracks,
        visual_odometry.py:439-472). Needs cv2."""
        import cv2

        draw = (cv2.cvtColor(img, cv2.COLOR_GRAY2RGB) if img.ndim == 2
                else img.copy())
        n = len(self.m_kps0)
        keep = (np.ones(n, bool) if all_tracks
                else (self.mask_match[:n] if len(self.mask_match) >= n
                      else np.zeros(n, bool)))
        for p_cur, p_ref in zip(self.m_kps1[keep].astype(int),
                                self.m_kps0[keep].astype(int)):
            cv2.line(draw, tuple(p_cur[:2]), tuple(p_ref[:2]),
                     (0, 255, 0), 1)
            cv2.circle(draw, tuple(p_cur[:2]), 1, (0, 0, 255), -1)
        return draw


def load_lightglue_for_vo(lg_ckpt: str, nfeatures: int, frame_size,
                          max_n: int = 1024, threshold: float = 0.0,
                          width_confidence: float = -1.0):
    """The (model, size, max_n) tuple of VisualOdometry's lightglue mode,
    from a ``.npz`` LightGlue checkpoint (its ``__meta__`` names the
    config). frame_size is the original (W, H) of the frames: the matcher
    sees keypoints scaled back to camera coordinates (reference
    visual_odometry.py:119-121), so they are normalised by the full
    frame."""
    from ..matching.configs import LIGHTGLUE_CONFIGS
    from ..matching.lightglue import LightGlue
    from ..utils.checkpoint import load_npz_checkpoint
    from ..utils.convert import load_jax_lightglue

    tree, meta = load_npz_checkpoint(lg_ckpt)
    name = meta.get("config", {}).get("lg_config", "kp2dtiny_S")
    lg_cfg = LIGHTGLUE_CONFIGS.get(name, LIGHTGLUE_CONFIGS["kp2dtiny_S"])
    if lg_cfg.input_dim != nfeatures:
        lg_cfg = dataclasses.replace(lg_cfg, input_dim=nfeatures,
                                     descriptor_dim=nfeatures)
    lg_cfg = dataclasses.replace(lg_cfg, filter_threshold=threshold,
                                 width_confidence=width_confidence)
    model = load_jax_lightglue(LightGlue(lg_cfg), tree["params"]).eval()
    return model, tuple(frame_size), max_n


def prep_frame(frame_bgr, new_size=None, device=None) -> torch.Tensor:
    """A BGR uint8 frame (H, W, 3) (numpy or a tensor) -> RGB float32 in
    [0, 1] at new_size (H, W), on ``device`` (default: the frame's, the
    CPU for numpy). Resizes in float, bilinear with half-pixel centres and
    no antialiasing (cv2.resize's INTER_LINEAR): a uint8 resize would
    quantize the interpolated values, enough to flip ratio-test
    survivors downstream."""
    x = torch.as_tensor(frame_bgr, device=device)
    rgb = x.flip(-1).to(torch.float32) / 255.0
    if new_size is not None and tuple(new_size) != tuple(rgb.shape[:2]):
        rgb = F.interpolate(rgb.permute(2, 0, 1)[None], size=tuple(new_size),
                            mode="bilinear", align_corners=False,
                            antialias=False)[0].permute(1, 2, 0)
    return rgb.contiguous()


class _ScaledFrontend:
    """Scales keypoints from the resized frame back to the camera frame
    (reference visual_odometry.py:119-121)."""

    def __init__(self, frontend, sx: float, sy: float):
        self.frontend = frontend
        self.scale = np.array([sx, sy])

    def run_async(self, img01):
        return self.frontend.run_async(img01)

    def fetch(self, handle):
        pts, feat, out = self.frontend.fetch(handle)
        return pts * self.scale, feat, out

    def run(self, img01):
        return self.fetch(self.run_async(img01))


class _ScaledDense:
    """Scales dense-match coordinates from the resized frame back to the
    camera frame (reference visual_odometry.py:310); numpy out."""

    def __init__(self, dm, sx: float, sy: float):
        self.dm = dm
        self.scale = np.array([sx, sy], np.float32)

    def extract(self, img01):
        return self.dm.extract(img01)

    def match_maps(self, f0, f1):
        kp0, kp1, conf = (t.cpu().numpy() for t in self.dm.match_maps(f0,
                                                                      f1))
        return kp0 * self.scale, kp1 * self.scale, conf


def run_visual_odometry(frontend, frames: Iterable, gt, new_size=None,
                        max_frames: Optional[int] = None,
                        verbose: bool = False, matcher: str = "bf",
                        lightglue=None, dense=None,
                        device_pose: bool = False,
                        dense_rel_conf: float = 0.1,
                        lg_width: float = -1.0, lg_threshold: float = 0.0,
                        pose_hypotheses: int = 8192, pose_restarts: int = 3,
                        device=None) -> Dict:
    """The online VO loop over ``frames`` (an iterable of BGR uint8 frames
    (H, W, 3), numpy or tensors) against ``gt`` (a KittiVideoGroundTruth):
    per-frame relative pose errors. ``lightglue``: the
    (model, size, max_n) tuple or a ``.npz`` path (loaded with
    load_lightglue_for_vo at the frames' size). ``dense``: the dense
    matcher of ``matcher="dense"``; where none is given, a DenseMatcher on
    the frontend's model with k = its top_k, as the JAX CLI builds it.

    A model that computes in bfloat16 gets each resized frame as uint8
    (``ops.image.quantize_u8``), as the JAX VO ships frames to it: the
    2/255 step equals the input cast's ulp there. Frames are resized in
    float either way.

    The loop is pipelined: frame t+1's extraction is enqueued before frame
    t's matching and pose run, so that the device extracts while the host
    solves; the results are those of the sequential loop."""
    dev = resolve_device(device)
    it = iter(frames)
    frame = next(it, None)
    if frame is None:
        raise ValueError("no frames")
    size = tuple(frame.shape)
    fx, fy, cx, cy = kitti_params()
    cam = PinholeCamera(size[1], size[0], fx, fy, cx, cy)

    transfer_u8 = frontend.cfg.dtype == "bfloat16"

    def prep(f):
        img01 = prep_frame(f, new_size, dev)
        return quantize_u8(img01) if transfer_u8 else img01

    sx = size[1] / (new_size[1] if new_size else size[1])
    sy = size[0] / (new_size[0] if new_size else size[0])
    if isinstance(lightglue, str):
        # pad slots cover the frontend's keypoint budget
        max_n = max(int(getattr(frontend, "top_k", 0) or 0), 1024)
        lightglue = load_lightglue_for_vo(
            lightglue, frontend.cfg.nfeatures, (size[1], size[0]),
            max_n=max_n, threshold=lg_threshold, width_confidence=lg_width)
    if matcher == "dense" and dense is None:
        from ..matching.dense import DenseMatcher

        dense = DenseMatcher(frontend.model, frontend.cfg,
                             new_size or size[:2], k=frontend.top_k,
                             device=dev)
    vo = VisualOdometry(_ScaledFrontend(frontend, sx, sy), cam,
                        matcher=matcher, lightglue=lightglue,
                        dense=None if dense is None
                        else _ScaledDense(dense, sx, sy),
                        dense_rel_conf=dense_rel_conf,
                        device_pose=device_pose,
                        pose_hypotheses=pose_hypotheses,
                        pose_restarts=pose_restarts, device=dev)
    vo.init(prep(frame))

    i_frame = 1
    t_errs, r_errs = [], []
    pending = None  # (img, extraction handle)
    while True:
        frame = next(it, None)
        frame_idx = i_frame + (1 if pending is not None else 0)
        more = frame is not None and (max_frames is None
                                      or frame_idx < max_frames)
        if more:
            img = prep(frame)
            handle = vo.begin_extract(img)
        if pending is not None:
            p_img, p_handle = pending
            R, t, _ = vo.process_image(p_img, prefetched=p_handle)
            t_err, r_err = calculate_relative_error(gt, i_frame, R, t)
            t_errs.append(t_err)
            r_errs.append(r_err)
            i_frame += 1
        if not more:
            break
        pending = (img, handle)

    errs = assemble_vo_error_stats(t_errs, r_errs)
    if verbose:
        return {**errs,
                "estimation_fails": vo.estimation_fails,
                "stats": vo.stats.as_dict(),
                "trajectory": [t.reshape(3).tolist()
                               for t in vo.trajectory]}
    return errs["total"]


def read_video(path: str):
    """The BGR uint8 frames of a video file, through cv2."""
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise RuntimeError(f"cannot read {path}")
    try:
        while True:
            ret, frame = cap.read()
            if not ret:
                return
            yield frame
    finally:
        cap.release()


def evaluate_visual_odometry(frontend, kitti_path: str, gt_name: str,
                             video_name: str, new_size=None,
                             max_frames: Optional[int] = None,
                             verbose: bool = False, **kw) -> Dict:
    """KITTI video VO eval (evaluation/visual_odometry.py:200-332):
    ``run_visual_odometry`` over the frames of ``kitti_path/video_name``
    (read with cv2) against the poses in ``kitti_path/gt_name``."""
    return run_visual_odometry(
        frontend, read_video(f"{kitti_path}/{video_name}"),
        KittiVideoGroundTruth(kitti_path, gt_name), new_size=new_size,
        max_frames=max_frames, verbose=verbose, **kw)
