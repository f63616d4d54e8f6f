"""Pose estimation and error metrics for VO, the counterpart of
``nanovs_slam_tpu/vo/pose.py``.

- ``estimate_pose`` (reference evaluation/visual_odometry.py:139-162), the
  host tail: undistort -> unproject -> cv2.findEssentialMat (USAC_MSAC,
  prob .999, threshold 3e-4, focal 1, pp (0, 0)) -> cv2.recoverPose. cv2 is
  imported where it runs.
- ``ransac_essential_device``: the same robust estimate on a torch device
  (the RANSAC of batched 8-point hypotheses, MSAC scoring, LO rounds, a
  Gauss-Newton polish on the essential manifold and a cheirality vote).
- ``estimate_pose_device``: the 8-point pose without RANSAC.
- The error metrics (src/visual_odometry/utils.py:5-19,
  evaluation/visual_odometry.py:165-176, :318-332), in numpy without cv2.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..ops.smallmat import cholesky_solve, nullvec, svd3

Tensor = torch.Tensor


def estimate_pose(kps_ref: np.ndarray, kps_cur: np.ndarray, cam):
    import cv2

    kp_ref_u = cam.undistort_points(kps_ref)
    kp_cur_u = cam.undistort_points(kps_cur)
    kpn_ref = cam.unproject_points(kp_ref_u)
    kpn_cur = cam.unproject_points(kp_cur_u)
    method = getattr(cv2, "USAC_MSAC", cv2.RANSAC)
    E, mask_match = cv2.findEssentialMat(
        kpn_cur, kpn_ref, focal=1, pp=(0.0, 0.0), method=method,
        prob=0.999, threshold=0.0003)
    _, R, t, mask = cv2.recoverPose(E, kpn_cur, kpn_ref, focal=1,
                                    pp=(0.0, 0.0))
    return R, t, mask_match, mask


def rotation_angle(R: np.ndarray) -> float:
    """||rotvec(R)||, the norm of ``cv2.Rodrigues(R)``, without cv2: R is
    first taken to the nearest rotation (U V^T of its SVD), and the angle
    is atan2 of half the skew part's norm against (trace - 1) / 2, which
    stays accurate near 0 and near pi (cv2's acos loses digits within 1e-6
    of pi). As in cv2, a rotation whose sine is below 1e-5 near 0 reads as
    the angle 0."""
    U, _, Vt = np.linalg.svd(np.asarray(R, np.float64))
    Q = U @ Vt
    s = 0.5 * np.linalg.norm([Q[2, 1] - Q[1, 2], Q[0, 2] - Q[2, 0],
                              Q[1, 0] - Q[0, 1]])
    c = 0.5 * (np.trace(Q) - 1.0)
    if s < 1e-5 and c > 0:
        return 0.0
    return float(math.atan2(s, c))


def calculate_pose_error(R_gt: np.ndarray, t_gt: np.ndarray,
                         R_est: np.ndarray, t_est: np.ndarray
                         ) -> Tuple[float, float]:
    """(translation error: L2 difference, rotation error: the angle of
    R_est R_gt^T)."""
    t_error = float(np.sqrt(((t_est - t_gt) ** 2).sum()))
    return t_error, rotation_angle(R_est.dot(R_gt.T))


def calculate_relative_error(gt, i_frame: int, R: np.ndarray, t: np.ndarray
                             ) -> Tuple[float, float]:
    _, _, _, absolute_scale = gt.get_pose_and_absolute_scale(i_frame - 1)
    t_last, rot_last = gt.extract_pose_values(i_frame - 1)
    est_t = t_last + absolute_scale * rot_last.dot(t).T
    est_R = rot_last.dot(R)
    t_curr, R_curr = gt.extract_pose_values(i_frame)
    return calculate_pose_error(R_curr, t_curr, est_R, est_t[0]
                                if est_t.ndim > 1 else est_t)


def calculate_error_stats(errors: np.ndarray) -> Dict[str, float]:
    return {"mean": float(errors.mean()), "sum": float(errors.sum()),
            "std": float(errors.std()), "max": float(errors.max()),
            "min": float(errors.min())}


def assemble_vo_error_stats(t_errs, r_errs) -> Dict:
    """Per-pair error lists -> the reference's stats layout
    (evaluation/visual_odometry.py:318-332): the first pair is dropped
    (the reference's loop warm-up) and translation / rotation / total each
    get mean / sum / std / max / min."""
    t = np.asarray(t_errs[1:], float)
    r = np.asarray(r_errs[1:], float)
    return {"translation": calculate_error_stats(t),
            "rotation": calculate_error_stats(r),
            "total": calculate_error_stats(t + r)}


# ------------------------------------------------------- the device RANSAC

def gumbel_noise(shape, generator: torch.Generator) -> Tensor:
    """Standard Gumbel noise of ``shape`` on the generator's device,
    float32: -log(-log(u)) with u uniform in [tiny, 1), as
    ``jax.random.gumbel`` draws it. Every random number of
    ``ransac_essential_device`` comes from here."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def _skew(t: Tensor) -> Tensor:
    z = torch.zeros_like(t[..., 0])
    return torch.stack([torch.stack([z, -t[..., 2], t[..., 1]], -1),
                        torch.stack([t[..., 2], z, -t[..., 0]], -1),
                        torch.stack([-t[..., 1], t[..., 0], z], -1)], -2)


def _exp_so3(w: Tensor) -> Tensor:
    th = torch.sqrt((w * w).sum(-1) + 1e-24)[..., None, None]
    K = _skew(w) / th
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + torch.sin(th) * K + (1.0 - torch.cos(th)) * (K @ K)


def _det3(M: Tensor) -> Tensor:
    return (M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2]
                            - M[..., 1, 2] * M[..., 2, 1])
            - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2]
                              - M[..., 1, 2] * M[..., 2, 0])
            + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1]
                              - M[..., 1, 1] * M[..., 2, 0]))


def _normalize_t(t: Tensor) -> Tensor:
    return t / torch.clamp(torch.linalg.vector_norm(t, dim=-1, keepdim=True),
                           min=1e-12)


def _tangent_basis(t: Tensor):
    ex = torch.tensor((1.0, 0.0, 0.0), dtype=t.dtype,
                      device=t.device).expand(t.shape)
    ey = torch.tensor((0.0, 1.0, 0.0), dtype=t.dtype,
                      device=t.device).expand(t.shape)
    a = torch.where(torch.abs(t[..., :1]) < 0.9, ex, ey)
    b1 = _normalize_t(torch.linalg.cross(t, a))
    return b1, torch.linalg.cross(t, b1)


def _apply(M: Tensor, h: Tensor) -> Tensor:
    """M (R, ..., 3, 3) times every row of h (R, N, 3), row r of M with
    row r of h -> (R, ..., N, 3)."""
    R = h.shape[0]
    out = torch.einsum("rmij,rnj->rmni", M.reshape(R, -1, 3, 3), h)
    return out.reshape(M.shape[:-2] + h.shape[1:])


def _like(x: Tensor, y: Tensor) -> Tensor:
    """x (R, *t) viewed as (R, 1, ..., 1, *t) to broadcast against y
    (R, ..., *t)."""
    return x.reshape(x.shape[:1] + (1,) * (y.dim() - x.dim()) + x.shape[1:])


def _epipolar(E: Tensor, h0: Tensor, h1: Tensor):
    """E (R, ..., 3, 3), h0 / h1 (R, N, 3) -> (E h0, E^T h1) each
    (R, ..., N, 3)."""
    return _apply(E, h0), _apply(E.transpose(-1, -2), h1)


def _sampson(E: Tensor, h0: Tensor, h1: Tensor) -> Tensor:
    """Squared Sampson distances (R, ..., N) of every correspondence of
    row r under every E of row r (R, ..., 3, 3)."""
    Ex0, Etx1 = _epipolar(E, h0, h1)
    num = torch.square((_like(h1, Ex0) * Ex0).sum(-1))
    den = (torch.square(Ex0[..., 0]) + torch.square(Ex0[..., 1])
           + torch.square(Etx1[..., 0]) + torch.square(Etx1[..., 1]))
    return num / torch.clamp(den, min=1e-12)


def _take(x: Tensor, idx: Tensor) -> Tensor:
    """x (S, n, ...) at idx (S, k) along dim 1 -> (S, k, ...)."""
    s = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[s, idx]


def _smallest(scores: Tensor, k: int) -> Tensor:
    """Indices (S, k) of the k smallest of (S, n), ties to the lower
    index (``lax.top_k`` of the negated scores)."""
    return torch.sort(scores, dim=-1, stable=True)[1][..., :k]


def _msac(d2: Tensor, v: Tensor, t2: float) -> Tensor:
    """MSAC scores (R, ...) of squared distances (R, ..., N) over the
    valid points v (R, N)."""
    return torch.where(_like(v, d2), torch.clamp(d2, max=t2), 0.0).sum(-1)


_W = ((0.0, -1.0, 0.0), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0))


def _decompose_vote(E: Tensor, wf: Tensor, h0: Tensor, h1: Tensor):
    """E (R, ..., 3, 3) -> the (R (R, ..., 3, 3), t (R, ..., 3)) of its
    4-way decomposition with the most points of weight ``wf`` (R, ..., N)
    (h0 / h1 (R, N, 3)) in front
    of both cameras (a midpoint-depth test; near-parallel rays do not
    vote, as in cv2.recoverPose). svd3's v2 sign at most swaps the roles
    of Ra and Rb inside the candidate set."""
    U, _, V = svd3(E)
    Vt = V.transpose(-1, -2)
    W = torch.tensor(_W, dtype=E.dtype, device=E.device)
    d = torch.sign(_det3(U @ Vt))[..., None, None]
    Ra, Rb, tu = U @ W @ Vt * d, U @ W.T @ Vt * d, U[..., :, 2]
    Rs = torch.stack([Ra, Ra, Rb, Rb], -3)
    ts = torch.stack([tu, -tu, tu, -tu], -2)
    a = _apply(Rs, h0)
    b = _like(h1, a)
    M00 = (a * a).sum(-1)
    M01 = -(a * b).sum(-1)
    M11 = (b * b).sum(-1)
    r0 = -(a * ts[..., None, :]).sum(-1)
    r1 = (b * ts[..., None, :]).sum(-1)
    det = M00 * M11 - M01 * M01
    ok = torch.abs(det) >= 1e-12
    safe = torch.where(ok, det, 1.0)
    z0 = (M11 * r0 - M01 * r1) / safe
    z1 = (M00 * r1 - M01 * r0) / safe
    votes = (((z0 > 0) & (z1 > 0) & ok).to(E.dtype)
             * wf[..., None, :]).sum(-1)
    k = torch.argmax(votes, dim=-1)
    kk = k[..., None, None, None].expand(k.shape + (1, 3, 3))
    return (torch.gather(Rs, -3, kk)[..., 0, :, :],
            torch.gather(ts, -2, kk[..., 0])[..., 0, :])


def _gn_step(R: Tensor, t: Tensor, wres: Tensor, h0: Tensor, h1: Tensor):
    """One Gauss-Newton step of (R, t) over so(3) x the tangent of S^2 on
    the weighted Sampson residual: the residual's derivatives along the 5
    directions of E = skew(t) R are written out (the JAX package takes
    them with jacfwd)."""
    b1, b2 = _tangent_basis(t)
    nt = torch.clamp(torch.linalg.vector_norm(t, dim=-1, keepdim=True),
                     min=1e-12)
    tn = t / nt
    E = _skew(tn) @ R
    Ex0, Etx1 = _epipolar(E, h0, h1)
    num = (_like(h1, Ex0) * Ex0).sum(-1)
    den_raw = (torch.square(Ex0[..., 0]) + torch.square(Ex0[..., 1])
               + torch.square(Etx1[..., 0]) + torch.square(Etx1[..., 1]))
    den = torch.clamp(den_raw, min=1e-12)
    sq = torch.sqrt(den)
    r = num / sq * wres
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    dts = [(b - tn * (tn * b).sum(-1, keepdim=True)) / nt for b in (b1, b2)]
    dE = torch.stack([_skew(tn) @ _skew(eye[k]) @ R for k in range(3)]
                     + [_skew(d) @ R for d in dts], -3)  # (..., 5, 3, 3)
    dEx0, dEtx1 = _epipolar(dE, h0, h1)  # (..., 5, N, 3)
    dnum = (_like(h1, dEx0) * dEx0).sum(-1)
    dden = 2.0 * (Ex0[..., None, :, 0] * dEx0[..., 0]
                  + Ex0[..., None, :, 1] * dEx0[..., 1]
                  + Etx1[..., None, :, 0] * dEtx1[..., 0]
                  + Etx1[..., None, :, 1] * dEtx1[..., 1])
    dden = torch.where((den_raw > 1e-12)[..., None, :], dden, 0.0)
    J = (wres[..., None, :] * (dnum / sq[..., None, :] - 0.5 * num[
        ..., None, :] * dden / (den * sq)[..., None, :])
         ).transpose(-1, -2)  # (..., N, 5)
    Jt = J.transpose(-1, -2)
    Hm = Jt @ J + 1e-12 * torch.eye(5, dtype=R.dtype, device=R.device)
    p = cholesky_solve(Hm, -(Jt @ r[..., None])[..., 0])
    Rn = _exp_so3(p[..., :3]) @ R
    return Rn, _normalize_t(t + b1 * p[..., 3:4] + b2 * p[..., 4:5])


def _polish(E_c: Tensor, s_c: Tensor, h0: Tensor, h1: Tensor, v: Tensor,
            t2: float):
    """Pool candidates E_c (R, k, 3, 3) with MSAC scores s_c -> the best
    of {unpolished, 5 GN steps on the binary inlier mask, then 5 IRLS
    steps with Cauchy weights over all valid points v (R, N)} of each, by
    MSAC: (R (R, k, 3, 3), t (R, k, 3), score (R, k))."""
    vf = v[:, None].to(E_c.dtype)
    wres = ((_sampson(E_c, h0, h1) < t2) & v[:, None]).to(E_c.dtype)
    R0, t0 = _decompose_vote(E_c, wres, h0, h1)
    R_gn, t_gn = R0, t0
    for _ in range(5):
        R_gn, t_gn = _gn_step(R_gn, t_gn, wres, h0, h1)
    R_ir, t_ir = R_gn, t_gn
    for _ in range(5):
        w_soft = vf / (1.0 + _sampson(_skew(t_ir) @ R_ir, h0, h1) / t2)
        R_ir, t_ir = _gn_step(R_ir, t_ir, w_soft, h0, h1)

    def score_or_inf(R, t):
        s = _msac(_sampson(_skew(t) @ R, h0, h1), v, t2)
        ok = (torch.isfinite(R).all(-1).all(-1) & torch.isfinite(t).all(-1)
              & torch.isfinite(s))
        return torch.where(ok, s, torch.inf)

    cand_R = torch.stack([R0, R_gn, R_ir], -3)
    cand_t = torch.stack([t0, t_gn, t_ir], -2)
    cand_s = torch.stack([s_c, score_or_inf(R_gn, t_gn),
                          score_or_inf(R_ir, t_ir)], -1)
    j = torch.argmin(cand_s, dim=-1)
    jj = j[..., None, None, None].expand(j.shape + (1, 3, 3))
    return (torch.gather(cand_R, -3, jj)[..., 0, :, :],
            torch.gather(cand_t, -2, jj[..., 0])[..., 0, :],
            torch.gather(cand_s, -1, j[..., None])[..., 0])


def ransac_essential_device(kpn_ref, kpn_cur, generator,
                            valid: Optional[Tensor] = None,
                            n_hypotheses: int = 8192,
                            threshold: float = 3e-4, lo_rounds: int = 2,
                            pool: int = 4, restarts: int = 3):
    """The robust essential-matrix pose on a torch device: the counterpart
    of the host tail ``cv2.findEssentialMat(USAC_MSAC, threshold 3e-4) +
    cv2.recoverPose`` (``estimate_pose``), and of the JAX package's
    ``ransac_essential_device``. No loop over hypotheses runs on the host:

    - ``n_hypotheses`` 8-point minimal samples (gumbel top-k, so no
      rejection loop), all null spaces in one batched Cholesky inverse
      iteration (``ops/smallmat.nullvec``), projected onto the essential
      manifold with the closed-form ``svd3``;
    - MSAC over the (hypotheses, points) Sampson tensor;
    - ``lo_rounds`` LO rounds: fresh minimal samples inside the winner's
      inliers and an inlier-weighted refit, each accept-if-better; the
      ``pool`` best hypotheses of every round are kept;
    - every pool candidate is decomposed (cheirality vote of the inliers)
      and polished by Gauss-Newton over (R, t) on the masked Sampson
      residual, then by IRLS with Cauchy weights; the best MSAC wins;
    - ``restarts`` independent streams run side by side on a leading
      axis, and the one with the largest final consensus wins (ties to
      the lowest stream).

    The arithmetic follows the inputs' dtype, as in the JAX package. In
    float32 the Sampson residual of an inlier (~1e-4, from terms ~1) keeps
    about three digits, so the card and the CPU can pick different
    winners from the same samples; in float64 they agree to 1e-15
    (``VisualOdometry`` passes float64).

    kpn_ref / kpn_cur: (N, 2) normalised image-plane correspondences (a
    tensor on the device, or numpy), the operand order of
    ``estimate_pose``; ``valid``: optional (N,) bool mask of padded slots;
    ``generator``: a ``torch.Generator`` on the device, from which
    ``gumbel_noise`` draws (restarts, n_hypotheses, N) a stage. Returns
    (R (3, 3), t (3, 1) unit, inlier mask (N,) bool), the cv2 convention.

    Batched over P pairs: kpn_ref / kpn_cur (P, N, 2), ``valid`` (P, N)
    and ``generator`` a sequence of P generators, one a pair. The pairs
    fold into the restarts' axis (P * restarts rows), so that one set of
    launches serves them all; each stage draws every pair's noise from
    that pair's generator in pair order, so that a pair's stream is the
    one the unbatched call draws. Returns R (P, 3, 3), t (P, 3, 1) and
    the inlier masks (P, N).
    """
    if torch.as_tensor(kpn_ref).dim() == 2:
        R, t, inl = ransac_essential_device(
            torch.as_tensor(kpn_ref)[None], torch.as_tensor(kpn_cur)[None],
            [generator], None if valid is None
            else torch.as_tensor(valid)[None], n_hypotheses, threshold,
            lo_rounds, pool, restarts)
        return R[0], t[0], inl[0]
    gens = list(generator)
    dev = gens[0].device
    pts0 = torch.as_tensor(kpn_cur, device=dev)  # cv2 operand order
    pts1 = torch.as_tensor(kpn_ref, device=dev)
    dt = pts0.dtype
    P, N = pts0.shape[:2]
    S = max(1, restarts)
    if len(gens) != P:
        raise ValueError(f"{P} pairs need {P} generators, got {len(gens)}")
    v = (torch.ones((P, N), dtype=torch.bool, device=dev) if valid is None
         else torch.as_tensor(valid, device=dev).to(torch.bool))
    vf = v.to(dt)
    n_valid = torch.clamp(vf.sum(1), min=1.0)

    # Hartley normalisation over each pair's valid points
    def normalize(p):
        mean = (p * vf[..., None]).sum(1) / n_valid[:, None]
        d = torch.sqrt(((p - mean[:, None]) ** 2).sum(-1))
        scale = math.sqrt(2.0) / torch.clamp((d * vf).sum(1) / n_valid,
                                             min=1e-9)
        T = torch.zeros((P, 3, 3), dtype=dt, device=dev)
        T[:, 0, 0] = T[:, 1, 1] = scale
        T[:, 0, 2] = -scale * mean[:, 0]
        T[:, 1, 2] = -scale * mean[:, 1]
        T[:, 2, 2] = 1.0
        return (p - mean[:, None]) * scale[:, None, None], T

    p0, T0 = normalize(pts0)
    p1, T1 = normalize(pts1)
    x0, y0 = p0[..., 0], p0[..., 1]
    x1, y1 = p1[..., 0], p1[..., 1]
    A = torch.stack([x1 * x0, x1 * y0, x1, y1 * x0, y1 * y0, y1, x0, y0,
                     torch.ones_like(x0)], dim=-1)  # (P, N, 9)
    ones = torch.ones((P, N, 1), dtype=dt, device=dev)

    def rows_of(x):  # (P, ...) -> (P * S, ...), row p * S + s
        return x.repeat_interleave(S, 0)

    A, v, T0, T1 = rows_of(A), rows_of(v), rows_of(T0), rows_of(T1)
    h0 = rows_of(torch.cat([pts0, ones], -1))
    h1 = rows_of(torch.cat([pts1, ones], -1))
    t2 = threshold * threshold
    rows = torch.arange(P * S, device=dev)

    def sampson(E):
        return _sampson(E, h0, h1)

    def essential_project(E):
        U, s, V = svd3(E)
        sbar = 0.5 * (s[..., 0] + s[..., 1])
        return sbar[..., None, None] * (
            U[..., :, 0:1] @ V[..., :, 0:1].transpose(-1, -2)
            + U[..., :, 1:2] @ V[..., :, 1:2].transpose(-1, -2))

    def denormalize(E):
        return _like(T1.transpose(-1, -2), E) @ E @ _like(T0, E)

    def hypotheses(support):
        """(P * S, n, 3, 3) essential candidates from minimal samples
        drawn inside ``support`` (P * S, N)."""
        g = torch.stack([gumbel_noise((S, n_hypotheses, N), gen)
                         for gen in gens]).to(dt)
        g = torch.where(support[:, None, :],
                        g.reshape(P * S, n_hypotheses, N), -torch.inf)
        idx = torch.topk(g, 8, dim=-1).indices  # (P * S, n, 8)
        E = nullvec(A[rows[:, None, None], idx]).reshape(
            P * S, n_hypotheses, 3, 3)
        return essential_project(denormalize(E))

    K = max(1, pool)
    E_h = hypotheses(v)
    d2 = sampson(E_h)  # (P * S, n, N)
    sc = _msac(d2, v, t2)
    best = torch.argmin(sc, dim=-1)
    E, score = E_h[rows, best], sc[rows, best]
    inl = (d2[rows, best] < t2) & v
    pidx = _smallest(sc, K)
    E_pool, s_pool = _take(E_h, pidx), _take(sc, pidx)
    del d2
    for _ in range(lo_rounds):
        E2_h = hypotheses(inl)
        sc2 = _msac(sampson(E2_h), v, t2)
        b2 = torch.argmin(sc2, dim=-1)
        take = sc2[rows, b2] < score
        E = torch.where(take[:, None, None], E2_h[rows, b2], E)
        score = torch.minimum(sc2[rows, b2], score)
        inl = (sampson(E) < t2) & v
        # the inlier-weighted DLT refit, also accept-if-better
        E_r = essential_project(denormalize(
            nullvec(A * inl.to(dt)[..., None]).reshape(P * S, 3, 3)))
        s_r = _msac(sampson(E_r), v, t2)
        E = torch.where((s_r < score)[:, None, None], E_r, E)
        score = torch.minimum(s_r, score)
        inl = (sampson(E) < t2) & v
        p2 = _smallest(sc2, K)
        E_pool = torch.cat([E_pool, _take(E2_h, p2), E_r[:, None]], 1)
        s_pool = torch.cat([s_pool, _take(sc2, p2), s_r[:, None]], 1)
        keep = _smallest(s_pool, K)
        E_pool, s_pool = _take(E_pool, keep), _take(s_pool, keep)

    R_cs, t_cs, s_cs = _polish(E_pool, s_pool, h0, h1, v, t2)
    kb = torch.argmin(s_cs, dim=-1)
    R_fin, t_fin = R_cs[rows, kb], t_cs[rows, kb]
    # Sampson is scale-invariant: skew(t) R is the winner's E
    inl_fin = (sampson(_skew(t_fin) @ R_fin) < t2) & v
    j = torch.argmax(inl_fin.sum(-1).reshape(P, S), dim=-1) \
        + torch.arange(P, device=dev) * S
    return R_fin[j], t_fin[j][..., None], inl_fin[j]


def estimate_pose_device(kpn_ref, kpn_cur, device=None):
    """The 8-point essential-matrix pose without RANSAC on a torch device
    (the counterpart of the JAX ``estimate_pose_device``): Hartley
    normalisation, the DLT null vector, projection onto the essential
    manifold, the 4-way decomposition and a midpoint-depth cheirality
    vote. kpn_ref / kpn_cur: (N, 2) normalised correspondences, the
    operand order of ``estimate_pose``; ``device`` defaults to theirs.
    Returns (R (3, 3), t (3, 1) unit, n_positive_depth)."""
    pts0 = torch.as_tensor(kpn_cur, dtype=torch.float32, device=device)
    pts1 = torch.as_tensor(kpn_ref, dtype=torch.float32, device=pts0.device)
    dev = pts0.device

    def normalize(p):
        mean = p.mean(0)
        scale = math.sqrt(2.0) / torch.clamp(
            torch.sqrt(((p - mean) ** 2).sum(-1)).mean(), min=1e-9)
        T = torch.eye(3, device=dev)
        T[0, 0] = T[1, 1] = scale
        T[0, 2] = -scale * mean[0]
        T[1, 2] = -scale * mean[1]
        return (p - mean) * scale, T

    p0, T0 = normalize(pts0)
    p1, T1 = normalize(pts1)
    x0, y0 = p0[:, 0], p0[:, 1]
    x1, y1 = p1[:, 0], p1[:, 1]
    # epipolar constraint x1^T E x0 = 0 rows
    A = torch.stack([x1 * x0, x1 * y0, x1, y1 * x0, y1 * y0, y1, x0, y0,
                     torch.ones_like(x0)], dim=1)
    vt = torch.linalg.svd(A, full_matrices=True)[2]
    E = T1.T @ vt[-1].reshape(3, 3) @ T0
    # onto the essential manifold (equal singular values, rank 2)
    u, s, vt = torch.linalg.svd(E)
    sbar = (s[0] + s[1]) / 2.0
    E = u @ torch.diag(torch.tensor([1.0, 1.0, 0.0], device=dev) * sbar) \
        @ vt
    # 4-way decomposition (Hartley & Zisserman 9.19)
    u, _, vt = torch.linalg.svd(E)
    d = torch.sign(torch.linalg.det(u @ vt))
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     device=dev)
    Ra, Rb, tu = u @ W @ vt * d, u @ W.T @ vt * d, u[:, 2:3]
    h0 = torch.cat([pts0, torch.ones_like(x0[:, None])], -1)
    h1 = torch.cat([pts1, torch.ones_like(x1[:, None])], -1)

    def depth_votes(R, t):
        a = (R @ h0.T).T
        b = h1
        M00 = (a * a).sum(-1)
        M01 = -(a * b).sum(-1)
        M11 = (b * b).sum(-1)
        r0 = -(a * t.T).sum(-1)
        r1 = (b * t.T).sum(-1)
        det = M00 * M11 - M01 * M01
        ok = torch.abs(det) >= 1e-12  # degenerate rays do not vote
        safe = torch.where(ok, det, 1.0)
        z0 = (M11 * r0 - M01 * r1) / safe
        z1 = (M00 * r1 - M01 * r0) / safe
        return ((z0 > 0) & (z1 > 0) & ok).sum()

    cands = [(Ra, tu), (Ra, -tu), (Rb, tu), (Rb, -tu)]
    votes = torch.stack([depth_votes(R, t) for R, t in cands])
    best = int(torch.argmax(votes))
    return cands[best][0], cands[best][1], votes[best]
