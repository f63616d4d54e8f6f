"""Robust homography estimation without cv2: the port's counterpart of
``cv2.findHomography(src, dst, cv2.RANSAC, 3, maxIters=5000)``, which the
JAX package's ``evaluation/descriptor.py`` calls (the card's machine has
no cv2).

cv2's recipe, step by step:
- RANSAC over 4-point samples. A sample is refused when three of its
  points are collinear in either image (cv2's ``haveCollinearPoints``
  test) or when its four triangles do not all keep or all flip their
  orientation from one image to the other (cv2's ``checkSubset``).
- Each sample is solved exactly (the homography the DLT finds for 4
  points, here in closed form). Its inliers are the
  points whose forward transfer error |H(src) - dst|^2 is at most
  thresh^2.
- A model replaces the best one when it has more inliers. The iteration
  count then falls to cv2's ``RANSACUpdateNumIters`` bound for the
  confidence (0.995), capped at ``max_iters``.
- The best model is refitted on its inliers (normalised DLT), then
  refined by Levenberg-Marquardt on the forward transfer error of those
  inliers (``scipy.optimize.least_squares(method="lm")``). The inliers
  returned are the refined model's.

cv2 5.0 differs from that recipe in two ways that show: the inliers it
returns are its final model's, and that model is not always the
least-squares one on them (a higher forward transfer error in 12 of 20
seeded cases, by up to 0.1 px at the corners; the tests state it). Here
the refit is repeated on the refitted model's inliers until they stop
changing (at most 10 rounds) before the refinement, so that a RANSAC
winner with too few inliers does not cut the set cv2 finds.

The random draws are not cv2's (so where several inlier sets are about
as good, the one found may differ): a generator seeded anew on every
call, so that the result does not depend on the order of calls. The
samples are drawn, solved and scored in chunks; they are taken in their
order until the adaptive count ends the loop, as one at a time would.
The points stay in float64 (cv2 rounds them to float32 first; the
evaluation's points are float32 values already).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

_FLT_EPSILON = float(np.finfo(np.float32).eps)
# the triangles of a sample whose orientations must agree (cv2's order)
_TRIANGLES = np.array([[0, 1, 2], [1, 2, 3], [0, 2, 3], [0, 1, 3]])
_CHUNK = 256


def _normaliser(pts: np.ndarray) -> np.ndarray:
    """(..., n, 2) -> (..., 3, 3): cv2's DLT normalisation, the centroid
    to the origin and each axis scaled by n over its summed absolute
    deviation."""
    c = pts.mean(-2)
    dev = np.abs(pts - c[..., None, :]).sum(-2)
    eps = np.finfo(np.float64).eps
    s = np.where(dev > eps, pts.shape[-2] / np.maximum(dev, eps), 1.0)
    T = np.zeros(pts.shape[:-2] + (3, 3))
    T[..., 0, 0], T[..., 1, 1], T[..., 2, 2] = s[..., 0], s[..., 1], 1.0
    T[..., 0, 2], T[..., 1, 2] = -c[..., 0] * s[..., 0], -c[..., 1] * s[..., 1]
    return T


def dlt(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Normalised DLT: (..., n, 2) x 2 -> (..., 3, 3) homographies with
    H[2, 2] = 1 (NaN where H[2, 2] is 0), by the right singular vector of
    the smallest singular value."""
    Ts, Td = _normaliser(src), _normaliser(dst)
    ps = src @ np.swapaxes(Ts[..., :2, :2], -1, -2) + Ts[..., None, :2, 2]
    pd = dst @ np.swapaxes(Td[..., :2, :2], -1, -2) + Td[..., None, :2, 2]
    x, y = ps[..., 0], ps[..., 1]
    u, v = pd[..., 0], pd[..., 1]
    one, zero = np.ones_like(x), np.zeros_like(x)
    rx = np.stack([x, y, one, zero, zero, zero, -u * x, -u * y, -u], -1)
    ry = np.stack([zero, zero, zero, x, y, one, -v * x, -v * y, -v], -1)
    A = np.concatenate([rx, ry], -2)
    h = np.linalg.svd(A)[2][..., -1, :]
    Hn = h.reshape(h.shape[:-1] + (3, 3))
    H = np.linalg.inv(Td) @ Hn @ Ts
    with np.errstate(divide="ignore", invalid="ignore"):
        return H / H[..., 2:3, 2:3]


def _adjugate(M: np.ndarray) -> np.ndarray:
    """(..., 3, 3) -> adjugates (the inverse times the determinant)."""
    c = lambda i, j: (M[..., (i + 1) % 3, (j + 1) % 3]  # noqa: E731
                      * M[..., (i + 2) % 3, (j + 2) % 3]
                      - M[..., (i + 1) % 3, (j + 2) % 3]
                      * M[..., (i + 2) % 3, (j + 1) % 3])
    return np.stack([np.stack([c(j, i) for j in range(3)], -1)
                     for i in range(3)], -2)


def four_point(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """(m, 4, 2) x 2 -> (m, 3, 3): the homographies of 4-point samples
    (the one that maps each sample exactly, which the DLT finds), in
    closed form: each side's projective basis A = [p1 p2 p3] diag(l) with
    [p1 p2 p3] l = p4, and H = B A^-1; H[2, 2] = 1 (NaN where it is 0)."""
    def basis(p):
        ph = np.concatenate([p, np.ones(p.shape[:-1] + (1,))], -1)
        M = np.swapaxes(ph[:, :3], -1, -2)  # columns p1, p2, p3
        lam = (_adjugate(M) @ ph[:, 3, :, None])[..., 0]
        return M * lam[:, None, :]

    H = basis(dst) @ _adjugate(basis(src))
    with np.errstate(divide="ignore", invalid="ignore"):
        return H / H[..., 2:3, 2:3]


def transfer_error(H: np.ndarray, src: np.ndarray, dst: np.ndarray
                   ) -> np.ndarray:
    """(..., 3, 3), (n, 2), (n, 2) -> (..., n) squared forward transfer
    errors |H(src) - dst|^2."""
    p = src @ np.swapaxes(H[..., :2, :2], -1, -2) + H[..., None, :2, 2]
    w = src @ H[..., 2, :2, None] + H[..., 2, 2, None, None]
    with np.errstate(divide="ignore", invalid="ignore"):
        d = p / w - dst
    return np.sum(d * d, -1)


def _collinear(pts: np.ndarray) -> np.ndarray:
    """(m, 4, 2) -> (m,): three of a sample's points on a line (cv2's
    test: each point against the pairs before it)."""
    bad = np.zeros(pts.shape[0], bool)
    for i in range(2, 4):
        for j in range(i):
            d1 = pts[:, j] - pts[:, i]
            for k in range(j):
                d2 = pts[:, k] - pts[:, i]
                cross = d2[:, 0] * d1[:, 1] - d2[:, 1] * d1[:, 0]
                scale = (np.abs(d1).sum(-1) + np.abs(d2).sum(-1))
                bad |= np.abs(cross) <= _FLT_EPSILON * scale
    return bad


def _orientation(pts: np.ndarray) -> np.ndarray:
    """(m, 4, 2) -> (m, 4): the sign of each triangle's determinant."""
    t = pts[:, _TRIANGLES]  # (m, 4, 3, 2)
    a, b, c = t[:, :, 0], t[:, :, 1], t[:, :, 2]
    return ((b[..., 0] - a[..., 0]) * (c[..., 1] - a[..., 1])
            - (b[..., 1] - a[..., 1]) * (c[..., 0] - a[..., 0]))


def good_samples(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """(m, 4, 2) x 2 -> (m,): the samples cv2's ``checkSubset`` keeps: no
    three points collinear in either image, and the four triangles'
    orientations all kept or all flipped."""
    neg = (_orientation(src) * _orientation(dst) < 0).sum(-1)
    return ~_collinear(src) & ~_collinear(dst) & ((neg == 0) | (neg == 4))


def ransac_iterations(confidence: float, outlier_ratio: float,
                      max_iters: int, sample_size: int = 4) -> int:
    """cv2's ``RANSACUpdateNumIters``."""
    ep = min(max(outlier_ratio, 0.0), 1.0)
    num = max(1.0 - confidence, np.finfo(np.float64).tiny)
    denom = 1.0 - (1.0 - ep) ** sample_size
    if denom < np.finfo(np.float64).tiny:
        return 0
    num, denom = np.log(num), np.log(denom)
    if denom >= 0 or -num >= max_iters * -denom:
        return max_iters
    return int(np.rint(num / denom))


def _refine(H: np.ndarray, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Levenberg-Marquardt on the forward transfer error over H's first
    eight entries (H[2, 2] = 1), from H."""
    from scipy.optimize import least_squares

    def residuals(h8):
        Hk = np.append(h8, 1.0).reshape(3, 3)
        p = src @ Hk[:2, :2].T + Hk[:2, 2]
        w = src @ Hk[2, :2] + 1.0
        w = np.where(np.abs(w) > np.finfo(np.float64).eps, 1.0 / w, 0.0)
        return (p * w[:, None] - dst).ravel()

    h8 = least_squares(residuals, H.ravel()[:8], method="lm").x
    return np.append(h8, 1.0).reshape(3, 3)


def find_homography_ransac(src, dst, thresh: float = 3.0,
                           max_iters: int = 5000, confidence: float = 0.995,
                           seed: int = 0, max_attempts: int = 10000
                           ) -> tuple[Optional[np.ndarray],
                                      Optional[np.ndarray]]:
    """src, dst (n, 2) point correspondences -> (H (3, 3) with
    H[2, 2] = 1, inlier mask (n,)), or (None, None) where cv2 gives no
    model: fewer than 4 points, or no sample that is not degenerate within
    ``max_attempts`` draws."""
    src = np.asarray(src, np.float64).reshape(-1, 2)
    dst = np.asarray(dst, np.float64).reshape(-1, 2)
    n = src.shape[0]
    if n < 4:
        return None, None
    if n == 4:  # cv2 solves the one sample and refines nothing
        if not good_samples(src[None], dst[None])[0]:
            return None, None
        H = dlt(src, dst)
        return (H, np.ones(n, bool)) if np.isfinite(H).all() else (None,
                                                                   None)
    rng = np.random.default_rng(seed)
    t2 = thresh * thresh
    best_H, best_mask, best_count = None, None, 3  # more than 3 to count
    niters, it, attempts = max_iters, 0, 0
    while it < niters:
        idx = rng.integers(0, n, (_CHUNK, 4))
        s = np.sort(idx, 1)
        distinct = np.all(s[:, 1:] != s[:, :-1], 1)
        ok = distinct.copy()
        ok[distinct] = good_samples(src[idx[distinct]], dst[idx[distinct]])
        # draws without a good sample count against max_attempts, as
        # cv2's redraws do: at the start there is then no model
        if not ok.any():
            attempts += _CHUNK
            if attempts >= max_attempts:
                if it == 0:
                    return None, None
                break
            continue
        attempts = 0
        idx = idx[ok]
        Hs = four_point(src[idx], dst[idx])
        inl = transfer_error(Hs, src, dst) <= t2  # NaN compares False
        counts = inl.sum(1)
        for k in range(idx.shape[0]):
            if it >= niters:
                break
            it += 1
            if counts[k] > best_count and np.isfinite(Hs[k]).all():
                best_H, best_mask, best_count = Hs[k], inl[k], counts[k]
                niters = ransac_iterations(confidence, (n - counts[k]) / n,
                                           niters)
    if best_H is None:
        return None, None
    H, mask = best_H, best_mask
    for _ in range(10):
        fit = dlt(src[mask], dst[mask])
        if not np.isfinite(fit).all():
            break
        H = fit
        grown = transfer_error(H, src, dst) <= t2
        if grown.sum() < 4 or (grown == mask).all():
            break
        mask = grown
    H = _refine(H, src[mask], dst[mask])
    return H, transfer_error(H, src, dst) <= t2
