"""Batched small-matrix primitives in closed form, the counterpart of
``nanovs_slam_tpu/ops/smallmat.py``: a Cholesky factor and solve, the
null vector of an (..., m, n) system by inverse iteration, and the
eigendecomposition and SVD of (..., 3, 3) matrices.

The device RANSAC (``vo/pose.ransac_essential_device``) solves thousands
of 8x9 null spaces and 3x3 SVDs a frame. Written out over the tiny
(static) matrix size, each step is a batched elementwise or small matrix
op on the whole batch; no ``torch.linalg`` decomposition takes their
place, so the card runs the same arithmetic as the reference.

Degenerate inputs (rank-deficient beyond the modelled null space,
near-isotropic spectra) return finite orthonormal garbage rather than
NaN: in the RANSAC such hypotheses must lose the MSAC argmin, not poison
it.
"""

from __future__ import annotations

import math

import torch

Tensor = torch.Tensor

__all__ = ["cholesky_factor", "cholesky_solve_factored", "cholesky_solve",
           "nullvec", "eigh3", "svd3"]


def cholesky_factor(M: Tensor) -> Tensor:
    """Batched Cholesky factor of SPD M (..., n, n) -> lower L,
    right-looking and vectorised per column. The sqrt argument is floored
    so that PSD-but-singular inputs give finite output."""
    n = M.shape[-1]
    below = torch.arange(n, device=M.device)
    S = M
    cols = []
    for j in range(n):
        d = torch.sqrt(torch.clamp(S[..., j, j], min=1e-30))
        col = S[..., :, j] / d[..., None]
        # rows < j belong to earlier columns
        col = col * (below >= j).to(M.dtype)
        cols.append(col)
        S = S - col[..., :, None] * col[..., None, :]
    return torch.stack(cols, -1)


def cholesky_solve_factored(L: Tensor, b: Tensor) -> Tensor:
    """Solve L L^T x = b for batched lower-triangular L (..., n, n) and
    b (..., n), the substitutions vectorised per column."""
    n = L.shape[-1]
    ar = torch.arange(n, device=L.device)
    y = b
    for j in range(n):
        yj = y[..., j] / L[..., j, j]
        y = y - yj[..., None] * (L[..., :, j] * (ar > j).to(L.dtype))
        y = torch.cat([y[..., :j], yj[..., None], y[..., j + 1:]], -1)
    x = y
    for j in reversed(range(n)):
        xj = x[..., j] / L[..., j, j]
        x = x - xj[..., None] * (L[..., j, :] * (ar < j).to(L.dtype))
        x = torch.cat([x[..., :j], xj[..., None], x[..., j + 1:]], -1)
    return x


def cholesky_solve(M: Tensor, b: Tensor) -> Tensor:
    """Batched SPD solve x = M^-1 b; M (..., n, n), b (..., n)."""
    return cholesky_solve_factored(cholesky_factor(M), b)


# a fixed generic start for the inverse iteration (no symmetry with the
# epipolar constraints' null spaces)
_START = (0.31, -0.47, 0.22, 0.55, -0.18, 0.40, -0.29, 0.36, 0.51,
          -0.24, 0.44, -0.38)


def nullvec(A: Tensor, iters: int = 4, shift: float = 1e-6) -> Tensor:
    """Unit vector minimising ||A v|| for batched A (..., m, n) -> (..., n):
    inverse iteration on A^T A + shift * tr * I through the Cholesky
    solve, factored once. One iteration converges for minimal solves
    (m = n - 1); ``iters`` = 4 covers least-squares refits."""
    n = A.shape[-1]
    M = torch.einsum("...ij,...ik->...jk", A, A)
    tr = torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    L = cholesky_factor(M + (shift * tr + 1e-30) * eye)
    v = torch.tensor(_START[:n], dtype=A.dtype,
                     device=A.device).expand(M.shape[:-1])
    for _ in range(iters):
        v = cholesky_solve_factored(L, v)
        v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1,
                                                     keepdim=True), min=1e-30)
    return v


def _robust_eigvec3(M: Tensor, lam: Tensor) -> Tensor:
    """Eigenvector of symmetric (..., 3, 3) M for eigenvalue lam (...,):
    the largest-norm cross product of two rows of M - lam I; a unit
    fallback for near-isotropic rows."""
    C = M - lam[..., None, None] * torch.eye(3, dtype=M.dtype,
                                             device=M.device)
    r0, r1, r2 = C[..., 0, :], C[..., 1, :], C[..., 2, :]
    cands = torch.stack([torch.linalg.cross(r0, r1),
                         torch.linalg.cross(r0, r2),
                         torch.linalg.cross(r1, r2)], dim=-2)
    nrm = torch.linalg.vector_norm(cands, dim=-1)
    best = torch.argmax(nrm, dim=-1)
    v = torch.gather(cands, -2, best[..., None, None].expand(
        best.shape + (1, 3)))[..., 0, :]
    n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    fallback = torch.tensor((0.0, 0.0, 1.0), dtype=M.dtype,
                            device=M.device).expand(v.shape)
    return torch.where(n > 1e-20, v / torch.clamp(n, min=1e-30), fallback)


def _tangent_pair(u: Tensor):
    """Two unit vectors completing batched unit u (..., 3) to an
    orthonormal frame."""
    ex = torch.tensor((1.0, 0.0, 0.0), dtype=u.dtype,
                      device=u.device).expand(u.shape)
    ey = torch.tensor((0.0, 1.0, 0.0), dtype=u.dtype,
                      device=u.device).expand(u.shape)
    a = torch.where(torch.abs(u[..., :1]) < 0.9, ex, ey)
    b1 = torch.linalg.cross(u, a)
    b1 = b1 / torch.clamp(torch.linalg.vector_norm(b1, dim=-1, keepdim=True),
                          min=1e-30)
    return b1, torch.linalg.cross(u, b1)


def _mv(M: Tensor, v: Tensor) -> Tensor:
    return torch.einsum("...ij,...j->...i", M, v)


def eigh3(M: Tensor):
    """Closed-form eigendecomposition of batched symmetric (..., 3, 3):
    (w (..., 3) descending, U (..., 3, 3) orthonormal eigenvector
    columns). Cardano's trigonometric roots; the smallest eigenvalue's
    vector from the cross-product construction, the top pair by an exact
    2x2 rotation in its orthogonal complement."""
    eye = torch.eye(3, dtype=M.dtype, device=M.device)
    q = torch.diagonal(M, dim1=-2, dim2=-1).sum(-1) / 3.0
    Mq = M - q[..., None, None] * eye
    p = torch.sqrt(torch.clamp((Mq * Mq).sum(dim=(-2, -1)) / 6.0,
                               min=1e-30))
    B = Mq / p[..., None, None]
    detB = (B[..., 0, 0] * (B[..., 1, 1] * B[..., 2, 2]
                            - B[..., 1, 2] * B[..., 2, 1])
            - B[..., 0, 1] * (B[..., 1, 0] * B[..., 2, 2]
                              - B[..., 1, 2] * B[..., 2, 0])
            + B[..., 0, 2] * (B[..., 1, 0] * B[..., 2, 1]
                              - B[..., 1, 1] * B[..., 2, 0]))
    phi = torch.arccos(torch.clamp(detB / 2.0, -1.0, 1.0)) / 3.0
    w0 = q + 2.0 * p * torch.cos(phi)
    w2 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    w1 = 3.0 * q - w0 - w2

    u2 = _robust_eigvec3(M, w2)
    b1, b2 = _tangent_pair(u2)
    Mb1, Mb2 = _mv(M, b1), _mv(M, b2)
    c00 = (b1 * Mb1).sum(-1)
    c01 = (b1 * Mb2).sum(-1)
    c11 = (b2 * Mb2).sum(-1)
    ang = 0.5 * torch.atan2(2.0 * c01, c00 - c11)
    c, s = torch.cos(ang)[..., None], torch.sin(ang)[..., None]
    ua = c * b1 + s * b2
    ub = -s * b1 + c * b2
    # the top pair descending by Rayleigh quotient
    ra = (ua * _mv(M, ua)).sum(-1)
    rb = (ub * _mv(M, ub)).sum(-1)
    swap = (rb > ra)[..., None]
    u0 = torch.where(swap, ub, ua)
    u1 = torch.where(swap, ua, ub)
    U = torch.stack([u0, u1, u2], dim=-1)
    w = torch.stack([torch.maximum(w0, w1), torch.minimum(w0, w1), w2], -1)
    return w, U


def svd3(E: Tensor):
    """Closed-form SVD of batched (..., 3, 3) for essential-matrix work:
    U from eigh3 of E E^T, v_i = E^T u_i / s_i with a Gram-Schmidt touch-up
    (any rotation of an equal top pair is valid), v2 = v0 x v1. Returns
    (U (..., 3, 3) columns, s (..., 3) descending >= 0, V (..., 3, 3)
    columns). v2's sign is a convention (s2 is a magnitude): uses that
    drop the smallest singular component do not see it."""
    M = torch.einsum("...ij,...kj->...ik", E, E)
    w, U = eigh3(M)
    u0, u1, u2 = U[..., 0], U[..., 1], U[..., 2]
    w0 = torch.einsum("...ji,...j->...i", E, u0)
    s0 = torch.linalg.vector_norm(w0, dim=-1)
    v0 = w0 / torch.clamp(s0[..., None], min=1e-30)
    w1 = torch.einsum("...ji,...j->...i", E, u1)
    s1 = torch.linalg.vector_norm(w1, dim=-1)
    w1 = w1 - (w1 * v0).sum(-1, keepdim=True) * v0
    n1 = torch.linalg.vector_norm(w1, dim=-1, keepdim=True)
    t1, _ = _tangent_pair(v0)
    v1 = torch.where(n1 > 1e-20, w1 / torch.clamp(n1, min=1e-30), t1)
    v2 = torch.linalg.cross(v0, v1)
    s2 = torch.abs(torch.einsum("...i,...ij,...j->...", u2, E, v2))
    V = torch.stack([v0, v1, v2], dim=-1)
    s = torch.stack([s0, s1, s2], dim=-1)
    return U, s, V
