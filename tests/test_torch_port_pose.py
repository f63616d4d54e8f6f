"""The port's pose path on the CPU against the JAX package: the small-matrix
closed forms (``ops/smallmat``), the device BF matcher, the rotation error
without cv2, the 8-point pose and the device RANSAC under the same injected
noise. Seeded numpy inputs go through both; each test states its
tolerance."""

import numpy as np
import pytest
import torch

import nanovs_slam_torch.vo.pose as port_pose
from nanovs_slam_torch.ops import smallmat
from nanovs_slam_torch.vo.camera import PinholeCamera, kitti_params
from nanovs_slam_torch.vo.matcher import (bf_match_device,
                                          ratio_test_match_one_to_one)

cv2 = pytest.importorskip("cv2")
jax = pytest.importorskip("jax")
jnp = jax.numpy
jax_smallmat = pytest.importorskip("nanovs_slam_tpu.ops.smallmat")
jax_pose = pytest.importorskip("nanovs_slam_tpu.vo.pose")
jax_matcher = pytest.importorskip("nanovs_slam_tpu.vo.matcher")

F32 = dict(atol=1e-5, rtol=0)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _spd(rs, B, n):
    A = rs.randn(B, n + 3, n).astype(np.float32)
    return np.einsum("bij,bik->bjk", A, A) + np.eye(n, dtype=np.float32)


# ------------------------------------------------------------ smallmat

def test_cholesky_factor_and_solves_match_jax():
    """Batches of SPD 9x9 and 5x5 systems: 1e-5 at float32 (on the
    solutions, relative to their scale)."""
    rs = np.random.RandomState(0)
    for n in (9, 5):
        M = _spd(rs, 64, n)
        b = rs.randn(64, n).astype(np.float32)
        L_want = np.asarray(jax_smallmat.cholesky_factor(jnp.asarray(M)))
        L_got = smallmat.cholesky_factor(_t(M)).numpy()
        np.testing.assert_allclose(L_got, L_want, **F32)
        x_want = np.asarray(jax_smallmat.cholesky_solve_factored(
            jnp.asarray(L_want), jnp.asarray(b)))
        x_got = smallmat.cholesky_solve_factored(_t(L_want), _t(b)).numpy()
        np.testing.assert_allclose(x_got, x_want, **F32)
        x2_want = np.asarray(jax_smallmat.cholesky_solve(jnp.asarray(M),
                                                         jnp.asarray(b)))
        x2_got = smallmat.cholesky_solve(_t(M), _t(b)).numpy()
        np.testing.assert_allclose(x2_got, x2_want, **F32)


def test_nullvec_matches_jax():
    """Minimal (8x9) and least-squares (40x9) systems: 1e-5."""
    rs = np.random.RandomState(1)
    for m in (8, 40):
        A = rs.randn(128, m, 9).astype(np.float32)
        want = np.asarray(jax_smallmat.nullvec(jnp.asarray(A)))
        got = smallmat.nullvec(_t(A)).numpy()
        np.testing.assert_allclose(got, want, **F32)


def _with_spectrum(rs, B, w):
    """(B, 3, 3) Q diag(w) Q^T with random rotations Q."""
    Q = np.stack([cv2.Rodrigues(rs.randn(3))[0] for _ in range(B)])
    return np.einsum("bij,j,bkj->bik", Q, w, Q)


def test_eigh3_and_svd3_match_jax():
    """Symmetric matrices with eigenvalues 1 apart and general ones with
    singular values 1 apart: w, U, s, V within 1e-5 (an eigenvector's
    error grows as the inverse of its gap, in any implementation). Rank-2
    essential matrices, whose top singular pair is equal and so has no
    unique basis: s and the rank-2 projection U[:, :2] V[:, :2]^T, which
    is all that the RANSAC uses of that pair, within 1e-5."""
    rs = np.random.RandomState(2)
    S = _with_spectrum(rs, 256, np.array([2.5, 1.0, -0.5])).astype(
        np.float32)
    for want, got in zip(jax_smallmat.eigh3(jnp.asarray(S)),
                         smallmat.eigh3(_t(S))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    G = (_with_spectrum(rs, 256, np.array([3.0, 2.0, 1.0]))
         @ np.stack([cv2.Rodrigues(rs.randn(3))[0] for _ in range(256)])
         ).astype(np.float32)
    for want, got in zip(jax_smallmat.svd3(jnp.asarray(G)),
                         smallmat.svd3(_t(G))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    t = rs.randn(64, 3)
    R = np.stack([cv2.Rodrigues(rs.randn(3) * 0.3)[0] for _ in range(64)])
    tx = np.zeros((64, 3, 3))
    tx[:, 0, 1], tx[:, 0, 2], tx[:, 1, 2] = -t[:, 2], t[:, 1], -t[:, 0]
    tx -= tx.transpose(0, 2, 1)
    E = (tx @ R).astype(np.float32)
    U_w, s_w, V_w = (np.asarray(a) for a in jax_smallmat.svd3(
        jnp.asarray(E)))
    U_g, s_g, V_g = (a.numpy() for a in smallmat.svd3(_t(E)))
    np.testing.assert_allclose(s_g, s_w, **F32)
    np.testing.assert_allclose(U_g[..., :2] @ V_g[..., :2].transpose(0, 2, 1),
                               U_w[..., :2] @ V_w[..., :2].transpose(0, 2, 1),
                               **F32)


# ------------------------------------------------------------ BF matcher

def test_bf_match_device_matches_jax_and_host():
    """Exact: the device twin against the JAX one (with padded slots and
    duplicated descriptors, so that ties meet the one-to-one rule) and, on
    the valid slots, against the host ratio test."""
    rs = np.random.RandomState(3)
    f0 = rs.randn(300, 32).astype(np.float32)
    f1 = np.concatenate([f0[:150] + 0.05 * rs.randn(150, 32),
                         rs.randn(100, 32)]).astype(np.float32)
    f0[10] = f0[11]  # two queries at one train: the lower index wins
    f0 /= np.linalg.norm(f0, axis=1, keepdims=True)
    f1 /= np.linalg.norm(f1, axis=1, keepdims=True)
    m0 = np.arange(300) < 280
    m1 = np.arange(250) < 240
    for masks in ((None, None), (m0, m1)):
        t_want, v_want = jax_matcher.bf_match_device(
            jnp.asarray(f0), jnp.asarray(f1),
            *(None if m is None else jnp.asarray(m) for m in masks))
        t_got, v_got = bf_match_device(
            _t(f0), _t(f1), *(None if m is None else torch.from_numpy(m)
                              for m in masks))
        np.testing.assert_array_equal(v_got.numpy(), np.asarray(v_want))
        v = v_got.numpy()
        np.testing.assert_array_equal(t_got.numpy()[v],
                                      np.asarray(t_want)[v])
    q, t, _ = ratio_test_match_one_to_one(f0, f1)
    t_got, v_got = bf_match_device(_t(f0), _t(f1))
    np.testing.assert_array_equal(np.nonzero(v_got.numpy())[0], np.sort(q))
    np.testing.assert_array_equal(t_got.numpy()[np.sort(q)],
                                  t[np.argsort(q)])


# ------------------------------------------------------------ errors

def test_rotation_error_matches_cv2_rodrigues():
    """||rotvec|| without cv2 against ||cv2.Rodrigues(R)|| to 1e-9, at
    angles below cv2's 1e-5 (which it reads as 0), small and generic ones
    and up to 1e-6 from pi (closer, cv2's acos is off by more than
    1e-9)."""
    rs = np.random.RandomState(4)
    angles = np.concatenate([[0.0, 1e-9, 1e-6, 2e-5, 1e-4],
                             rs.uniform(0, 3.1, 40),
                             [np.pi - 1e-4, np.pi - 1e-6]])
    for a in angles:
        axis = rs.randn(3)
        R = cv2.Rodrigues(axis / np.linalg.norm(axis) * a)[0]
        R2 = cv2.Rodrigues(rs.randn(3) * 0.5)[0]
        for Rest, Rgt in ((R, np.eye(3)), (R @ R2, R2)):
            want = jax_pose.calculate_pose_error(Rgt, np.zeros(3), Rest,
                                                 np.zeros(3))[1]
            got = port_pose.calculate_pose_error(Rgt, np.zeros(3), Rest,
                                                 np.zeros(3))[1]
            assert abs(got - want) <= 1e-9, (a, got, want)


# ------------------------------------------------------------ device pose

def _two_view(seed=7, n=300, outliers=0.3):
    """Normalised correspondences of a 3D cloud seen from two poses, a
    fraction of view 1's points moved by up to 0.08 (gross outliers)."""
    fx, fy, cx, cy = kitti_params()
    cam = PinholeCamera(1241, 376, fx, fy, cx, cy)
    rs = np.random.RandomState(seed)
    pts3d = np.stack([rs.uniform(-15, 15, n), rs.uniform(-4, 4, n),
                      rs.uniform(10, 60, n)], 1)
    t_gt = np.array([0.2, -0.1, 1.0])
    R_gt = cv2.Rodrigues(np.array([0.01, 0.03, -0.005]))[0]
    uv0, z0 = cam.project(pts3d)
    uv1, z1 = cam.project((R_gt.T @ (pts3d - t_gt).T).T)
    ok = (z0 > 0) & (z1 > 0)
    kpn0 = cam.unproject_points(uv0[ok]).astype(np.float32)
    kpn1 = cam.unproject_points(uv1[ok]).astype(np.float32)
    m = len(kpn0)
    bad = rs.choice(m, int(outliers * m), replace=False)
    kpn1[bad] += rs.uniform(-0.08, 0.08, (len(bad), 2)).astype(np.float32)
    return kpn0, kpn1, bad


def test_estimate_pose_device_matches_jax():
    """The 8-point pose on clean correspondences: R, t within 1e-4 and the
    same cheirality vote."""
    kpn0, kpn1, _ = _two_view(outliers=0.0)
    R_w, t_w, v_w = jax_pose.estimate_pose_device(kpn0, kpn1)
    R_g, t_g, v_g = port_pose.estimate_pose_device(kpn0, kpn1)
    np.testing.assert_allclose(R_g.numpy(), np.asarray(R_w), atol=1e-4)
    np.testing.assert_allclose(t_g.numpy(), np.asarray(t_w), atol=1e-4)
    assert int(v_g) == int(v_w)


@pytest.mark.parametrize("restarts", [1, 3])
def test_ransac_matches_jax_under_injected_noise(monkeypatch, restarts):
    """256 hypotheses a stage, 2 LO rounds, pool 4, on 30% gross outliers.
    Both take the same numpy gumbel noise: the JAX function through a
    patched ``jax.random.split`` (keys that count restarts and stages) and
    ``jax.random.gumbel`` (a table lookup by that count), the port through
    its ``gumbel_noise``. R and t within 1e-4, inlier masks equal."""
    H, lo = 256, 2
    kpn0, kpn1, bad = _two_view()
    N = len(kpn0)
    table = np.random.RandomState(11).gumbel(
        size=(restarts, 1 + lo, H, N)).astype(np.float32)

    def split(key, num=2):
        c = jnp.asarray(key)[0]
        return jnp.stack([jnp.stack([c * 16 + i + 1, jnp.asarray(key)[1]])
                          for i in range(num)])

    def gumbel(key, shape, dtype=jnp.float32):
        c = jnp.asarray(key)[0]
        r = jnp.maximum(c // 16, 1) - 1
        assert tuple(shape) == (H, N)
        return jnp.take(jnp.asarray(table.reshape(-1, H, N)),
                        r * (1 + lo) + c % 16 - 1, axis=0)

    monkeypatch.setattr(jax.random, "split", split)
    monkeypatch.setattr(jax.random, "gumbel", gumbel)
    # jitted: tracing once beats the op-by-op run on the CPU
    R_w, t_w, inl_w = jax.jit(lambda a, b, k: jax_pose.ransac_essential_device(
        a, b, k, n_hypotheses=H, restarts=restarts))(
        kpn0, kpn1, jnp.zeros((2,), jnp.uint32))
    monkeypatch.undo()

    stage = iter(range(1 + lo))

    def gumbel_noise(shape, generator):
        assert tuple(shape) == (restarts, H, N)
        return torch.from_numpy(table[:, next(stage)])

    monkeypatch.setattr(port_pose, "gumbel_noise", gumbel_noise)
    R_g, t_g, inl_g = port_pose.ransac_essential_device(
        _t(kpn0), _t(kpn1), torch.Generator(), n_hypotheses=H,
        restarts=restarts)
    np.testing.assert_allclose(R_g.numpy(), np.asarray(R_w), atol=1e-4)
    np.testing.assert_allclose(t_g.numpy(), np.asarray(t_w), atol=1e-4)
    np.testing.assert_array_equal(inl_g.numpy(), np.asarray(inl_w))
    assert inl_g.numpy()[bad].mean() < 0.1  # the outliers are out


def test_ransac_generator_stream_is_deterministic():
    """Two runs from generators with one seed give the same pose; the
    result has the documented shapes."""
    kpn0, kpn1, _ = _two_view()
    outs = [port_pose.ransac_essential_device(
        _t(kpn0), _t(kpn1), torch.Generator().manual_seed(5),
        n_hypotheses=128, restarts=2) for _ in range(2)]
    (R, t, inl), (R2, t2, inl2) = outs
    assert R.shape == (3, 3) and t.shape == (3, 1) and inl.dtype == torch.bool
    assert torch.equal(R, R2) and torch.equal(t, t2)
    assert torch.equal(inl, inl2)


def test_device_camera_matches_jax():
    """The torch camera (on the CPU here) against the JAX one, batched:
    depths and unprojections within 1e-5, pixels within 1e-6 relative
    (1e-3 px), the in-image mask equal."""
    from nanovs_slam_tpu.vo.camera import PinholeCameraDevice as JCam

    from nanovs_slam_torch.vo.camera import PinholeCameraDevice

    fx, fy, cx, cy = kitti_params()
    jcam = JCam(1241, 376, fx, fy, cx, cy)
    cam = PinholeCameraDevice(1241, 376, fx, fy, cx, cy, device="cpu")
    rs = np.random.RandomState(8)
    pts = np.stack([rs.uniform(-10, 10, (2, 200)), rs.uniform(-3, 3, (2, 200)),
                    rs.uniform(-5, 50, (2, 200))], -1).astype(np.float32)
    uv_w, z_w = jcam.project(jnp.asarray(pts))
    uv_g, z_g = cam.project(_t(pts))
    np.testing.assert_allclose(uv_g.numpy(), np.asarray(uv_w), rtol=1e-6,
                               atol=1e-3)
    np.testing.assert_allclose(z_g.numpy(), np.asarray(z_w), **F32)
    np.testing.assert_array_equal(cam.are_in_image(uv_g, z_g).numpy(),
                                  np.asarray(jcam.are_in_image(uv_w, z_w)))
    uv = rs.uniform(0, 1241, (2, 50, 2)).astype(np.float32)
    np.testing.assert_allclose(cam.unproject_points(_t(uv)).numpy(),
                               np.asarray(jcam.unproject_points(
                                   jnp.asarray(uv))), **F32)
