"""Helpers of the port's parity tests (tests/test_torch_port_*.py): seeded
flax variables without running flax's init, layout changes, and the
comparison of two ``make_infer_fn`` answers."""

import jax
import jax.numpy as jnp
import numpy as np
import torch


def random_variables(module, *inputs, seed=0, **kwargs):
    """(params, batch_stats) of the flax ``module`` for ``inputs``, as
    numpy arrays drawn from ``np.random.RandomState(seed)``. Shapes come
    from ``jax.eval_shape`` of ``module.init`` (no forward runs). Kernels
    are normal with variance 1/fan_in; biases, BN means and LayerNorm
    shifts 0.1 normal; BN and LayerNorm scales 1 + 0.1 normal; BN
    variances uniform in [0.5, 1.5); GeM's p uniform in [2.5, 3.5);
    NetVLAD centroids uniform in [0, 1)."""
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: module.init(
        {"params": key, "dropout": key}, *inputs, **kwargs))
    rs = np.random.RandomState(seed)

    def fill(path, s):
        leaf = path[-1].key
        if leaf in ("kernel", "assign_w"):
            a = rs.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif leaf in ("scale", "g"):
            a = 1.0 + 0.1 * rs.randn(*s.shape)
        elif leaf == "var":
            a = rs.uniform(0.5, 1.5, s.shape)
        elif leaf == "p":
            a = rs.uniform(2.5, 3.5, s.shape)
        elif leaf == "centroids":
            a = rs.rand(*s.shape)
        else:  # bias, b, mean
            a = 0.1 * rs.randn(*s.shape)
        return a.astype(np.float32)

    v = jax.tree_util.tree_map_with_path(fill, shapes)
    return dict(v["params"]), dict(v.get("batch_stats", {}))


def apply_jit(module, params, batch_stats, *inputs, **kwargs):
    """``module.apply`` under ``jax.jit`` (far faster on the CPU than
    op-by-op), numpy in and out; ``kwargs`` stay Python values."""
    fn = jax.jit(lambda v, *a: module.apply(v, *a, **kwargs))
    out = fn({"params": params, "batch_stats": batch_stats},
             *(jnp.asarray(a) for a in inputs))
    return jax.tree_util.tree_map(np.asarray, out)


def nchw(x):
    """NHWC numpy -> NCHW torch."""
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def nhwc(t):
    """NCHW torch -> NHWC numpy (other ranks as they are)."""
    a = t.detach().numpy()
    return a.transpose(0, 2, 3, 1) if a.ndim == 4 else a


def assert_dense_outputs_match(want, got):
    """Two ``make_infer_fn`` answers: the same keys and shapes, score and
    coord within 1e-4, descriptor cosine > 0.9999, vlad and depth within
    1e-4, classes equal on >= 99.9% of the pixels."""
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
    for k in ("score", "coord", "vlad", "depth"):
        if k in want:
            np.testing.assert_allclose(got[k], want[k], atol=1e-4,
                                       err_msg=k)
    assert np.sum(got["feat"] * want["feat"], -1).min() > 0.9999
    assert np.mean(got["seg"] == want["seg"]) >= 0.999


def assert_top_k_match_as_sets(want, got, conf):
    """Ties may reorder the top K, so the valid keypoints are compared as
    sets; a keypoint in one set only must score within 1e-4 of a cut (the
    threshold ``conf`` or the K-th score)."""
    for b in range(want["keypoints"].shape[0]):
        sets, scores, descs = [], {}, []
        for out in (want, got):
            valid = out["keypoint_valid"][b]
            kp = [tuple(p) for p in np.round(out["keypoints"][b][valid], 3)]
            scores.update(zip(kp, out["keypoint_scores"][b][valid]))
            descs.append(dict(zip(kp, out["descriptors"][b][valid])))
            sets.append(set(kp))
        assert sets[0], "no valid keypoints: the test input is too weak"
        kth = min(want["keypoint_scores"][b][-1],
                  got["keypoint_scores"][b][-1])
        for key in sets[0] ^ sets[1]:
            s = scores[key]
            assert min(abs(s - conf), abs(s - kth)) < 1e-4, (key, s)
        for key in sets[0] & sets[1]:
            assert float(np.dot(descs[0][key], descs[1][key])) > 0.9999
    np.testing.assert_allclose(
        np.sort(got["keypoint_scores"], -1),
        np.sort(want["keypoint_scores"], -1), atol=1e-4)
