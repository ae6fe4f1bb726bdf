"""VGICP: voxel tables, alignment recovery, fitness gate."""
import numpy as np
import jax.numpy as jnp

from warpsense.core import geometry
from warpsense.frontends.featsense import vgicp


def _room_cloud(n, rng, half=6.0, zhalf=2.0):
    pts = []
    per = n // 6
    for ax in range(3):
        for s in (-1, 1):
            p = np.stack([rng.uniform(-half, half, per),
                          rng.uniform(-half, half, per),
                          rng.uniform(-zhalf, zhalf, per)], axis=1)
            p[:, ax] = s * (zhalf if ax == 2 else half)
            pts.append(p)
    return np.concatenate(pts).astype(np.float32)


def test_voxel_table_mean_and_lookup():
    rng = np.random.default_rng(0)
    base = np.array([[0.5, 0.5, 0.5], [3.5, 0.5, 0.5]])
    pts = np.concatenate([
        base[0] + rng.normal(0, 0.05, (50, 3)),
        base[1] + rng.normal(0, 0.05, (50, 3))]).astype(np.float32)
    mask = jnp.ones((100,), bool)
    origin = jnp.zeros(3, jnp.float32)
    tbl = vgicp.build_voxel_table(jnp.asarray(pts), mask, origin, 1.0)
    assert int(tbl.mask.sum()) == 2
    idx, found = vgicp.lookup(tbl, jnp.asarray(base, jnp.float32),
                              jnp.ones((2,), bool), origin, 1.0)
    assert bool(found.all())
    means = np.asarray(tbl.mean)[np.asarray(idx)]
    np.testing.assert_allclose(means, base, atol=0.05)


def test_vgicp_recovers_transform():
    rng = np.random.default_rng(1)
    target = _room_cloud(3000, rng)
    source_w = _room_cloud(3000, np.random.default_rng(2))
    # true transform: source frame -> world;  source points = T^-1 p_world
    xi = np.array([0.0, 0.0, 0.05, 0.2, -0.15, 0.08], np.float32)
    q, t = geometry.se3_exp(jnp.asarray(xi))
    R = np.asarray(geometry.quat_to_mat(q), np.float64)
    tt = np.asarray(t, np.float64)
    source = ((source_w - tt) @ R).astype(np.float32)

    T, fitness = vgicp.vgicp_align(
        jnp.asarray(source), jnp.ones((len(source),), bool),
        jnp.asarray(target), jnp.ones((len(target),), bool),
        resolution=1.0, max_iterations=30, fitness_score_threshold=6.0)
    T = np.asarray(T)
    assert float(fitness) < 1.0
    np.testing.assert_allclose(T[:3, :3], R, atol=0.01)
    np.testing.assert_allclose(T[:3, 3], tt, atol=0.05)


def test_vgicp_fitness_gate_returns_identity():
    rng = np.random.default_rng(3)
    a = rng.uniform(-5, 5, (500, 3)).astype(np.float32)
    b = (rng.uniform(-5, 5, (500, 3)) + 300.0).astype(np.float32)  # disjoint
    T, fitness = vgicp.vgicp_align(
        jnp.asarray(a), jnp.ones((500,), bool),
        jnp.asarray(b), jnp.ones((500,), bool),
        resolution=1.0, max_iterations=5, fitness_score_threshold=6.0)
    assert not np.isfinite(float(fitness)) or float(fitness) > 6.0
    np.testing.assert_array_equal(np.asarray(T), np.eye(4, dtype=np.float32))
