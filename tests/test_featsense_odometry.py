"""F-LOAM odometry: analytic Jacobians vs autodiff, fits, convergence."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from warpsense.core import geometry
from warpsense.frontends.featsense import odometry as odo


def _perturbed_pose(seed=0, rot=0.05, trans=0.2):
    rng = np.random.default_rng(seed)
    xi = np.concatenate([rng.normal(0, rot, 3), rng.normal(0, trans, 3)])
    q, t = geometry.se3_exp(jnp.asarray(xi, jnp.float32))
    return q, t


def _plus(q, t, xi):
    dq, dt = geometry.se3_exp(xi)
    return (geometry.quat_mul(dq, q),
            geometry.quat_rotate(dq, t[None, :])[0] + dt)


def _fd_jacobian(r_of_xi, n_res, h=3e-3):
    """Central finite differences of the residual wrt the se3 increment
    (se3_exp is not autodiff-safe at exactly xi=0: |omega| has a NaN grad)."""
    J = np.zeros((n_res, 6), np.float64)
    for i in range(6):
        e = np.zeros(6, np.float32)
        e[i] = h
        rp = np.asarray(r_of_xi(jnp.asarray(e)), np.float64)
        rm = np.asarray(r_of_xi(jnp.asarray(-e)), np.float64)
        J[:, i] = (rp - rm) / (2 * h)
    return J


def test_edge_jacobian_matches_finite_differences():
    rng = np.random.default_rng(1)
    q, t = _perturbed_pose(1)
    pts = jnp.asarray(rng.normal(0, 3, (7, 3)), jnp.float32)
    a = jnp.asarray(rng.normal(0, 3, (7, 3)), jnp.float32)
    b = a + jnp.asarray(rng.normal(0, 1, (7, 3)), jnp.float32)
    valid = jnp.ones((7,), bool)

    def r_of_xi(xi):
        q2, t2 = _plus(q, t, xi)
        r, _ = odo.edge_residuals(q2, t2, pts, a, b, valid)
        return r

    J_fd = _fd_jacobian(r_of_xi, 7)
    _, J = odo.edge_residuals(q, t, pts, a, b, valid)
    np.testing.assert_allclose(np.asarray(J), J_fd, rtol=5e-3, atol=5e-3)


def test_surf_jacobian_matches_finite_differences():
    rng = np.random.default_rng(2)
    q, t = _perturbed_pose(2)
    pts = jnp.asarray(rng.normal(0, 3, (9, 3)), jnp.float32)
    n = rng.normal(0, 1, (9, 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    n = jnp.asarray(n, jnp.float32)
    d = jnp.asarray(rng.normal(0, 1, (9,)), jnp.float32)
    valid = jnp.ones((9,), bool)

    def r_of_xi(xi):
        q2, t2 = _plus(q, t, xi)
        r, _ = odo.surf_residuals(q2, t2, pts, n, d, valid)
        return r

    J_fd = _fd_jacobian(r_of_xi, 9)
    _, J = odo.surf_residuals(q, t, pts, n, d, valid)
    np.testing.assert_allclose(np.asarray(J), J_fd, rtol=5e-3, atol=5e-3)


def test_fit_lines_recovers_direction():
    rng = np.random.default_rng(3)
    direction = np.array([0.6, 0.64, 0.48])
    ts = rng.uniform(-1, 1, (4, 5, 1))
    base = rng.normal(0, 2, (4, 1, 3))
    nbrs = jnp.asarray(base + ts * direction, jnp.float32)
    a, b, valid = odo.fit_lines(nbrs, jnp.ones((4,), bool))
    assert bool(jnp.all(valid))
    got = np.array(a - b)
    got /= np.linalg.norm(got, axis=1, keepdims=True)
    dots = np.abs(got @ direction)
    np.testing.assert_allclose(dots, 1.0, atol=1e-4)


def test_fit_lines_rejects_planar_spread():
    # 5 points on a circle: lambda_max == lambda_mid, must fail the 3x gate
    ang = np.linspace(0, 2 * np.pi, 5, endpoint=False)
    circle = np.stack([np.cos(ang), np.sin(ang), np.zeros(5)], axis=1)
    nbrs = jnp.asarray(circle[None].repeat(3, 0), jnp.float32)
    _, _, valid = odo.fit_lines(nbrs, jnp.ones((3,), bool))
    assert not bool(jnp.any(valid))


def test_fit_planes_recovers_normal():
    rng = np.random.default_rng(5)
    n_true = np.array([0.0, 0.0, 1.0])
    xy = rng.uniform(-1, 1, (3, 5, 2))
    z = np.full((3, 5, 1), 2.0)        # plane z = 2 -> n.p + d = 0, d=-1/2 scale
    nbrs = jnp.asarray(np.concatenate([xy, z], axis=-1), jnp.float32)
    n, d, valid = odo.fit_planes(nbrs, jnp.ones((3,), bool))
    assert bool(jnp.all(valid))
    n_np = np.asarray(n)
    np.testing.assert_allclose(np.abs(n_np[:, 2]), 1.0, atol=1e-3)
    # plane equation: n.p + d = 0 at z=2 => n_z*2 + d = 0
    np.testing.assert_allclose(np.asarray(d), -2.0 * n_np[:, 2], atol=1e-3)


def test_voxel_downsample_centroids():
    pts = jnp.asarray([[0.1, 0.1, 0.1], [0.3, 0.3, 0.3],   # voxel (0,0,0)
                       [1.2, 0.0, 0.0],                     # voxel (1,0,0)
                       [9.0, 9.0, 9.0]], jnp.float32)       # masked out
    mask = jnp.asarray([True, True, True, False])
    p, m = odo.voxel_downsample(pts, mask, 1.0, 4)
    got = np.asarray(p)[np.asarray(m)]
    assert got.shape == (2, 3)
    got = got[np.argsort(got[:, 0])]
    np.testing.assert_allclose(got[0], [0.2, 0.2, 0.2], atol=1e-6)
    np.testing.assert_allclose(got[1], [1.2, 0.0, 0.0], atol=1e-6)


def _synthetic_maps(rng, n_edge=64, n_surf=512):
    """Edge points on 4 vertical lines, surf points on 3 walls (meters)."""
    lines = np.array([[2.0, 1.0], [-3.0, -2.0], [4.0, -3.0], [-5.0, 2.5]])
    le = []
    for lx, ly in lines:
        z = rng.uniform(-1.5, 2.5, n_edge // 4)
        le.append(np.stack([np.full_like(z, lx), np.full_like(z, ly), z], 1))
    edge = np.concatenate(le)
    walls = []
    m = n_surf // 3
    walls.append(np.stack([np.full(m, 8.0), rng.uniform(-6, 6, m),
                           rng.uniform(-2, 3, m)], 1))
    walls.append(np.stack([rng.uniform(-8, 8, m), np.full(m, 6.0),
                           rng.uniform(-2, 3, m)], 1))
    walls.append(np.stack([rng.uniform(-8, 8, m), rng.uniform(-6, 6, m),
                           np.full(m, -2.0)], 1))
    surf = np.concatenate(walls)
    return edge, surf


def test_odom_update_recovers_pose():
    rng = np.random.default_rng(7)
    edge_w, surf_w = _synthetic_maps(rng)
    edge_map = odo.FeatureMapState(jnp.asarray(edge_w, jnp.float32),
                                   jnp.ones((len(edge_w),), bool))
    surf_map = odo.FeatureMapState(jnp.asarray(surf_w, jnp.float32),
                                   jnp.ones((len(surf_w),), bool))

    # true sensor pose; scan features = world points pulled into sensor frame
    xi = np.array([0.0, 0.0, 0.08, 0.3, -0.2, 0.1], dtype=np.float32)
    q_true, t_true = geometry.se3_exp(jnp.asarray(xi))
    R = np.asarray(geometry.quat_to_mat(q_true), np.float64)
    t = np.asarray(t_true, np.float64)
    e_sensor = (edge_w - t) @ R            # R^T (p - t)
    s_sensor = (surf_w - t) @ R
    e_sensor += rng.normal(0, 0.005, e_sensor.shape)
    s_sensor += rng.normal(0, 0.005, s_sensor.shape)

    q0 = jnp.asarray([0.0, 0.0, 0.0, 1.0], jnp.float32)
    t0 = jnp.zeros(3, jnp.float32)
    q, tt = odo.odom_update(
        edge_map, surf_map,
        jnp.asarray(e_sensor, jnp.float32), jnp.ones((len(e_sensor),), bool),
        jnp.asarray(s_sensor, jnp.float32), jnp.ones((len(s_sensor),), bool),
        q0, t0, jnp.int32(5))
    t_err = np.linalg.norm(np.asarray(tt) - t)
    q_got = np.asarray(q)
    q_ref = np.asarray(q_true)
    q_err = 1.0 - abs(float(q_got @ q_ref))
    assert t_err < 0.03, f"translation error {t_err}"
    assert q_err < 1e-4, f"quaternion error {q_err}"


def test_odom_estimation_host_shell_tracks_motion():
    """Full OdomEstimation over several synthetic frames."""
    rng = np.random.default_rng(11)
    edge_w, surf_w = _synthetic_maps(rng, n_edge=64, n_surf=384)

    est = odo.OdomEstimation(edge_map_capacity=1024, surf_map_capacity=2048,
                             edge_leaf=0.1, optimization_steps=3)
    # ground-truth trajectory: straight line with slow yaw
    errs = []
    for i in range(5):
        yaw = 0.03 * i
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
        t = np.array([0.12 * i, -0.06 * i, 0.0])
        e_sensor = (edge_w - t) @ R
        s_sensor = (surf_w - t) @ R
        pose = est.update(e_sensor, np.ones(len(e_sensor), bool),
                          s_sensor, np.ones(len(s_sensor), bool))
        errs.append(np.linalg.norm(pose[:3, 3] - t))
    assert errs[-1] < 0.05, f"trajectory errors {errs}"


def test_occupied_prefix_bucketing_is_exact():
    """Slicing feature maps to the occupied power-of-2 prefix must not
    change the solve: masked entries were +inf in the distance matrix, so
    the 5-NN sets (and everything downstream) are identical.  This is the
    production fast path in OdomEstimation.update (it shrinks the knn map
    side)."""
    rng = np.random.default_rng(7)
    cap_e, cap_s = 512, 1024
    ne, ns = 60, 300
    emap = odo.FeatureMapState(
        points=jnp.asarray(rng.uniform(-5, 5, (cap_e, 3)), jnp.float32),
        mask=jnp.arange(cap_e) < ne)
    smap = odo.FeatureMapState(
        points=jnp.asarray(rng.uniform(-5, 5, (cap_s, 3)), jnp.float32),
        mask=jnp.arange(cap_s) < ns)
    pe = odo.OdomEstimation._occupied_prefix(emap, ne, lo=64)
    ps = odo.OdomEstimation._occupied_prefix(smap, ns, lo=64)
    assert pe.points.shape[0] == 64 and ps.points.shape[0] == 1024
    e = jnp.asarray(rng.uniform(-5, 5, (128, 3)), jnp.float32)
    s = jnp.asarray(rng.uniform(-5, 5, (256, 3)), jnp.float32)
    em = jnp.ones((128,), bool)
    sm = jnp.ones((256,), bool)
    q0 = jnp.asarray([0.0, 0.0, 0.0, 1.0], jnp.float32)
    t0 = jnp.asarray([0.05, -0.02, 0.01], jnp.float32)
    qa, ta = odo.odom_update(emap, smap, e, em, s, sm, q0, t0, jnp.int32(2))
    qb, tb = odo.odom_update(pe, ps, e, em, s, sm, q0, t0, jnp.int32(2))
    np.testing.assert_array_equal(np.asarray(qa), np.asarray(qb))
    np.testing.assert_array_equal(np.asarray(ta), np.asarray(tb))
