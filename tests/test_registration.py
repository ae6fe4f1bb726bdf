"""Registration parity + known-perturbation recovery.

Mirrors the reference's strategy: test/cuda.cpp::test_cuda_calc_jacobis
(device Jacobians vs CPU twin) and test/pcd_registration.cpp (perturb a
pose, register back, check the recovered error).

Note on convergence speed: the reference's GN formulation leaves the voxel
resolution un-normalized in the gradient, so steps are ~resolution times
smaller than a textbook GN step and it leans on max_iterations=200
(tsdf_registration.cpp:55-93).  The recovery tests replicate that behavior
(epsilon=0, several hundred iterations) rather than "fixing" it.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from warpsense.core.consts import WEIGHT_RESOLUTION
from warpsense.map.global_map import GlobalMap
from warpsense.map.local_map import LocalMap
from warpsense.ops.registration import jacobian_stats, register_cloud, _SC, _SG
from warpsense.ops.registration_reference import (
    jacobian_stats as jacobian_stats_ref, register_cloud_reference)

TAU = 600
RESOLUTION = 64
MAP_SIZE = (81, 81, 81)


SENSOR_MM = np.array([300, 200, 100])
ROOM_HALF = 2200.0


def room_points(n_per_face, rng):
    """Random points on the 6 walls of a box room (half extent ROOM_HALF)
    plus a vertical pillar for extra rotation observability — the
    360-degree indoor geometry the reference operates on."""
    pts = []
    for ax in range(3):
        for s in (-1.0, 1.0):
            uv = rng.uniform(-ROOM_HALF, ROOM_HALF, size=(n_per_face, 2))
            p = np.zeros((n_per_face, 3))
            p[:, ax] = s * ROOM_HALF
            p[:, (ax + 1) % 3] = uv[:, 0]
            p[:, (ax + 2) % 3] = uv[:, 1]
            pts.append(p)
    # pillar: 4 sides of a vertical box column
    m = n_per_face // 2
    for ax, lohi in ((0, (600.0, 1000.0)), (1, (700.0, 1100.0))):
        for side in lohi:
            p = np.zeros((m, 3))
            p[:, ax] = side
            p[:, 1 - ax] = rng.uniform(*((700.0, 1100.0) if ax == 0
                                         else (600.0, 1000.0)), size=m)
            p[:, 2] = rng.uniform(-ROOM_HALF, ROOM_HALF, size=m)
            pts.append(p)
    return np.round(np.concatenate(pts)).astype(np.int64)


@pytest.fixture(scope="module")
def corner_scene(tmp_path_factory):
    """Local map built by *fusing a synthetic room scan* with the device
    TSDF op — registration runs against the same kind of field it sees in
    the live pipeline (fuse -> register, the minimum end-to-end slice)."""
    from warpsense.core.consts import MATRIX_RESOLUTION
    from warpsense.ops.tsdf import tsdf_update, plan_raymarch

    tmp = tmp_path_factory.mktemp("reg")
    gm = GlobalMap(tmp / "room", TAU, 0)
    lm = LocalMap(MAP_SIZE, gm)

    rng = np.random.default_rng(99)
    pts = room_points(2500, rng)
    max_range = int(np.linalg.norm(pts - SENSOR_MM, axis=1).max()) + 100
    max_steps, max_isteps = plan_raymarch(TAU, RESOLUTION, max_range)
    sensor_voxel = SENSOR_MM // RESOLUTION
    up = jnp.asarray([0, 0, MATRIX_RESOLUTION], jnp.int32)
    state = tsdf_update(
        lm.device_state(), jnp.asarray(pts, jnp.int32),
        jnp.ones((len(pts),), bool), jnp.asarray(sensor_voxel, jnp.int32),
        up, size=lm.size, tau=TAU, max_weight=32 * WEIGHT_RESOLUTION,
        resolution=RESOLUTION, max_steps=max_steps, max_isteps=max_isteps)
    lm.absorb(state)
    return lm, pts


def pose_from(axis, angle_rad, trans_mm):
    axis = np.asarray(axis, float)
    axis /= np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]],
                  [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    R = np.eye(3) + np.sin(angle_rad) * K + (1 - np.cos(angle_rad)) * (K @ K)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R
    T[:3, 3] = trans_mm
    return T


def pose_errors(T):
    rot = np.degrees(np.arccos(np.clip((np.trace(T[:3, :3]) - 1) / 2, -1, 1)))
    return rot, np.linalg.norm(T[:3, 3])


def test_jacobian_stats_device_matches_reference(corner_scene):
    corner_map, scan = corner_scene
    rng = np.random.default_rng(3)
    pts = scan[rng.choice(len(scan), 120, replace=False)]
    pose = pose_from([0.3, 1.0, 0.2], 0.02, [60, -40, 30])
    H_ref, g_ref, e_ref, c_ref = jacobian_stats_ref(
        pts, corner_map, pose, RESOLUTION)

    state = corner_map.device_state()
    mask = jnp.ones((len(pts),), bool)
    Hs, gs, e, c = jacobian_stats(state, jnp.asarray(pts, jnp.int32), mask,
                                  jnp.asarray(pose), size=corner_map.size,
                                  resolution=RESOLUTION)
    D = np.concatenate([np.full(3, _SC), np.full(3, _SG)])
    H_dev = np.asarray(Hs, np.float64) / np.outer(D, D)
    g_dev = np.asarray(gs, np.float64) / D

    assert int(c) == c_ref
    assert int(e) == e_ref
    np.testing.assert_allclose(H_dev, H_ref.astype(np.float64), rtol=2e-5)
    np.testing.assert_allclose(g_dev, g_ref.astype(np.float64), rtol=2e-5,
                               atol=1e-3 * np.abs(g_ref).max())


def reg_cloud(scan, rng, n):
    """Voxel-center snap + dedup, like App::preprocess (app.cpp:120-148)."""
    vc = np.unique(scan // RESOLUTION * RESOLUTION + RESOLUTION // 2, axis=0)
    return vc[rng.choice(len(vc), min(n, len(vc)), replace=False)]


def test_registration_recovers_translation(corner_scene):
    """Pure translation offsets are pulled back to within ~a voxel."""
    corner_map, scan = corner_scene
    rng = np.random.default_rng(7)
    pts = reg_cloud(scan, rng, 3000)
    perturbed = pose_from([0, 0, 1.0], 0.0, [120, -100, 80])
    _, trans0 = pose_errors(perturbed)

    state = corner_map.device_state()
    mask = jnp.ones((len(pts),), bool)
    out = register_cloud(state, jnp.asarray(pts, jnp.int32), mask,
                         jnp.asarray(perturbed), size=corner_map.size,
                         resolution=RESOLUTION, max_iterations=200,
                         it_weight_gradient=0.1, epsilon=0.0)
    rot_err, trans_err = pose_errors(np.asarray(out))
    assert trans_err < RESOLUTION, f"translation error {trans_err:.1f} mm"
    assert rot_err < 0.3, f"introduced rotation {rot_err:.3f} deg"

    # fast mode: true-GN steps converge tighter on translation in a
    # fraction of the iterations
    out = register_cloud(state, jnp.asarray(pts, jnp.int32), mask,
                         jnp.asarray(perturbed), size=corner_map.size,
                         resolution=RESOLUTION, max_iterations=30,
                         it_weight_gradient=0.1, epsilon=0.0, mode="fast")
    rot_err, trans_err = pose_errors(np.asarray(out))
    assert trans_err < RESOLUTION / 2, f"fast translation {trans_err:.1f} mm"
    assert rot_err < 1.0


def test_registration_improves_full_perturbation(corner_scene):
    """Rotation+translation: the noisy surrogate-gradient GN of the
    reference does not reach sub-voxel truth on a synthetic cone-field
    scene, but it must substantially reduce the initial pose error before
    the epsilon window stops it (the reference's operating regime:
    tsdf_registration.cpp:81-93 + IMU pretransform keeps errors small)."""
    corner_map, scan = corner_scene
    rng = np.random.default_rng(5)
    pts = reg_cloud(scan, rng, 3000)
    perturbed = pose_from([0.1, 0.5, 1.0], np.deg2rad(1.0), [60, -50, 40])
    rot0, trans0 = pose_errors(perturbed)

    state = corner_map.device_state()
    mask = jnp.ones((len(pts),), bool)
    out = register_cloud(state, jnp.asarray(pts, jnp.int32), mask,
                         jnp.asarray(perturbed), size=corner_map.size,
                         resolution=RESOLUTION, max_iterations=200,
                         it_weight_gradient=0.1, epsilon=0.0)
    rot_err, trans_err = pose_errors(np.asarray(out))
    assert rot_err < 0.6 * rot0, f"rotation {rot_err:.3f} !< 0.6*{rot0:.3f}"
    assert trans_err < RESOLUTION, f"translation {trans_err:.1f} mm"


def test_registration_reference_recovers_translation(corner_scene):
    """The numpy twin shows the same translation recovery (twin sanity)."""
    corner_map, scan = corner_scene
    rng = np.random.default_rng(11)
    pts = reg_cloud(scan, rng, 1200)
    perturbed = pose_from([0, 0, 1.0], 0.0, [90, 70, -110])
    # epsilon=0: the quantized error is flat while the pose still creeps,
    # so the reference's plateau stop fires after ~4 iterations; the growing
    # Levenberg damping provides the stability instead.
    out = register_cloud_reference(pts, corner_map, perturbed,
                                   resolution=RESOLUTION, max_iterations=150,
                                   it_weight_gradient=0.1, epsilon=0.0)
    rot_err, trans_err = pose_errors(out)
    assert trans_err < 1.5 * RESOLUTION
    assert rot_err < 1.7  # transient rotation the damped GN injects/decays


def test_registration_packed_recovers_perturbation(corner_scene):
    """Packed single-plane fast path (1 gather/iter, byte-quantized
    gradients, interpolated residuals): recovers rot+trans perturbations
    tighter than the nearest-cell modes AND converges in few iterations
    (the 100x-cost fix: iterations actually terminate)."""
    from warpsense.ops.registration import (precompute_fields_packed,
                                            register_cloud_packed)
    corner_map, scan = corner_scene
    rng = np.random.default_rng(13)
    pts = reg_cloud(scan, rng, 3000)
    perturbed = pose_from([0.1, 0.5, 1.0], np.deg2rad(1.0), [60, -50, 40])
    rot0, trans0 = pose_errors(perturbed)

    state = corner_map.device_state()
    fields = precompute_fields_packed(state, tau=TAU)
    mask = jnp.ones((len(pts),), bool)
    out, iters, err = register_cloud_packed(
        fields, state.pos, state.offset, jnp.asarray(pts, jnp.int32), mask,
        jnp.asarray(perturbed), size=corner_map.size, resolution=RESOLUTION,
        tau=TAU, max_iterations=200, it_weight_gradient=0.1, epsilon=0.0)
    rot_err, trans_err = pose_errors(np.asarray(out))
    assert int(iters) < 40, f"no early convergence: {int(iters)} iterations"
    assert trans_err < RESOLUTION / 2, f"translation {trans_err:.1f} mm"
    assert rot_err < 0.5 * rot0, f"rotation {rot_err:.3f} !< {0.5 * rot0:.3f}"
    assert np.isfinite(float(err))


def test_registration_packed_interp_beats_nearest(corner_scene):
    """Gradient-interpolated residuals give sub-voxel translation recovery
    the nearest-cell residual cannot (the accuracy ceiling VERDICT r1 #4)."""
    from warpsense.ops.registration import (precompute_fields_packed,
                                            register_cloud_packed)
    corner_map, scan = corner_scene
    rng = np.random.default_rng(17)
    pts = reg_cloud(scan, rng, 3000)
    perturbed = pose_from([0, 0, 1.0], 0.0, [100, -90, 70])

    state = corner_map.device_state()
    fields = precompute_fields_packed(state, tau=TAU)
    mask = jnp.ones((len(pts),), bool)
    kw = dict(size=corner_map.size, resolution=RESOLUTION, tau=TAU,
              max_iterations=200, it_weight_gradient=0.1, epsilon=0.0)
    out_i, _, _ = register_cloud_packed(
        fields, state.pos, state.offset, jnp.asarray(pts, jnp.int32), mask,
        jnp.asarray(perturbed), interp=True, **kw)
    out_n, _, _ = register_cloud_packed(
        fields, state.pos, state.offset, jnp.asarray(pts, jnp.int32), mask,
        jnp.asarray(perturbed), interp=False, **kw)
    _, trans_i = pose_errors(np.asarray(out_i))
    _, trans_n = pose_errors(np.asarray(out_n))
    assert trans_i < RESOLUTION / 2
    assert trans_i <= trans_n + 1.0, (trans_i, trans_n)


def test_registration_packed_coarse_to_fine(corner_scene):
    """coarse_iterations (early LM rounds on a 1-in-4 subsample) recovers
    the same pose as the full-resolution loop."""
    from warpsense.ops.registration import (precompute_fields_packed,
                                            register_cloud_packed)
    corner_map, scan = corner_scene
    rng = np.random.default_rng(29)
    pts = reg_cloud(scan, rng, 3000)
    perturbed = pose_from([0.1, 0.5, 1.0], np.deg2rad(1.0), [60, -50, 40])

    state = corner_map.device_state()
    fields = precompute_fields_packed(state, tau=TAU)
    mask = jnp.ones((len(pts),), bool)
    kw = dict(size=corner_map.size, resolution=RESOLUTION, tau=TAU,
              max_iterations=200, it_weight_gradient=0.1, epsilon=0.0)
    out_c, iters_c, _ = register_cloud_packed(
        fields, state.pos, state.offset, jnp.asarray(pts, jnp.int32), mask,
        jnp.asarray(perturbed), coarse_iterations=5, **kw)
    rot_err, trans_err = pose_errors(np.asarray(out_c))
    assert trans_err < RESOLUTION / 2, f"translation {trans_err:.1f} mm"
    assert int(iters_c) < 40


def test_registration_packed_coarse_then_freeze(corner_scene):
    """coarse_iterations composes with gather_freeze (ADVICE r3: the combo
    used to silently drop the coarse phase): early LM rounds run on the
    1-in-4 subsample, then the freezable fine loop recovers the same pose
    as plain gather_freeze."""
    from warpsense.ops.registration import (precompute_fields_packed,
                                            register_cloud_packed)
    corner_map, scan = corner_scene
    rng = np.random.default_rng(47)
    pts = reg_cloud(scan, rng, 3000)
    perturbed = pose_from([0.1, 0.5, 1.0], np.deg2rad(1.0), [60, -50, 40])

    state = corner_map.device_state()
    fields = precompute_fields_packed(state, tau=TAU)
    mask = jnp.ones((len(pts),), bool)
    kw = dict(size=corner_map.size, resolution=RESOLUTION, tau=TAU,
              max_iterations=200, it_weight_gradient=0.1, epsilon=0.0)
    out_cf, iters_cf, err_cf = register_cloud_packed(
        fields, state.pos, state.offset, jnp.asarray(pts, jnp.int32), mask,
        jnp.asarray(perturbed), coarse_iterations=5, gather_freeze=True,
        **kw)
    out_f, _, _ = register_cloud_packed(
        fields, state.pos, state.offset, jnp.asarray(pts, jnp.int32), mask,
        jnp.asarray(perturbed), gather_freeze=True, **kw)
    rot_cf, trans_cf = pose_errors(np.asarray(out_cf))
    rot_f, trans_f = pose_errors(np.asarray(out_f))
    assert trans_cf < RESOLUTION / 2, f"translation {trans_cf:.1f} mm"
    assert abs(trans_cf - trans_f) < RESOLUTION / 4
    assert abs(rot_cf - rot_f) < 0.1
    assert int(iters_cf) < 40 and np.isfinite(float(err_cf))


def test_registration_packed_gather_freeze(corner_scene):
    """gather_freeze (cached-fields sub-voxel refinement) recovers the
    perturbation to the same tolerance as the re-gathering loop."""
    from warpsense.ops.registration import (precompute_fields_packed,
                                            register_cloud_packed)
    corner_map, scan = corner_scene
    rng = np.random.default_rng(31)
    pts = reg_cloud(scan, rng, 3000)
    perturbed = pose_from([0.1, 0.5, 1.0], np.deg2rad(1.0), [60, -50, 40])

    state = corner_map.device_state()
    fields = precompute_fields_packed(state, tau=TAU)
    mask = jnp.ones((len(pts),), bool)
    kw = dict(size=corner_map.size, resolution=RESOLUTION, tau=TAU,
              max_iterations=200, it_weight_gradient=0.1, epsilon=0.0)
    out_f, iters_f, err_f = register_cloud_packed(
        fields, state.pos, state.offset, jnp.asarray(pts, jnp.int32), mask,
        jnp.asarray(perturbed), gather_freeze=True, **kw)
    out_n, iters_n, _ = register_cloud_packed(
        fields, state.pos, state.offset, jnp.asarray(pts, jnp.int32), mask,
        jnp.asarray(perturbed), gather_freeze=False, **kw)
    rot_f, trans_f = pose_errors(np.asarray(out_f))
    rot_n, trans_n = pose_errors(np.asarray(out_n))
    assert trans_f < RESOLUTION / 2, f"translation {trans_f:.1f} mm"
    assert abs(trans_f - trans_n) < RESOLUTION / 4
    assert abs(rot_f - rot_n) < 0.1
    assert int(iters_f) < 40 and np.isfinite(float(err_f))


# ------------------------------------------------- packed fields: int64 oracle

def _random_state(seed, size=(37, 29, 23)):
    from warpsense.map.local_map import LocalMapState
    rng = np.random.default_rng(seed)
    v = rng.integers(-TAU, TAU + 1, size, dtype=np.int64).astype(np.int16)
    w = ((rng.random(size) < 0.7).astype(np.int16)
         * rng.integers(1, 64, size).astype(np.int16))
    return LocalMapState(value=jnp.asarray(v), weight=jnp.asarray(w),
                         pos=jnp.asarray([3, -2, 5], jnp.int32),
                         offset=jnp.asarray([7, 11, 2], jnp.int32))


def _oracle_gradients(v, w):
    """Per-axis central difference of the ring window in plain int64:
    C-truncated (next - prev) / 2 where both neighbours carry weight."""
    out = []
    for ax in range(3):
        nv, pv = np.roll(v, -1, axis=ax), np.roll(v, 1, axis=ax)
        nw, pw = np.roll(w, -1, axis=ax), np.roll(w, 1, axis=ax)
        d = nv - pv
        g = np.sign(d) * (np.abs(d) // 2)
        out.append(np.where((nw != 0) & (pw != 0), g, 0))
    return out


def _as_int32(x):
    return (np.asarray(x, np.int64) & 0xFFFFFFFF).astype(np.uint32) \
        .view(np.int32)


def test_packed_fields_match_int64_oracle():
    """One-plane byte packing v:8|gx:8|gy:8|gz:8 with round-to-nearest
    power-of-two quantization (8 mm steps at tau = 600) and the v byte 0
    as the empty-cell sentinel."""
    from warpsense.ops.registration import precompute_fields_packed
    state = _random_state(0)
    v = np.asarray(state.value, np.int64)
    w = np.asarray(state.weight, np.int64)
    s = 3                                    # 600 >> 3 = 75 <= 126 < 150

    def code(x):
        return np.clip(((x + (1 << (s - 1))) >> s) + 128, 1, 255)

    gx, gy, gz = _oracle_gradients(v, w)
    vcode = np.where(w != 0, code(v), 0)
    want = (vcode << 24) | (code(gx) << 16) | (code(gy) << 8) | code(gz)
    got = precompute_fields_packed(state, tau=TAU).plane
    np.testing.assert_array_equal(np.asarray(got), _as_int32(want))


def test_packed2_fields_match_int64_oracle():
    """Two-plane exact packing: a = gx:16|v:16, b = gz:16|gy:16, with
    v = -32768 marking an empty cell."""
    from warpsense.ops.registration import precompute_fields_packed2
    state = _random_state(1)
    v = np.asarray(state.value, np.int64)
    w = np.asarray(state.weight, np.int64)
    gx, gy, gz = _oracle_gradients(v, w)
    vs = np.where(w != 0, v, -32768)

    def pack(lo, hi):
        return ((hi & 0xFFFF) << 16) | (lo & 0xFFFF)

    got = precompute_fields_packed2(state)
    np.testing.assert_array_equal(np.asarray(got.plane_a),
                                  _as_int32(pack(vs, gx)))
    np.testing.assert_array_equal(np.asarray(got.plane_b),
                                  _as_int32(pack(gy, gz)))
