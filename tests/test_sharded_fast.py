"""Shard-count invariance of the PRODUCTION (fast) generation.

The round-2 sharded layer only covered the parity algorithms; these tests
pin the fast path — projective fusion, packed fields, adaptive-LM packed
registration — to its single-chip twin on the 8-device virtual CPU mesh:
N-device result == 1-device result.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from warpsense.core.consts import WEIGHT_RESOLUTION
from warpsense.map.local_map import LocalMapState
from warpsense.ops.registration import (precompute_fields_packed,
                                        precompute_fields_packed2,
                                        register_cloud_packed)
from warpsense.ops.tsdf_projective import tsdf_update_projective
from warpsense.parallel.sharded import (
    make_mesh, precompute_fields_packed_sharded,
    register_cloud_packed_sharded, shard_state,
    tsdf_update_projective_sharded)

TAU = 600
RES = 64
SIZE = (80, 41, 41)          # X divisible by the 8-device mesh
CH, COLS = 32, 128
EYE3 = jnp.eye(3, dtype=jnp.float32)


def room_cloud(n=4002, half=1200.0, zhalf=400.0, seed=7):
    # flat room: |z| <= zhalf keeps floor/ceiling inside the 45-deg vFOV so
    # the projective map constrains z as well as x/y
    rng = np.random.default_rng(seed)
    pts = []
    for ax in range(3):
        for s in (-1, 1):
            p = np.stack([rng.uniform(-half, half, n // 6),
                          rng.uniform(-half, half, n // 6),
                          rng.uniform(-zhalf, zhalf, n // 6)], axis=1)
            p[:, ax] = s * (zhalf if ax == 2 else half)
            pts.append(p)
    return np.round(np.concatenate(pts)).astype(np.int32)


def fresh_state():
    return LocalMapState(
        value=jnp.full(SIZE, TAU, jnp.int16),
        weight=jnp.zeros(SIZE, jnp.int16),
        pos=jnp.zeros(3, jnp.int32),
        offset=jnp.asarray([s // 2 for s in SIZE], jnp.int32),
    )


@pytest.fixture(scope="module")
def fused_pair():
    assert len(jax.devices()) >= 8
    pts = jnp.asarray(room_cloud())
    mask = jnp.ones((pts.shape[0],), bool)
    kw = dict(size=SIZE, tau=TAU, max_weight=32 * WEIGHT_RESOLUTION,
              resolution=RES, channels=CH, columns=COLS, vfov_deg=45.0)
    single = tsdf_update_projective(
        fresh_state(), pts, mask, jnp.zeros(3, jnp.int32), EYE3, **kw)
    mesh = make_mesh(8)
    sharded = tsdf_update_projective_sharded(
        shard_state(fresh_state(), mesh), pts, mask, jnp.zeros(3, jnp.int32),
        EYE3, mesh=mesh, **kw)
    return single, sharded, mesh, pts, mask


def test_projective_fusion_shard_invariance(fused_pair):
    single, sharded, *_ = fused_pair
    np.testing.assert_array_equal(np.asarray(single.value),
                                  np.asarray(sharded.value))
    np.testing.assert_array_equal(np.asarray(single.weight),
                                  np.asarray(sharded.weight))
    assert int(np.count_nonzero(np.asarray(single.weight))) > 5000


def test_packed_fields_shard_invariance(fused_pair):
    single, sharded, mesh, *_ = fused_pair
    one = precompute_fields_packed(single, tau=TAU)
    many = precompute_fields_packed_sharded(sharded, mesh=mesh, tau=TAU)
    np.testing.assert_array_equal(np.asarray(one.plane),
                                  np.asarray(many.plane))


def test_packed_fields_exact_shard_invariance(fused_pair):
    single, sharded, mesh, *_ = fused_pair
    one = precompute_fields_packed2(single)
    many = precompute_fields_packed_sharded(sharded, mesh=mesh, tau=TAU,
                                            exact=True)
    np.testing.assert_array_equal(np.asarray(one.plane_a),
                                  np.asarray(many.plane_a))
    np.testing.assert_array_equal(np.asarray(one.plane_b),
                                  np.asarray(many.plane_b))


def test_packed_registration_shard_invariance(fused_pair):
    single, sharded, mesh, pts, mask = fused_pair
    pert = np.eye(4, dtype=np.float32)
    pert[:3, 3] = [90, -60, 40]
    th = np.deg2rad(0.7)
    pert[:3, :3] = np.array([[np.cos(th), -np.sin(th), 0],
                             [np.sin(th), np.cos(th), 0], [0, 0, 1]],
                            np.float32)
    kw = dict(size=SIZE, resolution=RES, tau=TAU, max_iterations=50,
              epsilon=0.03)
    fields1 = precompute_fields_packed(single, tau=TAU)
    out1, it1, err1 = register_cloud_packed(
        fields1, single.pos, single.offset, pts, mask, jnp.asarray(pert),
        it_weight_gradient=0.1, **kw)
    fieldsN = precompute_fields_packed_sharded(sharded, mesh=mesh, tau=TAU)
    outN, itN, errN = register_cloud_packed_sharded(
        fieldsN, sharded.pos, sharded.offset, pts, mask, jnp.asarray(pert),
        mesh=mesh, **kw)
    # f32 psum order differs from the single-device matmul order: allow a
    # tiny numerical band, but the solution must be the same pose
    np.testing.assert_allclose(np.asarray(outN), np.asarray(out1),
                               rtol=1e-5, atol=2e-3)
    # and it actually corrected most of the perturbation
    assert np.linalg.norm(np.asarray(out1)[:3, 3]) < 40
    assert abs(int(itN) - int(it1)) <= 2


def test_packed_registration_sharded_gather_freeze(fused_pair):
    """Sharded gather_freeze converges to the same pose as single-chip
    gather_freeze (cache is shard-varying, loop replicated)."""
    single, sharded, mesh, pts, mask = fused_pair
    pert = np.eye(4, dtype=np.float32)
    pert[:3, 3] = [70, -50, 30]
    kw = dict(size=SIZE, resolution=RES, tau=TAU, max_iterations=50,
              epsilon=0.03)
    fields1 = precompute_fields_packed(single, tau=TAU)
    out1, _, _ = register_cloud_packed(
        fields1, single.pos, single.offset, pts, mask, jnp.asarray(pert),
        it_weight_gradient=0.1, gather_freeze=True, **kw)
    fieldsN = precompute_fields_packed_sharded(sharded, mesh=mesh, tau=TAU)
    outN, _, _ = register_cloud_packed_sharded(
        fieldsN, sharded.pos, sharded.offset, pts, mask, jnp.asarray(pert),
        mesh=mesh, gather_freeze=True, **kw)
    np.testing.assert_allclose(np.asarray(outN), np.asarray(out1),
                               rtol=1e-5, atol=2e-3)


def test_sharded_level_fusion_matches_single_chip_level():
    """The mesh fusion the sharded apps run (level beam grid inside the
    tilt envelope) equals the single-chip production sweep
    (fuse_cloud "projective-level") on the 8-device mesh, bit for bit,
    over two chained fusions from a slightly pitched sensor."""
    from warpsense.core.config import Params
    from warpsense.pipeline.fusion_backend import (fuse_cloud,
                                                   grid_rotation_for)

    params = Params.from_dict({
        "map": {"max_distance": TAU / 1000.0, "resolution": RES,
                "max_weight": 32},
        "lidar": {"channels": CH, "hresolution": COLS},
    })
    pts = jnp.asarray(room_cloud(seed=11))
    mask = jnp.ones((pts.shape[0],), bool)
    mesh = make_mesh(8)
    t = np.radians(1.0)                      # inside the 2-degree envelope
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = [[np.cos(t), 0, np.sin(t)], [0, 1, 0],
                    [-np.sin(t), 0, np.cos(t)]]
    single, sharded = fresh_state(), shard_state(fresh_state(), mesh)
    for shift_mm in ([0, 0, 0], [130, -70, 60]):
        pose[:3, 3] = shift_mm
        rot, level = grid_rotation_for(pose, 45.0)
        assert level
        single = fuse_cloud(single, pts, mask, pose, params=params,
                            size=SIZE, fusion="projective-level")
        sharded = tsdf_update_projective_sharded(
            sharded, pts, mask,
            jnp.asarray(np.floor(pose[:3, 3] / RES).astype(np.int32)), rot,
            mesh=mesh, size=SIZE, tau=TAU, max_weight=32 * WEIGHT_RESOLUTION,
            resolution=RES, channels=CH, columns=COLS, vfov_deg=45.0)
    np.testing.assert_array_equal(np.asarray(single.value),
                                  np.asarray(sharded.value))
    np.testing.assert_array_equal(np.asarray(single.weight),
                                  np.asarray(sharded.weight))
    assert int(np.count_nonzero(np.asarray(single.weight))) > 5000
