"""Shard-count invariance: N-device result == single-device result.

The reference has no distributed layer to test (SURVEY.md §4); this is the
new multi-chip capability's core guarantee, run on the 8-device virtual CPU
mesh from conftest.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from warpsense.core.consts import MATRIX_RESOLUTION, WEIGHT_RESOLUTION
from warpsense.map.local_map import LocalMapState
from warpsense.ops.registration import register_cloud
from warpsense.ops.tsdf import plan_raymarch, tsdf_update
from warpsense.parallel.sharded import (make_mesh, register_cloud_sharded,
                                        shard_state, tsdf_update_sharded)

TAU = 600
RES = 64
SIZE = (80, 41, 41)   # X divisible by the 8-device mesh
UP = jnp.asarray([0, 0, MATRIX_RESOLUTION], jnp.int32)


def room_cloud(n=4000, half=1200.0, seed=3):
    rng = np.random.default_rng(seed)
    pts = []
    for ax in range(3):
        for s in (-1, 1):
            p = rng.uniform(-half, half, size=(n // 6, 3))
            p[:, ax] = s * half
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
    assert len(jax.devices()) >= 8, "conftest should provide 8 cpu devices"
    pts = jnp.asarray(room_cloud())
    mask = jnp.ones((pts.shape[0],), bool)
    ms, mi = plan_raymarch(TAU, RES, 4000)

    single = tsdf_update(fresh_state(), pts, mask, jnp.zeros(3, jnp.int32),
                         UP, size=SIZE, tau=TAU,
                         max_weight=32 * WEIGHT_RESOLUTION, resolution=RES,
                         max_steps=ms, max_isteps=mi)

    mesh = make_mesh(8)
    sharded = tsdf_update_sharded(
        shard_state(fresh_state(), mesh), pts, mask, jnp.zeros(3, jnp.int32),
        UP, mesh=mesh, size=SIZE, tau=TAU,
        max_weight=32 * WEIGHT_RESOLUTION, resolution=RES,
        max_steps=ms, max_isteps=mi)
    return single, sharded, mesh, pts, mask


def test_tsdf_shard_invariance(fused_pair):
    single, sharded, *_ = fused_pair
    np.testing.assert_array_equal(np.asarray(single.value),
                                  np.asarray(sharded.value))
    np.testing.assert_array_equal(np.asarray(single.weight),
                                  np.asarray(sharded.weight))
    assert int(np.count_nonzero(np.asarray(single.weight))) > 10000


def test_registration_shard_invariance(fused_pair):
    single, sharded, mesh, pts, mask = fused_pair
    pert = np.eye(4, dtype=np.float32)
    pert[:3, 3] = [90, -60, 40]
    th = np.deg2rad(0.7)
    pert[:3, :3] = np.array([[np.cos(th), -np.sin(th), 0],
                             [np.sin(th), np.cos(th), 0], [0, 0, 1]],
                            np.float32)
    kw = dict(size=SIZE, resolution=RES, max_iterations=60,
              it_weight_gradient=0.1, epsilon=0.0)
    out1 = np.asarray(register_cloud(single, pts, mask, jnp.asarray(pert),
                                     **kw))
    outN = np.asarray(register_cloud_sharded(sharded, pts, mask,
                                             jnp.asarray(pert), mesh=mesh,
                                             **kw))
    np.testing.assert_allclose(outN, out1, rtol=1e-5, atol=2e-3)
    # and it actually corrected most of the perturbation
    assert np.linalg.norm(out1[:3, 3]) < 80
