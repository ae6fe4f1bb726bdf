"""Device TSDF kernel vs exact host twin — the parity strategy the reference
uses for CUDA (test/cuda.cpp validates every kernel against cpu/)."""
import numpy as np
import jax.numpy as jnp
import pytest

from warpsense.core.consts import MATRIX_RESOLUTION, WEIGHT_RESOLUTION
from warpsense.map.global_map import GlobalMap
from warpsense.map.local_map import LocalMap
from warpsense.ops.tsdf import tsdf_update, plan_raymarch, encode_key, decode_key
from warpsense.ops.tsdf_reference import update_tsdf_reference, calc_weight

TAU = 3000
RESOLUTION = 1000
MAX_WEIGHT = 10 * WEIGHT_RESOLUTION
MAP_SIZE = (21, 21, 21)
UP = np.array([0, 0, MATRIX_RESOLUTION], dtype=np.int64)


def make_map(tmp_path, name):
    gm = GlobalMap(tmp_path / name, TAU, 0)
    return LocalMap(MAP_SIZE, gm)


def device_update(lm, points, pos_mode="corner", max_range=20000):
    max_steps, max_isteps = plan_raymarch(TAU, RESOLUTION, max_range)
    n = points.shape[0]
    pts = jnp.asarray(points, dtype=jnp.int32)
    mask = jnp.ones((n,), dtype=bool)
    state = lm.device_state()
    out = tsdf_update(state, pts, mask, jnp.zeros(3, jnp.int32),
                      jnp.asarray(UP, jnp.int32),
                      size=lm.size, tau=TAU, max_weight=MAX_WEIGHT,
                      resolution=RESOLUTION, max_steps=max_steps,
                      max_isteps=max_isteps, pos_mode=pos_mode)
    return out


def test_key_codec_roundtrip():
    v = jnp.asarray([0, 5, -5, 3000, -3000, 1], dtype=jnp.int32)
    w = jnp.asarray([64, -64, 1, -1, 23, 64], dtype=jnp.int32)
    v2, w2 = decode_key(encode_key(v, w))
    np.testing.assert_array_equal(np.asarray(v), np.asarray(v2))
    np.testing.assert_array_equal(np.asarray(w), np.asarray(w2))


def test_key_order_matches_lattice():
    # positive weight beats negative; then smaller |value| wins
    a = int(encode_key(jnp.int32(100), jnp.int32(64)))
    b = int(encode_key(jnp.int32(50), jnp.int32(-64)))
    assert a < b
    c = int(encode_key(jnp.int32(50), jnp.int32(64)))
    assert c < a


def test_device_golden_line(tmp_path):
    """Single-point golden line must be exact on the device path too."""
    lm = make_map(tmp_path, "dev_golden")
    out = device_update(lm, np.array([[5500, 500, 500]]), max_range=12000)
    expected = {1: TAU, 2: TAU, 3: 2000, 4: 1000, 5: 0, 6: -1000, 7: -2000}
    c = np.asarray(out.offset)  # pos=0 -> array coord = offset + x mod size
    for x, val in expected.items():
        ax = (x + int(c[0])) % lm.size[0]
        v = int(np.asarray(out.value)[ax, c[1], c[2]])
        w = int(np.asarray(out.weight)[ax, c[1], c[2]])
        assert v == val, f"cell {x}: {v} != {val}"
        assert w == calc_weight(val, TAU)
    ax = (8 + int(c[0])) % lm.size[0]
    assert int(np.asarray(out.value)[ax, c[1], c[2]]) == TAU
    assert int(np.asarray(out.weight)[ax, c[1], c[2]]) == 0


def test_device_matches_reference_random_cloud(tmp_path):
    """Statistical parity on a random cloud: the float32 device path may
    flip knife-edge voxels; demand >=97% exact agreement and no weight-sign
    disagreements among the rest."""
    rng = np.random.default_rng(42)
    n = 40
    pts = np.stack([
        rng.integers(2000, 9000, size=n),
        rng.integers(-6000, 6000, size=n),
        rng.integers(-3000, 3000, size=n),
    ], axis=1).astype(np.int64)

    lm_ref = make_map(tmp_path, "ref")
    update_tsdf_reference(pts, np.zeros(3, np.int64), UP, lm_ref, TAU,
                          MAX_WEIGHT, RESOLUTION, pos_mode="corner")
    ref_v = np.asarray(lm_ref.state.value)
    ref_w = np.asarray(lm_ref.state.weight)

    lm_dev = make_map(tmp_path, "dev")
    out = device_update(lm_dev, pts, max_range=16000)
    dev_v = np.asarray(out.value)
    dev_w = np.asarray(out.weight)

    touched = (ref_w != 0) | (dev_w != 0)
    n_touched = int(touched.sum())
    assert n_touched > 100
    same = (ref_v == dev_v) & (ref_w == dev_w)
    agree = float((same & touched).sum()) / n_touched
    assert agree >= 0.97, f"device/reference agreement {agree:.3f}"


def test_device_averaging_accumulates(tmp_path):
    lm = make_map(tmp_path, "acc")
    state = device_update(lm, np.array([[5500, 500, 500]]), max_range=12000)
    lm.absorb(state)
    state2 = device_update(lm, np.array([[5500, 500, 500]]), max_range=12000)
    c = np.asarray(state2.offset)
    ax = (5 + int(c[0])) % lm.size[0]
    assert int(np.asarray(state2.weight)[ax, c[1], c[2]]) == 2 * WEIGHT_RESOLUTION
    assert int(np.asarray(state2.value)[ax, c[1], c[2]]) == 0


def test_device_matches_reference_exactly_at_long_range(tmp_path):
    """Rays of 20-55 m: squared distances and direction * length products
    overflow int32 and round in float32, yet the march must reproduce the
    integer reference voxel for voxel (exact int32 helpers in ops/tsdf.py;
    the old float32 stepping flipped knife-edge voxels)."""
    size = (121, 121, 41)
    rng = np.random.default_rng(3)
    n = 48
    r = rng.uniform(20000, 55000, n)
    az = rng.uniform(-np.pi, np.pi, n)
    pts = np.stack([r * np.cos(az), r * np.sin(az),
                    rng.uniform(-15000, 15000, n)], axis=1).astype(np.int64)

    lm_ref = LocalMap(size, GlobalMap(tmp_path / "ref", TAU, 0))
    update_tsdf_reference(pts, np.zeros(3, np.int64), UP, lm_ref, TAU,
                          MAX_WEIGHT, RESOLUTION, pos_mode="corner")
    lm_dev = LocalMap(size, GlobalMap(tmp_path / "dev", TAU, 0))
    max_steps, max_isteps = plan_raymarch(TAU, RESOLUTION, 60000)
    out = tsdf_update(lm_dev.device_state(), jnp.asarray(pts, jnp.int32),
                      jnp.ones((n,), bool), jnp.zeros(3, jnp.int32),
                      jnp.asarray(UP, jnp.int32), size=lm_dev.size, tau=TAU,
                      max_weight=MAX_WEIGHT, resolution=RESOLUTION,
                      max_steps=max_steps, max_isteps=max_isteps,
                      pos_mode="corner")
    ref_w = np.asarray(lm_ref.state.weight)
    assert int(np.count_nonzero(ref_w)) > 1000
    np.testing.assert_array_equal(np.asarray(out.value),
                                  np.asarray(lm_ref.state.value))
    np.testing.assert_array_equal(np.asarray(out.weight), ref_w)


def test_device_matches_reference_exactly_on_axis_rays(tmp_path):
    """Rays along the negative axes and diagonals put direction * length /
    distance exactly on integers, where a float32 ratio lands one below
    and flips the voxel; the int32 helpers keep the march exact."""
    tau, res = 600, 64
    size = (161, 161, 41)
    pts = []
    for d in range(3000, 5100, 37):
        pts += [[-d, 0, 0], [0, -d, 0], [-d, -d, 0], [d, -d, 100],
                [-d, d // 3, -d // 7]]
    pts = np.asarray(pts, np.int64)
    lm_ref = LocalMap(size, GlobalMap(tmp_path / "ref", tau, 0))
    update_tsdf_reference(pts, np.zeros(3, np.int64), UP, lm_ref, tau,
                          MAX_WEIGHT, res)
    lm_dev = LocalMap(size, GlobalMap(tmp_path / "dev", tau, 0))
    max_steps, max_isteps = plan_raymarch(tau, res, 8000)
    out = tsdf_update(lm_dev.device_state(), jnp.asarray(pts, jnp.int32),
                      jnp.ones((len(pts),), bool), jnp.zeros(3, jnp.int32),
                      jnp.asarray(UP, jnp.int32), size=lm_dev.size, tau=tau,
                      max_weight=MAX_WEIGHT, resolution=res,
                      max_steps=max_steps, max_isteps=max_isteps)
    np.testing.assert_array_equal(np.asarray(out.value),
                                  np.asarray(lm_ref.state.value))
    np.testing.assert_array_equal(np.asarray(out.weight),
                                  np.asarray(lm_ref.state.weight))
