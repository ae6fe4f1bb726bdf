"""Window shift with a SHARDED device state attached: per-shard slab
eviction into the host map path must round-trip exactly like the
single-device shift (reference semantics: hdf5_local_map.cpp:53-118 +
tsdf_mapping.cpp:97-136, scaled to a mesh)."""
import jax
import jax.numpy as jnp
import numpy as np

from warpsense.core.consts import WEIGHT_RESOLUTION
from warpsense.map.global_map import GlobalMap
from warpsense.map.local_map import LocalMap
from warpsense.ops.tsdf_projective import tsdf_update_projective
from warpsense.parallel.sharded import (make_mesh, shard_state,
                                        tsdf_update_projective_sharded)

TAU, RES = 600, 64
SIZE = (80, 41, 41)


def _fused(tmp_path, name, sharded_mesh=None):
    gm = GlobalMap(tmp_path / f"{name}", TAU, 0)
    # force_odd=False: the mesh needs X divisible by 8 — even extents are
    # the supported multi-chip window shape (floor-span convention)
    lm = LocalMap(SIZE, gm, force_odd=False)
    rng = np.random.default_rng(11)
    pts = []
    for ax in range(3):
        for s in (-1, 1):
            p = np.stack([rng.uniform(-1100, 1100, 500),
                          rng.uniform(-1100, 1100, 500),
                          rng.uniform(-350, 350, 500)], axis=1)
            p[:, ax] = s * (350 if ax == 2 else 1100)
            pts.append(p)
    pts = jnp.asarray(np.round(np.concatenate(pts)).astype(np.int32))
    mask = jnp.ones((pts.shape[0],), bool)
    kw = dict(size=lm.size, tau=TAU, max_weight=32 * WEIGHT_RESOLUTION,
              resolution=RES, channels=32, columns=128, vfov_deg=45.0)
    state = lm.device_state()
    if sharded_mesh is not None:
        state = shard_state(state, sharded_mesh)
        state = tsdf_update_projective_sharded(
            state, pts, mask, jnp.zeros(3, jnp.int32),
            jnp.eye(3, dtype=jnp.float32), mesh=sharded_mesh, **kw)
    else:
        state = tsdf_update_projective(
            state, pts, mask, jnp.zeros(3, jnp.int32),
            jnp.eye(3, dtype=jnp.float32), **kw)
    return lm, gm, state


def test_sharded_shift_matches_single(tmp_path):
    mesh = make_mesh(8)

    lm1, gm1, st1 = _fused(tmp_path, "single")
    lm1.attach_device(st1)
    lm1.shift([12, -5, 3])
    out1 = lm1.detach_device()

    lmN, gmN, stN = _fused(tmp_path, "sharded", sharded_mesh=mesh)
    lmN.attach_device(stN)
    lmN.shift([12, -5, 3])
    outN = lmN.detach_device()

    np.testing.assert_array_equal(np.asarray(out1.value),
                                  np.asarray(outN.value))
    np.testing.assert_array_equal(np.asarray(out1.weight),
                                  np.asarray(outN.weight))
    np.testing.assert_array_equal(np.asarray(out1.pos), np.asarray(outN.pos))
    np.testing.assert_array_equal(np.asarray(out1.offset),
                                  np.asarray(outN.offset))

    # both persisted identical evicted slabs
    lm1.absorb(out1)
    lmN.absorb(outN)
    lm1.write_back()
    lmN.write_back()
    a1 = gm1.read_area(np.asarray([-45, -25, -25]), np.asarray([45, 25, 25]))
    aN = gmN.read_area(np.asarray([-45, -25, -25]), np.asarray([45, 25, 25]))
    np.testing.assert_array_equal(a1, aN)
    gm1.close()
    gmN.close()


def test_sharded_shift_then_fuse_again(tmp_path):
    """After a sharded shift the state can be re-placed on the mesh and
    fused again (the pipeline's steady-state loop)."""
    mesh = make_mesh(8)
    lm, gm, st = _fused(tmp_path, "loop", sharded_mesh=mesh)
    lm.attach_device(st)
    lm.shift([8, 0, 0])
    st = lm.detach_device()
    st = shard_state(st, mesh)
    pts = jnp.asarray(np.full((60, 3), 500, np.int32))
    mask = jnp.ones((60,), bool)
    st = tsdf_update_projective_sharded(
        st, pts, mask, jnp.asarray([8, 0, 0], jnp.int32),
        jnp.eye(3, dtype=jnp.float32), mesh=mesh, size=lm.size, tau=TAU,
        max_weight=32 * WEIGHT_RESOLUTION, resolution=RES, channels=32,
        columns=128, vfov_deg=45.0)
    assert int(np.asarray(st.pos)[0]) == 8
    assert np.isfinite(np.asarray(st.value, np.float32)).all()
    gm.close()


def test_scoped_shift_union_matches_unscoped(tmp_path):
    """x_rows-scoped slab IO (the multi-host contract): two half-window
    scopes shifting against separate files together persist exactly what
    the unscoped shift persists (ring wrap included)."""
    # unscoped reference
    lm1, gm1, st1 = _fused(tmp_path, "uns")
    lm1.attach_device(st1)
    lm1.shift([12, -5, 3])
    out1 = lm1.detach_device()
    lm1.attach_device(out1)
    lm1.write_back()
    area = (np.asarray([-45, -25, -25]), np.asarray([45, 25, 25]))
    ref = gm1.read_area(*area)
    gm1.close()

    halves = []
    for name, rows in (("h0", (0, 40)), ("h1", (40, 80))):
        lm, gm, st = _fused(tmp_path, name)
        lm.attach_device(st, x_rows=rows)
        lm.shift([12, -5, 3])
        out = lm.detach_device()
        lm.attach_device(out, x_rows=rows)
        lm.write_back()
        halves.append(gm.read_area(*area))
        gm.close()

    # union (weight != 0 wins; weight is the high half of the packed u32)
    h0, h1 = halves
    merged = np.where((h0 >> 16) != 0, h0, h1)
    w_ref = (ref >> 16) != 0
    np.testing.assert_array_equal(merged[w_ref], ref[w_ref])
    np.testing.assert_array_equal((merged >> 16) != 0, w_ref)


def test_staged_shift_matches_plain_shift(tmp_path):
    """The collective-safe staged shift (begin_shift / shift_io /
    finish_shift — device work on the caller, map IO anywhere) must
    produce exactly the window and global-map content of the axis-
    sequenced ``shift`` (round-5: the mesh app's default overlapped
    shift)."""
    mesh = make_mesh(8)
    new_pos = np.asarray([13, -7, 4])

    lm_a, gm_a, st_a = _fused(tmp_path, "plain", sharded_mesh=mesh)
    lm_a.attach_device(st_a)
    lm_a.shift(new_pos)
    st_a = lm_a.detach_device()

    lm_b, gm_b, st_b = _fused(tmp_path, "staged", sharded_mesh=mesh)
    lm_b.attach_device(st_b)
    plan = lm_b.begin_shift(new_pos)
    lm_b.shift_io(plan)          # (worker phase — host IO only)
    st_b = lm_b.finish_shift(plan)

    np.testing.assert_array_equal(np.asarray(st_a.value),
                                  np.asarray(st_b.value))
    np.testing.assert_array_equal(np.asarray(st_a.weight),
                                  np.asarray(st_b.weight))
    np.testing.assert_array_equal(np.asarray(st_a.pos), np.asarray(st_b.pos))
    np.testing.assert_array_equal(np.asarray(st_a.offset),
                                  np.asarray(st_b.offset))
    # evicted content persisted identically
    lm_a.absorb(st_a)
    lm_b.absorb(st_b)
    lm_a.write_back()
    lm_b.write_back()
    gm_a.close()
    gm_b.close()
    assert gm_a.chunk_tags() == gm_b.chunk_tags()
    for k in gm_a.chunk_tags():
        np.testing.assert_array_equal(gm_a.read_chunk(k), gm_b.read_chunk(k))


def test_box_diff_partitions_correctly():
    """A \\ B boxes are disjoint and exactly cover the difference."""
    rng = np.random.default_rng(3)
    for _ in range(50):
        a_s = rng.integers(-10, 5, 3)
        a_e = a_s + rng.integers(0, 9, 3)
        b_s = rng.integers(-10, 5, 3)
        b_e = b_s + rng.integers(0, 9, 3)
        boxes = LocalMap._box_diff(a_s, a_e, b_s, b_e)
        grid = np.zeros((30, 30, 30), int)

        def mark(g, s, e, v):
            g[s[0] + 12:e[0] + 13, s[1] + 12:e[1] + 13,
              s[2] + 12:e[2] + 13] += v

        expect = np.zeros_like(grid)
        mark(expect, a_s, a_e, 1)
        inter = np.zeros_like(grid)
        mark(inter, b_s, b_e, 1)
        expect = (expect == 1) & (inter == 0)
        for s, e in boxes:
            mark(grid, s, e, 1)
        assert np.array_equal(grid.astype(bool), expect)
        assert grid.max() <= 1, "boxes overlap"
