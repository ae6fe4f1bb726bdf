"""Local/global map tests — ports the reference's test/map.cpp `map_raw`
golden scenario (ring shifts, chunk layout) plus ring-index property
tests against the reference overflow() semantics."""
import numpy as np
import jax.numpy as jnp
import pytest

from warpsense.map.global_map import GlobalMap, CHUNK_SIZE
from warpsense.map.local_map import LocalMap, ring_index, in_bounds
from warpsense.map.tsdf_entry import pack, unpack

DEFAULT_VALUE = 4
DEFAULT_WEIGHT = 6


def reference_overflow(val, maxv):
    # parity: include/map/hdf5_local_map.h:4-19
    if val >= 2 * maxv:
        return val - 2 * maxv
    if val >= maxv:
        return val - maxv
    return val


def reference_get_index(p, pos, offset, size):
    x = reference_overflow(p[0] - pos[0] + offset[0] + size[0], size[0]) * size[1] * size[2]
    y = reference_overflow(p[1] - pos[1] + offset[1] + size[1], size[1]) * size[2]
    z = reference_overflow(p[2] - pos[2] + offset[2] + size[2], size[2])
    return x + y + z


def test_ring_index_matches_reference():
    rng = np.random.default_rng(0)
    size = (5, 7, 9)
    for _ in range(50):
        pos = rng.integers(-100, 100, size=3)
        offset = rng.integers(0, np.asarray(size), size=3)
        # all in-bounds points
        p = pos + rng.integers(-2, 3, size=3)
        ours = int(ring_index(jnp.asarray(p), jnp.asarray(pos), jnp.asarray(offset), size))
        theirs = reference_get_index(p, pos, offset, size)
        assert ours == theirs


def test_entry_pack_roundtrip():
    v = np.asarray([0, 1, -1, 32767, -32768, 1234], dtype=np.int16)
    w = np.asarray([0, -1, 64, -64, 100, -100], dtype=np.int16)
    v2, w2 = unpack(pack(v, w))
    np.testing.assert_array_equal(v, v2)
    np.testing.assert_array_equal(w, w2)


@pytest.fixture
def local_map(tmp_path):
    gm = GlobalMap(tmp_path / "test", DEFAULT_VALUE, DEFAULT_WEIGHT)
    return LocalMap((5, 5, 5), gm)


def test_map_raw_golden(local_map):
    """Port of test/map.cpp `map_raw` (test/map.cpp:240-365)."""
    lm = local_map
    entries = {(-2, 2, 0): (0, 0), (-1, 2, 0): (1, 1), (-2, 1, 0): (2, 1),
               (-1, 1, 0): (3, 2), (-2, 0, 0): (4, 3), (-1, 0, 0): (5, 5)}
    for p, (v, w) in entries.items():
        lm.set_value_at(p, v, w)

    assert np.asarray(lm.state.pos).tolist() == [0, 0, 0]
    assert lm.size == (5, 5, 5)
    assert np.asarray(lm.state.offset).tolist() == [2, 2, 2]

    assert bool(in_bounds(jnp.asarray([0, 2, -2]), lm.state.pos, jnp.asarray(lm.size)))
    assert not bool(in_bounds(jnp.asarray([22, 0, 0]), lm.state.pos, jnp.asarray(lm.size)))
    assert lm.value_at((0, 0, 0)) == (DEFAULT_VALUE, DEFAULT_WEIGHT)
    assert lm.value_at((-1, 2, 0)) == (1, 1)

    # ---- shift far +x (chunk gets evicted to the global map)
    for x in (5, 10, 15, 20, 24):
        lm.shift((x, 0, 0))
    assert np.asarray(lm.state.pos).tolist() == [24, 0, 0]
    assert np.asarray(lm.state.offset).tolist() == [26 % 5, 2, 2]
    assert not bool(in_bounds(jnp.asarray([0, 2, -2]), lm.state.pos, jnp.asarray(lm.size)))
    assert bool(in_bounds(jnp.asarray([22, 0, 0]), lm.state.pos, jnp.asarray(lm.size)))
    assert lm.value_at((24, 0, 0)) == (DEFAULT_VALUE, DEFAULT_WEIGHT)

    # ---- shift directions
    lm.set_value_at((24, 0, 0), 24, 0)
    lm.shift((24, 5, 0)); lm.set_value_at((24, 5, 0), 24, 5)
    lm.shift((19, 5, 0)); lm.set_value_at((19, 5, 0), 19, 5)
    lm.shift((19, 0, 0)); lm.set_value_at((19, 0, 0), 19, 0)
    lm.shift((24, 0, 0)); assert lm.value_at((24, 0, 0)) == (24, 0)
    lm.shift((19, 0, 0)); assert lm.value_at((19, 0, 0)) == (19, 0)
    lm.shift((24, 5, 0)); assert lm.value_at((24, 5, 0)) == (24, 5)
    lm.shift((19, 5, 0)); assert lm.value_at((19, 5, 0)) == (19, 5)
    lm.shift((24, 0, 0)); assert lm.value_at((24, 0, 0)) == (24, 0)

    # ---- shift back
    for x in (19, 14, 9, 4, 0):
        lm.shift((x, 0, 0))
    assert np.asarray(lm.state.pos).tolist() == [0, 0, 0]
    assert np.asarray(lm.state.offset).tolist() == [2, 2, 2]
    assert lm.value_at((0, 0, 0)) == (DEFAULT_VALUE, DEFAULT_WEIGHT)
    assert lm.value_at((-1, 2, 0)) == (1, 1)


def test_write_back_and_chunk_layout(tmp_path):
    """Chunk layout parity with the reference's HDF5 schema: map/x_y_z
    uint32 arrays, C-order CS^3."""
    gm = GlobalMap(tmp_path / "layout", 100, 0)
    lm = LocalMap((5, 5, 5), gm)
    lm.set_value_at((1, 2, 0), 42, 7)
    lm.write_back()
    gm.close()
    d = np.load(tmp_path / "layout" / "map" / "0_0_0.npy")
    assert d.dtype == np.uint32 and d.shape == (CHUNK_SIZE ** 3,)
    idx = 1 * CHUNK_SIZE * CHUNK_SIZE + 2 * CHUNK_SIZE + 0
    v, w = unpack(d[idx])
    assert (int(v), int(w)) == (42, 7)


def test_global_map_resume(tmp_path):
    path = tmp_path / "resume"
    gm = GlobalMap(path, 100, 0)
    gm.set_value_raw((70, 0, 0), pack(np.int16(-5), np.int16(9)))
    gm.write_pose([1.0, 2.0, 3.0], [0, 0, 0, 1])
    gm.close()
    gm2 = GlobalMap(path, 100, 0, truncate=False)
    v, w = unpack(gm2.get_value_raw((70, 0, 0)))
    assert (int(v), int(w)) == (-5, 9)
    poses = gm2.read_poses()
    assert poses.shape == (1, 7)
    np.testing.assert_allclose(poses[0, :3], [1, 2, 3])
    gm2.write_pose([4.0, 5.0, 6.0], [0, 0, 0, 1])
    assert gm2.read_poses().shape == (2, 7)
    gm2.close()


def test_lru_eviction_persists(tmp_path):
    gm = GlobalMap(tmp_path / "lru", 0, 0)
    # touch more chunks than the LRU can hold
    for i in range(80):
        gm.set_value_raw((i * CHUNK_SIZE, 0, 0), i + 1)
    for i in range(80):
        assert gm.get_value_raw((i * CHUNK_SIZE, 0, 0)) == i + 1
    gm.close()


def test_shift_beyond_window_hops_correctly(local_map):
    """A move beyond the window extent walks there in window-sized hops
    (round-5 robustness: a diverged pose or far resume degrades to a
    window reload instead of a crashed run).  Content must equal a fresh
    reload at the destination."""
    v0, w0 = local_map.value_at((1, 1, 0))
    local_map.shift((17, -13, 0))            # several window spans away
    assert tuple(local_map.state.pos) == (17, -13, 0)
    # original content persisted to the global map and reloads exactly
    local_map.shift((0, 0, 0))
    assert local_map.value_at((1, 1, 0)) == (v0, w0)


def test_absorb_then_shift_mutable(tmp_path):
    """absorb() must deep-copy device arrays: jax arrays view as read-only
    numpy and shift() mutates the host mirror in place (regression)."""
    import jax.numpy as jnp
    from warpsense.map.global_map import GlobalMap
    from warpsense.map.local_map import LocalMap, LocalMapState

    gm = GlobalMap(tmp_path / "absorb", 600, 0)
    lm = LocalMap((7, 7, 7), gm)
    state = LocalMapState(*(jnp.asarray(x) for x in lm.state))
    lm.absorb(state)
    lm.shift([2, 1, 0])   # raised ValueError before the fix
    assert tuple(lm.state.pos.tolist()) == (2, 1, 0)


def test_device_backed_shift_matches_host_shift(tmp_path):
    """attach_device slab-only shift == the host-mirror shift: same window
    content after the same shift sequence, same evictions."""
    import jax.numpy as jnp
    from warpsense.map.local_map import LocalMapState

    rng = np.random.default_rng(7)
    size = (13, 13, 13)
    v = rng.integers(-600, 600, size).astype(np.int16)
    w = rng.integers(0, 32, size).astype(np.int16)

    def build(path):
        gm = GlobalMap(path, 600, 0)
        lm = LocalMap(size, gm)
        lm.state.value[...] = v
        lm.state.weight[...] = w
        return lm

    # host path
    lm_h = build(tmp_path / "host")
    for p in ((5, 0, 0), (5, -3, 2), (-1, -3, 2)):
        lm_h.shift(p)

    # device-backed path (same data as jnp arrays)
    lm_d = build(tmp_path / "dev")
    state = LocalMapState(value=jnp.asarray(v), weight=jnp.asarray(w),
                          pos=jnp.zeros(3, jnp.int32),
                          offset=jnp.asarray([s // 2 for s in size],
                                             jnp.int32))
    for p in ((5, 0, 0), (5, -3, 2), (-1, -3, 2)):
        lm_d.attach_device(state)
        lm_d.shift(p)
        state = lm_d.detach_device()

    np.testing.assert_array_equal(np.asarray(state.value), lm_h.state.value)
    np.testing.assert_array_equal(np.asarray(state.weight), lm_h.state.weight)
    np.testing.assert_array_equal(np.asarray(state.pos), lm_h.state.pos)
    np.testing.assert_array_equal(np.asarray(state.offset),
                                  lm_h.state.offset)


def test_merge_maps_exports_hdf5(tmp_path):
    """merge_maps writes the reference's HDF5 schema (/map/x_y_z uint32
    datasets with the meta attributes, /poses/<n>/pose) from a map store,
    for the tools that read it; the store itself needs no h5py."""
    h5py = pytest.importorskip("h5py")
    from warpsense.eval.merge_maps import merge

    gm = GlobalMap(tmp_path / "run", 100, 0, meta={"tau": 600})
    lm = LocalMap((5, 5, 5), gm)
    lm.set_value_at((1, 2, 0), 42, 7)
    lm.write_back()
    gm.write_pose([1.0, 2.0, 3.0], [0.0, 0.0, 0.0, 1.0])
    gm.close()
    stats = merge([tmp_path / "run"], tmp_path / "run.h5")
    assert stats == {"inputs": 1, "chunks": len(gm.chunk_tags()), "poses": 1}
    with h5py.File(tmp_path / "run.h5", "r") as f:
        assert int(f["map"].attrs["tau"]) == 600
        for tag in gm.chunk_tags():
            np.testing.assert_array_equal(f["map"][tag][...],
                                          gm.read_chunk(tag))
        np.testing.assert_allclose(f["poses"]["0"]["pose"][...],
                                   [1, 2, 3, 0, 0, 0, 1])
