"""Native C++ runtime: build, queue semantics, preprocess + slab parity."""
import threading

import numpy as np
import pytest

from warpsense.native import load as load_native

lib = load_native()
needs_native = pytest.mark.skipif(lib is None,
                                  reason="native toolchain unavailable")


@needs_native
def test_version():
    assert lib.ws_version() == 1


@needs_native
def test_byte_queue_fifo_and_force():
    from warpsense.utils.native_queue import NativeByteQueue

    q = NativeByteQueue(2, lib)
    assert q.push(b"a") and q.push(b"b")
    assert not q.push(b"c")                  # full, non-blocking
    assert q.push(b"c", force=True)          # drops oldest
    assert q.pop() == b"b"
    assert q.pop() == b"c"
    assert q.pop() is None
    assert len(q) == 0


@needs_native
def test_byte_queue_blocking_producer_consumer():
    from warpsense.utils.native_queue import NativeByteQueue

    q = NativeByteQueue(4, lib)
    got = []

    def consumer():
        while True:
            item = q.pop(timeout=2.0)
            if item == b"STOP":
                break
            got.append(item)

    t = threading.Thread(target=consumer)
    t.start()
    for i in range(50):
        assert q.push(f"item{i}".encode(), timeout=2.0)
    q.push(b"STOP", timeout=2.0)
    t.join(timeout=5.0)
    assert got == [f"item{i}".encode() for i in range(50)]


def test_scan_queue_roundtrip_any_backend():
    from warpsense.utils.native_queue import ScanQueue

    q = ScanQueue(4)
    cloud = np.random.default_rng(0).normal(0, 1, (8, 16, 3)).astype(np.float32)
    assert q.push(1.5, cloud, timeout=1.0)
    item = q.pop(timeout=1.0)
    assert item is not None
    stamp, got = item
    assert stamp == 1.5
    np.testing.assert_array_equal(got, cloud)


def test_preprocess_host_matches_device():
    import jax.numpy as jnp

    from warpsense.ops.preprocess import preprocess, preprocess_host

    rng = np.random.default_rng(5)
    pts = rng.uniform(-5, 5, (2000, 3)).astype(np.float32)
    # keep points off voxel boundaries so float/int snapping agrees
    pts = np.round(pts, 2) + 0.007
    cap = 2048
    pad = np.zeros((cap - len(pts), 3), np.float32)
    cloud = np.concatenate([pts, pad])
    valid = np.concatenate([np.ones(len(pts), bool), np.zeros(len(pad), bool)])

    d_pts, d_mask = preprocess(jnp.asarray(cloud), jnp.asarray(valid),
                               jnp.eye(4, dtype=jnp.float32),
                               resolution=64, capacity=cap)
    h_pts, h_mask = preprocess_host(cloud, resolution=64, capacity=cap)
    d_set = {tuple(p) for p in np.asarray(d_pts)[np.asarray(d_mask)].tolist()}
    h_set = {tuple(p) for p in h_pts[h_mask].tolist()}
    assert d_set == h_set
    assert len(d_set) > 500


@needs_native
def test_slab_gather_scatter_matches_numpy(tmp_path):
    """Native save/load area must produce the identical global map + window
    as the pure-numpy path across a multi-axis shift."""
    from warpsense.map.global_map import GlobalMap
    from warpsense.map.local_map import LocalMap

    rng = np.random.default_rng(7)

    def build(name, disable_native):
        gm = GlobalMap(tmp_path / name, 600, 0)
        lm = LocalMap((9, 9, 9), gm)
        if disable_native:
            lm._native = None
        lm.state.value[:] = rng.integers(-600, 600, lm.state.value.shape,
                                         dtype=np.int16)
        lm.state.weight[:] = rng.integers(0, 64, lm.state.weight.shape,
                                          dtype=np.int16)
        return gm, lm

    rng = np.random.default_rng(7)
    gm_a, a = build("native", disable_native=False)
    rng = np.random.default_rng(7)
    gm_b, b = build("numpy", disable_native=True)
    assert a._native is not None, "native lib should be loaded in this test"

    for target in ([5, -3, 2], [-2, 4, -6], [0, 0, 0]):
        a.shift(target)
        b.shift(target)
        np.testing.assert_array_equal(a.state.value, b.state.value)
        np.testing.assert_array_equal(a.state.weight, b.state.weight)
    a.write_back()
    b.write_back()
    gm_a.close()
    gm_b.close()

    assert gm_a.chunk_tags() == gm_b.chunk_tags()
    for k in gm_a.chunk_tags():
        np.testing.assert_array_equal(gm_a.read_chunk(k), gm_b.read_chunk(k))
