"""Golden-value TSDF line test — port of the reference test/map.cpp
`tsdf_write`/`tsdf_read` (single point at (5.5, 0.5, 0.5) m, exact
value/weight asserted per cell along the ray) plus a map-store round trip."""
import numpy as np
import pytest

from warpsense.core.consts import MATRIX_RESOLUTION, WEIGHT_RESOLUTION
from warpsense.map.global_map import GlobalMap
from warpsense.map.local_map import LocalMap
from warpsense.ops.tsdf_reference import (calc_weight,
                                          update_tsdf_reference)

TAU = 3000
RESOLUTION = 1000
MAX_WEIGHT = 10 * WEIGHT_RESOLUTION
MAP_SIZE = (20, 20, 20)

EXPECTED = {
    (1, 0, 0): TAU,
    (2, 0, 0): TAU,
    (3, 0, 0): 2000,
    (4, 0, 0): 1000,
    (5, 0, 0): 0,
    (6, 0, 0): -1000,
    (7, 0, 0): -2000,
}


def run_update(tmp_path, name="golden"):
    gm = GlobalMap(tmp_path / name, TAU, 0)
    lm = LocalMap(MAP_SIZE, gm)
    points = np.array([[5500, 500, 500]], dtype=np.int64)
    pos = np.zeros(3, dtype=np.int64)
    up = np.array([0, 0, MATRIX_RESOLUTION], dtype=np.int64)
    # test/map.cpp uses the CPU-flavor update (scanner at voxel corner)
    update_tsdf_reference(points, pos, up, lm, TAU, MAX_WEIGHT, RESOLUTION,
                          pos_mode="corner")
    return gm, lm


def test_tsdf_write_golden(tmp_path):
    gm, lm = run_update(tmp_path)
    for cell, value in EXPECTED.items():
        v, w = lm.value_at(cell)
        assert v == value, f"cell {cell}: value {v} != {value}"
        assert w == calc_weight(value, TAU), f"cell {cell}: weight {w}"
    v, w = lm.value_at((8, 0, 0))
    assert (v, w) == (TAU, 0)  # untouched default


def test_tsdf_read_roundtrip(tmp_path):
    """Write the map out, reread raw chunks, verify the same golden line
    (parity with test/map.cpp `tsdf_read`)."""
    from warpsense.map.tsdf_entry import unpack
    from warpsense.map.global_map import CHUNK_SIZE

    gm, lm = run_update(tmp_path, "roundtrip")
    lm.write_back()
    gm.close()

    found = {}
    for tag in gm.chunk_tags():
        cx, cy, cz = (int(t) for t in tag.split("_"))
        v, w = unpack(gm.read_chunk(tag))
        v = v.reshape(CHUNK_SIZE, CHUNK_SIZE, CHUNK_SIZE)
        w = w.reshape(CHUNK_SIZE, CHUNK_SIZE, CHUNK_SIZE)
        ii, jj, kk = np.nonzero(w > 0)
        for i, j, k in zip(ii, jj, kk):
            found[(cx * CHUNK_SIZE + i, cy * CHUNK_SIZE + j,
                   cz * CHUNK_SIZE + k)] = (int(v[i, j, k]), int(w[i, j, k]))
    for cell, value in EXPECTED.items():
        assert cell in found
        assert found[cell] == (value, calc_weight(value, TAU))


def test_tsdf_weight_never_increases_past_max(tmp_path):
    gm = GlobalMap(tmp_path / "w", TAU, 0)
    lm = LocalMap(MAP_SIZE, gm)
    points = np.array([[5500, 500, 500]], dtype=np.int64)
    pos = np.zeros(3, dtype=np.int64)
    up = np.array([0, 0, MATRIX_RESOLUTION], dtype=np.int64)
    for _ in range(15):
        update_tsdf_reference(points, pos, up, lm, TAU, MAX_WEIGHT, RESOLUTION,
                              pos_mode="corner")
    v, w = lm.value_at((5, 0, 0))
    assert v == 0
    assert w == MAX_WEIGHT
