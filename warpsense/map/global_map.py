"""Persistent chunked global TSDF map (a directory of ``.npy`` files).

Same chunk schema as the reference's HDF5 map
(src/map/hdf5_global_map.cpp and
include/map/hdf5_constants.h), stored as plain numpy files so the map
needs nothing beyond numpy:

* ``<path>/map/x_y_z.npy`` — one uint32 array per 64^3 chunk, named by its
  chunk coordinates, C-order index ``x*CS^2 + y*CS + z``;
* ``<path>/poses/<n>.npy`` — one 7-float pose ``[tx, ty, tz, qx, qy, qz,
  qw]`` per scan, rounded to 3 decimals;
* ``<path>/meta.json`` — the map attributes (tau, map_size_*,
  max_distance, map_resolution, max_weight).

``python -m warpsense.eval.merge_maps`` exports a map to the reference's
HDF5 layout (``/map/x_y_z``, ``/poses/<n>/pose``) on hosts that have h5py.

Improvements over the reference (documented capability deltas):
* ``truncate=False`` reopens an existing map — true resume, which the
  reference cannot do (it always opens with Truncate,
  hdf5_global_map.cpp:5).
* chunk IO is vectorized numpy instead of per-cell loops.
"""
from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path

import numpy as np

from .tsdf_entry import pack

CHUNK_SIZE = 64
NUM_ACTIVE_CHUNKS = 64  # LRU capacity, parity hdf5_global_map.h

MAP_GROUP = "map"
POSES_GROUP = "poses"
META_FILE = "meta.json"
POSE_SIZE = 7


def tag_from_chunk_pos(pos) -> str:
    return f"{int(pos[0])}_{int(pos[1])}_{int(pos[2])}"


def _jsonable(v):
    return v.item() if isinstance(v, np.generic) else v


class GlobalMap:
    def __init__(self, path: str | Path, default_value: int, default_weight: int = 0,
                 truncate: bool = True, meta: dict | None = None):
        self.path = Path(path)
        self._map = self.path / MAP_GROUP
        self._poses = self.path / POSES_GROUP
        if truncate:
            # only the store's own entries: never the directory itself
            for d in (self._map, self._poses):
                shutil.rmtree(d, ignore_errors=True)
            (self.path / META_FILE).unlink(missing_ok=True)
        self._map.mkdir(parents=True, exist_ok=True)
        self._poses.mkdir(parents=True, exist_ok=True)
        # ONE lock around every store access + the LRU dict: the async
        # map-shift worker calls write_area/read_area while the main
        # thread writes poses every scan.  Coarse by design: uncontended
        # in the common path.
        self._lock = threading.RLock()
        self.default_value = int(default_value)
        self.default_weight = int(default_weight)
        self._num_poses = len(list(self._poses.glob("*.npy")))
        # LRU: chunk_pos tuple -> np.uint32[CS^3]; dict preserves insertion
        # order, move_to_end semantics implemented manually.
        self._active: dict[tuple[int, int, int], np.ndarray] = {}
        if meta:
            self.write_meta(meta)

    # ------------------------------------------------------------------ chunks
    def _chunk_file(self, tag: str) -> Path:
        return self._map / f"{tag}.npy"

    def _default_chunk(self) -> np.ndarray:
        raw = pack(np.int16(self.default_value), np.int16(self.default_weight))
        return np.full(CHUNK_SIZE ** 3, raw, dtype=np.uint32)

    def chunk_tags(self) -> list[str]:
        """Tags (``x_y_z``) of the chunks persisted so far."""
        with self._lock:
            return sorted(p.stem for p in self._map.glob("*.npy"))

    def read_chunk(self, tag: str) -> np.ndarray:
        """A persisted chunk's raw uint32 entries (flat, C-order)."""
        with self._lock:
            return np.load(self._chunk_file(tag)).reshape(-1)

    def activate_chunk(self, chunk_pos) -> np.ndarray:
        """Return the chunk's raw uint32 buffer, loading / LRU-evicting as
        needed (parity hdf5_global_map.cpp:59-137)."""
        with self._lock:
            key = (int(chunk_pos[0]), int(chunk_pos[1]), int(chunk_pos[2]))
            if key in self._active:
                chunk = self._active.pop(key)
                self._active[key] = chunk  # refresh recency
                return chunk
            f = self._chunk_file(tag_from_chunk_pos(key))
            if f.exists():
                chunk = np.load(f).astype(np.uint32).reshape(-1)
            else:
                chunk = self._default_chunk()
            if len(self._active) >= NUM_ACTIVE_CHUNKS:
                old_key, old_chunk = next(iter(self._active.items()))
                del self._active[old_key]
                self._store(old_key, old_chunk)
            self._active[key] = chunk
            return chunk

    def _store(self, key, chunk: np.ndarray) -> None:
        np.save(self._chunk_file(tag_from_chunk_pos(key)), chunk)

    def get_value_raw(self, pos) -> int:
        pos = np.asarray(pos, dtype=np.int64)
        chunk_pos = np.floor_divide(pos, CHUNK_SIZE)
        chunk = self.activate_chunk(chunk_pos)
        local = pos - chunk_pos * CHUNK_SIZE
        idx = int(local[0]) * CHUNK_SIZE * CHUNK_SIZE + int(local[1]) * CHUNK_SIZE + int(local[2])
        return int(chunk[idx])

    def set_value_raw(self, pos, raw: int) -> None:
        pos = np.asarray(pos, dtype=np.int64)
        chunk_pos = np.floor_divide(pos, CHUNK_SIZE)
        chunk = self.activate_chunk(chunk_pos)
        local = pos - chunk_pos * CHUNK_SIZE
        idx = int(local[0]) * CHUNK_SIZE * CHUNK_SIZE + int(local[1]) * CHUNK_SIZE + int(local[2])
        chunk[idx] = np.uint32(raw)

    # --------------------------------------------------------------- bulk area
    def read_area(self, start, end) -> np.ndarray:
        """Raw uint32 block for the inclusive global-coordinate box
        [start, end] — vectorized per-chunk copies."""
        start = np.asarray(start, dtype=np.int64)
        end = np.asarray(end, dtype=np.int64)
        shape = tuple((end - start + 1).tolist())
        out = np.empty(shape, dtype=np.uint32)
        self._for_each_chunk(start, end, out, save=False)
        return out

    def write_area(self, start, block: np.ndarray) -> None:
        """Write a raw uint32 block with its minimum corner at ``start``."""
        start = np.asarray(start, dtype=np.int64)
        end = start + np.asarray(block.shape, dtype=np.int64) - 1
        self._for_each_chunk(start, end, np.ascontiguousarray(block), save=True)

    def _for_each_chunk(self, start, end, block: np.ndarray, save: bool) -> None:
        cs = CHUNK_SIZE
        c0 = np.floor_divide(start, cs)
        c1 = np.floor_divide(end, cs)
        with self._lock:
            self._for_each_chunk_locked(c0, c1, start, end, block, save)

    def _for_each_chunk_locked(self, c0, c1, start, end, block, save):
        cs = CHUNK_SIZE
        for cx in range(c0[0], c1[0] + 1):
            for cy in range(c0[1], c1[1] + 1):
                for cz in range(c0[2], c1[2] + 1):
                    chunk = self.activate_chunk((cx, cy, cz)).reshape(cs, cs, cs)
                    lo = np.maximum(start, np.array([cx, cy, cz]) * cs)
                    hi = np.minimum(end, np.array([cx, cy, cz]) * cs + cs - 1)
                    csl = tuple(slice(int(lo[i] - [cx, cy, cz][i] * cs),
                                      int(hi[i] - [cx, cy, cz][i] * cs) + 1) for i in range(3))
                    bsl = tuple(slice(int(lo[i] - start[i]), int(hi[i] - start[i]) + 1) for i in range(3))
                    if save:
                        chunk[csl] = block[bsl]
                    else:
                        block[bsl] = chunk[csl]

    # ------------------------------------------------------------------- poses
    def write_pose(self, translation, quat_xyzw, scale: float = 1.0) -> None:
        t = np.asarray(translation, dtype=np.float32) / float(scale)
        q = np.asarray(quat_xyzw, dtype=np.float32)
        vals = np.round(np.concatenate([t, q]) * 1000.0) / 1000.0
        with self._lock:
            np.save(self._poses / f"{self._num_poses}.npy",
                    vals.astype(np.float32))
            self._num_poses += 1

    def read_poses(self) -> np.ndarray:
        with self._lock:
            out = [np.load(self._poses / f"{i}.npy").astype(np.float32)
                   for i in range(self._num_poses)]
            return (np.stack(out) if out
                    else np.zeros((0, POSE_SIZE), np.float32))

    # -------------------------------------------------------------------- meta
    def write_meta(self, meta: dict) -> None:
        with self._lock:
            cur = self.read_meta()
            cur.update({k: _jsonable(v) for k, v in meta.items()})
            (self.path / META_FILE).write_text(json.dumps(cur))

    def read_meta(self) -> dict:
        f = self.path / META_FILE
        return json.loads(f.read_text()) if f.exists() else {}

    # ---------------------------------------------------------------- lifetime
    def write_back(self) -> None:
        with self._lock:
            for key, chunk in self._active.items():
                self._store(key, chunk)

    def close(self) -> None:
        self.write_back()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
