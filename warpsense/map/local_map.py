"""Ring-buffer local TSDF map as a functional state.

JAX re-design of the reference's ``HDF5LocalMap`` / ``cuda::DeviceMap``
pair (include/map/hdf5_local_map.h, include/warpsense/cuda/device_map.h):

* the dense window is two int16 arrays (value, weight) of shape (X, Y, Z) —
  sizes forced odd like the reference (src/map/hdf5_local_map.cpp:6-20);
* ring indexing ``array = (global - pos + offset) mod size`` is a pure
  function (equivalent to the reference's triple ``overflow()`` wrap,
  device_map.h:94-101 — proven equal in tests/test_map.py);
* ``shift`` evicts only the vacated slabs to the global map and loads
  the newly visible slabs (the reference instead round-trips the whole
  window over PCIe, src/warpsense/tsdf_mapping.cpp:116-123 — here only the
  slabs move between device and host).

Two layers:
* pure jnp functions (``ring_index``/``in_bounds``/...) used inside jitted
  device kernels, and
* a host ``LocalMap`` shell (numpy state + GlobalMap IO) that owns
  shift/write_back.  The pipeline keeps a device-resident mirror of the
  (value, weight) arrays; the host copy is synced around shifts only.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .global_map import GlobalMap
from .tsdf_entry import pack, unpack


class LocalMapState(NamedTuple):
    """Functional local-map state (a pytree; leaves may be np or jnp)."""
    value: jax.Array   # (X, Y, Z) int16 — TSDF value, mm
    weight: jax.Array  # (X, Y, Z) int16 — fixed-point weight
    pos: jax.Array     # (3,) int32 — global voxel coords of window center
    offset: jax.Array  # (3,) int32 — ring offset of the center cell


def make_odd(n: int) -> int:
    return n if n % 2 == 1 else n + 1


def create_state(size: tuple[int, int, int], default_value: int,
                 default_weight: int = 0, xp=np,
                 force_odd: bool = True) -> LocalMapState:
    """``force_odd=False`` permits even extents (multi-chip deployments
    shard the x-axis over the mesh, which needs divisibility, not parity);
    an even axis spans the asymmetric [pos - s/2, pos + (s-1)/2] box —
    every bounds/coords helper here uses that floor convention, which
    collapses to the reference's symmetric odd window when s is odd."""
    size = tuple((make_odd(int(s)) if force_odd else int(s)) for s in size)
    return LocalMapState(
        value=xp.full(size, default_value, dtype=xp.int16),
        weight=xp.full(size, default_weight, dtype=xp.int16),
        pos=xp.zeros((3,), dtype=xp.int32),
        offset=xp.asarray([s // 2 for s in size], dtype=xp.int32),
    )


# --------------------------------------------------------------- pure indexing
# (jnp code, safe inside jit; mirrored below in numpy for the host shell)

def ring_coords(points, pos, offset, size):
    """Global voxel coords (..., 3) -> array coords (..., 3)."""
    return jnp.mod(points - pos + offset, jnp.asarray(size))


def ring_index(points, pos, offset, size: tuple[int, int, int]):
    """Global voxel coords (..., 3) -> flat index into the (X,Y,Z) array."""
    a = ring_coords(points, pos, offset, size)
    return a[..., 0] * (size[1] * size[2]) + a[..., 1] * size[2] + a[..., 2]


def in_bounds(points, pos, size, buffer=0):
    """Per-point bool: inside the window, shrunk (buffer>0) or grown
    (buffer<0) — covers the reference's in_bounds / _with_buffer_neg /
    _with_buffer_pos trio (device_map.h:109-128).  Floor convention: an
    even axis spans [pos - s/2, pos + (s-1)/2] (identical to the odd
    symmetric window when s is odd)."""
    d = points - pos
    sz = jnp.asarray(size)
    lo = -(sz // 2) + buffer
    hi = (sz - 1) // 2 - buffer
    return jnp.all((d >= lo) & (d <= hi), axis=-1)


# ------------------------------------------------------------- host-side shell

class LocalMap:
    """Host orchestration shell around a numpy LocalMapState + GlobalMap.

    Owns shift / write_back (host IO); per-scan device compute consumes a
    jnp copy of the state (see warpsense/pipeline).
    """

    def __init__(self, size: tuple[int, int, int], global_map: GlobalMap,
                 force_odd: bool = True):
        self.size = tuple((make_odd(int(s)) if force_odd else int(s))
                          for s in size)
        self.global_map = global_map
        self.state = create_state(self.size, global_map.default_value,
                                  global_map.default_weight, xp=np,
                                  force_odd=force_odd)
        from ..native import load as _load_native
        self._native = _load_native()
        self._dev: LocalMapState | None = None
        self._dev_local = None          # (v, w) numpy slab (multi-host)
        self._x_scope: tuple[int, int] | None = None

    # -------------------------------------------------- device-backed mode
    def attach_device(self, state: LocalMapState,
                      x_rows: tuple[int, int] | None = None) -> None:
        """Enter device-backed mode: shift/write_back slab IO reads from and
        writes to ``state``'s DEVICE arrays directly — per shift only the
        evicted/loaded slabs move between device and host (O(slab), not
        O(window); the reference instead round-trips the whole window over
        PCIe, tsdf_mapping.cpp:116-123).  While attached, the host numpy
        mirror is NOT maintained (value_at and friends reflect stale data);
        ``detach_device`` returns the updated device state.

        ``x_rows=(lo, hi)``: restrict slab IO to ARRAY x-rows [lo, hi) —
        the multi-host contract (parallel.distributed.host_slab_bounds):
        each process evicts/loads/persists only the rows its devices own.
        When the state is a multi-process global array (not fully
        addressable), the owned rows are staged through a host-local numpy
        slab (this host's shards) and re-assembled into a global array at
        detach — O(host slab) per shift, still 1/n_hosts of the
        reference's full-window PCIe round-trip."""
        self._x_scope = x_rows
        addressable = getattr(state.value, "is_fully_addressable", True)
        self._dev_local = None
        if not addressable:
            if x_rows is None:
                raise ValueError(
                    "multi-process global state needs x_rows "
                    "(host_slab_bounds) to scope slab IO")
            lo, hi = x_rows
            v = np.empty((hi - lo,) + tuple(state.value.shape[1:]), np.int16)
            w = np.empty_like(v)
            for sv, sw in zip(state.value.addressable_shards,
                              state.weight.addressable_shards):
                r = sv.index[0]
                v[r.start - lo:r.stop - lo] = np.asarray(sv.data)
                w[r.start - lo:r.stop - lo] = np.asarray(sw.data)
            self._dev_local = (v, w)
            self._dev_template = (state.value, state.weight)
        self._dev = LocalMapState(
            value=state.value, weight=state.weight,
            pos=np.asarray(state.pos, np.int32).copy(),
            offset=np.asarray(state.offset, np.int32).copy())
        # shift() mutates self.state.pos/offset in place; keep them in sync
        self.state.pos[:] = self._dev.pos
        self.state.offset[:] = self._dev.offset

    def detach_device(self) -> LocalMapState:
        dev = self._dev
        self._dev = None
        self._x_scope = None
        if self._dev_local is not None:
            vloc, wloc = self._dev_local
            self._dev_local = None
            tv, tw = self._dev_template
            # drop the template reference: it pins the PRE-shift global
            # device buffers (hundreds of MB at production windows)
            self._dev_template = None

            def rebuild(template, local):
                import jax as _jax
                start = min(s.index[0].start
                            for s in template.addressable_shards)
                bufs = [
                    _jax.device_put(
                        local[s.index[0].start - start:
                              s.index[0].stop - start], s.device)
                    for s in template.addressable_shards]
                return _jax.make_array_from_single_device_arrays(
                    template.shape, template.sharding, bufs)

            return LocalMapState(
                value=rebuild(tv, vloc), weight=rebuild(tw, wloc),
                pos=jnp.asarray(self.state.pos),
                offset=jnp.asarray(self.state.offset))
        return LocalMapState(
            value=dev.value, weight=dev.weight,
            pos=jnp.asarray(self.state.pos),
            offset=jnp.asarray(self.state.offset))

    def _dev_slab_index(self, start, end):
        pos = self.state.pos.astype(np.int64)
        off = self.state.offset.astype(np.int64)
        axes = []
        for i in range(3):
            rng = np.arange(start[i], end[i] + 1, dtype=np.int64)
            axes.append(jnp.asarray((rng - pos[i] + off[i]) % self.size[i]))
        return axes

    def _dev_gather(self, start, end):
        ax, ay, az = self._dev_slab_index(start, end)
        v = jnp.take(jnp.take(jnp.take(self._dev.value, ax, axis=0),
                              ay, axis=1), az, axis=2)
        w = jnp.take(jnp.take(jnp.take(self._dev.weight, ax, axis=0),
                              ay, axis=1), az, axis=2)
        return np.asarray(v, np.int16), np.asarray(w, np.int16)

    def _dev_scatter(self, start, end, v, w) -> None:
        ax, ay, az = self._dev_slab_index(start, end)
        ix = jnp.ix_(ax, ay, az)
        self._dev = self._dev._replace(
            value=self._dev.value.at[ix].set(jnp.asarray(v, jnp.int16)),
            weight=self._dev.weight.at[ix].set(jnp.asarray(w, jnp.int16)))

    # numpy twins of the pure functions ------------------------------------
    def _coords(self, p: np.ndarray) -> np.ndarray:
        return (p - self.state.pos + self.state.offset) % np.asarray(self.size)

    def _in_bounds(self, p: np.ndarray) -> bool:
        return bool(np.all(np.abs(p - self.state.pos) <= np.asarray(self.size) // 2))

    def value_at(self, p) -> tuple[int, int]:
        p = np.asarray(p, dtype=np.int64)
        if not self._in_bounds(p):
            raise IndexError(f"index out of local-map bounds: {p.tolist()}")
        a = self._coords(p)
        return (int(self.state.value[a[0], a[1], a[2]]),
                int(self.state.weight[a[0], a[1], a[2]]))

    def set_value_at(self, p, value: int, weight: int) -> None:
        p = np.asarray(p, dtype=np.int64)
        if not self._in_bounds(p):
            raise IndexError(f"index out of local-map bounds: {p.tolist()}")
        a = self._coords(p)
        self.state.value[a[0], a[1], a[2]] = np.int16(value)
        self.state.weight[a[0], a[1], a[2]] = np.int16(weight)

    # ------------------------------------------------------------------- shift
    def _area_array_index(self, start: np.ndarray, end: np.ndarray):
        """np.ix_ index of array coords covering the inclusive global box."""
        pos = np.asarray(self.state.pos)
        off = np.asarray(self.state.offset)
        axes = []
        for i in range(3):
            rng = np.arange(start[i], end[i] + 1, dtype=np.int64)
            axes.append(((rng - pos[i] + off[i]) % self.size[i]).astype(np.int64))
        return np.ix_(*axes)

    def _native_args(self, start, end, raw):
        import ctypes
        i16p = ctypes.POINTER(ctypes.c_int16)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        size = np.asarray(self.size, np.int32)
        pos = np.asarray(self.state.pos, np.int32)
        off = np.asarray(self.state.offset, np.int32)
        start = np.ascontiguousarray(start, np.int64)
        end = np.ascontiguousarray(end, np.int64)
        return (self.state.value.ctypes.data_as(i16p),
                self.state.weight.ctypes.data_as(i16p),
                size.ctypes.data_as(i32p), pos.ctypes.data_as(i32p),
                off.ctypes.data_as(i32p), start.ctypes.data_as(i64p),
                end.ctypes.data_as(i64p), raw.ctypes.data_as(u32p),
                (size, pos, off, start, end))  # keep temporaries alive

    def _x_runs(self, start, end):
        """Split the global x range [start[0], end[0]] into runs whose
        ARRAY rows fall inside the x scope (ring-aware: a contiguous
        global range maps to at most a handful of scoped runs); one run
        covering everything when unscoped."""
        if self._x_scope is None:
            return [(int(start[0]), int(end[0]))]
        lo, hi = self._x_scope
        pos = int(self.state.pos[0])
        off = int(self.state.offset[0])
        X = self.size[0]
        runs, cur = [], None
        for gx in range(int(start[0]), int(end[0]) + 1):
            if lo <= (gx - pos + off) % X < hi:
                if cur is None:
                    cur = [gx, gx]
                else:
                    cur[1] = gx
            elif cur is not None:
                runs.append(tuple(cur))
                cur = None
        if cur is not None:
            runs.append(tuple(cur))
        return runs

    def _local_axes(self, start, end):
        pos = self.state.pos.astype(np.int64)
        off = self.state.offset.astype(np.int64)
        axes = []
        for i in range(3):
            rng = np.arange(start[i], end[i] + 1, dtype=np.int64)
            axes.append(((rng - pos[i] + off[i]) % self.size[i]))
        lo, _ = self._x_scope
        return np.ix_(axes[0] - lo, axes[1], axes[2])

    def _save_area(self, start, end) -> None:
        start = np.asarray(start, np.int64)
        end = np.asarray(end, np.int64)
        for gx0, gx1 in self._x_runs(start, end):
            s, e = start.copy(), end.copy()
            s[0], e[0] = gx0, gx1
            self._save_area_run(s, e)

    def _save_area_run(self, start, end) -> None:
        if self._dev is not None:
            if self._dev_local is not None:
                ix = self._local_axes(start, end)
                v, w = self._dev_local[0][ix], self._dev_local[1][ix]
            else:
                v, w = self._dev_gather(start, end)
            self.global_map.write_area(start, pack(v, w))
            return
        if self._native is not None:
            raw = np.empty(tuple((end - start + 1).tolist()), np.uint32)
            *args, keep = self._native_args(start, end, raw)
            self._native.ws_ring_gather(*args)
            self.global_map.write_area(start, raw)
            return
        ix = self._area_array_index(start, end)
        self.global_map.write_area(
            np.asarray(start), pack(self.state.value[ix], self.state.weight[ix]))

    def _load_area(self, start, end) -> None:
        start = np.asarray(start, np.int64)
        end = np.asarray(end, np.int64)
        for gx0, gx1 in self._x_runs(start, end):
            s, e = start.copy(), end.copy()
            s[0], e[0] = gx0, gx1
            self._load_area_run(s, e)

    def _load_area_run(self, start, end) -> None:
        raw = self.global_map.read_area(start, end)
        if self._dev is not None:
            v, w = unpack(raw)
            if self._dev_local is not None:
                ix = self._local_axes(start, end)
                self._dev_local[0][ix] = v
                self._dev_local[1][ix] = w
            else:
                self._dev_scatter(start, end, v, w)
            return
        if self._native is not None:
            raw = np.ascontiguousarray(raw, np.uint32)
            *args, keep = self._native_args(start, end, raw)
            self._native.ws_ring_scatter(*args)
            return
        v, w = unpack(raw)
        ix = self._area_array_index(start, end)
        self.state.value[ix] = v
        self.state.weight[ix] = w

    def shift(self, new_pos) -> None:
        """Re-center the window on ``new_pos`` (global voxel coords).

        Axis-by-axis: save the vacated slab to the global map, advance
        pos/offset, load the newly visible slab
        (parity src/map/hdf5_local_map.cpp:53-118).
        """
        new_pos = np.asarray(new_pos, dtype=np.int64)
        size = np.asarray(self.size, dtype=np.int64)
        for axis in range(3):
            # a move beyond the window extent (a diverged pose, or a resume
            # far from the last window) is walked in window-sized hops —
            # each hop's save/load is exact, so arbitrary distances stay
            # correct instead of killing the run (robustness over the
            # reference's implicit small-shift assumption)
            while int(new_pos[axis] - self.state.pos[axis]) != 0:
                pos = np.asarray(self.state.pos, dtype=np.int64)
                full = int(new_pos[axis] - pos[axis])
                diff = int(np.clip(full, -self.size[axis], self.size[axis]))
                self._shift_axis(axis, diff, size)

    def _shift_axis(self, axis: int, diff: int, size) -> None:
        """One axis hop (|diff| <= size[axis]): save vacated, advance,
        load visible."""
        pos = np.asarray(self.state.pos, dtype=np.int64)
        start = pos - size // 2
        end = pos + (size - 1) // 2
        if diff > 0:
            end[axis] = start[axis] + diff - 1
        else:
            start[axis] = end[axis] + diff + 1
        self._save_area(start, end)

        self.state.pos[axis] += diff
        self.state.offset[axis] = (self.state.offset[axis] + diff) \
            % self.size[axis]

        pos = np.asarray(self.state.pos, dtype=np.int64)
        start = pos - size // 2
        end = pos + (size - 1) // 2
        if diff > 0:
            start[axis] = end[axis] - (diff - 1)
        else:
            end[axis] = start[axis] - diff - 1
        self._load_area(start, end)

    # -------------------------------------------- overlapped (staged) shift
    #
    # The single-chip app may run ``shift`` on a worker thread (its device
    # dispatches are safe with one device), but on a multi-device mesh a
    # second thread's gather/scatter programs can reorder against the main
    # thread's collectives and diverge across devices.  The staged shift
    # keeps EVERY device dispatch on the calling (main) thread:
    #   begin_shift  (main)   gather the evicted boxes off the device
    #   shift_io     (worker) map writes + reads only — no device work
    #   finish_shift (main)   advance pos/offset, scatter the loaded boxes
    # Box set-differences make the phases order-free: array coords of a
    # fixed global voxel are invariant under (pos, offset) advancing
    # together, so the O∩N interior never moves and the evicted (O\N) and
    # loaded (N\O) regions are disjoint — equivalent to the axis-sequenced
    # ``shift`` (reference semantics hdf5_local_map.cpp:53-118), which
    # interleaves IO with the axis walk instead.

    @staticmethod
    def _box_diff(a_start, a_end, b_start, b_end):
        """Disjoint inclusive boxes covering A \\ B (axis peeling)."""
        boxes = []
        cur_s = np.asarray(a_start, np.int64).copy()
        cur_e = np.asarray(a_end, np.int64).copy()
        for ax in range(3):
            if cur_e[ax] < b_start[ax] or cur_s[ax] > b_end[ax]:
                boxes.append((cur_s.copy(), cur_e.copy()))   # fully outside
                return boxes
            if cur_s[ax] < b_start[ax]:
                s, e = cur_s.copy(), cur_e.copy()
                e[ax] = b_start[ax] - 1
                boxes.append((s, e))
                cur_s[ax] = b_start[ax]
            if cur_e[ax] > b_end[ax]:
                s, e = cur_s.copy(), cur_e.copy()
                s[ax] = b_end[ax] + 1
                boxes.append((s, e))
                cur_e[ax] = b_end[ax]
        return boxes                      # remaining core lies inside B

    def begin_shift(self, new_pos) -> dict:
        """Phase 1/3 (call on the MAIN thread, device attached): gather
        the evicted boxes to host memory.  Returns the shift plan."""
        if self._dev is None or self._dev_local is not None:
            raise RuntimeError("begin_shift needs attach_device without an "
                               "x-row scope (multi-process shifts are "
                               "synchronous)")
        new_pos = np.asarray(new_pos, np.int64)
        pos = np.asarray(self.state.pos, np.int64)
        size = np.asarray(self.size, np.int64)
        # no distance guard: the box set-difference is exact at ANY
        # distance (a move beyond the window evicts all of O and loads
        # all of N) — a diverged pose degrades to a window reload, not a
        # crashed run
        o_s, o_e = pos - size // 2, pos + (size - 1) // 2
        n_s, n_e = new_pos - size // 2, new_pos + (size - 1) // 2
        evict = [(s, e) + self._dev_gather(s, e)
                 for s, e in self._box_diff(o_s, o_e, n_s, n_e)]
        return {"new_pos": new_pos, "evict": evict,
                "load_boxes": self._box_diff(n_s, n_e, o_s, o_e),
                "loaded": None}

    def shift_io(self, plan: dict) -> None:
        """Phase 2/3 (safe on a WORKER thread): pure host map IO."""
        for s, e, v, w in plan["evict"]:
            self.global_map.write_area(np.asarray(s), pack(v, w))
        plan["loaded"] = [
            (s, e) + unpack(self.global_map.read_area(s, e))
            for s, e in plan["load_boxes"]]

    def finish_shift(self, plan: dict) -> LocalMapState:
        """Phase 3/3 (MAIN thread): advance pos/offset, scatter the loaded
        boxes into the device state, detach."""
        size = np.asarray(self.size, np.int64)
        diff = plan["new_pos"] - np.asarray(self.state.pos, np.int64)
        self.state.pos[:] = plan["new_pos"].astype(np.int32)
        self.state.offset[:] = ((self.state.offset + diff) % size
                                ).astype(np.int32)
        for s, e, v, w in plan["loaded"]:
            self._dev_scatter(s, e, v, w)
        return self.detach_device()

    def write_back(self) -> None:
        pos = np.asarray(self.state.pos, dtype=np.int64)
        size = np.asarray(self.size, dtype=np.int64)
        self._save_area(pos - size // 2, pos + (size - 1) // 2)
        self.global_map.write_back()

    def load_window(self, pos) -> None:
        """Center the window on ``pos`` and fill it from the global map —
        the resume path the reference lacks (it only ever truncates,
        hdf5_global_map.cpp:5)."""
        pos = np.asarray(pos, dtype=np.int64)
        size = np.asarray(self.size, dtype=np.int64)
        self.state.pos[:] = pos.astype(np.int32)
        self.state.offset[:] = (size // 2).astype(np.int32)
        self._load_area(pos - size // 2, pos + (size - 1) // 2)

    # ----------------------------------------------------------- device bridge
    def device_state(self) -> LocalMapState:
        """jnp copy of the state for jitted kernels."""
        return LocalMapState(*(jnp.asarray(x) for x in self.state))

    def absorb(self, state: LocalMapState) -> None:
        """Copy a (device) state back into the host mirror after updates."""
        # np.array (not asarray): jax arrays view as read-only numpy, and
        # shift()/load_area mutate the host mirror in place.
        self.state = LocalMapState(
            value=np.array(state.value, dtype=np.int16),
            weight=np.array(state.weight, dtype=np.int16),
            pos=np.array(state.pos, dtype=np.int32),
            offset=np.array(state.offset, dtype=np.int32),
        )
