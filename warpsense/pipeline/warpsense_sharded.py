"""Multi-chip warpsense: the full pipeline application on a device mesh.

The reference has no distributed layer at all (SURVEY.md §2.7/§5.8 — its
analogous orchestration is ``App::cloud_callback``,
src/warpsense/app.cpp:65-117, plus the async shift thread,
src/warpsense/tsdf_mapping.cpp:97-136, on ONE GPU).  This module is that
orchestration at mesh scale — new capability:

* the TSDF window (value, weight) is x-block-sharded across a 1-D
  ``Mesh('x')``; ``pos``/``offset`` replicated (parallel/sharded.py);
* per scan: preprocess -> (gated) sharded projective fusion (zero
  communication — each shard sweeps its own slab) -> CACHED sharded
  packed-fields precompute (two boundary planes ride ICI via ppermute)
  -> sharded adaptive-LM registration (27 GN scalars psum'd, solve
  replicated) — the identical production algorithms the single-chip fast
  pipeline runs, so an N-device trajectory matches the 1-chip trajectory
  to collective-ordering noise (pinned in tests/test_sharded_app.py);
* the registration fields are cached ACROSS scans and invalidated only on
  fusion or shift — the same amortization as the single-chip app
  (pipeline/warpsense.py); the round-3 bare step function re-paid the
  precompute every scan;
* window shift runs through ``LocalMap.attach_device`` against the
  sharded state: only the evicted/loaded slabs move between devices and
  the host map store (O(slab); parity pinned in
  tests/test_sharded_shift.py), then the state is re-placed on the mesh;
* persistence, resume, IMU pretransform, monitor hooks, and profiling are
  inherited unchanged from ``WarpsenseApp`` — the orchestration IS the
  single-chip orchestration with the device seams overridden.
"""
from __future__ import annotations

from pathlib import Path

import jax.numpy as jnp
import numpy as np

from ..core.config import Params
from ..map.local_map import make_odd
from ..parallel.sharded import (make_mesh, precompute_fields_packed_sharded,
                                register_cloud_packed_sharded, shard_state,
                                tsdf_update_projective_sharded)
from .warpsense import WarpsenseApp


class ShardedWarpsenseApp(WarpsenseApp):
    """Warpsense on an N-device mesh — same callbacks, same behavior.

    ``mesh``: a 1-D ``jax.sharding.Mesh`` (default: all devices).  The
    window's x extent is rounded UP to a multiple of the mesh size (even
    extents use the floor-span convention, map/local_map.py); y/z are
    forced odd like the reference.  Requires ``registration.mode ==
    "fast"`` — the mesh layer implements the production generation.
    """

    def __init__(self, params: Params, mesh=None,
                 map_path: str | Path | None = None,
                 window_size: tuple[int, int, int] | None = None,
                 sync_shift: bool = False, **kwargs):
        """``sync_shift=False`` (the default): the window shift is
        OVERLAPPED via the staged design (map/local_map.py begin_shift /
        shift_io / finish_shift) — the worker thread performs host map
        IO only, while every device dispatch (evict gathers at the
        trigger, load scatters at the swap-in) stays on the main thread
        in program order with the registration collectives.  This keeps
        the reference's async-shift semantics (scans register on the old
        window during the swap; fusions queue, tsdf_mapping.cpp:97-136)
        WITHOUT the cross-thread collective-ordering hazard that the
        single-chip worker design would have on a real multi-chip mesh.
        ``sync_shift=True`` swaps synchronously at the triggering scan;
        multi-process runs are always synchronous (every process must
        swap at the same scan index)."""
        import jax
        self._sync_shift = bool(sync_shift)
        self._shift_plan = None
        self.mesh = mesh if mesh is not None else make_mesh()
        self._axis = self.mesh.axis_names[0]
        n = self.mesh.shape[self._axis]
        if params.registration.mode != "fast":
            raise ValueError(
                "ShardedWarpsenseApp runs the production (fast) generation;"
                f" got registration.mode={params.registration.mode!r}")
        if params.registration.coarse_iterations:
            raise ValueError(
                "coarse_iterations is not supported by the sharded "
                "registration (register_cloud_packed_sharded); set it to 0")
        if window_size is None:
            sv = params.map.size_voxels
            window_size = (-(-sv[0] // n) * n, make_odd(sv[1]),
                           make_odd(sv[2]))
        if window_size[0] % n:
            raise ValueError(
                f"window x extent {window_size[0]} must divide the "
                f"{n}-device mesh")
        # multi-process (multi-host) run: every process executes the same
        # callbacks on the same scans; slab IO is scoped to the array
        # x-rows THIS host's devices own (host_slab_bounds) and persists
        # into a per-process map file — together the files hold exactly
        # the single-process map (pinned in tests/test_distributed.py)
        self._multiprocess = jax.process_count() > 1
        if self._multiprocess:
            from ..parallel.distributed import host_slab_bounds
            self._slab_rows = host_slab_bounds(self.mesh, window_size)
            # the per-process suffix must also apply to the DEFAULT path:
            # multi-host pods share filesystems, and N processes
            # truncating one file would corrupt it
            if map_path is None:
                map_path = params.map.store_path()
            map_path = Path(map_path).with_suffix(
                f".p{jax.process_index()}")
        else:
            self._slab_rows = None
        # forward sync_shift: the base __init__ also assigns
        # self._sync_shift, and would otherwise overwrite the value set
        # above with its own default
        super().__init__(params, map_path=map_path, force_odd=False,
                         window_size=window_size, sync_shift=sync_shift,
                         **kwargs)

    # ----------------------------------------------------------- device seams
    def _place(self, state):
        """(value, weight) x-block-sharded over the mesh, pos/offset
        replicated — called at construction, resume, and after shifts."""
        if self._multiprocess:
            from ..parallel.distributed import shard_state_global
            if getattr(state.value, "is_fully_addressable", True) is False:
                return state               # already a global array
            return shard_state_global(state, self.mesh)
        return shard_state(state, self.mesh)

    def _register(self, pts, mask, pretransform) -> np.ndarray:
        m = self.params.map
        reg = self.params.registration
        if self._fields is None:
            self._fields = precompute_fields_packed_sharded(
                self.state, mesh=self.mesh, tau=m.tau,
                exact=self.exact_fields)
        transform, iters, err = register_cloud_packed_sharded(
            self._fields, self.state.pos, self.state.offset, pts, mask,
            jnp.asarray(pretransform), mesh=self.mesh,
            size=self.local_map.size, resolution=m.resolution, tau=m.tau,
            max_iterations=reg.max_iterations, epsilon=reg.epsilon,
            gather_freeze=reg.gather_freeze)
        self._last_reg_iters = iters
        self._last_reg_err = err
        return np.asarray(transform)

    def _update_tsdf(self, pts, mask, pose: np.ndarray | None = None) -> None:
        """Sharded projective fusion — LEVEL map-aligned beam grid inside
        the tilt envelope (the production binning; single-chip twin:
        fusion_backend's "projective-level" mode), the true
        sensor attitude beyond it (fusion_backend.grid_rotation_for)."""
        from .fusion_backend import grid_rotation_for
        m = self.params.map
        if pose is None:
            pose = self.pose
        scanner_pos = jnp.asarray(
            np.floor(np.asarray(pose)[:3, 3] / m.resolution)
            .astype(np.int32))
        grid_rot, _ = grid_rotation_for(pose, self.params.lidar.vfov)
        self.state = tsdf_update_projective_sharded(
            self.state, pts, mask, scanner_pos,
            grid_rot, mesh=self.mesh,
            size=self.local_map.size, tau=m.tau,
            max_weight=m.max_weight_scaled, resolution=m.resolution,
            channels=self.params.lidar.channels,
            columns=self.params.lidar.hresolution,
            vfov_deg=self.params.lidar.vfov)
        self._fields = None      # map changed: registration fields stale

    def _maybe_shift(self) -> None:
        """Window shift on the mesh — OVERLAPPED by default via the
        staged collective-safe design (worker = host IO only; see
        ``sync_shift`` in ``__init__``).  Multi-process runs are always
        synchronous: every process must swap at the same scan index, and
        slab IO is scoped to this host's rows (host_slab_bounds)."""
        m = self.params.map
        if not (self._multiprocess or self._sync_shift):
            # staged overlapped shift: device gathers HERE (main thread),
            # host IO on the worker, device scatters in _collect_shift
            import threading
            if self._shift_thread is not None:
                return                 # one shift in flight at a time
            dist = np.linalg.norm(
                (self.last_shift_pose[:3, 3] - self.pose[:3, 3]) / 1000.0)
            if dist < m.shift:
                return
            self._pre_shift_pose = self.last_shift_pose
            self.last_shift_pose = self.pose.copy()
            new_pos = np.floor(self.pose[:3, 3]
                               / m.resolution).astype(np.int64)
            if self.monitor is not None:
                self.monitor.publish_shift(new_pos)
            self.local_map.attach_device(self.state)
            self._shift_plan = self.local_map.begin_shift(new_pos)

            def work():
                try:
                    self.local_map.shift_io(self._shift_plan)
                except BaseException as e:   # surfaced in _collect_shift
                    self._shift_error = e
            self._shift_thread = threading.Thread(target=work, daemon=True)
            self._shift_thread.start()
            return
        dist = np.linalg.norm(
            (self.last_shift_pose[:3, 3] - self.pose[:3, 3]) / 1000.0)
        if dist < m.shift:
            return
        self.last_shift_pose = self.pose.copy()
        new_pos = np.floor(self.pose[:3, 3] / m.resolution).astype(np.int64)
        if self.monitor is not None:
            self.monitor.publish_shift(new_pos)
        self.local_map.attach_device(self.state, x_rows=self._slab_rows)
        self.local_map.shift(new_pos)
        self.state = self._place(self.local_map.detach_device())
        self.shifted = True
        self._fields = None      # window moved: registration fields stale

    def _finish_async_shift(self):
        """Staged swap-in: main-thread scatters of the worker-loaded
        slabs (collective-safe; see map/local_map.py finish_shift)."""
        plan, self._shift_plan = self._shift_plan, None
        return self.local_map.finish_shift(plan)

    def terminate(self, csv_path=None) -> None:
        """Persist map + poses.  Multi-process: each host flushes only its
        slab rows into its own file through the scoped attach path (the
        state is a global array the host cannot fully materialize)."""
        if not self._multiprocess:
            return super().terminate(csv_path)
        self.imu_buffer.clear()
        self.local_map.attach_device(self.state, x_rows=self._slab_rows)
        self.local_map.write_back()
        self.local_map.detach_device()
        if csv_path is not None:
            self.eval.export_results(csv_path)
        self.global_map.close()
