"""Fastsense pipeline: the reference's third SLAM app.

Behavioral parity with `src/cpu/fastsense.cpp` — the monolithic
"warpsense_cpu" node whose distinguishing features (vs. warpsense) are its
*orchestration*, not its math:

* registration runs EVERY scan against the currently-published map while
  TSDF update + map shift + visualization run asynchronously in a side
  thread over a copy-on-write map clone, triggered every
  ``update_frequency`` scans or ``update_distance`` meters
  (fastsense.cpp:88-118, 239-254);
* the IMU pretransform comes from the *orientation difference* of
  (Madgwick-)filtered absolute orientations, not gyro integration
  (fastsense.cpp:181-212);
* SIGINT-style terminate joins the side thread and persists map + poses
  (fastsense.cpp:58-86).

Redesign: the reference clones the whole 600 MB local map so the
OpenMP registration can keep reading the old one while the clone shifts and
updates (copy ctor hdf5_local_map.cpp:22-31).  Here map state is an
immutable device pytree, so copy-on-write is free — the worker builds a NEW
``LocalMapState`` (host ring shift + functional ``tsdf_update``) and swaps
the (state, registration-fields) pair under a lock; in-flight registrations
keep their snapshot by construction.  The compute ops are the same jitted
device ops as warpsense (run them on the CPU backend for the literal
"fastsense on host cores" configuration).
"""
from __future__ import annotations

import threading
from pathlib import Path

import jax.numpy as jnp
import numpy as np

from ..core.config import Params
from ..map.global_map import GlobalMap
from ..map.local_map import LocalMap
from ..obs.profiler import RuntimeEvaluator
from ..ops.preprocess import preprocess
from ..ops.registration import precompute_fields, register_cloud_fields
from ..ops.tsdf_projective import tsdf_update_projective
from ..utils.imu import ImuOrientationDiff, ImuSample
from ..utils.ring_buffer import ConcurrentRingBuffer


def _mat_to_quat_np(R: np.ndarray) -> np.ndarray:
    from ..core import geometry
    return np.asarray(geometry.mat_to_quat(jnp.asarray(R, jnp.float32)))


class FastsenseApp:
    """Single-process fastsense loop: inline registration, async mapping.

    ``update_frequency`` / ``update_distance_m``: the shift-update-visualize
    gate (every 100 scans or 0.25 m in the reference, fastsense.cpp:239-243).
    ``viz_dir``: when set, the worker exports a TSDF PLY per update — the
    stand-in for the reference's RViz marker publish (fastsense.cpp:112-116).
    """

    def __init__(self, params: Params, map_path: str | Path | None = None,
                 capacity: int = 32768, update_frequency: int = 100,
                 update_distance_m: float = 0.25,
                 viz_dir: str | Path | None = None, profile: bool = False):
        self.params = params
        self.capacity = int(capacity)
        self.update_frequency = int(update_frequency)
        self.update_distance_m = float(update_distance_m)
        self.viz_dir = Path(viz_dir) if viz_dir is not None else None
        self.profile = profile
        m = params.map
        path = Path(map_path) if map_path is not None else m.store_path()
        self.global_map = GlobalMap(path, m.tau, m.initial_weight, meta={
            "tau": m.tau, "map_resolution": m.resolution,
            "max_weight": m.max_weight_scaled,
            "max_distance": m.max_distance,
            "map_size_x": m.size_voxels[0], "map_size_y": m.size_voxels[1],
            "map_size_z": m.size_voxels[2],
        })
        self.local_map = LocalMap(m.size_voxels, self.global_map)

        # (state, fields) snapshot published to the registration path; only
        # the worker thread replaces it (copy-on-write swap, fastsense.cpp:105-109)
        self._snap_lock = threading.Lock()
        self.state = self.local_map.device_state()
        self._fields = None

        self.pose = np.eye(4, dtype=np.float32)     # mm translation
        self.initialized = False
        self.scan_count = 0
        self.last_update_pose = np.eye(4, dtype=np.float32)
        self.path: list[np.ndarray] = []

        self.imu_buffer = ConcurrentRingBuffer(1000)
        self.imu_diff = ImuOrientationDiff(self.imu_buffer)
        # raw gyro+accel samples are filtered in-process — the role of the
        # reference's external imu_filter_madgwick node (imu_filter.launch)
        from ..utils.imu import MadgwickFilter
        self.madgwick = MadgwickFilter()

        self._jobs = ConcurrentRingBuffer(1)
        self._jobs_submitted = 0
        self._jobs_done = 0
        self._done_cv = threading.Condition()
        self._worker = threading.Thread(target=self._worker_run, daemon=True)
        self._worker_running = True
        self._worker.start()
        self.eval = RuntimeEvaluator.get_instance()

    # ------------------------------------------------------------- callbacks
    def imu_callback(self, sample: ImuSample,
                     linear_acceleration=None) -> None:
        """Buffer an orientation-carrying IMU sample (fastsense.cpp:120-125:
        the node subscribes the madgwick-filtered topic and uses
        msg.orientation directly).  A RAW sample (``orientation is None``)
        is run through the in-process Madgwick filter first —
        ``linear_acceleration`` then provides the gravity observation
        (parity with launch/imu_filter.launch wiring)."""
        if sample.orientation is None:
            accel = (np.zeros(3) if linear_acceleration is None
                     else linear_acceleration)
            sample = self.madgwick.filter_sample(sample, accel)
        self.imu_buffer.push_nb(sample, force=True)

    def cloud_callback(self, cloud_m: np.ndarray, stamp: float) -> np.ndarray:
        """One scan (fastsense.cpp:127-254).  Returns the new 4x4 pose (mm)."""
        prof = self.eval if self.profile else None
        if prof:
            prof.start("total")
        m = self.params.map
        flat = np.ascontiguousarray(cloud_m.reshape(-1, 3))
        if len(flat) > self.capacity:
            stride = int(np.ceil(len(flat) / self.capacity))
            flat = flat[::stride]
        pad = np.zeros((self.capacity - len(flat), 3), np.float32)
        cloud = jnp.asarray(np.concatenate([flat, pad]), jnp.float32)
        valid = jnp.asarray(np.concatenate(
            [np.any(flat != 0.0, axis=1), np.zeros(len(pad), bool)]))
        pts, mask = preprocess(cloud, valid, jnp.asarray(self.pose),
                               resolution=m.resolution, capacity=self.capacity)

        if not self.initialized:
            # first-scan bootstrap map update, synchronous (fastsense.cpp:168-174)
            self.initialized = True
            state = self._update_state(self.state, pts, mask, self.pose)
            self._publish(state)
            self.last_update_pose = self.pose.copy()

        pretransform = self.imu_diff.pretransform(stamp).astype(np.float32)
        dR = pretransform[:3, :3]
        pretransform[:3, 3] += (np.eye(3, dtype=np.float32) - dR) @ self.pose[:3, 3]

        with self._snap_lock:
            state, fields = self.state, self._fields
        if prof:
            prof.start("registration")
        transform = register_cloud_fields(
            fields, state.pos, state.offset, pts, mask,
            jnp.asarray(pretransform),
            size=self.local_map.size, resolution=m.resolution,
            max_iterations=self.params.registration.max_iterations,
            it_weight_gradient=self.params.registration.it_weight_gradient,
            epsilon=self.params.registration.epsilon,
            mode=self.params.registration.mode)
        transform = np.asarray(transform)
        if prof:
            prof.stop("registration")

        self.pose = (transform @ self.pose).astype(np.float32)
        self.path.append(self.pose.copy())
        self.global_map.write_pose(self.pose[:3, 3],
                                   _mat_to_quat_np(self.pose[:3, :3]),
                                   scale=1000.0)

        # shift-update-visualize gate: every N scans or D meters
        # (fastsense.cpp:239-243); the job carries the scan so the async
        # update fuses the exact cloud that crossed the gate
        self.scan_count += 1
        dist = np.linalg.norm(
            (self.last_update_pose[:3, 3] - self.pose[:3, 3]) / 1000.0)
        if (self.scan_count % self.update_frequency == 0
                or dist > self.update_distance_m):
            self.last_update_pose = self.pose.copy()
            # reference joins the previous thread before spawning a new one
            # (fastsense.cpp:246-249) => blocking hand-off, never a dropped job
            self._jobs_submitted += 1
            self._jobs.push((pts, mask, self.pose.copy()))
        if prof:
            prof.stop("total")
        return self.pose.copy()

    # --------------------------------------------------------------- mapping
    def _update_state(self, state, pts, mask, pose_mm: np.ndarray):
        m = self.params.map
        # the update donates its input buffers; clone first so the published
        # snapshot stays live for concurrent registrations — the device
        # analogue of the reference's local-map copy ctor
        # (hdf5_local_map.cpp:22-31)
        import jax
        state = jax.tree.map(jnp.copy, state)
        scanner_pos = jnp.asarray(
            np.floor(pose_mm[:3, 3] / m.resolution).astype(np.int32))
        return tsdf_update_projective(
            state, pts, mask, scanner_pos,
            jnp.asarray(pose_mm[:3, :3], jnp.float32),
            size=self.local_map.size, tau=m.tau,
            max_weight=m.max_weight_scaled, resolution=m.resolution,
            channels=self.params.lidar.channels,
            columns=self.params.lidar.hresolution,
            vfov_deg=self.params.lidar.vfov)

    def _publish(self, state) -> None:
        fields = precompute_fields(state)
        fields.vw.block_until_ready()
        with self._snap_lock:
            self.state = state
            self._fields = fields

    def _worker_run(self) -> None:
        """shift_update_visualize twin (fastsense.cpp:88-118), serialized."""
        m = self.params.map
        while True:
            job = self._jobs.pop(timeout=0.1)
            if job is None:
                if not self._worker_running:
                    return
                continue
            pts, mask, pose_mm = job
            state = self.state   # worker is the only writer => safe read
            new_pos = np.floor(pose_mm[:3, 3] / m.resolution).astype(np.int64)
            if np.any(new_pos != np.asarray(state.pos)):
                self.local_map.absorb(state)
                self.local_map.shift(new_pos)
                state = self.local_map.device_state()
            state = self._update_state(state, pts, mask, pose_mm)
            self._publish(state)
            if self.viz_dir is not None:
                from ..obs.viz import export_tsdf_ply
                self.viz_dir.mkdir(parents=True, exist_ok=True)
                export_tsdf_ply(
                    self.viz_dir / f"tsdf_{self.scan_count:06d}.ply",
                    self.state, resolution=m.resolution, tau=m.tau)
            with self._done_cv:
                self._jobs_done += 1
                self._done_cv.notify_all()

    def sync(self, timeout: float | None = None) -> None:
        """Block until every enqueued mapping job has been published —
        the deterministic analogue of the reference's thread join
        (fastsense.cpp:246-249); useful for tests and offline replay."""
        with self._done_cv:
            self._done_cv.wait_for(
                lambda: self._jobs_done >= self._jobs_submitted, timeout)

    # --------------------------------------------------------------- shutdown
    def terminate(self, csv_path: str | Path | None = None) -> None:
        """Join the side thread, persist map + poses (fastsense.cpp:58-86)."""
        self._worker_running = False
        self._worker.join()
        self.imu_buffer.clear()
        self.local_map.absorb(self.state)
        self.local_map.write_back()
        if csv_path is not None:
            self.eval.export_results(csv_path)
        self.global_map.close()

    def trajectory(self) -> np.ndarray:
        return np.stack(self.path) if self.path else np.zeros((0, 4, 4))
