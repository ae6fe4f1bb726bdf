"""Warpsense pipeline: HATSDF-SLAM per-scan loop on the accelerator.

Behavioral parity with the reference's App + TSDFMapping + TSDFRegistration
orchestration (src/warpsense/app.cpp:65-176, src/warpsense/tsdf_mapping.cpp)
with a functional twist:

* the local map lives on device as a ``LocalMapState`` pytree; every scan
  runs ``preprocess`` -> (gated) ``tsdf_update`` (donated state) ->
  ``register_cloud`` (whole GN loop on device) — no per-iteration
  host/device round trips (the reference's perform_registration copies the
  pose up and 32 partial reductions down every iteration,
  registration.cu:351-361);
* the reference's reader/writer ``shared_mutex`` disappears — updates
  return a NEW state, so there is nothing to race;
* map shift pulls the state to the host, runs the ring-buffer shift
  against the chunked global map, and pushes the state back
  (tsdf_mapping.cpp:97-136 round-trips the whole window over PCIe;
  here it only happens on actual shifts).
"""
from __future__ import annotations

from pathlib import Path

import jax.numpy as jnp
import numpy as np

from ..core.config import Params
from ..core.geometry import to_int_mat, transform_point_fixed
from ..map.global_map import GlobalMap
from ..map.local_map import LocalMap
from ..obs.profiler import RuntimeEvaluator
from ..ops.preprocess import preprocess
from ..ops.registration import (precompute_fields, precompute_fields_packed,
                                precompute_fields_packed2,
                                register_cloud_fields, register_cloud_packed)
from ..ops.tsdf import plan_raymarch
from ..utils.filter import SlidingWindowFilter
from ..utils.imu import ImuAccumulator, ImuSample
from ..utils.ring_buffer import ConcurrentRingBuffer


def _mat_to_quat_np(R: np.ndarray) -> np.ndarray:
    from ..core import geometry
    return np.asarray(geometry.mat_to_quat(jnp.asarray(R, jnp.float32)))


class WarpsenseApp:
    """Single-chip warpsense loop fed by ``cloud_callback``/``imu_callback``.

    ``map_path``: map directory; defaults to params.map.store_path().
    ``capacity``: static preprocessed-cloud capacity (the reference caps
    registration at 128K points, registration.cu:261).
    """

    def __init__(self, params: Params, map_path: str | Path | None = None,
                 capacity: int = 32768, max_range_mm: int = 50000,
                 profile: bool = False, fusion: str = "auto",
                 resume: bool = False, exact_fields: bool = False,
                 monitor=None, force_odd: bool = True,
                 window_size: tuple[int, int, int] | None = None,
                 sync_shift: bool = False):
        """``fusion``: "auto" (= "projective-level": the dense sweep of
        ops/tsdf_projective.py on the level beam grid inside the tilt
        envelope), "projective" (the same sweep binned on the sensor
        attitude) or "raymarch" (exact reference semantics, ops/tsdf.py);
        see pipeline/fusion_backend.py.

        ``resume=True`` reopens an existing map file, reloads the window
        around the last persisted pose and continues from it — the
        checkpoint/resume capability the reference lacks (SURVEY §5.4).

        ``monitor``: optional ``obs.live.LiveMonitor`` receiving per-scan
        poses, map-window snapshots, and shift events while the run is in
        flight (the reference's RViz streaming role, publish.h:11-93).

        ``force_odd``/``window_size``: window-extent control — the
        reference forces odd extents (hdf5_local_map.cpp:6-20); multi-chip
        deployments need the x extent divisible by the mesh instead (see
        pipeline/warpsense_sharded.py and map/local_map.py on the even-
        extent floor convention).

        ``sync_shift=True`` swaps the window synchronously at the
        triggering scan instead of on the worker thread — bitwise-
        reproducible runs (the async worker's completion time decides
        which scans queue their fusions, a genuine thread-timing
        nondeterminism); used by the accuracy benches."""
        self.params = params
        self._sync_shift = bool(sync_shift)
        self.capacity = int(capacity)
        self.profile = profile
        self.fusion = fusion
        self.exact_fields = exact_fields
        self._fields = None      # cached registration fields (per map epoch)
        self._last_reg_iters = 0  # device array in fast mode (lazy props)
        self._last_reg_err = float("nan")
        m = params.map
        path = Path(map_path) if map_path is not None else m.store_path()
        self.global_map = GlobalMap(path, m.tau, m.initial_weight,
                                    truncate=not resume, meta={
            "tau": m.tau, "map_resolution": m.resolution,
            "max_weight": m.max_weight_scaled,
            "max_distance": m.max_distance,
            "map_size_x": m.size_voxels[0], "map_size_y": m.size_voxels[1],
            "map_size_z": m.size_voxels[2],
        })
        self.local_map = LocalMap(window_size or m.size_voxels,
                                  self.global_map, force_odd=force_odd)

        self.pose = np.eye(4, dtype=np.float32)  # mm translation
        self._prev_pose = None     # previous scan's pose (velocity prior)
        self._reg_healthy = False  # last registration made a real step
        self.initialized = False
        if resume:
            poses = self.global_map.read_poses()
            if len(poses):
                from ..io.trajectory import _mat_from_quat
                last = poses[-1]
                self.pose[:3, :3] = _mat_from_quat(
                    last[3:7].astype(np.float64)).astype(np.float32)
                self.pose[:3, 3] = last[:3] * 1000.0     # stored in meters
                self.local_map.load_window(
                    np.floor(self.pose[:3, 3] / m.resolution).astype(np.int64))
                self.initialized = True
        self.state = self._place(self.local_map.device_state())
        self.last_tsdf_pose = self.pose.copy()
        self.last_shift_pose = self.pose.copy()
        self.shifted = False
        self.path: list[np.ndarray] = []

        self._shift_thread = None
        self._shift_error: BaseException | None = None
        self._pending_fusion: list = []
        self._rng = np.random.default_rng(0)
        self.imu_buffer = ConcurrentRingBuffer(1000)
        self.imu_filter = SlidingWindowFilter(10)
        self.imu_acc = ImuAccumulator(self.imu_buffer)

        self.max_steps, self.max_isteps = plan_raymarch(
            m.tau, m.resolution, max_range_mm, params.lidar.channels,
            params.lidar.vfov)
        self.eval = RuntimeEvaluator.get_instance()
        self.monitor = monitor

    # ----------------------------------------------------------- placement
    def _place(self, state):
        """Device-placement hook: identity on one chip; the sharded app
        overrides it to re-place (value, weight) block-sharded over the
        mesh after construction/shift/resume."""
        return state

    # ------------------------------------------------------------ telemetry
    @property
    def last_reg_iters(self) -> int:
        """GN iterations of the last scan (fast mode; materialized lazily
        so the hot path never blocks on the device)."""
        return int(self._last_reg_iters)

    @property
    def last_reg_err(self) -> float:
        return float(self._last_reg_err)

    # ------------------------------------------------------------- callbacks
    def imu_callback(self, sample: ImuSample) -> None:
        """Gyro smoothing (window 10) + buffering; parity app.cpp:54-63."""
        filtered = self.imu_filter.update(sample.angular_velocity)
        self.imu_buffer.push_nb(
            ImuSample(sample.stamp, np.asarray(filtered)), force=True)

    def cloud_callback(self, cloud_m: np.ndarray, stamp: float) -> np.ndarray:
        """One scan: preprocess -> gated TSDF fusion -> register -> pose.

        ``cloud_m``: (..., 3) float32 meters in the SENSOR frame (organized
        scans are flattened); zero rows are invalid.  Returns the updated
        4x4 pose (mm).
        """
        prof = self.eval if self.profile else None
        if prof:
            prof.start("total")
        self._collect_shift()
        m = self.params.map
        flat = np.ascontiguousarray(cloud_m.reshape(-1, 3))
        if len(flat) > self.capacity:
            # static-shape budget: uniform random subsample (a stride on an
            # organized scan would alias azimuth columns systematically)
            keep = self._rng.choice(len(flat), self.capacity, replace=False)
            flat = flat[np.sort(keep)]
        pad = np.zeros((self.capacity - len(flat), 3), np.float32)
        cloud = jnp.asarray(np.concatenate([flat, pad]), jnp.float32)
        valid = jnp.asarray(
            np.concatenate([np.any(flat != 0.0, axis=1),
                            np.zeros(len(pad), bool)]))

        if prof:
            prof.start("preprocessing")
        # fast mode keeps TRUE point coordinates through dedup: the voxel-
        # center snap (reference parity) scatters points off the surface in
        # the map grid and flattens the sub-voxel registration objective
        pts, mask = preprocess(cloud, valid, jnp.asarray(self.pose),
                               resolution=m.resolution, capacity=self.capacity,
                               snap=self.params.registration.mode != "fast")
        if prof:
            pts.block_until_ready()
            prof.stop("preprocessing")

        # Fusion order: the reference fuses BEFORE registering
        # (app.cpp:65-117), i.e. with the scan at the STALE pose — every
        # update injects wall evidence lagged by one scan's motion, which
        # registration then tracks: a measured ~0.15 deg/scan systematic
        # yaw drift on a 3 deg/scan turn (and plausibly the instability the
        # reference README admits at line 301).  Fast mode therefore fuses
        # AFTER registration at the refined pose (post_fuse below); parity
        # mode keeps the reference order.  Bootstrap (first scan / after
        # shift) must fuse first either way — there is nothing to register
        # against yet.
        fuse_now = (self.params.registration.mode != "fast"
                    or not self.initialized)
        dist_tsdf = np.linalg.norm(
            (self.last_tsdf_pose[:3, 3] - self.pose[:3, 3]) / 1000.0)
        want_fuse = (not self.initialized or dist_tsdf > m.update_distance
                     or self.shifted)
        if want_fuse and fuse_now:
            self.initialized = True
            self.shifted = False
            self.last_tsdf_pose = self.pose.copy()
            if prof:
                prof.start("tsdf")
            self._update_tsdf(pts, mask)
            if prof:
                self.state.value.block_until_ready()
                prof.stop("tsdf")
            want_fuse = False

        pretransform = self.imu_acc.acc_transform(stamp).astype(np.float32)
        # Apply the IMU delta rotation about the CURRENT sensor position,
        # not the map origin: the reference left-multiplies the raw delta
        # (app.cpp:98-102), which at distance r from the origin injects a
        # spurious ~2 sin(theta/2) r tangential offset every scan.
        dR = pretransform[:3, :3]
        pretransform[:3, 3] += (np.eye(3, dtype=np.float32) - dR) @ self.pose[:3, 3]
        imu_only = pretransform.copy()
        if (self.params.registration.mode == "fast"
                and self.params.registration.velocity_prior
                and self._prev_pose is not None and self._reg_healthy):
            # constant-velocity translation seed (config.velocity_prior):
            # without it, along-axis-degenerate geometry lets the LM's
            # damped weak direction slide behind the true motion.  Only
            # seeded after a HEALTHY registration — when the last scan was
            # sane-gated or registration contributed nothing (c = 0, off
            # the map), extrapolating the prior is a ballistic runaway; a
            # tracker that coasts to a stop near the map can re-lock
            pretransform[:3, 3] += self.pose[:3, 3] - self._prev_pose[:3, 3]
        self._prev_pose = self.pose.copy()

        if prof:
            prof.start("registration")
        transform = self._register(pts, mask, pretransform)
        if prof:
            prof.stop("registration")
        sane = self.params.registration.sane_step_m
        if self.params.registration.mode == "fast":
            delta = (transform @ self.pose)[:3, 3] - self.pose[:3, 3]
            if sane > 0 and float(np.linalg.norm(delta)) > sane * 1000.0:
                # implausible per-scan motion: a degenerate solve escaped
                # the map (config.sane_step_m) — keep the IMU-only prior
                # (NOT the velocity-seeded one: extrapolating an already
                # implausible velocity is exactly the ballistic runaway
                # this gate exists to stop) and let the next scans re-lock
                transform = imu_only.astype(np.float32)
                self._reg_healthy = False
            else:
                # a bit-exact pretransform return means registration made
                # no accepted step (zero valid points — off the map);
                # tracked even with the gate disabled so the velocity
                # prior keeps working when sane_step_m <= 0
                self._reg_healthy = not np.array_equal(
                    transform, pretransform.astype(np.float32))

        # Pose update: full SE3 composition pose <- transform @ pose.  The
        # registration refined `total` over the already-pose-transformed
        # cloud, so the corrected sensor pose is exactly transform @ pose.
        # (The reference instead does R <- dR R but t += dt, app.cpp:172-176,
        # dropping the (dR - I) @ t coupling — a bug that only cancels when
        # the scan-to-scan rotation is zero and that manifests as steady yaw
        # drift on curved trajectories.)
        self.pose = (transform @ self.pose).astype(np.float32)
        if want_fuse:
            # fast mode: fuse at the REFINED pose — re-transform the
            # map-frame points by the registration delta first
            self.initialized = True
            self.shifted = False
            self.last_tsdf_pose = self.pose.copy()
            if prof:
                prof.start("tsdf")
            pts_ref = transform_point_fixed(
                pts, to_int_mat(jnp.asarray(transform)))
            if self._shift_thread is not None:
                # window swap in flight: queue (fused after the swap, like
                # the reference's Mapping during shift, mapping.cpp:115-129).
                # The capture pose rides along: the projective ray origin
                # must be the pose the scan was taken at, not the pose at
                # flush time.
                self._pending_fusion.append((pts_ref, mask, self.pose.copy()))
            else:
                self._update_tsdf(pts_ref, mask)
            if prof:
                self.state.value.block_until_ready()
                prof.stop("tsdf")
        self.path.append(self.pose.copy())
        self.global_map.write_pose(self.pose[:3, 3],
                                   _mat_to_quat_np(self.pose[:3, :3]),
                                   scale=1000.0)
        self._maybe_shift()
        if prof:
            prof.stop("total")
        if self.monitor is not None:
            # live streaming (the reference's per-scan TF/path publish +
            # marker-cloud topics, app.cpp:150-170 / publish.h:11-93)
            self.monitor.publish_pose(stamp, self.pose)
            self.monitor.publish_map(self.state, resolution=m.resolution,
                                     tau=m.tau)
        return self.pose.copy()

    # -------------------------------------------------------------- internals
    def _register(self, pts, mask, pretransform) -> np.ndarray:
        """Registration seam (cached fields + GN/LM loop) — returns the
        refining 4x4 transform as numpy.  The sharded app overrides this
        with the mesh twins (same closure contract)."""
        m = self.params.map
        reg = self.params.registration
        if reg.mode == "fast":
            # production hot path: packed single-plane fields (1 gather per
            # GN iteration) + interpolated residuals + early convergence
            if self._fields is None:
                self._fields = (
                    precompute_fields_packed2(self.state) if self.exact_fields
                    else precompute_fields_packed(self.state, tau=m.tau))
            transform, iters, err = register_cloud_packed(
                self._fields, self.state.pos, self.state.offset, pts, mask,
                jnp.asarray(pretransform),
                size=self.local_map.size, resolution=m.resolution, tau=m.tau,
                max_iterations=reg.max_iterations,
                it_weight_gradient=reg.it_weight_gradient,
                epsilon=reg.epsilon,
                coarse_iterations=reg.coarse_iterations,
                gather_freeze=reg.gather_freeze)
            # kept as DEVICE arrays: int()/float() here would force a
            # blocking device->host transfer inside every cloud_callback
            # even when nobody reads them — the properties below
            # materialize lazily on access
            self._last_reg_iters = iters
            self._last_reg_err = err
        else:
            if self._fields is None:
                # recomputed only when the map changed (TSDF update or
                # shift) — dense sweep amortized over scans in between
                self._fields = precompute_fields(self.state)
            transform = register_cloud_fields(
                self._fields, self.state.pos, self.state.offset, pts, mask,
                jnp.asarray(pretransform),
                size=self.local_map.size, resolution=m.resolution,
                max_iterations=reg.max_iterations,
                it_weight_gradient=reg.it_weight_gradient,
                epsilon=reg.epsilon, mode=reg.mode)
        return np.asarray(transform)

    def _update_tsdf(self, pts, mask, pose: np.ndarray | None = None) -> None:
        """Fuse a (map-frame) cloud captured at ``pose`` (default: the
        current pose) — the pose fixes the projective ray origin.  Backend
        dispatch is shared with featsense (pipeline/fusion_backend.py)."""
        from .fusion_backend import fuse_cloud
        if pose is None:
            pose = self.pose
        self.state = fuse_cloud(
            self.state, pts, mask, pose, params=self.params,
            size=self.local_map.size, fusion=self.fusion,
            max_steps=self.max_steps, max_isteps=self.max_isteps)
        self._fields = None      # map changed: registration fields stale

    def _collect_shift(self) -> None:
        """Swap in a completed async shift (fast mode); fuse any scans that
        were queued while it was in flight (parity with the reference's
        Mapping accumulating clouds during shift, mapping.cpp:115-129)."""
        t = self._shift_thread
        if t is None or t.is_alive():
            return
        t.join()
        self._shift_thread = None
        if self._shift_error is not None:
            # surface worker failures instead of silently swapping in a
            # half-shifted window; allow a retry at the next gate
            err, self._shift_error = self._shift_error, None
            self.last_shift_pose = self._pre_shift_pose
            raise RuntimeError("async map shift failed") from err
        self.state = self._place(self._finish_async_shift())
        self.shifted = True
        self._fields = None      # window moved: registration fields stale
        pending, self._pending_fusion = self._pending_fusion, []
        for pts, mask, pose in pending:
            self._update_tsdf(pts, mask, pose=pose)

    def _finish_async_shift(self):
        """Swap-in seam for a completed async shift: return the post-shift
        device state.  The single-chip worker ran the whole ``shift`` (its
        device dispatches are safe with one device); the sharded app
        overrides this with the staged ``finish_shift`` (main-thread
        scatters only — see map/local_map.py's overlapped shift)."""
        return self.local_map.detach_device()

    def _maybe_shift(self) -> None:
        """Shift the ring-buffer window once the pose wandered >= map.shift
        meters from the last shift pose (tsdf_mapping.cpp:97-136).

        Fast mode runs the shift on a WORKER thread against a functional
        snapshot of the device state — registration keeps running on the
        old window meanwhile (the role of the reference's async map-shift
        thread + shared_mutex, tsdf_mapping.cpp:97-136, without the lock:
        the snapshot is immutable by construction) — and moves only the
        evicted/loaded slabs between device and host (O(slab) transfers;
        the reference round-trips the whole window, :116-123).  Scans that
        want fusion while the shift is in flight are queued and fused
        after the swap.  Parity mode keeps the reference-shaped
        synchronous whole-window path."""
        m = self.params.map
        if self._shift_thread is not None:
            return                     # one shift in flight at a time
        dist = np.linalg.norm(
            (self.last_shift_pose[:3, 3] - self.pose[:3, 3]) / 1000.0)
        if dist < m.shift:
            return
        self._pre_shift_pose = self.last_shift_pose
        self.last_shift_pose = self.pose.copy()
        new_pos = np.floor(self.pose[:3, 3] / m.resolution).astype(np.int64)
        if self.monitor is not None:
            self.monitor.publish_shift(new_pos)   # skeleton publish role
        if self.params.registration.mode == "fast":
            self.local_map.attach_device(self.state)
            if self._sync_shift:
                self.local_map.shift(new_pos)
                self.state = self._place(self.local_map.detach_device())
                self.shifted = True
                self._fields = None
                return
            import threading

            def work():
                try:
                    self.local_map.shift(new_pos)
                except BaseException as e:      # surfaced in _collect_shift
                    self._shift_error = e
            self._shift_thread = threading.Thread(target=work, daemon=True)
            self._shift_thread.start()
            return
        self.local_map.absorb(self.state)
        self.local_map.shift(new_pos)
        self.state = self._place(self.local_map.device_state())
        self.shifted = True
        self._fields = None      # window moved: registration fields stale

    # --------------------------------------------------------------- shutdown
    def terminate(self, csv_path: str | Path | None = None) -> None:
        """Persist map + poses; parity with App::terminate (app.cpp:190-225)."""
        self.imu_buffer.clear()
        if self._shift_thread is not None:
            self._shift_thread.join()
        self._collect_shift()
        self.local_map.absorb(self.state)
        self.local_map.write_back()
        if csv_path is not None:
            self.eval.export_results(csv_path)
        self.global_map.close()

    def trajectory(self) -> np.ndarray:
        return np.stack(self.path) if self.path else np.zeros((0, 4, 4))
