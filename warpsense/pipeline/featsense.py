"""Featsense pipeline: F-LOAM odometry + VGICP refinement + TSDF back end.

Behavioral parity with the reference's 4-stage featsense node
(/root/reference/src/featsense/featsense.cpp,
 /root/reference/src/featsense/mapping.cpp) re-composed around jitted
device ops:

* stage 1 LidarProcessing  -> ``frontends.featsense.features`` (one jit);
* stage 2 OdomEstimation   -> ``frontends.featsense.odometry`` (one jit
  per scan, whole re-associate/GN loop on device);
* stage 3 Mapping          -> VGICP refinement (``frontends.featsense.vgicp``)
  gated on pose distance + the shared TSDF fusion op (``ops.tsdf``);
* stage 4 Visualization    -> trajectory buffers + pose writing.

``FeatsenseApp.process_scan`` runs the stages sequentially (the functional
state makes the reference's ring-buffer handoffs unnecessary for
correctness); ``ThreadedFeatsenseRunner`` reproduces the reference's
pipeline parallelism across host threads for throughput, using the same
ConcurrentRingBuffer discipline (featsense.cpp:52-75).
"""
from __future__ import annotations

import threading
from collections import deque
from pathlib import Path

import jax.numpy as jnp
import numpy as np

from ..core.config import Params
from ..frontends.featsense.features import extract_features
from ..frontends.featsense.features_reference import FeatureParams
from ..frontends.featsense.odometry import OdomEstimation, voxel_downsample
from ..frontends.featsense.vgicp import vgicp_align
from ..map.global_map import GlobalMap
from ..map.local_map import LocalMap
from ..obs.profiler import RuntimeEvaluator
from ..ops.tsdf import plan_raymarch
from ..utils.ring_buffer import ConcurrentRingBuffer
from .warpsense import _mat_to_quat_np


class FeatsenseMapping:
    """TSDF back end with VGICP refinement (Mapping stage).

    Parity: mapping.cpp:39-152.  Consumes sensor-frame clouds (meters) +
    F-LOAM poses; produces VGICP-refined poses and a fused TSDF map.
    """

    def __init__(self, params: Params, map_path: str | Path | None = None,
                 capacity: int = 32768, max_range_mm: int = 50000,
                 fusion: str = "raymarch", resume: bool = False,
                 mesh=None, window_size: tuple[int, int, int] | None = None):
        """``fusion``: "raymarch" (reference-exact march, the parity
        default), "projective" (dense sweep, sensor-attitude grid) or
        "auto" (the level-grid sweep, "projective-level") — the same
        choices as pipeline/warpsense.py; the featsense back end is
        the SAME TSDF mapping the reference shares between both
        pipelines (mapping.cpp:39-152).

        ``resume=True`` reopens an existing map, reloads the window around
        the last persisted pose, and applies that pose as a world-frame
        OFFSET to the (freshly restarted) F-LOAM odometry — the same
        checkpoint/resume capability warpsense has (SURVEY §5.4; the
        reference truncates unconditionally, hdf5_global_map.cpp:5).

        ``mesh``: optional 1-D ``jax.sharding.Mesh`` — the O(voxels) TSDF
        fusion (the back end's roofline term) runs x-block-sharded via
        ``parallel.sharded.tsdf_update_projective_sharded`` while the
        front end (features, odometry, VGICP) stays replicated — the mesh
        twin of the reference's shared GPU back end (mapping.cpp:82-137);
        the window's x extent is rounded up to a mesh multiple.
        ``window_size`` overrides the window (and skips odd-forcing), as
        in WarpsenseApp."""
        self.params = params
        self.capacity = int(capacity)
        self.fusion = fusion
        self.mesh = mesh
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
        if window_size is not None:
            if mesh is not None:
                n = mesh.shape[mesh.axis_names[0]]
                if window_size[0] % n:
                    raise ValueError(
                        f"window x extent {window_size[0]} must divide "
                        f"the {n}-device mesh")
            self.local_map = LocalMap(window_size, self.global_map,
                                      force_odd=False)
        elif mesh is not None:
            from ..map.local_map import make_odd
            n = mesh.shape[mesh.axis_names[0]]
            sv = m.size_voxels
            self.local_map = LocalMap(
                (-(-sv[0] // n) * n, make_odd(sv[1]), make_odd(sv[2])),
                self.global_map, force_odd=False)
        else:
            self.local_map = LocalMap(m.size_voxels, self.global_map)
        # world-frame offset applied to every incoming F-LOAM pose: the
        # restarted odometry begins at identity, so composing offset @
        # floam maps its relative motion onto the persisted trajectory
        self.pose_offset = np.eye(4)
        if resume:
            poses = self.global_map.read_poses()
            if len(poses):
                from ..io.trajectory import _mat_from_quat
                last = poses[-1]
                self.pose_offset[:3, :3] = _mat_from_quat(
                    last[3:7].astype(np.float64))
                self.pose_offset[:3, 3] = last[:3]          # stored meters
                self.local_map.load_window(np.floor(
                    last[:3] * 1000.0 / m.resolution).astype(np.int64))
        self.state = self._place(self.local_map.device_state())
        self.max_steps, self.max_isteps = plan_raymarch(
            m.tau, m.resolution, max_range_mm, params.lidar.channels,
            params.lidar.vfov)

        self.last_pcls: deque = deque()      # enrich queue, world frame (m)
        self.last_gicp_pose = np.eye(4)
        self.last_floam_pose = np.eye(4)
        # mm frame: _maybe_shift compares against mm poses
        self.last_shift_pose = self._to_mm(self.pose_offset)
        self.initialized = False
        self.gicp_path: list[np.ndarray] = []

    # ------------------------------------------------------------------ utils
    def _place(self, state):
        """x-block-shard (value, weight) over the mesh when one is set."""
        if self.mesh is None:
            return state
        from ..parallel.sharded import shard_state
        return shard_state(state, self.mesh)

    def _subsample(self, pts: np.ndarray, mask: np.ndarray):
        """Map-resolution voxel subsample onto the fixed capacity
        (parity vgicp.h subsample + the 1M-point cap, update_tsdf.h:33)."""
        res_m = self.params.map.resolution / 1000.0
        if len(pts) > self.capacity:
            stride = int(np.ceil(len(pts) / self.capacity))
            pts, mask = pts[::stride], mask[::stride]
        pad = self.capacity - len(pts)
        pts = np.concatenate([pts, np.zeros((pad, 3), np.float32)])
        mask = np.concatenate([mask, np.zeros(pad, bool)])
        p, m2 = voxel_downsample(jnp.asarray(pts, jnp.float32),
                                 jnp.asarray(mask), res_m, self.capacity)
        return p, m2

    def _update_tsdf(self, pts_world_m, mask, pose_mm: np.ndarray) -> None:
        pts_mm = jnp.round(pts_world_m * 1000.0).astype(jnp.int32)
        if self.mesh is not None:
            # sharded back end: level map-aligned beam grid inside the
            # tilt envelope, true attitude beyond it — the same dispatch
            # as the sharded warpsense app
            from ..parallel.sharded import tsdf_update_projective_sharded
            from .fusion_backend import grid_rotation_for
            m = self.params.map
            grid_rot, _ = grid_rotation_for(pose_mm, self.params.lidar.vfov)
            scanner_pos = jnp.asarray(
                np.floor(np.asarray(pose_mm)[:3, 3] / m.resolution)
                .astype(np.int32))
            self.state = tsdf_update_projective_sharded(
                self.state, pts_mm, mask, scanner_pos, grid_rot,
                mesh=self.mesh, size=self.local_map.size, tau=m.tau,
                max_weight=m.max_weight_scaled, resolution=m.resolution,
                channels=self.params.lidar.channels,
                columns=self.params.lidar.hresolution,
                vfov_deg=self.params.lidar.vfov)
            return
        from .fusion_backend import fuse_cloud
        self.state = fuse_cloud(
            self.state, pts_mm, mask, pose_mm, params=self.params,
            size=self.local_map.size, fusion=self.fusion,
            max_steps=self.max_steps, max_isteps=self.max_isteps)

    def _maybe_shift(self, pose_mm: np.ndarray) -> None:
        m = self.params.map
        dist = np.linalg.norm(
            (self.last_shift_pose[:3, 3] - pose_mm[:3, 3]) / 1000.0)
        if dist < m.shift:
            return
        self.last_shift_pose = pose_mm.copy()
        new_pos = np.floor(pose_mm[:3, 3] / m.resolution).astype(np.int64)
        if self.mesh is not None:
            # O(slab) device IO against the sharded state, then re-place
            self.local_map.attach_device(self.state)
            self.local_map.shift(new_pos)
            self.state = self._place(self.local_map.detach_device())
            return
        self.local_map.absorb(self.state)
        self.local_map.shift(new_pos)
        self.state = self.local_map.device_state()

    @staticmethod
    def _to_mm(pose_m: np.ndarray) -> np.ndarray:
        p = np.asarray(pose_m, np.float64).copy()
        p[:3, 3] *= 1000.0
        return p.astype(np.float32)

    # ------------------------------------------------------------------- step
    def process(self, cloud_m: np.ndarray, valid: np.ndarray,
                floam_pose: np.ndarray) -> np.ndarray | None:
        """One scan (sensor frame, meters) + F-LOAM pose (meters).

        Returns the refined world pose (meters) when the TSDF update ran,
        None when gated away (parity mapping.cpp:78-80).
        """
        # resume offset: identity in a fresh run; after resume it maps the
        # restarted odometry's relative motion onto the persisted pose
        floam_pose = self.pose_offset @ np.asarray(floam_pose, np.float64)
        fl = self.params.floam

        if not self.initialized:
            pts, mask = self._subsample(cloud_m, valid)
            # first pose: sensor ~= world (floam starts at identity)
            world = np.asarray(pts) @ floam_pose[:3, :3].T + floam_pose[:3, 3]
            self.last_pcls.appendleft((jnp.asarray(world, jnp.float32), mask))
            self.last_gicp_pose = floam_pose.copy()
            self.last_floam_pose = floam_pose.copy()
            self._update_tsdf(jnp.asarray(world, jnp.float32), mask,
                              self._to_mm(floam_pose))
            self.initialized = True
            return floam_pose.copy()

        distance = np.linalg.norm(self.last_floam_pose[:3, 3]
                                  - floam_pose[:3, 3])
        if distance <= self.params.map.update_distance:
            return None

        # initial transform: last gicp pose advanced by the floam delta
        # (mapping.cpp:82-96: rotate by dR on the right, pretranslate dt)
        dR = floam_pose[:3, :3] @ self.last_floam_pose[:3, :3].T
        dt = floam_pose[:3, 3] - self.last_floam_pose[:3, 3]
        initial = np.eye(4)
        initial[:3, :3] = self.last_gicp_pose[:3, :3] @ dR
        initial[:3, 3] = self.last_gicp_pose[:3, 3] + dt

        pts, mask = self._subsample(cloud_m, valid)
        transformed = jnp.asarray(
            np.asarray(pts) @ initial[:3, :3].T + initial[:3, 3], jnp.float32)

        # enrich target from the last N world-frame clouds (mapping.cpp:22-37),
        # PADDED to the full enrich capacity so vgicp_align sees ONE shape
        # for the whole run (the 1..enrich ramp otherwise recompiles it
        # once per level — tens of seconds each on a remote device)
        pcls = list(self.last_pcls)
        while len(pcls) < fl.enrich:
            pcls.append((jnp.zeros_like(pcls[0][0]),
                         jnp.zeros_like(pcls[0][1])))
        tgt_pts = jnp.concatenate([p for p, _ in pcls])
        tgt_mask = jnp.concatenate([m for _, m in pcls])
        T, fitness = vgicp_align(
            transformed, mask, tgt_pts, tgt_mask, resolution=1.0,
            max_iterations=20, fitness_score_threshold=fl.vgicp_fitness_score)
        T = np.asarray(T, np.float64)
        gicp_pose = T @ initial
        aligned = jnp.asarray(
            np.asarray(transformed) @ T[:3, :3].T + T[:3, 3], jnp.float32)

        self._update_tsdf(aligned, mask, self._to_mm(gicp_pose))

        self.last_gicp_pose = gicp_pose.copy()
        self.last_floam_pose = floam_pose.copy()
        self.last_pcls.appendleft((aligned, mask))
        if len(self.last_pcls) > fl.enrich:
            self.last_pcls.pop()

        pose_mm = self._to_mm(gicp_pose)
        # scale=1000: poses persist in METERS, the same convention as the
        # warpsense pipeline (and what resume reads back)
        self.global_map.write_pose(pose_mm[:3, 3],
                                   _mat_to_quat_np(gicp_pose[:3, :3]),
                                   scale=1000.0)
        self.gicp_path.append(gicp_pose.copy())
        self._maybe_shift(pose_mm)
        return gicp_pose.copy()

    def terminate(self) -> None:
        """Persist map + poses (parity mapping.cpp:157-194)."""
        self.local_map.absorb(self.state)
        self.local_map.write_back()
        self.global_map.close()


class FeatsenseApp:
    """Full featsense loop: features -> odometry -> VGICP+TSDF mapping."""

    def __init__(self, params: Params, map_path: str | Path | None = None,
                 feature_params: FeatureParams | None = None,
                 edge_capacity: int = 2048, surf_capacity: int = 4096,
                 cloud_capacity: int = 32768, profile: bool = False,
                 odom_kwargs: dict | None = None, fusion: str = "raymarch",
                 resume: bool = False, mesh=None,
                 window_size: tuple[int, int, int] | None = None):
        """``mesh``/``window_size``: forwarded to ``FeatsenseMapping`` —
        the O(voxels) TSDF back end shards over the mesh while the front
        end stays replicated (reference architecture: one shared GPU back
        end behind both pipelines, mapping.cpp:82-137)."""
        self.params = params
        fl = params.floam
        self.feature_params = feature_params or FeatureParams(
            min_distance=fl.min_distance, max_distance=fl.max_distance,
            edge_threshold=fl.edge_threshold,
            surf_threshold=fl.surf_threshold)
        self.edge_capacity = edge_capacity
        self.surf_capacity = surf_capacity
        self.profile = profile
        self.eval = RuntimeEvaluator.get_instance()
        kwargs = dict(edge_leaf=fl.edge_resolution,
                      optimization_steps=fl.optimization_steps)
        kwargs.update(odom_kwargs or {})
        self.odom = OdomEstimation(**kwargs)
        self.mapping = FeatsenseMapping(params, map_path,
                                        capacity=cloud_capacity,
                                        fusion=fusion, resume=resume,
                                        mesh=mesh, window_size=window_size)
        self.floam_path: list[np.ndarray] = []

    def process_scan(self, cloud_m: np.ndarray, stamp: float = 0.0
                     ) -> np.ndarray:
        """One organized scan (H, W, 3) float32 meters -> F-LOAM pose (m)."""
        prof = self.eval if self.profile else None
        if prof:
            prof.start("total")
            prof.start("features")
        (e_pts, e_mask, _), (s_pts, s_mask, _) = extract_features(
            jnp.asarray(cloud_m, jnp.float32), params=self.feature_params,
            edge_capacity=self.edge_capacity,
            surf_capacity=self.surf_capacity)
        if prof:
            e_pts.block_until_ready()
            prof.stop("features")
            prof.start("odometry")
        floam_pose = self.odom.update(e_pts, e_mask, s_pts, s_mask)
        if prof:
            prof.stop("odometry")
            prof.start("mapping")
        flat = np.ascontiguousarray(cloud_m.reshape(-1, 3), dtype=np.float32)
        valid = np.any(flat != 0.0, axis=1)
        self.mapping.process(flat, valid, floam_pose)
        if prof:
            self.mapping.state.value.block_until_ready()
            prof.stop("mapping")
            prof.stop("total")
        self.floam_path.append(floam_pose.copy())
        return floam_pose

    def trajectory(self) -> np.ndarray:
        return (np.stack(self.floam_path) if self.floam_path
                else np.zeros((0, 4, 4)))

    def terminate(self, csv_path: str | Path | None = None) -> None:
        self.mapping.terminate()
        if csv_path is not None:
            self.eval.export_results(csv_path)


class ThreadedFeatsenseRunner:
    """Pipeline-parallel featsense: the reference's 4 background threads
    wired by ring buffers (featsense.cpp:52-75), around the same stages.

    Stage threads: features -> odometry -> mapping -> visualization (the
    4th thread drains ``pose_buffer`` into ``path`` and optionally appends
    a TUM trajectory file — the stand-in for the reference's TF broadcast
    + path pointcloud, visualization.cpp:16-67).  Queues carry device
    arrays; each stage dispatches its own jitted work so stages overlap.
    """

    def __init__(self, app: FeatsenseApp, queue_depth: int = 8,
                 viz_path: str | None = None):
        self.app = app
        self.cloud_buffer = ConcurrentRingBuffer(queue_depth)
        self.feature_buffer = ConcurrentRingBuffer(queue_depth)
        self.odom_buffer = ConcurrentRingBuffer(queue_depth)
        self.pose_buffer = ConcurrentRingBuffer(1024)
        self.viz_path = viz_path
        self.path: list[tuple[float, np.ndarray]] = []
        self.running = False
        self._threads: list[threading.Thread] = []

    # stage bodies ----------------------------------------------------------
    def _upstream_alive(self, stage: int) -> bool:
        # stage k must keep draining while any earlier stage thread is
        # still alive (it may yet push), not just while its buffer is
        # non-empty — otherwise drain() can drop in-flight items
        return any(t.is_alive() for t in self._threads[:stage])

    def _features_stage(self):
        app = self.app
        while self.running or len(self.cloud_buffer):
            item = self.cloud_buffer.pop(timeout=0.05)
            if item is None:
                continue
            cloud, stamp = item
            feats = extract_features(
                jnp.asarray(cloud, jnp.float32), params=app.feature_params,
                edge_capacity=app.edge_capacity,
                surf_capacity=app.surf_capacity)
            flat = np.ascontiguousarray(cloud.reshape(-1, 3),
                                        dtype=np.float32)
            self.feature_buffer.push((feats, flat, stamp))

    def _odometry_stage(self):
        app = self.app
        while (self.running or self._upstream_alive(1)
               or len(self.feature_buffer)):
            item = self.feature_buffer.pop(timeout=0.05)
            if item is None:
                continue
            ((e_pts, e_mask, _), (s_pts, s_mask, _)), flat, stamp = item
            pose = app.odom.update(e_pts, e_mask, s_pts, s_mask)
            app.floam_path.append(pose.copy())
            self.odom_buffer.push((flat, pose, stamp))

    def _mapping_stage(self):
        app = self.app
        while (self.running or self._upstream_alive(2)
               or len(self.odom_buffer)):
            item = self.odom_buffer.pop(timeout=0.05)
            if item is None:
                continue
            flat, pose, stamp = item
            valid = np.any(flat != 0.0, axis=1)
            refined = app.mapping.process(flat, valid, pose)
            self.pose_buffer.push_nb(
                (stamp, pose if refined is None else refined), force=True)

    def _viz_stage(self):
        """Drain refined poses into the in-memory path + optional TUM file
        (parity: Visualization::thread_run, visualization.cpp:16-67)."""
        fh = open(self.viz_path, "a") if self.viz_path else None
        try:
            while (self.running or self._upstream_alive(3)
                   or len(self.pose_buffer)):
                item = self.pose_buffer.pop(timeout=0.05)
                if item is None:
                    continue
                stamp, pose = item
                self.path.append((stamp, np.asarray(pose).copy()))
                if fh is not None:
                    from ..io.trajectory import _quat_from_mat
                    t = np.asarray(pose)[:3, 3]
                    q = _quat_from_mat(np.asarray(pose)[:3, :3])
                    fh.write("%.6f %.6f %.6f %.6f %.6f %.6f %.6f %.6f\n"
                             % (stamp, *t, *q))
        finally:
            if fh is not None:
                fh.close()

    # lifecycle --------------------------------------------------------------
    def start(self) -> None:
        self.running = True
        self._threads = [
            threading.Thread(target=self._features_stage, daemon=True),
            threading.Thread(target=self._odometry_stage, daemon=True),
            threading.Thread(target=self._mapping_stage, daemon=True),
            threading.Thread(target=self._viz_stage, daemon=True),
        ]
        for t in self._threads:
            t.start()

    def submit(self, cloud_m: np.ndarray, stamp: float) -> None:
        self.cloud_buffer.push((cloud_m, stamp))

    def drain(self) -> None:
        """Stop accepting work and join once all queues empty."""
        self.running = False
        for t in self._threads:
            t.join()
