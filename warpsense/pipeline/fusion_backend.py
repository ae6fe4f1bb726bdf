"""Shared TSDF fusion-backend dispatch for the pipelines.

The reference shares ONE cuda::TSDFMapping between warpsense and
featsense (tsdf_mapping.cpp); this module is that shared seam: both
pipelines resolve "auto"/"projective-level"/"projective"/"raymarch" here,
so the beam-grid attitude rule (the tilt envelope) lives in exactly one
place.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..core.consts import MATRIX_RESOLUTION
from ..core.geometry import to_int_mat, transform_point_fixed
from ..map.local_map import LocalMapState


def sensor_tilt_deg(pose_mm: np.ndarray) -> float:
    """Tilt of the sensor z axis from the map vertical, degrees."""
    R = np.asarray(pose_mm, np.float64)[:3, :3]
    return float(np.degrees(np.arccos(np.clip(R[2, 2], -1.0, 1.0))))


def level_tilt_budget_deg(vfov_deg: float) -> float:
    """Tilt envelope of the LEVEL map-aligned beam grid.

    Two loss mechanisms under sensor tilt t (measured coverage-deficit
    curve vs the attitude-aware grid on the indoor box scene,
    tests/test_tsdf_projective.py::test_level_grid_tilt_envelope):

    * ring ALIASING — the scan's discrete elevation fan no longer aligns
      with the level table's ring centers, leaving hole rings: ~6-7%
      written-voxel deficit at ANY tilt > 0 (exactly 0 at t = 0);
    * band CLIPPING — returns whose map-frame elevation leaves
      [-vfov/2, vfov/2] drop entirely: grows with t (measured 18% at
      5.6 deg, 32% at 11.25 deg, 43% at 22.5 deg).

    2 degrees keeps the deficit around ~10% worst-case-scene (sub-voxel
    ATE impact, pinned by the rotation-rich accuracy bench) while the
    level grid serves near-level platforms; beyond it dispatch falls back
    to the attitude-aware grid (the reference's ray-march handles
    attitude via up-vector interpolation, update_tsdf.cu:49-63)."""
    del vfov_deg        # measured dominated by aliasing, not band width
    return 2.0


def grid_rotation_for(pose_mm: np.ndarray, vfov_deg: float,
                      budget_deg: float | None = None):
    """(rotation 3x3 f32, level: bool) — the beam-grid attitude for a scan
    captured at ``pose_mm``: identity (level grid) inside the tilt
    envelope, the true sensor attitude beyond it."""
    budget = (level_tilt_budget_deg(vfov_deg) if budget_deg is None
              else budget_deg)
    if sensor_tilt_deg(pose_mm) <= budget:
        return jnp.eye(3, dtype=jnp.float32), True
    return jnp.asarray(np.asarray(pose_mm)[:3, :3], jnp.float32), False


def resolve_fusion(fusion: str) -> str:
    """"auto" -> "projective-level" (the production sweep: level
    map-aligned beam grid inside the tilt envelope, attitude-aware grid
    beyond it) on every backend and window shape; explicit names pass
    through."""
    return "projective-level" if fusion == "auto" else fusion


def fuse_cloud(state: LocalMapState, pts_mm, mask, pose_mm: np.ndarray, *,
               params, size, fusion: str, max_steps=None, max_isteps=None
               ) -> LocalMapState:
    """One fusion step of a map-frame mm cloud captured at ``pose_mm``.

    ``fusion``: "raymarch" (reference-exact march), "projective" (dense
    sweep binning on the sensor attitude), "projective-level" (dense sweep
    binning on the LEVEL map-aligned grid inside the tilt envelope and on
    the sensor attitude beyond it — the production path, shared with the
    sharded fusion in parallel/sharded.py), or "auto".
    """
    m = params.map
    scanner_pos = jnp.asarray(
        np.floor(np.asarray(pose_mm)[:3, 3] / m.resolution).astype(np.int32))
    fusion = resolve_fusion(fusion)
    if fusion in ("projective", "projective-level"):
        from ..ops.tsdf_projective import tsdf_update_projective
        # The beam grid attitude only defines the spherical binning of
        # the (already map-frame) scan, not the geometry.  "projective"
        # always bins with the sensor attitude (reference-exact);
        # "projective-level" bins on the LEVEL map-aligned grid INSIDE the
        # tilt envelope and falls back to the attitude-aware grid beyond
        # it, so sustained pitch/roll never silently drops returns
        # (level_tilt_budget_deg; reference role: update_tsdf.cu:49-63).
        if fusion == "projective":
            grid_rot = jnp.asarray(np.asarray(pose_mm)[:3, :3], jnp.float32)
        else:
            grid_rot, _ = grid_rotation_for(pose_mm, params.lidar.vfov)
        return tsdf_update_projective(
            state, pts_mm, mask, scanner_pos, grid_rot,
            size=size, tau=m.tau, max_weight=m.max_weight_scaled,
            resolution=m.resolution, channels=params.lidar.channels,
            columns=params.lidar.hresolution,
            vfov_deg=params.lidar.vfov)
    from ..ops.tsdf import tsdf_update
    int_rot = to_int_mat(jnp.asarray(np.asarray(pose_mm), jnp.float32))
    up = transform_point_fixed(
        jnp.asarray([0, 0, MATRIX_RESOLUTION], jnp.int32),
        int_rot.at[:3, 3].set(0))
    return tsdf_update(
        state, pts_mm, mask, scanner_pos, up, size=size, tau=m.tau,
        max_weight=m.max_weight_scaled, resolution=m.resolution,
        max_steps=max_steps, max_isteps=max_isteps,
        channels=params.lidar.channels, vfov_deg=params.lidar.vfov)
