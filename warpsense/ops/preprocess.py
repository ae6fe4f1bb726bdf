"""Scan preprocessing: voxel-center snap + dedup + pose transform.

JAX re-design of ``App::preprocess``
(/root/reference/src/warpsense/app.cpp:120-148):

* the reference dedups via a host ``unordered_set`` (dynamic size); here the
  cloud keeps a static shape — voxel keys are sorted on device, duplicates
  masked, and valid points compacted to the front so downstream ops march
  over a tight ``capacity``-sized prefix;
* the near-origin filter (all coords < 0.3 m) and the voxel-center snap
  (floor to voxel, + resolution/2) match the reference exactly;
* the pose transform uses the same fixed-point integer path as the device
  registration (to_int_mat/transform_point, util/util.h:8-18).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..core.geometry import to_int_mat, transform_point_fixed


@functools.partial(jax.jit, static_argnames=("resolution", "capacity",
                                              "snap"))
def preprocess(points_m: jax.Array, valid: jax.Array, pose: jax.Array, *,
               resolution: int, capacity: int,
               snap: bool = True) -> tuple[jax.Array, jax.Array]:
    """points_m: (N, 3) float32 meters (padded rows arbitrary);
    valid: (N,) bool; pose: 4x4 float32 (mm translation).

    Returns (points (capacity, 3) int32 mm, mask (capacity,) bool):
    deduplicated voxel representatives transformed into map frame,
    valid-first.

    ``snap=True`` returns voxel CENTERS (reference parity,
    app.cpp:120-148).  ``snap=False`` keeps the first point's TRUE mm
    coordinates per voxel: the sensor-frame center snap scatters points up
    to a half cell diagonal off the surface in the (differently aligned)
    map grid, which flattens/biases the registration objective for
    sub-voxel motion — the fast pipeline registers unsnapped points
    against interpolated residuals instead."""
    x, y, z = points_m[:, 0], points_m[:, 1], points_m[:, 2]
    near = (x < 0.3) & (y < 0.3) & (z < 0.3)   # reference quirk: AND, not norm
    keep = valid & ~near & jnp.all(jnp.isfinite(points_m), axis=-1)

    mm = points_m * 1000.0
    center = (jnp.floor(mm / resolution) * resolution
              + resolution // 2).astype(jnp.int32)
    if not snap:
        rep = jnp.round(mm).astype(jnp.int32)   # dedup key stays the voxel

    # sort by voxel key; push dropped points to the back
    big = jnp.int32(2 ** 30)
    cx = jnp.where(keep, center[:, 0], big)
    cy = jnp.where(keep, center[:, 1], big)
    cz = jnp.where(keep, center[:, 2], big)
    order = jnp.lexsort((cz, cy, cx))
    sc = center[order]
    skeep = keep[order]

    first = jnp.concatenate([jnp.ones((1,), bool),
                             jnp.any(sc[1:] != sc[:-1], axis=-1)])
    uniq = skeep & first
    if not snap:
        sc = rep[order]

    # compact unique points to the front (stable: argsort of ~uniq)
    comp = jnp.argsort(~uniq, stable=True)[:capacity]
    out_pts = sc[comp]
    out_mask = uniq[comp]

    transformed = transform_point_fixed(out_pts, to_int_mat(pose))
    return jnp.where(out_mask[:, None], transformed, 0), out_mask


def preprocess_host(points_m, *, resolution: int, capacity: int,
                    near_limit_m: float = 0.3):
    """Host-side preprocessing twin (native C++ when built, numpy fallback).

    Same mm-scale -> voxel-center snap -> dedup -> near filter as the
    device op, WITHOUT the pose transform (the caller applies it, or feeds
    the centers straight to the device).  Returns (points (capacity, 3)
    int32 mm, mask (capacity,)).  Used by data-loader threads to shrink
    host->device transfers to the dedup'd cloud.
    """
    import numpy as np

    from ..native import load as _load_native

    pts = np.ascontiguousarray(points_m, dtype=np.float32).reshape(-1, 3)
    out = np.zeros((capacity, 3), dtype=np.int32)
    lib = _load_native()
    if lib is not None:
        import ctypes
        n = lib.ws_preprocess(
            pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(pts),
            int(resolution), float(near_limit_m),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), capacity)
        n = int(n)
    else:
        keep = np.any(pts != 0.0, axis=1) & ~np.all(pts < near_limit_m, axis=1)
        mm = np.round(pts[keep] * 1000.0).astype(np.int64)
        vox = np.floor_divide(mm, resolution)
        _, first = np.unique(vox, axis=0, return_index=True)
        vox = vox[np.sort(first)][:capacity]
        n = len(vox)
        out[:n] = vox * resolution + resolution // 2
    mask = np.zeros((capacity,), bool)
    mask[:n] = True
    return out, mask
