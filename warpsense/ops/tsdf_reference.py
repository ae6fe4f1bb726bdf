"""Exact host-side reference implementation of the TSDF ray-march update.

This is the framework's "CPU twin" (the role src/cpu/update_tsdf.cpp plays
for the reference's CUDA kernels): every device kernel is validated against
it.  Integer semantics follow the reference exactly —
src/warpsense/cuda/update_tsdf.cu:45-128 (GPU flavor) and
src/cpu/update_tsdf.cpp:397-564 (CPU flavor):

* march from the scanner position to each point + tau in half-voxel steps,
* per visited cell: value = min(|point - cell_center|, tau), negative behind
  the surface; weight = WEIGHT_RESOLUTION, linearly dropping behind the
  surface past eps = tau/10,
* vertical interpolation between scan rings: spread each sample along the
  per-point interpolation vector over (2*delta_z)/resolution + 1 cells,
  non-middle copies marked with negative weight,
* per-voxel conflict resolution, then weighted running average into the map.

Like the device op (see ops/tsdf.py), voxel addressing deviates from the
reference by using floor division so the ``index*res + res/2`` cell-center
formula is correct in negative octants too.

Conflict resolution differs deliberately from the reference: the reference's
CUDA CAS rule (cuda/util.h:70-102) and CPU rule (cpu/update_tsdf.cpp:508-512)
are both order-dependent (racy on GPU).  We define a deterministic lattice —
entries compare by (weight<=0, |value|, sign, |weight|) and the minimum wins:
a positive-weight (real) sample always beats interpolated ones, then smaller
|value| wins.  This is order-independent, matches the reference in all
non-racy cases, and is the contract the device kernels implement bit-exactly.
"""
from __future__ import annotations

import math

import numpy as np

from ..core.consts import MATRIX_RESOLUTION, WEIGHT_RESOLUTION


def c_div(a: int, b: int) -> int:
    """C-style integer division (truncate toward zero)."""
    q = abs(a) // abs(b)
    return q if (a < 0) == (b < 0) else -q


def calc_weight(value: int, tau: int) -> int:
    """Parity: include/warpsense/test/common.h:16-26."""
    weight_epsilon = tau // 10
    if value < -weight_epsilon:
        return WEIGHT_RESOLUTION * (tau + value) // (tau - weight_epsilon)
    return WEIGHT_RESOLUTION


def entry_key(value: int, weight: int) -> tuple:
    """Deterministic combine lattice: smaller key wins."""
    return (1 if weight <= 0 else 0, abs(value), 0 if value >= 0 else 1, abs(weight))


def dz_per_distance(channels: int = 128, vfov_deg: float = 45.0) -> int:
    """Fixed-point half vertical angular pitch (update_tsdf.cu:49-50)."""
    angle = vfov_deg / channels
    return int(math.tan(angle / 180.0 * math.pi) / 2.0 * MATRIX_RESOLUTION)


def raymarch_emissions(points_mm: np.ndarray, scanner_pos_voxel: np.ndarray,
                       up: np.ndarray, tau: int, resolution: int,
                       in_bounds_fn, in_bounds_buffer_fn,
                       pos_mode: str = "center",
                       channels: int = 128, vfov_deg: float = 45.0
                       ) -> dict[tuple, tuple[int, int]]:
    """Run the exact ray-march and return {voxel: (value, weight)} after
    lattice conflict resolution (the content of the reference's new_map)."""
    dzpd = dz_per_distance(channels, vfov_deg)
    weight_epsilon = tau // 10

    sp = np.asarray(scanner_pos_voxel, dtype=np.int64)
    if pos_mode == "center":
        # GPU flavor: voxel center (cuda/util.h:116-123)
        pos = sp * resolution + resolution // 2
    elif pos_mode == "corner":
        # CPU flavor: voxel corner (cpu/update_tsdf.cpp:410)
        pos = sp * resolution
    else:
        raise ValueError(pos_mode)

    up = np.asarray(up, dtype=np.int64)
    out: dict[tuple, tuple[int, int]] = {}

    for point in np.asarray(points_mm, dtype=np.int64):
        cell = np.floor_divide(point, resolution)
        # GPU gate: cell within window + tau/res/2 buffer
        # (update_tsdf.cu:55); CPU gate is plain in_bounds.
        if not in_bounds_buffer_fn(cell, -(tau // resolution // 2)):
            continue
        direction = point - pos
        distance = int(np.floor(np.sqrt(float(np.dot(direction, direction)))))
        if distance == 0:
            continue
        normed_dir = np.array([c_div(int(direction[i]) * MATRIX_RESOLUTION, distance)
                               for i in range(3)], dtype=np.int64)
        inner = np.array([c_div(int(x), MATRIX_RESOLUTION)
                          for x in np.cross(normed_dir, up)], dtype=np.int64)
        interp = np.cross(normed_dir, inner)
        interp_norm = int(np.floor(np.sqrt(float(np.dot(interp, interp)))))
        if interp_norm == 0:
            continue
        interp = np.array([c_div(int(interp[i]) * MATRIX_RESOLUTION, interp_norm)
                           for i in range(3)], dtype=np.int64)

        prev = None
        for length in range(1, distance + tau + 1, resolution // 2):
            proj = pos + np.array([c_div(int(direction[i]) * length, distance)
                                   for i in range(3)], dtype=np.int64)
            index = np.floor_divide(proj, resolution)
            # reference quirk: only x and y compared (update_tsdf.cu:71)
            if prev is not None and index[0] == prev[0] and index[1] == prev[1]:
                continue
            prev = index
            if not in_bounds_fn(index):
                continue

            target_center = index * resolution + resolution // 2
            d = point - target_center
            value = int(np.floor(np.sqrt(float(np.dot(d, d)))))
            value = min(value, tau)
            if length > distance:
                value = -value
            weight = WEIGHT_RESOLUTION
            if value < -weight_epsilon:
                weight = WEIGHT_RESOLUTION * (tau + value) // (tau - weight_epsilon)
            if weight == 0:
                continue

            delta_z = c_div(dzpd * length, MATRIX_RESOLUTION)
            iter_steps = (delta_z * 2) // resolution + 1
            mid = delta_z // resolution
            lowest = proj - np.array([c_div(delta_z * int(interp[i]), MATRIX_RESOLUTION)
                                      for i in range(3)], dtype=np.int64)
            for step in range(iter_steps):
                raw = lowest + np.array(
                    [c_div(step * resolution * int(interp[i]), MATRIX_RESOLUTION)
                     for i in range(3)], dtype=np.int64)
                widx = np.floor_divide(raw, resolution)
                if not in_bounds_fn(widx):
                    continue
                w = weight if step == mid else -weight
                key = tuple(int(x) for x in widx)
                cand = (value, w)
                if key not in out or entry_key(*cand) < entry_key(*out[key]):
                    out[key] = cand
    return out


def combine_into_map(emissions: dict[tuple, tuple[int, int]], get_entry, set_entry,
                     max_weight: int) -> None:
    """Weighted running average of the resolved samples into the map.

    Parity: cu_avg_tsdf_krnl (update_tsdf.cu:13-43) / the merge loop in
    cpu/update_tsdf.cpp:546-560.
    """
    for voxel, (value, weight) in emissions.items():
        ev, ew = get_entry(voxel)
        if weight > 0 and ew > 0:
            nv = c_div(ev * ew + value * weight, ew + weight)
            nw = min(max_weight, ew + weight)
            set_entry(voxel, nv, nw)
        elif weight != 0 and ew <= 0:
            set_entry(voxel, value, weight)


def update_tsdf_reference(points_mm, scanner_pos_voxel, up, local_map,
                          tau: int, max_weight: int, resolution: int,
                          pos_mode: str = "center",
                          channels: int = 128, vfov_deg: float = 45.0) -> None:
    """Full reference TSDF update against a host LocalMap (in place)."""
    size = np.asarray(local_map.size)

    def in_bounds_fn(idx):
        return bool(np.all(np.abs(idx - np.asarray(local_map.state.pos)) <= size // 2))

    def in_bounds_buffer_fn(idx, buffer):
        return bool(np.all(np.abs(idx - np.asarray(local_map.state.pos))
                           <= size // 2 - buffer))

    emissions = raymarch_emissions(points_mm, scanner_pos_voxel, up, tau,
                                   resolution, in_bounds_fn, in_bounds_buffer_fn,
                                   pos_mode, channels, vfov_deg)
    combine_into_map(emissions, local_map.value_at,
                     lambda v, val, w: local_map.set_value_at(v, val, w),
                     max_weight)


def projective_reference(gcoords, scanner_mm, rng_tab, endpoint, *, tau: int,
                         resolution: int, channels: int = 128,
                         columns: int = 1024, vfov_deg: float = 45.0):
    """Float64 host twin of the projective sweep's per-voxel rule
    (ops/tsdf_projective.py, ``_projective_math``) on the LEVEL beam grid
    (R = I), at the global voxel coordinates ``gcoords`` (n, 3), against a
    beam table ``(rng_tab, endpoint)`` from ``build_beam_table`` (its
    ranges only mark holes: each beam's range is recomputed in float64
    from its endpoint).

    Returns ``(value, weight, margins)``: the new sample per voxel (0, 0
    where the rule rejects it), the beam it reads (``margins["beam"]``)
    and the distance of each of its decisions from its threshold —
    ``margins["bins"]`` (n, 2) for the ring
    and column rounding in beam widths, ``margins["mm"]`` (n, 7) for the
    front/behind, truncation, vertical, interpolation, horizontal, range
    and weight-drop comparisons, ``margins["weight"]`` (n,) for the weight
    floor.  Where every margin is clear of float32 rounding, the device
    sweep must agree exactly; where one is not, both sides of the
    threshold are the rule applied correctly."""
    c = (np.asarray(gcoords, np.float64) * resolution + resolution // 2
         - np.asarray(scanner_mm, np.float64))
    rho = np.hypot(c[:, 0], c[:, 1])
    r_vox = np.sqrt(rho ** 2 + c[:, 2] ** 2)
    spacing = math.radians(vfov_deg) / (channels - 1)
    ringf = (math.radians(vfov_deg) / 2 - np.arctan2(c[:, 2], rho)) / spacing
    colf = (np.arctan2(c[:, 1], c[:, 0]) + math.pi) * (columns / (2 * math.pi))
    ring = np.round(ringf).astype(np.int64)
    ring_ok = (ring >= 0) & (ring < channels)
    col = np.mod(np.round(colf), columns).astype(np.int64)
    beam = col * channels + np.clip(ring, 0, channels - 1)
    e = np.asarray(endpoint, np.float64)[beam] - np.asarray(scanner_mm)
    # the table marks holes; the range itself is recomputed in float64
    r_beam = np.where(np.isfinite(np.asarray(rng_tab)[beam]),
                      np.linalg.norm(e, axis=1), np.inf)
    dist = np.linalg.norm(c - e, axis=1)
    behind = r_vox > r_beam
    value = np.where(behind, -np.minimum(dist, tau), np.minimum(dist, tau))

    eps = tau // 10
    half = resolution * 0.5
    v_res = r_vox * np.abs(ringf - ring) * spacing
    delta_z = dz_per_distance(channels, vfov_deg) * r_vox / MATRIX_RESOLUTION
    h_res = r_vox * np.abs(colf - np.round(colf)) * (2 * math.pi / columns)
    wf = WEIGHT_RESOLUTION * (tau + value) / (tau - eps)
    w = np.where(value < -eps, np.floor(wf), WEIGHT_RESOLUTION)
    with np.errstate(invalid="ignore"):
        ok = (ring_ok & np.isfinite(r_beam)
              & (v_res <= np.maximum(delta_z, half)) & (h_res <= half)
              & (r_vox <= r_beam + tau) & (w != 0))
    w = np.where(v_res > half, -w, w)
    margins = {
        "beam": beam,
        "bins": np.stack([np.abs(ringf - np.floor(ringf) - 0.5),
                          np.abs(colf - np.floor(colf) - 0.5)], axis=1),
        "mm": np.stack([np.abs(r_vox - r_beam), np.abs(dist - tau),
                        np.abs(v_res - np.maximum(delta_z, half)),
                        np.abs(v_res - half), np.abs(h_res - half),
                        np.abs(r_vox - r_beam - tau),
                        np.abs(value + eps)], axis=1),
        # the floor only decides inside the drop band; at the clamp
        # (value = -tau) wf is exactly 0 on every backend
        "weight": np.where((value < -eps) & (dist < tau),
                           np.abs(wf - np.round(wf)), np.inf),
    }
    return (np.where(ok, np.trunc(value), 0).astype(np.int64),
            np.where(ok, w, 0).astype(np.int64), margins)
