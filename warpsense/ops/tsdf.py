"""Device (XLA) TSDF fusion step: the exact ray-march twin.

Re-design of the CUDA pair ``cu_min_tsdf_krnl`` +
``cu_avg_tsdf_krnl`` (src/warpsense/cuda/update_tsdf.cu:13-128):

* the CUDA kernel resolves racing rays with a CAS atomic keeping the entry
  with minimal |value| (cuda/util.h:70-102) — a race whose winner depends
  on timing.  Here every emitted sample is encoded into one int32 **order
  key** such that ``min`` over keys implements the deterministic combine
  lattice (positive-weight sample beats interpolated, then smaller |value|);
  XLA's scatter-min applies them (as atomic mins on a GPU).  Deterministic:
  a strictly stronger guarantee than the reference's atomics.
* the per-voxel averaging pass is a single fused element-wise sweep over the
  window (the ``new_map``/``avg_map`` double buffer of the reference
  collapses into the key tensor).
* the whole update is one jitted function with donated map state — no
  host/device round trips (the reference uploads points and downloads the
  map over PCIe each call).

Internal arithmetic is int32 with exact products and square roots (the
helpers below), so the march is bit-exact against the integer host twin
(ops/tsdf_reference.py) on every backend.

Deliberate deviation from the reference: voxel addressing uses FLOOR
division everywhere.  The reference truncates toward zero (C integer
division) but then computes cell centers as ``index*res + res/2`` — a
formula only valid for floor cells, so every negative-coordinate octant
stores TSDF values measured from a point a full voxel outside the cell
(update_tsdf.cu:89).  That bias (median |v| jumps from ~res/4 to ~1.4*res)
feeds distorted gradients to the registration and produces a systematic
yaw torque; floor addressing removes it.  Positive-coordinate behavior
(and all the reference's golden tests, test/map.cpp) is unchanged.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..core.consts import MATRIX_RESOLUTION, WEIGHT_RESOLUTION
from ..core.geometry import div_trunc
from ..map.local_map import LocalMapState, in_bounds, ring_index
from .tsdf_reference import dz_per_distance

# ----------------------------------------------------------------- order keys
# key = neg_flag<<23 | |value|<<8 | sign(value)<<7 | |weight|
# lexicographic min == combine lattice; SENTINEL means "never written".
# Plain Python int: a jnp scalar here would create a device array at
# IMPORT time and initialize the backend before the application can
# configure jax (platform choice, device counts, jax.distributed).
_SENTINEL = 2 ** 30


def encode_key(value: jax.Array, weight: jax.Array) -> jax.Array:
    neg = (weight <= 0).astype(jnp.int32)
    sign = (value < 0).astype(jnp.int32)
    return (neg << 23) | (jnp.abs(value) << 8) | (sign << 7) | jnp.abs(weight)


def decode_key(key: jax.Array) -> tuple[jax.Array, jax.Array]:
    untouched = key >= _SENTINEL
    neg = (key >> 23) & 1
    absv = (key >> 8) & 0x7FFF
    sign = (key >> 7) & 1
    absw = key & 0x7F
    value = jnp.where(sign == 1, -absv, absv)
    weight = jnp.where(neg == 1, -absw, absw)
    return (jnp.where(untouched, 0, value).astype(jnp.int32),
            jnp.where(untouched, 0, weight).astype(jnp.int32))


def plan_raymarch(tau: int, resolution: int, max_range_mm: int,
                  channels: int = 128, vfov_deg: float = 45.0) -> tuple[int, int]:
    """Static loop bounds (max_steps, max_isteps) for a given range budget."""
    step = max(resolution // 2, 1)
    max_steps = (max_range_mm + tau) // step + 1
    dzpd = dz_per_distance(channels, vfov_deg)
    dz_max = dzpd * (max_range_mm + tau) // MATRIX_RESOLUTION
    max_isteps = 2 * dz_max // resolution + 1
    return max_steps, max_isteps


# Exact integer helpers.  The reference computes in int64; JAX runs int32
# (x64 off), where products like direction * length overflow.  Each helper
# takes a float32 estimate and corrects it against a remainder computed in
# int32 wraparound arithmetic: the remainder is small, so its value modulo
# 2^32 is its exact value.  No result depends on float rounding, so the
# march is bit-exact against the integer reference on every backend.

def _floor_norm(v: jax.Array) -> jax.Array:
    """floor(|v|) of int32 vectors (..., 3), exact: the reference's int
    l2norm, even where |v|^2 exceeds int32."""
    v = v.astype(jnp.int32)
    s = jnp.sum(v * v, axis=-1)                  # wraps; only differenced
    k = jnp.floor(jnp.sqrt(jnp.sum(v.astype(jnp.float32) ** 2,
                                   axis=-1))).astype(jnp.int32)
    for _ in range(2):
        k = jnp.where(k * k - s > 0, k - 1, k)
        k = jnp.where((k + 1) * (k + 1) - s <= 0, k + 1, k)
    return k


def _mul_div_trunc(a: jax.Array, b: jax.Array, c: jax.Array) -> jax.Array:
    """C-truncated ``a * b / c`` for int32 ``a``, ``b`` and POSITIVE int32
    ``c``, exact even where ``a * b`` overflows int32."""
    q = jnp.trunc(a.astype(jnp.float32) * b.astype(jnp.float32)
                  / c.astype(jnp.float32)).astype(jnp.int32)
    neg = (a < 0) != (b < 0)
    for _ in range(2):
        r = a * b - q * c                        # exact: |r| < 2c
        q = jnp.where(neg, q + (r > 0) - (r <= -c), q - (r < 0) + (r >= c))
    return q


def ray_setup(points: jax.Array, pos_mm: jax.Array, up: jax.Array):
    """Per-point ray geometry of the march (update_tsdf.cu:49-63):
    (direction (N, 3), floor distance (N,), unit interpolation vector
    (N, 3) scaled by MATRIX_RESOLUTION, valid (N,)) — all int32."""
    direction = points - pos_mm
    distance = _floor_norm(direction)
    dist = jnp.maximum(distance, 1)[:, None]
    normed = div_trunc(direction * MATRIX_RESOLUTION, dist)
    inner = div_trunc(jnp.cross(normed, up.astype(jnp.int32)),
                      MATRIX_RESOLUTION)
    interp = jnp.cross(normed, inner)
    interp_norm = _floor_norm(interp)
    interp = _mul_div_trunc(interp, jnp.int32(MATRIX_RESOLUTION),
                            jnp.maximum(interp_norm, 1)[:, None])
    return direction, distance, interp, (distance > 0) & (interp_norm > 0)


def march_position(direction, distance, pos_mm, k, step_mm: int,
                   resolution: int):
    """Step ``k`` of every ray: (position mm, voxel index, length)."""
    length = (1 + k * step_mm).astype(jnp.int32)
    proj = pos_mm + _mul_div_trunc(direction, length,
                                   jnp.maximum(distance, 1)[:, None])
    return proj, jnp.floor_divide(proj, resolution), length


@functools.partial(
    jax.jit,
    static_argnames=("size", "tau", "max_weight", "resolution", "max_steps",
                     "max_isteps", "pos_mode", "channels", "vfov_deg"),
    donate_argnames=("state",),
)
def tsdf_update(state: LocalMapState, points: jax.Array, points_mask: jax.Array,
                scanner_pos: jax.Array, up: jax.Array, *,
                size: tuple[int, int, int], tau: int, max_weight: int,
                resolution: int, max_steps: int, max_isteps: int,
                pos_mode: str = "center", channels: int = 128,
                vfov_deg: float = 45.0) -> LocalMapState:
    """One full TSDF fusion step on device.

    points: (N, 3) int32 mm (padded); points_mask: (N,) bool;
    scanner_pos: (3,) int32 voxel coords; up: (3,) int32 MR-scaled.
    """
    nvox = size[0] * size[1] * size[2]
    dzpd = dz_per_distance(channels, vfov_deg)
    weight_epsilon = tau // 10
    step_mm = max(resolution // 2, 1)

    if pos_mode == "center":
        pos_mm = scanner_pos * resolution + resolution // 2
    else:
        pos_mm = scanner_pos * resolution

    direction, distance, interp, ray_ok = ray_setup(points, pos_mm, up)
    cell = jnp.floor_divide(points, resolution)
    point_ok = (points_mask & ray_ok
                & in_bounds(cell, state.pos, jnp.asarray(size),
                            -(tau // resolution // 2)))

    key_map = jnp.full((nvox,), _SENTINEL, dtype=jnp.int32)

    def index_at(k):
        """Voxel index of the march position at step k (C-truncation)."""
        return march_position(direction, distance, pos_mm, k, step_mm,
                              resolution)

    def body(k, key_map):
        proj, index, length = index_at(k)
        _, prev_index, _ = index_at(jnp.maximum(k - 1, 0))
        dup = ((index[:, 0] == prev_index[:, 0])
               & (index[:, 1] == prev_index[:, 1]) & (k > 0))
        within_ray = length <= distance + tau
        inb = in_bounds(index, state.pos, jnp.asarray(size))
        base_ok = point_ok & within_ray & ~dup & inb

        center = index * resolution + resolution // 2
        value = _floor_norm(points - center)
        value = jnp.minimum(value, tau)
        value = jnp.where(length > distance, -value, value)
        weight = jnp.where(
            value < -weight_epsilon,
            WEIGHT_RESOLUTION * (tau + value) // (tau - weight_epsilon),
            WEIGHT_RESOLUTION)
        base_ok = base_ok & (weight != 0)

        delta_z = dzpd * length // MATRIX_RESOLUTION                # scalar
        iter_steps = (delta_z * 2) // resolution + 1
        mid = delta_z // resolution
        lowest = proj - div_trunc(delta_z * interp, MATRIX_RESOLUTION)

        flats = []
        keys = []
        for s in range(max_isteps):
            raw = lowest + div_trunc(s * resolution * interp, MATRIX_RESOLUTION)
            widx = jnp.floor_divide(raw, resolution)
            ok = base_ok & (s < iter_steps) & in_bounds(widx, state.pos,
                                                        jnp.asarray(size))
            w = jnp.where(s == mid, weight, -weight)
            flats.append(jnp.where(ok, ring_index(widx, state.pos, state.offset,
                                                  size), nvox))
            keys.append(encode_key(value, w))
        flat = jnp.stack(flats, axis=-1).reshape(-1)
        key = jnp.stack(keys, axis=-1).reshape(-1)
        return key_map.at[flat].min(key, mode="drop")

    key_map = jax.lax.fori_loop(0, max_steps, body, key_map)

    # ---- fused averaging sweep (replaces cu_avg_tsdf_krnl + buffer reset)
    new_v, new_w = decode_key(key_map.reshape(size))
    ev = state.value.astype(jnp.int32)
    ew = state.weight.astype(jnp.int32)
    avg_case = (new_w > 0) & (ew > 0)
    over_case = (new_w != 0) & (ew <= 0)
    den = jnp.where(avg_case, ew + new_w, 1)
    avg_v = div_trunc(ev * ew + new_v * new_w, den)
    out_v = jnp.where(avg_case, avg_v, jnp.where(over_case, new_v, ev))
    out_w = jnp.where(avg_case, jnp.minimum(max_weight, ew + new_w),
                      jnp.where(over_case, new_w, ew))
    return LocalMapState(value=out_v.astype(jnp.int16),
                         weight=out_w.astype(jnp.int16),
                         pos=state.pos, offset=state.offset)
