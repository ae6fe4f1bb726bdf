"""Projective TSDF fusion — the production fusion path.

The ray-march formulation (ops/tsdf.py, parity with the reference's
cu_min_tsdf_krnl) is a SCATTER: ~10^7-10^8 conflicting voxel writes per
scan, resolved by atomics.  This module re-derives the same fusion as a
dense GATHER sweep, the classical projective TSDF
(KinectFusion lineage — also present in the reference as the
normal-based CPU variants, /root/reference/src/cpu/update_tsdf.cpp:35-394):

* the scan becomes a (columns, channels) BEAM TABLE — nearest return per
  beam (one small scatter-min over the scan, ~32K elements);
* every voxel of the window computes its (azimuth, elevation) wrt the
  scanner arithmetically, rounds to the nearest beam, and reads that
  beam's range/endpoint — per-voxel work is pure elementwise math plus
  one lookup into the 131K-entry table;
* signed distance = Euclidean distance voxel-center -> beam endpoint
  (exactly the march's ``value``), truncated to tau, negated behind the
  surface; the linear weight drop behind the surface and the
  interpolated-sample marker (negative weight) reproduce
  update_tsdf.cu:89-125's rules;
* angular acceptance reproduces the march's coverage: vertically the
  +-dz_per_distance ring-interpolation band, horizontally the ray's own
  cell footprint (res/2) — so voxels between diverging far-field columns
  stay untouched, like rays that never visit them;
* the same averaging merge as ops/tsdf.py folds the sweep into the map.

Cost model: touch every voxel once at bandwidth (the reference's
cu_avg_tsdf_krnl already does this every update): the int16 value and
weight planes are read and written once, 8 B/voxel, plus one lookup per
voxel into the ~1.5 MB beam table, which stays cache-resident.  Agreement
with the ray-march twin is validated statistically in tests (the two
formulations quantize ray coverage differently at cell boundaries).
"""
from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp

from ..core.consts import MATRIX_RESOLUTION, WEIGHT_RESOLUTION
from ..core.geometry import div_trunc
from ..map.local_map import LocalMapState, in_bounds
from .tsdf_reference import dz_per_distance


def check_fusion_config(tau: int, max_weight: int, vfov_deg: float) -> None:
    """Static-configuration guard shared by every projective fusion entry
    (single-device sweep and sharded twin).  Both arguments are static
    (Python ints/floats at trace time), so the check is free.

    * ``2 * tau * max_weight < 2^24``: the f32-exact averaging merge
      (``_div_trunc_by_pos``) is bit-identical to integer division only
      while the weighted sum |ev*ew + nv*nw| <= 2*tau*max_weight stays
      exactly representable in f32.
    * ``vfov_deg <= 90``: ``banded_atan``'s out-of-band rejection argument
      (|el| > 45 deg blows up monotonically and is rejected by ring_ok)
      only covers elevations the +-45-deg band can express.
    """
    if 2 * int(tau) * int(max_weight) >= (1 << 24):
        raise ValueError(
            f"2*tau*max_weight = {2 * int(tau) * int(max_weight)} >= 2^24: "
            "the f32-exact TSDF merge division would silently diverge from "
            "the integer reference (lower map.max_weight or max_distance)")
    if vfov_deg > 90.0:
        raise ValueError(
            f"vfov_deg = {vfov_deg} > 90: the banded-atan ring binning is "
            "only correct for vertical FOVs up to 90 degrees")


# ----------------------------------------------------------- shared angles
#
# One polynomial serves the single-device and the per-shard sweeps, so
# they stay bit-identical on every backend (a library atan2 may round
# differently per platform).  Odd minimax-style polynomial of degree 13 for atan over [-1, 1]:
# |err| < 3.8e-7 rad — the ring bin half-width is ~3.1e-3 rad and the
# vertical acceptance works in r*angle ~ 0.01 mm terms, both orders of
# magnitude above the polynomial error.

_ATAN_COEFFS = (
    0.9999983562999126, -0.3332313212264718, 0.1985179587326387,
    -0.13379591763197257, 0.08200914681344318, -0.0354820989980964,
    0.0073824108965324904)


def banded_atan(t: jax.Array) -> jax.Array:
    """atan(t) for |t| <= 1 (the +-45-deg band).  OUTSIDE the band the
    raw odd polynomial is provably >= pi/4 in magnitude and blows up
    monotonically (verified numerically over (1, 1e6]), so a consumer
    that rejects |elevation| > vfov/2 <= 45 deg rejects exactly the same
    set as a full atan would."""
    s = t * t
    p = jnp.float32(_ATAN_COEFFS[-1])
    for c in reversed(_ATAN_COEFFS[:-1]):
        p = p * s + jnp.float32(c)
    return p * t


def atan2_poly(y: jax.Array, x: jax.Array) -> jax.Array:
    """Polynomial atan2 (f32), quadrant-correct; (0, 0) -> 0."""
    ax_, ay_ = jnp.abs(x), jnp.abs(y)
    hi = jnp.maximum(jnp.maximum(ax_, ay_), 1e-20)
    t = jnp.minimum(ax_, ay_) / hi
    p = banded_atan(t)
    r = jnp.where(ay_ > ax_, jnp.float32(math.pi / 2) - p, p)
    r = jnp.where(x < 0, jnp.float32(math.pi) - r, r)
    return jnp.where(y < 0, -r, r)


# ------------------------------------------------------------- beam table

def build_beam_table(points: jax.Array, mask: jax.Array,
                     scanner_mm: jax.Array, R_sensor: jax.Array, *,
                     channels: int, columns: int, vfov_deg: float):
    """Scan -> nearest-return beam table.

    points: (N, 3) int32 mm (map frame); R_sensor: 3x3 f32 sensor->map
    rotation.  Returns (range_mm (columns*channels,) f32 with +inf holes,
    endpoint (columns*channels, 3) f32 mm).
    """
    d = (points - scanner_mm).astype(jnp.float32) @ R_sensor  # R^T rows
    rng = jnp.linalg.norm(d, axis=-1)
    ok = mask & (rng > 1.0)
    safe = jnp.maximum(rng, 1.0)
    az = jnp.arctan2(d[:, 1], d[:, 0])
    el = jnp.arcsin(jnp.clip(d[:, 2] / safe, -1.0, 1.0))

    spacing = math.radians(vfov_deg) / (channels - 1)
    half_v = math.radians(vfov_deg) / 2.0
    ring = jnp.round((half_v - el) / spacing).astype(jnp.int32)
    col = jnp.mod(jnp.round((az + math.pi) / (2 * math.pi) * columns)
                  .astype(jnp.int32), columns)
    ok = ok & (ring >= 0) & (ring < channels)
    flat = jnp.where(ok, col * channels + ring, columns * channels)

    # nearest return per beam: scatter-min of (range/8mm << 17 | point idx).
    # 14 range bits at 8 mm cover 131 m; 17 index bits cap the cloud at 128K
    # points (the reference's own registration cap, registration.cu:261).
    n = points.shape[0]
    assert n < (1 << 17), "beam table supports at most 128K points"
    key = (jnp.minimum(rng / 8.0, 2.0 ** 14 - 1).astype(jnp.int32) << 17) \
        | jnp.arange(n, dtype=jnp.int32)
    table = jnp.full((columns * channels,), jnp.int32(2 ** 30))
    table = table.at[flat].min(jnp.where(ok, key, 2 ** 30), mode="drop")
    hit = table < 2 ** 30
    idx = jnp.where(hit, table & ((1 << 17) - 1), 0)
    endpoint = jnp.where(hit[:, None], points[idx].astype(jnp.float32),
                         0.0)
    rng_tab = jnp.where(hit, jnp.linalg.norm(
        endpoint - scanner_mm.astype(jnp.float32), axis=-1), jnp.inf)
    return rng_tab, endpoint


# --------------------------------------------------------- projective sweep

def _global_coords(pos, offset, size):
    """Per-axis global voxel coordinate vectors in ARRAY order (ring-aware:
    global = pos + ((a - offset + s/2) mod s) - s/2)."""
    out = []
    for ax in range(3):
        a = jnp.arange(size[ax])
        s = size[ax]
        out.append(pos[ax] + jnp.mod(a - offset[ax] + s // 2, s) - s // 2)
    return out


@functools.partial(
    jax.jit,
    static_argnames=("size", "tau", "max_weight", "resolution", "channels",
                     "columns", "vfov_deg"),
    donate_argnames=("state",),
)
def tsdf_update_projective(state: LocalMapState, points: jax.Array,
                           points_mask: jax.Array, scanner_pos: jax.Array,
                           rotation: jax.Array, *, size: tuple[int, int, int],
                           tau: int, max_weight: int, resolution: int,
                           channels: int = 128, columns: int = 1024,
                           vfov_deg: float = 45.0) -> LocalMapState:
    """One projective fusion step (pure XLA).

    scanner_pos: (3,) int32 VOXEL coords; rotation: 3x3 f32 sensor->map.
    """
    check_fusion_config(tau, max_weight, vfov_deg)
    scanner_mm = scanner_pos * resolution + resolution // 2
    # the march drops whole rays whose endpoint falls outside the window
    # grown by tau/2 (ops/tsdf.py point_ok, update_tsdf.cu:69-75) — gate
    # beams identically so no free space is carved along dropped rays
    cell = jnp.floor_divide(points, resolution)
    points_mask = points_mask & in_bounds(
        cell, state.pos, jnp.asarray(size),
        -(tau // resolution // 2))
    rng_tab, endpoint = build_beam_table(
        points, points_mask, scanner_mm, rotation, channels=channels,
        columns=columns, vfov_deg=vfov_deg)

    new_v, new_w = _projective_sweep_xla(
        state, rng_tab, endpoint, scanner_mm, rotation, size=size, tau=tau,
        resolution=resolution, channels=channels, columns=columns,
        vfov_deg=vfov_deg)
    return _merge(state, new_v, new_w, max_weight)


def _projective_sweep_xla(state, rng_tab, endpoint, scanner_mm, rotation, *,
                          size, tau, resolution, channels, columns,
                          vfov_deg):
    """(new value, new weight) planes for the whole window."""
    gx, gy, gz = _global_coords(state.pos, state.offset, size)
    return projective_sweep_coords(
        gx, gy, gz, rng_tab, endpoint, scanner_mm, rotation, tau=tau,
        resolution=resolution, channels=channels, columns=columns,
        vfov_deg=vfov_deg)


def projective_sweep_coords(gx, gy, gz, rng_tab, endpoint, scanner_mm,
                            rotation, *, tau, resolution, channels, columns,
                            vfov_deg):
    """The sweep over an arbitrary box of global voxel coordinates — the
    shared core of the full-window sweep above and the per-shard sweep in
    parallel/sharded.py (each shard passes its own gx slice; the beam table
    is replicated, so the sweep needs no communication at all)."""
    cx = (gx * resolution + resolution // 2 - scanner_mm[0]).astype(jnp.float32)
    cy = (gy * resolution + resolution // 2 - scanner_mm[1]).astype(jnp.float32)
    cz = (gz * resolution + resolution // 2 - scanner_mm[2]).astype(jnp.float32)

    R = rotation.astype(jnp.float32)
    # sensor-frame direction d_s = R^T d, built from separable parts
    dsx = (cx[:, None, None] * R[0, 0] + cy[None, :, None] * R[1, 0]
           + cz[None, None, :] * R[2, 0])
    dsy = (cx[:, None, None] * R[0, 1] + cy[None, :, None] * R[1, 1]
           + cz[None, None, :] * R[2, 1])
    dsz = (cx[:, None, None] * R[0, 2] + cy[None, :, None] * R[1, 2]
           + cz[None, None, :] * R[2, 2])
    rho2 = dsx * dsx + dsy * dsy
    r_vox = jnp.sqrt(rho2 + dsz * dsz)

    # banded-atan arithmetic shared with the sharded sweep (bit parity);
    # |el| > 45 deg blows up and is rejected by ring_ok — requires
    # vfov <= 90 deg, which every supported sensor satisfies
    az = atan2_poly(dsy, dsx)
    inv_rho = 1.0 / jnp.maximum(jnp.sqrt(rho2), 1e-20)
    el = banded_atan(dsz * inv_rho)
    spacing = math.radians(vfov_deg) / (channels - 1)
    half_v = math.radians(vfov_deg) / 2.0
    ringf = jnp.clip((half_v - el) * (1.0 / spacing), -1e4, 1e4)
    ring = jnp.round(ringf).astype(jnp.int32)
    colf = (az + math.pi) * (columns / (2 * math.pi))
    col = jnp.mod(jnp.round(colf).astype(jnp.int32), columns)
    ring_ok = (ring >= 0) & (ring < channels)
    ring_c = jnp.clip(ring, 0, channels - 1)

    flat = col * channels + ring_c
    r_beam = rng_tab[flat]
    ex = endpoint[:, 0][flat]
    ey = endpoint[:, 1][flat]
    ez = endpoint[:, 2][flat]

    return _projective_math(
        cx[:, None, None] + jnp.zeros_like(r_vox),
        cy[None, :, None] + jnp.zeros_like(r_vox),
        cz[None, None, :] + jnp.zeros_like(r_vox),
        r_vox, ringf, ring, ring_ok, colf, r_beam,
        ex - scanner_mm[0], ey - scanner_mm[1], ez - scanner_mm[2],
        tau=tau, resolution=resolution, channels=channels, columns=columns,
        vfov_deg=vfov_deg)


def _projective_math(dx, dy, dz, r_vox, ringf, ring, ring_ok, colf, r_beam,
                     bx, by, bz, *, tau, resolution, channels, columns,
                     vfov_deg):
    """Shared per-voxel fusion math of the projective sweep.  All positions are relative to the scanner (mm, f32).

    Returns (value int16-ranged int32, weight int32) planes.
    """
    spacing = math.radians(vfov_deg) / (channels - 1)
    dzpd = dz_per_distance(channels, vfov_deg)          # fixed-point slope
    weight_epsilon = tau // 10

    # Euclidean distance voxel-center -> beam endpoint (the march's value)
    value = jnp.sqrt((dx - bx) ** 2 + (dy - by) ** 2 + (dz - bz) ** 2)
    value = jnp.minimum(value, float(tau))
    behind = r_vox > r_beam
    value = jnp.where(behind, -value, value)

    # vertical acceptance: the ring-interpolation band +-dz_per_distance
    # (update_tsdf.cu:101-125); horizontal: the ray's own cell footprint.
    # Divisions by non-pow2 constants are reciprocal multiplies (one
    # rounding rule everywhere keeps the single-device and sharded sweeps
    # bit-identical)
    delta_z = dzpd * r_vox * (1.0 / MATRIX_RESOLUTION)
    v_res = r_vox * jnp.abs(ringf - ring.astype(jnp.float32)) * spacing
    vertical_ok = v_res <= jnp.maximum(delta_z, resolution * 0.5)
    col_res = jnp.abs(colf - jnp.round(colf))
    h_res = r_vox * col_res * (2 * math.pi / columns)
    horizontal_ok = h_res <= resolution * 0.5

    interp = v_res > resolution * 0.5                    # off-ray band
    w = jnp.where(
        value < -weight_epsilon,
        jnp.floor((WEIGHT_RESOLUTION * (tau + value))
                  * (1.0 / (tau - weight_epsilon))),
        float(WEIGHT_RESOLUTION)).astype(jnp.int32)
    ok = (ring_ok & jnp.isfinite(r_beam) & vertical_ok & horizontal_ok
          & (r_vox <= r_beam + tau) & (w != 0))
    w = jnp.where(interp, -w, w)
    value_i = jnp.trunc(value).astype(jnp.int32)
    return (jnp.where(ok, value_i, 0), jnp.where(ok, w, 0))


def _div_trunc_by_pos(a: jax.Array, b: jax.Array) -> jax.Array:
    """C-style trunc division for int32 ``a`` by POSITIVE int32 ``b``,
    computed in f32 with an exact +-1 correction — bit-identical to the
    integer division whenever |a| < 2^24 and |a| + b < 2^24 (all operands
    and the remainder are then exactly representable, so the corrections
    are exact).  Why: integer division is a long instruction sequence on
    vector units; this form is ~6 cheap vector ops."""
    af = jnp.abs(a).astype(jnp.float32)
    bf = b.astype(jnp.float32)
    q = jnp.floor(af / bf)
    r = af - q * bf                      # exact: both products are ints<2^24
    q = q + (r >= bf).astype(jnp.float32) - (r < 0).astype(jnp.float32)
    qi = q.astype(jnp.int32)
    return jnp.where(a < 0, -qi, qi)


def _merge_planes(ev, ew, new_v, new_w, max_weight):
    """Elementwise weighted-averaging merge on int32 planes — the shared
    core of the single-device and sharded sweeps (parity cu_avg_tsdf_krnl
    update_tsdf.cu:13-43).  Returns (value, weight) int32.

    The weighted average |ev*ew + nv*nw| is bounded by 2*tau*max_weight;
    the f32-exact division below requires that < 2^24 (16.7M) — true for
    every supported configuration (tau <= 3 m, max_weight <= 2048) and
    asserted conservatively where static bounds are known."""
    avg_case = (new_w > 0) & (ew > 0)
    over_case = (new_w != 0) & (ew <= 0)
    den = jnp.where(avg_case, ew + new_w, 1)
    avg_v = _div_trunc_by_pos(ev * ew + new_v * new_w, den)
    out_v = jnp.where(avg_case, avg_v, jnp.where(over_case, new_v, ev))
    out_w = jnp.where(avg_case, jnp.minimum(max_weight, ew + new_w),
                      jnp.where(over_case, new_w, ew))
    return out_v, out_w


def _merge(state: LocalMapState, new_v, new_w, max_weight) -> LocalMapState:
    """Weighted averaging merge — identical to the ray-march op's sweep
    (ops/tsdf.py, parity cu_avg_tsdf_krnl update_tsdf.cu:13-43)."""
    out_v, out_w = _merge_planes(state.value.astype(jnp.int32),
                                 state.weight.astype(jnp.int32),
                                 new_v, new_w, max_weight)
    return LocalMapState(value=out_v.astype(jnp.int16),
                         weight=out_w.astype(jnp.int16),
                         pos=state.pos, offset=state.offset)
