"""Device (XLA) point-to-TSDF Gauss-Newton registration.

Re-design of the CUDA pair ``calc_jacobis_krnl`` +
``h_g_e_reduction_krnl`` (src/warpsense/cuda/registration.cu:14-257) and the
host GN loop (src/warpsense/tsdf_registration.cpp:28-105):

* the TSDF gradient (masked central differences with the reference's
  sign-change/empty-cell rejection) depends only on the CELL, so it is
  precomputed once per map change as dense rolled sweeps (HBM bandwidth,
  not latency) and packed with value/weight into 3 int32 planes
  (``precompute_fields``); each GN iteration is then 3 random gathers
  instead of the naive 14 (random gathers from the window are bound by
  memory latency — the dominant cost at this point count),
  J = [p x grad, grad];
* the 27-scalar reduction (H 6x6 symmetric, g 6, error, count) is two small
  matmuls: ``H = Js^T Js``, ``g = Js^T v`` — no shared-memory
  tree, no 32-partial host reduce, no per-iteration host round trip;
* the *entire* <=max_iterations GN loop runs inside one jitted
  ``lax.while_loop`` — pose update, 6x6 solve, Levenberg damping and the
  reference's 4-error convergence window all stay on device.  The reference
  instead uploads the pose and downloads partials every iteration
  (registration.cu:351-361).

Numerics: the reference accumulates H and g in int64.  f32 matmuls with
*column scaling* give the same GN step to ~1e-6 relative: scale columns of J
by D = diag([sc]*3, [sg]*3), solve (D H D + a c D^2) y = -D g, then
xi = D y — an exact reparametrization of (H + a c I) xi = -g, but with all
matmul operands O(1)-ranged so f32 is sufficient.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core.consts import MATRIX_RESOLUTION
from ..core.geometry import div_trunc, transform_point_fixed, xi_to_transform
from ..map.local_map import (LocalMapState, in_bounds, ring_coords,
                             ring_index)

# Column scaling: cross terms ~ p[mm] * grad[mm] ~ 2e4 * 1e3; grad ~ 1e3.
_SC = 1.0 / (1 << 24)
_SG = 1.0 / (1 << 10)


# ------------------------------------------------------- precomputed fields
#
# A random gather from the ~100M-voxel window is bound by memory latency,
# not bandwidth.  The naive per-iteration Jacobian needs 14 gathers (7
# cells x value+weight); but the TSDF gradient, its validity rejection, and the cell value depend
# ONLY on the cell — not the pose — so they are precomputed ONCE per map
# change as dense rolled sweeps (pure bandwidth) and packed into three
# int32 planes.  Each GN iteration then costs 3 gathers instead of 14, and
# the precompute amortizes across every scan until the next TSDF update.

class RegistrationFields(NamedTuple):
    """Packed per-voxel registration fields (int32 planes, (X, Y, Z)).

    vw = weight<<16 | value;  gxy = gy<<16 | gx;  gz = gz (low half)."""
    vw: jax.Array
    gxy: jax.Array
    gz: jax.Array


def _pack16(lo: jax.Array, hi: jax.Array) -> jax.Array:
    return ((hi.astype(jnp.int32) & 0xFFFF) << 16) | (lo.astype(jnp.int32)
                                                      & 0xFFFF)


def _unpack_lo(x: jax.Array) -> jax.Array:
    return (x << 16) >> 16          # arithmetic shift: sign-extended low half


def _unpack_hi(x: jax.Array) -> jax.Array:
    return x >> 16


@jax.jit
def precompute_fields(state: LocalMapState) -> RegistrationFields:
    """Dense value/weight/gradient planes from the map window.

    The central difference with sign-change / empty-neighbor rejection is
    exactly the reference's per-point rule (registration.cu:225-246) hoisted
    to per-voxel; ring wrap via roll matches the ring index arithmetic, and
    window-edge cells (whose rolled neighbors alias the opposite edge) are
    excluded by the same in_bounds(buffer=1) gate as the reference.
    """
    v = state.value.astype(jnp.int32)
    w = state.weight.astype(jnp.int32)
    grads = []
    for ax in range(3):
        nv = jnp.roll(v, -1, axis=ax)
        pv = jnp.roll(v, 1, axis=ax)
        nw = jnp.roll(w, -1, axis=ax)
        pw = jnp.roll(w, 1, axis=ax)
        sign_change = ((nv > 0) & (pv < 0)) | ((nv < 0) & (pv > 0))
        ok = (nw != 0) & (pw != 0) & ~sign_change
        grads.append(jnp.where(ok, div_trunc(nv - pv, 2), 0))
    return RegistrationFields(vw=_pack16(v, w),
                              gxy=_pack16(grads[0], grads[1]),
                              gz=_pack16(grads[2], jnp.zeros_like(v)))


def jacobian_stats_fields(fields: RegistrationFields, pos: jax.Array,
                          offset: jax.Array, points: jax.Array,
                          mask: jax.Array, total_transform: jax.Array, *,
                          size: tuple[int, int, int], resolution: int,
                          normalize_gradient: bool = False):
    """One iteration's scaled normal-equation statistics from precomputed
    fields — 3 gathers per iteration.

    Returns (Hs 6x6 f32, gs 6 f32, e f32, c f32) where Hs = D H D and
    gs = D g for D = diag([_SC]*3, [_SG]*3).
    points: (N, 3) int32 mm; mask: (N,) bool.
    """
    int_mat = jnp.trunc(total_transform.astype(jnp.float32)
                        * MATRIX_RESOLUTION).astype(jnp.int32)
    center = total_transform[:3, 3].astype(jnp.int32)  # C cast truncation

    pts = transform_point_fixed(points, int_mat)
    # floor cells, matching the fusion op's voxel addressing (see
    # ops/tsdf.py on the deliberate deviation from the reference's trunc)
    buf = jnp.floor_divide(pts, resolution)
    p = (pts - center).astype(jnp.float32)

    valid = mask & in_bounds(buf, pos, jnp.asarray(size), 1)
    a = ring_coords(buf, pos, offset, size)
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]

    vw = fields.vw[a0, a1, a2]
    cur_v = _unpack_lo(vw)
    cur_w = _unpack_hi(vw)
    valid = valid & (cur_w != 0)
    gxy = fields.gxy[a0, a1, a2]
    gz = fields.gz[a0, a1, a2]
    grad = jnp.stack([_unpack_lo(gxy), _unpack_hi(gxy), _unpack_lo(gz)],
                     axis=-1).astype(jnp.float32)          # (N, 3)
    if normalize_gradient:
        # proper directional derivative (mm per mm instead of mm per voxel):
        # turns the reference's ~1/resolution-scaled creep steps into true
        # Gauss-Newton steps (an improvement mode, not parity).
        grad = grad / float(resolution)

    cross = jnp.cross(p, grad)                              # (N, 3)
    Js = jnp.concatenate([cross * _SC, grad * _SG], axis=-1)  # (N, 6)
    vf = valid.astype(jnp.float32)
    Js = Js * vf[:, None]
    v = cur_v.astype(jnp.float32) * vf

    H = Js.T @ Js                                           # 6x6
    g = Js.T @ v
    e = jnp.sum(jnp.abs(v))
    c = jnp.sum(vf)
    return H, g, e, c


@functools.partial(
    jax.jit,
    static_argnames=("size", "resolution", "max_iterations", "mode"),
)
def register_cloud(state: LocalMapState, points: jax.Array, mask: jax.Array,
                   pretransform: jax.Array, *, size: tuple[int, int, int],
                   resolution: int, max_iterations: int,
                   it_weight_gradient: float, epsilon: float,
                   mode: str = "parity") -> jax.Array:
    """Full GN registration; returns the refined 4x4 pose (f32).

    Convergence: |err - prev[2]| < eps and |err - prev[0]| < eps over the
    4-error sliding window (tsdf_registration.cpp:81-93).

    ``mode``:
    * ``"parity"`` — the reference's exact scheme: un-normalized voxel
      gradient (so steps creep at ~1/resolution of the GN step) and the
      rotation centered on the *initial* pretransform translation.
    * ``"fast"`` — resolution-normalized gradients (true GN steps) and
      per-iteration recentering on the current pose translation; converges
      in a handful of iterations and avoids the parity mode's coupling of
      far-from-origin rotation with translation.
    """
    fields = precompute_fields(state)
    return _gn_loop(fields, state.pos, state.offset, points, mask,
                    pretransform, size=size, resolution=resolution,
                    max_iterations=max_iterations,
                    it_weight_gradient=it_weight_gradient, epsilon=epsilon,
                    mode=mode)


@functools.partial(
    jax.jit,
    static_argnames=("size", "resolution", "max_iterations", "mode"),
)
def register_cloud_fields(fields: RegistrationFields, pos: jax.Array,
                          offset: jax.Array, points: jax.Array,
                          mask: jax.Array, pretransform: jax.Array, *,
                          size: tuple[int, int, int], resolution: int,
                          max_iterations: int, it_weight_gradient: float,
                          epsilon: float, mode: str = "parity") -> jax.Array:
    """``register_cloud`` against cached ``precompute_fields`` output —
    the pipeline hot path: fields stay valid until the next TSDF update or
    shift, so most scans skip the dense precompute entirely."""
    return _gn_loop(fields, pos, offset, points, mask, pretransform,
                    size=size, resolution=resolution,
                    max_iterations=max_iterations,
                    it_weight_gradient=it_weight_gradient, epsilon=epsilon,
                    mode=mode)


def _gn_loop(fields, pos, offset, points, mask, pretransform, *, size,
             resolution, max_iterations, it_weight_gradient, epsilon, mode):
    fast = mode == "fast"
    center = pretransform[:3, 3].astype(jnp.int32)
    D = jnp.concatenate([jnp.full((3,), _SC, jnp.float32),
                         jnp.full((3,), _SG, jnp.float32)])

    def cond(carry):
        i, _, _, _, finished = carry
        return (i < max_iterations) & ~finished

    def body(carry):
        i, total, alpha, prev, _ = carry
        H, g, e, c = jacobian_stats_fields(fields, pos, offset, points,
                                           mask, total, size=size,
                                           resolution=resolution,
                                           normalize_gradient=fast)
        # (D H D + alpha c D^2) y = -D g;  xi = D y
        A = H + alpha * c * jnp.diag(D * D)
        empty = c <= 0.0
        A = jnp.where(empty, jnp.eye(6, dtype=jnp.float32), A)
        y = jnp.linalg.solve(A, -g)
        # a singular H (sparse coverage -> zero-gradient directions) gives a
        # non-finite solve while alpha is still 0 — skip the step and let
        # the Levenberg damping grow; only an empty system terminates
        ok = ~empty & jnp.all(jnp.isfinite(y))
        xi = jnp.where(ok, D * y, jnp.zeros(6, jnp.float32))
        ctr = total[:3, 3].astype(jnp.int32) if fast else center
        transform = xi_to_transform(xi, ctr)
        total = jnp.where(ok, transform @ total, total)

        err = e / jnp.maximum(c, 1.0)
        finished = (ok & (jnp.abs(err - prev[2]) < epsilon)
                    & (jnp.abs(err - prev[0]) < epsilon)) | empty
        prev = jnp.concatenate([prev[1:], err[None]])
        return i + 1, total, alpha + it_weight_gradient, prev, finished

    init = (jnp.int32(0), pretransform.astype(jnp.float32), jnp.float32(0.0),
            jnp.zeros((4,), jnp.float32), jnp.bool_(False))
    _, total, _, _, _ = jax.lax.while_loop(cond, body, init)
    return total


# ------------------------------------------------- packed fast path (1 gather)
#
# The per-iteration cost of the GN loop scales with the number of random
# gathers per point — so the fast path packs value + 3-axis gradient +
# validity into ONE int32 plane (byte layout v:8|gx:8|gy:8|gz:8,
# quantization shifts derived statically from tau) and pays a single
# gather per iteration instead of 3 (or the naive 14).
#
# The byte-quantized gradient (step = tau/127 rounded to a power of two,
# e.g. 8 mm at tau=600) also enables GRADIENT-INTERPOLATED residuals:
# r = v + g . (p - cell_center) / resolution — continuous sub-voxel residuals
# that supersede the reference's nearest-cell quantization
# (registration.cu:225-246) at zero extra gather cost.

class PackedFields(NamedTuple):
    """Single-plane packed registration fields (int32, (X, Y, Z)).

    Byte layout (MSB..LSB): v:8 | gx:8 | gy:8 | gz:8.  v byte 0 = invalid
    (weight 0); valid v code = (value >> vshift) + 128 in [1, 255]; gradient
    codes = (g >> gshift) + 128.  Shifts are static functions of tau."""
    plane: jax.Array


class PackedFields2(NamedTuple):
    """Two-plane EXACT packed fields (int32, (X, Y, Z)) — full int16
    precision at 2 gathers/iteration: a = v:16|gx:16, b = gy:16|gz:16;
    invalid (weight 0) is the sentinel v = -32768."""
    plane_a: jax.Array
    plane_b: jax.Array


def _pack_shift(tau: int, limit: int) -> int:
    s = 0
    while (tau >> s) > limit:
        s += 1
    return s


def packed_shifts(tau: int) -> tuple[int, int]:
    """(vshift, gshift): minimal power-of-two quantization for tau."""
    return _pack_shift(tau, 126), _pack_shift(tau, 126)


def _rshift_round(x, s):
    # round-to-nearest quantization (plain >> floors: a -2^(s-1) bias)
    return (x + (1 << s >> 1)) >> s if s else x


def packed_plane_from_neighbors(v, w, neighbors, *, tau: int) -> jax.Array:
    """Pack (value, per-axis central-difference gradient) into the one-plane
    byte layout from int32 ``v``/``w`` and per-axis neighbor tuples
    ``neighbors = [(nv, pv, nw, pw)] * 3``.  Shared by the dense precompute
    (roll neighbors) and the sharded precompute (halo-exchange neighbors on
    the partitioned axis).

    NO sign-change rejection (unlike the parity fields /
    registration.cu:225-246): the crossing cells carry the LARGEST and most
    informative signed-TSDF gradient, and the interpolated residual needs
    it exactly there."""
    vs, gs = packed_shifts(tau)
    codes = []
    for nv, pv, nw, pw in neighbors:
        ok = (nw != 0) & (pw != 0)
        g = jnp.where(ok, div_trunc(nv - pv, 2), 0)
        codes.append(jnp.clip(_rshift_round(g, gs) + 128, 1, 255))
    vcode = jnp.where(w != 0,
                      jnp.clip(_rshift_round(v, vs) + 128, 1, 255), 0)
    return ((vcode << 24) | (codes[0] << 16) | (codes[1] << 8) | codes[2])


@functools.partial(jax.jit, static_argnames=("tau",))
def precompute_fields_packed(state: LocalMapState, *,
                             tau: int) -> PackedFields:
    """One-plane packed twin of ``precompute_fields`` — fast-path rule:
    weight-validity masking only, NO sign-change rejection (see
    ``packed_plane_from_neighbors``)."""
    v = state.value.astype(jnp.int32)
    w = state.weight.astype(jnp.int32)
    neighbors = [(jnp.roll(v, -1, axis=ax), jnp.roll(v, 1, axis=ax),
                  jnp.roll(w, -1, axis=ax), jnp.roll(w, 1, axis=ax))
                 for ax in range(3)]
    return PackedFields(
        plane=packed_plane_from_neighbors(v, w, neighbors, tau=tau))


@jax.jit
def precompute_fields_packed2(state: LocalMapState) -> PackedFields2:
    """Exact (unquantized) two-plane packing — fast-path gradient rule:
    weight-validity masking only, no sign-change rejection."""
    v = state.value.astype(jnp.int32)
    w = state.weight.astype(jnp.int32)
    grads = []
    for ax in range(3):
        nv = jnp.roll(v, -1, axis=ax)
        pv = jnp.roll(v, 1, axis=ax)
        nw = jnp.roll(w, -1, axis=ax)
        pw = jnp.roll(w, 1, axis=ax)
        ok = (nw != 0) & (pw != 0)   # no sign-change rejection (see above)
        grads.append(jnp.where(ok, div_trunc(nv - pv, 2), 0))
    vsent = jnp.where(w != 0, v, -32768)
    return PackedFields2(plane_a=_pack16(vsent, grads[0]),
                         plane_b=_pack16(grads[1], grads[2]))


def _decode_packed(code: jax.Array, vs: int, gs: int):
    vcode = (code >> 24) & 0xFF
    valid = vcode != 0
    v = (vcode - 128) << vs
    gx = (((code >> 16) & 0xFF) - 128) << gs
    gy = (((code >> 8) & 0xFF) - 128) << gs
    gz = ((code & 0xFF) - 128) << gs
    grad = jnp.stack([gx, gy, gz], axis=-1)
    return valid, v, grad


_SCP = 1.0 / (1 << 15)   # cross columns ~ p[mm] * unit-grad


@functools.partial(
    jax.jit,
    static_argnames=("size", "resolution", "tau", "max_iterations", "interp",
                     "coarse_iterations", "gather_freeze"),
)
def register_cloud_packed(fields: PackedFields, pos: jax.Array,
                          offset: jax.Array, points: jax.Array,
                          mask: jax.Array, pretransform: jax.Array, *,
                          size: tuple[int, int, int], resolution: int,
                          tau: int, max_iterations: int,
                          it_weight_gradient: float, epsilon: float,
                          interp: bool = True, coarse_iterations: int = 0,
                          gather_freeze: bool = False):
    """Fast-mode GN registration against packed fields — the pipeline hot
    path.  One gather per iteration; resolution-normalized gradients (true
    GN steps); per-iteration recentering; optional gradient-interpolated
    residuals (``interp``).

    Returns ``(pose 4x4 f32, iterations int32, final_err f32)`` — the
    iteration count the reference never measures (tsdf_registration.cpp
    runs blind to its own convergence).

    Solver: adaptive Levenberg-Marquardt with Marquardt diagonal scaling
    (A = H + alpha diag(H)) and delayed accept/reject — each iteration
    costs exactly one stats pass (one gather); a rejected trial reuses the
    accepted state's cached (H, g) with a larger alpha.  This replaces the
    reference's blind linear damping ramp (H += it_weight_gradient * i * c
    * I, tsdf_registration.cpp:67), which throttles true-GN steps into
    ~100-iteration creep; adaptive LM converges the same problems in <20.

    Convergence: accepted step below the residual-quantization noise floor
    (0.5 mm translation, 3e-4 rad) with error improvement below
    ``epsilon`` (mm, the reference's epsilon role).

    ``gather_freeze``: once an ACCEPTED step falls below one voxel, stop
    re-gathering the fields table and
    iterate on the cached per-point values/gradients — the per-iteration
    cost is dominated by the latency-bound 32K-element gather (the
    stats math is elementwise over 32K points), so the
    sub-voxel refinement tail becomes ~free.  The interpolated residual
    extrapolates smoothly across the small pose updates; the final
    accepted pose differs from the re-gathering loop only when a cell
    boundary is crossed after freezing, bounded by the one-voxel gate
    (accuracy pinned by the recovery/ATE/stress tests).
    """
    stats = make_packed_stats(fields, pos, offset, points, mask, size=size,
                              resolution=resolution, tau=tau, interp=interp)
    stats_coarse = None
    if coarse_iterations > 0:
        # 1-in-4 deterministic subsample for the early iterations (the
        # dedup'd cloud has no organized structure for a stride to alias)
        stats_coarse = make_packed_stats(
            fields, pos, offset, points[::4], mask[::4], size=size,
            resolution=resolution, tau=tau, interp=interp)
    split = (make_packed_stats_split(
        fields, pos, offset, points, mask, size=size,
        resolution=resolution, tau=tau, interp=interp)
        if gather_freeze else None)
    del it_weight_gradient   # parity-mode ramp; LM adapts alpha itself
    return _lm_loop(stats, pretransform, max_iterations=max_iterations,
                    epsilon=epsilon, stats_coarse=stats_coarse,
                    coarse_iterations=coarse_iterations, split=split,
                    freeze_step_mm=float(resolution))


def make_packed_stats(fields, pos, offset, points, mask, *, size, resolution,
                      tau, interp, index_fn=None):
    """Build the per-iteration ``stats(total) -> (H, g, e, c)`` closure over
    packed fields.  ``index_fn(buf) -> (coords (N, 3), owned)``: optional
    override of the plane indexing — the sharded path maps global cells to
    shard-LOCAL array coords and gates by shard ownership; the default is
    the full-window ring coords with every in-bounds cell owned."""
    vs, gs = packed_shifts(tau)
    exact = isinstance(fields, PackedFields2)
    szv = jnp.asarray(size)

    def stats(total):
        int_mat = jnp.trunc(total * MATRIX_RESOLUTION).astype(jnp.int32)
        pts = transform_point_fixed(points, int_mat)
        buf = jnp.floor_divide(pts, resolution)
        valid = mask & in_bounds(buf, pos, szv, 1)
        if index_fn is None:
            a = ring_coords(buf, pos, offset, size)
        else:
            a, owned = index_fn(buf)
            valid = valid & owned
        a = jnp.where(valid[:, None], a, 0)
        a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
        if exact:
            pa = fields.plane_a[a0, a1, a2]
            pb = fields.plane_b[a0, a1, a2]
            v = _unpack_lo(pa)
            ok = v != -32768
            grad = jnp.stack([_unpack_hi(pa), _unpack_lo(pb),
                              _unpack_hi(pb)], axis=-1)
        else:
            ok, v, grad = _decode_packed(fields.plane[a0, a1, a2], vs, gs)
        valid = valid & ok
        gradf = grad.astype(jnp.float32) / float(resolution)   # mm per mm
        vf32 = v.astype(jnp.float32)
        if interp:
            # continuous residual: value + gradient x within-cell offset
            cc = buf * resolution + resolution // 2
            dpos = (pts - cc).astype(jnp.float32)
            vf32 = vf32 + jnp.sum(gradf * dpos, axis=-1)
        ctr = total[:3, 3]
        p = pts.astype(jnp.float32) - ctr
        cross = jnp.cross(p, gradf)
        vfm = valid.astype(jnp.float32)
        Js = jnp.concatenate([cross * _SCP, gradf], axis=-1) * vfm[:, None]
        r = vf32 * vfm
        H = Js.T @ Js
        g = Js.T @ r
        e = jnp.sum(jnp.abs(r))
        c = jnp.sum(vfm)
        return H, g, e, c

    return stats


def make_packed_stats_split(fields, pos, offset, points, mask, *, size,
                            resolution, tau, interp, index_fn=None):
    """(gather_fn, eval_fn) split of ``make_packed_stats``:
    ``cache = gather_fn(total)`` performs the expensive table gather +
    decode for the cells under ``total``; ``eval_fn(cache, total)``
    computes (H, g, e, c) for any nearby pose from the cache (pure
    vector math).  ``eval_fn(gather_fn(T), T)`` is bit-identical to
    ``make_packed_stats(...)(T)``."""
    vs, gs = packed_shifts(tau)
    exact = isinstance(fields, PackedFields2)
    szv = jnp.asarray(size)

    def _pts(total):
        int_mat = jnp.trunc(total * MATRIX_RESOLUTION).astype(jnp.int32)
        return transform_point_fixed(points, int_mat)

    def gather_fn(total):
        pts = _pts(total)
        buf = jnp.floor_divide(pts, resolution)
        valid = mask & in_bounds(buf, pos, szv, 1)
        if index_fn is None:
            a = ring_coords(buf, pos, offset, size)
        else:
            a, owned = index_fn(buf)
            valid = valid & owned
        a = jnp.where(valid[:, None], a, 0)
        a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
        if exact:
            pa = fields.plane_a[a0, a1, a2]
            pb = fields.plane_b[a0, a1, a2]
            v = _unpack_lo(pa)
            ok = v != -32768
            grad = jnp.stack([_unpack_hi(pa), _unpack_lo(pb), _unpack_hi(pb)],
                             axis=-1)
        else:
            ok, v, grad = _decode_packed(fields.plane[a0, a1, a2], vs, gs)
        valid = valid & ok
        gradf = grad.astype(jnp.float32) / float(resolution)
        cc = buf * resolution + resolution // 2
        return dict(valid=valid, v=v.astype(jnp.float32), gradf=gradf,
                    cc=cc)

    def eval_fn(cache, total):
        pts = _pts(total)
        vf32 = cache["v"]
        gradf = cache["gradf"]
        if interp:
            dpos = (pts - cache["cc"]).astype(jnp.float32)
            vf32 = vf32 + jnp.sum(gradf * dpos, axis=-1)
        ctr = total[:3, 3]
        p = pts.astype(jnp.float32) - ctr
        cross = jnp.cross(p, gradf)
        vfm = cache["valid"].astype(jnp.float32)
        Js = jnp.concatenate([cross * _SCP, gradf], axis=-1) * vfm[:, None]
        r = vf32 * vfm
        return Js.T @ Js, Js.T @ r, jnp.sum(jnp.abs(r)), jnp.sum(vfm)

    return gather_fn, eval_fn


def _lm_loop(stats, pretransform, *, max_iterations, epsilon,
             stats_coarse=None, coarse_iterations: int = 0, split=None,
             freeze_step_mm: float = 0.0):
    """Adaptive-LM driver over a ``stats(total)`` closure (see
    ``register_cloud_packed``); shared by the single-chip and sharded fast
    paths (the sharded stats closure psums its outputs — the loop itself is
    replicated and stays bit-identical across devices).

    ``stats_coarse``: optional cheaper closure (subsampled points) used
    for the first ``coarse_iterations`` — the per-iteration cost is one
    latency-bound gather proportional to the point count, and the early
    LM steps don't need full resolution (coarse-to-fine).

    ``split``: optional ``(gather_fn, eval_fn)`` pair enabling gather
    freezing: once an accepted step is below ``freeze_step_mm``, the
    cached gather is reused for every later iteration (see
    ``register_cloud_packed``'s gather_freeze)."""
    D = jnp.concatenate([jnp.full((3,), _SCP, jnp.float32),
                         jnp.full((3,), 1.0, jnp.float32)])

    def cond(carry):
        return (carry[0] < max_iterations) & ~carry[-1]

    if split is not None:
        gather_fn, eval_fn = split

    def body(carry):
        if split is None:
            i, acc, accH, accg, acc_err, alpha, trial, prev, _ = carry
            if stats_coarse is None:
                H, g, e, c = stats(trial)
            else:
                H, g, e, c = jax.lax.cond(i < coarse_iterations,
                                          stats_coarse, stats, trial)
        else:
            (i, acc, accH, accg, acc_err, alpha, trial, prev, cache,
             frozen, _) = carry
            coarse_now = (i < coarse_iterations if stats_coarse is not None
                          else jnp.bool_(False))
            # init cache was built at trial=p0; with a coarse phase it is
            # stale by hand-off, so the first fine iteration re-gathers
            reuse = frozen | ((i == 0) & (coarse_iterations == 0))
            cache = jax.lax.cond(reuse | coarse_now, lambda t: cache,
                                 gather_fn, trial)
            if stats_coarse is None:
                H, g, e, c = eval_fn(cache, trial)
            else:
                # coarse-then-freeze: subsampled stats for the early LM
                # rounds, then the split (freezable) fine evaluation
                H, g, e, c = jax.lax.cond(
                    coarse_now, stats_coarse,
                    lambda t: eval_fn(cache, t), trial)
        err = jnp.where(c > 0.0, e / jnp.maximum(c, 1.0), jnp.inf)

        # the coarse->fine hand-off re-baselines: the first full-resolution
        # evaluation becomes the accepted state AND the accepted error
        # (coarse and fine error populations differ slightly; comparing
        # across them would spuriously reject/stall)
        improved = err <= acc_err
        if stats_coarse is not None:
            rebase = i == coarse_iterations
            improved = improved | rebase
            err2 = jnp.where(rebase, err, jnp.minimum(err, acc_err))
        else:
            err2 = jnp.minimum(err, acc_err)
        acc2 = jnp.where(improved, trial, acc)
        H2 = jnp.where(improved, H, accH)
        g2 = jnp.where(improved, g, accg)
        alpha2 = jnp.clip(jnp.where(improved, alpha / 3.0, alpha * 4.0),
                          1e-5, 1e5)

        dH = jnp.diag(jnp.diag(H2)) + 1e-12 * jnp.eye(6, dtype=jnp.float32)
        y = jnp.linalg.solve(H2 + alpha2 * dH, -g2)
        ok = jnp.isfinite(err2) & jnp.all(jnp.isfinite(y))
        xi = jnp.where(ok, D * y, jnp.zeros(6, jnp.float32))
        trial2 = xi_to_transform(xi, acc2[:3, 3].astype(jnp.int32)) @ acc2

        # Converged: an accepted round whose next step is below the
        # residual noise floor (0.5 mm translation, 3e-4 rad) — when alpha
        # is large here, repeated rejections already proved a local
        # minimum — or the reference-style 4-round window on the ACCEPTED
        # error (|e - prev[0,2]| < epsilon, tsdf_registration.cpp:81-93;
        # under rejections the accepted error is flat, so the window doubles
        # as a stagnation stop).
        tiny = (improved & (jnp.sum(xi[:3] * xi[:3]) < 1e-7)
                & (jnp.sum(xi[3:] * xi[3:]) < 0.25))
        window = ((jnp.abs(err2 - prev[2]) < epsilon)
                  & (jnp.abs(err2 - prev[0]) < epsilon))
        finished = tiny | window | ~ok
        prev2 = jnp.concatenate([prev[1:], err2[None]])
        if split is None:
            return i + 1, acc2, H2, g2, err2, alpha2, trial2, prev2, finished
        # freeze once an ACCEPTED sub-half-voxel step proves the cells
        # stable (translation below freeze_step_mm, rotation < 1 mrad;
        # xi layout: [:3] rotation rad, [3:] translation mm); never while
        # still in the coarse phase (the fine cache isn't live yet)
        frozen2 = frozen | (improved & (i >= coarse_iterations)
                            & (jnp.sum(xi[3:] * xi[3:])
                               < freeze_step_mm * freeze_step_mm)
                            & (jnp.sum(xi[:3] * xi[:3]) < 1e-6))
        return (i + 1, acc2, H2, g2, err2, alpha2, trial2, prev2, cache,
                frozen2, finished)

    p0 = pretransform.astype(jnp.float32)
    eye6 = jnp.eye(6, dtype=jnp.float32)
    base = (jnp.int32(0), p0, eye6, jnp.zeros((6,), jnp.float32),
            jnp.float32(jnp.inf), jnp.float32(1e-3), p0,
            jnp.full((4,), jnp.inf, jnp.float32))
    if split is None:
        init = base + (jnp.bool_(False),)
        iters, acc, _, _, err, _, _, _, _ = jax.lax.while_loop(
            cond, body, init)
        return acc, iters, err
    init = base + (gather_fn(p0), jnp.bool_(False), jnp.bool_(False))
    out = jax.lax.while_loop(cond, body, init)
    iters, acc, err = out[0], out[1], out[4]
    return acc, iters, err


def jacobian_stats(state: LocalMapState, points: jax.Array, mask: jax.Array,
                   total_transform: jax.Array, *, size: tuple[int, int, int],
                   resolution: int, normalize_gradient: bool = False):
    """One iteration's statistics straight from the map state (parity-test
    API; the hot path precomputes fields once and reuses them)."""
    fields = precompute_fields(state)
    return jacobian_stats_fields(fields, state.pos, state.offset, points,
                                 mask, total_transform, size=size,
                                 resolution=resolution,
                                 normalize_gradient=normalize_gradient)
