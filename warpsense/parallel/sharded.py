"""Multi-chip sharding of the TSDF window + SLAM step (mesh / shard_map).

The reference is single-GPU with no distributed layer (SURVEY.md §2.7/§5.8);
this module is new capability, designed for device meshes:

* the local-map window (value, weight) is block-sharded along the ARRAY
  x-axis of the ring buffer across a 1-D ``Mesh('x')``.  Ring-buffer
  semantics survive sharding untouched because shards partition *array*
  space — ``pos``/``offset`` stay replicated scalars and the modular index
  math is unchanged.
* **registration**: every device computes Jacobians for the points whose
  cells land in its shard; the +-1-voxel gradient neighborhood crosses
  shard boundaries, so each shard exchanges one boundary YZ-plane with its
  ring neighbors via ``ppermute`` (the window is a torus — the wrap-around
  neighbor is exactly the ring wrap).  The 27 GN scalars (H, g, e, c) are
  ``psum``-ed over the device interconnect; the 6x6 solve is replicated.
* **TSDF fusion**: the ray-march is compute-replicated over points (cheap:
  O(points x steps)) while the scatter and the averaging sweep — the
  HBM-bound O(voxels) part — touch only the local shard.  This shards the
  dominant cost (the reference's ``cu_avg_tsdf_krnl`` sweeps every voxel,
  update_tsdf.cu:13-43) with zero communication.

All functions are shape-polymorphic in the mesh size; tests run them on an
8-device virtual CPU mesh and the driver dry-runs them via
``__graft_entry__.dryrun_multichip``.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.consts import MATRIX_RESOLUTION, WEIGHT_RESOLUTION
from ..core.geometry import div_trunc, transform_point_fixed, xi_to_transform
from ..map.local_map import LocalMapState, in_bounds
from ..ops.registration import (_SC, _SG, PackedFields, PackedFields2,
                                _lm_loop, _pack16, make_packed_stats,
                                make_packed_stats_split,
                                packed_plane_from_neighbors)
from ..ops.tsdf import (_SENTINEL, _floor_norm, decode_key, encode_key,
                        march_position, ray_setup)
from ..ops.tsdf_projective import (_merge_planes, build_beam_table,
                                   check_fusion_config,
                                   projective_sweep_coords)
from ..ops.tsdf_reference import dz_per_distance


def make_mesh(n_devices: int | None = None, axis: str = "x") -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), (axis,))


def shard_state(state: LocalMapState, mesh: Mesh) -> LocalMapState:
    """Place value/weight block-sharded on array axis 0, pos/offset replicated."""
    blk = NamedSharding(mesh, P("x", None, None))
    rep = NamedSharding(mesh, P())
    return LocalMapState(
        value=jax.device_put(state.value, blk),
        weight=jax.device_put(state.weight, blk),
        pos=jax.device_put(jnp.asarray(state.pos), rep),
        offset=jax.device_put(jnp.asarray(state.offset), rep),
    )


# --------------------------------------------------------------- registration

def _halo_exchange_x(block: jax.Array, axis: str, n: int) -> jax.Array:
    """(Xs, Y, Z) local block -> (Xs+2, Y, Z) with ring-neighbor halos."""
    right = [(i, (i + 1) % n) for i in range(n)]   # send to right neighbor
    left = [(i, (i - 1) % n) for i in range(n)]
    # my left halo = right edge of left neighbor (they send right)
    left_halo = jax.lax.ppermute(block[-1:], axis, right)
    right_halo = jax.lax.ppermute(block[:1], axis, left)
    return jnp.concatenate([left_halo, block, right_halo], axis=0)


def _sharded_jacobian_stats(value_blk, weight_blk, pos, offset, points, mask,
                            total_transform, *, size, resolution,
                            normalize_gradient, axis, n):
    """Runs inside shard_map: per-shard partial (H, g, e, c), psum-ed."""
    X, Y, Z = size
    Xs = X // n
    shard = jax.lax.axis_index(axis)

    int_mat = jnp.trunc(total_transform.astype(jnp.float32)
                        * MATRIX_RESOLUTION).astype(jnp.int32)
    center = total_transform[:3, 3].astype(jnp.int32)
    pts = transform_point_fixed(points, int_mat)
    buf = jnp.floor_divide(pts, resolution)
    p = (pts - center).astype(jnp.float32)

    sz = jnp.asarray(size)
    inb = jnp.all(jnp.abs(buf - pos) <= sz // 2 - 1, axis=-1) & mask
    a = jnp.mod(buf - pos + offset, sz)            # ring array coords
    mine = inb & (a[:, 0] // Xs == shard)
    ax_local = a[:, 0] - shard * Xs + 1            # +1: halo offset

    vh = _halo_exchange_x(value_blk, axis, n)
    wh = _halo_exchange_x(weight_blk, axis, n)

    def at(dx, dy, dz):
        ai = jnp.where(mine, ax_local + dx, 0)
        ay = jnp.mod(a[:, 1] + dy, Y)
        az = jnp.mod(a[:, 2] + dz, Z)
        return (vh[ai, ay, az].astype(jnp.int32),
                wh[ai, ay, az].astype(jnp.int32))

    cur_v, cur_w = at(0, 0, 0)
    valid = mine & (cur_w != 0)

    grads = []
    for axid in range(3):
        d = [0, 0, 0]
        d[axid] = 1
        nv, nw = at(*d)
        d[axid] = -1
        pv, pw = at(*d)
        sign_change = ((nv > 0) & (pv < 0)) | ((nv < 0) & (pv > 0))
        ok = (nw != 0) & (pw != 0) & ~sign_change
        grads.append(jnp.where(ok, div_trunc(nv - pv, 2), 0))
    grad = jnp.stack(grads, axis=-1).astype(jnp.float32)
    if normalize_gradient:
        grad = grad / float(resolution)

    cross = jnp.cross(p, grad)
    Js = jnp.concatenate([cross * _SC, grad * _SG], axis=-1)
    vf = valid.astype(jnp.float32)
    Js = Js * vf[:, None]
    v = cur_v.astype(jnp.float32) * vf

    H = jax.lax.psum(Js.T @ Js, axis)
    g = jax.lax.psum(Js.T @ v, axis)
    e = jax.lax.psum(jnp.sum(jnp.abs(v)), axis)
    c = jax.lax.psum(jnp.sum(vf), axis)
    return H, g, e, c


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "size", "resolution", "max_iterations", "mode"),
)
def register_cloud_sharded(state: LocalMapState, points, mask, pretransform, *,
                           mesh: Mesh, size, resolution, max_iterations,
                           it_weight_gradient, epsilon, mode: str = "parity"):
    """Distributed GN registration: same contract as ops.registration.
    register_cloud, map sharded over ``mesh``."""
    fast = mode == "fast"
    axis = mesh.axis_names[0]
    center = pretransform[:3, 3].astype(jnp.int32)
    D = jnp.concatenate([jnp.full((3,), _SC, jnp.float32),
                         jnp.full((3,), _SG, jnp.float32)])

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P("x", None, None), P("x", None, None), P(), P(), P(), P(),
                  P()),
        out_specs=(P(), P(), P(), P()),
    )
    def stats(value_blk, weight_blk, pos, offset, pts, msk, total):
        return _sharded_jacobian_stats(
            value_blk, weight_blk, pos, offset, pts, msk, total,
            size=size, resolution=resolution, normalize_gradient=fast,
            axis=axis, n=mesh.shape[axis])

    def cond(carry):
        i, _, _, _, finished = carry
        return (i < max_iterations) & ~finished

    def body(carry):
        i, total, alpha, prev, _ = carry
        H, g, e, c = stats(state.value, state.weight, state.pos, state.offset,
                           points, mask, total)
        A = H + alpha * c * jnp.diag(D * D)
        ok = c > 0.0
        A = jnp.where(ok, A, jnp.eye(6, dtype=jnp.float32))
        y = jnp.linalg.solve(A, -g)
        xi = jnp.where(ok, D * y, jnp.zeros(6, jnp.float32))
        ctr = total[:3, 3].astype(jnp.int32) if fast else center
        transform = xi_to_transform(xi, ctr)
        total = jnp.where(ok, transform @ total, total)
        err = e / jnp.maximum(c, 1.0)
        finished = ((jnp.abs(err - prev[2]) < epsilon)
                    & (jnp.abs(err - prev[0]) < epsilon)) | ~ok
        prev = jnp.concatenate([prev[1:], err[None]])
        return i + 1, total, alpha + it_weight_gradient, prev, finished

    init = (jnp.int32(0), pretransform.astype(jnp.float32), jnp.float32(0.0),
            jnp.zeros((4,), jnp.float32), jnp.bool_(False))
    _, total, _, _, _ = jax.lax.while_loop(cond, body, init)
    return total


# --------------------------------------------------------------- TSDF fusion

@functools.partial(
    jax.jit,
    static_argnames=("mesh", "size", "tau", "max_weight", "resolution",
                     "max_steps", "max_isteps", "channels", "vfov_deg"),
    donate_argnames=("state",),
)
def tsdf_update_sharded(state: LocalMapState, points, points_mask,
                        scanner_pos, up, *, mesh: Mesh, size, tau, max_weight,
                        resolution, max_steps, max_isteps, channels: int = 128,
                        vfov_deg: float = 45.0) -> LocalMapState:
    """Distributed TSDF fusion: march replicated, scatter + averaging sweep
    local to each shard (the O(voxels) cost — the roofline term — scales
    with the mesh)."""
    X, Y, Z = size
    axis = mesh.axis_names[0]
    dzpd = dz_per_distance(channels, vfov_deg)
    weight_epsilon = tau // 10
    step_mm = max(resolution // 2, 1)

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P("x", None, None), P("x", None, None), P(), P(), P(), P(),
                  P(), P()),
        out_specs=(P("x", None, None), P("x", None, None)),
    )
    def fuse(value_blk, weight_blk, pos, offset, pts, msk, spos, upv):
        n = mesh.shape[axis]
        Xs = X // n
        shard = jax.lax.axis_index(axis)
        nvox_local = Xs * Y * Z

        pos_mm = spos * resolution + resolution // 2
        direction, distance, interp, ray_ok = ray_setup(pts, pos_mm, upv)
        cell = jnp.floor_divide(pts, resolution)
        sz = jnp.asarray(size)
        point_ok = (msk & ray_ok
                    & jnp.all(jnp.abs(cell - pos)
                              <= sz // 2 + (tau // resolution // 2), axis=-1))

        key_map = jnp.full((nvox_local,), _SENTINEL, dtype=jnp.int32)
        # mark the carry as device-varying for shard_map's vma type system
        key_map = jax.lax.pvary(key_map, (axis,))

        def index_at(k):
            return march_position(direction, distance, pos_mm, k, step_mm,
                                  resolution)

        def body(k, key_map):
            proj, index, length = index_at(k)
            _, prev_index, _ = index_at(jnp.maximum(k - 1, 0))
            dup = ((index[:, 0] == prev_index[:, 0])
                   & (index[:, 1] == prev_index[:, 1]) & (k > 0))
            within = length <= distance + tau
            inb = jnp.all(jnp.abs(index - pos) <= sz // 2, axis=-1)
            base_ok = point_ok & within & ~dup & inb

            centr = index * resolution + resolution // 2
            value = _floor_norm(pts - centr)
            value = jnp.minimum(value, tau)
            value = jnp.where(length > distance, -value, value)
            weight = jnp.where(
                value < -weight_epsilon,
                WEIGHT_RESOLUTION * (tau + value) // (tau - weight_epsilon),
                WEIGHT_RESOLUTION)
            base_ok = base_ok & (weight != 0)

            delta_z = dzpd * length // MATRIX_RESOLUTION
            iter_steps = (delta_z * 2) // resolution + 1
            mid = delta_z // resolution
            lowest = proj - div_trunc(delta_z * interp, MATRIX_RESOLUTION)

            flats, keys = [], []
            for s in range(max_isteps):
                raw = lowest + div_trunc(s * resolution * interp,
                                         MATRIX_RESOLUTION)
                widx = jnp.floor_divide(raw, resolution)
                ok = base_ok & (s < iter_steps) & jnp.all(
                    jnp.abs(widx - pos) <= sz // 2, axis=-1)
                a = jnp.mod(widx - pos + offset, sz)
                mine = ok & (a[:, 0] // Xs == shard)
                local = (a[:, 0] - shard * Xs) * (Y * Z) + a[:, 1] * Z + a[:, 2]
                w = jnp.where(s == mid, weight, -weight)
                flats.append(jnp.where(mine, local, nvox_local))
                keys.append(encode_key(value, w))
            flat = jnp.stack(flats, axis=-1).reshape(-1)
            key = jnp.stack(keys, axis=-1).reshape(-1)
            return key_map.at[flat].min(key, mode="drop")

        key_map = jax.lax.fori_loop(0, max_steps, body, key_map)

        new_v, new_w = decode_key(key_map.reshape(Xs, Y, Z))
        ev = value_blk.astype(jnp.int32)
        ew = weight_blk.astype(jnp.int32)
        avg_case = (new_w > 0) & (ew > 0)
        over_case = (new_w != 0) & (ew <= 0)
        den = jnp.where(avg_case, ew + new_w, 1)
        avg_v = div_trunc(ev * ew + new_v * new_w, den)
        out_v = jnp.where(avg_case, avg_v, jnp.where(over_case, new_v, ev))
        out_w = jnp.where(avg_case, jnp.minimum(max_weight, ew + new_w),
                          jnp.where(over_case, new_w, ew))
        return out_v.astype(jnp.int16), out_w.astype(jnp.int16)

    value, weight = fuse(state.value, state.weight, state.pos, state.offset,
                         points, points_mask, scanner_pos, up)
    return LocalMapState(value=value, weight=weight, pos=state.pos,
                         offset=state.offset)


# Production-generation sharded layer: the packed-fields / adaptive-LM /
# interpolated-residual registration and the projective fusion sweep — the
# same algorithms the single-chip pipeline runs (ops/registration.py
# register_cloud_packed, ops/tsdf_projective.py), sharded over the mesh.
# The parity-generation functions above are kept as the exact-semantics
# twins (the role ops/tsdf.py plays on one chip).

@functools.partial(jax.jit, static_argnames=("mesh", "tau", "exact"))
def precompute_fields_packed_sharded(state: LocalMapState, *, mesh: Mesh,
                                     tau: int, exact: bool = False):
    """Sharded twin of ops.registration.precompute_fields_packed[2]: the
    value/gradient pack runs per-shard (pure local bandwidth); only the two
    boundary YZ-planes of (value, weight) cross devices (ppermute).  Output
    plane(s) carry the same x-block sharding as the map state."""
    axis = mesh.axis_names[0]
    n = mesh.shape[axis]
    blk = P("x", None, None)

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(blk, blk),
        out_specs=(blk, blk) if exact else blk,
    )
    def pack_blk(value_blk, weight_blk):
        v = value_blk.astype(jnp.int32)
        w = weight_blk.astype(jnp.int32)
        # the two boundary YZ-planes cross devices in their RAW int16 form —
        # half the halo bytes of exchanging the int32 working copies; the
        # cast commutes with the permute, so values are identical
        right = [(i, (i + 1) % n) for i in range(n)]
        left = [(i, (i - 1) % n) for i in range(n)]

        def halo32(blk16, blk32):
            lh = jax.lax.ppermute(blk16[-1:], axis, right).astype(jnp.int32)
            rh = jax.lax.ppermute(blk16[:1], axis, left).astype(jnp.int32)
            ext = jnp.concatenate([lh, blk32, rh], axis=0)
            return ext[2:], ext[:-2]

        nv, pv = halo32(value_blk, v)
        nw, pw = halo32(weight_blk, w)
        neighbors = [(nv, pv, nw, pw)]
        for ax in (1, 2):
            neighbors.append((jnp.roll(v, -1, axis=ax),
                              jnp.roll(v, 1, axis=ax),
                              jnp.roll(w, -1, axis=ax),
                              jnp.roll(w, 1, axis=ax)))
        if exact:
            grads = []
            for nv, pv, nw, pw in neighbors:
                ok = (nw != 0) & (pw != 0)
                grads.append(jnp.where(ok, div_trunc(nv - pv, 2), 0))
            vsent = jnp.where(w != 0, v, -32768)
            return _pack16(vsent, grads[0]), _pack16(grads[1], grads[2])
        return packed_plane_from_neighbors(v, w, neighbors, tau=tau)

    if exact:
        a, b = pack_blk(state.value, state.weight)
        return PackedFields2(plane_a=a, plane_b=b)
    return PackedFields(plane=pack_blk(state.value, state.weight))


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "size", "resolution", "tau", "max_iterations",
                     "interp", "gather_freeze"),
)
def register_cloud_packed_sharded(fields, pos, offset, points, mask,
                                  pretransform, *, mesh: Mesh, size,
                                  resolution: int, tau: int,
                                  max_iterations: int, epsilon: float,
                                  interp: bool = True,
                                  gather_freeze: bool = False):
    """Distributed twin of ops.registration.register_cloud_packed — same
    contract, returns ``(pose, iterations, err)``.

    The packed plane stays x-block-sharded; points are replicated.  Each
    shard gathers only the points whose cells it owns (1 local gather per
    LM iteration) and the 27 normal-equation scalars are ``psum``-ed; the
    adaptive-LM loop itself is replicated and bit-identical across devices
    (all its inputs are the psum results).  Reference semantics being
    scaled: src/warpsense/cuda/registration.cu:14-257."""
    X, Y, Z = size
    axis = mesh.axis_names[0]
    n = mesh.shape[axis]
    Xs = X // n

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P("x", None, None), P(), P(), P(), P(), P()),
        out_specs=(P(), P(), P()),
    )
    def run(fields_blk, pos, offset, pts, msk, pre):
        shard = jax.lax.axis_index(axis)
        szv = jnp.asarray(size)

        def index_fn(buf):
            # shard-LOCAL array coords (3-D gather; flat indexing would
            # force a tiled-layout relayout of the whole block)
            a = jnp.mod(buf - pos + offset, szv)
            owned = a[:, 0] // Xs == shard
            coords = jnp.stack([a[:, 0] - shard * Xs, a[:, 1], a[:, 2]],
                               axis=-1)
            return coords, owned

        local_stats = make_packed_stats(
            fields_blk, pos, offset, pts, msk, size=size,
            resolution=resolution, tau=tau, interp=interp, index_fn=index_fn)

        def psum_fused(stats4):
            # ONE 44-float all-reduce per LM iteration instead of four
            # (H 36 + g 6 + e 1 + c 1): the payload is identical, but a
            # single collective launch halves the per-iteration barrier
            # count on a real mesh (sums are elementwise, so packing
            # does not change any value)
            H, g, e, c = stats4
            flat = jnp.concatenate([H.reshape(36), g, e[None], c[None]])
            flat = jax.lax.psum(flat, axis)
            return flat[:36].reshape(6, 6), flat[36:42], flat[42], flat[43]

        def stats(total):
            return psum_fused(local_stats(total))

        split = None
        if gather_freeze:
            gather_fn, eval_local = make_packed_stats_split(
                fields_blk, pos, offset, pts, msk, size=size,
                resolution=resolution, tau=tau, interp=interp,
                index_fn=index_fn)

            def eval_fn(cache, total):
                # cache is shard-varying; the psum'd stats are replicated
                return psum_fused(eval_local(cache, total))

            split = (gather_fn, eval_fn)

        return _lm_loop(stats, pre, max_iterations=max_iterations,
                        epsilon=epsilon, split=split,
                        freeze_step_mm=float(resolution))

    return run(fields, pos, offset, points, mask,
               pretransform.astype(jnp.float32))


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "size", "tau", "max_weight", "resolution",
                     "channels", "columns", "vfov_deg"),
    donate_argnames=("state",),
)
def tsdf_update_projective_sharded(
        state: LocalMapState, points, points_mask, scanner_pos, rotation, *,
        mesh: Mesh, size, tau, max_weight, resolution, channels: int = 128,
        columns: int = 1024, vfov_deg: float = 45.0) -> LocalMapState:
    """Distributed twin of ops.tsdf_projective.tsdf_update_projective — the
    production fusion path at mesh scale.  The beam table (~131K entries)
    is computed replicated (it is tiny); the O(voxels) sweep + averaging
    merge — the memory-bound term (cu_avg_tsdf_krnl touches every voxel,
    update_tsdf.cu:13-43) — runs per-shard with ZERO communication: each
    shard sweeps its own x-slab of global coordinates."""
    check_fusion_config(tau, max_weight, vfov_deg)
    X, Y, Z = size
    axis = mesh.axis_names[0]
    n = mesh.shape[axis]
    Xs = X // n
    scanner_mm = scanner_pos * resolution + resolution // 2
    cell = jnp.floor_divide(points, resolution)
    points_mask = points_mask & in_bounds(
        cell, state.pos, jnp.asarray(size), -(tau // resolution // 2))
    rng_tab, endpoint = build_beam_table(
        points, points_mask, scanner_mm, rotation, channels=channels,
        columns=columns, vfov_deg=vfov_deg)

    def shard_coords(pos, offset):
        shard = jax.lax.axis_index(axis)
        ax = shard * Xs + jnp.arange(Xs)
        gx = pos[0] + jnp.mod(ax - offset[0] + X // 2, X) - X // 2
        gy = pos[1] + jnp.mod(jnp.arange(Y) - offset[1] + Y // 2, Y) - Y // 2
        gz = pos[2] + jnp.mod(jnp.arange(Z) - offset[2] + Z // 2, Z) - Z // 2
        return gx, gy, gz

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P("x", None, None), P("x", None, None), P(), P(), P(), P(),
                  P(), P()),
        out_specs=(P("x", None, None), P("x", None, None)),
    )
    def fuse(value_blk, weight_blk, pos, offset, rng_tab, endpoint, smm, rot):
        gx, gy, gz = shard_coords(pos, offset)
        new_v, new_w = projective_sweep_coords(
            gx, gy, gz, rng_tab, endpoint, smm, rot, tau=tau,
            resolution=resolution, channels=channels, columns=columns,
            vfov_deg=vfov_deg)
        out_v, out_w = _merge_planes(value_blk.astype(jnp.int32),
                                     weight_blk.astype(jnp.int32),
                                     new_v, new_w, max_weight)
        return out_v.astype(jnp.int16), out_w.astype(jnp.int16)

    value, weight = fuse(state.value, state.weight, state.pos, state.offset,
                         rng_tab, endpoint, scanner_mm, rotation)
    return LocalMapState(value=value, weight=weight, pos=state.pos,
                         offset=state.offset)


def slam_step_sharded(state: LocalMapState, points, mask, pretransform, *,
                      mesh: Mesh, params, size, max_steps=None,
                      max_isteps=None, scanner_pos=None, up=None,
                      mode: str = "parity", capture_pose=None):
    """One full SLAM step (fusion + registration) on the mesh — the unit
    the driver dry-runs and the multi-chip pipeline executes per scan.

    ``mode="fast"`` runs the PRODUCTION generation (projective fusion +
    packed fields + adaptive-LM registration — the same algorithms as the
    single-chip fast pipeline); ``"parity"`` keeps the reference-exact
    ray-march + un-normalized-gradient GN twins.

    ``capture_pose``: host 4x4 mm pose the scan was captured at; fast-mode
    fusion dispatches its beam-grid attitude through the SAME tilt-envelope
    rule as the apps (fusion_backend.grid_rotation_for) — level map-aligned
    grid inside the envelope, true sensor attitude beyond it.  ``None``
    (bare dryrun/bench step) assumes a level platform."""
    m = params.map
    if mode == "fast":
        from ..pipeline.fusion_backend import grid_rotation_for
        if capture_pose is None:
            grid_rot = jnp.eye(3, dtype=jnp.float32)
        else:
            grid_rot, _ = grid_rotation_for(np.asarray(capture_pose),
                                            params.lidar.vfov)
        state = tsdf_update_projective_sharded(
            state, points, mask, scanner_pos, grid_rot,
            mesh=mesh, size=size, tau=m.tau,
            max_weight=m.max_weight_scaled, resolution=m.resolution,
            channels=params.lidar.channels,
            columns=params.lidar.hresolution, vfov_deg=params.lidar.vfov)
        fields = precompute_fields_packed_sharded(state, mesh=mesh, tau=m.tau)
        pose, _iters, _err = register_cloud_packed_sharded(
            fields, state.pos, state.offset, points, mask, pretransform,
            mesh=mesh, size=size, resolution=m.resolution, tau=m.tau,
            max_iterations=params.registration.max_iterations,
            epsilon=params.registration.epsilon,
            gather_freeze=params.registration.gather_freeze)
        return state, pose
    state = tsdf_update_sharded(
        state, points, mask, scanner_pos, up, mesh=mesh, size=size,
        tau=m.tau, max_weight=m.max_weight_scaled, resolution=m.resolution,
        max_steps=max_steps, max_isteps=max_isteps,
        channels=params.lidar.channels, vfov_deg=params.lidar.vfov)
    pose = register_cloud_sharded(
        state, points, mask, pretransform, mesh=mesh, size=size,
        resolution=m.resolution,
        max_iterations=params.registration.max_iterations,
        it_weight_gradient=params.registration.it_weight_gradient,
        epsilon=params.registration.epsilon, mode=mode)
    return state, pose
