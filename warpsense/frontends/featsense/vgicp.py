"""Device (XLA) voxelized GICP (VGICP) refinement.

JAX replacement for the fast_gicp ``FastVGICP(Cuda)`` wrapper the
reference uses for loose post-registration refinement
(/root/reference/include/warpsense/vgicp.h:22-81, Koide et al. 2021):

* both clouds are voxelized at ``resolution``; every voxel keeps a mean and
  a plane-regularized covariance (eigenvalues -> (1, 1, 1e-3), fast_gicp's
  RegularizationMethod::PLANE).  Voxel tables are fixed-capacity sorted key
  arrays — lookup is a ``searchsorted`` (no hash maps, no kd-trees);
* each source point associates with the single target voxel containing its
  transformed position (fast_gicp NeighborSearchMethod::DIRECT1);
* the distribution-to-distribution Mahalanobis Gauss-Newton — residual
  r = mu_v - (R p + t), information M = (C_v + R C_p R^T)^-1 — runs
  entirely inside one jitted ``fori_loop``;
* the PCL-style fitness score (mean squared residual over matches) gates
  the result: above ``fitness_score_threshold`` the transform falls back
  to identity exactly like the reference (vgicp.h:59-63).

Key packing bounds the world to +-``KEY_RANGE`` voxels around the source
centroid (int32 keys); at the reference's 1 m VGICP resolution that is a
+-511 m neighborhood — far beyond any single-scan envelope.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ...core import geometry

KEY_BITS = 10
KEY_RANGE = 1 << (KEY_BITS - 1)          # +-512 voxels around the origin
_KEY_INVALID = jnp.int32(2 ** 30)


class VoxelTable(NamedTuple):
    keys: jax.Array    # (V,) int32, sorted ascending, invalid = _KEY_INVALID
    mean: jax.Array    # (V, 3) f32
    cov: jax.Array     # (V, 3, 3) f32 (plane-regularized)
    mask: jax.Array    # (V,) bool


def _pack_keys(points: jax.Array, mask: jax.Array, origin: jax.Array,
               resolution: float) -> jax.Array:
    cell = jnp.floor((points - origin) / resolution).astype(jnp.int32)
    cell = cell + KEY_RANGE
    ok = mask & jnp.all((cell >= 0) & (cell < 2 * KEY_RANGE), axis=-1)
    key = ((cell[:, 0] << (2 * KEY_BITS)) | (cell[:, 1] << KEY_BITS)
           | cell[:, 2])
    return jnp.where(ok, key, _KEY_INVALID)


def _regularize(cov: jax.Array) -> jax.Array:
    """fast_gicp PLANE regularization: eigenvalues -> (1e-3, 1, 1)."""
    w, v = jnp.linalg.eigh(cov)
    w_reg = jnp.asarray([1e-3, 1.0, 1.0], cov.dtype)
    w_reg = jnp.broadcast_to(w_reg, w.shape)
    return jnp.einsum("...ij,...j,...kj->...ik", v, w_reg, v)


def build_voxel_table(points: jax.Array, mask: jax.Array, origin: jax.Array,
                      resolution: float) -> VoxelTable:
    """Sorted voxel distribution table from a (N, 3) masked cloud."""
    N = points.shape[0]
    key = _pack_keys(points, mask, origin, resolution)
    order = jnp.argsort(key)
    sk = key[order]
    sp = points[order]
    sm = sk != _KEY_INVALID
    new_group = jnp.concatenate([jnp.ones((1,), bool), sk[1:] != sk[:-1]])
    gid = jnp.cumsum(new_group) - 1
    wf = sm.astype(jnp.float32)
    cnt = jax.ops.segment_sum(wf, gid, num_segments=N)
    psum = jax.ops.segment_sum(sp * wf[:, None], gid, num_segments=N)
    ppt = jax.ops.segment_sum(
        jnp.einsum("ni,nj->nij", sp, sp) * wf[:, None, None],
        gid, num_segments=N)
    n = jnp.maximum(cnt, 1.0)
    mean = psum / n[:, None]
    cov = ppt / n[:, None, None] - jnp.einsum("ni,nj->nij", mean, mean)
    cov = _regularize(cov + 1e-9 * jnp.eye(3))

    # representative key per group = key at each group's first row
    first_row = jax.ops.segment_min(jnp.arange(N), gid, num_segments=N)
    first_row = jnp.clip(first_row, 0, N - 1)
    gkey = jnp.where(cnt > 0, sk[first_row], _KEY_INVALID)
    # already ascending by construction (groups follow the sorted order)
    return VoxelTable(keys=gkey, mean=mean, cov=cov, mask=cnt > 0)


def lookup(table: VoxelTable, points: jax.Array, mask: jax.Array,
           origin: jax.Array, resolution: float):
    """Associate each point with its containing voxel (DIRECT1).

    Returns (index into table, found)."""
    key = _pack_keys(points, mask, origin, resolution)
    idx = jnp.searchsorted(table.keys, key)
    idx = jnp.clip(idx, 0, table.keys.shape[0] - 1)
    found = (table.keys[idx] == key) & (key != _KEY_INVALID) & table.mask[idx]
    return idx, found


@functools.partial(jax.jit, static_argnames=("resolution", "max_iterations"))
def vgicp_align(source_pts: jax.Array, source_mask: jax.Array,
                target_pts: jax.Array, target_mask: jax.Array, *,
                resolution: float = 1.0, max_iterations: int = 20,
                fitness_score_threshold: float = 6.0):
    """Align source onto target; returns (4x4 f32 transform, fitness score).

    The transform maps source-frame points into the target frame; identity
    when the fitness gate fails (parity vgicp.h:59-66).
    """
    wf = source_mask.astype(jnp.float32)
    origin = (jnp.sum(source_pts * wf[:, None], axis=0)
              / jnp.maximum(jnp.sum(wf), 1.0))

    tgt = build_voxel_table(target_pts, target_mask, origin, resolution)
    src = build_voxel_table(source_pts, source_mask, origin, resolution)
    sidx, sfound = lookup(src, source_pts, source_mask, origin, resolution)
    src_cov = jnp.where(sfound[:, None, None], src.cov[sidx],
                        jnp.eye(3, dtype=jnp.float32))

    def body(_, carry):
        R, t = carry
        pw = source_pts @ R.T + t
        tidx, found = lookup(tgt, pw, source_mask, origin, resolution)
        found = found & sfound
        mu = tgt.mean[tidx]
        Cv = tgt.cov[tidx]
        r = mu - pw                                           # (N, 3)
        M = jnp.linalg.inv(Cv + R @ src_cov @ R.T
                           + 1e-6 * jnp.eye(3, dtype=jnp.float32))
        M = jnp.where(found[:, None, None], M, 0.0)
        r = jnp.where(found[:, None], r, 0.0)
        # left increment T' = exp(xi) T: pw' ~ pw + omega x pw + dt, so
        # dr/domega = skew(pw), dr/dt = -I;  J_i = [ skew(pw_i) | -I ]
        rp = pw
        zeros = jnp.zeros_like(rp[:, 0])
        Jrot = jnp.stack([
            jnp.stack([zeros, -rp[:, 2], rp[:, 1]], axis=-1),
            jnp.stack([rp[:, 2], zeros, -rp[:, 0]], axis=-1),
            jnp.stack([-rp[:, 1], rp[:, 0], zeros], axis=-1),
        ], axis=-2)                                           # skew(Rp)
        Jtrans = -jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32),
                                   Jrot.shape)
        J = jnp.concatenate([Jrot, Jtrans], axis=-1)          # (N, 3, 6)
        MJ = M @ J                                            # (N, 3, 6)
        H = jnp.einsum("nij,nik->jk", J, MJ)                  # (6, 6)
        g = jnp.einsum("nij,ni->j", MJ, r)
        ok = jnp.sum(found) > 6
        A = jnp.where(ok, H + 1e-6 * jnp.eye(6, dtype=jnp.float32),
                      jnp.eye(6, dtype=jnp.float32))
        dx = jnp.where(ok, jnp.linalg.solve(A, -g), jnp.zeros(6, jnp.float32))
        dq, dt = geometry.se3_exp(dx)
        dR = geometry.quat_to_mat(dq)
        return dR @ R, (dR @ t[:, None])[:, 0] + dt

    R0 = jnp.eye(3, dtype=jnp.float32)
    t0 = jnp.zeros(3, jnp.float32)
    R, t = jax.lax.fori_loop(0, max_iterations, body, (R0, t0))

    # fitness: mean squared distance to the matched voxel means
    pw = source_pts @ R.T + t
    tidx, found = lookup(tgt, pw, source_mask, origin, resolution)
    d2 = jnp.sum((tgt.mean[tidx] - pw) ** 2, axis=-1)
    nf = jnp.maximum(jnp.sum(found.astype(jnp.float32)), 1.0)
    fitness = jnp.sum(jnp.where(found, d2, 0.0)) / nf
    # no matches at all = failed alignment
    fitness = jnp.where(jnp.sum(found) > 0, fitness, jnp.inf)

    T = geometry.pose_matrix(R, t)
    bad = fitness > fitness_score_threshold
    T = jnp.where(bad, jnp.eye(4, dtype=jnp.float32), T)
    return T, fitness
