"""SE(3) / fixed-point geometry utilities.

Behavioral parity targets (re-derived, not translated):
* ``to_int_mat`` / ``transform_point``  — /root/reference/include/util/util.h:8-18
* ``xi_to_transform``                  — /root/reference/include/warpsense/registration/util.h:5-39
* ``se3_exp`` (quaternion + V*t form)  — /root/reference/src/featsense/lidar_optimization.cpp:109-146
* ``skew``                             — /root/reference/src/featsense/lidar_optimization.cpp:148-159

All functions are pure and jittable; they accept/return jnp arrays so the
same code runs on the accelerator inside jitted steps and on the host.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .consts import MATRIX_RESOLUTION


def to_int_mat(pose: jax.Array) -> jax.Array:
    """Scale a float 4x4 pose by MATRIX_RESOLUTION and truncate to int32."""
    return (pose * MATRIX_RESOLUTION).astype(jnp.int32)


def transform_point_fixed(points: jax.Array, int_mat: jax.Array) -> jax.Array:
    """Apply a fixed-point 4x4 (int32, MATRIX_RESOLUTION-scaled rotation and
    mm translation also scaled) to int32 mm points: ``(R*p + t) / MR``.

    Same int32 arithmetic envelope as the reference device op
    (cuda/util.h:11-22).  ``points``: (..., 3) int32.
    """
    p = points.astype(jnp.int32)
    m = int_mat.astype(jnp.int32)
    out = p @ m[:3, :3].T + m[:3, 3]
    # C integer division truncates toward zero; jnp // floors.
    return _div_trunc(out, MATRIX_RESOLUTION).astype(jnp.int32)


def div_trunc(a: jax.Array, b) -> jax.Array:
    """C-style integer division (truncate toward zero, unlike jnp's floor)."""
    b = jnp.asarray(b, dtype=a.dtype)
    q = jnp.abs(a) // jnp.abs(b)
    return jnp.where((a < 0) != (b < 0), -q, q)


_div_trunc = div_trunc


def skew(v: jax.Array) -> jax.Array:
    """3x3 skew-symmetric matrix of a 3-vector."""
    zero = jnp.zeros((), dtype=v.dtype)
    return jnp.stack([
        jnp.stack([zero, -v[2], v[1]]),
        jnp.stack([v[2], zero, -v[0]]),
        jnp.stack([-v[1], v[0], zero]),
    ])


def rodrigues(axis_angle: jax.Array) -> jax.Array:
    """Rotation matrix from an axis-angle 3-vector (Rodrigues formula),
    numerically safe at theta -> 0."""
    theta = jnp.linalg.norm(axis_angle)
    safe = jnp.where(theta < 1e-12, 1.0, theta)
    l = axis_angle / safe
    L = skew(l)
    R = (jnp.eye(3, dtype=axis_angle.dtype)
         + jnp.sin(theta) * L
         + (1.0 - jnp.cos(theta)) * (L @ L))
    return jnp.where(theta < 1e-12, jnp.eye(3, dtype=axis_angle.dtype), R)


def xi_to_transform(xi: jax.Array, center: jax.Array) -> jax.Array:
    """Twist (rot[3], trans[3]) -> 4x4 SE3, compensating rotation about
    ``center`` (mm) rather than the origin.

    Parity: registration/util.h:5-39 ("Formula 3.9", HATSDF thesis).
    """
    rotation = rodrigues(xi[:3])
    center_f = center.astype(xi.dtype)
    shift = rotation @ (-center_f)
    t = shift + center_f + xi[3:6]
    top = jnp.concatenate([rotation, t[:, None]], axis=1)
    bottom = jnp.array([[0.0, 0.0, 0.0, 1.0]], dtype=xi.dtype)
    return jnp.concatenate([top, bottom], axis=0)


def quat_mul(q1: jax.Array, q2: jax.Array) -> jax.Array:
    """Hamilton product, quaternions as (x, y, z, w)."""
    x1, y1, z1, w1 = q1[0], q1[1], q1[2], q1[3]
    x2, y2, z2, w2 = q2[0], q2[1], q2[2], q2[3]
    return jnp.stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ])


def quat_rotate(q: jax.Array, v: jax.Array) -> jax.Array:
    """Rotate vector(s) v (..., 3) by unit quaternion q=(x,y,z,w)."""
    u = q[:3]
    w = q[3]
    uv = jnp.cross(jnp.broadcast_to(u, v.shape), v)
    return v + 2.0 * (w * uv + jnp.cross(jnp.broadcast_to(u, uv.shape), uv))


def quat_to_mat(q: jax.Array) -> jax.Array:
    """Unit quaternion (x,y,z,w) -> 3x3 rotation matrix."""
    x, y, z, w = q[0], q[1], q[2], q[3]
    return jnp.stack([
        jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)]),
        jnp.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)]),
        jnp.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]),
    ])


def mat_to_quat(R: jax.Array) -> jax.Array:
    """3x3 rotation matrix -> unit quaternion (x,y,z,w), branch-free."""
    m00, m01, m02 = R[0, 0], R[0, 1], R[0, 2]
    m10, m11, m12 = R[1, 0], R[1, 1], R[1, 2]
    m20, m21, m22 = R[2, 0], R[2, 1], R[2, 2]
    tr = m00 + m11 + m22
    # four candidate constructions; pick the numerically best
    qw = jnp.stack([1 + tr, 1 + m00 - m11 - m22, 1 - m00 + m11 - m22, 1 - m00 - m11 + m22])
    qw = jnp.sqrt(jnp.maximum(qw, 1e-12)) / 2.0
    case0 = jnp.stack([(m21 - m12), (m02 - m20), (m10 - m01)]) / (4 * qw[0])
    w0 = jnp.stack([case0[0], case0[1], case0[2], qw[0]])
    w1 = jnp.stack([qw[1], (m01 + m10) / (4 * qw[1]), (m02 + m20) / (4 * qw[1]), (m21 - m12) / (4 * qw[1])])
    w2 = jnp.stack([(m01 + m10) / (4 * qw[2]), qw[2], (m12 + m21) / (4 * qw[2]), (m02 - m20) / (4 * qw[2])])
    w3 = jnp.stack([(m02 + m20) / (4 * qw[3]), (m12 + m21) / (4 * qw[3]), qw[3], (m10 - m01) / (4 * qw[3])])
    idx = jnp.argmax(jnp.stack([tr, m00, m11, m22]))
    q = jax.lax.switch(idx, [lambda: w0, lambda: w1, lambda: w2, lambda: w3])
    return q / jnp.linalg.norm(q)


def se3_exp(xi: jax.Array) -> tuple[jax.Array, jax.Array]:
    """se(3) exponential -> (unit quaternion (x,y,z,w), translation).

    ``xi`` = (omega[3], upsilon[3]).  Parity:
    lidar_optimization.cpp:109-146 (Taylor fallback below 1e-10).
    """
    omega = xi[:3]
    upsilon = xi[3:]
    theta = jnp.linalg.norm(omega)
    half = 0.5 * theta
    theta_sq = theta * theta
    small = theta < 1e-10
    imag = jnp.where(
        small,
        0.5 - 0.0208333 * theta_sq + 0.000260417 * theta_sq * theta_sq,
        jnp.sin(half) / jnp.where(small, 1.0, theta),
    )
    real = jnp.cos(half)
    q = jnp.concatenate([imag * omega, real[None]])
    q = q / jnp.linalg.norm(q)

    Omega = skew(omega)
    safe_t = jnp.where(small, 1.0, theta)
    J = jnp.where(
        small,
        quat_to_mat(q),
        (jnp.eye(3, dtype=xi.dtype)
         + (1 - jnp.cos(theta)) / (safe_t * safe_t) * Omega
         + (theta - jnp.sin(theta)) / (safe_t ** 3) * (Omega @ Omega)),
    )
    return q, J @ upsilon


def pose_matrix(R: jax.Array, t: jax.Array) -> jax.Array:
    top = jnp.concatenate([R, t[:, None]], axis=1)
    bottom = jnp.array([[0.0, 0.0, 0.0, 1.0]], dtype=R.dtype)
    return jnp.concatenate([top, bottom], axis=0)


def to_map(pose_mm: jax.Array, resolution: int) -> jax.Array:
    """mm pose (4x4 float) -> voxel index of its translation (floor division).

    Parity: util/util.h ``to_map``.
    """
    t = pose_mm[:3, 3]
    return jnp.floor(t / resolution).astype(jnp.int32)


def floor_divide(a: jax.Array, b) -> jax.Array:
    """Floor division (used by chunked global map addressing)."""
    return jnp.floor_divide(a, b)
