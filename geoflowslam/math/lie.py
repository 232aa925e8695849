"""Lie-group math for the JAX GeoFlow-SLAM rebuild.

JAX replacement for the reference's vendored Sophus library
(/root/reference/Thirdparty/Sophus): SO(3), SE(3) and Sim(3) exp/log maps,
composition, inversion and point actions, written as pure jnp functions that
vmap/jit cleanly over batches (the reference operates on single Eigen objects
inside per-edge loops; here every op is batched by construction).

Conventions
-----------
* Rotations are 3x3 matrices (float32 by default). Quaternion helpers use
  (w, x, y, z) ordering.
* SE(3) is carried as a pair ``(R, t)`` with ``R: [..., 3, 3]`` and
  ``t: [..., 3]``; a world point transforms as ``x' = R @ x + t``.
* Sim(3) is ``(s, R, t)`` with scalar scale ``s: [...]``.
* ``se3_exp`` uses the twist ordering ``[rho (trans), phi (rot)]`` like Sophus.

All functions are numerically guarded around theta -> 0 with Taylor expansions
so that gradients are finite (needed by the GN/LM solvers).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-8


# ---------------------------------------------------------------------------
# SO(3)
# ---------------------------------------------------------------------------

def hat(v: jnp.ndarray) -> jnp.ndarray:
    """Skew-symmetric matrix of v: [..., 3] -> [..., 3, 3]."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = jnp.zeros_like(x)
    return jnp.stack(
        [
            jnp.stack([zero, -z, y], axis=-1),
            jnp.stack([z, zero, -x], axis=-1),
            jnp.stack([-y, x, zero], axis=-1),
        ],
        axis=-2,
    )


def vee(m: jnp.ndarray) -> jnp.ndarray:
    """Inverse of hat: [..., 3, 3] -> [..., 3]."""
    return jnp.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], axis=-1)


def so3_exp(phi: jnp.ndarray) -> jnp.ndarray:
    """Exponential map so(3) -> SO(3) (Rodrigues), Taylor-guarded near 0."""
    theta2 = jnp.sum(phi * phi, axis=-1)
    theta = jnp.sqrt(jnp.maximum(theta2, _EPS * _EPS))
    small = theta2 < _EPS
    # sin(t)/t and (1-cos t)/t^2 with Taylor fallbacks
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2)
    k = hat(phi)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), k.shape)
    return eye + a[..., None, None] * k + b[..., None, None] * (k @ k)


def so3_log(rot: jnp.ndarray) -> jnp.ndarray:
    """Log map SO(3) -> so(3). Accurate up to theta < pi - eps.

    Uses the quaternion route which is numerically stable near theta = 0 and
    theta = pi (matches Sophus' behaviour closely enough for BA purposes).
    """
    q = quat_from_mat(rot)
    return quat_log(q)


def so3_right_jacobian(phi: jnp.ndarray) -> jnp.ndarray:
    """Right Jacobian Jr of SO(3); reference: IMU::IntegratedRotation
    (/root/reference/include/ImuTypes.h:137) and so3 calculus in G2oTypes."""
    theta2 = jnp.sum(phi * phi, axis=-1)
    theta = jnp.sqrt(jnp.maximum(theta2, _EPS * _EPS))
    small = theta2 < _EPS
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2)
    c = jnp.where(
        small,
        1.0 / 6.0 - theta2 / 120.0,
        (theta - jnp.sin(theta)) / (theta2 * theta),
    )
    k = hat(phi)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), k.shape)
    return eye - b[..., None, None] * k + c[..., None, None] * (k @ k)


def so3_right_jacobian_inv(phi: jnp.ndarray) -> jnp.ndarray:
    """Inverse right Jacobian of SO(3)."""
    theta2 = jnp.sum(phi * phi, axis=-1)
    theta = jnp.sqrt(jnp.maximum(theta2, _EPS * _EPS))
    small = theta2 < _EPS
    half = 0.5 * theta
    cot_term = jnp.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 / theta2) - (1.0 + jnp.cos(theta)) / (2.0 * theta * jnp.sin(theta)),
    )
    k = hat(phi)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), k.shape)
    return eye + 0.5 * k + cot_term[..., None, None] * (k @ k)


def normalize_rotation(rot: jnp.ndarray) -> jnp.ndarray:
    """Project a near-rotation back onto SO(3) via quaternion round-trip
    (reference: IMU::NormalizeRotation, /root/reference/src/ImuTypes.cc)."""
    q = quat_from_mat(rot)
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    return mat_from_quat(q)


# ---------------------------------------------------------------------------
# Quaternions (w, x, y, z)
# ---------------------------------------------------------------------------

def quat_from_mat(rot: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix -> unit quaternion (w,x,y,z), branchless for vmap."""
    m = rot
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    # Four candidate constructions; pick the numerically best per element.
    qw0 = jnp.sqrt(jnp.maximum(1.0 + tr, _EPS)) * 0.5
    c0 = jnp.stack(
        [qw0, (m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0), (m10 - m01) / (4 * qw0)],
        axis=-1,
    )
    qx1 = jnp.sqrt(jnp.maximum(1.0 + m00 - m11 - m22, _EPS)) * 0.5
    c1 = jnp.stack(
        [(m21 - m12) / (4 * qx1), qx1, (m01 + m10) / (4 * qx1), (m02 + m20) / (4 * qx1)],
        axis=-1,
    )
    qy2 = jnp.sqrt(jnp.maximum(1.0 - m00 + m11 - m22, _EPS)) * 0.5
    c2 = jnp.stack(
        [(m02 - m20) / (4 * qy2), (m01 + m10) / (4 * qy2), qy2, (m12 + m21) / (4 * qy2)],
        axis=-1,
    )
    qz3 = jnp.sqrt(jnp.maximum(1.0 - m00 - m11 + m22, _EPS)) * 0.5
    c3 = jnp.stack(
        [(m10 - m01) / (4 * qz3), (m02 + m20) / (4 * qz3), (m12 + m21) / (4 * qz3), qz3],
        axis=-1,
    )
    cands = jnp.stack([c0, c1, c2, c3], axis=-2)  # [..., 4, 4]
    scores = jnp.stack([tr, m00 - m11 - m22, m11 - m00 - m22, m22 - m00 - m11], axis=-1)
    idx = jnp.argmax(scores, axis=-1)
    q = jnp.take_along_axis(cands, idx[..., None, None].astype(jnp.int32), axis=-2)
    q = jnp.squeeze(q, axis=-2)
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    # Canonical sign: w >= 0
    return q * jnp.where(q[..., :1] < 0, -1.0, 1.0)


def mat_from_quat(q: jnp.ndarray) -> jnp.ndarray:
    """Unit quaternion (w,x,y,z) -> rotation matrix."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    return jnp.stack(
        [
            jnp.stack([r00, r01, r02], axis=-1),
            jnp.stack([r10, r11, r12], axis=-1),
            jnp.stack([r20, r21, r22], axis=-1),
        ],
        axis=-2,
    )


def quat_log(q: jnp.ndarray) -> jnp.ndarray:
    """Unit quaternion -> rotation vector (axis * angle)."""
    q = q * jnp.where(q[..., :1] < 0, -1.0, 1.0)
    w = jnp.clip(q[..., 0], -1.0, 1.0)
    v = q[..., 1:]
    vnorm = jnp.linalg.norm(v, axis=-1)
    angle = 2.0 * jnp.arctan2(vnorm, w)
    small = vnorm < _EPS
    scale = jnp.where(small, 2.0 / jnp.maximum(w, _EPS), angle / jnp.maximum(vnorm, _EPS))
    return v * scale[..., None]


def quat_mul(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return jnp.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


# ---------------------------------------------------------------------------
# SE(3)  (R, t) pairs
# ---------------------------------------------------------------------------

def se3_identity(batch_shape=(), dtype=jnp.float32):
    rot = jnp.broadcast_to(jnp.eye(3, dtype=dtype), (*batch_shape, 3, 3))
    t = jnp.zeros((*batch_shape, 3), dtype=dtype)
    return rot, t


def se3_exp(xi: jnp.ndarray):
    """Twist [rho, phi] ([..., 6]) -> (R, t). Sophus ordering: trans first."""
    rho, phi = xi[..., :3], xi[..., 3:]
    rot = so3_exp(phi)
    # Left Jacobian V of SO(3): t = V @ rho
    theta2 = jnp.sum(phi * phi, axis=-1)
    theta = jnp.sqrt(jnp.maximum(theta2, _EPS * _EPS))
    small = theta2 < _EPS
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2)
    c = jnp.where(
        small,
        1.0 / 6.0 - theta2 / 120.0,
        (theta - jnp.sin(theta)) / (theta2 * theta),
    )
    k = hat(phi)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), k.shape)
    v_mat = eye + b[..., None, None] * k + c[..., None, None] * (k @ k)
    t = jnp.einsum("...ij,...j->...i", v_mat, rho)
    return rot, t


def se3_log(rot: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """(R, t) -> twist [rho, phi]."""
    phi = so3_log(rot)
    theta2 = jnp.sum(phi * phi, axis=-1)
    theta = jnp.sqrt(jnp.maximum(theta2, _EPS * _EPS))
    small = theta2 < _EPS
    half = 0.5 * theta
    cot_term = jnp.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * jnp.cos(half) / jnp.maximum(jnp.sin(half), _EPS)) / theta2,
    )
    k = hat(phi)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), k.shape)
    v_inv = eye - 0.5 * k + cot_term[..., None, None] * (k @ k)
    rho = jnp.einsum("...ij,...j->...i", v_inv, t)
    return jnp.concatenate([rho, phi], axis=-1)


def se3_compose(ra, ta, rb, tb):
    """(Ra,ta) * (Rb,tb): apply b first, then a."""
    return ra @ rb, jnp.einsum("...ij,...j->...i", ra, tb) + ta


def se3_inverse(rot, t):
    rinv = jnp.swapaxes(rot, -1, -2)
    return rinv, -jnp.einsum("...ij,...j->...i", rinv, t)


def se3_apply(rot, t, pts):
    """Transform points: [..., 3, 3], [..., 3], [..., N, 3] -> [..., N, 3]."""
    return jnp.einsum("...ij,...nj->...ni", rot, pts) + t[..., None, :]


def se3_apply_one(rot, t, pt):
    return jnp.einsum("...ij,...j->...i", rot, pt) + t


# ---------------------------------------------------------------------------
# Sim(3)  (s, R, t)
# ---------------------------------------------------------------------------

def sim3_identity(batch_shape=(), dtype=jnp.float32):
    rot, t = se3_identity(batch_shape, dtype)
    return jnp.ones(batch_shape, dtype=dtype), rot, t


def sim3_compose(sa, ra, ta, sb, rb, tb):
    """(sa,Ra,ta) * (sb,Rb,tb): x -> sa*Ra*(sb*Rb*x + tb) + ta."""
    return (
        sa * sb,
        ra @ rb,
        sa[..., None] * jnp.einsum("...ij,...j->...i", ra, tb) + ta,
    )


def sim3_inverse(s, rot, t):
    rinv = jnp.swapaxes(rot, -1, -2)
    sinv = 1.0 / s
    return sinv, rinv, -sinv[..., None] * jnp.einsum("...ij,...j->...i", rinv, t)


def sim3_apply(s, rot, t, pts):
    return s[..., None, None] * jnp.einsum("...ij,...nj->...ni", rot, pts) + t[..., None, :]


def sim3_exp(xi: jnp.ndarray):
    """7-vector [rho, phi, sigma] -> (s, R, t). Matches Sophus Sim3 exp."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    s = jnp.exp(sigma)
    rot = so3_exp(phi)
    theta2 = jnp.sum(phi * phi, axis=-1)
    theta = jnp.sqrt(jnp.maximum(theta2, _EPS * _EPS))
    k = hat(phi)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), k.shape)
    # W matrix (Sophus sim3.hpp calc_W): t = W @ rho, with scale coupling.
    small_sig = jnp.abs(sigma) < _EPS
    small_th = theta2 < _EPS

    a_coef = jnp.where(small_sig, jnp.zeros_like(sigma), (s - 1.0) / jnp.where(small_sig, 1.0, sigma))
    c_coef = jnp.where(small_sig, jnp.ones_like(sigma), a_coef)  # C in Sophus

    # For theta small: W ~ C*I + ((sigma-1+s)/sigma^2  ...) — use double Taylor.
    sig_safe = jnp.where(small_sig, 1.0, sigma)
    th_safe = jnp.where(small_th, 1.0, theta)
    denom = sig_safe * sig_safe + theta2

    a_big = jnp.where(
        small_sig,
        (1.0 - jnp.cos(th_safe)) / jnp.maximum(theta2, _EPS),
        (s * jnp.sin(th_safe) * sig_safe + (1.0 - s * jnp.cos(th_safe)) * th_safe)
        / jnp.maximum(th_safe * denom, _EPS),
    )
    b_big = jnp.where(
        small_sig,
        (th_safe - jnp.sin(th_safe)) / jnp.maximum(theta2 * th_safe, _EPS),
        (
            c_coef
            - ((s * jnp.cos(th_safe) - 1.0) * sig_safe + s * jnp.sin(th_safe) * th_safe)
            / jnp.maximum(denom, _EPS)
        )
        / jnp.maximum(theta2, _EPS),
    )
    a_final = jnp.where(small_th, jnp.where(small_sig, 0.5 * jnp.ones_like(sigma), ((sig_safe - 1.0) * s + 1.0) / jnp.maximum(sig_safe * sig_safe, _EPS)), a_big)
    b_final = jnp.where(small_th, jnp.zeros_like(sigma), b_big)
    w_mat = c_coef[..., None, None] * eye + a_final[..., None, None] * k + b_final[..., None, None] * (k @ k)
    t = jnp.einsum("...ij,...j->...i", w_mat, rho)
    return s, rot, t
