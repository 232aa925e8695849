"""Host-numpy VI initialization solvers.

The IMU-init state machine (LocalMapping::InitializeIMU essence,
/root/reference/src/LocalMapping.cc:1552, VigInit :1804, IMUAlign :2111,
ScaleRefinement :2446) runs over at most ~10 keyframes. As device programs
the jnp versions (solvers/inertial.py) recompile on every attempt, because
the KF-chain length grows until init succeeds, and each attempt ends in a
blocking read. The closed-form solves are tiny dense least-squares, so the
production init path runs them here in numpy; the device only sees one
fixed-shape gather of KF states and one fixed-shape apply (system.py).

The jnp twins in solvers/inertial.py remain the reference implementation
(unit-tested against each other) and serve jit-composed callers.
"""
from __future__ import annotations

import numpy as np


def so3_exp_np(w: np.ndarray) -> np.ndarray:
    th = float(np.linalg.norm(w))
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]],
                 np.float64)
    if th < 1e-8:
        return np.eye(3) + K
    return (np.eye(3) + np.sin(th) / th * K
            + (1 - np.cos(th)) / th**2 * (K @ K))


def so3_log_np(r: np.ndarray) -> np.ndarray:
    c = np.clip((np.trace(r) - 1.0) * 0.5, -1.0, 1.0)
    th = np.arccos(c)
    if th < 1e-8:
        return np.array([r[2, 1] - r[1, 2], r[0, 2] - r[2, 0],
                         r[1, 0] - r[0, 1]]) * 0.5
    return th / (2 * np.sin(th)) * np.array(
        [r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1]])


def solve_gyro_bias_np(rots_wb, dRs, JRgs, iters: int = 5) -> np.ndarray:
    """Gyro-bias GN over consecutive-KF rotation constraints (imu_ceres.h
    GyroscopeBiasCostFunction): min ||Log((dR exp(JRg bg))^T R1^T R2)||^2.
    Jacobian by central differences (3 params, S<=9 segments)."""
    rots_wb = np.asarray(rots_wb, np.float64)
    dRs = np.asarray(dRs, np.float64)
    JRgs = np.asarray(JRgs, np.float64)
    s = len(dRs)

    def residuals(bg):
        out = np.empty((s, 3))
        for i in range(s):
            dRb = dRs[i] @ so3_exp_np(JRgs[i] @ bg)
            out[i] = so3_log_np(dRb.T @ rots_wb[i].T @ rots_wb[i + 1])
        return out

    bg = np.zeros(3)
    eps = 1e-6
    for _ in range(iters):
        r = residuals(bg)
        j = np.empty((s, 3, 3))
        for a in range(3):
            d = np.zeros(3)
            d[a] = eps
            j[:, :, a] = (residuals(bg + d) - residuals(bg - d)) / (2 * eps)
        h = np.einsum("sri,srj->ij", j, j) + 1e-9 * np.eye(3)
        g = -np.einsum("sri,sr->i", j, r)
        bg = bg + np.linalg.solve(h, g)
    return bg.astype(np.float32)


def solve_gravity_scale_velocities_np(rots_wb, ps_wb, dts, dVs, dPs,
                                      solve_scale: bool = False):
    """Linear VI init (ImuInitializer::solve_gravity_scale essence):
      s*(p2-p1) = v1*dt + 0.5 g dt^2 + R1 dP
      v2 = v1 + g dt + R1 dV
    Returns (velocities [K,3], gravity [3], scale)."""
    rots_wb = np.asarray(rots_wb, np.float64)
    ps_wb = np.asarray(ps_wb, np.float64)
    dts = np.asarray(dts, np.float64)
    dVs = np.asarray(dVs, np.float64)
    dPs = np.asarray(dPs, np.float64)
    k = len(rots_wb)
    sc = k - 1
    nx = 3 * k + 3 + (1 if solve_scale else 0)
    a = np.zeros((6 * sc, nx))
    b = np.zeros(6 * sc)
    for i in range(sc):
        dt = dts[i]
        r1 = rots_wb[i]
        rp, rv = 6 * i, 6 * i + 3
        a[rp:rp + 3, 3 * i:3 * i + 3] = np.eye(3) * dt
        a[rp:rp + 3, 3 * k:3 * k + 3] = 0.5 * dt * dt * np.eye(3)
        if solve_scale:
            a[rp:rp + 3, -1] = -(ps_wb[i + 1] - ps_wb[i])
            b[rp:rp + 3] = -(r1 @ dPs[i])
        else:
            b[rp:rp + 3] = (ps_wb[i + 1] - ps_wb[i]) - r1 @ dPs[i]
        a[rv:rv + 3, 3 * i:3 * i + 3] = -np.eye(3)
        a[rv:rv + 3, 3 * (i + 1):3 * (i + 1) + 3] = np.eye(3)
        a[rv:rv + 3, 3 * k:3 * k + 3] = -dt * np.eye(3)
        b[rv:rv + 3] = r1 @ dVs[i]
    x, *_ = np.linalg.lstsq(a, b, rcond=None)
    vels = x[:3 * k].reshape(k, 3).astype(np.float32)
    grav = x[3 * k:3 * k + 3].astype(np.float32)
    scale = float(x[-1]) if solve_scale else 1.0
    return vels, grav, scale


def _gravity_tangent_basis_np(g_dir):
    e = (np.array([0.0, 0.0, 1.0]) if abs(g_dir[2]) < 0.9
         else np.array([1.0, 0.0, 0.0]))
    b1 = np.cross(g_dir, e)
    b1 = b1 / max(np.linalg.norm(b1), 1e-9)
    b2 = np.cross(g_dir, b1)
    return np.stack([b1, b2], axis=1)


def solve_accelerometer_analytic_np(rots_wb, ps_wb, dts, dVs, dPs, JPa, JVa,
                                    solve_scale: bool = False,
                                    g_mag: float = 9.81):
    """Accelerometer init with bias (methods.h analytic/mqh essence): linear
    system extended with ba via the preintegration Jacobians; pass 1 frees
    gravity, pass 2 re-solves with |g| = g_mag on the S2 tangent.
    Returns (velocities [K,3], gravity [3], ba [3], scale)."""
    rots_wb = np.asarray(rots_wb, np.float64)
    ps_wb = np.asarray(ps_wb, np.float64)
    dts = np.asarray(dts, np.float64)
    dVs = np.asarray(dVs, np.float64)
    dPs = np.asarray(dPs, np.float64)
    JPa = np.asarray(JPa, np.float64)
    JVa = np.asarray(JVa, np.float64)
    k = len(rots_wb)
    sc = k - 1

    def build(g0_dir):
        free_g = g0_dir is None
        ng = 3 if free_g else 2
        basis = None if free_g else _gravity_tangent_basis_np(g0_dir)
        nxx = 3 * k + ng + 3 + (1 if solve_scale else 0)
        a = np.zeros((6 * sc, nxx))
        b = np.zeros(6 * sc)
        for i in range(sc):
            dt = dts[i]
            r1 = rots_wb[i]
            rp, rv = 6 * i, 6 * i + 3
            a[rp:rp + 3, 3 * i:3 * i + 3] = np.eye(3) * dt
            a[rp:rp + 3, 3 * k:3 * k + ng] = \
                0.5 * dt * dt * (np.eye(3) if free_g else g_mag * basis)
            a[rp:rp + 3, 3 * k + ng:3 * k + ng + 3] = r1 @ JPa[i]
            b_p0 = -(r1 @ dPs[i])
            if not free_g:
                b_p0 = b_p0 - 0.5 * dt * dt * g_mag * g0_dir
            if solve_scale:
                a[rp:rp + 3, -1] = -(ps_wb[i + 1] - ps_wb[i])
                b[rp:rp + 3] = b_p0
            else:
                b[rp:rp + 3] = (ps_wb[i + 1] - ps_wb[i]) + b_p0
            a[rv:rv + 3, 3 * i:3 * i + 3] = -np.eye(3)
            a[rv:rv + 3, 3 * (i + 1):3 * (i + 1) + 3] = np.eye(3)
            a[rv:rv + 3, 3 * k:3 * k + ng] = \
                -dt * (np.eye(3) if free_g else g_mag * basis)
            a[rv:rv + 3, 3 * k + ng:3 * k + ng + 3] = -(r1 @ JVa[i])
            b_v = r1 @ dVs[i]
            if not free_g:
                b_v = b_v + dt * g_mag * g0_dir
            b[rv:rv + 3] = b_v
        return a, b, ng, basis

    a, b, ng, _ = build(None)
    x, *_ = np.linalg.lstsq(a, b, rcond=None)
    g0 = x[3 * k:3 * k + 3]
    g0_dir = g0 / max(np.linalg.norm(g0), 1e-9)
    a, b, ng, basis = build(g0_dir)
    x, *_ = np.linalg.lstsq(a, b, rcond=None)
    vels = x[:3 * k].reshape(k, 3).astype(np.float32)
    grav = g_mag * (g0_dir + basis @ x[3 * k:3 * k + 2])
    grav = (g_mag * grav / max(np.linalg.norm(grav), 1e-9)).astype(np.float32)
    ba = x[3 * k + 2:3 * k + 5].astype(np.float32)
    scale = float(x[-1]) if solve_scale else 1.0
    return vels, grav, ba, scale


def solve_scale_refinement_np(rots_wb, ps_wb, dts, dVs, dPs, vels,
                              g_mag: float = 9.81, g_dir=None):
    """ScaleRefinement (LocalMapping.cc:2446): velocities held from the map;
    re-estimate scale + 2-DoF gravity correction. Returns (scale, grav)."""
    rots_wb = np.asarray(rots_wb, np.float64)
    ps_wb = np.asarray(ps_wb, np.float64)
    dts = np.asarray(dts, np.float64)
    dVs = np.asarray(dVs, np.float64)
    dPs = np.asarray(dPs, np.float64)
    vels = np.asarray(vels, np.float64)
    if g_dir is None:
        g_dir = np.array([0.0, 0.0, -1.0])
    basis = _gravity_tangent_basis_np(g_dir)
    k = len(rots_wb)
    a = np.zeros((3 * (k - 1), 3))
    b = np.zeros(3 * (k - 1))
    for i in range(k - 1):
        dt = dts[i]
        r = 3 * i
        a[r:r + 3, 0] = ps_wb[i + 1] - ps_wb[i]
        a[r:r + 3, 1:3] = -0.5 * g_mag * dt * dt * basis
        b[r:r + 3] = (vels[i] * dt + 0.5 * g_mag * dt * dt * g_dir
                      + rots_wb[i] @ dPs[i])
    x, *_ = np.linalg.lstsq(a, b, rcond=None)
    scale = float(x[0])
    grav = g_mag * (g_dir + basis @ x[1:3])
    grav = (g_mag * grav / max(np.linalg.norm(grav), 1e-9)).astype(np.float32)
    return scale, grav


def gravity_alignment_rotation_np(gravity) -> np.ndarray:
    """R_wg aligning estimated gravity to (0,0,-|g|): world' = R @ world."""
    g = np.asarray(gravity, np.float64)
    g = g / max(np.linalg.norm(g), 1e-9)
    target = np.array([0.0, 0.0, -1.0])
    v = np.cross(g, target)
    c = float(np.dot(g, target))
    s = float(np.linalg.norm(v))
    axis = v / max(s, 1e-9)
    return so3_exp_np(axis * np.arctan2(s, c)).astype(np.float32)
