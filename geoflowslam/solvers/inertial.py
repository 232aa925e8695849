"""Visual-inertial pose optimization + IMU initialization solvers.

JAX replacement for the inertial g2o machinery:
* PoseInertialOptimizationLastKeyFrame / LastFrame
  (/root/reference/src/Optimizer.cc:5899, :6762) — current-frame
  (pose, velocity, bias) GN against the last state through the
  preintegrated IMU factor (EdgeInertial, include/G2oTypes.h:458) +
  bias random walk (EdgeGyroRW/EdgeAccRW :719-819) + reprojection terms.
* InertialOptimization (gravity/bias/scale estimation, Optimizer.cc:4489+)
  used by LocalMapping::InitializeIMU — here a closed-form linear solve for
  (gravity, per-KF velocities, scale) after a gyro-bias GN, the standard
  VI-init decomposition (also covers the reference's VIG-Init/methods.h
  closed-form alternatives).

State convention: body pose (R_wb, p_wb) + velocity v_w + bias (bg, ba).
Camera reprojection goes through the body->cam extrinsic T_cb.
Jacobians of the inertial terms come from jax.jacfwd over the 15-dim tangent
(right-multiplicative on R_wb) — exact, and cheap at this size.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

from functools import partial

import jax
import jax.numpy as jnp

from geoflowslam.math import lie
from geoflowslam.imu import preintegration as pre
from geoflowslam.solvers.pose_opt import (
    CHI2_MONO, CHI2_STEREO, HUBER_MONO, HUBER_STEREO, PoseObs, _huber_w,
)


class BodyState(NamedTuple):
    r_wb: jnp.ndarray   # [3,3]
    p: jnp.ndarray      # [3]
    v: jnp.ndarray      # [3]
    bg: jnp.ndarray     # [3]
    ba: jnp.ndarray     # [3]


def apply_tangent(s: BodyState, d: jnp.ndarray) -> BodyState:
    """Right-multiplicative 15-dim update (ImuCamPose::Update convention)."""
    return BodyState(
        r_wb=s.r_wb @ lie.so3_exp(d[0:3]),
        p=s.p + s.r_wb @ d[3:6],
        v=s.v + d[6:9],
        bg=s.bg + d[9:12],
        ba=s.ba + d[12:15],
    )


def cam_pose_from_body(s: BodyState, r_cb: jnp.ndarray, t_cb: jnp.ndarray):
    """T_cw = T_cb * T_bw."""
    r_bw = s.r_wb.T
    t_bw = -r_bw @ s.p
    rot = r_cb @ r_bw
    t = r_cb @ t_bw + t_cb
    return rot, t


def inertial_residual(s1: BodyState, s2: BodyState, p: pre.Preintegrated,
                      gravity=pre.GRAVITY):
    """EdgeInertial 9-dim residual (G2oTypes.cc EdgeInertial::computeError),
    using s1's bias through the preintegration bias Jacobians."""
    bias = jnp.concatenate([s1.bg, s1.ba])
    dR = pre.delta_rotation(p, bias)
    dV = pre.delta_velocity(p, bias)
    dP = pre.delta_position(p, bias)
    dt = p.dt
    er = lie.so3_log(dR.T @ s1.r_wb.T @ s2.r_wb)
    ev = s1.r_wb.T @ (s2.v - s1.v - gravity * dt) - dV
    ep = s1.r_wb.T @ (s2.p - s1.p - s1.v * dt - 0.5 * gravity * dt * dt) - dP
    return jnp.concatenate([er, ev, ep])


def _reproj_residual_body(s: BodyState, obs: PoseObs, r_cb, t_cb,
                          fx, fy, cx, cy, bf):
    rot, t = cam_pose_from_body(s, r_cb, t_cb)
    pc = obs.pts_w @ rot.T + t
    z = pc[:, 2]
    zs = jnp.where(jnp.abs(z) < 1e-6, 1e-6, z)
    u = fx * pc[:, 0] / zs + cx
    v = fy * pc[:, 1] / zs + cy
    ur = u - bf / zs
    r = jnp.stack([obs.uv[:, 0] - u, obs.uv[:, 1] - v,
                   jnp.where(obs.is_stereo, obs.u_right - ur, 0.0)], axis=1)
    return r, z


@partial(jax.jit, static_argnames=("rounds", "iters", "return_info"))
def inertial_pose_optimization(
    s2: BodyState, s1: BodyState, preint: pre.Preintegrated,
    obs: PoseObs, r_cb, t_cb, fx, fy, cx, cy, bf=0.0,
    calib: Optional[pre.ImuCalib] = None,
    prior_s2: Optional[BodyState] = None, prior_info: Optional[jnp.ndarray] = None,
    rounds: int = 4, iters: int = 10, return_info: bool = False,
):
    """Optimize the current body state s2; s1 (last KF/frame) is fixed.

    Mirrors PoseInertialOptimizationLastKeyFrame: 4 rounds of GN with
    chi-square re-gating of reprojection edges between rounds. Returns
    (s2, inlier_mask, n_inliers) — plus the 15x15 information matrix of s2
    at the solution when return_info (the reference recovers it the same
    way to seed the next frame's EdgePriorPoseImu, Optimizer.cc:6334+).
    """
    info9 = jnp.linalg.inv(preint.cov[:9, :9] + 1e-6 * jnp.eye(9))
    info9 = 0.5 * (info9 + info9.T)
    # bias random walk over THIS segment: the preintegration's accumulated
    # walk covariance (per-sample cov here would be ~100x too stiff)
    walk_info = jnp.linalg.inv(preint.cov[9:15, 9:15] + 1e-10 * jnp.eye(6))

    inlier = obs.valid

    def gn(s2, inlier, use_huber):
        def body(_, s2_flat):
            s2c = s2_flat

            def full_residual(d):
                s = apply_tangent(s2c, d)
                r_re, z = _reproj_residual_body(s, obs, r_cb, t_cb, fx, fy, cx, cy, bf)
                r_in = inertial_residual(s1, s, preint)
                # bias random walk to s1's bias
                r_bw = jnp.concatenate([s.bg - s1.bg, s.ba - s1.ba])
                return r_re, r_in, r_bw, z

            d0 = jnp.zeros(15)
            (r_re, r_in, r_bw, z) = full_residual(d0)
            jac = jax.jacfwd(lambda d: full_residual(d)[:3])(d0)
            j_re, j_in, j_bw = jac

            chi2 = (r_re[:, 0] ** 2 + r_re[:, 1] ** 2
                    + jnp.where(obs.is_stereo, r_re[:, 2] ** 2, 0.0)) * obs.inv_sigma2
            delta = jnp.where(obs.is_stereo, HUBER_STEREO, HUBER_MONO)
            w = _huber_w(chi2, delta) if use_huber else jnp.ones_like(chi2)
            w = w * obs.inv_sigma2 * (inlier & (z > 0)).astype(r_re.dtype)
            rm = jnp.stack([jnp.ones_like(w), jnp.ones_like(w),
                            obs.is_stereo.astype(w.dtype)], 1)
            wr = w[:, None] * rm

            h = jnp.einsum("nri,nr,nrj->ij", j_re, wr, j_re)
            g = -jnp.einsum("nri,nr->i", j_re, wr * r_re)
            h = h + j_in.T @ info9 @ j_in
            g = g - j_in.T @ info9 @ r_in
            h = h + j_bw.T @ walk_info @ j_bw
            g = g - j_bw.T @ walk_info @ r_bw
            if prior_s2 is not None and prior_info is not None:
                # prior residual: tangent from prior to current
                dr = lie.so3_log(prior_s2.r_wb.T @ s2c.r_wb)
                dp = prior_s2.r_wb.T @ (s2c.p - prior_s2.p)
                dv = s2c.v - prior_s2.v
                dbg = s2c.bg - prior_s2.bg
                dba = s2c.ba - prior_s2.ba
                r_pr = jnp.concatenate([dr, dp, dv, dbg, dba])
                h = h + prior_info
                g = g - prior_info @ r_pr
            h = h + 1e-3 * jnp.diag(jnp.diag(h)) + 1e-5 * jnp.eye(15)
            # Jacobi preconditioning: blocks span ~1e2 (reproj) to ~1e8+
            # (IMU/bias) — unscaled f32 solves corrupt the small blocks
            dj = 1.0 / jnp.sqrt(jnp.maximum(jnp.diag(h), 1e-12))
            h_n = h * dj[:, None] * dj[None, :]
            dx = dj * jnp.linalg.solve(h_n, dj * g)
            dx = jnp.where(jnp.all(jnp.isfinite(dx)), dx, 0.0)
            return apply_tangent(s2c, dx)

        return jax.lax.fori_loop(0, iters, body, s2)

    for rnd in range(rounds):
        s2 = gn(s2, inlier, use_huber=(rnd < rounds - 1))
        r_re, z = _reproj_residual_body(s2, obs, r_cb, t_cb, fx, fy, cx, cy, bf)
        chi2 = (r_re[:, 0] ** 2 + r_re[:, 1] ** 2
                + jnp.where(obs.is_stereo, r_re[:, 2] ** 2, 0.0)) * obs.inv_sigma2
        th = jnp.where(obs.is_stereo, CHI2_STEREO, CHI2_MONO)
        inlier = obs.valid & (chi2 <= th) & (z > 0)

    s2 = s2._replace(r_wb=lie.normalize_rotation(s2.r_wb))
    if not return_info:
        return s2, inlier, jnp.sum(inlier)

    # Recover the information of s2 at the solution (reprojection inliers +
    # inertial + bias-walk terms) for the next frame's marginalized prior.
    def res_all(d):
        s = apply_tangent(s2, d)
        r_re, z = _reproj_residual_body(s, obs, r_cb, t_cb, fx, fy, cx, cy, bf)
        r_in = inertial_residual(s1, s, preint)
        r_bw = jnp.concatenate([s.bg - s1.bg, s.ba - s1.ba])
        return r_re, r_in, r_bw

    j_re, j_in, j_bw = jax.jacfwd(res_all)(jnp.zeros(15))
    w = obs.inv_sigma2 * (inlier & (z > 0)).astype(jnp.float32)
    rm = jnp.stack([jnp.ones_like(w), jnp.ones_like(w),
                    obs.is_stereo.astype(w.dtype)], 1)
    wr = w[:, None] * rm
    info = (jnp.einsum("nri,nr,nrj->ij", j_re, wr, j_re)
            + j_in.T @ info9 @ j_in + j_bw.T @ walk_info @ j_bw)
    info = _sanitize_info(info)
    return s2, inlier, jnp.sum(inlier), info


def _sanitize_info(info: jnp.ndarray) -> jnp.ndarray:
    """Symmetrize + clamp a marginal information matrix to PSD (f32 Schur
    complements can go slightly indefinite)."""
    info = 0.5 * (info + info.T)
    ev, vec = jnp.linalg.eigh(info)
    ev = jnp.clip(ev, 0.0, None)
    info = (vec * ev[None, :]) @ vec.T
    return jnp.where(jnp.all(jnp.isfinite(info)), info,
                     jnp.zeros_like(info))


def _prior_tangent(s: BodyState, mean: BodyState) -> jnp.ndarray:
    """15-dim right tangent of s relative to mean (EdgePriorPoseImu residual,
    include/G2oTypes.h:905: the error is the update that maps the prior mean
    to the current estimate, in the apply_tangent convention)."""
    dr = lie.so3_log(mean.r_wb.T @ s.r_wb)
    dp = mean.r_wb.T @ (s.p - mean.p)
    return jnp.concatenate([dr, dp, s.v - mean.v, s.bg - mean.bg,
                            s.ba - mean.ba])


@partial(jax.jit, static_argnames=("rounds", "iters"))
def inertial_pose_optimization_joint(
    s2: BodyState, s1: BodyState, prior_info: jnp.ndarray,
    preint: pre.Preintegrated, obs: PoseObs, r_cb, t_cb,
    fx, fy, cx, cy, bf=0.0, rounds: int = 4, iters: int = 6,
):
    """PoseInertialOptimizationLastFrame (Optimizer.cc:6762): joint GN over
    the PREVIOUS frame state s1 — held only by its marginalized prior
    (EdgePriorPoseImu) — and the current frame s2 (reprojection + inertial
    + bias random walk). After convergence s1 is marginalized out by Schur
    complement; the marginal becomes the next frame's prior.

    This is what makes velocity observable in monocular-inertial tracking:
    with a frozen s1 the velocity chain is pure dead reckoning, while the
    joint solve lets the current frame's vision retro-correct v1.

    Returns (s2, inlier_mask, n_inliers, marg_info [15,15]).
    """
    info9 = jnp.linalg.inv(preint.cov[:9, :9] + 1e-6 * jnp.eye(9))
    info9 = 0.5 * (info9 + info9.T)
    walk_info = jnp.linalg.inv(preint.cov[9:15, 9:15] + 1e-10 * jnp.eye(6))
    s1_bar = s1  # prior mean = last frame's solution

    inlier = obs.valid

    def res_all(s1c, s2c, d):
        sa = apply_tangent(s1c, d[:15])
        sb = apply_tangent(s2c, d[15:])
        r_re, z = _reproj_residual_body(sb, obs, r_cb, t_cb, fx, fy, cx, cy, bf)
        r_in = inertial_residual(sa, sb, preint)
        r_bw = jnp.concatenate([sb.bg - sa.bg, sb.ba - sa.ba])
        r_pr = _prior_tangent(sa, s1_bar)
        return r_re, r_in, r_bw, r_pr, z

    def obs_weights(z, inlier, use_huber, r_re):
        chi2 = (r_re[:, 0] ** 2 + r_re[:, 1] ** 2
                + jnp.where(obs.is_stereo, r_re[:, 2] ** 2, 0.0)) * obs.inv_sigma2
        delta = jnp.where(obs.is_stereo, HUBER_STEREO, HUBER_MONO)
        w = _huber_w(chi2, delta) if use_huber else jnp.ones_like(chi2)
        w = w * obs.inv_sigma2 * (inlier & (z > 0)).astype(r_re.dtype)
        rm = jnp.stack([jnp.ones_like(w), jnp.ones_like(w),
                        obs.is_stereo.astype(w.dtype)], 1)
        return w[:, None] * rm

    def assemble(s1c, s2c, inlier, use_huber):
        d0 = jnp.zeros(30)
        r_re, r_in, r_bw, r_pr, z = res_all(s1c, s2c, d0)
        j_re, j_in, j_bw, j_pr = jax.jacfwd(
            lambda d: res_all(s1c, s2c, d)[:4])(d0)
        wr = obs_weights(z, inlier, use_huber, r_re)
        h = jnp.einsum("nri,nr,nrj->ij", j_re, wr, j_re)
        g = -jnp.einsum("nri,nr->i", j_re, wr * r_re)
        h = h + j_in.T @ info9 @ j_in
        g = g - j_in.T @ info9 @ r_in
        h = h + j_bw.T @ walk_info @ j_bw
        g = g - j_bw.T @ walk_info @ r_bw
        h = h + j_pr.T @ prior_info @ j_pr
        g = g - j_pr.T @ prior_info @ r_pr
        return h, g

    def gn(carry, inlier, use_huber):
        def body(_, carry):
            s1c, s2c = carry
            h, g = assemble(s1c, s2c, inlier, use_huber)
            h = h + 1e-3 * jnp.diag(jnp.diag(h)) + 1e-5 * jnp.eye(30)
            dj = 1.0 / jnp.sqrt(jnp.maximum(jnp.diag(h), 1e-12))
            h_n = h * dj[:, None] * dj[None, :]
            dx = dj * jnp.linalg.solve(h_n, dj * g)
            dx = jnp.where(jnp.all(jnp.isfinite(dx)), dx, 0.0)
            return (apply_tangent(s1c, dx[:15]), apply_tangent(s2c, dx[15:]))
        return jax.lax.fori_loop(0, iters, body, carry)

    carry = (s1, s2)
    for rnd in range(rounds):
        carry = gn(carry, inlier, use_huber=(rnd < rounds - 1))
        r_re, z = _reproj_residual_body(carry[1], obs, r_cb, t_cb,
                                        fx, fy, cx, cy, bf)
        chi2 = (r_re[:, 0] ** 2 + r_re[:, 1] ** 2
                + jnp.where(obs.is_stereo, r_re[:, 2] ** 2, 0.0)) * obs.inv_sigma2
        th = jnp.where(obs.is_stereo, CHI2_STEREO, CHI2_MONO)
        inlier = obs.valid & (chi2 <= th) & (z > 0)

    s1f, s2f = carry
    # Marginalize s1: prior for the next frame = H22 - H21 H11^-1 H12 at the
    # solution, with inlier weights and no robust kernel.
    h, _ = assemble(s1f, s2f, inlier, use_huber=False)
    h = h + 1e-6 * jnp.eye(30)
    h11, h12, h22 = h[:15, :15], h[:15, 15:], h[15:, 15:]
    dj = 1.0 / jnp.sqrt(jnp.maximum(jnp.diag(h11), 1e-12))
    x = dj[:, None] * jnp.linalg.solve(h11 * dj[:, None] * dj[None, :],
                                       dj[:, None] * h12)
    marg = _sanitize_info(h22 - h12.T @ x)

    s2f = s2f._replace(r_wb=lie.normalize_rotation(s2f.r_wb))
    return s2f, inlier, jnp.sum(inlier), marg


# ---------------------------------------------------------------------------
# IMU initialization (InitializeIMU / VIG-Init family)
# ---------------------------------------------------------------------------

def solve_gyro_bias(rots_wb: jnp.ndarray, preints_dR: jnp.ndarray,
                    preints_JRg: jnp.ndarray, valid: jnp.ndarray,
                    iters: int = 5) -> jnp.ndarray:
    """Gyro-bias-only GN over consecutive-KF rotation constraints
    (imu_ceres.h GyroscopeBiasCostFunction / methods.h gyroscope_only):
    minimize || Log((dR exp(JRg bg))^T R1^T R2) ||^2 over segments."""
    def residuals(bg):
        def one(r1, r2, dR, jrg):
            dRb = dR @ lie.so3_exp(jrg @ bg)
            return lie.so3_log(dRb.T @ r1.T @ r2)
        return jax.vmap(one)(rots_wb[:-1], rots_wb[1:], preints_dR, preints_JRg)

    bg = jnp.zeros(3)
    w = valid.astype(jnp.float32)

    def body(_, bg):
        r = residuals(bg)
        j = jax.jacfwd(residuals)(bg)       # [S,3,3]
        h = jnp.einsum("s,sri,srj->ij", w, j, j) + 1e-9 * jnp.eye(3)
        g = -jnp.einsum("s,sri,sr->i", w, j, r)
        return bg + jnp.linalg.solve(h, g)

    return jax.lax.fori_loop(0, iters, body, bg)


def solve_gravity_scale_velocities(
    rots_wb, ps_wb, dts, dVs, dPs, valid, solve_scale: bool = False):
    """Linear VI initialization: solve per-KF velocities + gravity (+ scale)
    from preintegrated segments (ImuInitializer::solve_gravity_scale +
    InertialOptimization essence). K states, S = K-1 segments.

    Minimizes over x = [v_0..v_{K-1}, g, (s)] the position & velocity
    constraints:
      s*(p2-p1) = v1*dt + 0.5 g dt^2 + R1 dP
      v2 = v1 + g dt + R1 dV
    Returns (velocities [K,3], gravity [3], scale).
    """
    k = rots_wb.shape[0]
    s_count = k - 1
    nx = 3 * k + 3 + (1 if solve_scale else 0)

    rows = []
    rhs = []
    w = valid.astype(jnp.float32)

    a_list = []
    b_list = []
    for i in range(s_count):
        dt = dts[i]
        r1 = rots_wb[i]
        # position row (3 eqs)
        a_p = jnp.zeros((3, nx))
        a_p = a_p.at[:, 3 * i:3 * i + 3].set(jnp.eye(3) * dt)
        a_p = a_p.at[:, 3 * k:3 * k + 3].set(0.5 * dt * dt * jnp.eye(3))
        if solve_scale:
            a_p = a_p.at[:, -1].set(-(ps_wb[i + 1] - ps_wb[i]))
            b_p = -(r1 @ dPs[i])
        else:
            b_p = (ps_wb[i + 1] - ps_wb[i]) - r1 @ dPs[i]
        # velocity row (3 eqs)
        a_v = jnp.zeros((3, nx))
        a_v = a_v.at[:, 3 * i:3 * i + 3].set(-jnp.eye(3))
        a_v = a_v.at[:, 3 * (i + 1):3 * (i + 1) + 3].set(jnp.eye(3))
        a_v = a_v.at[:, 3 * k:3 * k + 3].set(-dt * jnp.eye(3))
        b_v = r1 @ dVs[i]
        a_list += [a_p * w[i], a_v * w[i]]
        b_list += [b_p * w[i], b_v * w[i]]

    a = jnp.concatenate(a_list, axis=0)
    b = jnp.concatenate(b_list, axis=0)
    x, *_ = jnp.linalg.lstsq(a, b)
    vels = x[:3 * k].reshape(k, 3)
    grav = x[3 * k:3 * k + 3]
    scale = x[-1] if solve_scale else jnp.ones(())
    return vels, grav, scale


def _gravity_tangent_basis(g_dir: jnp.ndarray) -> jnp.ndarray:
    """[3,2] basis of the plane orthogonal to g_dir
    (ImuInitializer::s2_tangential_basis, include/ImuInitializer.h:47)."""
    e = jnp.where(jnp.abs(g_dir[2]) < 0.9,
                  jnp.array([0.0, 0.0, 1.0]), jnp.array([1.0, 0.0, 0.0]))
    b1 = jnp.cross(g_dir, e)
    b1 = b1 / jnp.maximum(jnp.linalg.norm(b1), 1e-9)
    b2 = jnp.cross(g_dir, b1)
    return jnp.stack([b1, b2], axis=1)


def solve_accelerometer_analytic(rots_wb, ps_wb, dts, dVs, dPs, JPa, JVa,
                                 valid, solve_scale: bool = False,
                                 g_mag: float = 9.81):
    """Accelerometer initialization with bias estimation
    (analytic_accelerometer / mqh_accelerometer essence,
    /root/reference/include/methods.h:127,398 + src/polynomial.cc): extend
    the linear VI system with the accelerometer bias through the
    preintegration Jacobians (dP ~= dP0 + JPa ba, dV ~= dV0 + JVa ba), solve
    unconstrained, then re-solve with the gravity-magnitude constraint by
    parameterizing g = g_mag * (g0_dir + B delta) on the S2 tangent (the
    reference enforces |g| = G via a polynomial root / Lagrangian solve; the
    tangent relinearization reaches the same constrained optimum here since
    the unconstrained g is already near the sphere).

    Returns (velocities [K,3], gravity [3] with |g| = g_mag, ba [3], scale).
    """
    k = rots_wb.shape[0]
    s_count = k - 1
    nx = 3 * k + 3 + 3 + (1 if solve_scale else 0)   # v, g, ba, (s)
    w = valid.astype(jnp.float32)

    def build(g0_dir=None):
        """g0_dir None: free gravity (3 dof); else 2-dof tangent around it."""
        free_g = g0_dir is None
        ng = 3 if free_g else 2
        nxx = 3 * k + ng + 3 + (1 if solve_scale else 0)
        basis = None if free_g else _gravity_tangent_basis(g0_dir)
        a_list, b_list = [], []
        for i in range(s_count):
            dt = dts[i]
            r1 = rots_wb[i]
            # position row: s(p2-p1) = v1 dt + 0.5 g dt^2 + R1(dP + JPa ba)
            a_p = jnp.zeros((3, nxx))
            a_p = a_p.at[:, 3 * i:3 * i + 3].set(jnp.eye(3) * dt)
            gcol = 0.5 * dt * dt * (jnp.eye(3) if free_g
                                    else g_mag * basis)
            a_p = a_p.at[:, 3 * k:3 * k + ng].set(gcol)
            a_p = a_p.at[:, 3 * k + ng:3 * k + ng + 3].set(r1 @ JPa[i])
            b_p0 = -(r1 @ dPs[i])
            if not free_g:
                b_p0 = b_p0 - 0.5 * dt * dt * g_mag * g0_dir
            if solve_scale:
                a_p = a_p.at[:, -1].set(-(ps_wb[i + 1] - ps_wb[i]))
                b_p = b_p0
            else:
                b_p = (ps_wb[i + 1] - ps_wb[i]) + b_p0
            # velocity row: v2 = v1 + g dt + R1(dV + JVa ba)
            a_v = jnp.zeros((3, nxx))
            a_v = a_v.at[:, 3 * i:3 * i + 3].set(-jnp.eye(3))
            a_v = a_v.at[:, 3 * (i + 1):3 * (i + 1) + 3].set(jnp.eye(3))
            gvol = -dt * (jnp.eye(3) if free_g else g_mag * basis)
            a_v = a_v.at[:, 3 * k:3 * k + ng].set(gvol)
            # v2 - v1 - g dt - R1 JVa ba = R1 dV  (ba coefficient is negative)
            a_v = a_v.at[:, 3 * k + ng:3 * k + ng + 3].set(-(r1 @ JVa[i]))
            b_v = r1 @ dVs[i]
            if not free_g:
                b_v = b_v + dt * g_mag * g0_dir
            a_list += [a_p * w[i], a_v * w[i]]
            b_list += [b_p * w[i], b_v * w[i]]
        return (jnp.concatenate(a_list, 0), jnp.concatenate(b_list, 0),
                ng, basis)

    # pass 1: unconstrained gravity
    a, b, ng, _ = build(None)
    x, *_ = jnp.linalg.lstsq(a, b)
    g0 = x[3 * k:3 * k + 3]
    g0_dir = g0 / jnp.maximum(jnp.linalg.norm(g0), 1e-9)
    # pass 2: |g| = g_mag enforced on the tangent
    a, b, ng, basis = build(g0_dir)
    x, *_ = jnp.linalg.lstsq(a, b)
    vels = x[:3 * k].reshape(k, 3)
    delta = x[3 * k:3 * k + 2]
    grav = g_mag * (g0_dir + basis @ delta)
    grav = g_mag * grav / jnp.maximum(jnp.linalg.norm(grav), 1e-9)
    ba = x[3 * k + 2:3 * k + 5]
    scale = x[-1] if solve_scale else jnp.ones(())
    return vels, grav, ba, scale


def solve_scale_refinement(rots_wb, ps_wb, dts, dVs, dPs, vels, g_mag=9.81,
                           g_dir=None):
    """LocalMapping::ScaleRefinement (/root/reference/src/LocalMapping.cc:2446
    -> InertialOptimization(Map*, Rwg, scale)): with velocities and biases
    held from the map, re-estimate only the map scale and a 2-DoF gravity
    direction correction from the position constraints.

    Returns (scale, gravity [3] with |g| = g_mag)."""
    k = rots_wb.shape[0]
    if g_dir is None:
        g_dir = jnp.array([0.0, 0.0, -1.0])
    basis = _gravity_tangent_basis(g_dir)
    a_list, b_list = [], []
    for i in range(k - 1):
        dt = dts[i]
        r1 = rots_wb[i]
        # s (p2 - p1) - 0.5 g_mag (B d) dt^2 = v1 dt + 0.5 g_mag g_dir dt^2 + R1 dP
        a_row = jnp.zeros((3, 3))
        a_row = a_row.at[:, 0].set(ps_wb[i + 1] - ps_wb[i])
        a_row = a_row.at[:, 1:3].set(-0.5 * g_mag * dt * dt * basis)
        b_row = vels[i] * dt + 0.5 * g_mag * dt * dt * g_dir + r1 @ dPs[i]
        a_list.append(a_row)
        b_list.append(b_row)
    a = jnp.concatenate(a_list, 0)
    b = jnp.concatenate(b_list, 0)
    x, *_ = jnp.linalg.lstsq(a, b)
    scale = x[0]
    grav = g_mag * (g_dir + basis @ x[1:3])
    grav = g_mag * grav / jnp.maximum(jnp.linalg.norm(grav), 1e-9)
    return scale, grav


def gravity_alignment_rotation(gravity: jnp.ndarray) -> jnp.ndarray:
    """R_wg aligning estimated gravity to (0,0,-9.81): world' = R @ world."""
    g_norm = gravity / jnp.maximum(jnp.linalg.norm(gravity), 1e-9)
    target = jnp.array([0.0, 0.0, -1.0])
    v = jnp.cross(g_norm, target)
    c = jnp.dot(g_norm, target)
    s = jnp.linalg.norm(v)
    axis = v / jnp.maximum(s, 1e-9)
    angle = jnp.arctan2(s, c)
    return lie.so3_exp(axis * angle)
