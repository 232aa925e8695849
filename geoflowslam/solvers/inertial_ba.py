"""Visual-inertial windowed bundle adjustment (LocalInertialBA).

JAX replacement for Optimizer::LocalInertialBA
(/root/reference/src/Optimizer.cc:3056) and FullInertialBA (:365): a
temporal window of KF states (pose, velocity, gyro/acc bias — 15 DoF each)
jointly optimized with landmarks under reprojection + preintegrated-IMU +
bias-random-walk factors.

Structure exploited as dense batched matmuls:
* landmarks eliminated by the same dense Schur trick as solvers/local_ba.py
  (Hll block-diagonal, one einsum for the reduced system);
* the reduced state system S is dense [(15K)^2] — K is the ~10-KF temporal
  window of the reference, so S is at most ~150x150: one Cholesky;
* inertial-edge Jacobians come from jax.jacfwd over the two adjacent
  15-dim tangents (exact, vmapped over the K-1 segments).

Preintegration segments arrive as stacked arrays (from the host's per-KF
Preintegrated buffers, pipeline/inertial.py).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from geoflowslam.math import lie
from geoflowslam.imu import preintegration as pre
from geoflowslam.solvers.local_ba import BAProblem, _residuals, _chi2
from geoflowslam.solvers.pose_opt import (
    CHI2_MONO, CHI2_STEREO, HUBER_MONO, HUBER_STEREO, _huber_w,
)


class ImuSegments(NamedTuple):
    """Stacked preintegration between consecutive window KFs i -> i+1."""
    dR: jnp.ndarray     # [S,3,3]
    dV: jnp.ndarray     # [S,3]
    dP: jnp.ndarray     # [S,3]
    JRg: jnp.ndarray    # [S,3,3]
    JVg: jnp.ndarray    # [S,3,3]
    JVa: jnp.ndarray    # [S,3,3]
    JPg: jnp.ndarray    # [S,3,3]
    JPa: jnp.ndarray    # [S,3,3]
    info9: jnp.ndarray      # [S,9,9] inverse preintegration covariance
    walk_info: jnp.ndarray  # [S,6,6] inverse SEGMENT bias random-walk cov
    dt: jnp.ndarray         # [S]
    bias0: jnp.ndarray      # [S,6] linearization bias
    valid: jnp.ndarray      # [S]


class RelPoseFactors(NamedTuple):
    """EdgeICP relative-pose factors between consecutive window KFs
    (include/G2oTypes.h:508-572, added inside LocalInertialBA when the
    inter-KF GICP passes its 400-inlier gate, Optimizer.cc:3260-3321).
    Measurement: T_rel = T_cw[i+1] ∘ T_cw[i]^-1 (camera frames)."""
    rot: jnp.ndarray   # [S,3,3]
    t: jnp.ndarray     # [S,3]
    info: jnp.ndarray  # [S] scalar information weight (0 = factor absent)

    @staticmethod
    def empty(s: int):
        return RelPoseFactors(
            rot=jnp.broadcast_to(jnp.eye(3), (s, 3, 3)),
            t=jnp.zeros((s, 3)), info=jnp.zeros((s,)))


class VIBAProblem(NamedTuple):
    vis: BAProblem              # poses Tcw + landmark/observation grid
    kf_vel: jnp.ndarray         # [K,3]
    kf_bias: jnp.ndarray        # [K,6]
    segs: ImuSegments           # K-1 temporal segments
    r_cb: jnp.ndarray           # [3,3] cam-from-body rotation
    t_cb: jnp.ndarray           # [3]
    walk_info: jnp.ndarray      # [6,6] bias random-walk information
    icp: Optional[RelPoseFactors] = None   # EdgeICP inter-KF factors


def _body_from_cam(rot_cw, t_cw, r_cb, t_cb):
    """T_wb = (T_cb^-1 ∘ T_cw)^-1 = T_wc ∘ T_cb."""
    r_wc = jnp.swapaxes(rot_cw, -1, -2)
    t_wc = -jnp.einsum("...ij,...j->...i", r_wc, t_cw)
    r_wb = r_wc @ r_cb
    p_wb = jnp.einsum("...ij,j->...i", r_wc, t_cb) + t_wc
    return r_wb, p_wb


def _inertial_residual_seg(r1, p1, v1, b1, r2, p2, v2, seg_idx, segs: ImuSegments,
                           gravity=pre.GRAVITY):
    """EdgeInertial 9-residual for one segment with bias correction."""
    dbg = b1[:3] - segs.bias0[seg_idx, :3]
    dba = b1[3:] - segs.bias0[seg_idx, 3:]
    dR = segs.dR[seg_idx] @ lie.so3_exp(segs.JRg[seg_idx] @ dbg)
    dV = segs.dV[seg_idx] + segs.JVg[seg_idx] @ dbg + segs.JVa[seg_idx] @ dba
    dP = segs.dP[seg_idx] + segs.JPg[seg_idx] @ dbg + segs.JPa[seg_idx] @ dba
    dt = segs.dt[seg_idx]
    er = lie.so3_log(dR.T @ r1.T @ r2)
    ev = r1.T @ (v2 - v1 - gravity * dt) - dV
    ep = r1.T @ (p2 - p1 - v1 * dt - 0.5 * gravity * dt * dt) - dP
    return jnp.concatenate([er, ev, ep])


def _apply_state_tangent(rot_cw, t_cw, vel, bias, d, r_cb, t_cb):
    """15-dim update in BODY coordinates mapped back to the Tcw storage."""
    r_wb, p_wb = _body_from_cam(rot_cw, t_cw, r_cb, t_cb)
    r_wb = r_wb @ lie.so3_exp(d[0:3])
    p_wb = p_wb + r_wb @ d[3:6]
    vel = vel + d[6:9]
    bias = bias + d[9:15]
    # back to Tcw: T_cw = T_cb ∘ T_bw
    r_bw = r_wb.T
    t_bw = -r_bw @ p_wb
    rot_cw2 = r_cb @ r_bw
    t_cw2 = r_cb @ t_bw + t_cb
    return rot_cw2, t_cw2, vel, bias


def vi_local_ba(prob: VIBAProblem, fx, fy, cx, cy, bf=0.0,
                iters1: int = 4, iters2: int = 6, damping: float = 1e-5):
    """Joint GN over [K,15] states + landmarks, Schur-eliminated.

    Returns (VIBAProblem with optimized states/points, obs inlier mask)."""
    vis = prob.vis
    k = vis.kf_rot.shape[0]
    active = vis.obs_valid & vis.pt_valid[None, :] & vis.kf_valid[:, None]

    def gn_step(state, active, use_huber):
        vis, vel, bias = state
        r, jp_cam, jl, behind = _residuals(vis, fx, fy, cx, cy, bf)
        chi2 = _chi2(r, vis)
        delta = jnp.where(vis.is_stereo, HUBER_STEREO, HUBER_MONO)
        w = _huber_w(chi2, delta) if use_huber else jnp.ones_like(chi2)
        w = w * vis.inv_sigma2 * (active & ~behind).astype(r.dtype)
        rm = jnp.stack([jnp.ones_like(w), jnp.ones_like(w),
                        vis.is_stereo.astype(w.dtype)], axis=-1)
        wr = w[..., None] * rm

        # map the camera-pose Jacobian [.,3,6] (left-mult on Tcw) to the
        # body tangent: delta_cam = Ad * delta_body_pose. For T_cw = exp(dc) T_cw0
        # with body update r_wb exp(dphi), p += r_wb dp:
        # jacobian via jacfwd of the 6-dof cam tangent wrt 6-dof body tangent
        def cam_delta_of_body(d6, rot_cw, t_cw):
            r2, t2, _, _ = _apply_state_tangent(
                rot_cw, t_cw, jnp.zeros(3), jnp.zeros(6),
                jnp.concatenate([d6, jnp.zeros(9)]),
                prob.r_cb, prob.t_cb)
            # left-mult cam tangent: log(T2 ∘ T0^-1)
            ri, ti = lie.se3_inverse(rot_cw, t_cw)
            rr, tt = lie.se3_compose(r2, t2, ri, ti)
            return lie.se3_log(rr, tt)

        # note ordering: body tangent = [phi(3), rho(3)]; cam = [rho, phi]
        ad = jax.vmap(lambda R, t: jax.jacfwd(
            lambda d6: cam_delta_of_body(d6, R, t))(jnp.zeros(6)))(
                vis.kf_rot, vis.kf_t)                      # [K,6,6]
        jp = jnp.einsum("kmri,kij->kmrj", jp_cam, ad)      # [K,M,3,6] body

        hpp6 = jnp.einsum("kmri,kmr,kmrj->kij", jp, wr, jp)
        hll = jnp.einsum("kmri,kmr,kmrj->mij", jl, wr, jl)
        hpl = jnp.einsum("kmri,kmr,kmrj->kmij", jp, wr, jl)
        bp6 = -jnp.einsum("kmri,kmr->ki", jp, wr * r)
        bl = -jnp.einsum("kmri,kmr->mi", jl, wr * r)

        # trace-relative damping: landmark blocks span many orders of
        # magnitude and near-singular ones NaN in a plain f32 inv
        tr = jnp.trace(hll, axis1=-2, axis2=-1)[:, None, None]
        hll = hll + (1e-3 * tr / 3.0 + damping) * jnp.eye(3)
        hll_inv = jnp.linalg.inv(hll)
        pt_active = (jnp.sum(w, axis=0) > 0) & vis.pt_valid
        hll_inv = hll_inv * pt_active[:, None, None]

        s6 = -jnp.einsum("kmij,mjl,qmrl->kiqr", hpl, hll_inv, hpl)
        s6 = s6.at[jnp.arange(k), :, jnp.arange(k), :].add(hpp6)
        rhs6 = bp6 - jnp.einsum("kmij,mjl,ml->ki", hpl, hll_inv, bl)

        # expand to the 15-dof state system
        d = 15
        s = jnp.zeros((k, d, k, d))
        s = s.at[:, :6, :, :6].set(s6)
        rhs = jnp.zeros((k, d)).at[:, :6].set(rhs6)

        # inertial edges between consecutive KFs
        r_wb, p_wb = _body_from_cam(vis.kf_rot, vis.kf_t, prob.r_cb, prob.t_cb)

        def seg_residual(d1, d2, i):
            r1, p1, v1, b1 = _apply_state_tangent(
                vis.kf_rot[i], vis.kf_t[i], vel[i], bias[i], d1,
                prob.r_cb, prob.t_cb)
            rb1, pb1 = _body_from_cam(r1, p1, prob.r_cb, prob.t_cb)
            r2c, p2c, v2, b2 = _apply_state_tangent(
                vis.kf_rot[i + 1], vis.kf_t[i + 1], vel[i + 1], bias[i + 1],
                d2, prob.r_cb, prob.t_cb)
            rb2, pb2 = _body_from_cam(r2c, p2c, prob.r_cb, prob.t_cb)
            e_in = _inertial_residual_seg(rb1, pb1, v1, b1, rb2, pb2, v2, i,
                                          prob.segs)
            e_bw = b2 - b1
            if prob.icp is not None:
                # EdgeICP: e = log(T_meas^-1 ∘ T2 ∘ T1^-1) in camera frames
                ri, ti = lie.se3_inverse(r1, p1)
                rr, tr = lie.se3_compose(r2c, p2c, ri, ti)
                mi, mt = lie.se3_inverse(prob.icp.rot[i], prob.icp.t[i])
                er, et = lie.se3_compose(mi, mt, rr, tr)
                e_icp = lie.se3_log(er, et)
            else:
                e_icp = jnp.zeros(6)
            return e_in, e_bw, e_icp

        z15 = jnp.zeros(15)
        segs_idx = jnp.arange(k - 1)

        def one_seg(i):
            e_in, e_bw, e_icp = seg_residual(z15, z15, i)
            j1 = jax.jacfwd(lambda d1: seg_residual(d1, z15, i))(z15)
            j2 = jax.jacfwd(lambda d2: seg_residual(z15, d2, i))(z15)
            return (e_in, e_bw, e_icp, j1[0], j2[0], j1[1], j2[1],
                    j1[2], j2[2])

        (e_in, e_bw, e_icp, j1i, j2i, j1b, j2b,
         j1c, j2c) = jax.vmap(one_seg)(segs_idx)
        wseg = prob.segs.valid.astype(jnp.float32)

        info9 = prob.segs.info9 * wseg[:, None, None]
        winfo = prob.segs.walk_info * wseg[:, None, None]
        icp_w = (prob.icp.info * wseg)[:, None, None] * jnp.eye(6)[None] \
            if prob.icp is not None else jnp.zeros((k - 1, 6, 6))

        # accumulate into s/rhs
        h11 = jnp.einsum("sri,srl,slj->sij", j1i, info9, j1i) \
            + jnp.einsum("sri,srl,slj->sij", j1b, winfo, j1b) \
            + jnp.einsum("sri,srl,slj->sij", j1c, icp_w, j1c)
        h22 = jnp.einsum("sri,srl,slj->sij", j2i, info9, j2i) \
            + jnp.einsum("sri,srl,slj->sij", j2b, winfo, j2b) \
            + jnp.einsum("sri,srl,slj->sij", j2c, icp_w, j2c)
        h12 = jnp.einsum("sri,srl,slj->sij", j1i, info9, j2i) \
            + jnp.einsum("sri,srl,slj->sij", j1b, winfo, j2b) \
            + jnp.einsum("sri,srl,slj->sij", j1c, icp_w, j2c)
        g1 = -(jnp.einsum("sri,srl,sl->si", j1i, info9, e_in)
               + jnp.einsum("sri,srl,sl->si", j1b, winfo, e_bw)
               + jnp.einsum("sri,srl,sl->si", j1c, icp_w, e_icp))
        g2 = -(jnp.einsum("sri,srl,sl->si", j2i, info9, e_in)
               + jnp.einsum("sri,srl,sl->si", j2b, winfo, e_bw)
               + jnp.einsum("sri,srl,sl->si", j2c, icp_w, e_icp))

        ii = segs_idx
        s = s.at[ii, :, ii, :].add(h11)
        s = s.at[ii + 1, :, ii + 1, :].add(h22)
        s = s.at[ii, :, ii + 1, :].add(h12)
        s = s.at[ii + 1, :, ii, :].add(jnp.swapaxes(h12, -1, -2))
        rhs = rhs.at[ii].add(g1)
        rhs = rhs.at[ii + 1].add(g2)

        # fix masked KFs
        free = (vis.kf_valid & ~vis.kf_fixed).astype(jnp.float32)
        fm = free[:, None]
        s = s * fm[:, :, None, None] * free[None, None, :, None]
        sd = s.reshape(k * d, k * d)
        diag_fix = (1.0 - (fm * jnp.ones((k, d)))).reshape(-1)
        sd = sd + jnp.diag(diag_fix + 1e-3 * jnp.diag(sd)) \
            + damping * jnp.eye(k * d)
        rhsf = (rhs * fm).reshape(-1)
        # Jacobi preconditioning: the blocks span ~1e2 (reproj) to ~1e8+
        # (IMU/bias information) — unscaled f32 Cholesky loses the small
        # blocks entirely (dx underflows to 0)
        dj = 1.0 / jnp.sqrt(jnp.maximum(jnp.diag(sd), 1e-12))
        sd_n = sd * dj[:, None] * dj[None, :]
        dx = dj * jnp.linalg.solve(sd_n, dj * rhsf)
        dx = dx.reshape(k, d) * fm
        dx = jnp.where(jnp.all(jnp.isfinite(dx)), dx, jnp.zeros_like(dx))
        # trust region: GN with near-rigid IMU information overshoots badly
        # from far-off linearization points (e.g. right after a coarse
        # monocular scale init); clamp per-block step norms
        def clamp(seg, cap):
            n = jnp.linalg.norm(seg, axis=-1, keepdims=True)
            return seg * jnp.minimum(1.0, cap / jnp.maximum(n, 1e-9))
        dx = jnp.concatenate([
            clamp(dx[:, 0:3], 0.2),    # rotation [rad]
            clamp(dx[:, 3:6], 0.5),    # position [m]
            clamp(dx[:, 6:9], 1.0),    # velocity [m/s]
            clamp(dx[:, 9:15], 0.05),  # bias
        ], axis=1)

        # landmark back-substitution (uses the 6-dof cam part of dx)
        dx6 = dx[:, :6]
        dl = jnp.einsum("mij,mj->mi", hll_inv,
                        bl - jnp.einsum("kmij,ki->mj", hpl, dx6))
        dl = jnp.where(jnp.all(jnp.isfinite(dl)), dl, jnp.zeros_like(dl))

        new_rot, new_t, new_vel, new_bias = jax.vmap(
            lambda R, t, v, b, dd: _apply_state_tangent(
                R, t, v, b, dd, prob.r_cb, prob.t_cb))(
                vis.kf_rot, vis.kf_t, vel, bias, dx)
        new_rot = lie.normalize_rotation(new_rot)
        vis2 = vis._replace(kf_rot=new_rot, kf_t=new_t,
                            pts=vis.pts + dl * pt_active[:, None])
        return (vis2, new_vel, new_bias)

    state = (vis, prob.kf_vel, prob.kf_bias)
    for _ in range(iters1):
        state = gn_step(state, active, True)
    vis2, vel2, bias2 = state
    r, _, _, behind = _residuals(vis2, fx, fy, cx, cy, bf)
    chi2 = _chi2(r, vis2)
    th = jnp.where(vis2.is_stereo, CHI2_STEREO, CHI2_MONO)
    active = active & (chi2 <= th) & (~behind)
    state = (vis2, vel2, bias2)
    for _ in range(iters2):
        state = gn_step(state, active, True)
    vis2, vel2, bias2 = state
    r, _, _, behind = _residuals(vis2, fx, fy, cx, cy, bf)
    chi2 = _chi2(r, vis2)
    inliers = vis2.obs_valid & (chi2 <= th) & (~behind)
    return prob._replace(vis=vis2, kf_vel=vel2, kf_bias=bias2), inliers