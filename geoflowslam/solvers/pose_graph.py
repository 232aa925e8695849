"""Pose-graph optimization over Sim3/SE3: essential graph + 4DoF variants.

JAX replacement for Optimizer::OptimizeEssentialGraph (Sim3,
/root/reference/src/Optimizer.cc:2042/2415), OptimizeEssentialGraph4DoF
(:9252) and OptimizeSim3 (:2797).

The reference builds a sparse g2o graph over thousands of KFs; our padded
graph is K_MAX <= a few hundred KFs, so the dense GN over the stacked
tangent (7K or 4K params) is a single small Cholesky per iteration — the
whole optimization is one jit region, edges evaluated by one vmap.

Edge list representation: (i [E], j [E], s_ij, R_ij, t_ij, valid [E]) with
measurement S_ij = S_i S_j^-1 (g2o convention), residual
e = log(S_ij * S_j * S_i^-1) in sim3 tangent [rho, phi, sigma].
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from geoflowslam.math import lie


class PoseGraphEdges(NamedTuple):
    i: jnp.ndarray       # [E] int32
    j: jnp.ndarray       # [E] int32
    s: jnp.ndarray       # [E] measured relative scale
    rot: jnp.ndarray     # [E,3,3] measured relative rotation
    t: jnp.ndarray       # [E,3]
    weight: jnp.ndarray  # [E] info weight (covisibility count / loop boost)
    valid: jnp.ndarray   # [E] bool


def _sim3_log(s, rot, t):
    """Inverse of lie.sim3_exp (first-order-exact via inverse W matrix is
    overkill here; use log of rotation + scale, and solve W rho = t)."""
    sigma = jnp.log(s)
    phi = lie.so3_log(rot)
    # W from sim3_exp at (phi, sigma); solve for rho.
    xi_probe = jnp.concatenate([jnp.zeros(3), phi, sigma[None]])

    def t_of_rho(rho):
        _, _, tt = lie.sim3_exp(jnp.concatenate([rho, phi, sigma[None]]))
        return tt

    w_mat = jax.jacfwd(t_of_rho)(jnp.zeros(3))
    rho = jnp.linalg.solve(w_mat + 1e-9 * jnp.eye(3), t)
    return jnp.concatenate([rho, phi, sigma[None]])


def edge_residual(xi_all, i, j, s_m, rot_m, t_m,
                  base_s, base_rot, base_t, fix_scale: bool):
    """Residual of one edge given tangent updates xi_all [K,7] applied left-
    multiplicatively to base poses: S_k = exp(xi_k) * S_k0."""
    def pose_of(k):
        xi = xi_all[k]
        xi = jnp.where(fix_scale, xi.at[6].set(0.0), xi)
        ds, dr, dt = lie.sim3_exp(xi)
        return lie.sim3_compose(ds, dr, dt, base_s[k], base_rot[k], base_t[k])

    si, ri, ti = pose_of(i)
    sj, rj, tj = pose_of(j)
    sji, rji, tji = lie.sim3_inverse(sj, rj, tj)
    # S_err = S_ij_meas * S_j * S_i^-1
    s1, r1, t1 = lie.sim3_compose(s_m, rot_m, t_m, si, ri, ti)
    sii, rii, tii = lie.sim3_inverse(s1, r1, t1)
    se, re, te = lie.sim3_compose(sj, rj, tj, sii, rii, tii)
    return _sim3_log(se, re, te)


def optimize_pose_graph(base_s, base_rot, base_t, kf_valid, kf_fixed,
                        edges: PoseGraphEdges, fix_scale: bool = True,
                        iters: int = 15, yaw_only: bool = False):
    """Dense GN over the whole graph. Returns updated (s, rot, t) per KF.

    kf_fixed: poses held constant (the loop KF in CorrectLoop).
    fix_scale: True for stereo/RGBD (scale is observable) — Sim3 reduces to
    SE3 exactly as the reference's bFixScale flag does.
    yaw_only: restrict rotation updates to the gravity (yaw) axis — the
    reference's OptimizeEssentialGraph4DoF used for inertial maps where
    roll/pitch are observable from gravity (Optimizer.cc:9252).
    """
    k = base_s.shape[0]

    def residuals(xi_flat):
        xi_all = xi_flat.reshape(k, 7)

        def one(e_i, e_j, e_s, e_rot, e_t):
            return edge_residual(xi_all, e_i, e_j, e_s, e_rot, e_t,
                                 base_s, base_rot, base_t, fix_scale)

        return jax.vmap(one)(edges.i, edges.j, edges.s, edges.rot, edges.t)

    w = edges.weight * edges.valid.astype(base_s.dtype)
    free = (kf_valid & ~kf_fixed).astype(base_s.dtype)
    free_mask = jnp.repeat(free, 7)
    if fix_scale:
        scale_mask = jnp.tile(jnp.arange(7) != 6, (k,))
        free_mask = free_mask * scale_mask
    if yaw_only:
        # tangent = [rho(3), phi(3), sigma]: keep phi_z (world yaw; gravity
        # is -z after IMU alignment), freeze phi_x/phi_y
        rp_mask = jnp.tile((jnp.arange(7) != 3) & (jnp.arange(7) != 4), (k,))
        free_mask = free_mask * rp_mask

    def body(_, xi_flat):
        r = residuals(xi_flat)                         # [E,7]
        jac = jax.jacfwd(residuals)(xi_flat)           # [E,7,7K]
        h = jnp.einsum("e,eri,erj->ij", w, jac, jac)
        g = -jnp.einsum("e,eri,er->i", w, jac, r)
        h = h * free_mask[:, None] * free_mask[None, :]
        h = h + jnp.diag(1.0 - free_mask) + 1e-6 * jnp.eye(7 * k)
        g = g * free_mask
        dx = jnp.linalg.solve(h, g)
        dx = jnp.where(jnp.all(jnp.isfinite(dx)), dx, 0.0)
        return xi_flat + dx

    xi = jax.lax.fori_loop(0, iters, body, jnp.zeros(7 * k))
    xi_all = xi.reshape(k, 7)
    if fix_scale:
        xi_all = xi_all.at[:, 6].set(0.0)

    ds, dr, dt = jax.vmap(lie.sim3_exp)(xi_all)
    s_out, r_out, t_out = jax.vmap(lie.sim3_compose)(ds, dr, dt,
                                                     base_s, base_rot, base_t)
    r_out = lie.normalize_rotation(r_out)
    return s_out, r_out, t_out


def optimize_sim3_pair(s0, rot0, t0, pts1, pts2, valid,
                       iters: int = 10, fix_scale: bool = False,
                       huber: float = 0.1):
    """Refine a Sim3 aligning pts1 -> pts2 (OptimizeSim3 essence on 3D-3D
    terms; the reference uses two-way reprojection, equivalent at small
    residuals for calibrated RGBD). Returns (s, rot, t, inliers)."""
    def params_res(xi):
        ds, dr, dt = lie.sim3_exp(jnp.where(fix_scale, xi.at[6].set(0.0), xi))
        s, r, t = lie.sim3_compose(ds, dr, dt, s0, rot0, t0)
        pred = s * pts1 @ r.T + t
        return (pred - pts2).reshape(-1)

    w_pt = valid.astype(pts1.dtype)

    def body(_, xi):
        r = params_res(xi).reshape(-1, 3)
        nrm = jnp.linalg.norm(r, axis=1)
        wh = jnp.where(nrm <= huber, 1.0, huber / jnp.maximum(nrm, 1e-9)) * w_pt
        jac = jax.jacfwd(params_res)(xi).reshape(-1, 3, 7)
        h = jnp.einsum("p,pri,prj->ij", wh, jac, jac) + 1e-6 * jnp.eye(7)
        g = -jnp.einsum("p,pri,pr->i", wh, jac, r)
        dx = jnp.linalg.solve(h, g)
        return xi + jnp.where(jnp.all(jnp.isfinite(dx)), dx, 0.0)

    xi = jax.lax.fori_loop(0, iters, body, jnp.zeros(7))
    ds, dr, dt = lie.sim3_exp(jnp.where(fix_scale, xi.at[6].set(0.0), xi))
    s, r, t = lie.sim3_compose(ds, dr, dt, s0, rot0, t0)
    pred = s * pts1 @ r.T + t
    err = jnp.linalg.norm(pred - pts2, axis=1)
    inl = valid & (err < huber)
    return s, lie.normalize_rotation(r), t, inl
