"""Local bundle adjustment: batched Gauss-Newton with Schur complement.

JAX replacement for the g2o local BA family in
/root/reference/src/Optimizer.cc — LocalBundleAdjustment (:1588),
BundleAdjustment/GlobalBundleAdjustemnt (:47-365) — built from dense batched matmuls:

* The observation structure is a dense [K, M] grid (KF x map point) with a
  validity mask instead of g2o's edge lists; residuals/Jacobians for every
  observation are produced by one fused einsum pass.
* Landmarks are eliminated by the Schur complement: Hll is [M, 3, 3]
  block-diagonal (batched 3x3 inverse), the reduced camera system
  S = Hpp - Hpl Hll^-1 Hpl^T is a dense [6K, 6K] matrix assembled with a
  single einsum over M (the K is small: the reference's local window is
  ~10-30 KFs), then solved with Cholesky.
* Fixed keyframes (the reference's lFixedCameras) participate in residuals
  but their state rows are masked out of the solve.
* Robust Huber weights as IRLS; the reference's two-stage schedule
  (5 iters -> drop outliers -> 10 iters, Optimizer.cc:1990-2010) is
  reproduced with chi-square re-gating between stages.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from geoflowslam.math import lie
from geoflowslam.solvers.pose_opt import (
    CHI2_MONO, CHI2_STEREO, HUBER_MONO, HUBER_STEREO, _huber_w,
)


class BAProblem(NamedTuple):
    """Dense local-BA problem. K keyframes x M landmarks (padded)."""
    kf_rot: jnp.ndarray      # [K,3,3] Tcw rotation per KF
    kf_t: jnp.ndarray        # [K,3]
    kf_fixed: jnp.ndarray    # [K] bool — contribute obs, not optimized
    kf_valid: jnp.ndarray    # [K] bool
    pts: jnp.ndarray         # [M,3] world
    pt_valid: jnp.ndarray    # [M] bool
    uv: jnp.ndarray          # [K,M,2]
    u_right: jnp.ndarray     # [K,M]
    is_stereo: jnp.ndarray   # [K,M] bool
    inv_sigma2: jnp.ndarray  # [K,M]
    obs_valid: jnp.ndarray   # [K,M] bool


def _residuals(prob: BAProblem, fx, fy, cx, cy, bf):
    """r [K,M,3], jac_pose [K,M,3,6], jac_pt [K,M,3,3], behind [K,M]."""
    pc = jnp.einsum("kij,mj->kmi", prob.kf_rot, prob.pts) + prob.kf_t[:, None, :]
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    z_safe = jnp.where(jnp.abs(z) < 1e-6, 1e-6, z)
    inv_z = 1.0 / z_safe
    inv_z2 = inv_z * inv_z

    u = fx * x * inv_z + cx
    v = fy * y * inv_z + cy
    ur = u - bf * inv_z
    r = jnp.stack([
        prob.uv[..., 0] - u,
        prob.uv[..., 1] - v,
        jnp.where(prob.is_stereo, prob.u_right - ur, 0.0),
    ], axis=-1)

    zero = jnp.zeros_like(x)
    du = jnp.stack([fx * inv_z, zero, -fx * x * inv_z2], axis=-1)
    dv = jnp.stack([zero, fy * inv_z, -fy * y * inv_z2], axis=-1)
    dur = du + jnp.stack([zero, zero, bf * inv_z2], axis=-1)
    d_proj = jnp.stack([du, dv, dur], axis=-2)                        # [K,M,3,3]

    eye = jnp.broadcast_to(jnp.eye(3, dtype=pc.dtype), pc.shape[:-1] + (3, 3))
    d_pc_pose = jnp.concatenate([eye, -lie.hat(pc)], axis=-1)         # [K,M,3,6]
    jac_pose = -jnp.einsum("kmij,kmjl->kmil", d_proj, d_pc_pose)
    # d(pc)/d(pt_w) = R_k
    jac_pt = -jnp.einsum("kmij,kjl->kmil", d_proj, prob.kf_rot)
    return r, jac_pose, jac_pt, (z <= 0)


def _chi2(r, prob: BAProblem):
    r2 = r[..., 0] ** 2 + r[..., 1] ** 2 + jnp.where(prob.is_stereo, r[..., 2] ** 2, 0.0)
    return r2 * prob.inv_sigma2


def _gn_step(prob: BAProblem, active, fx, fy, cx, cy, bf, use_huber,
             damping=1e-6):
    r, jp, jl, behind = _residuals(prob, fx, fy, cx, cy, bf)
    chi2 = _chi2(r, prob)
    delta = jnp.where(prob.is_stereo, HUBER_STEREO, HUBER_MONO)
    w = _huber_w(chi2, delta) if use_huber else jnp.ones_like(chi2)
    w = w * prob.inv_sigma2 * (active & ~behind).astype(r.dtype)
    row_mask = jnp.stack([jnp.ones_like(w), jnp.ones_like(w),
                          prob.is_stereo.astype(w.dtype)], axis=-1)
    wr = w[..., None] * row_mask                                       # [K,M,3]

    k, m = w.shape
    hpp = jnp.einsum("kmri,kmr,kmrj->kij", jp, wr, jp)                 # [K,6,6]
    hll = jnp.einsum("kmri,kmr,kmrj->mij", jl, wr, jl)                 # [M,3,3]
    hpl = jnp.einsum("kmri,kmr,kmrj->kmij", jp, wr, jl)                # [K,M,6,3]
    bp = -jnp.einsum("kmri,kmr->ki", jp, wr * r)                       # [K,6]
    bl = -jnp.einsum("kmri,kmr->mi", jl, wr * r)                       # [M,3]

    # Landmark elimination (trace-relative damping: absolute damping is
    # negligible against large blocks and near-singular ones NaN in f32 inv)
    tr = jnp.trace(hll, axis1=-2, axis2=-1)[:, None, None]
    hll = hll + (1e-3 * tr / 3.0 + damping) * jnp.eye(3, dtype=hll.dtype)
    hll_inv = jnp.linalg.inv(hll)                                      # [M,3,3]
    # point inactive if no valid obs at all -> its update must be zero
    pt_active = (jnp.sum(w, axis=0) > 0) & prob.pt_valid
    hll_inv = hll_inv * pt_active[:, None, None]

    s = jnp.einsum("kmij,mjl,qmrl->kiqr", hpl, hll_inv, hpl)           # [K,6,K,6]
    s = -s
    s = s.at[jnp.arange(k), :, jnp.arange(k), :].add(hpp)
    rhs = bp - jnp.einsum("kmij,mjl,ml->ki", hpl, hll_inv, bl)

    # Mask fixed / invalid KFs out of the solve.
    free = (prob.kf_valid & ~prob.kf_fixed).astype(s.dtype)            # [K]
    fm = free[:, None]                                                 # [K,1]
    s = s * fm[:, :, None, None] * free[None, None, :, None]
    sd = s.reshape(k * 6, k * 6)
    diag_fix = (1.0 - (fm * jnp.ones((k, 6), s.dtype))).reshape(-1)
    # Levenberg-style multiplicative damping: regularizes the near-null gauge
    # directions (e.g. monocular global scale) that absolute damping misses.
    sd = sd + jnp.diag(diag_fix + 1e-3 * jnp.diag(sd)) \
        + damping * jnp.eye(k * 6, dtype=s.dtype)
    rhs = (rhs * fm).reshape(-1)

    dp = jnp.linalg.solve(sd, rhs).reshape(k, 6)
    dp = dp * fm
    dp = jnp.where(jnp.all(jnp.isfinite(dp)), dp, jnp.zeros_like(dp))

    dl = jnp.einsum("mij,mj->mi", hll_inv,
                    bl - jnp.einsum("kmij,ki->mj", hpl, dp))
    dl = jnp.where(jnp.all(jnp.isfinite(dl)), dl, jnp.zeros_like(dl))

    dr_rot, dr_t = lie.se3_exp(dp)
    new_rot = jnp.einsum("kij,kjl->kil", dr_rot, prob.kf_rot)
    new_rot = lie.normalize_rotation(new_rot)
    new_t = jnp.einsum("kij,kj->ki", dr_rot, prob.kf_t) + dr_t
    new_pts = prob.pts + dl * pt_active[:, None]
    return prob._replace(kf_rot=new_rot, kf_t=new_t, pts=new_pts)


def local_bundle_adjustment(prob: BAProblem, fx, fy, cx, cy, bf=0.0,
                            iters1: int = 5, iters2: int = 10):
    """Two-stage local BA with outlier re-gating (reference schedule).

    Returns (problem, obs_inlier_mask [K,M])."""
    active = prob.obs_valid & prob.pt_valid[None, :] & prob.kf_valid[:, None]

    def stage(prob, active, n_iter, use_huber):
        def body(_, p):
            return _gn_step(p, active, fx, fy, cx, cy, bf, use_huber)
        return jax.lax.fori_loop(0, n_iter, body, prob)

    prob = stage(prob, active, iters1, True)
    r, _, _, behind = _residuals(prob, fx, fy, cx, cy, bf)
    chi2 = _chi2(r, prob)
    th = jnp.where(prob.is_stereo, CHI2_STEREO, CHI2_MONO)
    active = active & (chi2 <= th) & (~behind)

    # second stage without the robust kernel: the reference removes Huber
    # after outlier pruning (Optimizer.cc LocalBundleAdjustment, e->setRobustKernel(0))
    prob = stage(prob, active, iters2, False)
    r, _, _, behind = _residuals(prob, fx, fy, cx, cy, bf)
    chi2 = _chi2(r, prob)
    inliers = prob.obs_valid & (chi2 <= th) & (~behind)
    return prob, inliers
