"""GICP and NDT point-cloud registration as fixed-iteration Gauss-Newton.

JAX replacement for RegistrationGICP
(/root/reference/src/RegistrationGICP.cc): small_gicp's align() (GICP type,
0.1 m max correspondence) and pcl::NormalDistributionsTransform (0.05 m
resolution NDT, 35 iters). Used as the tracking pose predictor
(Tracking::PredictStateICP/:PredictStateNDT, src/Tracking.cc:3365-3465) and
to generate EdgeICP factors inside local BA (src/Optimizer.cc:3260-3321).

Instead of KdTree + per-iteration reallocation, correspondences come from a
brute-force matmul distance matrix over downsampled padded clouds (P <= 4096),
and the optimizer is a fixed-count GN on SE(3) with masked correspondences —
the whole registration is one jit-compiled function.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from geoflowslam.math import lie
from geoflowslam.ops import pointcloud as pc


class RegistrationResult(NamedTuple):
    rot: jnp.ndarray        # [3,3] target<-source
    t: jnp.ndarray          # [3]
    n_inliers: jnp.ndarray  # [] int32 (matched correspondences, last iter)
    error: jnp.ndarray      # [] mean residual norm over inliers
    converged: jnp.ndarray  # [] bool


def _inv_sym3(m: jnp.ndarray, eps: float = 1e-12) -> jnp.ndarray:
    """Closed-form inverse of a batch of symmetric 3x3 matrices [P,3,3]
    (adjugate / det): pure elementwise arithmetic that fuses, where
    jnp.linalg.inv would run a batched LU solve."""
    a, b, c = m[:, 0, 0], m[:, 0, 1], m[:, 0, 2]
    d, e = m[:, 1, 1], m[:, 1, 2]
    f = m[:, 2, 2]
    co00 = d * f - e * e
    co01 = c * e - b * f
    co02 = b * e - c * d
    co11 = a * f - c * c
    co12 = b * c - a * e
    co22 = a * d - b * b
    det = a * co00 + b * co01 + c * co02
    inv_det = 1.0 / jnp.where(jnp.abs(det) < eps, eps, det)
    rows = jnp.stack([
        jnp.stack([co00, co01, co02], axis=1),
        jnp.stack([co01, co11, co12], axis=1),
        jnp.stack([co02, co12, co22], axis=1),
    ], axis=1)
    return rows * inv_det[:, None, None]


def gicp_register(src: jnp.ndarray, src_valid: jnp.ndarray,
                  tgt: jnp.ndarray, tgt_valid: jnp.ndarray,
                  init_rot=None, init_t=None,
                  max_corr_dist: float = 0.1, iters: int = 10,
                  k_cov: int = 10) -> RegistrationResult:
    """Generalized ICP (plane-to-plane): covariance-weighted GN.

    src/tgt: [P,3] padded clouds (already voxel-downsampled).
    Returns T such that tgt ~= R @ src + t.
    """
    dtype = src.dtype
    rot = jnp.eye(3, dtype=dtype) if init_rot is None else init_rot
    t = jnp.zeros(3, dtype=dtype) if init_t is None else init_t

    cov_s, _ = pc.estimate_covariances(src, src_valid, k_cov)
    cov_t, _ = pc.estimate_covariances(tgt, tgt_valid, k_cov)

    def step(carry, _):
        rot, t = carry
        ps = src @ rot.T + t                            # transformed source
        idx, d2, ok = pc.knn_indices(ps, src_valid, tgt, tgt_valid, 1)
        nn = idx[:, 0]
        matched = ok[:, 0] & (d2[:, 0] < max_corr_dist * max_corr_dist)

        q = tgt[nn]                                     # [P,3]
        r = ps - q                                      # residual
        # GICP information: W = (C_t + R C_s R^T)^-1
        rcs = jnp.einsum("ij,pjk,lk->pil", rot, cov_s, rot)
        w_inv = cov_t[nn] + rcs + 1e-6 * jnp.eye(3, dtype=dtype)
        w = _inv_sym3(w_inv) * matched[:, None, None].astype(dtype)

        # d(r)/d(xi), left-mult update on (R, t): [I | -hat(ps)]
        eye = jnp.broadcast_to(jnp.eye(3, dtype=dtype), (src.shape[0], 3, 3))
        jac = jnp.concatenate([eye, -lie.hat(ps)], axis=2)   # [P,3,6]

        h = jnp.einsum("pij,pik,pkl->jl", jac, w, jac)
        g = -jnp.einsum("pij,pik,pk->j", jac, w, r)
        h = h + 1e-6 * jnp.eye(6, dtype=dtype)
        dx = jnp.linalg.solve(h, g)
        dx = jnp.where(jnp.all(jnp.isfinite(dx)), dx, 0.0)
        dr, dt = lie.se3_exp(dx)
        rot2 = lie.normalize_rotation(dr @ rot)
        t2 = dr @ t + dt
        stats = (jnp.sum(matched), jnp.sum(jnp.linalg.norm(r, axis=1) * matched)
                 / jnp.maximum(jnp.sum(matched), 1), jnp.linalg.norm(dx))
        return (rot2, t2), stats

    (rot, t), stats = jax.lax.scan(step, (rot, t), None, length=iters)
    n_inl, err, dx_norm = stats[0][-1], stats[1][-1], stats[2][-1]
    return RegistrationResult(rot=rot, t=t, n_inliers=n_inl.astype(jnp.int32),
                              error=err, converged=dx_norm < 1e-3)


# ---------------------------------------------------------------------------
# NDT (voxelized normal distributions), PCL-style
# ---------------------------------------------------------------------------

def build_ndt_grid(tgt: jnp.ndarray, tgt_valid: jnp.ndarray, resolution: float,
                   max_voxels: int = 2048):
    """Voxel means + covariances of the target cloud. Returns padded
    (centers [V,3], covs_inv [V,3,3], valid [V])."""
    key = pc._voxel_keys(tgt, tgt_valid, resolution)
    order = jnp.argsort(key)
    ks = key[order]
    pts_s = tgt[order]
    first = jnp.concatenate([jnp.ones((1,), bool), ks[1:] != ks[:-1]])
    seg = jnp.cumsum(first.astype(jnp.int32)) - 1          # segment id per point
    valid_pt = ks != pc.INVALID_KEY
    w = valid_pt.astype(tgt.dtype)
    n_seg = max_voxels
    seg_c = jnp.clip(seg, 0, n_seg - 1)
    cnt = jnp.zeros((n_seg,), tgt.dtype).at[seg_c].add(w)
    mean = jnp.zeros((n_seg, 3), tgt.dtype).at[seg_c].add(pts_s * w[:, None])
    mean = mean / jnp.maximum(cnt[:, None], 1.0)
    d = pts_s - mean[seg_c]
    cov = jnp.zeros((n_seg, 3, 3), tgt.dtype).at[seg_c].add(
        jnp.einsum("p,pi,pj->pij", w, d, d))
    cov = cov / jnp.maximum(cnt[:, None, None], 1.0)
    vvalid = cnt >= 5.0                                     # PCL min 5 pts/voxel
    # regularize small eigenvalues (PCL inflates to 1e-2 * largest)
    vals, vecs = jnp.linalg.eigh(cov)
    floor = jnp.maximum(vals[:, 2:3] * 1e-2, 1e-6)
    vals_r = jnp.maximum(vals, floor)
    cov_r = jnp.einsum("vij,vj,vkj->vik", vecs, vals_r, vecs)
    cov_inv = jnp.linalg.inv(cov_r + 1e-9 * jnp.eye(3, dtype=tgt.dtype))
    cov_inv = cov_inv * vvalid[:, None, None]
    return mean, cov_inv, vvalid


def ndt_register(src: jnp.ndarray, src_valid: jnp.ndarray,
                 tgt: jnp.ndarray, tgt_valid: jnp.ndarray,
                 init_rot=None, init_t=None, resolution: float = 0.5,
                 iters: int = 35) -> RegistrationResult:
    """NDT registration: GN on the Mahalanobis distance of each source point
    to its nearest voxel distribution (quadratic NDT score approximation)."""
    dtype = src.dtype
    rot = jnp.eye(3, dtype=dtype) if init_rot is None else init_rot
    t = jnp.zeros(3, dtype=dtype) if init_t is None else init_t
    centers, cov_inv, vvalid = build_ndt_grid(tgt, tgt_valid, resolution)

    def step(carry, _):
        rot, t = carry
        ps = src @ rot.T + t
        idx, d2, ok = pc.knn_indices(ps, src_valid, centers, vvalid, 1)
        nn = idx[:, 0]
        matched = ok[:, 0] & (d2[:, 0] < (1.5 * resolution) ** 2)
        r = ps - centers[nn]
        w = cov_inv[nn] * matched[:, None, None].astype(dtype)
        eye = jnp.broadcast_to(jnp.eye(3, dtype=dtype), (src.shape[0], 3, 3))
        jac = jnp.concatenate([eye, -lie.hat(ps)], axis=2)
        h = jnp.einsum("pij,pik,pkl->jl", jac, w, jac)
        g = -jnp.einsum("pij,pik,pk->j", jac, w, r)
        h = h + 1e-5 * jnp.eye(6, dtype=dtype)
        dx = jnp.linalg.solve(h, g)
        dx = jnp.where(jnp.all(jnp.isfinite(dx)), dx, 0.0)
        dr, dt = lie.se3_exp(dx)
        rot2 = lie.normalize_rotation(dr @ rot)
        t2 = dr @ t + dt
        stats = (jnp.sum(matched), jnp.sum(jnp.linalg.norm(r, axis=1) * matched)
                 / jnp.maximum(jnp.sum(matched), 1), jnp.linalg.norm(dx))
        return (rot2, t2), stats

    (rot, t), stats = jax.lax.scan(step, (rot, t), None, length=iters)
    n_inl, err, dx_norm = stats[0][-1], stats[1][-1], stats[2][-1]
    return RegistrationResult(rot=rot, t=t, n_inliers=n_inl.astype(jnp.int32),
                              error=err, converged=dx_norm < 1e-3)
