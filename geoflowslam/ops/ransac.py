"""Batched RANSAC: fundamental / homography / PnP / Sim3, batched.

Replaces the iterative hypothesize-and-verify loops of the reference —
cv::findFundamentalMat (src/Tracking.cc:2010, ORBmatcher.cc:2397),
cv::solvePnPRansac (src/Tracking.cc:2021), TwoViewReconstruction's H/F RANSAC
(src/TwoViewReconstruction.cc), Sim3Solver::iterate (src/Sim3Solver.cc) and
MLPnPsolver::iterate (src/MLPnPsolver.cpp) — with a fixed batch of K
hypotheses solved by vmapped minimal solvers and scored by dense residual
matrices: one [K, N] evaluation instead of data-dependent iteration, the
idiomatic RANSAC shape for SIMD machines.

All inputs are padded with validity masks; all shapes static.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from geoflowslam.math import lie


def _sample_minimal_sets(key, valid, n_hyp, set_size):
    """[n_hyp, set_size] distinct indices drawn from valid entries via
    per-hypothesis Gumbel top-k (masked, without replacement)."""
    n = valid.shape[0]
    g = jax.random.gumbel(key, (n_hyp, n))
    g = jnp.where(valid[None, :], g, -jnp.inf)
    _, idx = jax.lax.top_k(g, set_size)
    return idx


def _normalize_2d(pts, valid):
    """Hartley normalization: zero-mean, mean distance sqrt(2)."""
    w = valid.astype(pts.dtype)
    n = jnp.maximum(jnp.sum(w), 1.0)
    mean = jnp.sum(pts * w[:, None], axis=0) / n
    d = jnp.linalg.norm(pts - mean, axis=1)
    md = jnp.sum(d * w) / n
    s = jnp.sqrt(2.0) / jnp.maximum(md, 1e-9)
    t = jnp.array([[s, 0, -s * mean[0]], [0, s, -s * mean[1]], [0, 0, 1]], pts.dtype)
    return (pts - mean) * s, t


class RansacResult(NamedTuple):
    model: jnp.ndarray      # best model parameters
    inliers: jnp.ndarray    # [N] bool
    n_inliers: jnp.ndarray  # scalar int32
    score: jnp.ndarray      # scalar float (model score)


# ---------------------------------------------------------------------------
# Fundamental matrix (8-point)
# ---------------------------------------------------------------------------

def _solve_f_8pt(p1, p2):
    """8-point F from [8,2]x[8,2] (already normalized). Returns [3,3]."""
    x1, y1 = p1[:, 0], p1[:, 1]
    x2, y2 = p2[:, 0], p2[:, 1]
    a = jnp.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, jnp.ones_like(x1)], axis=1)
    _, _, vt = jnp.linalg.svd(a, full_matrices=True)
    f = vt[8].reshape(3, 3)
    # rank-2 enforcement
    u, s, vt2 = jnp.linalg.svd(f)
    s = s.at[2].set(0.0)
    return u @ jnp.diag(s) @ vt2


def _epipolar_dist2(f, p1, p2):
    """Symmetric squared epipolar transfer distance, pixels^2."""
    ones = jnp.ones((p1.shape[0], 1), p1.dtype)
    h1 = jnp.concatenate([p1, ones], axis=1)
    h2 = jnp.concatenate([p2, ones], axis=1)
    l2 = h1 @ f.T           # epiline in image 2
    l1 = h2 @ f             # epiline in image 1
    num = jnp.sum(h2 * l2, axis=1) ** 2
    d2 = num / jnp.maximum(l2[:, 0] ** 2 + l2[:, 1] ** 2, 1e-12)
    d1 = num / jnp.maximum(l1[:, 0] ** 2 + l1[:, 1] ** 2, 1e-12)
    return d1, d2


def ransac_fundamental(key, uv1, uv2, valid, n_hyp: int = 128,
                       threshold: float = 3.84, sigma: float = 1.0) -> RansacResult:
    """F-RANSAC with the reference's chi-square scoring
    (TwoViewReconstruction::CheckFundamental: per-point score
    thScore - chi2 for chi2 < 3.841/sigma^2, both directions)."""
    uv1n, t1 = _normalize_2d(uv1, valid)
    uv2n, t2 = _normalize_2d(uv2, valid)
    idx = _sample_minimal_sets(key, valid, n_hyp, 8)

    def solve(i):
        return _solve_f_8pt(uv1n[i], uv2n[i])

    fs_n = jax.vmap(solve)(idx)                       # [K,3,3] normalized
    fs = jnp.einsum("ji,kjl,lm->kim", t2, fs_n, t1)   # denormalize: F = T2^T Fn T1

    th = threshold * sigma * sigma
    th_score = 5.991 * sigma * sigma

    def score_one(f):
        d1, d2 = _epipolar_dist2(f, uv1, uv2)
        in1 = (d1 < th) & valid
        in2 = (d2 < th) & valid
        inl = in1 & in2
        sc = jnp.sum(jnp.where(in1, th_score - d1, 0.0) + jnp.where(in2, th_score - d2, 0.0))
        return inl, sc

    inls, scores = jax.vmap(score_one)(fs)
    best = jnp.argmax(scores)
    return RansacResult(fs[best], inls[best], jnp.sum(inls[best]), scores[best])


# ---------------------------------------------------------------------------
# Homography (4-point DLT)
# ---------------------------------------------------------------------------

def _solve_h_4pt(p1, p2):
    def rows(pp1, pp2):
        x, y = pp1
        u, v = pp2
        r1 = jnp.array([-x, -y, -1.0, 0, 0, 0, u * x, u * y, u])
        r2 = jnp.array([0, 0, 0, -x, -y, -1.0, v * x, v * y, v])
        return jnp.stack([r1, r2])

    a = jnp.concatenate([rows(p1[i], p2[i]) for i in range(4)], axis=0)  # [8,9]
    _, _, vt = jnp.linalg.svd(a, full_matrices=True)
    h = vt[8].reshape(3, 3)
    return h / jnp.where(jnp.abs(h[2, 2]) < 1e-12, 1e-12, h[2, 2])


def _h_transfer_dist2(h, p1, p2):
    ones = jnp.ones((p1.shape[0], 1), p1.dtype)
    h1 = jnp.concatenate([p1, ones], axis=1)
    h2 = jnp.concatenate([p2, ones], axis=1)
    q2 = h1 @ h.T
    q2 = q2[:, :2] / jnp.where(jnp.abs(q2[:, 2:3]) < 1e-12, 1e-12, q2[:, 2:3])
    hinv = jnp.linalg.inv(h)
    q1 = h2 @ hinv.T
    q1 = q1[:, :2] / jnp.where(jnp.abs(q1[:, 2:3]) < 1e-12, 1e-12, q1[:, 2:3])
    d21 = jnp.sum((q2 - p2) ** 2, axis=1)
    d12 = jnp.sum((q1 - p1) ** 2, axis=1)
    return d12, d21


def ransac_homography(key, uv1, uv2, valid, n_hyp: int = 128,
                      sigma: float = 1.0) -> RansacResult:
    """H-RANSAC with CheckHomography scoring (th = 5.991 both directions)."""
    idx = _sample_minimal_sets(key, valid, n_hyp, 4)
    hs = jax.vmap(lambda i: _solve_h_4pt(uv1[i], uv2[i]))(idx)
    th = 5.991 * sigma * sigma

    def score_one(h):
        d12, d21 = _h_transfer_dist2(h, uv1, uv2)
        in1 = (d12 < th) & valid
        in2 = (d21 < th) & valid
        inl = in1 & in2
        sc = jnp.sum(jnp.where(in1, th - d12, 0.0) + jnp.where(in2, th - d21, 0.0))
        return inl, sc

    inls, scores = jax.vmap(score_one)(hs)
    best = jnp.argmax(scores)
    return RansacResult(hs[best], inls[best], jnp.sum(inls[best]), scores[best])


# ---------------------------------------------------------------------------
# PnP (6-point DLT + orthogonalization), replaces solvePnPRansac / MLPnP
# ---------------------------------------------------------------------------

def _solve_pnp_dlt(pts3d, rays):
    """[6,3] world points + [6,2] normalized image coords -> (R, t) cam<-world."""
    x, y = rays[:, 0], rays[:, 1]
    zeros = jnp.zeros((6, 4), pts3d.dtype)
    ph = jnp.concatenate([pts3d, jnp.ones((6, 1), pts3d.dtype)], axis=1)  # [6,4]
    a_top = jnp.concatenate([ph, zeros, -x[:, None] * ph], axis=1)
    a_bot = jnp.concatenate([zeros, ph, -y[:, None] * ph], axis=1)
    a = jnp.concatenate([a_top, a_bot], axis=0)       # [12, 12]
    _, _, vt = jnp.linalg.svd(a, full_matrices=True)
    p = vt[11].reshape(3, 4)
    m = p[:, :3]
    # sign: points must have positive depth on average
    depths = ph @ p[2]
    p = p * jnp.where(jnp.sum(depths) < 0, -1.0, 1.0)
    m = p[:, :3]
    # Orthogonalize M = sR via SVD
    u, s, vt2 = jnp.linalg.svd(m)
    det = jnp.linalg.det(u @ vt2)
    d = jnp.diag(jnp.array([1.0, 1.0, 1.0]))
    d = d.at[2, 2].set(det)
    rot = u @ d @ vt2
    scale = jnp.sum(s * jnp.diag(d)) / 3.0
    t = p[:, 3] / jnp.maximum(scale, 1e-12)
    return rot, t


def ransac_pnp(key, pts3d, uv_norm, valid, n_hyp: int = 128,
               threshold_px: float = 5.99, focal: float = 1.0) -> RansacResult:
    """PnP RANSAC over normalized image coords; threshold in pixels via
    `focal` scaling (so callers pass fx). Returns model [3,4] = [R|t]."""
    idx = _sample_minimal_sets(key, valid, n_hyp, 6)
    rots, ts = jax.vmap(lambda i: _solve_pnp_dlt(pts3d[i], uv_norm[i]))(idx)

    def score_one(rot, t):
        pc = pts3d @ rot.T + t
        z = pc[:, 2]
        proj = pc[:, :2] / jnp.where(jnp.abs(z[:, None]) < 1e-9, 1e-9, z[:, None])
        err2 = jnp.sum((proj - uv_norm) ** 2, axis=1) * focal * focal
        inl = (err2 < threshold_px ** 2) & (z > 0) & valid
        return inl, jnp.sum(inl.astype(jnp.float32))

    inls, scores = jax.vmap(score_one)(rots, ts)
    best = jnp.argmax(scores)
    model = jnp.concatenate([rots[best], ts[best][:, None]], axis=1)
    return RansacResult(model, inls[best], jnp.sum(inls[best]), scores[best])


def refine_pnp_ml(rot0, t0, pts3d, uv_norm, inliers, iters: int = 8):
    """Maximum-likelihood PnP refinement over bearing vectors
    (MLPnPsolver::mlpnp_gn, /root/reference/src/MLPnPsolver.cpp:1-1244, used
    in relocalization at src/Tracking.cc:4586): Gauss-Newton on the residual
    of each observed bearing expressed in its own 2D nullspace basis —
    r_i = [r_i; s_i]^T (R p_i + t)/|R p_i + t| with (r_i, s_i) spanning the
    plane orthogonal to the observed unit bearing v_i. Batched over all
    correspondences; a left-multiplicative se3 update per iteration.

    Returns (rot, t) refined from (rot0, t0)."""
    from geoflowslam.math import lie

    v = jnp.concatenate([uv_norm, jnp.ones_like(uv_norm[:, :1])], axis=1)
    v = v / jnp.linalg.norm(v, axis=1, keepdims=True)           # [N,3]
    # nullspace basis per bearing: r = normalize(v x e), s = v x r
    e = jnp.where(jnp.abs(v[:, 2:3]) < 0.9,
                  jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0]), v.shape),
                  jnp.broadcast_to(jnp.array([1.0, 0.0, 0.0]), v.shape))
    r_b = jnp.cross(v, e)
    r_b = r_b / jnp.maximum(jnp.linalg.norm(r_b, axis=1, keepdims=True), 1e-9)
    s_b = jnp.cross(v, r_b)
    w = inliers.astype(jnp.float32)

    def step(carry, _):
        rot, t = carry
        pc = pts3d @ rot.T + t                                   # [N,3]
        nrm = jnp.maximum(jnp.linalg.norm(pc, axis=1, keepdims=True), 1e-9)
        u = pc / nrm                                             # [N,3]
        res = jnp.stack([jnp.sum(r_b * u, axis=1),
                         jnp.sum(s_b * u, axis=1)], axis=1)      # [N,2]
        # d u / d pc = (I - u u^T)/|pc| ; d pc/d xi = [I | -[pc]x] (left upd)
        eye = jnp.eye(3)
        du = (eye[None] - u[:, :, None] * u[:, None, :]) / nrm[:, :, None]
        px = jnp.zeros((pts3d.shape[0], 3, 3))
        px = px.at[:, 0, 1].set(-pc[:, 2]).at[:, 0, 2].set(pc[:, 1])
        px = px.at[:, 1, 0].set(pc[:, 2]).at[:, 1, 2].set(-pc[:, 0])
        px = px.at[:, 2, 0].set(-pc[:, 1]).at[:, 2, 1].set(pc[:, 0])
        dpc = jnp.concatenate([jnp.broadcast_to(eye, px.shape), -px], axis=2)
        jac_u = jnp.einsum("nij,njk->nik", du, dpc)              # [N,3,6]
        jac = jnp.stack([jnp.einsum("ni,nik->nk", r_b, jac_u),
                         jnp.einsum("ni,nik->nk", s_b, jac_u)], axis=1)
        h = jnp.einsum("n,nri,nrj->ij", w, jac, jac) + 1e-8 * jnp.eye(6)
        g = jnp.einsum("n,nri,nr->i", w, jac, res)
        dx = -jnp.linalg.solve(h, g)
        dr = lie.so3_exp(dx[3:])
        rot2 = dr @ rot
        t2 = dr @ t + dx[:3]
        return (rot2, t2), None

    (rot, t), _ = jax.lax.scan(step, (rot0, t0), None, length=iters)
    return rot, t


# ---------------------------------------------------------------------------
# Sim3 (Horn closed form, 3 points), replaces Sim3Solver
# ---------------------------------------------------------------------------

def solve_sim3_horn(pts1, pts2, w=None, fix_scale: bool = False):
    """Closed-form Sim3 aligning pts1 -> pts2 ([N,3] each, optional weights).

    Horn's method as in Sim3Solver::ComputeSim3
    (/root/reference/src/Sim3Solver.cc): returns (s, R, t) with
    pts2 ~= s * R @ pts1 + t.
    """
    if w is None:
        w = jnp.ones(pts1.shape[0], pts1.dtype)
    wn = w / jnp.maximum(jnp.sum(w), 1e-9)
    c1 = jnp.sum(pts1 * wn[:, None], axis=0)
    c2 = jnp.sum(pts2 * wn[:, None], axis=0)
    q1 = pts1 - c1
    q2 = pts2 - c2
    cov = jnp.einsum("n,ni,nj->ij", wn, q2, q1)
    u, s, vt = jnp.linalg.svd(cov)
    d = jnp.eye(3)
    d = d.at[2, 2].set(jnp.linalg.det(u @ vt))
    rot = u @ d @ vt
    var1 = jnp.sum(wn * jnp.sum(q1 * q1, axis=1))
    scale = jnp.where(
        fix_scale, 1.0, jnp.sum(s * jnp.diag(d)) / jnp.maximum(var1, 1e-12)
    )
    t = c2 - scale * rot @ c1
    return scale, rot, t


def ransac_sim3(key, pts1, pts2, valid, n_hyp: int = 64,
                threshold: float = 0.05, fix_scale: bool = False) -> RansacResult:
    """Sim3 RANSAC over 3D-3D correspondences. Threshold is a relative
    3D distance (fraction of point depth), a simplification of the reference's
    per-image reprojection gates (Sim3Solver::CheckInliers)."""
    idx = _sample_minimal_sets(key, valid, n_hyp, 3)

    def solve(i):
        return solve_sim3_horn(pts1[i], pts2[i], fix_scale=fix_scale)

    ss, rots, ts = jax.vmap(solve)(idx)

    def score_one(s, rot, t):
        pred = s * pts1 @ rot.T + t
        err = jnp.linalg.norm(pred - pts2, axis=1)
        rel = err / jnp.maximum(jnp.linalg.norm(pts2, axis=1), 1e-6)
        inl = (rel < threshold) & valid
        return inl, jnp.sum(inl.astype(jnp.float32))

    inls, scores = jax.vmap(score_one)(ss, rots, ts)
    best = jnp.argmax(scores)
    model = jnp.concatenate([ss[best][None], rots[best].reshape(-1), ts[best]])
    return RansacResult(model, inls[best], jnp.sum(inls[best]), scores[best])
