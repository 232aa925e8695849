"""Rectified stereo matching: per-keypoint SAD search along the epipolar row.

JAX replacement for Frame::ComputeStereoMatches
(/root/reference/src/Frame.cc:1153-1313): the reference does a row-bucketed
descriptor match followed by an 11x11 SAD refinement with subpixel parabola
fitting; here the SAD search runs densely over the full disparity range for
every keypoint in one vmapped pass (the [N, D] cost tile is tiny), with the same best/second gating and parabolic subpixel refinement.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def _patch(img, cx, cy, half: int):
    """[2h+1, 2h+1] patch around (cx, cy) with border clamp (int coords)."""
    h, w = img.shape
    ys = jnp.clip(cy + jnp.arange(-half, half + 1), 0, h - 1)
    xs = jnp.clip(cx + jnp.arange(-half, half + 1), 0, w - 1)
    return img[ys[:, None], xs[None, :]]


@partial(jax.jit, static_argnames=("max_disp", "half"))
def stereo_match(img_l: jnp.ndarray, img_r: jnp.ndarray, uv: jnp.ndarray,
                 valid: jnp.ndarray, bf: float, min_disp: float = 0.5,
                 max_disp: int = 64, half: int = 5, sad_ratio: float = 0.9):
    """Match left keypoints into the right image.

    Returns (u_right [N], depth [N]) with -1 where matching failed.
    """
    n = uv.shape[0]
    ui = jnp.round(uv[:, 0]).astype(jnp.int32)
    vi = jnp.round(uv[:, 1]).astype(jnp.int32)

    def one(u, v, ok):
        pl = _patch(img_l, u, v, half)
        pl = pl - pl[half, half]

        def cost_at(d):
            pr = _patch(img_r, u - d, v, half)
            pr = pr - pr[half, half]
            return jnp.sum(jnp.abs(pl - pr))

        costs = jax.vmap(cost_at)(jnp.arange(max_disp))
        best = jnp.argmin(costs)
        c_best = costs[best]
        second = jnp.min(jnp.where(jnp.arange(max_disp) == best, jnp.inf, costs))
        # subpixel parabola
        cm1 = costs[jnp.clip(best - 1, 0, max_disp - 1)]
        cp1 = costs[jnp.clip(best + 1, 0, max_disp - 1)]
        denom = cm1 + cp1 - 2 * c_best
        delta = jnp.where(jnp.abs(denom) > 1e-6,
                          0.5 * (cm1 - cp1) / jnp.maximum(denom, 1e-6), 0.0)
        delta = jnp.clip(delta, -1.0, 1.0)
        disp = best.astype(jnp.float32) + delta
        good = ok & (disp >= min_disp) & (best > 0) & (best < max_disp - 1) \
            & (c_best < sad_ratio * second + 1e-6) \
            & (u - max_disp >= 0)
        ur = jnp.where(good, u.astype(jnp.float32) - disp, -1.0)
        depth = jnp.where(good, bf / jnp.maximum(disp, min_disp), -1.0)
        return ur, depth

    return jax.vmap(one)(ui, vi, valid)


@jax.jit
def fisheye_stereo_match(rays_l: jnp.ndarray, desc_l: jnp.ndarray,
                         mask_l: jnp.ndarray, sigma2_l: jnp.ndarray,
                         rays_r: jnp.ndarray, desc_r: jnp.ndarray,
                         mask_r: jnp.ndarray, sigma2_r: jnp.ndarray,
                         r_lr: jnp.ndarray, t_lr: jnp.ndarray,
                         f_err: float = 400.0):
    """Stereo-fisheye matching + ray triangulation.

    JAX Frame::ComputeStereoFishEyeMatches
    (/root/reference/src/Frame.cc:1503-1577) + KannalaBrandt8::
    TriangulateMatches (src/CameraModels/KannalaBrandt8.cpp:306-370): the
    reference brute-force knn-matches the lapping-area keypoints with a 0.7
    Lowe ratio, then per match unprojects both rays, gates on parallax
    (cosParallaxRays <= 0.9998), DLT-triangulates in the left frame and
    gates both reprojection errors at chi2 5.991 x level sigma^2. Here the
    Hamming matrix is one matmul and the whole candidate set is
    triangulated/gated in one batched pass. Rays arrive pre-unprojected
    (any camera model — undistortion already happened at frame build), so
    the reprojection gate is evaluated in the pinhole-equivalent image
    (error scaled by `f_err`), not the raw fisheye grid: identical
    chi2 semantics, no second KB8 projection.

    Args:
      rays_l/rays_r: [N,3]/[M,3] unit-z rays per keypoint.
      desc_*: [.,8] uint32 ORB descriptors; mask_*: validity & lapping area.
      sigma2_*: [.] per-keypoint level sigma^2 (mvLevelSigma2[octave]).
      r_lr, t_lr: right-cam -> left-cam rigid transform (mRlr, mtlr).
    Returns:
      (depth [N] z in left cam (<=0 invalid), p3d [N,3] left-cam points,
       match_idx [N] into right keypoints or -1).
    """
    from geoflowslam.ops import matching
    from geoflowslam.math.triangulate import triangulate_points

    n = rays_l.shape[0]
    # BFmatcher.knnMatch + Lowe 0.7 (Frame.cc:1523-1531); no absolute
    # Hamming gate in the reference -> max_dist=255
    m_idx, _ = matching.match_descriptors(desc_l, mask_l, desc_r, mask_r,
                                          max_dist=255, ratio=0.7,
                                          mutual=False)
    j = jnp.maximum(m_idx, 0)
    r2 = rays_r[j]
    # parallax gate in the left frame: r21 = R_lr r2 (KannalaBrandt8.cpp:312)
    r21 = r2 @ r_lr.T
    cosp = jnp.sum(rays_l * r21, axis=-1) / jnp.maximum(
        jnp.linalg.norm(rays_l, axis=-1) * jnp.linalg.norm(r21, axis=-1),
        1e-9)
    # triangulate with left cam as world: P2 = [R_rl | -R_rl t_lr]
    rot21 = r_lr.T
    t21 = -rot21 @ t_lr
    p3d, cheir = triangulate_points(rays_l, r2, rot21, t21)
    z1 = p3d[:, 2]
    p2c = p3d @ rot21.T + t21
    # reprojection gates, pinhole-equivalent pixels (chi2 5.991 x sigma^2)
    e1 = (p3d[:, :2] / jnp.maximum(z1[:, None], 1e-9)
          - rays_l[:, :2]) * f_err
    e2 = (p2c[:, :2] / jnp.maximum(p2c[:, 2:3], 1e-9)
          - r2[:, :2]) * f_err
    ok = ((m_idx >= 0) & (cosp <= 0.9998) & cheir
          & (jnp.sum(e1 * e1, axis=-1) <= 5.991 * sigma2_l)
          & (jnp.sum(e2 * e2, axis=-1) <= 5.991 * sigma2_r[j])
          & (z1 > 1e-4))
    depth = jnp.where(ok, z1, -1.0)
    return depth, p3d, jnp.where(ok, m_idx, -1)
