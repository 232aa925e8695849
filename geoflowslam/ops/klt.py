"""Pyramidal Lucas-Kanade optical flow, batched over keypoints.

JAX replacement for cv::calcOpticalFlowPyrLK as used by the
dual-stream optical-flow tracker (ORBmatcher::SearchByProjectionWithOF
3-level prior stream + 6-level 2D stream, /root/reference/src/ORBmatcher.cc:
2303-2497; fbKltTracking forward/backward check :2186; Tracking::fbKltTracking
src/Tracking.cc:3262; pyramid built per frame in Frame ctor src/Frame.cc:373).

Shape-static design: every keypoint runs the same fixed iteration count per
level with masked convergence (`lax.while` would desync the batch); patch
gathers are bilinear interpolation via 4 fused gathers over the level image.
vmap over N keypoints; levels unrolled coarse->fine (static list).
"""
from __future__ import annotations

from typing import List, NamedTuple

import jax
import jax.numpy as jnp


class KLTResult(NamedTuple):
    pts: jnp.ndarray     # [N,2] tracked positions (level-0 coords)
    status: jnp.ndarray  # [N] bool
    err: jnp.ndarray     # [N] mean abs residual over the window


def _extract_patches(img_padded, tl_xy, side: int):
    """Contiguous [side, side] block per point (vmapped dynamic_slice: ONE
    block gather of N slices instead of 4 scattered element-gathers per
    bilinear sample)."""
    def one(c):
        return jax.lax.dynamic_slice(img_padded, (c[1], c[0]), (side, side))
    return jax.vmap(one)(tl_xy)


def _bilinear_patch(patch, frac_xy):
    """Resample an integer-aligned [N,P,P] patch stack at per-point
    fractional offset: four SHIFTED VIEWS of the patch blended elementwise
    (no gather). Output [N,P-1,P-1]: sample (i,j) sits at integer offset
    (i,j) + frac relative to the patch's top-left corner."""
    fx = frac_xy[:, 0][:, None, None]
    fy = frac_xy[:, 1][:, None, None]
    return ((1 - fx) * (1 - fy) * patch[:, :-1, :-1]
            + fx * (1 - fy) * patch[:, :-1, 1:]
            + (1 - fx) * fy * patch[:, 1:, :-1]
            + fx * fy * patch[:, 1:, 1:])


def _track_level(img_prev, img_next, pts_prev_lvl, guess_lvl, win: int,
                 iters: int, min_eig: float):
    """One pyramid level of LK for all points. Returns (new guess, ok).

    Patch-based: template + gradients come from one (win+3)^2 block per
    point; each GN iteration re-extracts one (win+1)^2 block at the current
    estimate. All interpolation is shifted-view arithmetic inside the
    blocks. Border semantics = replicate (edge pad), matching
    cv::buildOpticalFlowPyramid's replicated-border padding."""
    r = win // 2
    h, w = img_prev.shape
    pad = r + 2
    ip_prev = jnp.pad(img_prev, pad, mode="edge")
    ip_next = jnp.pad(img_next, pad, mode="edge")

    # template + spatial gradients at integer-aligned samples around
    # pts_prev: sample offsets -(r+1)..(r+1) -> integer span win+3
    P_t = win + 3
    base_p = jnp.floor(pts_prev_lvl).astype(jnp.int32)          # [N,2] (x,y)
    frac_p = pts_prev_lvl - base_p
    tl_p = base_p - (r + 1) + pad
    patch_p = _extract_patches(ip_prev, tl_p, P_t)              # [N,P_t,P_t]
    interp = _bilinear_patch(patch_p, frac_p)                   # [N,win+2,win+2]
    tmpl = interp[:, 1:-1, 1:-1]                                # [N,win,win]
    ix = 0.5 * (interp[:, 1:-1, 2:] - interp[:, 1:-1, :-2])
    iy = 0.5 * (interp[:, 2:, 1:-1] - interp[:, :-2, 1:-1])
    gxx = jnp.sum(ix * ix, axis=(1, 2))
    gxy = jnp.sum(ix * iy, axis=(1, 2))
    gyy = jnp.sum(iy * iy, axis=(1, 2))
    det = gxx * gyy - gxy * gxy
    tr = gxx + gyy
    eig_min = 0.5 * (tr - jnp.sqrt(jnp.maximum(tr * tr - 4 * det, 0.0)))
    good_grad = eig_min / (win * win) > min_eig
    det_safe = jnp.where(jnp.abs(det) < 1e-9, 1e-9, det)

    P_c = win + 1    # iteration block: sample offsets -r..r -> span win+1

    def sample_cur(g):
        base = jnp.floor(g).astype(jnp.int32)
        tl = base - r + pad
        patch = _extract_patches(ip_next, tl, P_c)              # [N,P_c,P_c]
        return _bilinear_patch(patch, g - base)                 # [N,win,win]

    def body(_, g):
        di = sample_cur(g) - tmpl
        bx = jnp.sum(di * ix, axis=(1, 2))
        by = jnp.sum(di * iy, axis=(1, 2))
        # step = -G^-1 b with G = [[gxx,gxy],[gxy,gyy]]
        sx = -(gyy * bx - gxy * by) / det_safe
        sy = -(-gxy * bx + gxx * by) / det_safe
        step = jnp.stack([sx, sy], axis=1)
        return g + jnp.where(good_grad[:, None], step, 0.0)

    g_out = jax.lax.fori_loop(0, iters, body, guess_lvl)
    err = jnp.mean(jnp.abs(sample_cur(g_out) - tmpl), axis=(1, 2))
    # point (not whole patch) must stay inside, as before
    inb = ((g_out[:, 0] >= 0) & (g_out[:, 0] <= w - 1)
           & (g_out[:, 1] >= 0) & (g_out[:, 1] <= h - 1))
    return g_out, good_grad & inb, err


def klt_track(pyr_prev: List[jnp.ndarray], pyr_next: List[jnp.ndarray],
              pts_prev: jnp.ndarray, init_guess: jnp.ndarray | None = None,
              scale_factor: float = 2.0, win: int = 21, iters: int = 10,
              min_eig: float = 1e-4, max_levels: int | None = None) -> KLTResult:
    """Track pts_prev (level-0 coords) from pyr_prev to pyr_next.

    `init_guess` (level-0 coords) seeds the search — used by the 3D-prior
    stream which initializes at map-point projections (ORBmatcher.cc:2379).
    """
    n_levels = len(pyr_prev) if max_levels is None else min(max_levels, len(pyr_prev))
    if init_guess is None:
        init_guess = pts_prev

    top = n_levels - 1
    inv_top = 1.0 / (scale_factor ** top)
    g = init_guess * inv_top
    ok_all = jnp.ones(pts_prev.shape[0], bool)
    err = jnp.zeros(pts_prev.shape[0])
    for lvl in range(top, -1, -1):
        s = 1.0 / (scale_factor ** lvl)
        p_lvl = pts_prev * s
        g, ok, err = _track_level(pyr_prev[lvl], pyr_next[lvl], p_lvl, g,
                                  win, iters, min_eig)
        ok_all = ok_all & ok
        if lvl > 0:
            g = g * scale_factor
    return KLTResult(pts=g, status=ok_all, err=err)


def fb_klt_track(pyr_prev, pyr_next, pts_prev, init_guess=None,
                 fb_thresh: float = 1.0, fb_levels: int = 1,
                 **kw) -> KLTResult:
    """Forward-backward LK with consistency gating (Tracking::fbKltTracking,
    /root/reference/src/Tracking.cc:3262 and ORBmatcher.cc:2186).

    The backward verification starts AT the converged forward estimate, so
    it is a local consistency test: it runs only the `fb_levels` finest
    pyramid levels (coarse backward levels would just re-find the same
    basin and double the cost of the whole tracker)."""
    fwd = klt_track(pyr_prev, pyr_next, pts_prev, init_guess, **kw)
    kw_b = dict(kw)
    kw_b["max_levels"] = min(fb_levels, kw.get("max_levels", fb_levels))
    bwd = klt_track(pyr_next, pyr_prev, fwd.pts, fwd.pts, **kw_b)
    fb_err = jnp.linalg.norm(bwd.pts - pts_prev, axis=1)
    status = fwd.status & bwd.status & (fb_err < fb_thresh)
    return KLTResult(pts=fwd.pts, status=status, err=fwd.err)


def build_lk_pyramid(img: jnp.ndarray, n_levels: int) -> List[jnp.ndarray]:
    """Half-resolution pyramid with 5x5 Gaussian smoothing per octave
    (cv::buildOpticalFlowPyramid analogue; Frame.cc:373 builds maxLevel=6)."""
    from geoflowslam.ops.pyramid import gaussian_blur

    levels = [img]
    for _ in range(1, n_levels):
        sm = gaussian_blur(levels[-1], 5, 1.1)
        levels.append(sm[::2, ::2])
    return levels
