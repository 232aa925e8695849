"""Monocular initialization: two-view reconstruction + initial map.

JAX replacement for Tracking::MonocularInitialization +
CreateInitialMapMonocular (/root/reference/src/Tracking.cc:2826-3044) and
TwoViewReconstruction (/root/reference/src/TwoViewReconstruction.cc): match
the first two frames (descriptor NN + GMS option), score H and F hypotheses
in parallel RANSAC batches, pick the model (reference: ratio H/(H+F) > 0.4
-> homography), recover motion with cheirality checks, triangulate, and
seed the map with the two KFs + points (scale normalized to median depth).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from geoflowslam.math import lie, triangulate
from geoflowslam.ops import matching, ransac
from geoflowslam.state import map_state as M
from geoflowslam.state.frame import FrameData


class MonoInitResult(NamedTuple):
    ok: jnp.ndarray          # [] bool
    rot21: jnp.ndarray       # [3,3] frame2-from-frame1
    t21: jnp.ndarray         # [3] (unit-ish scale)
    pts1: jnp.ndarray        # [N,3] triangulated points in frame-1 camera
    match_idx: jnp.ndarray   # [N] kp1 -> kp2 or -1
    pt_valid: jnp.ndarray    # [N]


def _decompose_essential(e_mat):
    """E -> 4 candidate (R, t) (TwoViewReconstruction::DecomposeE)."""
    u, s, vt = jnp.linalg.svd(e_mat)
    # enforce det +1
    u = u * jnp.sign(jnp.linalg.det(u))
    vt = vt * jnp.sign(jnp.linalg.det(vt))
    w = jnp.array([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]])
    r1 = u @ w @ vt
    r2 = u @ w.T @ vt
    t = u[:, 2]
    return (r1, t), (r1, -t), (r2, t), (r2, -t)


def _decompose_homography(a_mat):
    """Calibrated homography A = K^-1 H K -> 8 (R, t) motion hypotheses
    (Faugeras SVD method, TwoViewReconstruction::ReconstructH,
    /root/reference/src/TwoViewReconstruction.cc)."""
    u, d, vt = jnp.linalg.svd(a_mat)
    s = jnp.linalg.det(u) * jnp.linalg.det(vt)
    d1, d2, d3 = d[0], d[1], d[2]
    eps = 1e-9
    x1 = jnp.sqrt(jnp.maximum((d1 * d1 - d2 * d2)
                              / jnp.maximum(d1 * d1 - d3 * d3, eps), 0.0))
    x3 = jnp.sqrt(jnp.maximum((d2 * d2 - d3 * d3)
                              / jnp.maximum(d1 * d1 - d3 * d3, eps), 0.0))
    out = []
    for e1 in (1.0, -1.0):
        for e3 in (1.0, -1.0):
            # case d' = +d2
            st = (d1 - d3) * (e1 * x1) * (e3 * x3) / jnp.maximum(d2, eps)
            ct = (d1 * x3 * x3 + d3 * x1 * x1) / jnp.maximum(d2, eps)
            rp = jnp.array([[1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0]])
            rp = rp.at[0, 0].set(ct).at[0, 2].set(-st)
            rp = rp.at[2, 0].set(st).at[2, 2].set(ct)
            tp = jnp.array([1.0, 0.0, -1.0]) * jnp.array(
                [e1 * x1, 0.0, e3 * x3]) * (d1 - d3)
            rot = s * u @ rp @ vt
            t = u @ tp
            out.append((rot, t / jnp.maximum(jnp.linalg.norm(t), eps)))
            # case d' = -d2
            sp = (d1 + d3) * (e1 * x1) * (e3 * x3) / jnp.maximum(d2, eps)
            cp = (d3 * x1 * x1 - d1 * x3 * x3) / jnp.maximum(d2, eps)
            rp2 = jnp.zeros((3, 3))
            rp2 = rp2.at[0, 0].set(cp).at[0, 2].set(sp)
            rp2 = rp2.at[1, 1].set(-1.0)
            rp2 = rp2.at[2, 0].set(sp).at[2, 2].set(-cp)
            tp2 = jnp.array([e1 * x1, 0.0, e3 * x3]) * (d1 + d3)
            rot2 = s * u @ rp2 @ vt
            t2 = u @ tp2
            out.append((rot2, t2 / jnp.maximum(jnp.linalg.norm(t2), eps)))
    return out


def two_view_reconstruct(key, uv1, uv2, valid, fx, fy, cx, cy,
                         n_hyp: int = 128, sigma: float = 1.0):
    """H/F model selection + motion recovery + triangulation
    (TwoViewReconstruction::Reconstruct: ratio SH/(SH+SF) > 0.5 -> the
    8-hypothesis homography decomposition, otherwise the 4-hypothesis
    essential decomposition).

    Returns MonoInitResult with pts in cam1 frame, |t| normalized to 1.
    """
    kf, kh = jax.random.split(key)
    res_f = ransac.ransac_fundamental(kf, uv1, uv2, valid, n_hyp, sigma=sigma)
    res_h = ransac.ransac_homography(kh, uv1, uv2, valid, n_hyp, sigma=sigma)
    # RH > 0.50 -> homography (TwoViewReconstruction.cc:119; the 0.40 in the
    # paper is commented out in the reference)
    use_h = res_h.score / jnp.maximum(res_h.score + res_f.score, 1e-9) > 0.50

    k_mat = jnp.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    k_inv = jnp.linalg.inv(k_mat)
    e_mat = k_mat.T @ res_f.model @ k_mat
    cands_f = list(_decompose_essential(e_mat))
    a_mat = k_inv @ res_h.model @ k_mat
    cands_h = _decompose_homography(a_mat)

    rays1 = (jnp.concatenate([uv1, jnp.ones((uv1.shape[0], 1))], 1) @ k_inv.T)
    rays2 = (jnp.concatenate([uv2, jnp.ones((uv2.shape[0], 1))], 1) @ k_inv.T)

    def score_candidate(rt, inl):
        rot, t = rt
        pts, tri_ok = triangulate.triangulate_points(rays1, rays2, rot, t)
        good = tri_ok & inl
        # parallax + reprojection sanity
        e1 = jnp.linalg.norm(pts[:, :2] / jnp.maximum(pts[:, 2:3], 1e-6)
                             - rays1[:, :2], axis=1) * fx
        pts2 = pts @ rot.T + t
        e2 = jnp.linalg.norm(pts2[:, :2] / jnp.maximum(pts2[:, 2:3], 1e-6)
                             - rays2[:, :2], axis=1) * fx
        good = good & (e1 < 4.0 * sigma) & (e2 < 4.0 * sigma)
        return jnp.sum(good), pts, good

    def pick_best(cands, inl):
        scores, all_pts, all_good = [], [], []
        for rt in cands:
            n, pts, good = score_candidate(rt, inl)
            scores.append(n)
            all_pts.append(pts)
            all_good.append(good)
        scores = jnp.stack(scores)
        best = jnp.argmax(scores)
        n_best = scores[best]
        n_second = jnp.sort(scores)[-2]
        # reference gates: enough points and a clear winner
        ok = (n_best > 50) & (n_second < 0.75 * n_best)
        rots = jnp.stack([c[0] for c in cands])
        ts = jnp.stack([c[1] for c in cands])
        return ok, rots[best], ts[best], jnp.stack(all_pts)[best], \
            jnp.stack(all_good)[best]

    ok_f, rot_f, t_f, pts_f, good_f = pick_best(cands_f, res_f.inliers)
    ok_h, rot_h, t_h, pts_h, good_h = pick_best(cands_h, res_h.inliers)
    ok = jnp.where(use_h, ok_h, ok_f)
    rot = jnp.where(use_h, rot_h, rot_f)
    t = jnp.where(use_h, t_h, t_f)
    pts = jnp.where(use_h, pts_h, pts_f)
    good = jnp.where(use_h, good_h, good_f)
    return ok, rot, t, pts, good


def try_monocular_init(key, frame1: FrameData, frame2: FrameData,
                       fx, fy, cx, cy, min_matches: int = 100,
                       use_gms: bool = False):
    """Match frame1<->frame2 and attempt reconstruction
    (SearchForInitialization[WithGMS] + Reconstruct; `use_gms` enables the
    grid-motion-statistics verification pass, the UseGMSInit config key)."""
    f1, f2 = frame1.feat, frame2.feat
    m_idx, m_dist = matching.match_descriptors(
        f1.desc, f1.valid, f2.desc, f2.valid,
        max_dist=matching.TH_LOW, ratio=0.9, mutual=True)
    # spatial gating: init expects small motion (reference windowSize=100)
    uv2 = f2.uv[jnp.maximum(m_idx, 0)]
    near = jnp.linalg.norm(uv2 - f1.uv, axis=1) < 100.0
    m_idx = jnp.where(near, m_idx, -1)
    if use_gms:
        from geoflowslam.ops.gms import gms_filter
        size = (int(2 * cx), int(2 * cy))
        m_idx = gms_filter(f1.uv, f2.uv, m_idx, size, size)
    valid = m_idx >= 0
    n_matches = jnp.sum(valid)

    ok, rot21, t21, pts1, good = two_view_reconstruct(
        key, f1.uv, uv2, valid, fx, fy, cx, cy)
    ok = ok & (n_matches >= min_matches)
    # normalize scale: median depth -> 1 (CreateInitialMapMonocular's
    # invMedianDepth normalization)
    depths = jnp.where(good, pts1[:, 2], jnp.nan)
    med = jnp.nanmedian(depths)
    scale = 1.0 / jnp.maximum(med, 1e-6)
    return MonoInitResult(ok=ok, rot21=rot21, t21=t21 * scale,
                          pts1=pts1 * scale, match_idx=m_idx,
                          pt_valid=good)


def create_initial_map_mono(ms: M.MapState, frame1: FrameData,
                            frame2: FrameData, init: MonoInitResult,
                            time1, time2, scale_factor: float = 1.2,
                            n_levels: int = 8):
    """Insert KF1 (identity) + KF2 (rot21, t21) + triangulated points."""
    f1, f2 = frame1.feat, frame2.feat
    n = f1.capacity
    slot1 = M.free_kf_slot(ms)
    # temporary insert so slot2 differs
    make = init.pt_valid & (init.match_idx >= 0)
    ms, mp_slots = M.free_mp_slots(ms, n, use_mask=make)
    ids = jnp.where(make, mp_slots, M.NO_MP)

    obs1 = ids
    obs2 = jnp.full((n,), M.NO_MP, jnp.int32)
    tgt = jnp.where(make, init.match_idx, n)
    obs2 = obs2.at[tgt].set(ids, mode="drop")

    ms = M.insert_keyframe(
        ms, slot1, jnp.eye(3), jnp.zeros(3), jnp.zeros(3), jnp.zeros(6),
        time1, f1.uv, f1.level, f1.angle, f1.desc,
        jnp.full((n,), -1.0), f1.valid, obs1, jnp.int32(-1))
    slot2 = M.free_kf_slot(ms)
    ms = M.insert_keyframe(
        ms, slot2, init.rot21, init.t21, jnp.zeros(3), jnp.zeros(6),
        time2, f2.uv, f2.level, f2.angle, f2.desc,
        jnp.full((n,), -1.0), f2.valid, obs2, slot1)

    pts_w = init.pts1  # world = cam1 frame
    dist = jnp.linalg.norm(pts_w, axis=1)
    normal = -pts_w / jnp.maximum(dist[:, None], 1e-6)
    level_sf = scale_factor ** f1.level.astype(jnp.float32)
    max_d = dist * level_sf
    min_d = max_d / (scale_factor ** (n_levels - 1))
    ms = M.add_map_points(ms, mp_slots, pts_w, f1.desc, normal, min_d, max_d,
                          slot1, make)
    return ms, slot1, slot2, obs2, jnp.sum(make)
