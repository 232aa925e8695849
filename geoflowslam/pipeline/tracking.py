"""Tracking stage: jit-compiled per-frame pose estimation.

JAX re-expression of Tracking (reference src/Tracking.cc) — the
5000-line per-frame state machine — split into a small set of jit-compiled
stage functions operating on the padded MapState + FrameData pytrees, with
only the branchy scalar state machine (eTrackingState transitions, KF
decision) left to the host orchestrator (pipeline/system.py):

* `stereo_initialization`    <- Tracking::StereoInitialization (:2697)
* `track_with_motion_model`  <- TrackWithMotionModel (:3466): project last
  frame's map points at the predicted pose, SearchByProjection, pose-only GN.
* `track_local_map`          <- TrackLocalMap (:3729) + SearchLocalPoints
  (:4294): covisibility-window map points, frustum gating, projection search,
  pose-only GN over all matches, found/visible bookkeeping.
* `create_keyframe`          <- CreateNewKeyFrame (:4168): KF insertion plus
  RGB-D close-point creation.

Each function returns (new_state, scalars) where scalars are the handful of
numbers the host needs for branching (inlier counts, tracked ratio).
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from geoflowslam.math import lie
from geoflowslam.ops import matching
from geoflowslam.ops.extractor import FeatureSet
from geoflowslam.solvers import pose_opt
from geoflowslam.state import map_state as M
from geoflowslam.state.frame import FrameData


@dataclasses.dataclass(frozen=True)
class TrackConfig:
    fx: float = 400.0
    fy: float = 400.0
    cx: float = 320.0
    cy: float = 240.0
    bf: float = 40.0
    n_levels: int = 8
    scale_factor: float = 1.2
    search_radius_mm: float = 15.0   # SearchByProjection th (motion model)
    search_radius_lm: float = 5.0    # SearchLocalPoints base radius
    match_max_dist: int = matching.TH_HIGH
    min_inliers: int = 10
    local_window: int = 10           # K1 covisible KFs
    lm_max_candidates: int = 2048    # cap on projected local-map points
    max_new_mp_per_kf: int = 256
    close_depth: float = 3.5         # mThDepth analogue for RGBD point creation


def _inv_sigma2(levels: jnp.ndarray, scale_factor: float) -> jnp.ndarray:
    """Per-octave information weight (ORB-SLAM mvInvLevelSigma2)."""
    sigma2 = (scale_factor ** levels.astype(jnp.float32)) ** 2
    return 1.0 / sigma2


def _project(rot, t, pts_w, cfg: TrackConfig):
    pc = pts_w @ rot.T + t
    z = pc[:, 2]
    zs = jnp.where(jnp.abs(z) < 1e-6, 1e-6, z)
    u = cfg.fx * pc[:, 0] / zs + cfg.cx
    v = cfg.fy * pc[:, 1] / zs + cfg.cy
    in_img = (u >= 0) & (u < 2 * cfg.cx) & (v >= 0) & (v < 2 * cfg.cy) & (z > 0.1)
    return jnp.stack([u, v], axis=1), z, in_img


class TrackResult(NamedTuple):
    rot: jnp.ndarray
    t: jnp.ndarray
    obs_mp: jnp.ndarray     # [N] mp id per current-frame keypoint (-1 none)
    n_inliers: jnp.ndarray  # [] int32


# ---------------------------------------------------------------------------
# Initialization (RGB-D / stereo)
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("cfg",))
def stereo_initialization(ms: M.MapState, frame: FrameData, time,
                          cfg: TrackConfig):
    """First KF + map points from depth (Tracking::StereoInitialization).

    Pose = identity. Every valid keypoint with depth becomes a map point.
    """
    feat = frame.feat
    n = feat.capacity
    rot0, t0 = jnp.eye(3), jnp.zeros(3)

    has_depth = frame.depth_kp > 0
    make = feat.valid & has_depth
    # world position: unproject at identity pose
    z = jnp.maximum(frame.depth_kp, 1e-6)
    x = (feat.uv[:, 0] - cfg.cx) / cfg.fx * z
    y = (feat.uv[:, 1] - cfg.cy) / cfg.fy * z
    pos = jnp.stack([x, y, z], axis=1)

    kf_slot = M.free_kf_slot(ms)
    ms, mp_slots = M.free_mp_slots(ms, n, use_mask=make)
    obs_mp = jnp.where(make, mp_slots, M.NO_MP)

    norm = -pos / jnp.maximum(jnp.linalg.norm(pos, axis=1, keepdims=True), 1e-6)
    dist = jnp.linalg.norm(pos, axis=1)
    level_sf = cfg.scale_factor ** feat.level.astype(jnp.float32)
    max_d = dist * level_sf
    min_d = max_d / (cfg.scale_factor ** (cfg.n_levels - 1))

    ms = M.insert_keyframe(
        ms, kf_slot, rot0, t0, jnp.zeros(3), jnp.zeros(6), time,
        feat.uv, feat.level, feat.angle, feat.desc, frame.depth_kp,
        feat.valid, obs_mp, jnp.int32(-1))
    ms = M.add_map_points(ms, mp_slots, pos, feat.desc, norm, min_d, max_d,
                          kf_slot, make)
    n_pts = jnp.sum(make)
    return ms, kf_slot, TrackResult(rot0, t0, obs_mp, n_pts.astype(jnp.int32))


# ---------------------------------------------------------------------------
# Motion-model tracking
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("cfg",))
def track_with_motion_model(ms: M.MapState, frame: FrameData,
                            last_obs_mp: jnp.ndarray,
                            pred_rot, pred_t, cfg: TrackConfig,
                            extra_obs: jnp.ndarray | None = None,
                            last_levels: jnp.ndarray | None = None):
    """Project last frame's map points at the predicted pose and match
    against the current frame, then pose-only GN. `extra_obs` [N] carries
    pre-bound map-point ids (the OF dual-stream appends, of_tracking.py).
    `last_levels` [N] are the last frame's keypoint octaves: the search
    radius is octave-scaled and the octave window centred on them
    (SearchByProjection, /root/reference/src/ORBmatcher.cc:1853+:
    radius = th * mvScaleFactors[nLastOctave], levels [oct-1, oct+1])."""
    feat = frame.feat
    has_mp = last_obs_mp >= 0
    mp_idx = jnp.maximum(last_obs_mp, 0)
    pts_w = ms.mp_pos[mp_idx]
    mp_ok = has_mp & ms.mp_valid[mp_idx]

    uv_proj, z, in_img = _project(pred_rot, pred_t, pts_w, cfg)
    valid_proj = mp_ok & in_img

    if last_levels is None:
        last_levels = jnp.zeros((feat.capacity,), jnp.int32)
    radius = cfg.search_radius_mm * (
        cfg.scale_factor ** last_levels.astype(jnp.float32))
    qdesc = ms.mp_desc[mp_idx]
    m_idx, m_dist = matching.search_by_projection(
        uv_proj, last_levels, valid_proj, qdesc,
        feat.uv, feat.level, feat.desc, feat.valid, radius,
        max_dist=cfg.match_max_dist)

    # Build per-current-keypoint mp assignment (unmatched rows scatter to an
    # out-of-bounds index and are dropped).
    obs_mp = jnp.full((feat.capacity,), M.NO_MP, jnp.int32)
    tgt = jnp.where(m_idx >= 0, m_idx, feat.capacity)
    obs_mp = obs_mp.at[tgt].set(mp_idx.astype(jnp.int32), mode="drop")
    if extra_obs is not None:
        obs_mp = jnp.where(obs_mp == M.NO_MP, extra_obs, obs_mp)

    rot, t, obs_mp, n_inl = _pose_opt_from_obs(ms, frame, obs_mp, pred_rot, pred_t, cfg)
    return TrackResult(rot, t, obs_mp, n_inl)


def _pose_opt_from_obs(ms, frame, obs_mp, rot0, t0, cfg: TrackConfig):
    feat = frame.feat
    has = obs_mp >= 0
    mp_idx = jnp.maximum(obs_mp, 0)
    pts_w = ms.mp_pos[mp_idx]
    valid = has & ms.mp_valid[mp_idx] & feat.valid
    is_stereo = valid & (frame.u_right > 0)
    obs = pose_opt.PoseObs(
        pts_w=pts_w, uv=feat.uv, u_right=frame.u_right,
        is_stereo=is_stereo,
        inv_sigma2=_inv_sigma2(feat.level, cfg.scale_factor),
        valid=valid)
    rot, t, inl, n_inl = pose_opt.pose_optimization(
        rot0, t0, obs, cfg.fx, cfg.fy, cfg.cx, cfg.cy, cfg.bf)
    obs_mp = jnp.where(inl, obs_mp, M.NO_MP)
    return rot, t, obs_mp, n_inl


@partial(jax.jit, static_argnames=("cfg",))
def track_reference_keyframe(ms: M.MapState, frame: FrameData,
                             words_frame, words_kf, ref_kf,
                             rot0, t0, cfg: TrackConfig):
    """Tracking::TrackReferenceKeyFrame (/root/reference/src/Tracking.cc:3106):
    when motion-model tracking fails, match the frame against the reference
    KF's map points gated by BoW word equality (ORBmatcher::SearchByBoW
    visits only same-node features), then pose-only GN from the last pose.

    words_*: vocabulary leaf ids per keypoint (retrieval/vocab.descend)."""
    feat = frame.feat
    kf_obs = ms.kf_obs_mp[ref_kf]
    kf_ok = ms.kf_kp_valid[ref_kf] & (kf_obs >= 0) \
        & ms.mp_valid[jnp.maximum(kf_obs, 0)]
    same_word = (words_frame[:, None] == words_kf[None, :]) \
        & (words_frame >= 0)[:, None] & (words_kf >= 0)[None, :]
    m_idx, m_dist = matching.match_descriptors(
        feat.desc, feat.valid, ms.kf_desc[ref_kf], kf_ok,
        max_dist=matching.TH_LOW, ratio=0.7, mutual=True, mask=same_word)
    # rotation-histogram consistency (SearchByBoW's CheckOrientation)
    m_idx = matching.rotation_consistency(
        feat.angle, ms.kf_angle[ref_kf], m_idx)
    obs_mp = jnp.where(m_idx >= 0, kf_obs[jnp.maximum(m_idx, 0)], M.NO_MP)
    rot, t, obs_mp, n_inl = _pose_opt_from_obs(ms, frame, obs_mp, rot0, t0, cfg)
    return TrackResult(rot, t, obs_mp, n_inl)


# ---------------------------------------------------------------------------
# Local-map tracking
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("cfg",))
def track_local_map(ms: M.MapState, frame: FrameData, obs_mp: jnp.ndarray,
                    rot, t, ref_kf, cfg: TrackConfig, local_masks=None):
    """Search additional local-map points, then pose-only GN over all.

    Also updates map-point visible/found counters (the culling signal).

    `local_masks` = precomputed (kf_mask, mp_mask) from M.local_window —
    the window only changes at map mutations (KF insertion/cull/loop), so
    the host computes it once per KF instead of per frame (the O(K·M)
    incidence + covisibility matmuls dominate per-frame cost at scale)."""
    feat = frame.feat
    if local_masks is None:
        _, _, cand_idx = M.local_window(ms, ref_kf, cfg.local_window,
                                        cfg.lm_max_candidates)
        mp_mask = None
    else:
        _, mp_mask, cand_idx = local_masks

    # per-frame work touches ONLY the compacted candidate subset [C] —
    # the O(M) window compaction ran once per map mutation (M.local_window)
    cand_valid = ms.mp_valid[cand_idx]
    if mp_mask is not None:
        cand_valid = cand_valid & mp_mask[cand_idx]
    pos_c = ms.mp_pos[cand_idx]
    uv_proj, z, in_img = _project(rot, t, pos_c, cfg)
    # skip points already matched in this frame
    already = jnp.zeros((ms.m_max,), bool).at[jnp.maximum(obs_mp, 0)].set(obs_mp >= 0)
    cand = cand_valid & in_img & ~already[cand_idx]

    # frustum gates (Frame::isInFrustum, /root/reference/src/Frame.cc:876):
    # distance within the point's scale-invariance band and viewing
    # direction within 60 deg of the stored normal (viewingCosLimit=0.5)
    cam_center = -(rot.T @ t)
    dvec = pos_c - cam_center
    dist = jnp.linalg.norm(dvec, axis=1)
    min_d_c = ms.mp_min_dist[cand_idx]
    max_d_c = ms.mp_max_dist[cand_idx]
    scale_ok = (dist > 0.8 * min_d_c) & (dist < 1.2 * max_d_c)
    cand = cand & (scale_ok | (max_d_c <= 0))
    view = dvec / jnp.maximum(dist, 1e-6)[:, None]
    normal_c = ms.mp_normal[cand_idx]
    vcos = jnp.sum(view * normal_c, axis=1)
    has_normal = jnp.sum(normal_c ** 2, axis=1) > 0.25
    cand = cand & ((vcos > 0.5) | ~has_normal)

    # predicted octave from distance (MapPoint::PredictScale)
    log_sf = jnp.log(jnp.float32(cfg.scale_factor))
    ratio_d = jnp.maximum(max_d_c, 1e-6) / jnp.maximum(dist, 1e-6)
    level_pred = jnp.clip(jnp.ceil(jnp.log(ratio_d) / log_sf),
                          0, cfg.n_levels - 1).astype(jnp.int32)

    # radius by viewing cos (SearchLocalPoints: 2.5 px head-on, 4.0 px
    # oblique), octave-scaled; search_radius_lm is the th multiplier (=5 ->
    # the reference's 2.5/4.0 at level 0)
    r_view = jnp.where(vcos >= 0.998, 0.5, 0.8)
    radius = (cfg.search_radius_lm * r_view
              * cfg.scale_factor ** level_pred.astype(jnp.float32))
    m_idx, m_dist = matching.search_by_projection(
        uv_proj, level_pred, cand, ms.mp_desc[cand_idx],
        feat.uv, feat.level, feat.desc,
        feat.valid & ~(obs_mp >= 0),  # unmatched slots only
        radius, max_dist=matching.TH_HIGH)

    # visible counter: candidates in frustum
    visible_add = jnp.zeros((ms.m_max,)).at[cand_idx].add(
        cand.astype(jnp.float32), mode="drop")
    tgt = jnp.where(m_idx >= 0, m_idx, feat.capacity)
    new_obs = obs_mp.at[tgt].set(cand_idx.astype(jnp.int32), mode="drop")
    # keep pre-existing assignments where present
    new_obs = jnp.where(obs_mp >= 0, obs_mp, new_obs)

    rot2, t2, final_obs, n_inl = _pose_opt_from_obs(ms, frame, new_obs, rot, t, cfg)

    found_add = jnp.zeros((ms.m_max,))
    found_add = found_add.at[jnp.maximum(final_obs, 0)].add(
        (final_obs >= 0).astype(jnp.float32), mode="drop")
    ms = ms._replace(
        mp_visible=ms.mp_visible + visible_add + found_add,
        mp_found=ms.mp_found + found_add,
    )
    return ms, TrackResult(rot2, t2, final_obs, n_inl)


@partial(jax.jit, static_argnames=("cfg",))
def mean_reproj_error(ms: M.MapState, frame: FrameData, obs_mp, rot, t,
                      cfg: TrackConfig):
    """Mean pixel reprojection error over the frame's bound map points
    (the reference's per-frame mFrame2FrameReprojErr / mFrame2MapReprojErr
    bookkeeping, /root/reference/src/Tracking.cc:2468-2526)."""
    feat = frame.feat
    has = (obs_mp >= 0) & feat.valid & ms.mp_valid[jnp.maximum(obs_mp, 0)]
    pts = ms.mp_pos[jnp.maximum(obs_mp, 0)]
    uv, z, in_img = _project(rot, t, pts, cfg)
    err = jnp.linalg.norm(uv - feat.uv, axis=1)
    ok = has & (z > 0.1)
    return jnp.sum(jnp.where(ok, err, 0.0)) / jnp.maximum(
        jnp.sum(ok.astype(jnp.float32)), 1.0)


# ---------------------------------------------------------------------------
# Fused per-frame step (bench / low-latency path)
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("cfg", "fcfg"))
def fused_track_step(gray, depth, ms: M.MapState, last_obs_mp,
                     pred_rot, pred_t, ref_kf, cfg: TrackConfig, fcfg,
                     local_masks=None):
    """One dispatch for the whole per-frame hot path: frame build +
    motion-model tracking + local-map tracking. Eliminates the per-call
    dispatch floors between the three stages and lets XLA overlap the
    stages' memory traffic.

    Returns (frame, TrackResult, updated MapState)."""
    from geoflowslam.state.frame import build_frame

    frame = build_frame(gray, depth, fcfg, cfg.fx, cfg.fy, cfg.cx, cfg.cy)
    res = track_with_motion_model.__wrapped__(
        ms, frame, last_obs_mp, pred_rot, pred_t, cfg)
    ms2, res2 = track_local_map.__wrapped__(
        ms, frame, res.obs_mp, res.rot, res.t, ref_kf, cfg,
        local_masks=local_masks)
    return frame, res2, ms2


# ---------------------------------------------------------------------------
# Keyframe creation (RGB-D)
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("cfg",))
def create_keyframe(ms: M.MapState, frame: FrameData, rot, t, time,
                    obs_mp: jnp.ndarray, prev_kf, cfg: TrackConfig,
                    kf_slot=None):
    """Insert a KF; create new close-depth map points for unmatched keypoints
    (Tracking::CreateNewKeyFrame RGB-D branch, src/Tracking.cc:4168-4285).
    `kf_slot` may be supplied by the host (it mirrors slot occupancy and can
    pick the slot without a device round-trip); defaults to free_kf_slot."""
    feat = frame.feat
    if kf_slot is None:
        kf_slot = M.free_kf_slot(ms)

    depth_ok = (frame.depth_kp < cfg.close_depth) if cfg.close_depth > 0 \
        else jnp.ones_like(frame.depth_kp, bool)
    make = (feat.valid & (obs_mp == M.NO_MP) & (frame.depth_kp > 0) & depth_ok)
    # cap the number of new points: keep closest ones first (reference sorts
    # by depth and caps at 100 far ones; we cap total)
    order_key = jnp.where(make, frame.depth_kp, jnp.inf)
    _, order = jax.lax.top_k(-order_key, min(cfg.max_new_mp_per_kf, feat.capacity))
    sel_mask = jnp.zeros((feat.capacity,), bool).at[order].set(True)
    make = make & sel_mask

    rot_wc = rot.T
    cam_center = -rot_wc @ t
    z = jnp.maximum(frame.depth_kp, 1e-6)
    x = (feat.uv[:, 0] - cfg.cx) / cfg.fx * z
    y = (feat.uv[:, 1] - cfg.cy) / cfg.fy * z
    pos_c = jnp.stack([x, y, z], axis=1)
    pos_w = pos_c @ rot_wc.T + cam_center

    ms, mp_slots = M.free_mp_slots(ms, feat.capacity, use_mask=make)
    new_ids = jnp.where(make, mp_slots, M.NO_MP)
    obs_all = jnp.where(make, new_ids, obs_mp)

    d = pos_w - cam_center
    dist = jnp.linalg.norm(d, axis=1)
    norm = d / jnp.maximum(dist[:, None], 1e-6)
    level_sf = cfg.scale_factor ** feat.level.astype(jnp.float32)
    max_d = dist * level_sf
    min_d = max_d / (cfg.scale_factor ** (cfg.n_levels - 1))

    ms = M.insert_keyframe(
        ms, kf_slot, rot, t, jnp.zeros(3), jnp.zeros(6), time,
        feat.uv, feat.level, feat.angle, feat.desc, frame.depth_kp,
        feat.valid, obs_all, prev_kf)
    ms = M.add_map_points(ms, mp_slots, pos_w, feat.desc, norm, min_d, max_d,
                          kf_slot, make)
    return ms, kf_slot, jnp.sum(make).astype(jnp.int32)
