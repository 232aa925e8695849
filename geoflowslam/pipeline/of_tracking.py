"""Dual-stream optical-flow tracking (the GeoFlow-SLAM headline feature).

JAX re-expression of ORBmatcher::SearchByProjectionWithOF
(/root/reference/src/ORBmatcher.cc:2303-2497) + Tracking::EstimatePoseByOF
(src/Tracking.cc:1943) + Frame::AddPts (src/Frame.cc:625):

* 3D-prior stream: keypoints of the last frame bound to map points are
  LK-tracked into the current frame with their *projected* positions (at the
  predicted pose) as initial guesses, over the fine pyramid levels
  (:2379-2440). Survivors are gated by fundamental-matrix RANSAC and appended
  to the current frame's reserved OF keypoint slots, carrying their map-point
  association — giving the pose optimizer dense frame-to-map constraints even
  when descriptor matching fails (fast motion / blur).
* 2D stream: all last-frame keypoints are forward/backward LK-tracked over
  the full pyramid (:2443-2493), F-gated, spatially de-duplicated against
  existing keypoints (isPointNearby/updateMask :2296, MASK_THRESHOLD), and
  appended as fresh keypoints (descriptors inherited from the last frame) so
  feature coverage survives between ORB re-detections.

Both streams are fixed-shape: the FrameData feature set reserves
`n_of_slots` padded slots that this stage fills in place.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from geoflowslam.ops import klt as K
from geoflowslam.ops import ransac
from geoflowslam.state import map_state as M
from geoflowslam.state.frame import FrameData
from geoflowslam.pipeline.tracking import TrackConfig, _project


@dataclasses.dataclass(frozen=True)
class OFConfig:
    lk_win: int = 21             # LKWindowSize
    lk_iters: int = 10
    levels_3d: int = 3           # prior stream: fine levels only
    levels_2d: int = 6           # 2D stream: full pyramid (capped by frame)
    fb_thresh: float = 0.5       # max_fbklt_dist (ORBmatcher.cc:2380) —
                                 # BOTH streams are forward-backward gated
    f_ransac_hyp: int = 64
    f_sigma: float = 1.0         # 3D stream; 2D uses 0.5x (:2466)
    mask_radius: float = 8.0     # MASK_THRESHOLD spatial dedup
    min_eig: float = 1e-4


@partial(jax.jit, static_argnames=("cfg", "ofcfg", "n_of_slots"))
def of_dual_stream(ms: M.MapState, last_frame: FrameData, cur_frame: FrameData,
                   last_obs_mp: jnp.ndarray, pred_rot, pred_t, key,
                   cfg: TrackConfig, ofcfg: OFConfig, n_of_slots: int):
    """Fill cur_frame's last `n_of_slots` keypoint slots from the two
    streams (sources: ALL of the last frame's valid keypoints, including
    previously appended OF points — track_feature_pts_ continuity).

    Returns (cur_frame with filled slots, obs_mp_extra [N_total] with map
    point ids for the appended 3D-stream slots, n_3d, n_2d).
    """
    lf, cf = last_frame.feat, cur_frame.feat
    n_base = cf.capacity - n_of_slots
    pyr_prev = last_frame.lk_pyramid
    pyr_next = cur_frame.lk_pyramid
    lv3 = min(ofcfg.levels_3d, len(pyr_prev))
    lv2 = min(ofcfg.levels_2d, len(pyr_prev))

    # ----- 3D-prior stream ------------------------------------------------
    has_mp = last_obs_mp >= 0
    mp_idx = jnp.maximum(last_obs_mp, 0)
    mp_ok = has_mp & ms.mp_valid[mp_idx]
    uv_proj, z, in_img = _project(pred_rot, pred_t, ms.mp_pos[mp_idx], cfg)
    guess = jnp.where((mp_ok & in_img)[:, None], uv_proj, lf.uv)

    # forward-backward gated like the reference's fbKltTracking call for
    # the prior stream (ORBmatcher.cc:2383-2386, max_fbklt_dist=0.5): a
    # plain forward LK lets drifting tracks carry their MAP-POINT binding
    # into the pose solve — measured as an ATE regression, not a rescue
    r3 = K.fb_klt_track(pyr_prev, pyr_next, lf.uv, guess,
                        fb_thresh=ofcfg.fb_thresh, win=ofcfg.lk_win,
                        iters=ofcfg.lk_iters, min_eig=ofcfg.min_eig,
                        max_levels=lv3)
    ok3 = r3.status & mp_ok & lf.valid

    k1, k2 = jax.random.split(key)
    fres3 = ransac.ransac_fundamental(k1, lf.uv, r3.pts, ok3,
                                      n_hyp=ofcfg.f_ransac_hyp,
                                      sigma=ofcfg.f_sigma)
    ok3 = ok3 & fres3.inliers

    # ----- 2D stream ------------------------------------------------------
    r2 = K.fb_klt_track(pyr_prev, pyr_next, lf.uv, None,
                        fb_thresh=ofcfg.fb_thresh, win=ofcfg.lk_win,
                        iters=ofcfg.lk_iters, min_eig=ofcfg.min_eig,
                        max_levels=lv2)
    ok2 = r2.status & lf.valid & ~ok3          # 3D stream takes precedence
    # tighter F gate for descriptor-less 2D tracks (F_THRESHOLD*0.5,
    # ORBmatcher.cc:2466)
    fres2 = ransac.ransac_fundamental(k2, lf.uv, r2.pts, ok2,
                                      n_hyp=ofcfg.f_ransac_hyp,
                                      sigma=0.5 * ofcfg.f_sigma)
    ok2 = ok2 & fres2.inliers

    # ----- spatial dedup mask (isPointNearby over a coarse grid) ----------
    cell = ofcfg.mask_radius
    gw = int(2 * cfg.cx / cell) + 2
    gh = int(2 * cfg.cy / cell) + 2

    def cells_of(uv, valid):
        cxs = jnp.clip((uv[:, 0] / cell).astype(jnp.int32), 0, gw - 1)
        cys = jnp.clip((uv[:, 1] / cell).astype(jnp.int32), 0, gh - 1)
        flat = cys * gw + cxs
        return jnp.where(valid, flat, gw * gh)

    occ = jnp.zeros((gw * gh + 1,), bool)
    occ = occ.at[cells_of(cf.uv, cf.valid)].set(True, mode="drop")
    c3 = cells_of(r3.pts, ok3)
    ok3 = ok3 & ~occ[jnp.minimum(c3, gw * gh - 1)]
    occ = occ.at[jnp.where(ok3, c3, gw * gh)].set(True, mode="drop")
    c2 = cells_of(r2.pts, ok2)
    ok2 = ok2 & ~occ[jnp.minimum(c2, gw * gh - 1)]

    # ----- append into the reserved OF slots ------------------------------
    n_slots = n_of_slots
    # priority: 3D-stream survivors first, then 2D
    pri = jnp.where(ok3, 2.0, jnp.where(ok2, 1.0, 0.0)) \
        - 1e-6 * jnp.arange(lf.capacity, dtype=jnp.float32)
    order = jnp.argsort(-pri)[:n_slots]               # source kp indices
    src_ok3 = ok3[order]
    src_ok2 = ok2[order]
    any_ok = src_ok3 | src_ok2
    new_uv = jnp.where(src_ok3[:, None], r3.pts[order],
                       jnp.where(src_ok2[:, None], r2.pts[order], 0.0))

    slot_idx = jnp.arange(n_base, n_base + n_slots)
    feat = cf
    uv_full = feat.uv.at[slot_idx].set(new_uv)
    # descriptors: 3D-stream points inherit the MAP POINT's distinctive
    # descriptor (Frame::AddPts copies mp->GetDescriptor(), Frame.cc:634);
    # 2D-stream points keep the persistent track descriptor from the last
    # frame — a fresher source than re-BRIEFing a drifting patch
    desc_src = jnp.where(src_ok3[:, None],
                         ms.mp_desc[mp_idx[order]].astype(lf.desc.dtype),
                         lf.desc[order])
    desc_full = feat.desc.at[slot_idx].set(desc_src)
    angle_full = feat.angle.at[slot_idx].set(lf.angle[order])
    level_full = feat.level.at[slot_idx].set(lf.level[order])
    resp_full = feat.response.at[slot_idx].set(lf.response[order])
    valid_full = feat.valid.at[slot_idx].set(any_ok)
    feat = feat._replace(uv=uv_full, desc=desc_full, angle=angle_full,
                         level=level_full, response=resp_full, valid=valid_full)

    # map-point binding for appended 3D-stream slots
    obs_extra = jnp.full((cf.capacity,), M.NO_MP, jnp.int32)
    obs_extra = obs_extra.at[slot_idx].set(
        jnp.where(src_ok3, last_obs_mp[order], M.NO_MP))

    # per-slot INNOVATION of the 3D-prior stream: distance between where
    # the track landed and its init (the map-point projection at the
    # PREDICTED pose). A track that stayed at its init carries no pose
    # information beyond the prediction itself — on texture-poor frames
    # these "confirmations" dominate, and a health gate that counts them
    # keeps a drifting prediction alive forever (frame_step discounts
    # them; 2D-stream slots carry no map binding and are marked 1e9).
    innov3 = jnp.linalg.norm(r3.pts - guess, axis=1)
    of_innov = jnp.full((cf.capacity,), 1e9, jnp.float32)
    of_innov = of_innov.at[slot_idx].set(
        jnp.where(src_ok3, innov3[order], 1e9))

    # depth for appended slots: sample the retained depth image at the
    # tracked position (Frame::AddPts, /root/reference/src/Frame.cc:625-674),
    # making OF points full stereo observations instead of mono-only.
    cur2 = cur_frame._replace(feat=feat)
    if cur_frame.depth_img is not None:
        dimg = cur_frame.depth_img
        hh, ww = dimg.shape
        xi = jnp.clip(jnp.round(new_uv[:, 0]).astype(jnp.int32), 0, ww - 1)
        yi = jnp.clip(jnp.round(new_uv[:, 1]).astype(jnp.int32), 0, hh - 1)
        d_of = dimg[yi, xi]
        d_of = jnp.where(any_ok & (d_of > 0), d_of, -1.0)
        ur_of = jnp.where(d_of > 0,
                          new_uv[:, 0] - cfg.bf / jnp.maximum(d_of, 1e-6),
                          -1.0)
        cur2 = cur2._replace(
            depth_kp=cur2.depth_kp.at[slot_idx].set(d_of),
            u_right=cur2.u_right.at[slot_idx].set(ur_of))
    return (cur2, obs_extra, jnp.sum(src_ok3), jnp.sum(src_ok2 & any_ok),
            of_innov)
