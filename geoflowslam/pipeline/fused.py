"""Single-dispatch production frame step.

The reference hides its per-frame latency in threads; the answer here
(SURVEY §7: "minimize host-device syncs — single fused step, scalar outputs
only") is to compile the WHOLE per-frame pipeline into one XLA program:

    IMU preintegration -> state prediction (IMU or motion model)
    -> frame build (CLAHE + pyramid + FAST + rBRIEF + depth)
    -> motion-model projection tracking -> local-map tracking
    -> VI pose refinement (LastKeyFrame / LastFrame-joint variants)
    -> acceptance gating + motion-model update + body-state update

One device dispatch + one scalar read-back per frame, instead of the staged
path's ~8 dispatches and ~4 blocking reads; it also lets XLA overlap stage
memory traffic. The host keeps only the branchy recovery logic (fallback searches,
relocalization, KF policy), which it enters only when the returned inlier
count is low (rare).

Mirrors Tracking::Track's hot path (/root/reference/src/Tracking.cc:2042):
PreintegrateIMU :1724, PredictStateIMU :1876, TrackWithMotionModel :3466,
TrackLocalMap :3729, PoseInertialOptimizationLastFrame/KeyFrame.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from geoflowslam.math import lie
from geoflowslam.imu import preintegration as pre
from geoflowslam.solvers import inertial as VI
from geoflowslam.solvers import pose_opt as PO
from geoflowslam.state import map_state as M
from geoflowslam.state.frame import build_frame
from geoflowslam.pipeline import tracking as T


class FusedOut(NamedTuple):
    frame: object            # FrameData (for host fallbacks / KF insertion)
    rot: jnp.ndarray         # final Tcw
    t: jnp.ndarray
    obs_mp: jnp.ndarray      # [N] final per-keypoint map-point binding
    ms: object               # MapState with updated found/visible counters
    vel_rot: jnp.ndarray     # updated motion model Tcl
    vel_t: jnp.ndarray
    p_frame: Optional[object]    # frame-gap preintegration (imu modes)
    body: Optional[object]       # updated BodyState (imu init modes)
    marg: Optional[jnp.ndarray]  # marginal info for the next frame's prior
    scalars: jnp.ndarray     # [4] int32: n_mm, n_lm, n_vi, vi_accepted
    twc: jnp.ndarray         # [3,4] camera-to-world (trajectory recording)
    trel: jnp.ndarray        # [3,4] T_cr = Tcw ∘ Trw^-1 vs the ref KF —
                             # the reference's mlRelativeFramePoses
                             # (SaveTrajectoryTUM rebasing, System.cc:994+)
    bias_out: Optional[jnp.ndarray]  # [6] updated (bg, ba) in imu modes
    host_pkt: jnp.ndarray    # [35] f32: scalars(4) + twc(12) + trel(12) +
                             # bias(6) + aux(1: ICP-carried flag) packed
                             # into ONE array (kept for the flush path and
                             # tests)
    of_counts: object        # [2] int32 (n_3d, n_2d) appended OF points,
                             # or None when the OF stage is off (a None
                             # leaf keeps non-OF HLO byte-identical)
    pkt_window: jnp.ndarray  # [W,35] rolling window of the last W frames'
                             # [seq, host_pkt] rows. The host decision loop
                             # reads SNAPSHOTS of this ring from a side
                             # thread and processes unseen rows by seq: a
                             # blocking read waits for the queued frames,
                             # so decisions self-pace instead of stalling
                             # the dispatch loop (LocalMapping-queue parity)


PKT_WINDOW = 64     # ring rows; must exceed frames dispatched per read
PKT_ROW = 36        # 1 seq + 4 scalars + 12 twc + 12 trel + 6 bias + 1 aux
                    # aux: 1.0 when the frame was ICP-carried (registration
                    # held the pose through a visual-inlier collapse)


def _tree_where(c, a, b):
    return jax.tree_util.tree_map(
        lambda x, y: jnp.where(
            jnp.reshape(c, (1,) * x.ndim) if x.ndim else c, x, y), a, b)


@partial(jax.jit, static_argnames=("cfg", "fcfg", "imu_mode", "min_inliers",
                                   "use_of", "use_icp", "icp_method",
                                   "icp_min_inliers", "n_of_slots", "ofcfg",
                                   "use_lidar", "lidar_cfg", "with_recovery",
                                   "reloc_kl"))
def frame_step(gray, depth, ms: M.MapState, last_obs_mp, last_levels,
               vel_rot, vel_t, use_vel, cur_rot, cur_t, ref_kf, local_masks,
               acc, gyro, dts, body, bias, prior_info, r_cb, t_cb, calib,
               cfg: T.TrackConfig, fcfg, imu_mode: str, min_inliers: int,
               pkt_window=None, seq=None, last_frame=None,
               use_of: bool = False, use_icp: bool = False,
               icp_method: str = "gicp", icp_min_inliers: int = 200,
               n_of_slots: int = 0, ofcfg=None,
               use_lidar: bool = False, lidar_map=None, lidar_cfg=None,
               with_recovery: bool = False, reloc_vocab=None,
               reloc_db=None, reloc_kl=None):
    """One fused frame. imu_mode:
      "off"   — visual only (acc/gyro/body/... may be None)
      "raw"   — IMU present but uninitialized: preintegrate only
      "kf"    — IMU initialized, last state map-anchored
                (PoseInertialOptimizationLastKeyFrame; returns the marginal)
      "prior" — frame-to-frame joint solve with the marginalized prior
                (PoseInertialOptimizationLastFrame)

    GeoFlow robustness stages fused into the SAME dispatch when enabled
    (round-2 VERDICT: `_can_fuse` used to exclude them, dropping hard
    sequences to the staged path's per-frame sync costs):
      use_icp — GICP/NDT registration of the depth clouds as a pose
        predictor (PredictStateICP/NDT, /root/reference/src/Tracking.cc:
        3365-3465), gated on-device by `icp_min_inliers` (:3394).
      use_of  — dual-stream LK optical flow appending tracked keypoints
        (3D prior stream carries map-point bindings) into the frame's
        reserved OF slots (SearchByProjectionWithOF, src/ORBmatcher.cc:
        2303; Frame::AddPts, src/Frame.cc:625).
    Both need `last_frame` (the previous FusedOut.frame, chained on
    device); with `last_frame=None` they are statically skipped.

    with_recovery=True compiles the RECOVERY variant (round-4 VERDICT
    "frame-rate degraded mode"): when the health gate fails, a fused
    relocalization (pipeline/reloc.reloc_core — BoW retrieval over
    `reloc_db`, PnP RANSAC, pose GN over the top-3 candidates) runs INSIDE
    the dispatch under a lax.cond, and the relocalized pose/bindings are
    adopted ON DEVICE — the pipelined chain self-heals without a host sync
    (the reference runs Relocalization in-line at camera rate,
    src/Tracking.cc:4537). The host learns via the packet aux slot
    (2.0 + candidate slot).
    """
    # ---- IMU preintegration + prediction ---------------------------------
    p_frame = None
    if imu_mode != "off":
        p_frame = pre.preintegrate(acc, gyro, dts, bias, calib)
    if imu_mode in ("kf", "prior"):
        r_wb2, p2, v2 = pre.predict_state(body.r_wb, body.p, body.v,
                                          p_frame, bias)
        pred_body = VI.BodyState(r_wb=r_wb2, p=p2, v=v2,
                                 bg=bias[:3], ba=bias[3:])
        pr, pt = VI.cam_pose_from_body(pred_body, r_cb, t_cb)
    else:
        pred_body = None
        vr, vt = lie.se3_compose(vel_rot, vel_t, cur_rot, cur_t)
        pr = jnp.where(use_vel, vr, cur_rot)
        pt = jnp.where(use_vel, vt, cur_t)

    # ---- frame build + visual tracking -----------------------------------
    frame = build_frame(gray, depth, fcfg, cfg.fx, cfg.fy, cfg.cx, cfg.cy)

    # ---- GICP/NDT pose predictor (PredictStateICP, Tracking.cc:3365) -----
    icp_held = jnp.zeros((), bool)   # registration converged this frame
    if use_icp and last_frame is not None and frame.cloud is not None:
        from geoflowslam.ops import gicp as G
        # init: T_lc = T_lw ∘ T_cw_pred^-1 (cur_* is the last frame's pose)
        pri_i, pti_i = lie.se3_inverse(pr, pt)
        r0, t0 = lie.se3_compose(cur_rot, cur_t, pri_i, pti_i)
        reg_fn = G.ndt_register if icp_method == "ndt" else G.gicp_register
        reg = reg_fn(frame.cloud, frame.cloud_valid,
                     last_frame.cloud, last_frame.cloud_valid,
                     init_rot=r0, init_t=t0)
        # PredictStateICP accepts only converged registrations with enough
        # inliers (Tracking.cc:3394: result.converged && num_inliers > 200)
        # PLAUSIBILITY bound on the measured frame-to-frame motion: on
        # degenerate geometry (blank wall -> planar cloud) GICP "converges"
        # onto whatever the velocity init proposed (in-plane motion is
        # unobservable), and an unbounded delta learned back into the
        # motion model compounds exponentially (round-5 hard run: 113 m
        # ATE from a 100 m/s runaway). The reference never accepts ICP
        # deltas beyond camera-rate physics either — its predictor feeds a
        # visually-gated track (Tracking.cc:3394 onward).
        dt_mag = jnp.linalg.norm(reg.t)
        dr_cos = 0.5 * (jnp.trace(reg.rot) - 1.0)
        plaus = (dt_mag < 0.5) & (dr_cos > 0.94)      # <0.5 m, <~20deg/frame
        icp_ok = reg.converged & (reg.n_inliers >= icp_min_inliers) & plaus
        # T_cw = T_lc^-1 ∘ T_lw
        rri, rti = lie.se3_inverse(reg.rot, reg.t)
        r_icp, t_icp = lie.se3_compose(rri, rti, cur_rot, cur_t)
        pr = jnp.where(icp_ok, r_icp, pr)
        pt = jnp.where(icp_ok, t_icp, pt)
        icp_held = icp_ok

    # ---- dual-stream OF append (SearchByProjectionWithOF) ----------------
    # of_counts stays None unless the OF stage runs: a None leaf adds no HLO
    # output, so non-OF configs keep their exact pre-OF compiled program
    # (warm persistent-cache hits).
    extra_obs = None
    of_counts = None
    of_innov = None
    if use_of and last_frame is not None and n_of_slots > 0:
        from geoflowslam.pipeline import of_tracking as OF
        key = jax.random.PRNGKey(
            jnp.asarray(0.0 if seq is None else seq).astype(jnp.int32))
        frame, extra_obs, n3d, n2d, of_innov = OF.of_dual_stream.__wrapped__(
            ms, last_frame, frame, last_obs_mp, pr, pt, key, cfg,
            OF.OFConfig() if ofcfg is None else ofcfg, n_of_slots)
        of_counts = jnp.stack([n3d, n2d]).astype(jnp.int32)

    res = T.track_with_motion_model.__wrapped__(
        ms, frame, last_obs_mp, pr, pt, cfg, extra_obs=extra_obs,
        last_levels=last_levels)
    ms2, res2 = T.track_local_map.__wrapped__(
        ms, frame, res.obs_mp, res.rot, res.t, ref_kf, cfg,
        local_masks=local_masks)
    # Health count with OF-confirmation discount: OF-slot inliers whose
    # track never moved off its predicted init (innovation < 1 px) are
    # "confirmations" — self-consistent with ANY prediction on degenerate
    # texture, they sustained a 20 m/s pose runaway for 150 frames. They
    # still feed the pose optimizer (real information when the prediction
    # is right), but tracking HEALTH requires evidence the prediction was
    # actually tested: descriptor-matched inliers, or OF tracks that moved.
    if of_innov is not None:
        confirm = (of_innov < 1.0) & (res2.obs_mp >= 0)
        n_health = (res2.n_inliers
                    - jnp.sum(confirm).astype(res2.n_inliers.dtype))
        res2 = res2._replace(n_inliers=n_health)

    # ---- lidar point-to-plane joint refine (PoseLidarVisualOptimization,
    # /root/reference/src/Optimizer.cc:8338-8421: reprojection +
    # EdgeLidarPoint2Plane factors against the sliding local cloud map) ----
    # Fused like OF/ICP: an empty local map yields zero valid plane factors,
    # so the stage is self-gating on device — the flagship G1 combo
    # (OF + ICP + lidar, g1_op_icp_lidar_indoor1.yaml) stays one dispatch.
    if use_lidar and lidar_map is not None and frame.cloud is not None:
        from geoflowslam.pipeline import lidar_mapping as LD
        pl = LD.make_plane_obs.__wrapped__(
            lidar_map, frame.cloud, frame.cloud_valid, res2.rot, res2.t,
            lidar_cfg)
        has_l = res2.obs_mp >= 0
        mp_l = jnp.maximum(res2.obs_mp, 0)
        feat_l = frame.feat
        val_l = has_l & ms2.mp_valid[mp_l] & feat_l.valid
        obs_l = PO.PoseObs(
            pts_w=ms2.mp_pos[mp_l], uv=feat_l.uv, u_right=frame.u_right,
            is_stereo=val_l & (frame.u_right > 0),
            inv_sigma2=1.0 / (cfg.scale_factor
                              ** feat_l.level.astype(jnp.float32)) ** 2,
            valid=val_l)
        rot_l, t_l, inl_l, n_l = PO.pose_optimization(
            res2.rot, res2.t, obs_l, cfg.fx, cfg.fy, cfg.cx, cfg.cy,
            cfg.bf, plane_obs=pl, rounds=2, iters_per_round=5)
        res2 = T.TrackResult(rot=rot_l, t=t_l,
                             obs_mp=jnp.where(inl_l, res2.obs_mp, -1),
                             n_inliers=n_l)

    # ---- VI refinement + acceptance --------------------------------------
    rot_f, t_f, obs_f = res2.rot, res2.t, res2.obs_mp
    n_vi = jnp.int32(-1)
    accept = jnp.zeros((), bool)
    body_out = None
    marg = None
    if imu_mode in ("kf", "prior"):
        s1 = body

        def body_from_cam(rot_cw, t_cw, v):
            # InertialTracker.body_from_cam: T_wb = T_wc ∘ T_cb
            r_wc = rot_cw.T
            return VI.BodyState(r_wb=r_wc @ r_cb, p=r_wc @ (t_cb - t_cw),
                                v=v, bg=bias[:3], ba=bias[3:])

        # body state at the visually-optimized pose, IMU-predicted velocity
        s2_vis = body_from_cam(res2.rot, res2.t, pred_body.v)
        has = res2.obs_mp >= 0
        mp_idx = jnp.maximum(res2.obs_mp, 0)
        feat = frame.feat
        valid = has & ms2.mp_valid[mp_idx] & feat.valid
        obs = PO.PoseObs(
            pts_w=ms2.mp_pos[mp_idx], uv=feat.uv, u_right=frame.u_right,
            is_stereo=valid & (frame.u_right > 0),
            inv_sigma2=1.0 / (cfg.scale_factor
                              ** feat.level.astype(jnp.float32)) ** 2,
            valid=valid)
        if imu_mode == "kf":
            s2, inl, n_vi, marg = VI.inertial_pose_optimization(
                s2_vis, s1, p_frame, obs, r_cb, t_cb,
                cfg.fx, cfg.fy, cfg.cx, cfg.cy, cfg.bf, calib=calib,
                rounds=2, iters=6, return_info=True)
        else:
            s2, inl, n_vi, marg = VI.inertial_pose_optimization_joint(
                s2_vis, s1, prior_info, p_frame, obs, r_cb, t_cb,
                cfg.fx, cfg.fy, cfg.cx, cfg.cy, cfg.bf, rounds=2, iters=6)
        rot_vi, t_vi = VI.cam_pose_from_body(s2, r_cb, t_cb)
        n2i = res2.n_inliers
        accept = (n_vi >= jnp.maximum(jnp.int32(min_inliers),
                                      (n2i.astype(jnp.float32) * 0.5)
                                      .astype(jnp.int32)))
        rot_f = jnp.where(accept, rot_vi, res2.rot)
        t_f = jnp.where(accept, t_vi, res2.t)
        obs_f = jnp.where(accept, jnp.where(inl, res2.obs_mp, -1),
                          res2.obs_mp)
        # body state: accepted VI state, else re-derived from the visual
        # pose with finite-difference velocity (_update_body_state parity)
        p_vis = rot_f.T @ (t_cb - t_f)
        dt_g = jnp.maximum(p_frame.dt, 1e-4)
        v_fd = (p_vis - s1.p) / dt_g
        body_vis = body_from_cam(rot_f, t_f, v_fd)
        body_out = _tree_where(accept, s2, body_vis)

    # ---- on-device health gate ------------------------------------------
    # A failed frame (inlier collapse) must NOT poison the device-resident
    # chained state: the host only learns about the failure a read-batch
    # later, and every frame dispatched meanwhile would track from the
    # garbage pose. Carry the PREDICTED state instead (IMU dead-reckoning /
    # motion-model extrapolation — the reference's RECENTLY_LOST
    # PredictStateIMU behavior, src/Tracking.cc:2480) and keep the map
    # untouched; the host's staged recovery still runs at drain time using
    # the true inlier counts in the packet.
    n_eff = jnp.where(accept, n_vi, res2.n_inliers) \
        if imu_mode in ("kf", "prior") else res2.n_inliers
    ok_frame = n_eff >= min_inliers
    # ICP-carried frame (TrackWithMotionModelICP, Tracking.cc:3576-3623):
    # visual inliers collapsed but the depth registration converged — the
    # ICP-predicted pose (already in pr/pt) IS the track. Flagged to the
    # host via the packet's aux slot so it keeps state OK instead of
    # entering staged recovery (each staged frame makes several blocking
    # reads; the reference rides ICP through texture loss without ever
    # going RECENTLY_LOST).
    carried = icp_held & ~ok_frame
    # Failure pose: ICP-carried frames ride the registered pose (pr/pt);
    # IMU-backed frames dead-reckon the preintegrated prediction
    # (PredictStateIMU, src/Tracking.cc:2480). Visual-only failures HOLD
    # the last pose instead of advancing the motion model — the reference
    # relocalizes RECENTLY_LOST frames from the last known pose, it never
    # integrates an unmeasured velocity (a held motion model walks away
    # linearly and poisons every wide-radius re-search).
    dead_reckon = carried | (imu_mode in ("kf", "prior"))
    pf_r = jnp.where(dead_reckon, pr, cur_rot)
    pf_t = jnp.where(dead_reckon, pt, cur_t)
    rot_f = jnp.where(ok_frame, rot_f, pf_r)
    t_f = jnp.where(ok_frame, t_f, pf_t)
    obs_f = jnp.where(ok_frame, obs_f, last_obs_mp)
    # (fields track_local_map didn't touch are the same tensor; XLA folds
    # select(c, x, x) — only genuinely-updated arrays pay for the gate)
    ms2 = jax.tree_util.tree_map(lambda a, b: jnp.where(ok_frame, a, b),
                                 ms2, ms)
    if body_out is not None:
        body_out = _tree_where(ok_frame, body_out, pred_body)

    # ---- fused relocalization (recovery variant only) ---------------------
    relocd = None
    if with_recovery and reloc_vocab is not None and reloc_db is not None:
        from geoflowslam.pipeline.reloc import reloc_core
        from geoflowslam.retrieval.vocab import Vocabulary
        # vocab tree structure (k, levels) is static; the centers/weights
        # ride in as traced arrays (reloc_vocab = (centers, weights))
        vocab = Vocabulary(centers=reloc_vocab[0], weights=reloc_vocab[1],
                           k=reloc_kl[0], levels=reloc_kl[1])

        def _try_reloc(_):
            # stage 1 (cheap continuity): wide-radius re-search from the
            # predicted pose against the last bindings — the staged path's
            # "fallback 1" and the reference's TrackReferenceKeyFrame
            # retry slot (src/Tracking.cc:2433: try again before reloc)
            import dataclasses as _dc
            wide = _dc.replace(cfg, search_radius_mm=40.0)
            resw = T.track_with_motion_model.__wrapped__(
                ms, frame, last_obs_mp, pr, pt, wide,
                last_levels=last_levels)
            # stage 2: full relocalization over the BoW candidates
            k = jax.random.PRNGKey(
                jnp.asarray(0.0 if seq is None else seq)
                .astype(jnp.int32) + 7777)
            n_r, r_r, t_r, obs_r, cand_r = reloc_core(
                vocab, reloc_db, ms2, frame, k, cfg,
                fcfg.orb.width, fcfg.orb.height,
                cfg.fx, cfg.fy, cfg.cx, cfg.cy)
            use_w = resw.n_inliers >= min_inliers
            return (jnp.where(use_w, resw.n_inliers, n_r),
                    jnp.where(use_w, resw.rot, r_r),
                    jnp.where(use_w, resw.t, t_r),
                    jnp.where(use_w, resw.obs_mp, obs_r),
                    jnp.where(use_w, ref_kf, cand_r).astype(jnp.int32))

        def _skip(_):
            return (jnp.zeros((), jnp.int32), jnp.eye(3), jnp.zeros(3),
                    jnp.full_like(last_obs_mp, M.NO_MP),
                    jnp.zeros((), jnp.int32))

        n_r, r_r, t_r, obs_r, cand_r = jax.lax.cond(
            ~ok_frame, _try_reloc, _skip, None)
        # acceptance well above the tracking-OK floor: a 40 px wide-radius
        # re-search at a wrong pose finds chance matches, and a falsely
        # adopted reloc pose restarts the failure loop from garbage
        # (Tracking.cc:4660 demands nGood >= 50 for the same reason)
        relocd = (~ok_frame) & (n_r >= max(min_inliers, 30))
        rot_f = jnp.where(relocd, r_r, rot_f)
        t_f = jnp.where(relocd, t_r, t_f)
        obs_f = jnp.where(relocd, obs_r, obs_f)
        reloc_cand = cand_r
        if body_out is not None:
            # re-derive the body state from the relocalized camera pose,
            # keeping the (dead-reckoned) velocity estimate
            body_reloc = VI.BodyState(
                r_wb=rot_f.T @ r_cb, p=rot_f.T @ (t_cb - t_f),
                v=body_out.v, bg=bias[:3], ba=bias[3:])
            body_out = _tree_where(relocd, body_reloc, body_out)

    # ---- motion model update (Tcl = Tcw ∘ Tlw^-1) ------------------------
    lri, lti = lie.se3_inverse(cur_rot, cur_t)
    nvr, nvt = lie.se3_compose(rot_f, t_f, lri, lti)
    # on failure keep the previous motion model (don't learn from a
    # predicted-only delta) — unless ICP measured the delta (carried)
    nvr = jnp.where(ok_frame | carried, nvr, vel_rot)
    nvt = jnp.where(ok_frame | carried, nvt, vel_t)
    # velocity runaway backstop: no camera this framework targets moves
    # 0.5 m between consecutive frames; a learned translation rate beyond
    # that is a tracking artifact (see the OF-confirmation health gate
    # above for the root-cause defense), so clamp its magnitude.
    v_mag = jnp.linalg.norm(nvt)
    nvt = nvt * jnp.minimum(1.0, 0.5 / jnp.maximum(v_mag, 1e-9))
    if relocd is not None:
        # after a relocalization the frame-to-frame motion is unknown
        # (the reference clears mVelocity): predict-from-same-pose next
        nvr = jnp.where(relocd, jnp.eye(3), nvr)
        nvt = jnp.where(relocd, jnp.zeros(3), nvt)

    rwc = rot_f.T
    twc = jnp.concatenate([rwc, (-(rwc @ t_f))[:, None]], axis=1)
    # relative pose vs the reference KF (for retroactively-corrected
    # trajectory export): T_cr = Tcw ∘ Trw^-1
    r_rw, t_rw = ms.kf_rot[ref_kf], ms.kf_t[ref_kf]
    r_cr = rot_f @ r_rw.T
    t_cr = t_f - r_cr @ t_rw
    trel = jnp.concatenate([r_cr, t_cr[:, None]], axis=1)
    bias_out = (jnp.concatenate([body_out.bg, body_out.ba])
                if body_out is not None else None)
    scalars = jnp.stack([res.n_inliers, res2.n_inliers, n_vi,
                         accept.astype(jnp.int32)])
    if relocd is not None:
        # aux coding: 0 normal, 1 ICP-carried, 2+slot relocalized (the slot
        # fits the f32 mantissa exactly — k_max <= 2^23)
        aux = jnp.where(relocd, 2.0 + reloc_cand.astype(jnp.float32),
                        carried.astype(jnp.float32))
    else:
        aux = carried.astype(jnp.float32)
    host_pkt = jnp.concatenate([
        scalars.astype(jnp.float32), twc.reshape(-1), trel.reshape(-1),
        bias_out if bias_out is not None else jnp.zeros(6),
        aux.reshape(1)])
    if pkt_window is None:
        win = jnp.zeros((PKT_WINDOW, PKT_ROW), jnp.float32)
        seq = jnp.zeros((), jnp.float32)
    else:
        win = pkt_window
    row = jnp.concatenate([seq.reshape(1).astype(jnp.float32), host_pkt])
    win = jnp.concatenate([win[1:], row[None]], axis=0)
    return FusedOut(frame=frame, rot=rot_f, t=t_f, obs_mp=obs_f, ms=ms2,
                    vel_rot=nvr, vel_t=nvt, p_frame=p_frame, body=body_out,
                    marg=marg, scalars=scalars, twc=twc, trel=trel,
                    bias_out=bias_out, host_pkt=host_pkt, of_counts=of_counts,
                    pkt_window=win)
