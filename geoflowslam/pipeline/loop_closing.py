"""Loop closing: place recognition, Sim3 verification, loop correction.

JAX re-expression of the LoopClosing thread
(/root/reference/src/LoopClosing.cc): instead of a polling thread, a
`LoopCloser` invoked by the host after each KF insertion:

* place recognition: BoW query against the KF database
  (NewDetectCommonRegions :353 / KeyFrameDatabase::DetectNBestCandidates)
* geometric verification: descriptor matching between the two KFs'
  map points + Sim3 RANSAC (Sim3Solver) + GN refinement (OptimizeSim3)
* loop correction (CorrectLoop :1022): propagate the corrective Sim3
  through the essential graph — here the full padded pose-graph GN
  (solvers/pose_graph.py) over covisibility + temporal + loop edges,
  with map points re-anchored through their reference KF's correction.
* multi-map merge (MergeLocal :1307/1894): when the candidate lives in a
  dormant Atlas map, the two maps are welded by the Sim3 instead
  (state/map_state.merge_maps) and the pose graph runs on the union.

Global BA after the loop (RunGlobalBundleAdjustment :2360) reuses the
landmark-sharded distributed BA (parallel/dist_ba.py) when a mesh is given,
or the single-device Schur BA otherwise.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from geoflowslam.math import lie
from geoflowslam.ops import matching, ransac
from geoflowslam.ops import pointcloud as pc
from geoflowslam.retrieval import vocab as V
from geoflowslam.retrieval import kf_database as DB
from geoflowslam.solvers import pose_graph as PG
from geoflowslam.state import map_state as M


from functools import partial


@partial(jax.jit, static_argnames=("max_edges",))
def _extract_essential_edges(ms: M.MapState, cur, cand, s, rot, t,
                             covis_edge_min: float, max_edges: int):
    """Essential-graph edge extraction on device (OptimizeEssentialGraph's
    edge set, /root/reference/src/Optimizer.cc:2042): covisibility edges over
    the threshold + the temporal chain, picked by one masked top-k over the
    [K,K] covisibility matrix; the verified loop edge (i=cand, j=cur,
    measured Sim3) occupies the last slot. Relative-pose measurements come
    from the current (pre-correction) poses, batched."""
    k = ms.k_max
    cov = M.covisibility(ms).astype(jnp.float32)
    valid2 = ms.kf_valid[:, None] & ms.kf_valid[None, :]
    upper = jnp.triu(jnp.ones((k, k), bool), 1)
    w = jnp.where((cov >= covis_edge_min) & upper & valid2,
                  jnp.minimum(cov, 100.0) / 100.0, 0.0)
    # temporal chain: edge (prev[j], j) with the reference's strong weight
    prev = ms.kf_prev
    t_ok = ms.kf_valid & (prev >= 0) & ms.kf_valid[jnp.maximum(prev, 0)]
    w = w.at[jnp.where(t_ok, prev, 0), jnp.arange(k)].max(
        jnp.where(t_ok, 1.0, 0.0))
    vals, flat = jax.lax.top_k(w.reshape(-1), max_edges - 1)
    ei = (flat // k).astype(jnp.int32)
    ej = (flat % k).astype(jnp.int32)
    ev = vals > 0.0
    # measured S_ij = T_i T_j^-1 (unit scale) from current poses
    ri, ti = ms.kf_rot[ei], ms.kf_t[ei]
    rj, tj = ms.kf_rot[ej], ms.kf_t[ej]
    r_rel = jnp.einsum("eab,ecb->eac", ri, rj)          # R_i R_j^T
    t_rel = ti - jnp.einsum("eab,eb->ea", r_rel, tj)
    # loop edge: p_cand_cam = s R p_cur_cam + t => S_cand<-cur = S_ij
    ei = jnp.concatenate([ei, cand[None]])
    ej = jnp.concatenate([ej, cur[None]])
    ew = jnp.concatenate([vals, jnp.array([5.0])])
    ev = jnp.concatenate([ev, jnp.array([True])])
    srel = jnp.concatenate([jnp.ones((max_edges - 1,)), s[None]])
    rrel = jnp.concatenate([r_rel, rot[None]], axis=0)
    trel = jnp.concatenate([t_rel, t[None]], axis=0)
    return PG.PoseGraphEdges(i=ei, j=ej, s=srel, rot=rrel, t=trel,
                             weight=ew, valid=ev)


@partial(jax.jit, static_argnames=("cfg",))
def _count_projection_matches(ms: M.MapState, cur, cand, s, rot, t, cfg):
    """Project the candidate KF's map points into the current KF's camera
    through the verified camera-frame Sim3 (p_cand = s R p_cur + t, so
    p_cur = R^T (p_cand - t) / s) and count descriptor matches near the
    projections (FindMatchesByProjection essence)."""
    obs = ms.kf_obs_mp[cand]
    has = (obs >= 0) & ms.kf_kp_valid[cand]
    mp = jnp.maximum(obs, 0)
    has = has & ms.mp_valid[mp]
    pts_w = ms.mp_pos[mp]
    # candidate-camera coords, then through Sim3^-1 into cur-camera coords
    p_cand = pts_w @ ms.kf_rot[cand].T + ms.kf_t[cand]
    p_cur = (p_cand - t) @ rot / jnp.maximum(s, 1e-9)
    z = jnp.where(jnp.abs(p_cur[:, 2]) < 1e-6, 1e-6, p_cur[:, 2])
    u = cfg.fx * p_cur[:, 0] / z + cfg.cx
    v = cfg.fy * p_cur[:, 1] / z + cfg.cy
    inb = (p_cur[:, 2] > 0.1) & (u >= 0) & (u < 2 * cfg.cx) \
        & (v >= 0) & (v < 2 * cfg.cy)
    uv = jnp.stack([u, v], axis=1)
    radius = jnp.full((obs.shape[0],), 8.0)
    m_idx, m_dist = matching.search_by_projection(
        uv, jnp.zeros_like(obs), has & inb, ms.mp_desc[mp],
        ms.kf_uv[cur], ms.kf_level[cur], ms.kf_desc[cur],
        ms.kf_kp_valid[cur], radius, max_dist=matching.TH_HIGH,
        min_off=0, max_off=8)   # octave-free verification window
    return jnp.sum(m_idx >= 0).astype(jnp.int32)


@partial(jax.jit, static_argnames=("fix_scale", "cfg"))
def _verify_sim3_fused(ms: M.MapState, cur, cand, key, fix_scale: bool, cfg):
    """ONE-dispatch geometric verification of a matured loop candidate:
    map-point descriptor matching -> Sim3 RANSAC (Sim3Solver) -> GN
    refinement (OptimizeSim3) -> guided-projection count
    (FindMatchesByProjection), /root/reference/src/LoopClosing.cc:353-969.

    Returns (scalars [3] int32 = [n_ransac_inl, n_opt_inl, n_proj], s, R, t)
    so the host gates on one small read instead of an eager op-by-op chain
    with a blocking read per stage."""
    m_idx, _ = matching.match_descriptors(
        ms.kf_desc[cur], ms.kf_kp_valid[cur] & (ms.kf_obs_mp[cur] >= 0),
        ms.kf_desc[cand], ms.kf_kp_valid[cand] & (ms.kf_obs_mp[cand] >= 0),
        max_dist=matching.TH_LOW, ratio=0.85, mutual=True)

    mp1 = ms.kf_obs_mp[cur]
    mp2 = ms.kf_obs_mp[cand][jnp.maximum(m_idx, 0)]
    valid = (m_idx >= 0) & (mp1 >= 0) & (mp2 >= 0)
    p1w = ms.mp_pos[jnp.maximum(mp1, 0)]
    p2w = ms.mp_pos[jnp.maximum(mp2, 0)]
    # to camera coords of each KF (Sim3Solver works in camera frames)
    p1c = p1w @ ms.kf_rot[cur].T + ms.kf_t[cur]
    p2c = p2w @ ms.kf_rot[cand].T + ms.kf_t[cand]

    res = ransac.ransac_sim3(key, p1c, p2c, valid,
                             fix_scale=fix_scale, threshold=0.1)
    s0 = res.model[0]
    r0 = res.model[1:10].reshape(3, 3)
    t0 = res.model[10:13]
    s, rot, t, inl = PG.optimize_sim3_pair(
        s0, r0, t0, p1c, p2c, res.inliers, fix_scale=fix_scale)
    n_proj = _count_projection_matches.__wrapped__(ms, cur, cand, s, rot, t,
                                                   cfg)
    # geometric STRUCTURE of the consensus: the smallest eigenvalue of the
    # inlier 3D covariance. A flat wall with repetitive texture aliases —
    # shifted-by-a-texture-period matches are RANSAC-consistent (plane maps
    # to plane) and even re-project consistently, producing a verified-but-
    # meters-wrong Sim3 (measured 2 m / 28 deg on the hard loop cells). A
    # planar consensus cannot disambiguate such shifts, so the host rejects
    # candidates whose inlier set has no out-of-plane extent.
    w = inl.astype(p1c.dtype)
    nw = jnp.maximum(jnp.sum(w), 1.0)
    mean1 = jnp.sum(p1c * w[:, None], axis=0) / nw
    c1 = (p1c - mean1) * w[:, None]
    cov1 = c1.T @ c1 / nw
    lam = pc.sym3_eigvals(cov1[None])[0]
    thickness_mm = jnp.sqrt(jnp.maximum(lam[0], 0.0)) * 1e3
    scalars = jnp.stack([res.n_inliers.astype(jnp.int32),
                         jnp.sum(inl).astype(jnp.int32), n_proj,
                         thickness_mm.astype(jnp.int32)])
    return scalars, s, rot, t


def detect_step(vocab, db, ms: M.MapState, kf_slot, prev_groups, prev_counts,
                min_score: float, n_best: int = 3):
    """One-dispatch per-KF place recognition + temporal-consistency update.

    Fuses BoW descent, DetectNBestCandidates retrieval, the database insert
    and the consistent-groups bookkeeping (mvConsistentGroups,
    /root/reference/src/LoopClosing.cc:353-627) into a single device program
    whose small scalar outputs the host reads a few frames later
    (copy_to_host_async) — the steady-state "no loop yet" path costs zero
    blocking round trips.

    Unlike round 2's single chain, this keeps `n_best` chains (one per
    candidate group): a candidate's count is 1 + the max count of any
    previous group it overlaps, so alternating/noisy candidates no longer
    reset consistency progress.

    Returns (db', groups [n_best,K] bool, counts [n_best] int32,
    scalars [n_best,3] int32 rows = (cand_idx, count, score*1e4)).
    """
    kf_slot = jnp.int32(kf_slot)
    desc = ms.kf_desc[kf_slot]
    kp_valid = ms.kf_kp_valid[kf_slot]
    words = V.descend(vocab, desc, kp_valid)
    qvec = V.bow_vector(vocab, words)
    cand_idx, cand_score, cand_ok = DB.detect_candidates(
        db, ms, qvec, kf_slot, n_best=n_best)
    db = db._replace(bow=db.bow.at[kf_slot].set(qvec),
                     valid=db.valid.at[kf_slot].set(True))
    ok = cand_ok & (cand_score >= min_score)
    cov = M.covisibility(ms)                          # [K,K]
    groups = cov[cand_idx] > 0                        # [n_best, K]
    groups = groups.at[jnp.arange(n_best), cand_idx].set(True)
    groups = groups & ok[:, None]
    overlap = jnp.einsum("gk,pk->gp", groups.astype(jnp.float32),
                         prev_groups.astype(jnp.float32)) > 0
    inherited = jnp.max(jnp.where(overlap, prev_counts[None, :], 0), axis=1)
    counts = jnp.where(ok, 1 + inherited, 0)
    scalars = jnp.stack(
        [cand_idx.astype(jnp.int32), counts.astype(jnp.int32),
         (cand_score * 1e4).astype(jnp.int32)], axis=1)
    return db, groups, counts, scalars


@dataclasses.dataclass(frozen=True)
class LoopConfig:
    min_score: float = 0.05
    min_sim3_inliers: int = 20
    fix_scale: bool = True         # stereo/RGBD; mono optimizes scale
    covis_edge_min: int = 30       # essential-graph edge threshold
    max_edges: int = 512
    run_pose_graph: bool = True
    run_global_ba: bool = False    # synchronous GBA right after correction
    # interleaved background GBA (RunGlobalBundleAdjustment as micro-steps
    # driven by SlamSystem, abortable): default on — the reference always
    # spawns its GBA thread after a loop
    async_global_ba: bool = True
    use_icp_loop: bool = False     # UseICPLoop: GICP-refine the loop Sim3
    # temporal consistency: the same candidate region must be re-detected on
    # this many consecutive KFs before geometric verification is attempted
    # (NewDetectCommonRegions' >=3 coincidences, LoopClosing.cc:353-627)
    consistency_needed: int = 3
    # guided-projection verification: minimum matches when projecting the
    # candidate's map points into the current KF through the verified Sim3
    # (FindMatchesByProjection gate, LoopClosing.cc:969)
    min_proj_verify: int = 25
    # post-correction duplicate welding + welding BA (SearchAndFuse :2224,
    # MergeLocal welding BA :1307-1894)
    run_weld: bool = True
    # drift-budget gate for SAME-MAP loop constraints: the correction a
    # verified Sim3 implies (measured relative pose vs the odometry relative
    # pose) must be commensurate with plausible accumulated drift. A false
    # loop between similar-looking places passes every geometric check
    # (BoW, Sim3 RANSAC, guided projection are all self-consistent on
    # repetitive/planar structure) but demands a correction far beyond any
    # real drift — forcing it through the essential graph bent a 4.5 cm
    # trajectory into a 1.75 m one. Budget = floor + rate * |t_cur - t_cand|
    # (seconds). Cross-map merges are exempt (fragment offsets are
    # arbitrary).
    drift_budget_floor_m: float = 0.30
    drift_budget_rate: float = 0.02       # m per second of separation
    drift_budget_floor_deg: float = 5.0
    drift_budget_rate_deg: float = 0.10   # deg per second of separation
    # minimum out-of-plane extent (meters) of the Sim3 inlier consensus:
    # planar consensi are aliasing-prone (see _verify_sim3_fused)
    min_structure_m: float = 0.05


class LoopCloser:
    """Host-side loop-closing stage (one call per new KF)."""

    def __init__(self, vocab: V.Vocabulary, k_max: int,
                 cfg: LoopConfig = LoopConfig(), map_cfg=None, mesh=None):
        self.vocab = vocab
        self.cfg = cfg
        self.db = DB.KFDatabase.create(k_max, vocab.n_words)
        self.n_loops = 0
        self.n_merges = 0
        self.key = jax.random.PRNGKey(77)
        if map_cfg is None:
            from geoflowslam.pipeline.local_mapping import MappingConfig
            map_cfg = MappingConfig()
        self._map_cfg = map_cfg
        self.mesh = mesh  # optional jax.sharding.Mesh: distributed global BA
        self.n_cand = 3
        # temporal-consistency chains (mvConsistentGroups): device-resident
        # [n_cand, K] group masks + [n_cand] counts updated inside detect_step
        self._groups = jnp.zeros((self.n_cand, k_max), bool)
        self._counts = jnp.zeros((self.n_cand,), jnp.int32)
        self._detect_jit = None
        self.k_max = k_max

    def _detect(self, ms, kf_slot):
        """Dispatch the fused detect program; returns the [n_cand,3] scalar
        tile (cand_idx, count, score*1e4) with its D2H copy started."""
        if self._detect_jit is None:
            vocab, cfg, n_cand = self.vocab, self.cfg, self.n_cand

            @jax.jit
            def fn(db, ms, kf_slot, groups, counts):
                return detect_step(vocab, db, ms, kf_slot, groups, counts,
                                   cfg.min_score, n_cand)
            self._detect_jit = fn
        self.db, self._groups, self._counts, scalars = self._detect_jit(
            self.db, ms, jnp.int32(kf_slot), self._groups, self._counts)
        scalars.copy_to_host_async()
        return scalars

    def begin_detect(self, ms: M.MapState, kf_slot: int):
        """Async API for the fused production loop: one dispatch, no reads.
        The caller re-reads the returned scalars a few frames later and, for
        a matured candidate, calls `complete_candidate`."""
        return self._detect(ms, kf_slot)

    def matured_candidate(self, scalars_np) -> Optional[int]:
        """Pick the best candidate whose chain reached the consistency gate
        from a matured detect-scalar tile; None if none qualifies."""
        for row in np.asarray(scalars_np):
            cand, count, _score = (int(x) for x in row)
            if count >= self.cfg.consistency_needed:
                return cand
        return None

    def on_keyframe(self, ms: M.MapState, kf_slot: int, inertial: bool = False,
                    kf_clouds: Optional[dict] = None):
        """Detect + correct synchronously (staged path / tests). Returns
        (ms, loop_found: bool)."""
        scalars = np.asarray(self._detect(ms, kf_slot))
        best = self.matured_candidate(scalars)
        if best is None:
            return ms, False
        return self.complete_candidate(ms, int(kf_slot), best,
                                       inertial=inertial, kf_clouds=kf_clouds)

    def complete_candidate(self, ms: M.MapState, kf_slot_i: int, best: int,
                           inertial: bool = False,
                           kf_clouds: Optional[dict] = None):
        """Geometric verification + correction for a consistency-matured
        candidate (the rare, expensive tail of NewDetectCommonRegions →
        CorrectLoop). Returns (ms, loop_found)."""
        ok, s, rot, t, n_inl, n_proj = self._verify_sim3(ms, kf_slot_i, best)
        if not ok:
            return ms, False

        # guided-projection verification (FindMatchesByProjection :969): the
        # verified Sim3 must re-find the candidate's map points when they are
        # projected into the current KF (computed inside the fused verify
        # dispatch; gated here).
        if n_proj < self.cfg.min_proj_verify:
            return ms, False

        if (self.cfg.use_icp_loop and kf_clouds is not None
                and kf_slot_i in kf_clouds and best in kf_clouds):
            # UseICPLoop: refine the loop transform by registering the two
            # KFs' depth clouds (Tracking/LoopClosing ICP loop verification).
            from geoflowslam.ops import gicp as G
            c1, v1 = kf_clouds[kf_slot_i]
            c2, v2 = kf_clouds[best]
            reg = G.gicp_register(c1, v1, c2, v2, init_rot=rot, init_t=t)
            if int(reg.n_inliers) >= self.cfg.min_sim3_inliers:
                rot, t = reg.rot, reg.t
                s = jnp.ones(())

        same_map = int(ms.kf_map_id[best]) == int(ms.kf_map_id[kf_slot_i])
        if same_map:
            # drift-budget gate (see LoopConfig.drift_budget_*): compare the
            # measured cur-cam -> cand-cam transform against the odometry
            # relative pose; reject corrections no real drift could explain.
            import numpy as _np
            r1 = _np.asarray(ms.kf_rot[kf_slot_i])
            t1 = _np.asarray(ms.kf_t[kf_slot_i])
            r2 = _np.asarray(ms.kf_rot[best])
            t2 = _np.asarray(ms.kf_t[best])
            r_o = r2 @ r1.T
            t_o = t2 - r_o @ t1
            r_m, t_m = _np.asarray(rot), _np.asarray(t)
            s_m = float(_np.asarray(s))
            # error transform E = T_meas o T_odom^-1 (meas: p -> sRp + t):
            # E x = s R_m R_o^T (x - t_o) + t_m
            r_e = r_m @ r_o.T
            t_e = t_m - s_m * (r_e @ t_o)
            dt_sec = abs(float(ms.kf_time[kf_slot_i])
                         - float(ms.kf_time[best]))
            budget_t = (self.cfg.drift_budget_floor_m
                        + self.cfg.drift_budget_rate * dt_sec)
            budget_r = _np.deg2rad(self.cfg.drift_budget_floor_deg
                                   + self.cfg.drift_budget_rate_deg * dt_sec)
            ang = _np.arccos(_np.clip((_np.trace(r_e) - 1) / 2, -1, 1))
            if (_np.linalg.norm(t_e) > budget_t or ang > budget_r
                    or abs(_np.log(max(s_m, 1e-9))) > 0.2):
                from geoflowslam.utils.verbose import warn
                warn(f"loop candidate {kf_slot_i}->{best} REJECTED by drift "
                     f"budget: |t_err|={_np.linalg.norm(t_e):.2f}m "
                     f"(budget {budget_t:.2f}), rot_err="
                     f"{_np.rad2deg(ang):.1f}deg (budget "
                     f"{_np.rad2deg(budget_r):.1f}), s={s_m:.3f}, "
                     f"dt={dt_sec:.1f}s")
                return ms, False
        if not same_map:
            # Atlas merge: weld the active map into the candidate's map.
            # The verified Sim3 is camera-frame (p_cand_cam = s R p_cur_cam
            # + t); merge_maps applies a *world*-frame transform, so convert
            # through both KFs' poses:  X' = R2^T(sR R1 X + sR t1 + t - t2)
            # with (R1,t1)=Tcw(cur), (R2,t2)=Tcw(cand)  =>
            # s_w = s, R_w = R2^T R R1, t_w = R2^T(s R t1 + t - t2).
            r1, t1 = ms.kf_rot[kf_slot_i], ms.kf_t[kf_slot_i]
            r2, t2 = ms.kf_rot[best], ms.kf_t[best]
            r_w = r2.T @ rot @ r1
            t_w = r2.T @ (s * (rot @ t1) + t - t2)
            ms = M.merge_maps(ms, ms.kf_map_id[kf_slot_i], ms.kf_map_id[best],
                              s, r_w, t_w)
            self.n_merges += 1
        if self.cfg.run_pose_graph:
            ms = self._correct_loop(ms, kf_slot_i, best, s, rot, t,
                                    yaw_only=inertial)
        if self.cfg.run_weld:
            # SearchAndFuse (:2224): weld duplicate landmarks across the
            # corrected seam (cur <-> cand and cand's strongest covisible),
            # then a welding local BA over the now-connected window
            # (MergeLocal's welding BA essence).
            from geoflowslam.pipeline import local_mapping as LMod
            cov_b = M.covisibility(ms)[best]
            nb_best = int(jnp.argmax(cov_b))
            ms = LMod.fuse_pair(ms, jnp.int32(kf_slot_i), jnp.int32(best),
                                self._map_cfg)
            if int(cov_b[nb_best]) > 0 and nb_best != kf_slot_i:
                ms = LMod.fuse_pair(ms, jnp.int32(kf_slot_i),
                                    jnp.int32(nb_best), self._map_cfg)
            ms, _ = LMod.local_ba_step(ms, jnp.int32(kf_slot_i),
                                       self._map_cfg)
        if self.cfg.run_global_ba:
            # RunGlobalBundleAdjustment (LoopClosing.cc:2360): full-map BA
            # after the pose-graph correction (synchronous jitted step here
            # instead of a detached thread).
            if self.mesh is not None:
                from geoflowslam.pipeline.local_mapping import (
                    global_ba_step_distributed)
                ms = global_ba_step_distributed(ms, self._map_cfg, self.mesh)
            else:
                from geoflowslam.pipeline.local_mapping import global_ba_step
                ms = global_ba_step(ms, self._map_cfg)
        self.n_loops += 1
        # fresh chains after a correction
        self._groups = jnp.zeros((self.n_cand, self.k_max), bool)
        self._counts = jnp.zeros((self.n_cand,), jnp.int32)
        return ms, True

    # ------------------------------------------------------------------

    def _verify_sim3(self, ms: M.MapState, cur: int, cand: int):
        """Match map points of the two KFs, Sim3 RANSAC + refinement +
        guided-projection count — as ONE jitted dispatch and ONE scalar-tile
        read. An eager per-op version pays hundreds of small compiles
        (too short for the persistent cache to keep) plus a blocking read
        per op, turning every matured loop candidate into a stall.

        Returns (ok, s, R, t, n_inl, n_proj) with (s,R,t) mapping cur-KF
        camera coords to cand-KF camera coords (the Scm of the reference).
        """
        self.key, k = jax.random.split(self.key)
        scalars, s, rot, t = _verify_sim3_fused(
            ms, jnp.int32(cur), jnp.int32(cand), k,
            self.cfg.fix_scale, self._map_cfg)
        n_ransac, n_opt, n_proj, thick_mm = (int(x)
                                             for x in np.asarray(scalars))
        ok = (n_ransac >= self.cfg.min_sim3_inliers
              and n_opt >= self.cfg.min_sim3_inliers)
        if ok and thick_mm < 1e3 * self.cfg.min_structure_m:
            from geoflowslam.utils.verbose import warn
            warn(f"loop candidate {cur}->{cand} REJECTED: planar consensus "
                 f"(structure thickness {thick_mm} mm < "
                 f"{1e3 * self.cfg.min_structure_m:.0f} mm) — aliased "
                 "wall-to-wall Sim3s are RANSAC-consistent")
            ok = False
        return ok, s, rot, t, n_opt, n_proj

    def _correct_loop(self, ms: M.MapState, cur: int, cand: int, s, rot, t,
                      yaw_only: bool = False):
        """Essential-graph pose-graph optimization with the loop constraint.

        Graph: covisibility edges (weight = shared count, >= covis_edge_min)
        + temporal chain + the loop edge cur->cand with the measured Sim3.
        The loop (candidate-side) KF is held fixed; map points transform with
        their reference KF's correction. Edge extraction is one jitted masked
        top-k over the covisibility matrix (no O(K^2) host loop).
        """
        k_max = ms.k_max
        base_s = jnp.ones((k_max,))
        base_rot, base_t = ms.kf_rot, ms.kf_t
        edges = _extract_essential_edges(
            ms, jnp.int32(cur), jnp.int32(cand), jnp.float32(s), rot, t,
            float(self.cfg.covis_edge_min), self.cfg.max_edges)

        fixed = jnp.zeros((k_max,), bool).at[cand].set(True)
        # inertial maps: 4DoF yaw-only correction (gravity pins roll/pitch,
        # OptimizeEssentialGraph4DoF)
        s_new, r_new, t_new = PG.optimize_pose_graph(
            base_s, base_rot, base_t, ms.kf_valid, fixed, edges,
            fix_scale=self.cfg.fix_scale, iters=10, yaw_only=yaw_only)

        # re-anchor map points through their reference KF correction:
        # X' = S_new^-1 ( S_old (X) ), applied per point via mp_first_kf
        ref_kf = jnp.clip(ms.mp_first_kf, 0, k_max - 1)
        ro, to = base_rot[ref_kf], base_t[ref_kf]
        rn, tn = r_new[ref_kf], t_new[ref_kf]
        sn = s_new[ref_kf]
        # cam coords under old pose
        pc = jnp.einsum("mij,mj->mi", ro, ms.mp_pos) + to
        # back to world with corrected pose: X' = S_new^-1 pc
        rni = jnp.swapaxes(rn, -1, -2)
        pw = jnp.einsum("mij,mj->mi", rni, (pc - tn) / jnp.maximum(sn, 1e-9)[:, None])
        new_pos = jnp.where(ms.mp_valid[:, None], pw, ms.mp_pos)

        # KF poses: Tcw' = s,R,t composed (camera from world scaled)
        return ms._replace(
            kf_rot=jnp.where(ms.kf_valid[:, None, None], r_new, ms.kf_rot),
            kf_t=jnp.where(ms.kf_valid[:, None],
                           t_new / jnp.maximum(s_new, 1e-9)[:, None], ms.kf_t),
            mp_pos=new_pos,
        )
