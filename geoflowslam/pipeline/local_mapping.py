"""Local-mapping stage: map maintenance + windowed bundle adjustment.

JAX re-expression of the LocalMapping thread
(/root/reference/src/LocalMapping.cc): instead of a queue-consuming thread,
a jit-compiled `local_mapping_step` invoked by the host after each KF
insertion performs (in the reference's order, LocalMapping::Run :89-412):

* duplicate fusion within the covisibility neighbourhood (SearchInNeighbors
  :1129) — here a descriptor+reprojection merge over the incidence tables,
* local BA over the covisibility window with fixed 1-ring
  (LocalBundleAdjustment dispatch :184-247 -> solvers/local_ba.py),
* map-point culling (MapPointCulling :467),
* (keyframe culling handled by the host on scalar stats: KeyFrameCulling :1302)

Monocular triangulation of new points (CreateNewMapPoints :803) lives in
`triangulate_new_points`; the RGB-D path creates points at KF insertion
(pipeline/tracking.py::create_keyframe) as the reference does.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from geoflowslam.math import lie, triangulate
from geoflowslam.ops import matching
from geoflowslam.solvers import local_ba
from geoflowslam.state import map_state as M


@dataclasses.dataclass(frozen=True)
class MappingConfig:
    fx: float = 400.0
    fy: float = 400.0
    cx: float = 320.0
    cy: float = 240.0
    bf: float = 40.0
    scale_factor: float = 1.2
    window_opt: int = 8      # optimized KFs (covisibility window)
    window_fixed: int = 4    # fixed anchor KFs (1-ring)
    ba_max_pts: int = 1024   # landmark slots in the BA problem
    cull_found_ratio: float = 0.25
    cull_min_obs: int = 2


def _inv_sigma2(levels, scale_factor):
    return 1.0 / (scale_factor ** levels.astype(jnp.float32)) ** 2


# ---------------------------------------------------------------------------
# BA window extraction / write-back
# ---------------------------------------------------------------------------

def _select_window(ms: M.MapState, center_kf, cfg: MappingConfig,
                   incidence=None):
    """Pick the optimized window (top covisible KFs of center) + fixed ring.

    Returns (kf_idx [KW], kf_in_window [KW] bool, kf_fixed [KW] bool)."""
    kw = cfg.window_opt + cfg.window_fixed
    inc = M.observation_incidence(ms) if incidence is None else incidence
    cov = M.covisibility(ms, incidence=inc)
    row = cov[center_kf] * ms.kf_valid * (ms.kf_map_id == ms.active_map)
    row = row.at[center_kf].set(1 << 20)  # center always first
    vals, idx = jax.lax.top_k(row, cfg.window_opt)
    opt_mask_k = jnp.zeros((ms.k_max,), bool).at[idx].set(vals > 0)

    # fixed ring: KFs covisible with the window but not in it
    window_mps = (jnp.einsum("k,km->m", opt_mask_k.astype(jnp.float32), inc) > 0)
    sees_window = (jnp.einsum("km,m->k", inc, window_mps.astype(jnp.float32)) > 0)
    ring = sees_window & ~opt_mask_k & ms.kf_valid
    rvals, ridx = jax.lax.top_k(ring.astype(jnp.int32) * (1 + cov[center_kf]),
                                cfg.window_fixed)
    kf_idx = jnp.concatenate([idx, ridx])
    in_win = jnp.concatenate([vals > 0, rvals > 0])
    fixed = jnp.concatenate([jnp.zeros((cfg.window_opt,), bool),
                             jnp.ones((cfg.window_fixed,), bool)])
    # Gauge anchoring: ensure at least TWO fixed KFs (one pins SE3, the
    # second pins the monocular scale; the reference gets this from its
    # fixed 1-ring + KF0, see Optimizer.cc:1588 lFixedCameras).
    n_fixed = jnp.sum((fixed & in_win).astype(jnp.int32))
    times = jnp.where(in_win & ~fixed, ms.kf_time[kf_idx], jnp.inf)
    oldest1 = jnp.argmin(times)
    times2 = times.at[oldest1].set(jnp.inf)
    oldest2 = jnp.argmin(times2)
    fixed = jnp.where(n_fixed >= 1, fixed, fixed.at[oldest1].set(True))
    n_fixed = jnp.sum((fixed & in_win).astype(jnp.int32))
    fixed = jnp.where(n_fixed >= 2, fixed, fixed.at[oldest2].set(True))
    return kf_idx, in_win, fixed


def extract_ba_problem(ms: M.MapState, kf_idx, in_win, fixed,
                       cfg: MappingConfig, incidence=None):
    """Build a dense BAProblem for the given KF slots. Returns
    (problem, mp_idx, ctx) where ctx carries the scatter indices needed by
    `writeback_ba`.

    The landmark score (observation count over the optimized window) is a
    direct [KW,N] -> [M] scatter from the window KFs' observation lists —
    O(KW*N), not the O(K*M) full-incidence einsum (`incidence` kept for
    signature compatibility; unused)."""
    del incidence
    kw = kf_idx.shape[0]
    opt_sel = in_win & ~fixed                          # [KW]
    obs_w = ms.kf_obs_mp[kf_idx]                       # [KW, N]
    ov = (obs_w >= 0) & ms.kf_kp_valid[kf_idx] \
        & ms.kf_valid[kf_idx][:, None] & opt_sel[:, None]
    mp_score = jnp.zeros((ms.m_max + 1,)).at[
        jnp.where(ov, obs_w, ms.m_max).reshape(-1)].add(
        1.0, mode="drop")[:ms.m_max] * ms.mp_valid
    mvals, mp_idx = jax.lax.top_k(mp_score, cfg.ba_max_pts)
    mp_in = mvals > 0
    lookup = jnp.full((ms.m_max + 1,), -1, jnp.int32)
    lookup = lookup.at[mp_idx].set(jnp.arange(cfg.ba_max_pts, dtype=jnp.int32))

    obs = ms.kf_obs_mp[kf_idx]                      # [KW, N]
    kp_valid = ms.kf_kp_valid[kf_idx]
    local_m = lookup[jnp.clip(obs, -1, ms.m_max)]
    has = (obs >= 0) & (local_m >= 0) & kp_valid & in_win[:, None]

    uv_kp = ms.kf_uv[kf_idx]
    lvl_kp = ms.kf_level[kf_idx]
    d_kp = ms.kf_depth[kf_idx]
    ur_kp = jnp.where(d_kp > 0, uv_kp[..., 0] - cfg.bf / jnp.maximum(d_kp, 1e-6), -1.0)

    ml = cfg.ba_max_pts
    tgt = jnp.where(has, local_m, ml)
    kk = jnp.broadcast_to(jnp.arange(kw)[:, None], obs.shape)

    uv = jnp.zeros((kw, ml, 2)).at[kk, tgt].set(uv_kp, mode="drop")
    urg = jnp.zeros((kw, ml)).at[kk, tgt].set(ur_kp, mode="drop")
    sig = jnp.zeros((kw, ml)).at[kk, tgt].set(
        _inv_sigma2(lvl_kp, cfg.scale_factor), mode="drop")
    ovalid = jnp.zeros((kw, ml), bool).at[kk, tgt].set(True, mode="drop")

    prob = local_ba.BAProblem(
        kf_rot=ms.kf_rot[kf_idx], kf_t=ms.kf_t[kf_idx],
        kf_fixed=fixed | ~in_win, kf_valid=in_win,
        pts=ms.mp_pos[mp_idx], pt_valid=mp_in,
        uv=uv, u_right=urg, is_stereo=urg > 0,
        inv_sigma2=sig, obs_valid=ovalid,
    )
    ctx = (kk, tgt, has, local_m, obs, ovalid)
    return prob, mp_idx, mp_in, ctx


def writeback_ba(ms: M.MapState, out, obs_inl, kf_idx, in_win, fixed,
                 mp_idx, mp_in, ctx):
    kk, tgt, has, local_m, obs, ovalid = ctx
    upd = in_win & ~fixed
    ms = ms._replace(
        kf_rot=ms.kf_rot.at[kf_idx].set(
            jnp.where(upd[:, None, None], out.kf_rot, ms.kf_rot[kf_idx])),
        kf_t=ms.kf_t.at[kf_idx].set(
            jnp.where(upd[:, None], out.kf_t, ms.kf_t[kf_idx])),
        mp_pos=ms.mp_pos.at[mp_idx].set(
            jnp.where(mp_in[:, None], out.pts, ms.mp_pos[mp_idx])),
    )
    bad = ovalid & ~obs_inl
    bad_kp = bad[kk, jnp.where(has, local_m, 0)] & has
    new_obs = jnp.where(bad_kp, M.NO_MP, obs)
    return ms._replace(kf_obs_mp=ms.kf_obs_mp.at[kf_idx].set(new_obs))


@partial(jax.jit, static_argnames=("cfg",))
def local_ba_step(ms: M.MapState, center_kf, cfg: MappingConfig,
                  incidence=None):
    """Extract the covisibility window, run Schur BA, write back."""
    kf_idx, in_win, fixed = _select_window(ms, center_kf, cfg,
                                           incidence=incidence)
    prob, mp_idx, mp_in, ctx = extract_ba_problem(ms, kf_idx, in_win, fixed,
                                                  cfg, incidence=incidence)
    out, obs_inl = local_ba.local_bundle_adjustment(
        prob, cfg.fx, cfg.fy, cfg.cx, cfg.cy, cfg.bf)
    ms = writeback_ba(ms, out, obs_inl, kf_idx, in_win, fixed, mp_idx, mp_in, ctx)
    return ms, jnp.sum(prob.obs_valid).astype(jnp.int32)


@partial(jax.jit, static_argnames=("cfg", "ba_pts"))
def global_ba_step(ms: M.MapState, cfg: MappingConfig, ba_pts: int = 4096):
    """GlobalBundleAdjustemnt (/root/reference/src/Optimizer.cc:47): all KFs
    of the active map, origin KF fixed; reuses the dense Schur machinery with
    the full KF slot range as the window."""
    kf_idx = jnp.arange(ms.k_max, dtype=jnp.int32)
    in_win = ms.kf_valid & (ms.kf_map_id == ms.active_map)
    # fix the two oldest (gauge, incl. monocular scale)
    times = jnp.where(in_win, ms.kf_time, jnp.inf)
    o1 = jnp.argmin(times)
    o2 = jnp.argmin(times.at[o1].set(jnp.inf))
    fixed = jnp.zeros((ms.k_max,), bool).at[o1].set(True).at[o2].set(True)
    big_cfg = dataclasses.replace(cfg, ba_max_pts=ba_pts)
    prob, mp_idx, mp_in, ctx = extract_ba_problem(ms, kf_idx, in_win, fixed,
                                                  big_cfg)
    out, obs_inl = local_ba.local_bundle_adjustment(
        prob, cfg.fx, cfg.fy, cfg.cx, cfg.cy, cfg.bf, iters1=5, iters2=10)
    ms = writeback_ba(ms, out, obs_inl, kf_idx, in_win, fixed, mp_idx, mp_in, ctx)
    return ms


class AsyncGBA:
    """Background-style, abortable global BA (RunGlobalBundleAdjustment,
    /root/reference/src/LoopClosing.cc:2360-2470).

    The reference runs GBA on a detached thread with an abort flag and, on
    completion, propagates corrections to KFs/points created meanwhile. Here
    the device runs the tracking programs in order, so the equivalent is
    *interleaved micro-steps*: `start()` snapshots the problem, the host
    calls `step()` once per frame (a single jitted GN iteration, a few ms —
    tracking latency stays bounded), `abort()` drops it (mbStopGBA), and
    when the iteration budget completes `finish()` writes the optimized
    state back, propagating corrections to KFs inserted during the run
    through the temporal chain (mTcwGBA parent propagation) and to
    non-optimized points through their reference KF.
    """

    def __init__(self, cfg: MappingConfig, ba_pts: int = 4096,
                 iters_total: int = 15, mesh=None):
        self.cfg = cfg
        self.ba_pts = ba_pts
        self.iters_total = iters_total
        self.active = False
        self._prob = None
        # optional jax.sharding.Mesh: each micro-step runs the
        # landmark-sharded SPMD iteration (parallel/dist_ba.py) instead of
        # the single-device GN step — the background GBA is the scale-out
        # compute of the system (RunGlobalBundleAdjustment's role,
        # /root/reference/src/LoopClosing.cc:2360).
        self.mesh = mesh
        self._dist_iter = None

    def start(self, ms: M.MapState):
        kf_idx = jnp.arange(ms.k_max, dtype=jnp.int32)
        in_win = ms.kf_valid & (ms.kf_map_id == ms.active_map)
        times = jnp.where(in_win, ms.kf_time, jnp.inf)
        o1 = jnp.argmin(times)
        o2 = jnp.argmin(times.at[o1].set(jnp.inf))
        fixed = jnp.zeros((ms.k_max,), bool).at[o1].set(True).at[o2].set(True)
        big = dataclasses.replace(self.cfg, ba_max_pts=self.ba_pts)
        prob, mp_idx, mp_in, ctx = _gba_extract(ms, in_win, fixed, big)
        self._prob = prob
        self._active_mask = prob.obs_valid & prob.pt_valid[None, :] \
            & prob.kf_valid[:, None]
        self._mp_idx, self._mp_in = mp_idx, mp_in
        self._in_win, self._fixed = in_win, fixed
        self._kf_idx = kf_idx
        self.i = 0
        self.active = True

    def abort(self):
        self.active = False
        self._prob = None

    def step(self) -> bool:
        """One GN iteration; returns True when the budget is done."""
        if not self.active:
            return False
        if self.mesh is not None:
            if self._dist_iter is None:
                from geoflowslam.parallel import dist_ba
                self._dist_iter = dist_ba.make_distributed_ba(
                    self.mesh, self.cfg.fx, self.cfg.fy, self.cfg.cx,
                    self.cfg.cy, self.cfg.bf, iters=1)
            self._prob = self._dist_iter(self._prob)
        else:
            self._prob = _gba_iter(self._prob, self._active_mask, self.cfg)
        self.i += 1
        return self.i >= self.iters_total

    def finish(self, ms: M.MapState) -> M.MapState:
        out = self._prob
        self.active = False
        self._prob = None
        return _gba_writeback(ms, out, self._in_win, self._fixed,
                              self._mp_idx, self._mp_in, self.cfg)


@partial(jax.jit, static_argnames=("cfg",))
def _gba_extract(ms, in_win, fixed, cfg: MappingConfig):
    kf_idx = jnp.arange(ms.k_max, dtype=jnp.int32)
    return extract_ba_problem(ms, kf_idx, in_win, fixed, cfg)


@partial(jax.jit, static_argnames=("cfg",))
def _gba_iter(prob, active, cfg: MappingConfig):
    return local_ba._gn_step(prob, active, cfg.fx, cfg.fy, cfg.cx, cfg.cy,
                             cfg.bf, True)


@partial(jax.jit, static_argnames=("cfg",))
def _gba_writeback(ms: M.MapState, out, in_win, fixed, mp_idx, mp_in,
                   cfg: MappingConfig):
    """Write optimized poses/points; propagate corrections to state created
    during the run (KFs via the temporal chain, points via their ref KF)."""
    k = ms.k_max
    # per-slot corrected pose tables (start from current poses)
    new_rot = jnp.where(in_win[:, None, None], out.kf_rot, ms.kf_rot)
    new_t = jnp.where(in_win[:, None], out.kf_t, ms.kf_t)
    corrected = in_win
    # KFs inserted during the run: T_c_new = T_c_now ∘ T_r_now^-1 ∘ T_r_new
    for _ in range(4):
        prev = ms.kf_prev
        pr = jnp.maximum(prev, 0)
        can = ms.kf_valid & ~corrected & (prev >= 0) & corrected[pr]
        r_now, t_now = ms.kf_rot[pr], ms.kf_t[pr]
        # T_r_now^-1 ∘ T_r_new:  R = R_now^T R_new, t = R_now^T (t_new - t_now)
        dr = jnp.einsum("kba,kbc->kac", r_now, new_rot[pr])
        dtv = jnp.einsum("kba,kb->ka", r_now, new_t[pr] - t_now)
        cr = jnp.einsum("kab,kbc->kac", ms.kf_rot, dr)
        ct = jnp.einsum("kab,kb->ka", ms.kf_rot, dtv) + ms.kf_t
        new_rot = jnp.where(can[:, None, None], cr, new_rot)
        new_t = jnp.where(can[:, None], ct, new_t)
        corrected = corrected | can
    # points: optimized ones directly; others via their reference KF:
    # X_new = T_r_new^-1 ∘ T_r_now (X)
    opt_pt = jnp.zeros((ms.m_max,), bool).at[mp_idx].set(mp_in)
    pos = ms.mp_pos.at[mp_idx].set(
        jnp.where(mp_in[:, None], out.pts, ms.mp_pos[mp_idx]))
    ref = jnp.clip(ms.mp_first_kf, 0, k - 1)
    ro, to = ms.kf_rot[ref], ms.kf_t[ref]
    rn, tn = new_rot[ref], new_t[ref]
    pc = jnp.einsum("mij,mj->mi", ro, ms.mp_pos) + to
    pw = jnp.einsum("mji,mj->mi", rn, pc - tn)
    move = ms.mp_valid & ~opt_pt & corrected[ref]
    pos = jnp.where(move[:, None], pw, pos)
    return ms._replace(
        kf_rot=jnp.where(corrected[:, None, None], new_rot, ms.kf_rot),
        kf_t=jnp.where(corrected[:, None], new_t, ms.kf_t),
        mp_pos=pos)


def global_ba_step_distributed(ms: M.MapState, cfg: MappingConfig, mesh,
                               ba_pts: int = 4096, iters: int = 10):
    """Global BA over a jax.sharding.Mesh: landmarks sharded across the
    `land` axis (parallel/dist_ba.py), the reference's background-thread GBA
    re-expressed as multi-chip SPMD. ba_pts must divide the mesh size."""
    from geoflowslam.parallel import dist_ba

    kf_idx = jnp.arange(ms.k_max, dtype=jnp.int32)
    in_win = ms.kf_valid & (ms.kf_map_id == ms.active_map)
    times = jnp.where(in_win, ms.kf_time, jnp.inf)
    o1 = jnp.argmin(times)
    o2 = jnp.argmin(times.at[o1].set(jnp.inf))
    fixed = jnp.zeros((ms.k_max,), bool).at[o1].set(True).at[o2].set(True)
    big_cfg = dataclasses.replace(cfg, ba_max_pts=ba_pts)

    @jax.jit
    def extract(ms):
        return extract_ba_problem(ms, kf_idx, in_win, fixed, big_cfg)

    prob, mp_idx, mp_in, ctx = extract(ms)
    fn = dist_ba.make_distributed_ba(mesh, cfg.fx, cfg.fy, cfg.cx, cfg.cy,
                                     cfg.bf, iters=iters)
    out = fn(prob)

    @jax.jit
    def wb(ms, out):
        # recompute inliers on the optimized problem for edge pruning
        r, _, _, behind = local_ba._residuals(out, cfg.fx, cfg.fy, cfg.cx,
                                              cfg.cy, cfg.bf)
        chi2 = local_ba._chi2(r, out)
        th = jnp.where(out.is_stereo, local_ba.CHI2_STEREO, local_ba.CHI2_MONO)
        inl = out.obs_valid & (chi2 <= th) & (~behind)
        return writeback_ba(ms, out, inl, kf_idx, in_win, fixed,
                            mp_idx, mp_in, ctx)

    return wb(ms, out)


@partial(jax.jit, static_argnames=("cfg", "kw"))
def vi_ba_step(ms: M.MapState, kf_slots, slot_valid, segs, r_cb, t_cb,
               walk_info, cfg: MappingConfig, kw: int, icp=None):
    """LocalInertialBA over a temporal KF window (pipeline glue around
    solvers/inertial_ba.vi_local_ba). kf_slots [KW] oldest-first; segment i
    connects slots i and i+1. `icp`: optional RelPoseFactors (EdgeICP)."""
    from geoflowslam.solvers import inertial_ba as VIBA

    in_win = slot_valid
    fixed = jnp.zeros((kw,), bool).at[0].set(True)
    prob_vis, mp_idx, mp_in, ctx = extract_ba_problem(
        ms, kf_slots, in_win, fixed, cfg)
    prob = VIBA.VIBAProblem(
        vis=prob_vis,
        kf_vel=ms.kf_vel[kf_slots], kf_bias=ms.kf_bias[kf_slots],
        segs=segs, r_cb=r_cb, t_cb=t_cb, walk_info=walk_info, icp=icp)
    out, obs_inl = VIBA.vi_local_ba(prob, cfg.fx, cfg.fy, cfg.cx, cfg.cy, cfg.bf)
    ms = writeback_ba(ms, out.vis, obs_inl, kf_slots, in_win, fixed,
                      mp_idx, mp_in, ctx)
    upd = in_win & ~fixed
    ms = ms._replace(
        kf_vel=ms.kf_vel.at[kf_slots].set(
            jnp.where(upd[:, None], out.kf_vel, ms.kf_vel[kf_slots])),
        kf_bias=ms.kf_bias.at[kf_slots].set(
            jnp.where(upd[:, None], out.kf_bias, ms.kf_bias[kf_slots])),
    )
    return ms, jnp.sum(prob_vis.obs_valid).astype(jnp.int32)


@partial(jax.jit, static_argnames=("tcfg", "cfg", "kw", "use_vi"))
def mapping_step(ms: M.MapState, frame, rot, t, time_rel, obs_mp, ref_kf,
                 kf_slot, vel, bias, kf_slots_p, slot_valid, segs,
                 r_cb, t_cb, walk_info, icp, tcfg, cfg: MappingConfig,
                 kw: int, use_vi: bool):
    """The whole per-KF mapping pipeline as ONE dispatch (LocalMapping::Run
    body, /root/reference/src/LocalMapping.cc:89-412): KF insertion (+ VI
    state stamp) -> windowed (VI-)BA -> duplicate fusion -> descriptor/
    normal refresh -> point culling -> KF culling -> observation refresh +
    local-window mask recompute for the tracker.

    The staged path runs these as 8+ separate dispatches, each with its
    own launch and host round trip. The host
    supplies `kf_slot` (it mirrors slot occupancy) and the stacked IMU
    segments (host numpy), so no device chatter precedes the dispatch.

    Returns (ms, new_obs [N], (kf_mask, mp_mask), kf_rot, kf_t,
    scalars [2] = [culled_slot, n_obs_window])."""
    from geoflowslam.pipeline import tracking as T
    from geoflowslam.solvers import inertial_ba as VIBA

    ms, kf_slot, n_new = T.create_keyframe.__wrapped__(
        ms, frame, rot, t, time_rel, obs_mp, ref_kf, tcfg, kf_slot=kf_slot)
    # The [K,M] incidence scatter is the megastep's dominant repeated cost
    # at production capacities (6-7 rebuilds ~= 60% of the program): build
    # it ONCE per map version and thread it through every consumer. The one
    # KF-cycle staleness this introduces for fuse/cull neighbour SELECTION
    # is harmless — every decision is still masked by the CURRENT
    # kf_valid/mp_valid (UpdateConnections in the reference is likewise
    # refreshed per KF, not per mutation, LocalMapping.cc:89-412).
    if use_vi:
        ms = ms._replace(
            kf_vel=ms.kf_vel.at[kf_slot].set(vel),
            kf_bias=ms.kf_bias.at[kf_slot].set(bias))
        prob_vis, mp_idx, mp_in, ctx = extract_ba_problem(
            ms, kf_slots_p, slot_valid,
            jnp.zeros((kw,), bool).at[0].set(True), cfg)
        prob = VIBA.VIBAProblem(
            vis=prob_vis, kf_vel=ms.kf_vel[kf_slots_p],
            kf_bias=ms.kf_bias[kf_slots_p], segs=segs, r_cb=r_cb, t_cb=t_cb,
            walk_info=walk_info, icp=icp)
        out, obs_inl = VIBA.vi_local_ba(prob, cfg.fx, cfg.fy, cfg.cx,
                                        cfg.cy, cfg.bf)
        fixed = jnp.zeros((kw,), bool).at[0].set(True)
        ms = writeback_ba(ms, out.vis, obs_inl, kf_slots_p, slot_valid,
                          fixed, mp_idx, mp_in, ctx)
        upd = slot_valid & ~fixed
        ms = ms._replace(
            kf_vel=ms.kf_vel.at[kf_slots_p].set(
                jnp.where(upd[:, None], out.kf_vel, ms.kf_vel[kf_slots_p])),
            kf_bias=ms.kf_bias.at[kf_slots_p].set(
                jnp.where(upd[:, None], out.kf_bias,
                          ms.kf_bias[kf_slots_p])))
        n_obs = jnp.sum(prob_vis.obs_valid).astype(jnp.int32)
    else:
        ms, n_obs = local_ba_step.__wrapped__(ms, kf_slot, cfg)
    # post-BA shared tables (outlier-pruned observations): ONE rebuild
    inc2 = M.observation_incidence(ms)
    cov2 = M.covisibility(ms, incidence=inc2)
    ms = fuse_duplicates.__wrapped__(ms, kf_slot, cfg, cov=cov2)
    ms = refresh_point_stats.__wrapped__(ms, kf_slot, cov=cov2)
    ms = M.cull_map_points(ms, incidence=inc2)
    ms, culled = keyframe_culling.__wrapped__(ms, kf_slot, incidence=inc2)
    # refresh the frame's observation bindings (drop culled references)
    obs = ms.kf_obs_mp[kf_slot]
    new_obs = jnp.where(
        (obs >= 0) & ms.mp_valid[jnp.maximum(obs, 0)], obs, M.NO_MP)
    masks = M.local_window(ms, kf_slot, tcfg.local_window,
                           tcfg.lm_max_candidates, incidence=inc2)
    scalars = jnp.stack([culled, n_obs])
    return (ms, new_obs, masks, ms.kf_rot[kf_slot], ms.kf_t[kf_slot],
            scalars)


# ---------------------------------------------------------------------------
# Map-point culling + fusion
# ---------------------------------------------------------------------------

@jax.jit
def cull_step(ms: M.MapState) -> M.MapState:
    return M.cull_map_points(ms)


@partial(jax.jit, static_argnames=("redundancy", "min_obs_level"))
def keyframe_culling(ms: M.MapState, center_kf, protect_recent: float = 1.0,
                     redundancy: float = 0.9, min_obs_level: int = 3,
                     incidence=None):
    """LocalMapping::KeyFrameCulling (/root/reference/src/LocalMapping.cc:1302):
    a local KF is redundant if >= 90% of its map points are observed by at
    least 3 other KFs; the newest KFs (within `protect_recent` seconds of the
    center, the reference's inertial 3s guard) are protected.

    Returns (ms, culled_slot or -1). Culls at most one KF per call (as the
    reference effectively does per loop iteration)."""
    inc = (M.observation_incidence(ms) if incidence is None
           else incidence)                            # [K, M]
    n_obs = jnp.sum(inc, axis=0)                      # [M]
    # per KF: fraction of its points with >= min_obs_level total observations
    own = inc > 0
    redundant_pts = own & (n_obs[None, :] >= min_obs_level)
    n_own = jnp.maximum(jnp.sum(own, axis=1), 1)
    frac = jnp.sum(redundant_pts, axis=1) / n_own
    protected = (ms.kf_time >= ms.kf_time[center_kf] - protect_recent)
    is_first = ms.kf_prev < 0                          # keep map origins
    cand = (ms.kf_valid & ~protected & ~is_first
            & (ms.kf_map_id == ms.active_map) & (frac > redundancy)
            & (jnp.sum(own, axis=1) > 20))
    best = jnp.argmax(jnp.where(cand, frac, -1.0))
    do_cull = cand[best]

    def cull(ms):
        # repair the temporal chain: successors of `best` point to its prev
        prev_of_best = ms.kf_prev[best]
        new_prev = jnp.where(ms.kf_prev == best, prev_of_best, ms.kf_prev)
        ms = ms._replace(kf_prev=new_prev)
        return M.erase_keyframe(ms, best)

    ms = jax.lax.cond(do_cull, cull, lambda m: m, ms)
    return ms, jnp.where(do_cull, best, -1).astype(jnp.int32)


def _fuse_into(ms: M.MapState, center_kf, kf, enabled, cfg: MappingConfig,
               radius_px: float = 3.0):
    """Fuse the center KF's map points into duplicates observed by `kf`:
    project, match by descriptor within `radius_px`, relabel the newer slot
    onto the older one everywhere (MapPoint::Replace essence)."""
    obs_c = ms.kf_obs_mp[center_kf]
    valid_c = obs_c >= 0
    mp = jnp.maximum(obs_c, 0)
    pts = ms.mp_pos[mp]
    rot, t = ms.kf_rot[kf], ms.kf_t[kf]
    pc = pts @ rot.T + t
    z = jnp.where(jnp.abs(pc[:, 2]) < 1e-6, 1e-6, pc[:, 2])
    u = cfg.fx * pc[:, 0] / z + cfg.cx
    v = cfg.fy * pc[:, 1] / z + cfg.cy
    uv = jnp.stack([u, v], axis=1)
    inb = (z > 0.1) & (u >= 0) & (u < 2 * cfg.cx) & (v >= 0) & (v < 2 * cfg.cy)
    q_valid = valid_c & inb & ms.kf_valid[kf]
    radius = jnp.full((obs_c.shape[0],), radius_px)
    m_idx, m_dist = matching.search_by_projection(
        uv, jnp.zeros_like(obs_c), q_valid, ms.mp_desc[mp],
        ms.kf_uv[kf], ms.kf_level[kf], ms.kf_desc[kf],
        ms.kf_kp_valid[kf], radius, max_dist=matching.TH_LOW)
    other = ms.kf_obs_mp[kf][jnp.maximum(m_idx, 0)]
    dup = (m_idx >= 0) & (other >= 0) & (other != mp) & enabled
    # merge: replace our mp with theirs everywhere (keep earlier slot id)
    keep = jnp.where(other < mp, other, mp)
    drop = jnp.where(other < mp, mp, other)
    # relabel all observations of `drop` -> `keep`
    relabel = jnp.arange(ms.m_max, dtype=jnp.int32)
    relabel = relabel.at[jnp.where(dup, drop, ms.m_max)].set(
        jnp.where(dup, keep, 0).astype(jnp.int32), mode="drop")
    new_obs_all = jnp.where(ms.kf_obs_mp >= 0,
                            relabel[jnp.maximum(ms.kf_obs_mp, 0)],
                            ms.kf_obs_mp)
    dead = jnp.zeros((ms.m_max,), bool).at[jnp.where(dup, drop, ms.m_max)].set(
        True, mode="drop")
    return ms._replace(kf_obs_mp=new_obs_all,
                       mp_valid=ms.mp_valid & ~dead)


@partial(jax.jit, static_argnames=("cfg",))
def fuse_duplicates(ms: M.MapState, center_kf, cfg: MappingConfig,
                    cov=None):
    """SearchInNeighbors essence: map points of the center KF that project
    onto another point's observation in a neighbour KF with a close
    descriptor get merged (keep the older slot). `cov`: optional
    precomputed covisibility (neighbour SELECTION only — one KF cycle of
    staleness is harmless; the merge itself reads current state)."""
    # Project center KF's points into each covisible KF and find keypoints
    # already bound to a different mp with a similar descriptor.
    if cov is None:
        cov = M.covisibility(ms)
    row = cov[center_kf] * ms.kf_valid \
        * (ms.kf_map_id == ms.kf_map_id[center_kf])
    w_nb, nb = jax.lax.top_k(row, 5)

    for i in range(5):
        # a zero-weight "neighbour" is just top_k filler (possibly a KF from
        # a dormant Atlas map) — fusing into it would weld maps incorrectly
        ms = _fuse_into(ms, center_kf, nb[i], w_nb[i] > 0, cfg)
    return ms


@partial(jax.jit, static_argnames=("cfg",))
def fuse_pair(ms: M.MapState, kf_a, kf_b, cfg: MappingConfig):
    """Loop SearchAndFuse (/root/reference/src/LoopClosing.cc:2224): after a
    loop/merge correction, weld the two loop ends by fusing duplicates in
    both directions with a wide search radius (the corrected poses overlap
    but share no observations yet, so covisibility-driven fusion can't see
    the pair)."""
    enabled = ms.kf_valid[kf_a] & ms.kf_valid[kf_b] & (kf_a != kf_b)
    ms = _fuse_into(ms, kf_a, kf_b, enabled, cfg, radius_px=6.0)
    ms = _fuse_into(ms, kf_b, kf_a, enabled, cfg, radius_px=6.0)
    return ms


@partial(jax.jit, static_argnames=("n_window",))
def refresh_point_stats(ms: M.MapState, center_kf, n_window: int = 10,
                        cov=None):
    """MapPoint::ComputeDistinctiveDescriptors + UpdateNormalAndDepth for the
    points observed by the center KF (/root/reference/src/MapPoint.cc): the
    reference refreshes a point's representative descriptor (min median
    Hamming among its observations) and viewing normal (mean unit direction
    from observing KF centers) every time observations change; long-lived
    points otherwise keep their birth descriptor and matching degrades as
    the viewpoint drifts.

    Batched over the center KF's keypoints x a covisibility window of
    `n_window` observing KFs (the reference iterates all observations; the
    window covers them in practice since distant KFs rarely still observe)."""
    from geoflowslam.ops.matching import hamming_matrix

    if cov is None:
        cov = M.covisibility(ms)
    row = (cov[center_kf] * ms.kf_valid).at[center_kf].set(1 << 20)
    _, kf_win = jax.lax.top_k(row, min(n_window, ms.k_max))  # center first

    obs_c = ms.kf_obs_mp[center_kf]                      # [N] mp ids
    has = (obs_c >= 0) & ms.kf_kp_valid[center_kf]
    mp = jnp.maximum(obs_c, 0)
    has = has & ms.mp_valid[mp]
    n = obs_c.shape[0]

    # invert each window KF's obs map: mp -> kp index
    def kp_of(kf):
        o = ms.kf_obs_mp[kf]
        ok = (o >= 0) & ms.kf_kp_valid[kf]
        inv = jnp.full((ms.m_max,), -1, jnp.int32)
        return inv.at[jnp.where(ok, o, ms.m_max)].set(
            jnp.arange(n, dtype=jnp.int32), mode="drop")

    inv_all = jax.vmap(kp_of)(kf_win)                    # [W, M]
    kp_idx = inv_all[:, mp]                              # [W, N]
    seen = (kp_idx >= 0) & ms.kf_valid[kf_win][:, None]  # [W, N]

    # --- distinctive descriptor: min median Hamming over observations -----
    kp_safe = jnp.maximum(kp_idx, 0)
    descs = ms.kf_desc[kf_win[:, None], kp_safe]         # [W, N, 8]
    w = kf_win.shape[0]
    dm = jax.vmap(lambda ds: hamming_matrix(ds, ds), in_axes=1)(descs)  # [N,W,W]
    big = jnp.int32(1 << 10)
    pair_ok = seen.T[:, :, None] & seen.T[:, None, :]    # [N, W, W]
    dmm = jnp.where(pair_ok, dm, big)
    # median over valid entries ~ sorted middle of the valid count
    srt = jnp.sort(dmm, axis=2)                          # [N, W, W]
    n_obs = jnp.sum(seen.T, axis=1)                      # [N]
    mid = jnp.maximum(n_obs // 2, 1)[:, None]
    med = jnp.take_along_axis(
        srt, jnp.broadcast_to(mid[:, :, None], (n, w, 1)), axis=2)[:, :, 0]
    med = jnp.where(seen.T, med, big)                    # [N, W]
    best_w = jnp.argmin(med, axis=1)                     # [N]
    new_desc = descs[best_w, jnp.arange(n)]              # [N, 8]

    # --- viewing normal: mean unit direction from observing centers -------
    centers = -jnp.einsum("wji,wj->wi", ms.kf_rot[kf_win], ms.kf_t[kf_win])
    d = ms.mp_pos[mp][None, :, :] - centers[:, None, :]  # [W, N, 3]
    d = d / jnp.maximum(jnp.linalg.norm(d, axis=-1, keepdims=True), 1e-6)
    nsum = jnp.sum(jnp.where(seen[:, :, None], d, 0.0), axis=0)
    new_norm = nsum / jnp.maximum(jnp.linalg.norm(nsum, axis=-1,
                                                  keepdims=True), 1e-6)

    upd = has & (n_obs >= 2)
    tgt = jnp.where(upd, mp, ms.m_max)
    return ms._replace(
        mp_desc=ms.mp_desc.at[tgt].set(new_desc, mode="drop"),
        mp_normal=ms.mp_normal.at[tgt].set(new_norm, mode="drop"),
    )


# ---------------------------------------------------------------------------
# Monocular triangulation of new points (CreateNewMapPoints)
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("cfg", "max_new", "n_neighbors"))
def triangulate_new_points(ms: M.MapState, center_kf, cfg: MappingConfig,
                           max_new: int = 256, n_neighbors: int = 3):
    """Match unbound keypoints of the center KF against its best covisible
    neighbours (descriptor NN + epipolar gating) and triangulate
    (CreateNewMapPoints uses 10-20 covisible KFs; we unroll the top few)."""
    cov = M.covisibility(ms)
    row = cov[center_kf] * ms.kf_valid
    _, nbs = jax.lax.top_k(row, n_neighbors)
    total = jnp.int32(0)
    for i in range(n_neighbors):
        ms, n_new = _triangulate_with(ms, center_kf, nbs[i], cfg, max_new)
        total = total + n_new
    return ms, total


def _triangulate_with(ms: M.MapState, center_kf, nb, cfg: MappingConfig,
                      max_new: int):
    n = ms.n_kp
    desc_c = ms.kf_desc[center_kf]
    desc_n = ms.kf_desc[nb]
    free_c = ms.kf_kp_valid[center_kf] & (ms.kf_obs_mp[center_kf] == M.NO_MP)
    free_n = ms.kf_kp_valid[nb] & (ms.kf_obs_mp[nb] == M.NO_MP)
    m_idx, m_dist = matching.match_descriptors(
        desc_c, free_c, desc_n, free_n, max_dist=matching.TH_LOW,
        ratio=0.8, mutual=True)

    # rays in each camera
    uv_c = ms.kf_uv[center_kf]
    uv_n = ms.kf_uv[nb][jnp.maximum(m_idx, 0)]
    rays_c = jnp.stack([(uv_c[:, 0] - cfg.cx) / cfg.fx,
                        (uv_c[:, 1] - cfg.cy) / cfg.fy,
                        jnp.ones(n)], axis=1)
    rays_n = jnp.stack([(uv_n[:, 0] - cfg.cx) / cfg.fx,
                        (uv_n[:, 1] - cfg.cy) / cfg.fy,
                        jnp.ones(n)], axis=1)
    # relative pose: T_nc = T_n * T_c^-1 (center cam as reference frame)
    rc, tc = ms.kf_rot[center_kf], ms.kf_t[center_kf]
    rn, tn = ms.kf_rot[nb], ms.kf_t[nb]
    rci, tci = lie.se3_inverse(rc, tc)
    r_nc, t_nc = lie.se3_compose(rn, tn, rci, tci)
    pts_c, tri_ok = triangulate.triangulate_points(rays_c, rays_n, r_nc, t_nc)

    # reprojection checks in both views
    def reproj_err(rays, pts):
        z = jnp.where(jnp.abs(pts[:, 2]) < 1e-6, 1e-6, pts[:, 2])
        return jnp.linalg.norm(pts[:, :2] / z[:, None] - rays[:, :2], axis=1) * cfg.fx

    e1 = reproj_err(rays_c, pts_c)
    pts_n = pts_c @ r_nc.T + t_nc
    e2 = reproj_err(rays_n, pts_n)
    # parallax gate: baseline/depth
    baseline = jnp.linalg.norm(t_nc)
    good = ((m_idx >= 0) & tri_ok & (e1 < 2.0) & (e2 < 2.0)
            & (pts_c[:, 2] > 0.1) & (pts_c[:, 2] < 50.0)
            & (baseline / jnp.maximum(pts_c[:, 2], 1e-3) > 0.01))

    # world coords: X_w = T_c^-1 X_c
    pts_w = pts_c @ rci.T + tci
    # cap count
    _, order = jax.lax.top_k(good.astype(jnp.float32)
                             - 1e-3 * jnp.arange(n, dtype=jnp.float32), max_new)
    sel = jnp.zeros((n,), bool).at[order].set(True)
    make = good & sel

    ms, mp_slots = M.free_mp_slots(ms, n, use_mask=make)
    new_ids = jnp.where(make, mp_slots, M.NO_MP)

    cam_c_w = tci
    d = pts_w - cam_c_w
    dist = jnp.linalg.norm(d, axis=1)
    normal = d / jnp.maximum(dist[:, None], 1e-6)
    lvl = ms.kf_level[center_kf]
    level_sf = cfg.scale_factor ** lvl.astype(jnp.float32)
    max_d = dist * level_sf
    min_d = max_d / (cfg.scale_factor ** 7)

    ms = M.add_map_points(ms, mp_slots, pts_w, desc_c, normal, min_d, max_d,
                          center_kf, make)
    # bind observations in both KFs
    obs_c_new = jnp.where(make, new_ids, ms.kf_obs_mp[center_kf])
    ms = ms._replace(kf_obs_mp=ms.kf_obs_mp.at[center_kf].set(obs_c_new))
    tgt = jnp.where(make & (m_idx >= 0), m_idx, n)
    obs_nb = ms.kf_obs_mp[nb].at[tgt].set(new_ids, mode="drop")
    ms = ms._replace(kf_obs_mp=ms.kf_obs_mp.at[nb].set(obs_nb))
    return ms, jnp.sum(make).astype(jnp.int32)
