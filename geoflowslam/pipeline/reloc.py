"""Relocalization core: BoW retrieval -> per-candidate PnP -> pose GN.

Tracking::Relocalization (/root/reference/src/Tracking.cc:4537) as ONE
traceable function: BoW descent + candidate retrieval
(KeyFrameDatabase::DetectRelocalizationCandidates) + per-candidate
(descriptor match -> GMS prune -> PnP RANSAC -> MLPnP GN refine ->
pose-only GN), vmapped over the top-N candidates, best-by-inliers selected
ON DEVICE.

Shared by two callers:
  * the standalone jitted reloc dispatch (SlamSystem._build_reloc_jit,
    staged-path recovery: one dispatch + one scalar read), and
  * the fused recovery frame step (pipeline/fused.frame_step with
    with_recovery=True): reloc runs INSIDE the per-frame dispatch under a
    lax.cond when tracking failed, adopting the relocalized pose on device
    so recovery happens at frame rate with zero extra host syncs — the
    reference runs Relocalization in-line at camera rate on a CPU.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from geoflowslam.ops import matching as MATCH
from geoflowslam.ops import ransac as RS
from geoflowslam.ops.gms import gms_filter
from geoflowslam.retrieval import kf_database as DBD
from geoflowslam.retrieval import vocab as Vv
from geoflowslam.state import map_state as M
from geoflowslam.pipeline import tracking as T


def reloc_core(vocab, db: DBD.KFDatabase, ms: M.MapState, frame, key,
               tcfg, w: int, h: int, fx, fy, cx, cy, n_best: int = 3):
    """Traceable relocalization over the top-`n_best` BoW candidates.

    Returns (n_inl, rot, t, obs_mp, cand_slot) of the best candidate —
    n_inl is the pose-GN inlier count the caller gates on
    (>= min_inliers_ok, as Tracking.cc:4660's nGood >= 50 essence)."""
    feat = frame.feat
    words = Vv.descend(vocab, feat.desc, feat.valid)
    qvec = Vv.bow_vector(vocab, words)
    idx, _score, ok = DBD.detect_relocalization_candidates(
        db, ms, qvec, n_best=n_best)
    uvn = (feat.uv - jnp.array([cx, cy])) / jnp.array([fx, fy])
    keys = jax.random.split(key, n_best)

    def try_cand(kf, okc, k):
        m_idx, _ = MATCH.match_descriptors(
            feat.desc, feat.valid, ms.kf_desc[kf],
            ms.kf_kp_valid[kf] & (ms.kf_obs_mp[kf] >= 0),
            max_dist=MATCH.TH_LOW, ratio=0.85, mutual=True)
        # GMS grid-motion-statistics prune (SearchWithGMS,
        # src/ORBmatcher.cc:744): wide-baseline reloc matches are
        # outlier-heavy; the grid vote prunes before PnP RANSAC.
        m_idx = gms_filter(feat.uv, ms.kf_uv[kf], m_idx, (w, h), (w, h))
        mp = ms.kf_obs_mp[kf][jnp.maximum(m_idx, 0)]
        valid = (m_idx >= 0) & (mp >= 0) \
            & ms.mp_valid[jnp.maximum(mp, 0)] & okc
        n_valid = jnp.sum(valid)
        pts = ms.mp_pos[jnp.maximum(mp, 0)]
        res = RS.ransac_pnp(k, pts, uvn, valid, threshold_px=5.99,
                            focal=fx)
        # ML bearing-vector refinement of the RANSAC hypothesis
        # (MLPnPsolver::mlpnp_gn parity, src/Tracking.cc:4586-4593)
        rot0, t0 = RS.refine_pnp_ml(
            res.model[:, :3], res.model[:, 3], pts, uvn, res.inliers)
        obs_mp = jnp.where(valid, mp, M.NO_MP)
        rot, t, obs2, n_inl = T._pose_opt_from_obs(
            ms, frame, obs_mp, rot0, t0, tcfg)
        gate = okc & (n_valid >= 15) & (res.n_inliers >= 10)
        return jnp.where(gate, n_inl, 0), rot, t, obs2

    n_inls, rots, ts, obs2s = jax.vmap(try_cand)(idx, ok, keys)
    b = jnp.argmax(n_inls)
    return n_inls[b], rots[b], ts[b], obs2s[b], idx[b]
