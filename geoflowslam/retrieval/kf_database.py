"""Keyframe database: BoW store + loop/reloc candidate retrieval.

JAX replacement for KeyFrameDatabase
(/root/reference/src/KeyFrameDatabase.cc): the DBoW2 inverted file
(word -> KF list) becomes a dense [K_MAX, V] BoW matrix next to the MapState;
DetectNBestCandidates / DetectRelocalizationCandidates become masked batched
L1-score reductions over that matrix (one fused pass instead of inverted-
index walks — K_MAX is small, V is a few thousand).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from geoflowslam.retrieval import vocab as V
from geoflowslam.state import map_state as M


class KFDatabase(NamedTuple):
    bow: jnp.ndarray     # [K_MAX, V] L1-normalized tf-idf vectors
    valid: jnp.ndarray   # [K_MAX]

    @staticmethod
    def create(k_max: int, n_words: int):
        return KFDatabase(bow=jnp.zeros((k_max, n_words), jnp.float32),
                          valid=jnp.zeros((k_max,), bool))


def add_keyframe(db: KFDatabase, vocab: V.Vocabulary, slot,
                 desc: jnp.ndarray, kp_valid: jnp.ndarray) -> KFDatabase:
    words = V.descend(vocab, desc, kp_valid)
    vec = V.bow_vector(vocab, words)
    return KFDatabase(bow=db.bow.at[slot].set(vec),
                      valid=db.valid.at[slot].set(True))


def erase_keyframe(db: KFDatabase, slot) -> KFDatabase:
    return db._replace(valid=db.valid.at[slot].set(False))


def detect_candidates(db: KFDatabase, ms: M.MapState, query_vec: jnp.ndarray,
                      query_kf, n_best: int = 3, exclude_window: int = 10,
                      group_size: int = 10):
    """Loop/merge candidates for `query_kf` with covisibility-group scoring
    (KeyFrameDatabase::DetectNBestCandidates,
    /root/reference/src/KeyFrameDatabase.cc): each candidate's score is
    accumulated over its covisibility group (itself + top-`group_size`
    covisible KFs), ranking by the group sum but returning the group's
    best-scoring member — a single aliased view can't win against a
    consistently-matching region.

    Returns (cand_idx [n_best], cand_score [n_best], cand_ok [n_best])."""
    scores = V.l1_score(db.bow, query_vec[None, :])          # [K]
    cov = M.covisibility(ms)
    connected = cov[query_kf] > 0
    mask = (db.valid & ms.kf_valid & ~connected)
    mask = mask.at[query_kf].set(False)
    # exclude temporally-adjacent KFs of the SAME map (dormant Atlas maps are
    # always eligible — that's the merge path, LoopClosing::MergeLocal)
    dt = jnp.abs(ms.kf_time - ms.kf_time[query_kf])
    same_map = ms.kf_map_id == ms.kf_map_id[query_kf]
    mask = mask & ~(same_map & (dt < 3.0))
    s = jnp.where(mask, scores, 0.0)

    g = min(group_size, ms.k_max)
    nb_w, nb_idx = jax.lax.top_k(cov, g)                     # [K, g]
    member_s = s[nb_idx] * (nb_w > 0)                        # [K, g]
    acc = s + jnp.sum(member_s, axis=1)
    # group representative: best-scoring member (incl. the candidate itself)
    g_scores = jnp.concatenate([s[:, None], member_s], axis=1)   # [K, g+1]
    g_idx = jnp.concatenate(
        [jnp.arange(ms.k_max, dtype=jnp.int32)[:, None], nb_idx], axis=1)
    best_loc = jnp.argmax(g_scores, axis=1)
    best_member = jnp.take_along_axis(g_idx, best_loc[:, None], axis=1)[:, 0]
    best_member_s = jnp.take_along_axis(g_scores, best_loc[:, None],
                                        axis=1)[:, 0]

    acc = jnp.where(mask, acc, -1.0)
    vals, idx = jax.lax.top_k(acc, n_best)
    cand = best_member[idx].astype(jnp.int32)
    cand_s = best_member_s[idx]
    return cand, cand_s, (vals > 0.0) & (cand_s > 0.0)


def detect_relocalization_candidates(db: KFDatabase, ms: M.MapState,
                                     query_vec: jnp.ndarray, n_best: int = 5):
    """Relocalization candidates: best-scoring valid KFs of the ACTIVE map
    (DetectRelocalizationCandidates takes the active Map* and filters to it,
    /root/reference/src/KeyFrameDatabase.cc — cross-map healing is the
    merge path's job, LoopClosing::MergeLocal)."""
    scores = V.l1_score(db.bow, query_vec[None, :])
    active = ms.kf_map_id == ms.active_map
    s = jnp.where(db.valid & ms.kf_valid & active, scores, -1.0)
    vals, idx = jax.lax.top_k(s, n_best)
    return idx, vals, vals > 0.0
