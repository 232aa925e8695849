"""Descriptor matching kernels: Hamming search as matmuls.

JAX replacement for ORBmatcher's per-keypoint loops
(/root/reference/src/ORBmatcher.cc): DescriptorDistance's popcount (:2536)
becomes a dense {-1,+1} bfloat16 matmul (dist = (256 - dot)/2) over the full
padded keypoint sets; the grid-based candidate gating (Frame::GetFeaturesInArea)
becomes a dense spatial mask on the same [N, M] tile; the rotation-histogram
consistency check (:2500-2534, HISTO_LENGTH=30, keep top-3 bins) becomes a
one-hot vote + top-k filter.

All functions take padded arrays + validity masks and return padded index
arrays with -1 for "no match", so they compose inside jit with static shapes.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from geoflowslam.ops.orb import unpack_bits_pm1

TH_LOW = 50      # ORBmatcher::TH_LOW
TH_HIGH = 100    # ORBmatcher::TH_HIGH
HISTO_LENGTH = 30
BIG = np.int32(1 << 20)  # host constant; no device op at import


def hamming_matrix(desc_a: jnp.ndarray, desc_b: jnp.ndarray) -> jnp.ndarray:
    """[N,8]u32 x [M,8]u32 -> [N,M] int32 Hamming distances via one matmul.

    With a, b in {-1,+1}^256: dot = 256 - 2*hamming, so
    hamming = (256 - dot) / 2. bf16 accumulation to f32 is exact here
    (integers <= 256).
    """
    a = unpack_bits_pm1(desc_a)                    # [N, 256] bf16
    b = unpack_bits_pm1(desc_b)
    dot = jax.lax.dot_general(
        a, b, (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.DEFAULT,
    )
    return ((256.0 - dot) * 0.5).astype(jnp.int32)


def _best_two(dist: jnp.ndarray):
    """Per-row best and second-best distances + best index. dist [N, M]."""
    neg = -dist
    top2, idx2 = jax.lax.top_k(neg, 2)
    best = -top2[:, 0]
    second = -top2[:, 1]
    return best, second, idx2[:, 0]


def match_descriptors(desc_a, valid_a, desc_b, valid_b, max_dist=TH_LOW,
                      ratio: float = 0.9, mutual: bool = True,
                      mask: jnp.ndarray | None = None):
    """Nearest-neighbour Hamming match with Lowe ratio + optional mutual check.

    Returns (match_idx [N] int32 into B or -1, match_dist [N] int32).
    `mask` [N, M] optionally restricts candidate pairs (spatial gating).
    """
    dist = hamming_matrix(desc_a, desc_b)
    invalid = (~valid_a[:, None]) | (~valid_b[None, :])
    if mask is not None:
        invalid = invalid | (~mask)
    dist = jnp.where(invalid, BIG, dist)

    best, second, bidx = _best_two(dist)
    ok = (best <= max_dist) & (best.astype(jnp.float32) <= ratio * second.astype(jnp.float32))

    if mutual:
        # B's best A must be this row.
        distT = jnp.where(invalid, BIG, hamming_matrix(desc_a, desc_b)).T
        b_best_a = jnp.argmin(distT, axis=1)        # [M]
        ok = ok & (b_best_a[bidx] == jnp.arange(desc_a.shape[0]))

    return jnp.where(ok, bidx, -1), jnp.where(ok, best, BIG)


def rotation_consistency(angles_a, angles_b, match_idx, n_keep: int = 3):
    """Keep matches whose angle difference falls in the top-`n_keep` of a
    HISTO_LENGTH-bin rotation histogram (ORBmatcher.cc:2500-2534)."""
    valid = match_idx >= 0
    idx_safe = jnp.maximum(match_idx, 0)
    rot = angles_a - angles_b[idx_safe]
    rot = jnp.mod(rot, 2 * jnp.pi)
    bins = jnp.clip((rot * (HISTO_LENGTH / (2 * jnp.pi))).astype(jnp.int32), 0, HISTO_LENGTH - 1)
    hist = jnp.sum(jax.nn.one_hot(bins, HISTO_LENGTH, dtype=jnp.int32) * valid[:, None].astype(jnp.int32), axis=0)
    top_vals, top_idx = jax.lax.top_k(hist, n_keep)
    keep_bin = jnp.zeros((HISTO_LENGTH,), bool).at[top_idx].set(top_vals > 0)
    return jnp.where(valid & keep_bin[bins], match_idx, -1)


def spatial_mask(uv_query: jnp.ndarray, uv_target: jnp.ndarray,
                 radius: jnp.ndarray) -> jnp.ndarray:
    """[N,2] query centers vs [M,2] target kps, per-query radius [N] -> [N,M].

    Dense replacement for Frame::GetFeaturesInArea's 64x48 grid walk
    (/root/reference/src/Frame.cc:1007-1085).
    """
    d = uv_query[:, None, :] - uv_target[None, :, :]
    return (jnp.abs(d[..., 0]) <= radius[:, None]) & (jnp.abs(d[..., 1]) <= radius[:, None])


def level_mask(level_query: jnp.ndarray, level_target: jnp.ndarray,
               min_off: int = 0, max_off: int = 1) -> jnp.ndarray:
    """Scale-octave gating as in SearchByProjection (target level within
    [pred_level + min_off, pred_level + max_off])."""
    d = level_target[None, :] - level_query[:, None]
    return (d >= min_off) & (d <= max_off)


def search_by_projection(uv_proj, level_pred, valid_proj, desc_query, feat_uv,
                         feat_level, feat_desc, feat_valid, radius,
                         max_dist=TH_HIGH, ratio=0.9,
                         min_off: int = -1, max_off: int = 1):
    """Projection-guided search (frame-from-last-frame flavour,
    ORBmatcher::SearchByProjection /root/reference/src/ORBmatcher.cc:1853).

    Args:
      uv_proj: [N,2] predicted pixel positions of query map points/features.
      level_pred: [N] predicted octave.
      valid_proj: [N] projection validity (in front, in image).
      desc_query: [N,8] query descriptors.
      feat_*: target frame's padded FeatureSet fields.
      radius: [N] per-query search radius in pixels (already scale-adjusted).
    Returns (match_idx [N] into target features, dist [N]).
    """
    m = spatial_mask(uv_proj, feat_uv, radius)
    m = m & level_mask(level_pred, feat_level, min_off, max_off)
    m = m & valid_proj[:, None]
    return match_descriptors(desc_query, valid_proj, feat_desc, feat_valid,
                             max_dist=max_dist, ratio=ratio, mutual=False, mask=m)
