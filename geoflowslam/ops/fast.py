"""FAST corner detection + grid keypoint distribution, fully vectorized.

JAX replacement for the per-cell cv::FAST loops and the recursive
quad-tree keypoint distribution in ORBextractor::ComputeKeyPointsOctTree /
DistributeOctTree (/root/reference/src/ORBextractor.cc:567-1143).

Design: the detector is a dense stencil over the whole level (16 shifted
views of the padded image -> bright/dark arc test via circular windowed
sums), which XLA fuses into a handful of vectorized passes — no per-cell
Python. The reference's octree spatial balancing is replaced by per-cell
top-k followed by global top-k, which yields the same qualitative spread
(bounded per-cell density, response-sorted) with fixed shapes.

The reference's two-threshold fallback (iniThFAST=20 then minThFAST=7 for
empty cells, ORBextractor.cc:770+) is reproduced exactly: scores are computed
at the low threshold and a per-cell flag selects which threshold's corners
are eligible.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

# Bresenham circle of radius 3: 16 (dy, dx) offsets, standard FAST-9/16 ring.
_CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)
ARC_LEN = 9  # FAST-9: need >= 9 contiguous pixels


def fast_score_maps(img: jnp.ndarray, thresholds) -> list:
    """Dense FAST-9 corner responses of img [H, W] for several thresholds,
    sharing the 16-ring stencil (one shifted-diff pass for all thresholds).

    Score is the sum over the ring of max(|diff| - t, 0) on the majority side,
    zeroed where the contiguous-arc test fails (a VLFeat-style response with
    the same ordering behaviour as OpenCV's max-threshold score).
    """
    h, w = img.shape
    r = 3
    pad = jnp.pad(img, r, mode="edge")
    center = img
    diffs = jnp.stack(
        [pad[r + dy: r + dy + h, r + dx: r + dx + w] - center for dy, dx in _CIRCLE],
        axis=0,
    )  # [16, H, W]

    ys = jnp.arange(h)[:, None]
    xs = jnp.arange(w)[None, :]
    inside = (ys >= r) & (ys < h - r) & (xs >= r) & (xs < w - r)

    def arc_ok(bits):
        """bits: [H, W] int32 with ring membership in bits 0..15. Contiguous
        run >= 9 detected by bitwise shift-AND folding (one array, no
        [16, H, W] cumsum stack)."""
        m = bits | (bits << 16)          # unwrap the circular ring
        t = m & (m >> 1)                  # runs >= 2
        t = t & (t >> 2)                  # runs >= 4
        t = t & (t >> 4)                  # runs >= 8
        t = t & (m >> 8)                  # runs >= 9
        return (t & jnp.int32(0xFFFF)) != 0

    out = []
    for threshold in thresholds:
        bright_bits = jnp.zeros((h, w), jnp.int32)
        dark_bits = jnp.zeros((h, w), jnp.int32)
        sb = jnp.zeros((h, w), img.dtype)
        sd = jnp.zeros((h, w), img.dtype)
        for k in range(16):
            d = diffs[k]
            bright_bits = bright_bits | ((d > threshold).astype(jnp.int32) << k)
            dark_bits = dark_bits | ((d < -threshold).astype(jnp.int32) << k)
            sb = sb + jnp.maximum(d - threshold, 0.0)
            sd = sd + jnp.maximum(-d - threshold, 0.0)
        score = jnp.where(arc_ok(bright_bits), sb, 0.0) \
            + jnp.where(arc_ok(dark_bits), sd, 0.0)
        out.append(jnp.where(inside, score, 0.0))
    return out


def fast_score_map(img: jnp.ndarray, threshold: float) -> jnp.ndarray:
    return fast_score_maps(img, [threshold])[0]


def nms3x3(score: jnp.ndarray) -> jnp.ndarray:
    """3x3 non-maximum suppression (keeps strict local maxima).

    Written as 8 shifted elementwise maxes, which fuse into the surrounding
    stencil pipeline."""
    h, w = score.shape
    p = jnp.pad(score, 1, constant_values=-jnp.inf)
    m = score
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            m = jnp.maximum(m, p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w])
    return jnp.where(score >= m, score, 0.0)


class LevelKeypoints(NamedTuple):
    xy: jnp.ndarray        # [N, 2] float32 (x, y) in level coords
    score: jnp.ndarray     # [N]
    valid: jnp.ndarray     # [N] bool


def detect_level(img: jnp.ndarray, n_keypoints: int, ini_threshold: float,
                 min_threshold: float, cell_size: int = 32,
                 per_cell_cap: int = 8, border: int = 16) -> LevelKeypoints:
    """Detect up to n_keypoints FAST corners with spatial balancing.

    1. score at min_threshold (dense), NMS.
    2. cells where the best score clears ini_threshold's response keep only
       strong corners; starved cells fall back to the low threshold
       (reference two-pass fallback, ORBextractor.cc:793-860).
    3. per-cell top-`per_cell_cap`, then global top-`n_keypoints`.
    """
    h, w = img.shape
    s_low, s_high = fast_score_maps(img, [min_threshold, ini_threshold])
    score_low = nms3x3(s_low)
    score_high = nms3x3(s_high)

    ys = jnp.arange(h)[:, None]
    xs = jnp.arange(w)[None, :]
    inb = (ys >= border) & (ys < h - border) & (xs >= border) & (xs < w - border)
    score_low = jnp.where(inb, score_low, 0.0)
    score_high = jnp.where(inb, score_high, 0.0)

    # Pad to multiples of cell_size with zeros.
    ph = (h + cell_size - 1) // cell_size * cell_size
    pw = (w + cell_size - 1) // cell_size * cell_size
    sl = jnp.pad(score_low, ((0, ph - h), (0, pw - w)))
    sh = jnp.pad(score_high, ((0, ph - h), (0, pw - w)))
    ncy, ncx = ph // cell_size, pw // cell_size

    def cells(s):
        return (
            s.reshape(ncy, cell_size, ncx, cell_size)
            .transpose(0, 2, 1, 3)
            .reshape(ncy * ncx, cell_size * cell_size)
        )

    cl, ch = cells(sl), cells(sh)
    cell_has_high = jnp.any(ch > 0, axis=1, keepdims=True)
    # Use high-threshold corners where present, low-threshold otherwise.
    eligible = jnp.where(cell_has_high, ch, cl)  # [C, cs*cs]

    k = per_cell_cap
    top_s, top_i = jax.lax.top_k(eligible, k)          # [C, k]
    cell_ids = jnp.arange(ncy * ncx)[:, None]
    cy = cell_ids // ncx
    cx = cell_ids % ncx
    py = top_i // cell_size
    px = top_i % cell_size
    gy = cy * cell_size + py
    gx = cx * cell_size + px

    flat_s = top_s.reshape(-1)
    flat_y = gy.reshape(-1)
    flat_x = gx.reshape(-1)

    n = min(n_keypoints, flat_s.shape[0])
    sel_s, sel_i = jax.lax.top_k(flat_s, n)
    xy = jnp.stack([flat_x[sel_i], flat_y[sel_i]], axis=-1).astype(jnp.float32)
    valid = sel_s > 0
    if n < n_keypoints:
        padn = n_keypoints - n
        xy = jnp.concatenate([xy, jnp.zeros((padn, 2), jnp.float32)])
        sel_s = jnp.concatenate([sel_s, jnp.zeros((padn,), sel_s.dtype)])
        valid = jnp.concatenate([valid, jnp.zeros((padn,), bool)])
    return LevelKeypoints(xy=xy, score=sel_s, valid=valid)
