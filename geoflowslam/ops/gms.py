"""GMS (Grid-based Motion Statistics) match verification as dense grid votes.

JAX replacement for Thirdparty/GMS/include/gms_matcher.h
(/root/reference, used by ORBmatcher::SearchWithGMS and
SearchForInitializationWithGMS, src/ORBmatcher.cc:744-852): 20x20 grids on
both images, cell-pair vote accumulation, 3x3 aligned-neighbourhood score and
the THRESH_FACTOR=6 * sqrt(mean-support) threshold.

The reference loops over 4 half-cell grid shifts and per-cell best-pair maps;
here votes are a single scatter into a [G*G, G*G] matrix and the
neighbourhood sum is 9 shifted adds of the reshaped [G,G,G,G] tensor, with
the grid-shift loop unrolled (4 static iterations). Rotation/scale pattern
search (8 rotations x 5 scales in the reference) is approximated by the
aligned pattern, which is the configuration the reference actually runs with
for initialization (WithRotation=false, WithScale=false defaults).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

GRID = 20
THRESH_FACTOR = 6.0


def _cell_ids(uv, w, h, shift_x, shift_y):
    """Cell index per keypoint for one of the 4 half-cell-shifted grids."""
    cw, ch = w / GRID, h / GRID
    cx = jnp.clip(((uv[:, 0] + shift_x * cw / 2) / cw).astype(jnp.int32), 0, GRID - 1)
    cy = jnp.clip(((uv[:, 1] + shift_y * ch / 2) / ch).astype(jnp.int32), 0, GRID - 1)
    return cy * GRID + cx


def gms_filter(uv_a: jnp.ndarray, uv_b: jnp.ndarray, match_idx: jnp.ndarray,
               size_a, size_b) -> jnp.ndarray:
    """Filter matches by grid motion statistics.

    Args:
      uv_a: [N,2] keypoints in image A; uv_b: [M,2] in image B.
      match_idx: [N] index into B or -1.
      size_a, size_b: (w, h) static tuples.
    Returns filtered match_idx ([N], -1 where rejected).
    """
    wa, ha = size_a
    wb, hb = size_b
    valid = match_idx >= 0
    idx_safe = jnp.maximum(match_idx, 0)
    uvb = uv_b[idx_safe]

    keep_any = jnp.zeros_like(valid)
    for shift in range(4):  # 4 half-cell grid offsets, as in the reference
        sx, sy = shift % 2, shift // 2
        ca = _cell_ids(uv_a, wa, ha, sx, sy)                       # [N]
        cb = _cell_ids(uvb, wb, hb, sx, sy)
        pair = ca * (GRID * GRID) + cb
        votes = jnp.zeros((GRID * GRID * GRID * GRID,), jnp.float32)
        votes = votes.at[pair].add(valid.astype(jnp.float32))
        v4 = votes.reshape(GRID, GRID, GRID, GRID)                 # [ay,ax,by,bx]

        # Aligned 3x3 neighbourhood: score(a, b) = sum_{d} votes[a+d, b+d];
        # support = number of features in the 3x3 left neighbourhood.
        feat_per_cell = jnp.zeros((GRID * GRID,), jnp.float32).at[ca].add(valid.astype(jnp.float32))
        f2 = feat_per_cell.reshape(GRID, GRID)
        score = jnp.zeros_like(v4)
        support = jnp.zeros_like(f2)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                score = score + _shift4(v4, dy, dx)
                support = support + _shift2(f2, dy, dx)
        thresh = THRESH_FACTOR * jnp.sqrt(support / 9.0)           # [ay,ax]
        cell_pass = score > thresh[:, :, None, None]               # [ay,ax,by,bx]
        # Tolerate one-cell quantization of the right cell (matches whose
        # b-cell straddles a border relative to the dominant motion family):
        # dilate the pass mask over the (by, bx) 3x3 neighbourhood.
        cp = cell_pass
        dil = jnp.zeros_like(cp)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                dil = dil | _shift_axis(_shift_axis(cp, dy, 2), dx, 3).astype(bool)
        keep = dil.reshape(-1)[pair]
        keep_any = keep_any | (keep & valid)

    return jnp.where(keep_any, match_idx, -1)


def _shift4(v4, dy, dx):
    """votes[ay+dy, ax+dx, by+dy, bx+dx] with zero padding at borders."""
    out = v4
    for axis, d in ((0, dy), (1, dx), (2, dy), (3, dx)):
        out = _shift_axis(out, d, axis)
    return out


def _shift2(f2, dy, dx):
    return _shift_axis(_shift_axis(f2, dy, 0), dx, 1)


def _shift_axis(x, d, axis):
    if d == 0:
        return x
    rolled = jnp.roll(x, -d, axis)
    # zero out wrapped entries
    n = x.shape[axis]
    idx = jnp.arange(n)
    ok = (idx + d >= 0) & (idx + d < n)
    shape = [1] * x.ndim
    shape[axis] = n
    return rolled * ok.reshape(shape)
