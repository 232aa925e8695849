"""Image pyramid + separable Gaussian blur + CLAHE.

JAX replacement for ORBextractor::ComputePyramid
(/root/reference/src/ORBextractor.cc:1227-1252, 8 levels x1.2 via cv::resize),
the pre-descriptor GaussianBlur(7x7, sigma=2) in computeDescriptors, and the
cv::CLAHE contrast equalization applied in the Frame ctor
(/root/reference/src/Frame.cc:366-373).

All shapes are static Python ints so every level compiles once; images are
float32 [H, W] in [0, 255].
"""
from __future__ import annotations

import functools
import math
from typing import List, Tuple

import jax
import jax.numpy as jnp


def pyramid_shapes(h: int, w: int, n_levels: int, scale_factor: float) -> List[Tuple[int, int]]:
    """Static per-level (h, w), matching cv::resize rounding in the reference."""
    shapes = []
    for lvl in range(n_levels):
        inv = 1.0 / (scale_factor ** lvl)
        shapes.append((int(round(h * inv)), int(round(w * inv))))
    return shapes


def resize_bilinear(img: jnp.ndarray, out_h: int, out_w: int) -> jnp.ndarray:
    """Bilinear resize with static output shape (cv::INTER_LINEAR analogue)."""
    return jax.image.resize(img, (out_h, out_w), method="bilinear")


def build_pyramid(img: jnp.ndarray, n_levels: int, scale_factor: float):
    """Returns a list of [h_l, w_l] float32 arrays (level 0 = input)."""
    h, w = img.shape
    shapes = pyramid_shapes(h, w, n_levels, scale_factor)
    levels = [img]
    for lvl in range(1, n_levels):
        # Reference resizes from the previous level, not level 0.
        levels.append(resize_bilinear(levels[-1], *shapes[lvl]))
    return levels


def _gaussian_kernel1d(ksize: int, sigma: float):
    import numpy as np

    r = (ksize - 1) / 2.0
    x = np.arange(ksize, dtype=np.float32) - r
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return k / np.sum(k)   # numpy: compile-time constant (jit-safe)


def gaussian_blur(img: jnp.ndarray, ksize: int = 7, sigma: float = 2.0) -> jnp.ndarray:
    """Separable Gaussian blur with reflect padding (BORDER_REFLECT_101).

    Implemented as shift-and-add instead of a single-channel lax.conv: the
    unrolled shifts fuse into one elementwise pass per axis.
    """
    k = _gaussian_kernel1d(ksize, sigma)
    pad = ksize // 2
    x = jnp.pad(img, ((pad, pad), (0, 0)), mode="reflect")
    h = img.shape[0]
    out = None
    for i in range(ksize):
        term = x[i:i + h, :] * float(k[i])
        out = term if out is None else out + term
    x = jnp.pad(out, ((0, 0), (pad, pad)), mode="reflect")
    w = img.shape[1]
    out = None
    for i in range(ksize):
        term = x[:, i:i + w] * float(k[i])
        out = term if out is None else out + term
    return out


def clahe(img: jnp.ndarray, clip_limit: float = 3.0, grid: int = 8,
          n_bins: int = 256) -> jnp.ndarray:
    """Contrast-limited adaptive histogram equalization.

    Equivalent of cv::createCLAHE(3.0, (8,8)) used on every input frame
    (/root/reference/src/Frame.cc:305-310, Tracking config UseClahe).

    Scatter-histograms and per-pixel LUT gathers are expressed through a
    hi/lo nibble decomposition of the 8-bit bin index: one-hot over 16 'hi'
    and 16 'lo' values turns the histogram into a [16, P] x [P, 16] batched
    matmul per tile and the LUT application into a ph,hl,pl->p contraction,
    with no scatter and no gather. Requires H, W divisible by `grid`.
    """
    h, w = img.shape
    th, tw = h // grid, w // grid
    n_tiles = grid * grid
    p = th * tw
    x = jnp.clip(img, 0, 255)
    tiles = x.reshape(grid, th, grid, tw).transpose(0, 2, 1, 3).reshape(n_tiles, p)
    idx = jnp.clip(jnp.round(tiles), 0, 255)
    hi = jnp.floor(idx / 16.0)
    lo = idx - hi * 16.0

    rng16 = jnp.arange(16, dtype=jnp.float32)
    oh_hi = (hi[..., None] == rng16).astype(jnp.bfloat16)     # [T, P, 16]
    oh_lo = (lo[..., None] == rng16).astype(jnp.bfloat16)
    # hist2d[t, hi, lo] = sum_p oh_hi * oh_lo  (batched 16xPx16 matmul)
    hist2d = jnp.einsum("tph,tpl->thl", oh_hi, oh_lo,
                        preferred_element_type=jnp.float32)
    hist = hist2d.reshape(n_tiles, n_bins)                    # [T, 256]

    # Clip histogram and redistribute excess uniformly (OpenCV semantics).
    limit = jnp.maximum(clip_limit * p / n_bins, 1.0)
    clipped = jnp.minimum(hist, limit)
    excess = jnp.sum(hist - clipped, axis=1, keepdims=True)
    hist_c = clipped + excess / n_bins
    cdf = jnp.cumsum(hist_c, axis=1)
    lut = jnp.clip(jnp.round(cdf * (255.0 / p)), 0, 255)      # [T, 256]
    lut2d = lut.reshape(grid, grid, 16, 16)                   # [gy, gx, hi, lo]

    # Per-pixel LUT value for each of the 4 neighbouring tiles, as
    # contractions: val[t, p] = oh_hi . lut2d[tile] . oh_lo
    def apply_lut(lut_sel):  # lut_sel: [T, 16, 16] -> [T, P]
        return jnp.einsum("tph,thl,tpl->tp", oh_hi,
                          lut_sel.astype(jnp.bfloat16), oh_lo,
                          preferred_element_type=jnp.float32)

    # tile index of each tile's 4 bilinear source tiles: pixels inside tile
    # (gy, gx) interpolate between tiles (gy0..gy1, gx0..gx1) that depend on
    # the pixel position within the tile; evaluate the 4 shifted-tile LUTs.
    ty = jnp.arange(grid)
    tx = jnp.arange(grid)

    def shifted(dy, dx):
        yy = jnp.clip(ty + dy, 0, grid - 1)
        xx = jnp.clip(tx + dx, 0, grid - 1)
        return lut2d[yy[:, None], xx[None, :]].reshape(n_tiles, 16, 16)

    v_c = apply_lut(shifted(0, 0))      # own tile
    v_u = apply_lut(shifted(-1, 0))     # up
    v_d = apply_lut(shifted(1, 0))
    v_l = apply_lut(shifted(0, -1))
    v_r = apply_lut(shifted(0, 1))
    v_ul = apply_lut(shifted(-1, -1))
    v_ur = apply_lut(shifted(-1, 1))
    v_dl = apply_lut(shifted(1, -1))
    v_dr = apply_lut(shifted(1, 1))

    # bilinear weights within each tile (pixel at local (py, px))
    py = (jnp.arange(th, dtype=jnp.float32) + 0.5) / th - 0.5   # in [-0.5, 0.5)
    px = (jnp.arange(tw, dtype=jnp.float32) + 0.5) / tw - 0.5
    wy_up = jnp.maximum(-py, 0.0)[:, None]     # weight of the tile above
    wy_dn = jnp.maximum(py, 0.0)[:, None]
    wy_c = 1.0 - wy_up - wy_dn
    wx_lf = jnp.maximum(-px, 0.0)[None, :]
    wx_rt = jnp.maximum(px, 0.0)[None, :]
    wx_c = 1.0 - wx_lf - wx_rt

    def t2d(v):  # [T, P] -> [H, W]
        return v.reshape(grid, grid, th, tw).transpose(0, 2, 1, 3).reshape(h, w)

    wy_up_f = jnp.tile(wy_up, (grid, 1))
    wy_dn_f = jnp.tile(wy_dn, (grid, 1))
    wy_c_f = jnp.tile(wy_c, (grid, 1))
    wx_lf_f = jnp.tile(wx_lf, (1, grid))
    wx_rt_f = jnp.tile(wx_rt, (1, grid))
    wx_c_f = jnp.tile(wx_c, (1, grid))

    out = (
        t2d(v_c) * wy_c_f * wx_c_f
        + t2d(v_u) * wy_up_f * wx_c_f + t2d(v_d) * wy_dn_f * wx_c_f
        + t2d(v_l) * wy_c_f * wx_lf_f + t2d(v_r) * wy_c_f * wx_rt_f
        + t2d(v_ul) * wy_up_f * wx_lf_f + t2d(v_ur) * wy_up_f * wx_rt_f
        + t2d(v_dl) * wy_dn_f * wx_lf_f + t2d(v_dr) * wy_dn_f * wx_rt_f
    )
    return out
