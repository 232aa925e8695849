"""ORB orientation + rotated BRIEF-256 descriptors, batched.

JAX replacement for ORBextractor::computeOrientation (intensity
centroid over a 31x31 circular patch) and computeOrbDescriptor (steered
BRIEF-256 on the Gaussian-blurred image)
(/root/reference/src/ORBextractor.cc:99-480).

Two deliberate departures from the reference, both documented:

* Orientation moments are computed as two dense depthwise convolutions over
  the whole level (x- and y-weighted circular masks) followed by a single
  gather per keypoint, instead of per-keypoint patch loops — identical values,
  one fused conv instead of N scattered reads.
* The BRIEF sampling pattern is a deterministically generated Gaussian pair
  pattern (seeded, sigma = patch/5 as in the BRIEF paper) rather than the
  learned table hard-coded in OpenCV/ORB-SLAM. Descriptors are therefore not
  bit-compatible with the C++ build (matching behaviour and invariances are
  equivalent); vocabularies are trained for this pattern (retrieval/vocab.py).

Descriptors are returned as [N, 8] uint32 (256 bits).
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

PATCH_SIZE = 31
HALF_PATCH = 15
N_BITS = 256


def _umax_per_row():
    """Half-width of the centroid disc per |dy| (the reference's umax circle,
    ORBextractor ctor)."""
    r = HALF_PATCH
    return [int(np.floor(np.sqrt(max(r * r + r * 0.5 - v * v, 0.0))))
            for v in range(r + 1)]


def _circular_masks():
    """x/y-weighted circular masks for the intensity centroid, built from the
    same per-row umax table the moment maps use (self-consistent disc)."""
    umax = _umax_per_row()
    vs, us = np.mgrid[-HALF_PATCH:HALF_PATCH + 1, -HALF_PATCH:HALF_PATCH + 1]
    disc = np.abs(us) <= np.array([umax[abs(v)] for v in range(-HALF_PATCH, HALF_PATCH + 1)])[:, None]
    mx = (us * disc).astype(np.float32)
    my = (vs * disc).astype(np.float32)
    # numpy (not jnp): module-level cache must hold constants, never tracers
    return mx, my


_MX, _MY = None, None


def _get_masks():
    global _MX, _MY
    if _MX is None:
        _MX, _MY = _circular_masks()
    return _MX, _MY


def orientation_maps(img: jnp.ndarray):
    """Dense m10/m01 moment maps; angle = atan2(m01, m10) at keypoints.

    Instead of a dense 31x31 single-channel convolution, the moments are
    built from x-prefix sums: per disc row dy with half-width w, the
    windowed x-weighted sum is two slice differences of cumsum arrays
    (sum dx*I = sum (u+dx)*I - u*sum I): 31 rows x a few fused slices.
    """
    h, w_img = img.shape
    pad = HALF_PATCH
    umax = _umax_per_row()

    xs = jnp.arange(w_img + 2 * pad + 1, dtype=img.dtype)
    ys = jnp.arange(h + 2 * pad + 1, dtype=img.dtype)

    imgp = jnp.pad(img, pad)  # zero pad; detector border >= 16 excludes edges
    # prefix sums along x: P[v, u] = sum_{u'<u} I, Q = sum u' * I
    p_x = jnp.pad(jnp.cumsum(imgp, axis=1), ((0, 0), (1, 0)))
    q_x = jnp.pad(jnp.cumsum(imgp * xs[None, :-1], axis=1), ((0, 0), (1, 0)))
    # prefix sums along y for m01
    p_y = jnp.pad(jnp.cumsum(imgp, axis=0), ((1, 0), (0, 0)))
    q_y = jnp.pad(jnp.cumsum(imgp * ys[:-1, None], axis=0), ((1, 0), (0, 0)))

    u0 = jnp.arange(w_img, dtype=img.dtype) + pad   # padded x-coord of center
    v0 = jnp.arange(h, dtype=img.dtype) + pad

    m10 = jnp.zeros_like(img)
    m01 = jnp.zeros_like(img)
    for dy in range(-pad, pad + 1):
        w = umax[abs(dy)]
        # row at y = v + dy, x-window [u - w, u + w] in padded coords
        row_p = p_x[pad + dy: pad + dy + h, :]
        row_q = q_x[pad + dy: pad + dy + h, :]
        s_p = row_p[:, 2 * pad + w + 1 - pad: 2 * pad + w + 1 - pad + w_img] \
            - row_p[:, pad - w: pad - w + w_img]
        s_q = row_q[:, 2 * pad + w + 1 - pad: 2 * pad + w + 1 - pad + w_img] \
            - row_q[:, pad - w: pad - w + w_img]
        m10 = m10 + (s_q - u0[None, :] * s_p)
    for dx in range(-pad, pad + 1):
        w = umax[abs(dx)]
        col_p = p_y[:, pad + dx: pad + dx + w_img]
        col_q = q_y[:, pad + dx: pad + dx + w_img]
        s_p = col_p[pad + w + 1: pad + w + 1 + h, :] - col_p[pad - w: pad - w + h, :]
        s_q = col_q[pad + w + 1: pad + w + 1 + h, :] - col_q[pad - w: pad - w + h, :]
        m01 = m01 + (s_q - v0[:, None] * s_p)
    return m10, m01


def compute_orientations(img: jnp.ndarray, xy: jnp.ndarray) -> jnp.ndarray:
    """Angles (radians) for keypoints xy [N, 2] (x, y) on level image."""
    m10, m01 = orientation_maps(img)
    xi = jnp.clip(jnp.round(xy[:, 0]).astype(jnp.int32), 0, img.shape[1] - 1)
    yi = jnp.clip(jnp.round(xy[:, 1]).astype(jnp.int32), 0, img.shape[0] - 1)
    return jnp.arctan2(m01[yi, xi], m10[yi, xi])


def _brief_pattern(seed: int = 12345) -> np.ndarray:
    """Deterministic Gaussian BRIEF pattern: [256, 4] int32 (x1,y1,x2,y2),
    points ~ N(0, (patch/5)^2) clipped to the patch (BRIEF paper G-II)."""
    rng = np.random.RandomState(seed)
    sigma = PATCH_SIZE / 5.0
    pts = rng.randn(N_BITS, 4) * sigma
    pts = np.clip(np.round(pts), -(HALF_PATCH - 2), HALF_PATCH - 2)
    # Avoid degenerate identical pairs.
    same = (pts[:, 0] == pts[:, 2]) & (pts[:, 1] == pts[:, 3])
    pts[same, 2] += 1
    return pts.astype(np.int32)


_PATTERN = None


def get_pattern() -> np.ndarray:
    global _PATTERN
    if _PATTERN is None:
        _PATTERN = _brief_pattern()  # numpy constant (jit-safe cache)
    return _PATTERN


def compute_descriptors(img_blur: jnp.ndarray, xy: jnp.ndarray,
                        angles: jnp.ndarray) -> jnp.ndarray:
    """Steered BRIEF-256 for N keypoints -> [N, 8] uint32.

    img_blur: the Gaussian-blurred level image; xy: [N,2] (x,y); angles: [N].
    Pattern points are rotated by the keypoint angle and rounded, exactly the
    GET_VALUE scheme in computeOrbDescriptor (ORBextractor.cc:99-156).
    """
    h, w = img_blur.shape
    pat = get_pattern().astype(jnp.float32)          # [256, 4]
    ca, sa = jnp.cos(angles), jnp.sin(angles)        # [N]

    p1 = pat[:, 0:2]   # [256, 2] (x, y)
    p2 = pat[:, 2:4]

    def rotate(p):  # [256,2] x [N] -> [N,256,2]
        rx = p[None, :, 0] * ca[:, None] - p[None, :, 1] * sa[:, None]
        ry = p[None, :, 0] * sa[:, None] + p[None, :, 1] * ca[:, None]
        return jnp.stack([rx, ry], axis=-1)

    r1 = rotate(p1) + xy[:, None, :]
    r2 = rotate(p2) + xy[:, None, :]

    def sample(pts):  # [N,256,2] -> [N,256] nearest-neighbour intensities
        xi = jnp.clip(jnp.round(pts[..., 0]).astype(jnp.int32), 0, w - 1)
        yi = jnp.clip(jnp.round(pts[..., 1]).astype(jnp.int32), 0, h - 1)
        return img_blur[yi, xi]

    bits = (sample(r1) < sample(r2)).astype(jnp.uint32)   # [N, 256]
    shifts = jnp.arange(32, dtype=jnp.uint32)
    words = bits.reshape(-1, 8, 32) << shifts[None, None, :]
    return jnp.sum(words, axis=-1).astype(jnp.uint32)      # [N, 8]


# ---------------------------------------------------------------------------
# Patch-based fused path (production): one 45x45 patch slice per keypoint,
# then orientation / blur / BRIEF as small batched matmuls. Bit-identical to
# the dense path above (same pattern, same 7x7 sigma=2 reflect blur, same
# nearest-neighbour rounding) but avoids the full-image moment passes, the
# full-pyramid blur and the 512 random gathers per keypoint that dominated
# the extract() device profile at 1000 features. The matmul-friendly trick
# is the separable one-hot sampling: a nearest-neighbour gather from a patch equals
# row-one-hot @ patch followed by a column-one-hot contraction — exact,
# because each one-hot row has a single unit entry (f32 throughout).
# ---------------------------------------------------------------------------

BLUR_K = 7            # ORBextractor GaussianBlur(image, 7x7, 2, 2) parity
BLUR_MARGIN = BLUR_K // 2
# max |rotated pattern offset| = 13*sqrt(2) ~ 18.39, +0.5 rounding -> 19;
# +3 blur margin -> raw patch half-width 22.
RAW_PATCH = 45
BLUR_PATCH = RAW_PATCH - 2 * BLUR_MARGIN   # 39


def extract_patches(img: jnp.ndarray, xy: jnp.ndarray,
                    patch: int = RAW_PATCH, margin: int = BLUR_MARGIN):
    """Slice one patch per keypoint from the reflect-padded level image.

    Returns (patches [N,patch,patch], fx [N], fy [N]) where (fx, fy) is the
    keypoint position in patch coordinates. Padding the image by `margin`
    (reflect, matching gaussian_blur's BORDER_REFLECT_101) before slicing
    makes the VALID-conv blur of a patch bit-equal to a window of the
    full-image blur, including at image borders."""
    from jax import lax
    h, w = img.shape
    imgp = jnp.pad(img, margin, mode="reflect")
    ix = jnp.round(xy[:, 0]).astype(jnp.int32) + margin
    iy = jnp.round(xy[:, 1]).astype(jnp.int32) + margin
    x0 = jnp.clip(ix - patch // 2, 0, w + 2 * margin - patch)
    y0 = jnp.clip(iy - patch // 2, 0, h + 2 * margin - patch)
    pat = jax.vmap(
        lambda y, x: lax.dynamic_slice(imgp, (y, x), (patch, patch)))(y0, x0)
    fx = xy[:, 0] + margin - x0.astype(xy.dtype)
    fy = xy[:, 1] + margin - y0.astype(xy.dtype)
    return pat, fx, fy


def orientation_from_patches(patches: jnp.ndarray, fx, fy) -> jnp.ndarray:
    """Intensity-centroid angles from raw patches: a 31x31 disc slice per
    keypoint + two mask contractions (same circular masks as the dense
    path; keypoints sit >= border(16) from the level edge so the disc never
    reads padded pixels)."""
    from jax import lax
    mx, my = _get_masks()
    mxj = jnp.asarray(mx)
    myj = jnp.asarray(my)
    d = 2 * HALF_PATCH + 1
    cx = jnp.round(fx).astype(jnp.int32) - HALF_PATCH
    cy = jnp.round(fy).astype(jnp.int32) - HALF_PATCH
    # patches carry a blur margin; the disc slice start is >= 0 in-range
    disc = jax.vmap(
        lambda p, y, x: lax.dynamic_slice(p, (y, x), (d, d)))(patches, cy, cx)
    m10 = jnp.einsum("nrc,rc->n", disc, mxj)
    m01 = jnp.einsum("nrc,rc->n", disc, myj)
    return jnp.arctan2(m01, m10)


def blur_patches(patches: jnp.ndarray, ksize: int = BLUR_K,
                 sigma: float = 2.0) -> jnp.ndarray:
    """Batched separable 7x7 Gaussian (VALID) on raw patches: equals the
    corresponding window of gaussian_blur(img) because the patches were cut
    from the reflect-padded image."""
    from geoflowslam.ops.pyramid import _gaussian_kernel1d
    k = _gaussian_kernel1d(ksize, sigma)
    n, p, _ = patches.shape
    out = None
    for i in range(ksize):
        term = patches[:, i:i + p - 2 * (ksize // 2), :] * float(k[i])
        out = term if out is None else out + term
    x = out
    out = None
    for i in range(ksize):
        term = x[:, :, i:i + p - 2 * (ksize // 2)] * float(k[i])
        out = term if out is None else out + term
    return out


def descriptors_from_patches(blurred: jnp.ndarray, fx, fy,
                             angles: jnp.ndarray) -> jnp.ndarray:
    """Steered BRIEF-256 from blurred patches [N,39,39] -> [N,8] uint32.

    Sample index = round(R(angle) @ pattern + in-patch position) - margin,
    clipped to the blurred patch — identical values to compute_descriptors'
    full-image gather (see extract_patches for the border argument). The
    gather is realised as separable one-hot matmuls."""
    bp = BLUR_PATCH
    pat = get_pattern().astype(jnp.float32)          # [256, 4]
    ca, sa = jnp.cos(angles), jnp.sin(angles)
    pp = jnp.concatenate([pat[:, 0:2], pat[:, 2:4]], axis=0)   # [512, 2]
    rx = pp[None, :, 0] * ca[:, None] - pp[None, :, 1] * sa[:, None]
    ry = pp[None, :, 0] * sa[:, None] + pp[None, :, 1] * ca[:, None]
    xi = jnp.clip(jnp.round(rx + fx[:, None]).astype(jnp.int32) - BLUR_MARGIN,
                  0, bp - 1)                          # [N, 512]
    yi = jnp.clip(jnp.round(ry + fy[:, None]).astype(jnp.int32) - BLUR_MARGIN,
                  0, bp - 1)
    iota = jnp.arange(bp)
    row_oh = (yi[:, :, None] == iota[None, None, :]).astype(jnp.float32)
    col_oh = (xi[:, :, None] == iota[None, None, :]).astype(jnp.float32)
    tmp = jnp.einsum("nkr,nrc->nkc", row_oh, blurred,
                     preferred_element_type=jnp.float32)
    s = jnp.sum(tmp * col_oh, axis=-1)                # [N, 512] exact samples
    bits = (s[:, :256] < s[:, 256:]).astype(jnp.uint32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    words = bits.reshape(-1, 8, 32) << shifts[None, None, :]
    return jnp.sum(words, axis=-1).astype(jnp.uint32)


def orient_and_describe(img: jnp.ndarray, xy: jnp.ndarray):
    """Fused production path for one level: patches -> (angles, descriptors).

    Replaces compute_orientations + gaussian_blur + compute_descriptors with
    identical outputs (see the patch-path header comment)."""
    patches, fx, fy = extract_patches(img, xy)
    ang = orientation_from_patches(patches, fx, fy)
    blurred = blur_patches(patches)
    desc = descriptors_from_patches(blurred, fx, fy, ang)
    return ang, desc


def unpack_bits_pm1(desc: jnp.ndarray, dtype=jnp.bfloat16) -> jnp.ndarray:
    """[N, 8] uint32 -> [N, 256] in {-1, +1} for Hamming matmuls."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (desc[:, :, None] >> shifts[None, None, :]) & jnp.uint32(1)
    bits = bits.reshape(desc.shape[0], 256)
    return (bits.astype(jnp.float32) * 2.0 - 1.0).astype(dtype)
