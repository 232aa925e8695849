"""Pyramidal LK unit tests (ops/klt.py, the dual-stream OF workhorse —
cv::calcOpticalFlowPyrLK role, /root/reference/src/ORBmatcher.cc:2303).

The patch-based formulation (contiguous block extraction + shifted-view
bilinear) must recover known sub-pixel shifts; these tests pin both the
numerics and the forward-backward gate.
"""
import numpy as np
import jax
import jax.numpy as jnp

from geoflowslam.ops import klt as K


def _textured(h=120, w=160, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, (h // 4, w // 4)).astype(np.float32)
    img = jnp.asarray(np.kron(base, np.ones((4, 4), np.float32)))
    from geoflowslam.ops.pyramid import gaussian_blur
    return gaussian_blur(img, 5, 1.2)


def _shift(img, dx, dy):
    """Translate by (dx, dy) with bilinear resampling (scipy-free)."""
    h, w = img.shape
    ys, xs = jnp.meshgrid(jnp.arange(h, dtype=jnp.float32),
                          jnp.arange(w, dtype=jnp.float32), indexing="ij")
    x = jnp.clip(xs - dx, 0.0, w - 1.001)
    y = jnp.clip(ys - dy, 0.0, h - 1.001)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    fx, fy = x - x0, y - y0
    g = img
    return (g[y0, x0] * (1 - fx) * (1 - fy) + g[y0, x0 + 1] * fx * (1 - fy)
            + g[y0 + 1, x0] * (1 - fx) * fy + g[y0 + 1, x0 + 1] * fx * fy)


def test_klt_recovers_subpixel_shift():
    img = _textured()
    dx, dy = 3.4, -2.6
    img2 = _shift(img, dx, dy)
    pyr1 = K.build_lk_pyramid(img, 3)
    pyr2 = K.build_lk_pyramid(img2, 3)
    pts = jnp.asarray(np.array(
        [[40.0, 40.0], [80.0, 60.0], [120.0, 30.0], [60.0, 90.0]],
        np.float32))
    res = K.klt_track(pyr1, pyr2, pts, win=21, iters=10)
    assert bool(res.status.all()), np.asarray(res.status)
    err = np.asarray(res.pts) - (np.asarray(pts) + np.array([dx, dy]))
    assert np.abs(err).max() < 0.25, err


def test_fb_gate_rejects_occluded():
    img = _textured()
    img2 = _shift(img, 2.0, 1.0)
    # blank out a region in the target: tracks landing there lose texture
    img2 = img2.at[30:70, 90:130].set(100.0)
    pyr1 = K.build_lk_pyramid(img, 3)
    pyr2 = K.build_lk_pyramid(img2, 3)
    pts = jnp.asarray(np.array(
        [[40.0, 40.0],            # clean -> survives
         [108.0, 48.0]],          # lands in the blanked region -> gated
        np.float32))
    res = K.fb_klt_track(pyr1, pyr2, pts, fb_thresh=0.5, win=21, iters=10)
    st = np.asarray(res.status)
    assert st[0], st
    err0 = np.asarray(res.pts)[0] - (np.asarray(pts)[0] + np.array([2.0, 1.0]))
    assert np.abs(err0).max() < 0.25


def test_klt_prior_guess_converges_fast_motion():
    """A 15 px motion exceeds the 21x21 window's pull-in range at fine
    levels; the projected-guess entry (3D-prior stream) must converge."""
    img = _textured()
    dx, dy = 15.0, -11.0
    img2 = _shift(img, dx, dy)
    pyr1 = K.build_lk_pyramid(img, 3)
    pyr2 = K.build_lk_pyramid(img2, 3)
    pts = jnp.asarray(np.array([[60.0, 60.0], [90.0, 40.0]], np.float32))
    guess = pts + jnp.asarray(np.array([dx - 1.5, dy + 1.5], np.float32))
    res = K.klt_track(pyr1, pyr2, pts, init_guess=guess, win=21, iters=10)
    assert bool(res.status.all())
    err = np.asarray(res.pts) - (np.asarray(pts) + np.array([dx, dy]))
    assert np.abs(err).max() < 0.3, err
