import jax
import jax.numpy as jnp
import numpy as np

from geoflowslam.ops import fast as fast_ops
from geoflowslam.ops import orb as orb_ops
from geoflowslam.ops import pyramid as pyr_ops
from geoflowslam.ops.extractor import OrbConfig, extract


def checker_image(h=96, w=128, sq=16, lo=40.0, hi=220.0):
    ys, xs = np.mgrid[0:h, 0:w]
    img = np.where(((ys // sq) + (xs // sq)) % 2 == 0, lo, hi)
    return jnp.asarray(img, jnp.float32)


def squares_image(h=96, w=128, lo=50.0, hi=220.0, size=10, step=24):
    """Isolated bright squares on dark background; L-corners are true FAST-9
    corners (unlike checkerboard X-junctions, which have exactly 8/8 ring
    splits and are rejected by the contiguous-arc test — as in OpenCV)."""
    img = np.full((h, w), lo, np.float32)
    truth = []
    for cy in range(24, h - size - 3, step):
        for cx in range(24, w - size - 3, step):
            img[cy:cy + size, cx:cx + size] = hi
            truth += [(cx, cy), (cx + size - 1, cy), (cx, cy + size - 1),
                      (cx + size - 1, cy + size - 1)]
    return jnp.asarray(img), np.array(truth, np.float32)


def textured_image(key, h=96, w=128):
    base = jax.random.uniform(key, (h, w), minval=0.0, maxval=255.0)
    return pyr_ops.gaussian_blur(base, 5, 1.0)


class TestFast:
    def test_detects_square_corners(self):
        img, truth = squares_image()
        kp = fast_ops.detect_level(img, 64, 20.0, 7.0)
        n_valid = int(jnp.sum(kp.valid))
        assert n_valid >= 10
        xy = np.asarray(kp.xy)[np.asarray(kp.valid)]
        d = np.linalg.norm(xy[:, None, :] - truth[None, :, :], axis=-1).min(axis=1)
        assert d.max() <= 1.5

    def test_flat_image_no_corners(self):
        img = jnp.full((96, 128), 100.0)
        kp = fast_ops.detect_level(img, 64, 20.0, 7.0)
        assert int(jnp.sum(kp.valid)) == 0

    def test_threshold_fallback(self):
        # weak corners only: high threshold finds nothing, fallback does
        img, _ = squares_image(lo=100.0, hi=112.0)
        kp_strict = fast_ops.detect_level(img, 64, 20.0, 20.0)
        assert int(jnp.sum(kp_strict.valid)) == 0
        kp = fast_ops.detect_level(img, 64, 20.0, 7.0)
        assert int(jnp.sum(kp.valid)) > 0

    def test_border_respected(self):
        img = textured_image(jax.random.PRNGKey(0))
        kp = fast_ops.detect_level(img, 128, 10.0, 5.0, border=16)
        xy = np.asarray(kp.xy)[np.asarray(kp.valid)]
        if len(xy):
            assert xy[:, 0].min() >= 16 and xy[:, 0].max() < 128 - 16
            assert xy[:, 1].min() >= 16 and xy[:, 1].max() < 96 - 16


class TestOrientation:
    def test_gradient_direction(self):
        # intensity increasing along +x -> centroid along +x -> angle ~ 0
        img = jnp.tile(jnp.arange(128, dtype=jnp.float32)[None, :], (96, 1))
        ang = orb_ops.compute_orientations(img, jnp.array([[64.0, 48.0]]))
        assert abs(float(ang[0])) < 0.05
        # increasing along +y -> angle ~ pi/2
        img2 = jnp.tile(jnp.arange(96, dtype=jnp.float32)[:, None], (1, 128))
        ang2 = orb_ops.compute_orientations(img2, jnp.array([[64.0, 48.0]]))
        assert abs(float(ang2[0]) - np.pi / 2) < 0.05


def hamming(d1, d2):
    x = np.bitwise_xor(np.asarray(d1), np.asarray(d2))
    return np.unpackbits(x.view(np.uint8), axis=-1).sum(axis=-1)


class TestDescriptors:
    def test_rotation_invariance(self):
        key = jax.random.PRNGKey(1)
        img = textured_image(key, 128, 128)
        img_rot = jnp.rot90(img, k=1)  # 90 deg CCW
        blur = pyr_ops.gaussian_blur(img)
        blur_rot = pyr_ops.gaussian_blur(img_rot)

        # Pick interior points; (x, y) -> rot90 maps to (y, W-1-x)
        xy = jnp.array([[60.0, 50.0], [40.0, 70.0], [80.0, 64.0]])
        xy_rot = jnp.stack([xy[:, 1], 128 - 1 - xy[:, 0]], axis=-1)

        a1 = orb_ops.compute_orientations(img, xy)
        a2 = orb_ops.compute_orientations(img_rot, xy_rot)
        d1 = orb_ops.compute_descriptors(blur, xy, a1)
        d2 = orb_ops.compute_descriptors(blur_rot, xy_rot, a2)
        dist_match = hamming(d1, d2)
        assert dist_match.max() < 60, dist_match

        # Cross distances between different keypoints should be much larger.
        dist_cross = hamming(d1[0:1], d2[1:2])
        assert dist_cross.min() > 80

    def test_unpack_pm1(self):
        desc = jnp.array([[0xFFFFFFFF] + [0] * 7], jnp.uint32)
        pm = orb_ops.unpack_bits_pm1(desc, jnp.float32)
        assert float(pm[0, :32].sum()) == 32.0
        assert float(pm[0, 32:].sum()) == -224.0


class TestExtractor:
    def test_end_to_end(self):
        cfg = OrbConfig(n_features=200, n_levels=4, height=96, width=128)
        img = textured_image(jax.random.PRNGKey(2))
        fs = extract(img, cfg)
        assert fs.uv.shape == (200, 2)
        assert fs.desc.shape == (200, 8)
        n_valid = int(jnp.sum(fs.valid))
        assert n_valid > 50
        # level-0 coords are within image bounds for valid kps
        xy = np.asarray(fs.uv)[np.asarray(fs.valid)]
        assert xy[:, 0].max() < 128 and xy[:, 1].max() < 96

    def test_jit_stability(self):
        cfg = OrbConfig(n_features=100, n_levels=3, height=96, width=128)
        f = jax.jit(lambda im: extract(im, cfg))
        img = textured_image(jax.random.PRNGKey(3))
        fs1 = f(img)
        fs2 = f(img + 0.0)
        np.testing.assert_array_equal(np.asarray(fs1.uv), np.asarray(fs2.uv))


class TestClahe:
    def test_improves_contrast(self):
        key = jax.random.PRNGKey(4)
        img = jax.random.uniform(key, (96, 128), minval=100.0, maxval=140.0)
        out = pyr_ops.clahe(img, grid=8)
        assert float(jnp.std(out)) > float(jnp.std(img))
        assert 0 <= float(out.min()) and float(out.max()) <= 255

    def test_identity_range(self):
        img = checker_image()
        out = pyr_ops.clahe(img)
        assert out.shape == img.shape
