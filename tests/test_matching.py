import jax
import jax.numpy as jnp
import numpy as np

from geoflowslam.ops import matching, gms, ransac
from geoflowslam.math import lie


def random_desc(key, n):
    return jax.random.randint(key, (n, 8), 0, 2**31 - 1, dtype=jnp.int32).astype(jnp.uint32)


def flip_bits(key, desc, n_bits):
    """Flip n_bits random bits in each descriptor."""
    n = desc.shape[0]
    out = np.asarray(desc).copy()
    rng = np.random.RandomState(int(jax.random.randint(key, (), 0, 1 << 30)))
    for i in range(n):
        for b in rng.choice(256, n_bits, replace=False):
            out[i, b // 32] ^= np.uint32(1 << (b % 32))
    return jnp.asarray(out)


def np_hamming(a, b):
    x = np.bitwise_xor(np.asarray(a)[:, None, :], np.asarray(b)[None, :, :])
    x = np.ascontiguousarray(x)
    return np.unpackbits(x.view(np.uint8), axis=-1).sum(axis=-1)


class TestHamming:
    def test_matrix_matches_numpy(self):
        ka, kb = jax.random.split(jax.random.PRNGKey(0))
        da, db = random_desc(ka, 37), random_desc(kb, 53)
        d = matching.hamming_matrix(da, db)
        np.testing.assert_array_equal(np.asarray(d), np_hamming(da, db))

    def test_match_with_noise(self):
        key = jax.random.PRNGKey(1)
        da = random_desc(key, 64)
        db = flip_bits(jax.random.PRNGKey(2), da, 10)  # 10-bit noise
        valid = jnp.ones(64, bool)
        idx, dist = matching.match_descriptors(da, valid, db, valid, max_dist=50)
        matched = np.asarray(idx)
        assert (matched == np.arange(64)).mean() > 0.95

    def test_invalid_masked_out(self):
        key = jax.random.PRNGKey(3)
        da = random_desc(key, 16)
        valid_a = jnp.ones(16, bool).at[5].set(False)
        idx, _ = matching.match_descriptors(da, valid_a, da, jnp.ones(16, bool))
        assert int(idx[5]) == -1

    def test_rotation_consistency(self):
        n = 60
        ang_a = jnp.zeros(n)
        # 50 matches rotated by 0.5 rad, 10 outliers at random angles
        ang_b = jnp.concatenate([jnp.full((50,), -0.5),
                                 jnp.linspace(1.0, 3.0, 10)])
        match_idx = jnp.arange(n)
        kept = matching.rotation_consistency(ang_a, ang_b, match_idx, n_keep=1)
        kept = np.asarray(kept)
        assert (kept[:50] >= 0).all()
        assert (kept[50:] == -1).sum() >= 8


class TestGMS:
    def test_coherent_motion_kept_outliers_rejected(self):
        # GMS statistics need realistic density (the reference runs it with
        # 1000+ ORB matches, gms_matcher.h assumes ~10k features).
        key = jax.random.PRNGKey(4)
        n, n_in = 2000, 1700
        uv_a = jax.random.uniform(key, (n, 2)) * jnp.array([600.0, 440.0]) + 20.0
        shift = jnp.array([15.0, -8.0])
        uv_b = uv_a + shift
        k2 = jax.random.PRNGKey(5)
        uv_b = uv_b.at[n_in:].set(
            jax.random.uniform(k2, (n - n_in, 2)) * jnp.array([600.0, 440.0]) + 20.0)
        match_idx = jnp.arange(n)
        kept = gms.gms_filter(uv_a, uv_b, match_idx, (640, 480), (640, 480))
        kept = np.asarray(kept)
        assert (kept[:n_in] >= 0).mean() > 0.8
        assert (kept[n_in:] == -1).mean() > 0.8


class TestRansacF:
    def make_two_view(self, key, n=200, n_out=40):
        k1, k2, k3 = jax.random.split(key, 3)
        pts = jax.random.uniform(k1, (n, 3), minval=jnp.array([-2, -2, 3.0]),
                                 maxval=jnp.array([2, 2, 8.0]))
        rot = lie.so3_exp(jnp.array([0.03, -0.12, 0.02]))
        t = jnp.array([0.6, 0.05, 0.03])
        fx, cx, cy = 400.0, 320.0, 240.0
        uv1 = pts[:, :2] / pts[:, 2:3] * fx + jnp.array([cx, cy])
        pc2 = pts @ rot.T + t
        uv2 = pc2[:, :2] / pc2[:, 2:3] * fx + jnp.array([cx, cy])
        # outliers
        uv2 = uv2.at[:n_out].add(jax.random.uniform(k2, (n_out, 2), minval=30, maxval=120))
        # small noise on the rest
        uv2 = uv2.at[n_out:].add(jax.random.normal(k3, (n - n_out, 2)) * 0.3)
        return uv1, uv2, pts, rot, t, fx

    def test_fundamental_finds_inliers(self):
        uv1, uv2, *_ = self.make_two_view(jax.random.PRNGKey(6))
        valid = jnp.ones(200, bool)
        res = ransac.ransac_fundamental(jax.random.PRNGKey(7), uv1, uv2, valid)
        inl = np.asarray(res.inliers)
        assert inl[40:].mean() > 0.9    # true inliers kept
        assert inl[:40].mean() < 0.2    # outliers rejected

    def test_pnp(self):
        uv1, uv2, pts, rot, t, fx = self.make_two_view(jax.random.PRNGKey(8))
        # normalized coords of view 2
        uvn = (uv2 - jnp.array([320.0, 240.0])) / fx
        valid = jnp.ones(200, bool)
        res = ransac.ransac_pnp(jax.random.PRNGKey(9), pts, uvn, valid,
                                threshold_px=4.0, focal=fx)
        model = np.asarray(res.model)
        # minimal-solver accuracy only; the pipeline refines with GN after
        np.testing.assert_allclose(model[:, :3], np.asarray(rot), atol=2e-2)
        np.testing.assert_allclose(model[:, 3], np.asarray(t), atol=5e-2)
        assert int(res.n_inliers) > 140

    def test_homography_on_plane(self):
        key = jax.random.PRNGKey(10)
        # planar scene: z = 5 plane
        k1, k2 = jax.random.split(key)
        pts = jax.random.uniform(k1, (120, 3), minval=jnp.array([-2, -2, 0.0]),
                                 maxval=jnp.array([2, 2, 0.0])) + jnp.array([0, 0, 5.0])
        rot = lie.so3_exp(jnp.array([0.05, -0.02, 0.04]))
        t = jnp.array([0.3, -0.1, 0.1])
        fx, c = 400.0, jnp.array([320.0, 240.0])
        uv1 = pts[:, :2] / pts[:, 2:3] * fx + c
        pc2 = pts @ rot.T + t
        uv2 = pc2[:, :2] / pc2[:, 2:3] * fx + c
        uv2 = uv2.at[:20].add(50.0)
        res = ransac.ransac_homography(jax.random.PRNGKey(11), uv1, uv2, jnp.ones(120, bool))
        inl = np.asarray(res.inliers)
        assert inl[20:].mean() > 0.9
        assert inl[:20].mean() < 0.2


class TestSim3:
    def test_horn_exact(self):
        key = jax.random.PRNGKey(12)
        pts1 = jax.random.normal(key, (50, 3))
        s, rot, t = 1.7, lie.so3_exp(jnp.array([0.2, -0.3, 0.5])), jnp.array([1.0, -2.0, 0.5])
        pts2 = s * pts1 @ rot.T + t
        se, re, te = ransac.solve_sim3_horn(pts1, pts2)
        np.testing.assert_allclose(float(se), s, rtol=1e-4)
        np.testing.assert_allclose(np.asarray(re), np.asarray(rot), atol=1e-4)
        np.testing.assert_allclose(np.asarray(te), np.asarray(t), atol=1e-4)

    def test_ransac_sim3_with_outliers(self):
        key = jax.random.PRNGKey(13)
        pts1 = jax.random.normal(key, (80, 3)) + jnp.array([0, 0, 4.0])
        s, rot, t = 0.8, lie.so3_exp(jnp.array([0.1, 0.2, -0.1])), jnp.array([0.5, 0.2, -0.3])
        pts2 = s * pts1 @ rot.T + t
        pts2 = pts2.at[:15].add(jax.random.normal(jax.random.PRNGKey(14), (15, 3)) * 2.0)
        res = ransac.ransac_sim3(jax.random.PRNGKey(15), pts1, pts2, jnp.ones(80, bool))
        inl = np.asarray(res.inliers)
        assert inl[15:].mean() > 0.9
        s_est = float(res.model[0])
        np.testing.assert_allclose(s_est, s, rtol=0.05)
