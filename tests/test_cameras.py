import jax
import jax.numpy as jnp
import numpy as np

from geoflowslam.math import cameras


PINHOLE_PARAMS = jnp.array([458.654, 457.296, 367.215, 248.375, 0, 0, 0, 0], jnp.float32)
KB8_PARAMS = jnp.array(
    [190.978, 190.973, 254.931, 256.897, 0.00348, 0.000715, -0.0020532, 0.000202], jnp.float32
)


def rand_points(key, n):
    pts = jax.random.normal(key, (n, 3))
    return pts.at[:, 2].set(jnp.abs(pts[:, 2]) + 0.5)


class TestPinhole:
    def test_project_unproject(self):
        pts = rand_points(jax.random.PRNGKey(0), 100)
        uv = cameras.pinhole_project(PINHOLE_PARAMS, pts)
        rays = cameras.pinhole_unproject(PINHOLE_PARAMS, uv)
        # rays * z should reproduce pts
        rec = rays * pts[:, 2:3]
        np.testing.assert_allclose(np.asarray(rec), np.asarray(pts), rtol=1e-4, atol=1e-4)

    def test_jacobian_matches_autodiff(self):
        pts = rand_points(jax.random.PRNGKey(1), 10)
        jac = cameras.pinhole_project_jac(PINHOLE_PARAMS, pts)
        jac_ad = jax.vmap(jax.jacfwd(lambda p: cameras.pinhole_project(PINHOLE_PARAMS, p)))(pts)
        np.testing.assert_allclose(np.asarray(jac), np.asarray(jac_ad), rtol=1e-3, atol=1e-3)

    def test_radtan_roundtrip(self):
        dist = jnp.array([-0.28, 0.07, 2e-4, 1.8e-5, 0.0], jnp.float32)
        xy = jax.random.uniform(jax.random.PRNGKey(2), (50, 2), minval=-0.5, maxval=0.5)
        xyd = cameras.radtan_distort(dist, xy)
        xyu = cameras.radtan_undistort(dist, xyd)
        np.testing.assert_allclose(np.asarray(xyu), np.asarray(xy), atol=1e-5)


class TestKB8:
    def test_project_unproject(self):
        pts = rand_points(jax.random.PRNGKey(3), 100)
        uv = cameras.kb8_project(KB8_PARAMS, pts)
        rays = cameras.kb8_unproject(KB8_PARAMS, uv)
        # rays at z=1; compare directions
        d1 = rays / jnp.linalg.norm(rays, axis=-1, keepdims=True)
        d2 = pts / jnp.linalg.norm(pts, axis=-1, keepdims=True)
        np.testing.assert_allclose(np.asarray(d1), np.asarray(d2), atol=1e-4)

    def test_jacobian_finite(self):
        pts = rand_points(jax.random.PRNGKey(4), 10)
        jac = cameras.kb8_project_jac(KB8_PARAMS, pts)
        assert np.all(np.isfinite(np.asarray(jac)))


def test_triangulation():
    from geoflowslam.math import triangulate, lie

    key = jax.random.PRNGKey(5)
    pts_w = rand_points(key, 64) * jnp.array([2.0, 2.0, 4.0]) + jnp.array([0, 0, 2.0])
    # cam1 at origin; cam2 translated + slightly rotated
    rot21 = lie.so3_exp(jnp.array([0.02, -0.1, 0.03]))
    t21 = jnp.array([-0.4, 0.05, 0.02])
    rays1 = pts_w / pts_w[:, 2:3]
    pts_c2 = pts_w @ rot21.T + t21
    rays2 = pts_c2 / pts_c2[:, 2:3]
    rec, valid = triangulate.triangulate_points(rays1, rays2, rot21, t21)
    assert bool(jnp.all(valid))
    np.testing.assert_allclose(np.asarray(rec), np.asarray(pts_w), rtol=2e-3, atol=2e-3)
