import jax
import jax.numpy as jnp
import numpy as np
import pytest

from geoflowslam.math import lie


def rand_rotvecs(key, n, scale=2.5):
    return scale * jax.random.normal(key, (n, 3))


class TestSO3:
    def test_exp_log_roundtrip(self):
        phi = rand_rotvecs(jax.random.PRNGKey(0), 64)
        # keep |phi| < pi for log uniqueness
        norm = jnp.linalg.norm(phi, axis=-1, keepdims=True)
        phi = phi / jnp.maximum(norm, 1.0) * jnp.minimum(norm, 3.0)
        rot = lie.so3_exp(phi)
        phi2 = lie.so3_log(rot)
        np.testing.assert_allclose(np.asarray(phi2), np.asarray(phi), atol=2e-5)

    def test_exp_is_rotation(self):
        phi = rand_rotvecs(jax.random.PRNGKey(1), 32)
        rot = lie.so3_exp(phi)
        eye = jnp.eye(3)[None].repeat(32, 0)
        np.testing.assert_allclose(np.asarray(rot @ jnp.swapaxes(rot, -1, -2)), np.asarray(eye), atol=1e-5)
        np.testing.assert_allclose(np.asarray(jnp.linalg.det(rot)), 1.0, atol=1e-5)

    def test_small_angle(self):
        phi = jnp.array([[1e-9, -1e-9, 1e-10], [0.0, 0.0, 0.0]])
        rot = lie.so3_exp(phi)
        assert np.all(np.isfinite(np.asarray(rot)))
        phi2 = lie.so3_log(rot)
        assert np.all(np.isfinite(np.asarray(phi2)))

    def test_right_jacobian_fd(self):
        # Jr: exp(phi + d) ~ exp(phi) exp(Jr d)
        phi = jnp.array([0.3, -0.7, 0.5])
        jr = lie.so3_right_jacobian(phi)
        eps = 1e-4
        for i in range(3):
            d = jnp.zeros(3).at[i].set(eps)
            lhs = lie.so3_exp(phi + d)
            rhs = lie.so3_exp(phi) @ lie.so3_exp(jr @ d)
            np.testing.assert_allclose(np.asarray(lhs), np.asarray(rhs), atol=1e-6)

    def test_right_jacobian_inv(self):
        phi = jnp.array([[0.3, -0.7, 0.5], [1e-9, 0, 0]])
        jr = lie.so3_right_jacobian(phi)
        jri = lie.so3_right_jacobian_inv(phi)
        eye = jnp.eye(3)[None].repeat(2, 0)
        np.testing.assert_allclose(np.asarray(jr @ jri), np.asarray(eye), atol=1e-5)

    def test_quat_roundtrip_near_pi(self):
        # rotations near pi exercise the non-trace quaternion branches
        axis = jnp.array([[1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0], [0.577, 0.577, 0.577]])
        phi = axis * 3.10
        rot = lie.so3_exp(phi)
        rot2 = lie.mat_from_quat(lie.quat_from_mat(rot))
        np.testing.assert_allclose(np.asarray(rot2), np.asarray(rot), atol=1e-5)


class TestSE3:
    def test_exp_log_roundtrip(self):
        key = jax.random.PRNGKey(2)
        xi = jax.random.normal(key, (64, 6))
        xi = xi.at[:, 3:].multiply(0.8)
        rot, t = lie.se3_exp(xi)
        xi2 = lie.se3_log(rot, t)
        np.testing.assert_allclose(np.asarray(xi2), np.asarray(xi), atol=3e-5)

    def test_compose_inverse(self):
        key = jax.random.PRNGKey(3)
        xi = jax.random.normal(key, (8, 6))
        rot, t = lie.se3_exp(xi)
        ri, ti = lie.se3_inverse(rot, t)
        rc, tc = lie.se3_compose(rot, t, ri, ti)
        np.testing.assert_allclose(np.asarray(rc), np.asarray(jnp.eye(3)[None].repeat(8, 0)), atol=1e-5)
        np.testing.assert_allclose(np.asarray(tc), 0.0, atol=1e-5)

    def test_apply_matches_matrix(self):
        xi = jnp.array([0.1, -0.2, 0.3, 0.4, -0.5, 0.6])
        rot, t = lie.se3_exp(xi)
        pts = jax.random.normal(jax.random.PRNGKey(4), (10, 3))
        out = lie.se3_apply(rot, t, pts)
        ref = pts @ np.asarray(rot).T + np.asarray(t)
        np.testing.assert_allclose(np.asarray(out), ref, atol=1e-5)

    def test_exp_matches_expm(self):
        from jax.scipy.linalg import expm
        xi = jnp.array([0.2, -0.1, 0.4, 0.3, 0.2, -0.6])
        rot, t = lie.se3_exp(xi)
        gen = jnp.zeros((4, 4)).at[:3, :3].set(lie.hat(xi[3:])).at[:3, 3].set(xi[:3])
        m = expm(gen)
        np.testing.assert_allclose(np.asarray(rot), np.asarray(m[:3, :3]), atol=1e-5)
        np.testing.assert_allclose(np.asarray(t), np.asarray(m[:3, 3]), atol=1e-5)


class TestSim3:
    def test_exp_matches_expm(self):
        from jax.scipy.linalg import expm
        for xi_np in [
            [0.2, -0.1, 0.4, 0.3, 0.2, -0.6, 0.3],
            [0.2, -0.1, 0.4, 0.3, 0.2, -0.6, 0.0],
            [0.2, -0.1, 0.4, 1e-9, 0, 0, 0.25],
            [0.2, -0.1, 0.4, 1e-9, 0, 0, 1e-9],
        ]:
            xi = jnp.array(xi_np)
            s, rot, t = lie.sim3_exp(xi)
            gen = (
                jnp.zeros((4, 4))
                .at[:3, :3].set(lie.hat(xi[3:6]) + xi[6] * jnp.eye(3))
                .at[:3, 3].set(xi[:3])
            )
            m = expm(gen)
            np.testing.assert_allclose(np.asarray(s[None] * rot), np.asarray(m[:3, :3]), atol=1e-5, err_msg=str(xi_np))
            np.testing.assert_allclose(np.asarray(t), np.asarray(m[:3, 3]), atol=1e-5, err_msg=str(xi_np))

    def test_compose_inverse(self):
        s1, r1, t1 = lie.sim3_exp(jnp.array([0.1, 0.2, -0.3, 0.2, -0.1, 0.3, 0.4]))
        si, ri, ti = lie.sim3_inverse(s1, r1, t1)
        sc, rc, tc = lie.sim3_compose(s1, r1, t1, si, ri, ti)
        np.testing.assert_allclose(float(sc), 1.0, atol=1e-5)
        np.testing.assert_allclose(np.asarray(rc), np.eye(3), atol=1e-5)
        np.testing.assert_allclose(np.asarray(tc), 0.0, atol=1e-5)

    def test_apply(self):
        s, r, t = lie.sim3_exp(jnp.array([0.1, 0.2, -0.3, 0.2, -0.1, 0.3, 0.4]))
        pts = jax.random.normal(jax.random.PRNGKey(5), (7, 3))
        out = lie.sim3_apply(s, r, t, pts)
        ref = float(s) * pts @ np.asarray(r).T + np.asarray(t)
        np.testing.assert_allclose(np.asarray(out), ref, atol=1e-5)
