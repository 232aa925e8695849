import jax
import jax.numpy as jnp
import numpy as np

from geoflowslam.imu import preintegration as pre
from geoflowslam.math import lie


def make_calib():
    return pre.ImuCalib.create(
        t_bc_mat=np.eye(4, dtype=np.float32),
        noise_gyro=1.7e-4, noise_acc=2e-3, walk_gyro=1.9e-5, walk_acc=3e-3,
        freq=200.0,
    )


def synth_trajectory(n, dt):
    """Analytic trajectory: sinusoidal translation + slow rotation.

    Returns per-sample body-frame gyro/acc (noise-free) plus ground-truth
    world pose/velocity at each sample time.
    """
    ts = np.arange(n + 1) * dt
    w = np.array([0.3, -0.2, 0.5])        # constant body angular velocity
    g = np.array([0.0, 0.0, -9.81])

    def rot(t):
        return np.asarray(lie.so3_exp(jnp.asarray(w * t, jnp.float32)))

    def pos(t):
        return np.array([np.sin(t), 0.5 * np.cos(2 * t), 0.2 * t])

    def vel(t):
        return np.array([np.cos(t), -np.sin(2 * t), 0.2])

    def acc_w(t):
        return np.array([-np.sin(t), -2 * np.cos(2 * t), 0.0])

    gyro = np.tile(w, (n, 1)).astype(np.float32)
    accs = np.zeros((n, 3), np.float32)
    for i in range(n):
        tm = ts[i] + 0.5 * dt  # midpoint sample
        accs[i] = rot(tm).T @ (acc_w(tm) - g)
    return (
        jnp.asarray(accs), jnp.asarray(gyro),
        jnp.full((n,), dt, jnp.float32),
        rot(ts[0]), pos(ts[0]), vel(ts[0]),
        rot(ts[-1]), pos(ts[-1]), vel(ts[-1]),
    )


class TestPreintegration:
    def test_noise_free_prediction(self):
        n, dt = 100, 1.0 / 200.0
        acc, gyro, dts, r0, p0, v0, r1, p1, v1 = synth_trajectory(n, dt)
        calib = make_calib()
        p = pre.preintegrate(acc, gyro, dts, jnp.zeros(6), calib)
        r_pred, t_pred, v_pred = pre.predict_state(
            jnp.asarray(r0, jnp.float32), jnp.asarray(p0, jnp.float32),
            jnp.asarray(v0, jnp.float32), p, jnp.zeros(6))
        np.testing.assert_allclose(np.asarray(r_pred), r1, atol=2e-3)
        np.testing.assert_allclose(np.asarray(t_pred), p1, atol=2e-3)
        np.testing.assert_allclose(np.asarray(v_pred), v1, atol=5e-3)

    def test_padding_invariance(self):
        n, dt = 50, 1.0 / 200.0
        acc, gyro, dts, *_ = synth_trajectory(n, dt)
        calib = make_calib()
        p1 = pre.preintegrate(acc, gyro, dts, jnp.zeros(6), calib)
        # pad with 30 zero-dt rows
        pad = 30
        acc_p = jnp.concatenate([acc, jnp.ones((pad, 3))], axis=0)
        gyro_p = jnp.concatenate([gyro, jnp.ones((pad, 3))], axis=0)
        dts_p = jnp.concatenate([dts, jnp.zeros(pad)], axis=0)
        p2 = pre.preintegrate(acc_p, gyro_p, dts_p, jnp.zeros(6), calib)
        np.testing.assert_allclose(np.asarray(p2.dR), np.asarray(p1.dR), atol=1e-6)
        np.testing.assert_allclose(np.asarray(p2.dP), np.asarray(p1.dP), atol=1e-6)
        np.testing.assert_allclose(np.asarray(p2.cov), np.asarray(p1.cov), atol=1e-9)
        np.testing.assert_allclose(float(p2.dt), float(p1.dt), atol=1e-6)

    def test_bias_jacobians_first_order(self):
        n, dt = 80, 1.0 / 200.0
        acc, gyro, dts, *_ = synth_trajectory(n, dt)
        calib = make_calib()
        b0 = jnp.zeros(6)
        p0 = pre.preintegrate(acc, gyro, dts, b0, calib)
        db = jnp.array([1e-3, -2e-3, 1.5e-3, 5e-3, -4e-3, 3e-3])
        # Jacobian-corrected deltas vs exact reintegration at the new bias
        p1 = pre.preintegrate(acc, gyro, dts, b0 + db, calib)
        np.testing.assert_allclose(
            np.asarray(pre.delta_rotation(p0, b0 + db)), np.asarray(p1.dR), atol=5e-5)
        np.testing.assert_allclose(
            np.asarray(pre.delta_velocity(p0, b0 + db)), np.asarray(p1.dV), atol=5e-4)
        np.testing.assert_allclose(
            np.asarray(pre.delta_position(p0, b0 + db)), np.asarray(p1.dP), atol=5e-4)

    def test_covariance_psd_and_growth(self):
        n, dt = 60, 1.0 / 200.0
        acc, gyro, dts, *_ = synth_trajectory(n, dt)
        calib = make_calib()
        p = pre.preintegrate(acc, gyro, dts, jnp.zeros(6), calib)
        cov = np.asarray(p.cov, np.float64)
        np.testing.assert_allclose(cov, cov.T, atol=1e-12)
        eig = np.linalg.eigvalsh(cov[:9, :9])
        assert eig.min() > -1e-12
        assert eig.max() > 0

    def test_merge_previous(self):
        n, dt = 40, 1.0 / 200.0
        acc, gyro, dts, *_ = synth_trajectory(n, dt)
        calib = make_calib()
        half = n // 2
        pad = jnp.zeros((10, 3))
        a1 = jnp.concatenate([acc[:half], pad]); g1 = jnp.concatenate([gyro[:half], pad])
        d1 = jnp.concatenate([dts[:half], jnp.zeros(10)])
        a2 = jnp.concatenate([acc[half:], pad]); g2 = jnp.concatenate([gyro[half:], pad])
        d2 = jnp.concatenate([dts[half:], jnp.zeros(10)])
        p1 = pre.preintegrate(a1, g1, d1, jnp.zeros(6), calib)
        p2 = pre.preintegrate(a2, g2, d2, jnp.zeros(6), calib)
        merged = pre.merge_previous(p1, p2, calib)
        full = pre.preintegrate(acc, gyro, dts, jnp.zeros(6), calib)
        np.testing.assert_allclose(np.asarray(merged.dR), np.asarray(full.dR), atol=1e-6)
        np.testing.assert_allclose(np.asarray(merged.dP), np.asarray(full.dP), atol=1e-6)
        np.testing.assert_allclose(float(merged.dt), float(full.dt), atol=1e-6)
