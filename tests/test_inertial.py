import jax
import jax.numpy as jnp
import numpy as np

from geoflowslam.math import lie
from geoflowslam.imu import preintegration as pre
from geoflowslam.solvers import inertial
from geoflowslam.solvers.pose_opt import PoseObs

FX, FY, CX, CY = 400.0, 400.0, 320.0, 240.0


def make_calib():
    return pre.ImuCalib.create(np.eye(4, dtype=np.float32), 1.7e-4, 2e-3,
                               1.9e-5, 3e-3, 200.0)


def simulate_segment(t0, t1, rate=200.0, bias=None, max_s=64):
    """IMU samples between t0, t1 on the test trajectory of
    tests/test_preintegration.synth_trajectory-style motion."""
    from geoflowslam.io.synthetic import smooth_trajectory, GRAVITY
    dt = 1.0 / rate
    n = int(round((t1 - t0) * rate))
    ts = t0 + (jnp.arange(max_s) + 0.5) * dt
    rot_wb, p, v, a_w, w_body = smooth_trajectory(ts)
    acc = jnp.einsum("sij,sj->si", jnp.swapaxes(rot_wb, -1, -2), a_w - GRAVITY)
    gyro = w_body
    if bias is not None:
        gyro = gyro + bias[:3]
        acc = acc + bias[3:]
    dts = jnp.where(jnp.arange(max_s) < n, dt, 0.0)
    return acc.astype(jnp.float32), gyro.astype(jnp.float32), dts.astype(jnp.float32)


def state_at(t):
    from geoflowslam.io.synthetic import smooth_trajectory
    rot, p, v, *_ = smooth_trajectory(jnp.asarray(t))
    return inertial.BodyState(r_wb=rot, p=p, v=v, bg=jnp.zeros(3), ba=jnp.zeros(3))


class TestInertialPoseOpt:
    def test_visual_inertial_tracking(self):
        calib = make_calib()
        t0, t1 = 1.0, 1.2
        s1 = state_at(t0)
        s2_gt = state_at(t1)
        acc, gyro, dts = simulate_segment(t0, t1)
        p = pre.preintegrate(acc, gyro, dts, jnp.zeros(6), calib)

        # visual observations of world points from the body/cam pose at t1
        key = jax.random.PRNGKey(0)
        pts = jax.random.uniform(key, (200, 3), minval=jnp.array([-2, -2, 2.0]),
                                 maxval=jnp.array([2, 2, 6.0]))
        r_cb, t_cb = jnp.eye(3), jnp.zeros(3)  # body == cam
        rot_cw, t_cw = inertial.cam_pose_from_body(s2_gt, r_cb, t_cb)
        pc = pts @ rot_cw.T + t_cw
        uv = pc[:, :2] / pc[:, 2:3] * FX + jnp.array([CX, CY])
        uv = uv + jax.random.normal(jax.random.PRNGKey(1), uv.shape) * 0.3
        n = pts.shape[0]
        obs = PoseObs(pts_w=pts, uv=uv, u_right=jnp.zeros(n),
                      is_stereo=jnp.zeros(n, bool), inv_sigma2=jnp.ones(n),
                      valid=pc[:, 2] > 0.1)

        # init from IMU prediction only
        r_p, p_p, v_p = pre.predict_state(s1.r_wb, s1.p, s1.v, p, jnp.zeros(6))
        s2_init = inertial.BodyState(r_wb=r_p, p=p_p, v=v_p,
                                     bg=jnp.zeros(3), ba=jnp.zeros(3))
        s2, inl, n_inl = inertial.inertial_pose_optimization(
            s2_init, s1, p, obs, r_cb, t_cb, FX, FY, CX, CY, calib=calib)
        np.testing.assert_allclose(np.asarray(s2.r_wb), np.asarray(s2_gt.r_wb), atol=3e-3)
        np.testing.assert_allclose(np.asarray(s2.p), np.asarray(s2_gt.p), atol=2e-2)
        np.testing.assert_allclose(np.asarray(s2.v), np.asarray(s2_gt.v), atol=0.15)
        assert int(n_inl) > 180

    def test_inertial_residual_zero_at_gt(self):
        calib = make_calib()
        t0, t1 = 0.5, 0.7
        s1, s2 = state_at(t0), state_at(t1)
        acc, gyro, dts = simulate_segment(t0, t1)
        p = pre.preintegrate(acc, gyro, dts, jnp.zeros(6), calib)
        r = inertial.inertial_residual(s1, s2, p)
        assert float(jnp.abs(r).max()) < 5e-3, np.asarray(r)


class TestImuInit:
    def test_gyro_bias_recovery(self):
        calib = make_calib()
        bias_gt = jnp.array([0.02, -0.015, 0.01, 0.0, 0.0, 0.0])
        times = np.arange(0.0, 2.0, 0.25)
        rots, dRs, jrgs, valid = [], [], [], []
        for i, t in enumerate(times):
            rots.append(state_at(t).r_wb)
        for i in range(len(times) - 1):
            acc, gyro, dts = simulate_segment(times[i], times[i + 1], bias=bias_gt)
            p = pre.preintegrate(acc, gyro, dts, jnp.zeros(6), calib)
            dRs.append(p.dR)
            jrgs.append(p.JRg)
            valid.append(True)
        bg = inertial.solve_gyro_bias(
            jnp.stack(rots), jnp.stack(dRs), jnp.stack(jrgs),
            jnp.asarray(valid))
        np.testing.assert_allclose(np.asarray(bg), np.asarray(bias_gt[:3]), atol=1e-3)

    def test_gravity_velocity_recovery(self):
        calib = make_calib()
        times = np.arange(0.0, 2.0, 0.25)
        states = [state_at(t) for t in times]
        dVs, dPs, dts_seg, valid = [], [], [], []
        for i in range(len(times) - 1):
            acc, gyro, dts = simulate_segment(times[i], times[i + 1])
            p = pre.preintegrate(acc, gyro, dts, jnp.zeros(6), calib)
            dVs.append(p.dV); dPs.append(p.dP); dts_seg.append(p.dt)
            valid.append(True)
        vels, grav, scale = inertial.solve_gravity_scale_velocities(
            jnp.stack([s.r_wb for s in states]),
            jnp.stack([s.p for s in states]),
            jnp.stack(dts_seg), jnp.stack(dVs), jnp.stack(dPs),
            jnp.asarray(valid))
        np.testing.assert_allclose(np.asarray(grav), [0, 0, -9.81], atol=0.05)
        v_gt = np.stack([np.asarray(s.v) for s in states])
        np.testing.assert_allclose(np.asarray(vels), v_gt, atol=0.05)

    def test_gravity_alignment(self):
        g = jnp.array([0.3, -0.5, -9.7])
        r = inertial.gravity_alignment_rotation(g)
        aligned = r @ g
        np.testing.assert_allclose(np.asarray(aligned[:2]), 0.0, atol=1e-5)
        assert float(aligned[2]) < -9.0


class TestSegmentCompaction:
    def test_long_kf_gap_decimates_to_capacity(self):
        """A KF segment longer than 2x seg_capacity (lost stretches /
        delayed KF decisions at low frame rates) must decimate repeatedly —
        one halving used to leave len > cap and crash np.pad with a
        negative width — while preserving total integration time."""
        from geoflowslam.pipeline.inertial import InertialTracker, ImuConfig

        tr = InertialTracker(ImuConfig())
        rate, dt = 200.0, 1.0 / 200.0
        # 12.8 s of samples = 2560 live rows = 5x the 512 capacity
        for k in range(128):
            n = 20
            acc = np.random.randn(32, 3).astype(np.float32)
            gyro = np.random.randn(32, 3).astype(np.float32)
            dts = np.where(np.arange(32) < n, dt, 0.0).astype(np.float32)
            tr._chunks.append((acc, gyro, dts, 0.1 * k))
        acc, gyro, dts = tr._stack_chunks_np()
        assert acc.shape == (tr.seg_capacity, 3)
        assert dts.shape == (tr.seg_capacity,)
        assert abs(float(dts.sum()) - 128 * 20 * dt) < 1e-3
