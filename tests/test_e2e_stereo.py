"""End-to-end stereo + stereo-inertial tracking on the synthetic room."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from geoflowslam.io.synthetic import SyntheticWorld, SyntheticSequence, Camera
from geoflowslam.pipeline.system import SlamSystem, SystemConfig
from geoflowslam.pipeline.inertial import ImuConfig
from geoflowslam.state.frame import FrameConfig
from geoflowslam.ops.extractor import OrbConfig
from geoflowslam.ops.stereo import stereo_match
from geoflowslam.eval.ate import ate_rmse
from geoflowslam.math import lie


BASELINE = 0.1  # meters


def render_stereo(seq, world, t):
    rot_cw, t_cw = seq.pose_cw(t)
    gl, depth = seq._render(rot_cw, t_cw)
    # right camera: shifted +baseline along camera x; Trw = Tcr^-1 ... for a
    # rectified pair T_rw = T_rc ∘ T_cw with t_rc = (-b, 0, 0)
    t_rw = t_cw + jnp.array([-BASELINE, 0.0, 0.0])
    gr, _ = seq._render(rot_cw, t_rw)
    return gl, gr, depth, (rot_cw, t_cw)


def test_stereo_match_depth_accuracy():
    cam = Camera(fx=200.0, fy=200.0, cx=160.0, cy=120.0, width=320, height=240)
    world = SyntheticWorld(cam)
    seq = SyntheticSequence(world, fps=10.0)
    gl, gr, depth, _ = render_stereo(seq, world, 0.0)
    # sample interior pixels with texture
    key = jax.random.PRNGKey(0)
    uv = jax.random.uniform(key, (200, 2),
                            minval=jnp.array([80.0, 20.0]),
                            maxval=jnp.array([300.0, 220.0]))
    bf = cam.fx * BASELINE
    ur, d_est = stereo_match(gl, gr, uv, jnp.ones(200, bool), bf)
    xi = jnp.round(uv[:, 0]).astype(int)
    yi = jnp.round(uv[:, 1]).astype(int)
    d_gt = depth[yi, xi]
    ok = np.asarray(d_est) > 0
    assert ok.mean() > 0.5, ok.mean()
    rel = np.abs(np.asarray(d_est) - np.asarray(d_gt))[ok] / np.asarray(d_gt)[ok]
    assert np.median(rel) < 0.05, np.median(rel)


@pytest.mark.slow
def test_stereo_tracking_ate():
    w, h = 320, 240
    cam = Camera(fx=200.0, fy=200.0, cx=w / 2, cy=h / 2, width=w, height=h)
    orb = OrbConfig(n_features=300, n_levels=4, height=h, width=w)
    bf = cam.fx * BASELINE
    fc = FrameConfig(orb=orb, lk_levels=3, cloud_stride=8, cloud_max_pts=1024,
                     bf=bf)
    cfg = SystemConfig(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, bf=bf,
                       frame=fc, k_max=24, m_max=4096, sensor="rgbd")
    world = SyntheticWorld(cam)
    seq = SyntheticSequence(world, fps=10.0)
    slam = SlamSystem(cfg)
    gt = []
    for i in range(30):
        t = i / seq.fps
        gl, gr, _, (rot_cw, t_cw) = render_stereo(seq, world, t)
        slam.track_stereo(gl, gr, t)
        twc = np.eye(4)
        rwc = np.asarray(rot_cw).T
        twc[:3, :3] = rwc
        twc[:3, 3] = -rwc @ np.asarray(t_cw)
        gt.append((t, twc))
    stats = slam.map_stats()
    assert stats["state"] == "OK", stats
    m = ate_rmse(slam.trajectory, gt)
    assert m["ate_rmse"] < 0.06, (m, stats)


@pytest.mark.slow
def test_stereo_inertial_tracking():
    """Stereo-Inertial (EuRoC configs[2] essence) on the synthetic room."""
    from geoflowslam.pipeline.inertial import ImuConfig
    w, h = 320, 240
    cam = Camera(fx=200.0, fy=200.0, cx=w / 2, cy=h / 2, width=w, height=h)
    orb = OrbConfig(n_features=300, n_levels=4, height=h, width=w)
    bf = cam.fx * BASELINE
    fc = FrameConfig(orb=orb, lk_levels=3, cloud_stride=8, cloud_max_pts=1024,
                     bf=bf)
    cfg = SystemConfig(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, bf=bf,
                       frame=fc, k_max=24, m_max=4096,
                       imu=ImuConfig(init_min_kfs=4, init_min_time=0.5))
    world = SyntheticWorld(cam)
    seq = SyntheticSequence(world, fps=10.0)
    slam = SlamSystem(cfg)
    gt, last_t = [], 0.0
    for i in range(35):
        t = i / seq.fps
        gl, gr, _, (rot_cw, t_cw) = render_stereo(seq, world, t)
        if i == 0:
            slam.track_stereo(gl, gr, t)
        else:
            acc, gyro, dts = seq.imu_between(last_t, t, 32)
            slam.track_stereo_inertial(gl, gr, acc, gyro, dts, t)
        last_t = t
        twc = np.eye(4)
        rwc = np.asarray(rot_cw).T
        twc[:3, :3] = rwc
        twc[:3, 3] = -rwc @ np.asarray(t_cw)
        gt.append((t, twc))
    stats = slam.map_stats()
    assert stats["state"] == "OK", stats
    assert slam.imu.initialized
    tail = len(slam.trajectory) // 2
    m = ate_rmse(slam.trajectory[-tail:], gt[-tail:])
    assert m["ate_rmse"] < 0.06, (m, stats)
