"""End-to-end RGB-D-inertial tracking on the synthetic room."""
import numpy as np
import jax.numpy as jnp
import pytest

from geoflowslam.io.synthetic import SyntheticWorld, SyntheticSequence, Camera
from geoflowslam.pipeline.system import SlamSystem, SystemConfig
from geoflowslam.pipeline.inertial import ImuConfig
from geoflowslam.state.frame import FrameConfig
from geoflowslam.ops.extractor import OrbConfig
from geoflowslam.eval.ate import ate_rmse


def small_system(w=320, h=240):
    cam = Camera(fx=200.0, fy=200.0, cx=w / 2, cy=h / 2, width=w, height=h)
    orb = OrbConfig(n_features=400, n_levels=4, height=h, width=w)
    fc = FrameConfig(orb=orb, lk_levels=3, cloud_stride=8, cloud_max_pts=1024,
                     bf=20.0)
    imu = ImuConfig(init_min_kfs=4, init_min_time=0.5)
    sys_cfg = SystemConfig(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
                           bf=20.0, frame=fc, k_max=24, m_max=4096, imu=imu)
    return cam, sys_cfg


@pytest.mark.slow
def test_rgbd_inertial_tracking():
    cam, cfg = small_system()
    world = SyntheticWorld(cam)
    seq = SyntheticSequence(world, fps=10.0)
    slam = SlamSystem(cfg)

    gt = []
    n_frames = 50
    last_t = 0.0
    for i in range(n_frames):
        t = i / seq.fps
        gray, depth, (rot_cw, t_cw) = seq.frame(t)
        if i == 0:
            slam.track_rgbd(gray, depth, t)
        else:
            acc, gyro, dts = seq.imu_between(last_t, t, cfg.imu.max_samples_per_frame)
            slam.track_rgbd_inertial(gray, depth, acc, gyro, dts, t)
        last_t = t
        twc = np.eye(4)
        rwc = np.asarray(rot_cw).T
        twc[:3, :3] = rwc
        twc[:3, 3] = -rwc @ np.asarray(t_cw)
        gt.append((t, twc))

    stats = slam.map_stats()
    assert stats["state"] == "OK", stats
    assert slam.imu.initialized, stats

    # evaluate the post-initialization tail only (the map is re-aligned at
    # IMU init; the reference similarly rewrites the trajectory at save time)
    tail = int(n_frames * 0.5)
    m = ate_rmse(slam.trajectory[-tail:], gt[-tail:])
    assert m["ate_rmse"] < 0.05, (m, stats)

    # velocity estimate sanity: near ground-truth speed scale
    v = np.asarray(slam.imu.body.v)
    assert np.isfinite(v).all() and np.linalg.norm(v) < 3.0
