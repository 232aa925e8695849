"""Mono-inertial LONG-HORIZON metric-scale hold (>=60 s).

The reference stages VIBA1/VIBA2 after IMU init and re-pins scale with
LocalMapping::ScaleRefinement (/root/reference/src/LocalMapping.cc:327-368,
2446); the acceptance budget for mono-inertial scale error is <5%
(/root/reference/Changelog.md:45 regime). This drives 64 s of synthetic
mono-inertial SLAM and gates the Sim3-fit scale of the estimated trajectory
against metric ground truth, early and late — the scale must neither come
out wrong at init nor drift over the horizon.
"""
import numpy as np
import pytest

from geoflowslam.io.synthetic import SyntheticWorld, SyntheticSequence, Camera
from geoflowslam.pipeline.system import SlamSystem, SystemConfig
from geoflowslam.pipeline.inertial import ImuConfig
from geoflowslam.state.frame import FrameConfig
from geoflowslam.ops.extractor import OrbConfig
from geoflowslam.eval.ate import ate_rmse


@pytest.mark.slow
def test_mono_inertial_scale_hold_60s():
    w, h = 320, 240
    fps = 5.0
    n_frames = 320                      # 64 s
    cam = Camera(fx=200.0, fy=200.0, cx=w / 2, cy=h / 2, width=w, height=h)
    orb = OrbConfig(n_features=400, n_levels=4, height=h, width=w)
    fc = FrameConfig(orb=orb, lk_levels=3, cloud_stride=8, cloud_max_pts=1024,
                     bf=0.0)
    cfg = SystemConfig(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, bf=0.0,
                       frame=fc, k_max=96, m_max=16384, sensor="mono",
                       min_inliers_ok=12,
                       imu=ImuConfig(init_min_kfs=5, init_min_time=0.8))
    world = SyntheticWorld(cam)
    # freq=2.5 time-warp: accelerations ~1 m/s^2 (handheld regime). Metric
    # scale is OBSERVABLE only under excitation — at the default tame
    # trajectory (~0.15 m/s^2, 1.5% of g) the gravity terms dominate every
    # preintegrated segment and no estimator can separate scale from the
    # rotation-estimate noise floor (the reference requires the same;
    # its mono-inertial sequences are vigorously excited).
    seq = SyntheticSequence(world, fps=fps, scale=1.2, freq=2.5)
    slam = SlamSystem(cfg)

    gt, last_t = [], 0.0
    for i in range(n_frames):
        t = i / fps
        gray, _, (rot_cw, t_cw) = seq.frame(t)
        if i == 0:
            slam.track_monocular(gray, t)
        else:
            acc, gyro, dts = seq.imu_between(last_t, t, 64)
            slam.track_monocular_inertial(gray, acc, gyro, dts, t)
        last_t = t
        twc = np.eye(4)
        rwc = np.asarray(rot_cw).T
        twc[:3, :3] = rwc
        twc[:3, 3] = -rwc @ np.asarray(t_cw)
        gt.append((t, twc))

    stats = slam.map_stats()
    assert stats["state"] == "OK", stats
    assert slam.imu.initialized, stats

    traj = slam.trajectory
    assert len(traj) > n_frames * 0.9, len(traj)
    n = len(traj)

    # scale over the post-init early window and over the late half: the
    # Sim3 alignment scale is the metric-scale error of the estimate
    early = slice(n // 5, n // 2)
    late = slice(n // 2, n)
    m_early = ate_rmse(traj[early], gt[early], with_scale=True)
    m_late = ate_rmse(traj[late], gt[late], with_scale=True)
    assert abs(m_early["scale"] - 1.0) < 0.05, (m_early, stats)
    assert abs(m_late["scale"] - 1.0) < 0.05, (m_late, stats)
    # and the scale must not drift between the halves
    assert abs(m_late["scale"] - m_early["scale"]) < 0.04, (m_early, m_late)

    # rigid (6-DoF) tail ATE: with correct metric scale this stays tight
    tail = n * 2 // 5
    m6 = ate_rmse(traj[-tail:], gt[-tail:], with_scale=False)
    assert m6["ate_rmse"] < 0.15, (m6, stats)
