"""End-to-end feature-switch variants: OF / ICP / odometry — the reference's
config-matrix ablation style (SURVEY.md §4: tum_icp_op.yaml etc.)."""
import numpy as np
import jax.numpy as jnp
import pytest

from geoflowslam.io.synthetic import SyntheticWorld, SyntheticSequence, Camera
from geoflowslam.pipeline.system import SlamSystem, SystemConfig
from geoflowslam.state.frame import FrameConfig
from geoflowslam.ops.extractor import OrbConfig
from geoflowslam.eval.ate import ate_rmse


def run_variant(n_frames=30, fps=10.0, **cfg_kw):
    w, h = 320, 240
    cam = Camera(fx=200.0, fy=200.0, cx=w / 2, cy=h / 2, width=w, height=h)
    orb = OrbConfig(n_features=300, n_levels=4, height=h, width=w)
    fc = FrameConfig(orb=orb, lk_levels=3, cloud_stride=8, cloud_max_pts=1024,
                     bf=20.0, n_of_slots=cfg_kw.pop("n_of_slots", 0))
    cfg = SystemConfig(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, bf=20.0,
                       frame=fc, k_max=24, m_max=4096, **cfg_kw)
    world = SyntheticWorld(cam)
    seq = SyntheticSequence(world, fps=fps)
    slam = SlamSystem(cfg)
    gt = []
    for i in range(n_frames):
        t = i / seq.fps
        gray, depth, (rot_cw, t_cw) = seq.frame(t)
        if cfg.use_odom:
            from geoflowslam.io.synthetic import smooth_trajectory
            _, _, v, _, _ = smooth_trajectory(jnp.asarray(t))
            slam.set_odom(np.asarray(v), odom_frame=False)  # world-frame GT
        slam.track_rgbd(gray, depth, t)
        twc = np.eye(4)
        rwc = np.asarray(rot_cw).T
        twc[:3, :3] = rwc
        twc[:3, 3] = -rwc @ np.asarray(t_cw)
        gt.append((t, twc))
    return slam, gt


@pytest.mark.slow
def test_of_tracking():
    # low fps = large inter-frame motion, where the OF streams matter (the
    # spatial dedup mask correctly appends few points under slow motion)
    slam, gt = run_variant(use_of=True, n_of_slots=256, fps=5.0)
    stats = slam.map_stats()
    assert stats["state"] == "OK", stats
    n3d, n2d = getattr(slam, "debug_of", (0, 0))
    assert n3d + n2d > 5, (n3d, n2d)
    m = ate_rmse(slam.trajectory, gt)
    assert m["ate_rmse"] < 0.06, m


@pytest.mark.slow
def test_icp_tracking():
    slam, gt = run_variant(use_icp=True, icp_min_inliers=100)
    stats = slam.map_stats()
    assert stats["state"] == "OK", stats
    m = ate_rmse(slam.trajectory, gt)
    assert m["ate_rmse"] < 0.05, m


@pytest.mark.slow
def test_odom_assist():
    slam, gt = run_variant(use_odom=True)
    stats = slam.map_stats()
    assert stats["state"] == "OK", stats
    m = ate_rmse(slam.trajectory, gt)
    assert m["ate_rmse"] < 0.05, m


@pytest.mark.slow
def test_lidar_tracking():
    slam, gt = run_variant(use_lidar=True)
    stats = slam.map_stats()
    assert stats["state"] == "OK", stats
    m = ate_rmse(slam.trajectory, gt)
    assert m["ate_rmse"] < 0.05, m
    # global map accumulates
    assert len(slam.global_map.points()) > 500


@pytest.mark.slow
def test_g1_of_icp_lidar_fused():
    """The flagship G1 switch combo — OF dual-stream + GICP predictor +
    lidar point-to-plane — all three FUSED in one frame dispatch
    (g1_op_icp_lidar_indoor1.yaml; plane factors src/Optimizer.cc:8338-8421).
    Asserts the fast path was actually taken (use_lidar no longer
    disqualifies _can_fuse) and accuracy holds."""
    slam, gt = run_variant(use_of=True, n_of_slots=256, use_icp=True,
                           icp_min_inliers=100, use_lidar=True)
    stats = slam.map_stats()
    assert stats["state"] == "OK", stats
    assert slam._can_fuse(), "G1 combo fell back to the staged path"
    m = ate_rmse(slam.trajectory, gt)
    assert m["ate_rmse"] < 0.05, m
    assert len(slam.global_map.points()) > 500


@pytest.mark.slow
def test_icp_inertial_edgeicp():
    """The flagship G1 combo: RGB-D + IMU + ICP (EdgeICP factors in VI-BA)."""
    from geoflowslam.pipeline.inertial import ImuConfig
    w, h = 320, 240
    cam = Camera(fx=200.0, fy=200.0, cx=w / 2, cy=h / 2, width=w, height=h)
    orb = OrbConfig(n_features=300, n_levels=4, height=h, width=w)
    fc = FrameConfig(orb=orb, lk_levels=3, cloud_stride=8, cloud_max_pts=1024,
                     bf=20.0)
    cfg = SystemConfig(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, bf=20.0,
                       frame=fc, k_max=24, m_max=4096,
                       imu=ImuConfig(init_min_kfs=4, init_min_time=0.5),
                       use_icp=True, icp_min_inliers=100)
    world = SyntheticWorld(cam)
    seq = SyntheticSequence(world, fps=10.0)
    slam = SlamSystem(cfg)
    gt, last_t = [], 0.0
    for i in range(35):
        t = i / seq.fps
        gray, depth, (rot_cw, t_cw) = seq.frame(t)
        if i == 0:
            slam.track_rgbd(gray, depth, t)
        else:
            acc, gyro, dts = seq.imu_between(last_t, t, 32)
            slam.track_rgbd_inertial(gray, depth, acc, gyro, dts, t)
        last_t = t
        twc = np.eye(4)
        rwc = np.asarray(rot_cw).T
        twc[:3, :3] = rwc
        twc[:3, 3] = -rwc @ np.asarray(t_cw)
        gt.append((t, twc))
    stats = slam.map_stats()
    assert stats["state"] == "OK", stats
    assert slam.imu.initialized
    assert len(slam._kf_icp_rel) >= 1  # EdgeICP factors were generated
    tail = len(slam.trajectory) // 2
    m = ate_rmse(slam.trajectory[-tail:], gt[-tail:])
    assert m["ate_rmse"] < 0.05, (m, stats)
