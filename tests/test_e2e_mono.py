"""End-to-end monocular tracking on the synthetic room (BASELINE config[0])."""
import numpy as np
import pytest

from geoflowslam.io.synthetic import SyntheticWorld, SyntheticSequence, Camera
from geoflowslam.pipeline.system import SlamSystem, SystemConfig
from geoflowslam.state.frame import FrameConfig
from geoflowslam.ops.extractor import OrbConfig
from geoflowslam.eval.ate import ate_rmse


# fast-tier e2e: kept in the default smoke run
def test_mono_tracking_ate():
    w, h = 320, 240
    cam = Camera(fx=200.0, fy=200.0, cx=w / 2, cy=h / 2, width=w, height=h)
    orb = OrbConfig(n_features=400, n_levels=4, height=h, width=w)
    fc = FrameConfig(orb=orb, lk_levels=3, cloud_stride=8, cloud_max_pts=1024,
                     bf=0.0)
    cfg = SystemConfig(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, bf=0.0,
                       frame=fc, k_max=24, m_max=4096, sensor="mono",
                       min_inliers_ok=12)
    world = SyntheticWorld(cam)
    seq = SyntheticSequence(world, fps=10.0)
    slam = SlamSystem(cfg)

    gt = []
    n_frames = 40
    for i in range(n_frames):
        t = i / seq.fps
        gray, _, (rot_cw, t_cw) = seq.frame(t)
        slam.track_monocular(gray, t)
        twc = np.eye(4)
        rwc = np.asarray(rot_cw).T
        twc[:3, :3] = rwc
        twc[:3, 3] = -rwc @ np.asarray(t_cw)
        gt.append((t, twc))

    stats = slam.map_stats()
    assert stats["state"] == "OK", stats
    assert stats["n_kfs"] >= 2, stats

    # monocular: scale is free -> 7-DoF alignment
    tail = len(slam.trajectory) * 3 // 4
    m = ate_rmse(slam.trajectory[-tail:], gt[-tail:], with_scale=True)
    assert m["ate_rmse"] < 0.06, (m, stats)
