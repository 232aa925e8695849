"""End-to-end RGB-D tracking on the synthetic room (the reference validates
with dataset runs + ATE, SURVEY.md §4; this is the equivalent harness)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from geoflowslam.io.synthetic import SyntheticWorld, SyntheticSequence, Camera
from geoflowslam.pipeline.system import SlamSystem, SystemConfig, TrackingState
from geoflowslam.state.frame import FrameConfig
from geoflowslam.ops.extractor import OrbConfig
from geoflowslam.eval.ate import ate_rmse, rpe


def small_system(w=320, h=240):
    cam = Camera(fx=200.0, fy=200.0, cx=w / 2, cy=h / 2, width=w, height=h)
    orb = OrbConfig(n_features=400, n_levels=4, height=h, width=w)
    fc = FrameConfig(orb=orb, lk_levels=3, cloud_stride=8, cloud_max_pts=1024,
                     bf=20.0)
    sys_cfg = SystemConfig(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
                           bf=20.0, frame=fc, k_max=24, m_max=4096)
    return cam, sys_cfg


# fast-tier e2e: kept in the default smoke run
def test_rgbd_tracking_ate():
    cam, cfg = small_system()
    world = SyntheticWorld(cam)
    seq = SyntheticSequence(world, fps=10.0)
    slam = SlamSystem(cfg)

    gt = []
    n_frames = 40
    for i in range(n_frames):
        t = i / seq.fps
        gray, depth, (rot_cw, t_cw) = seq.frame(t)
        slam.track_rgbd(gray, depth, t)
        twc = np.eye(4)
        rwc = np.asarray(rot_cw).T
        twc[:3, :3] = rwc
        twc[:3, 3] = -rwc @ np.asarray(t_cw)
        gt.append((t, twc))

    stats = slam.map_stats()
    assert stats["state"] == "OK", stats
    assert stats["n_kfs"] >= 2, stats

    m = ate_rmse(slam.trajectory, gt)
    # room is ~6m across; trajectory amplitude ~1m. Sub-5cm ATE expected.
    assert m["ate_rmse"] < 0.05, (m, stats)

    r = rpe(slam.trajectory, gt)
    assert r["rpe_trans"] < 0.03, r
