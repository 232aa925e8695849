"""Long-horizon soak: hard-mode sequence with epoch timestamps at the forced
inertial KF cadence — the VERDICT round-2 acceptance criteria (holds ATE,
never evicts a live KF, per-KF mapping cost stays flat)."""
import time

import jax.numpy as jnp
import numpy as np
import pytest

from geoflowslam.io.synthetic import (SyntheticWorld,
                                      HardSyntheticSequence, Camera)
from geoflowslam.pipeline.system import SlamSystem, SystemConfig
from geoflowslam.pipeline.inertial import ImuConfig
from geoflowslam.pipeline.loop_closing import LoopConfig
from geoflowslam.retrieval.vocab import default_vocabulary
from geoflowslam.state.frame import FrameConfig
from geoflowslam.ops.extractor import OrbConfig
from geoflowslam.eval.ate import ate_rmse


@pytest.mark.slow
def test_hardmode_epoch_soak():
    w, h = 320, 240
    cam = Camera(fx=200.0, fy=200.0, cx=w / 2, cy=h / 2, width=w, height=h)
    orb = OrbConfig(n_features=300, n_levels=4, height=h, width=w)
    fc = FrameConfig(orb=orb, lk_levels=3, cloud_stride=8, cloud_max_pts=1024,
                     bf=20.0)
    cfg = SystemConfig(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, bf=20.0,
                       frame=fc, k_max=96, m_max=16384,
                       imu=ImuConfig(), loop=LoopConfig())
    world = SyntheticWorld(cam)
    seq = HardSyntheticSequence(world, fps=10.0)
    slam = SlamSystem(cfg, vocab=default_vocabulary())

    t0 = 1.4e9          # epoch-scale stamps (TUM/EuRoC regime)
    n_frames = 420      # 42 s -> a full loop revisit at the 40 s period
    gt, last_t = [], None
    kf_costs = []
    for i in range(n_frames):
        ts = i / seq.fps
        gray, depth, (rot_cw, t_cw) = seq.frame(ts)
        n_kf_before = slam.map_stats()["n_kfs"]
        tk0 = time.perf_counter()
        if last_t is None:
            slam.track_rgbd(gray, depth, t0 + ts)
        else:
            acc, gyro, dts = seq.imu_between(last_t, ts, 32)
            slam.track_rgbd_inertial(gray, depth, acc, gyro, dts, t0 + ts)
        if slam.map_stats()["n_kfs"] != n_kf_before:
            kf_costs.append(time.perf_counter() - tk0)
        last_t = ts
        twc = np.eye(4)
        rwc = np.asarray(rot_cw).T
        twc[:3, :3] = rwc
        twc[:3, 3] = -rwc @ np.asarray(t_cw)
        gt.append((t0 + ts, twc))

    st = slam.map_stats()
    assert st["state"] == "OK", st
    assert slam.imu.initialized
    # the forced 0.5 s inertial cadence over 42 s plus culling stays within
    # capacity: the live-KF eviction guard never tripped (it raises)
    assert st["n_kfs"] < cfg.k_max, st
    # Loop closing is ON (LoopClosing thread parity, src/LoopClosing.cc:105)
    # and the sequence revisits its start at the 40 s period: the loop must
    # close and pull accumulated drift back under a tight gate.
    from geoflowslam.eval.ate import rpe
    r = rpe(slam.trajectory, gt)
    assert r["rpe_trans"] < 0.06, (r, st)
    m = ate_rmse(slam.trajectory, gt)
    assert m["ate_rmse"] < 0.10, (m, st)
    # flat per-KF mapping cost: the late half must not grow with map size
    # (generous 2x bound; catches O(K*M)-per-KF regressions, not jitter)
    half = len(kf_costs) // 2
    early = np.median(kf_costs[1:half])
    late = np.median(kf_costs[half:])
    assert late < 2.0 * early + 0.05, (early, late)
