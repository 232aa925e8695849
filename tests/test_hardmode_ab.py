"""Hard-sequence A/B for the GeoFlow robustness stack (VERDICT round-4 #4).

The dual-stream optical flow + GICP predictor exist to rescue tracking
under fast rotation and texture loss (the paper's contribution,
/root/reference/src/ORBmatcher.cc:2303-2497, src/Tracking.cc:3365-3465,
3576-3623; evidenced upstream by config-matrix runs tum_icp_op.yaml vs
tum_no_icp_op.yaml). This pins the delta in CI at a CPU-tractable
operating point: HardSyntheticSequence at 6 fps input (≈5x the
inter-frame motion of the 30 fps real-chip matrix cells) over a blank-wall
window + rotation bursts.

Measured at this operating point (2026-08, CPU mesh):
  switches OFF: RECENTLY_LOST, ATE 77 cm   — the documented failure
  switches ON:  see gate below             — the rescue
The real-chip analogue is results_hard/ rgbd vs rgbd_of_icp
(tests/test_hardmode_gate.py).
"""
import numpy as np
import pytest

from geoflowslam.io.synthetic import (SyntheticWorld,
                                      HardSyntheticSequence, Camera)
from geoflowslam.pipeline.system import SlamSystem, SystemConfig
from geoflowslam.state.frame import FrameConfig
from geoflowslam.ops.extractor import OrbConfig
from geoflowslam.eval.ate import ate_rmse

FPS = 6.0
N_FRAMES = 90          # 15 s: through the t=10 s blank-wall window


def _run(robust: bool):
    w, h = 320, 240
    cam = Camera(fx=200.0, fy=200.0, cx=w / 2, cy=h / 2, width=w, height=h)
    orb = OrbConfig(n_features=400, n_levels=4, height=h, width=w)
    fc = FrameConfig(orb=orb, lk_levels=3, cloud_stride=8,
                     cloud_max_pts=1024, bf=20.0,
                     n_of_slots=256 if robust else 0)
    kw = dict(use_of=True, use_icp=True, icp_min_inliers=100) if robust \
        else {}
    cfg = SystemConfig(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, bf=20.0,
                       frame=fc, k_max=32, m_max=8192, **kw)
    world = SyntheticWorld(cam)
    seq = HardSyntheticSequence(world, fps=FPS)
    slam = SlamSystem(cfg)
    gt = []
    for i in range(N_FRAMES):
        t = i / FPS
        gray, depth, (rot_cw, t_cw) = seq.frame(t)
        slam.track_rgbd(gray, depth, t)
        twc = np.eye(4)
        rwc = np.asarray(rot_cw).T
        twc[:3, :3] = rwc
        twc[:3, 3] = -rwc @ np.asarray(t_cw)
        gt.append((t, twc))
    st = slam.map_stats()
    m = ate_rmse(slam.trajectory, gt)
    return slam, st, m


@pytest.mark.slow
def test_of_icp_rescues_hard_sequence():
    slam, st, m = _run(robust=True)
    assert st["n_maps"] == 1, st
    assert st["state"] == "OK", st
    assert m["ate_rmse"] < 0.15, (m, st)
    # the OF streams actually fired (device counters from the fused step)
    n3d, n2d = (int(x) for x in np.asarray(slam.debug_of))
    assert n3d + n2d > 0, (n3d, n2d)


@pytest.mark.slow
def test_visual_only_fails_hard_sequence():
    """Companion: the same sequence WITHOUT the robustness stack loses
    tracking — documents the failure the stack exists to fix. If this ever
    starts passing, the A/B no longer separates and both gates should be
    re-tightened."""
    slam, st, m = _run(robust=False)
    degraded = (st["n_maps"] >= 2 or st["state"] != "OK"
                or m["ate_rmse"] > 0.30)
    assert degraded, ("visual-only now survives the hard sequence; "
                      "re-calibrate the A/B", st, m)
