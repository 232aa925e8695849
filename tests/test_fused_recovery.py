"""Frame-rate degraded mode: the fused RECOVERY step relocalizes on device.

Round-4 VERDICT item 3: RECENTLY_LOST frames must stay on the single-dispatch
fused loop (pipeline/fused.frame_step with_recovery=True runs the
relocalization of Tracking::Relocalization, /root/reference/src/
Tracking.cc:4537, INSIDE the dispatch under a lax.cond) instead of falling
into the eager staged machinery. The host learns of a device-side reloc via
the packet aux slot and flips its state machine without extra syncs.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from geoflowslam.io.synthetic import SyntheticWorld, SyntheticSequence, Camera
from geoflowslam.pipeline.system import SlamSystem, SystemConfig, TrackingState
from geoflowslam.state.frame import FrameConfig
from geoflowslam.ops.extractor import OrbConfig, extract
from geoflowslam.retrieval import vocab as V


def _mk(loop=False):
    w, h = 320, 240
    cam = Camera(fx=200.0, fy=200.0, cx=w / 2, cy=h / 2, width=w, height=h)
    orb = OrbConfig(n_features=300, n_levels=4, height=h, width=w)
    fc = FrameConfig(orb=orb, lk_levels=3, cloud_stride=8, cloud_max_pts=1024,
                     bf=20.0)
    world = SyntheticWorld(cam)
    seq = SyntheticSequence(world, fps=10.0)
    desc = []
    for t in [0.0, 0.7, 1.4]:
        gray, _, _ = seq.frame(t)
        fs = extract(gray, orb)
        desc.append(np.asarray(fs.desc)[np.asarray(fs.valid)])
    voc = V.build_vocabulary(np.concatenate(desc), k=8, levels=2, iters=3)
    loop_cfg = None
    if loop:
        from geoflowslam.pipeline.loop_closing import LoopConfig
        loop_cfg = LoopConfig(min_sim3_inliers=15, min_score=0.02)
    cfg = SystemConfig(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, bf=20.0,
                       frame=fc, k_max=32, m_max=4096,
                       kf_min_interval=1, kf_max_interval=2,
                       # long RECENTLY_LOST budget: recovery must succeed by
                       # relocalizing, not by resetting into a new map
                       time_recently_lost=30.0,
                       loop=loop_cfg)
    return cam, seq, cfg, voc, (w, h)


@pytest.mark.slow
def test_fused_recovery_relocalizes_without_new_map():
    """Lose tracking on blank frames, revisit a mapped view: the fused
    recovery variant must relocalize back into the SAME map (n_maps == 1)
    while the system never leaves the fused dispatch loop."""
    cam, seq, cfg, voc, (w, h) = _mk(loop=False)
    slam = SlamSystem(cfg, vocab=voc)
    # reloc is possible without a LoopCloser: the System-owned KF database
    # (the reference's mpKeyFrameDatabase exists regardless of loop closing)
    assert slam._recovery_capable()

    for i in range(22):
        t = i / seq.fps
        gray, depth, _ = seq.frame(t)
        slam.track_rgbd(gray, depth, t)
    st_a = slam.map_stats()
    assert st_a["n_kfs"] >= 6 and st_a["state"] == "OK", st_a

    # blank wall: tracking must degrade to RECENTLY_LOST (not LOST: the
    # recently-lost budget is long, and no IMU means no KF insertion)
    blank = jnp.full((h, w), 100.0)
    bdepth = jnp.full((h, w), 2.0)
    n_lost_seen = 0
    for i in range(8):
        t = 2.2 + i / seq.fps
        slam.track_rgbd(blank, bdepth, t)
        slam._flush_pending()
        n_lost_seen += slam.state == TrackingState.RECENTLY_LOST
    assert n_lost_seen >= 4, (n_lost_seen, slam.state)
    assert slam.map_stats()["n_maps"] == 1

    # revisit mapped views: the DEVICE-side reloc (aux >= 2) must re-acquire
    for i in range(6):
        t = 3.2 + i / seq.fps
        gray, depth, _ = seq.frame((4 + i) / seq.fps)
        slam.track_rgbd(gray, depth, t)
    st = slam.map_stats()
    assert st["state"] == "OK", st
    assert st["n_maps"] == 1, st          # same map — no Atlas fragmentation
    assert slam.n_lost >= 4               # the loss was real

    # and tracking continues normally afterwards (bindings re-acquired)
    for i in range(6, 12):
        t = 3.2 + i / seq.fps
        gray, depth, _ = seq.frame((4 + i) / seq.fps)
        slam.track_rgbd(gray, depth, t)
    st2 = slam.map_stats()
    assert st2["state"] == "OK", st2
    assert st2["n_kfs"] >= st["n_kfs"]    # KF insertion resumed


@pytest.mark.slow
def test_kf_stall_watchdog_counts():
    """The silent-stall watchdog (round-4 VERDICT weak #6) trips when no KF
    lands for >10 s while the system claims OK."""
    cam, seq, cfg, voc, (w, h) = _mk(loop=False)
    slam = SlamSystem(cfg, vocab=voc)
    for i in range(10):
        t = i / seq.fps
        gray, depth, _ = seq.frame(t)
        slam.track_rgbd(gray, depth, t)
    assert slam.map_stats()["state"] == "OK"
    assert slam.kf_stall_warnings == 0
    # hold the camera perfectly still with a huge KF interval: tracking is
    # OK forever, no parallax, KF policy inserts nothing -> watchdog trips
    import dataclasses
    slam.cfg = dataclasses.replace(slam.cfg, kf_max_interval=10_000)
    gray, depth, _ = seq.frame(9 / seq.fps)
    for i in range(10, 140):
        slam.track_rgbd(gray, depth, i / seq.fps)
    slam._flush_pending()
    assert slam.kf_stall_warnings >= 1
