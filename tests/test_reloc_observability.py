"""Relocalization under wide-baseline revisit + reprojection-error
observability (SaveFrame2FrameReprojErr parity).

Reference behaviours covered:
* Tracking::Relocalization (/root/reference/src/Tracking.cc:4537): KF-DB
  candidates -> SearchWithGMS-filtered matching (src/ORBmatcher.cc:744) ->
  PnP RANSAC -> pose refinement, entered from RECENTLY_LOST.
* mFrame2FrameReprojErr / mFrame2MapReprojErr recording and the shutdown
  dumps (include/Tracking.h:430-431, include/System.h:184-185).
"""
import os

import numpy as np
import jax.numpy as jnp
import pytest

from geoflowslam.io.synthetic import SyntheticWorld, SyntheticSequence, Camera
from geoflowslam.pipeline.system import (SlamSystem, SystemConfig,
                                         TrackingState)
from geoflowslam.state.frame import FrameConfig
from geoflowslam.ops.extractor import OrbConfig, extract
from geoflowslam.retrieval import vocab as V


def _small_setup(w=320, h=240, n_feat=300, **cfg_kw):
    cam = Camera(fx=200.0, fy=200.0, cx=w / 2, cy=h / 2, width=w, height=h)
    orb = OrbConfig(n_features=n_feat, n_levels=4, height=h, width=w)
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
    cfg = SystemConfig(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, bf=20.0,
                       frame=fc, k_max=32, m_max=4096,
                       kf_min_interval=1, kf_max_interval=2, **cfg_kw)
    return cam, seq, voc, cfg


@pytest.mark.slow
def test_relocalization_wide_baseline():
    """Lose tracking on blank frames, then revisit an early viewpoint with
    image noise: relocalization (GMS-filtered matching + PnP) must recover
    the pose instead of spawning a new Atlas map."""
    cam, seq, voc, cfg = _small_setup(
        # keep the system in RECENTLY_LOST (no new-map escape hatch)
        time_recently_lost=30.0, min_kfs_for_new_map=99)
    slam = SlamSystem(cfg, vocab=voc)

    first_pass = {}
    for i in range(20):
        t = i / seq.fps
        gray, depth, _ = seq.frame(t)
        slam.track_rgbd(gray, depth, t)
        first_pass[round(t, 2)] = slam.current_pose_wc().copy()
    assert slam.map_stats()["state"] == "OK"
    assert slam.map_stats()["n_kfs"] >= 5

    blank = jnp.full((cam.height, cam.width), 100.0)
    bdepth = jnp.full((cam.height, cam.width), 2.0)
    for i in range(6):
        t = 2.0 + i / seq.fps
        slam.track_rgbd(blank, bdepth, t)
    assert slam.map_stats()["state"] in ("RECENTLY_LOST", "LOST")

    # wide-baseline revisit: an early viewpoint, notably different from the
    # last tracked frame, with sensor noise on the image
    rng = np.random.default_rng(7)
    t_re = 0.4
    gray, depth, (rot_cw, t_cw) = seq.frame(t_re)
    noisy = np.clip(np.asarray(gray) + rng.normal(0, 6.0, gray.shape), 0, 255)
    ok = False
    for i in range(3):   # a few attempts, as the reference's per-frame loop
        t = 3.0 + i / seq.fps
        slam.track_rgbd(noisy, depth, t)
        if slam.map_stats()["state"] == "OK":
            ok = True
            break
    assert ok, slam.map_stats()
    # a couple of clean frames after the reloc snap the pose back onto the
    # map (the reference likewise refines over the frames that follow).
    # Gate against the system's OWN first-pass estimate at the same
    # viewpoint: reloc recovers the pose *in the map frame* — residual
    # map-vs-GT drift (~0.2 m here) is a mapping property, not a reloc one.
    for i in range(1, 4):
        t_c = t_re + i / seq.fps
        gray_c, depth_c, _ = seq.frame(t_c)
        slam.track_rgbd(gray_c, depth_c, 3.5 + i / seq.fps)
    assert slam.map_stats()["state"] == "OK", slam.map_stats()
    pose = slam.current_pose_wc()
    ref_pose = first_pass[round(t_c, 2)]
    err = np.linalg.norm(pose[:3, 3] - ref_pose[:3, 3])
    assert err < 0.1, (err, pose[:3, 3], ref_pose[:3, 3])


def test_reproj_err_dumps(tmp_path):
    """record_reproj_err=True records per-frame f2f/f2m reprojection stats
    and shutdown writes the Frame2{Frame,Map}ReprojErr.txt dumps."""
    cam, seq, voc, cfg = _small_setup(n_feat=200)
    cfg = SystemConfig(**{**cfg.__dict__, "record_reproj_err": True})
    slam = SlamSystem(cfg, vocab=voc)
    for i in range(8):
        t = i / seq.fps
        gray, depth, _ = seq.frame(t)
        slam.track_rgbd(gray, depth, t)
    assert len(slam.f2f_reproj) > 0 and len(slam.f2m_reproj) > 0
    # tracked-frame reprojection error should be subpixel-ish on synthetic
    errs = [e for (_, e, _) in slam.f2m_reproj if e > 0]
    assert errs and float(np.median(errs)) < 5.0, errs

    out = str(tmp_path)
    slam.shutdown(save_dir=out)
    for name in ("Frame2FrameReprojErr.txt", "Frame2MapReprojErr.txt"):
        p = os.path.join(out, name)
        assert os.path.exists(p), name
        assert os.path.getsize(p) > 0, name
