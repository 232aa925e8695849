"""End-to-end Atlas multi-map recovery + loop-closing merge (BASELINE
config[4] essence): track, lose tracking on blank frames, start a new map,
revisit the same area, and let place recognition weld the maps."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from geoflowslam.io.synthetic import SyntheticWorld, SyntheticSequence, Camera
from geoflowslam.pipeline.system import SlamSystem, SystemConfig, TrackingState
from geoflowslam.pipeline.loop_closing import LoopConfig
from geoflowslam.state.frame import FrameConfig
from geoflowslam.ops.extractor import OrbConfig, extract
from geoflowslam.retrieval import vocab as V


@pytest.mark.slow
def test_atlas_break_and_merge():
    w, h = 320, 240
    cam = Camera(fx=200.0, fy=200.0, cx=w / 2, cy=h / 2, width=w, height=h)
    orb = OrbConfig(n_features=300, n_levels=4, height=h, width=w)
    fc = FrameConfig(orb=orb, lk_levels=3, cloud_stride=8, cloud_max_pts=1024,
                     bf=20.0)
    world = SyntheticWorld(cam)
    seq = SyntheticSequence(world, fps=10.0)

    # train a vocabulary on descriptors from the synthetic world
    desc = []
    for t in [0.0, 0.7, 1.4]:
        gray, _, _ = seq.frame(t)
        fs = extract(gray, orb)
        desc.append(np.asarray(fs.desc)[np.asarray(fs.valid)])
    voc = V.build_vocabulary(np.concatenate(desc), k=8, levels=2, iters=3)

    cfg = SystemConfig(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, bf=20.0,
                       frame=fc, k_max=32, m_max=4096,
                       kf_min_interval=1, kf_max_interval=2,
                       time_recently_lost=0.25, min_kfs_for_new_map=6,
                       loop=LoopConfig(min_sim3_inliers=15, min_score=0.02,
                                       run_global_ba=True))
    slam = SlamSystem(cfg, vocab=voc)

    # phase A: build a map with >= 10 KFs
    for i in range(22):
        t = i / seq.fps
        gray, depth, _ = seq.frame(t)
        slam.track_rgbd(gray, depth, t)
    assert slam.map_stats()["n_kfs"] >= 6, slam.map_stats()

    # phase B: blank frames -> lost -> new Atlas map
    blank = jnp.full((h, w), 100.0)
    bdepth = jnp.full((h, w), 2.0)
    for i in range(8):
        t = 2.2 + i / seq.fps
        slam.track_rgbd(blank, bdepth, t)
    # observe through map_stats(): it drains the async frame pipeline first
    # (reading slam.ms directly shows the pre-decision state)
    st_b = slam.map_stats()
    assert st_b["n_maps"] >= 2, st_b

    # phase C: revisit the starting view -> init map 2 -> merge via loop
    for i in range(12):
        t = 3.2 + i / seq.fps
        gray, depth, _ = seq.frame(i / seq.fps)  # same views as phase A
        slam.track_rgbd(gray, depth, t)

    st = slam.map_stats()
    assert st["state"] == "OK", st
    assert slam.loop_closer.n_loops + slam.loop_closer.n_merges >= 1, (
        st, slam.loop_closer.n_loops, slam.loop_closer.n_merges)
    # after a merge everything should live in one map id again
    active = int(slam.ms.active_map)
    kf_maps = np.asarray(slam.ms.kf_map_id)[np.asarray(slam.ms.kf_valid)]
    assert (kf_maps == active).mean() > 0.9, kf_maps
