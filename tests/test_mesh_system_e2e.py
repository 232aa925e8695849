"""SlamSystem(mesh=...) end-to-end: loop correction + DISTRIBUTED async GBA
through the full system on the 8-device virtual CPU mesh (VERDICT round-4
#10 — closes the gap between "the multichip dryrun compiles" and "the
system uses it").

Scenario = tests/test_e2e_loop.py's break-and-merge: build a map, lose it
on blank frames, revisit, merge via place recognition. The merge kicks the
background GBA (RunGlobalBundleAdjustment's role, LoopClosing.cc:2360);
with a mesh the micro-steps run the landmark-sharded SPMD iteration
(parallel/dist_ba.py) — asserted actually stepped, and the trajectory must
match the single-device run of the same sequence.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from geoflowslam.io.synthetic import SyntheticWorld, SyntheticSequence, Camera
from geoflowslam.pipeline.system import SlamSystem, SystemConfig
from geoflowslam.pipeline.loop_closing import LoopConfig
from geoflowslam.state.frame import FrameConfig
from geoflowslam.ops.extractor import OrbConfig, extract
from geoflowslam.retrieval import vocab as V


def _run(mesh, voc, seq, cam):
    w, h = cam.width, cam.height
    orb = OrbConfig(n_features=300, n_levels=4, height=h, width=w)
    fc = FrameConfig(orb=orb, lk_levels=3, cloud_stride=8, cloud_max_pts=1024,
                     bf=20.0)
    cfg = SystemConfig(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, bf=20.0,
                       frame=fc, k_max=32, m_max=4096,
                       kf_min_interval=1, kf_max_interval=2,
                       time_recently_lost=0.25, min_kfs_for_new_map=6,
                       loop=LoopConfig(min_sim3_inliers=15, min_score=0.02,
                                       run_global_ba=True,
                                       async_global_ba=True))
    slam = SlamSystem(cfg, vocab=voc, mesh=mesh)
    blank = jnp.full((h, w), 100.0)
    bdepth = jnp.full((h, w), 2.0)
    for i in range(22):                       # phase A: build a map
        t = i / seq.fps
        gray, depth, _ = seq.frame(t)
        slam.track_rgbd(gray, depth, t)
    for i in range(8):                        # phase B: lost -> new map
        slam.track_rgbd(blank, bdepth, 2.2 + i / seq.fps)
    for i in range(16):                       # phase C: revisit -> merge
        t = 3.2 + i / seq.fps
        gray, depth, _ = seq.frame(i / seq.fps)
        slam.track_rgbd(gray, depth, t)
    st = slam.map_stats()
    traj = {round(ts, 4): np.asarray(m)[:3, 3] for ts, m in slam.trajectory}
    return slam, st, traj


@pytest.mark.slow
def test_mesh_loop_gba_matches_single_device():
    w, h = 320, 240
    cam = Camera(fx=200.0, fy=200.0, cx=w / 2, cy=h / 2, width=w, height=h)
    world = SyntheticWorld(cam)
    seq = SyntheticSequence(world, fps=10.0)
    orb = OrbConfig(n_features=300, n_levels=4, height=h, width=w)
    desc = []
    for t in [0.0, 0.7, 1.4]:
        gray, _, _ = seq.frame(t)
        fs = extract(gray, orb)
        desc.append(np.asarray(fs.desc)[np.asarray(fs.valid)])
    voc = V.build_vocabulary(np.concatenate(desc), k=8, levels=2, iters=3)

    devs = jax.devices()
    assert len(devs) >= 8, "conftest pins an 8-device virtual CPU platform"
    mesh = jax.sharding.Mesh(np.array(devs[:8]), ("land",))

    slam_m, st_m, traj_m = _run(mesh, voc, seq, cam)
    slam_s, st_s, traj_s = _run(None, voc, seq, cam)

    # both runs recover and close the loop/merge
    for st, slam in ((st_m, slam_m), (st_s, slam_s)):
        assert st["state"] == "OK", st
        assert slam.loop_closer.n_loops + slam.loop_closer.n_merges >= 1, st
    # the mesh run's background GBA really ran SPMD micro-steps
    assert slam_m._gba is not None and slam_m._gba.mesh is mesh
    assert slam_m._gba.i >= 1, "distributed GBA never stepped"
    # trajectories agree: same sequence, same decisions; the only numeric
    # difference is psum-reduction order inside the distributed GN
    common = sorted(set(traj_m) & set(traj_s))
    assert len(common) >= 30
    d = np.array([traj_m[t] - traj_s[t] for t in common])
    rms = float(np.sqrt((d ** 2).sum(1).mean()))
    assert rms < 0.02, f"mesh vs single-device trajectory diverged: {rms}"
