import os
import numpy as np
import jax.numpy as jnp
import pytest

from geoflowslam.state import map_state as M
from geoflowslam.state import serialize as S
from geoflowslam.utils.timers import StageTimers


def test_atlas_roundtrip(tmp_path):
    ms = M.create(8, 64, 256)
    ms = M.insert_keyframe(
        ms, jnp.int32(2), jnp.eye(3), jnp.ones(3), jnp.zeros(3), jnp.zeros(6),
        jnp.float32(1.5), jnp.ones((64, 2)), jnp.zeros(64, jnp.int32),
        jnp.zeros(64), jnp.ones((64, 8), jnp.uint32), jnp.full((64,), 2.0),
        jnp.ones(64, bool), jnp.arange(64, dtype=jnp.int32), jnp.int32(-1))
    p = str(tmp_path / "atlas")
    S.save_atlas(p, ms, extra={"seq": "test"})
    ms2, extra = S.load_atlas(p + ".npz")
    assert extra["seq"] == "test"
    np.testing.assert_array_equal(np.asarray(ms2.kf_valid), np.asarray(ms.kf_valid))
    np.testing.assert_allclose(np.asarray(ms2.kf_t[2]), 1.0)
    np.testing.assert_array_equal(np.asarray(ms2.kf_obs_mp), np.asarray(ms.kf_obs_mp))


def test_vocab_checksum_gate(tmp_path):
    from geoflowslam.retrieval import vocab as V
    import jax

    train = np.asarray(jax.random.randint(jax.random.PRNGKey(0), (500, 8),
                                          0, 2**31 - 1, jnp.int32), np.uint32)
    v1 = V.build_vocabulary(train, k=4, levels=2, iters=2, seed=0)
    v2 = V.build_vocabulary(train, k=4, levels=2, iters=2, seed=1)
    ms = M.create(4, 16, 64)
    p = str(tmp_path / "a")
    S.save_atlas(p, ms, vocab=v1)
    S.load_atlas(p + ".npz", vocab=v1)  # same vocab: ok
    with pytest.raises(ValueError):
        S.load_atlas(p + ".npz", vocab=v2)


@pytest.mark.slow
def test_session_continue_roundtrip(tmp_path):
    """save_session/load_session CONTINUES tracking mid-stream: a restored
    session must track the same upcoming frames as the uninterrupted one
    (the reference's LoadAtlas cannot do this — System.cc:2102 starts a new
    active map and must relocalize)."""
    from geoflowslam.io.synthetic import (SyntheticWorld,
                                          SyntheticSequence, Camera)
    from geoflowslam.pipeline.system import SlamSystem, SystemConfig
    from geoflowslam.pipeline.inertial import ImuConfig
    from geoflowslam.pipeline.loop_closing import LoopConfig
    from geoflowslam.state.frame import FrameConfig
    from geoflowslam.ops.extractor import OrbConfig
    from geoflowslam.retrieval.vocab import default_vocabulary

    w, h = 320, 240
    cam = Camera(fx=200.0, fy=200.0, cx=w / 2, cy=h / 2, width=w, height=h)
    orb = OrbConfig(n_features=400, n_levels=4, height=h, width=w)
    fc = FrameConfig(orb=orb, lk_levels=3, cloud_stride=8,
                     cloud_max_pts=1024, bf=20.0)
    imu = ImuConfig(init_min_kfs=4, init_min_time=0.5)
    vocab = default_vocabulary()
    cfg = SystemConfig(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, bf=20.0,
                       frame=fc, k_max=24, m_max=4096, imu=imu,
                       loop=LoopConfig())
    world = SyntheticWorld(cam)
    seq = SyntheticSequence(world, fps=10.0)

    def drive(slam, i0, i1, last_t):
        for i in range(i0, i1):
            t = i / seq.fps
            gray, depth, _ = seq.frame(t)
            if i == 0:
                slam.track_rgbd(gray, depth, t)
            else:
                acc, gyro, dts = seq.imu_between(
                    last_t, t, cfg.imu.max_samples_per_frame)
                slam.track_rgbd_inertial(gray, depth, acc, gyro, dts, t)
            last_t = t
        return last_t

    slam = SlamSystem(cfg, vocab=vocab)
    last_t = drive(slam, 0, 35, 0.0)
    assert slam.imu.initialized
    p = str(tmp_path / "session")
    slam.save_session(p)
    st_saved = slam.map_stats()

    # continue the original
    drive(slam, 35, 55, last_t)
    pose_a = slam.current_pose_wc()
    st_a = slam.map_stats()

    # restore into a FRESH system and continue over the same frames
    slam2 = SlamSystem(cfg, vocab=vocab)
    slam2.load_session(p)
    st2 = slam2.map_stats()
    assert st2["n_kfs"] == st_saved["n_kfs"]
    assert st2["n_mps"] == st_saved["n_mps"]
    assert st2["state"] == st_saved["state"] == "OK"
    assert slam2.imu.initialized
    drive(slam2, 35, 55, last_t)
    pose_b = slam2.current_pose_wc()
    st_b = slam2.map_stats()
    assert st_b["state"] == "OK", st_b
    # both continuations track the same world: poses agree to centimeters
    np.testing.assert_allclose(pose_b[:3, 3], pose_a[:3, 3], atol=0.05)
    assert abs(st_b["n_kfs"] - st_a["n_kfs"]) <= 2, (st_a, st_b)


def test_timers_outputs(tmp_path):
    t = StageTimers()
    for i in range(5):
        t.add("Track_total", 10.0 + i)
        t.add("LBA", 5.0)
    t.write_all(str(tmp_path), {"sensor": "rgbd"})
    for fn in ["ExecTimeMean.txt", "LocalMapTimeStats.txt", "LBA_Stats.txt",
               "SessionInfo.txt", "TrackTimeCost.txt"]:
        assert os.path.exists(tmp_path / fn), fn
    content = open(tmp_path / "ExecTimeMean.txt").read()
    assert "Track_total 12.0000" in content
