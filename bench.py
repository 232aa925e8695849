"""Benchmark: steady-state RGB-D-inertial SLAM on one GPU, at scale.

Prints ONE JSON line: {"metric", "value", "unit", "device", "detail"}.

The operating point is the full steady-state loop of
`SlamSystem.track_rgbd_inertial` at 640x480 with 1000 ORB features: IMU
preintegration, frame build (CLAHE + pyramid + FAST + rBRIEF + depth
cloud), motion-model + local-map tracking, VI pose refinement, KF insertion
at the reference's forced 0.5 s inertial cadence, and the amortized per-KF
mapping work (VI local BA, fusion, culling), at the PRODUCTION capacities
(SystemConfig defaults k_max=256, m_max=65536) on a MATURE map with loop
closing ON.

Shape of the run:
  0. pre-render: frames + IMU rendered batched on the device and cached
     on disk inside the checkout (.cache/, deterministic). Excluded from
     the run budget.
  1. maturation: track `n_mature` frames (default 1800 = 60 s) to build a
     map with ~100 live KFs / thousands of points. Maturation doubles as
     the WARMUP pass: it traverses every steady-state program variant
     (imu_mode raw->kf->prior, VIBA1/VIBA2 wide windows, KF insert
     mapping megasteps, loop detection) so the timed window below is
     compile-free. Optionally restored from a mature-session checkpoint
     (GEOFLOW_BENCH_SESSION=1): SlamSystem.save_session/load_session
     CONTINUES a session — a capability the reference's LoadAtlas lacks
     (it starts a new active map, System.cc:2102).
  2. warmup tail: the last `n_warm` maturation frames always run live
     (even after a session restore) so every timed-window program is
     traced + compiled/cache-loaded BEFORE the clock.
  3. timed: the next `n_timed` frames (default 500 = 16.7 s, ~30 KF
     events at the 0.5 s cadence) measured wall-clock, median/p90/
     sustained-FPS; the clock stops after block_until_ready on the last
     pose, so the device queue has drained.

Compile accounting: jax_log_compiles events are itemized per phase
(render / maturation / timed) in the JSON detail; a healthy timed window
has none. Compiles persist in utils/compile_log.cache_dir().
Wall-clock per frame includes host orchestration, exactly what the
reference's ExecTimeMean "Total Tracking" measures (src/Tracking.cc:219-600).

Refuses to run unless JAX's first device is a GPU, and exits non-zero when
any phase fails.
"""
import json
import os
import sys
import time

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from geoflowslam.utils.compile_log import (install,
                                               enable_persistent_cache)
    from geoflowslam.utils.device import card_info, describe, require_gpu
    devices = jax.devices()
    require_gpu(devices)
    dev = devices[0]
    print(f"bench device: {describe(devices)}", file=sys.stderr)
    enable_persistent_cache()
    clog = install()

    from geoflowslam.io.synthetic import (
        Camera, SyntheticWorld, imu_samples, render_sequence,
        smooth_trajectory, trajectory_poses)
    from geoflowslam.state.frame import FrameConfig
    from geoflowslam.ops.extractor import OrbConfig
    from geoflowslam.pipeline.system import SlamSystem, SystemConfig
    from geoflowslam.pipeline.inertial import ImuConfig
    from geoflowslam.pipeline.loop_closing import LoopConfig
    from geoflowslam.retrieval.vocab import default_vocabulary
    from geoflowslam.pipeline import tracking as T

    cam = Camera()  # 640x480, fx 400
    fps_in = 30.0
    imu_rate = 200.0
    s_max = 32
    n_mature = int(os.environ.get("GEOFLOW_BENCH_MATURE", 1800))
    n_timed = int(os.environ.get("GEOFLOW_BENCH_TIMED", 500))
    n_warm = int(os.environ.get("GEOFLOW_BENCH_WARM", 300))
    budget = float(os.environ.get("GEOFLOW_BENCH_BUDGET", 900.0))
    use_session = os.environ.get("GEOFLOW_BENCH_SESSION", "1") != "0"
    n_total = n_mature + n_timed

    orb = OrbConfig(n_features=1000, n_levels=8, height=cam.height,
                    width=cam.width)
    # sensor-native ingestion, packed for the wire (io/feed_codec "m12":
    # gray u8 + 12-bit depth in one buffer, 0.75 MB/frame vs 2.4 MB for
    # float32), the format of GigE camera feeds
    fc = FrameConfig(orb=orb, lk_levels=4, cloud_stride=4, cloud_max_pts=4096,
                     depth_map_factor=1.0, feed_codec="m12")
    # early IMU init so the warmup transient stays short
    imu = ImuConfig(init_min_kfs=4, init_min_time=0.8)
    # PRODUCTION capacities (SystemConfig defaults): k_max=256, m_max=65536.
    # Loop closing is ON (the reference's LoopClosing thread always runs,
    # src/LoopClosing.cc:105): the per-KF retrieval/consistency dispatch is
    # inside the measured operating point.
    cfg = SystemConfig(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, bf=40.0,
                       frame=fc, imu=imu, loop=LoopConfig())
    assert cfg.k_max == 256 and cfg.m_max == 65536  # bench == shipped system

    # ---- pre-render + pack the sequence once, cache on disk ---------------
    # OUT OF BUDGET (deterministic input preparation, not SLAM), rendered
    # batched on the device
    cache_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             ".cache")
    os.makedirs(cache_dir, exist_ok=True)
    cache = os.path.join(cache_dir, f"bench_m12_{n_total}_{cam.width}"
                                    f"_{fps_in:g}.npz")
    t0 = time.time()
    if os.path.exists(cache):
        z = np.load(cache)
        bufs, acc_a, gyro_a, dts_1 = (z["bufs"], z["acc"], z["gyro"],
                                      z["dts1"])
        print(f"loaded {n_total} cached packed frames: {time.time()-t0:.1f}s",
              file=sys.stderr)
    else:
        ts_all = np.arange(n_total) / fps_in
        _, _, rot_cw_a, t_cw_a = trajectory_poses(smooth_trajectory, ts_all)
        acc_a, gyro_a, dts_1 = imu_samples(smooth_trajectory, ts_all, fps_in,
                                           imu_rate=imu_rate, s_max=s_max)
        bufs = render_sequence(SyntheticWorld(cam), rot_cw_a, t_cw_a)
        np.savez(cache + ".tmp.npz", bufs=bufs, acc=acc_a, gyro=gyro_a,
                 dts1=dts_1)
        os.replace(cache + ".tmp.npz", cache)
        print(f"pre-render+pack {n_total} frames: {time.time()-t0:.1f}s "
              f"(cached)", file=sys.stderr)

    # ---- budget starts HERE: the run is maturation + warmup + timed -------
    t_start = time.time()
    session_ckpt = os.path.join(cache_dir, f"bench_session_{n_total}"
                                           f"_{cam.width}.npz")
    n_ckpt = max(n_mature - n_warm, 1)     # checkpoint/restore point

    slam = SlamSystem(cfg, vocab=default_vocabulary())
    t0 = time.time()
    i_begin = 0
    if use_session and os.path.exists(session_ckpt):
        try:
            slam.load_session(session_ckpt)
            i_begin = n_ckpt
            print(f"restored mature session at frame {n_ckpt}: "
                  f"{time.time()-t0:.1f}s, map {slam.map_stats()}",
                  file=sys.stderr)
        except Exception as e:
            print(f"session restore failed ({e}); maturing from scratch",
                  file=sys.stderr)
            slam = SlamSystem(cfg, vocab=default_vocabulary())
            i_begin = 0

    # ---- maturation + warmup: build the production-scale map --------------
    i_stop = n_mature
    for i in range(i_begin, n_mature):
        t = i / fps_in
        if i == 0:
            slam.track_rgbd(bufs[i], None, t)
        else:
            slam.track_rgbd_inertial(bufs[i], None, acc_a[i], gyro_a[i],
                                     dts_1, t)
        if i == n_ckpt and use_session and i_begin < n_ckpt:
            try:
                slam.save_session(session_ckpt)
                print(f"  session checkpoint saved at frame {i}",
                      file=sys.stderr)
            except Exception as e:
                print(f"  session checkpoint skipped: {e}", file=sys.stderr)
        if i % 300 == 0:
            print(f"  mature {i}: {time.time()-t0:.0f}s {slam.map_stats()}",
                  file=sys.stderr)
        if time.time() - t_start > 0.85 * budget:
            print(f"  WARNING maturation over budget at frame {i}; the "
                  "timed map is NOT mature", file=sys.stderr)
            i_stop = i + 1
            break
    st_mature = slam.map_stats()
    print(f"maturation+warmup to frame {i_stop}: {time.time()-t0:.1f}s, map "
          f"{st_mature}, imu_init={slam.imu.initialized}", file=sys.stderr)
    t_warmed = time.time()

    # ---- timed steady-state loop over the mature map ----------------------
    from geoflowslam.utils.timers import StageTimers
    slam.timers = StageTimers()        # stage stats for the timed section
    per_frame = []
    kf_before = slam.ref_kf
    kf_events = 0
    t0 = time.time()
    for j in range(n_timed):
        i = i_stop + j
        if i >= n_total:
            break
        t = i / fps_in
        tf = time.time()
        slam.track_rgbd_inertial(bufs[i], None, acc_a[i], gyro_a[i],
                                 dts_1, t)
        per_frame.append(time.time() - tf)
        if slam.ref_kf != kf_before:
            kf_before = slam.ref_kf
            kf_events += 1
    # SUSTAINED throughput: drain the device queue before stopping the
    # clock — dispatch is async, so without this the loop only measures
    # host dispatch rate while the device queue absorbs the burst
    jax.block_until_ready(slam.cur_t)
    dt = time.time() - t0
    n_run = len(per_frame)
    pf = np.asarray(per_frame) * 1000
    print(f"per-frame ms: median {np.median(pf):.1f}, p90 "
          f"{np.percentile(pf, 90):.1f}, max {pf.max():.1f}", file=sys.stderr)
    fps = n_run / dt if dt > 0 else 0.0   # sustained, incl. queue drain
    st = slam.map_stats()
    # compile accounting: events per phase (setup+render / maturation /
    # timed window). A healthy run has ZERO timed-window compiles.
    c_render, c_mature, c_timed = clog.split(0.0, t_start, t_warmed)
    print(f"compiles: render/setup {c_render}, maturation {c_mature}, "
          f"TIMED {c_timed}", file=sys.stderr)
    print(f"steady-state: {n_run} frames in {dt:.3f}s -> {fps:.1f} FPS "
          f"({1000*dt/max(n_run,1):.2f} ms/frame), {kf_events} KF events, "
          f"map {st}", file=sys.stderr)
    for line in slam.timers.summary_lines():
        print("  " + line, file=sys.stderr)

    # ---- secondary: fused visual hot path ---------------------------------
    tcfg = cfg.track_cfg()
    ms = slam.ms
    masks = slam._local_window_fn(ms, jnp.int32(slam.ref_kf))
    args = (jnp.asarray(bufs[i_stop]), jnp.zeros((1, 1), jnp.float32),
            ms, slam.last_obs_mp, slam.cur_rot, slam.cur_t,
            jnp.int32(slam.ref_kf))
    _, r, _ = T.fused_track_step(*args, tcfg, cfg.frame, local_masks=masks)
    jax.block_until_ready(r.t)
    t0 = time.time()
    n_hot = 50
    for _ in range(n_hot):
        _, r, _ = T.fused_track_step(*args, tcfg, cfg.frame,
                                     local_masks=masks)
    jax.block_until_ready(r.t)
    hot = n_hot / (time.time() - t0)
    print(f"hot-path (fused visual track): {hot:.1f} FPS "
          f"({1000/hot:.2f} ms/frame)", file=sys.stderr)

    print(json.dumps({
        "metric": "rgbd_inertial_slam_fps_640x480_1000feat_mature_map",
        "value": round(fps, 2),
        "unit": "frames/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(devices), "card": card_info()},
        "detail": {
            "timed_frames": n_run, "kf_events": kf_events,
            "median_ms": round(float(np.median(pf)), 2) if n_run else 0.0,
            "p90_ms": round(float(np.percentile(pf, 90)), 2) if n_run else 0.0,
            "k_max": cfg.k_max, "m_max": cfg.m_max,
            "map_at_timing_start": st_mature,
            "map": st,
            "maturation_frames": i_stop,
            "compiles": {"render_setup": c_render, "maturation": c_mature,
                         "timed": c_timed},
            "hot_path_fps": round(hot, 2),
        },
    }))


if __name__ == "__main__":
    main()
