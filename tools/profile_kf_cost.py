"""Measure TRUE per-frame device+host cost in the production bench config.

Runs the real SlamSystem over the cached bench frame buffers, draining the
device queue after EVERY frame (block_until_ready on the pose), so each
frame's wall time is its genuine cost
instead of being absorbed by the async queue. KF-event frames therefore show
the full mapping megastep + loop-closing cost; `--log-compiles` surfaces any
mid-run recompilation (the round-3 bench showed 6 compile-wall frames inside
the timed window).

Usage: python tools/profile_kf_cost.py [--frames 150] [--log-compiles]
"""
import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=150)
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--log-compiles", action="store_true")
    ap.add_argument("--k", type=int, default=256)
    ap.add_argument("--m", type=int, default=65536)
    args = ap.parse_args()

    import jax
    from geoflowslam.utils.compile_log import enable_persistent_cache
    enable_persistent_cache()
    if args.log_compiles:
        jax.config.update("jax_log_compiles", True)
    import jax.numpy as jnp  # noqa: F401

    from geoflowslam.io.synthetic import Camera
    from geoflowslam.state.frame import FrameConfig
    from geoflowslam.ops.extractor import OrbConfig
    from geoflowslam.pipeline.system import SlamSystem, SystemConfig
    from geoflowslam.pipeline.inertial import ImuConfig
    from geoflowslam.pipeline.loop_closing import LoopConfig
    from geoflowslam.retrieval.vocab import default_vocabulary

    cam = Camera()
    fps_in = 30.0
    cache = os.path.join(ROOT, ".cache", "bench_m12_2300_640_30.npz")
    if not os.path.exists(cache):
        print(f"no frame cache at {cache}; run bench.py once first",
              file=sys.stderr)
        return
    z = np.load(cache, mmap_mode="r")
    bufs, acc_a, gyro_a, dts_1 = (np.asarray(z["bufs"]), np.asarray(z["acc"]),
                                  np.asarray(z["gyro"]), np.asarray(z["dts1"]))

    orb = OrbConfig(n_features=1000, n_levels=8, height=cam.height,
                    width=cam.width)
    fc = FrameConfig(orb=orb, lk_levels=4, cloud_stride=4, cloud_max_pts=4096,
                     depth_map_factor=1.0, feed_codec="m12")
    imu = ImuConfig(init_min_kfs=4, init_min_time=0.8)
    cfg = SystemConfig(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, bf=40.0,
                       frame=fc, imu=imu, loop=LoopConfig(),
                       k_max=args.k, m_max=args.m)
    slam = SlamSystem(cfg, vocab=default_vocabulary())

    kf_before = None
    rows = []
    t_run = time.time()
    for j in range(args.frames):
        i = args.start + j
        t = i / fps_in
        tf = time.perf_counter()
        if i == 0:
            slam.track_rgbd(bufs[i], None, t)
        else:
            slam.track_rgbd_inertial(bufs[i], None, acc_a[i], gyro_a[i],
                                     dts_1, t)
        jax.block_until_ready(slam.cur_t)   # full drain every frame
        dt_ms = (time.perf_counter() - tf) * 1000
        is_kf = slam.ref_kf != kf_before
        kf_before = slam.ref_kf
        rows.append((i, dt_ms, is_kf, slam.map_stats()["n_kfs"]))
        if is_kf or dt_ms > 200:
            print(f"frame {i:4d}: {dt_ms:8.1f} ms  kf={is_kf} "
                  f"n_kfs={rows[-1][3]}", file=sys.stderr)
    arr = np.asarray([r[1] for r in rows])
    kf_rows = np.asarray([r[1] for r in rows if r[2]])
    plain = np.asarray([r[1] for r in rows if not r[2]])
    print(f"\ntotal {time.time()-t_run:.1f}s for {len(rows)} frames")
    print(f"plain frames: median {np.median(plain):.1f} ms, "
          f"p90 {np.percentile(plain, 90):.1f}, max {plain.max():.1f}")
    if len(kf_rows):
        print(f"KF frames (n={len(kf_rows)}): "
              + " ".join(f"{v:.0f}" for v in kf_rows))
    if hasattr(slam, "timers") and slam.timers is not None:
        for line in slam.timers.summary_lines():
            print("  " + line)


if __name__ == "__main__":
    main()
