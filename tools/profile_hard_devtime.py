"""Drained per-frame DEVICE time of the hard-mode fused step.

The hard cells dispatch at ~4 ms/frame host-side but sustain <1 FPS: the
wall hides in the device queue and surfaces at sync points (New_KF ~30 s).
This probe separates the two: it drives the EXACT hard-mode config
(rgbd_inertial + OF + ICP @ 640x480/1000feat by default) over the cached
hard frames, BLOCKING on each frame's outputs, so the printed per-frame
time is true device-chain latency (frame_step + any KF megastep that frame
triggered).

    python tools/profile_hard_devtime.py [--frames 60] [--no-of] [--no-icp]
        [--no-imu]
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
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--warm", type=int, default=8,
                    help="frames before timing starts")
    ap.add_argument("--no-of", action="store_true")
    ap.add_argument("--no-icp", action="store_true")
    ap.add_argument("--no-imu", action="store_true")
    args = ap.parse_args()

    import jax
    from geoflowslam.utils.compile_log import (enable_persistent_cache,
                                               install)
    enable_persistent_cache()
    clog = install(explain_misses=True)
    print(f"device: {jax.devices()[0]}", file=sys.stderr)

    from geoflowslam.io.synthetic import (SyntheticWorld,
                                          HardSyntheticSequence, Camera)
    from geoflowslam.pipeline.system import SlamSystem, SystemConfig
    from geoflowslam.pipeline.inertial import ImuConfig
    from geoflowslam.state.frame import FrameConfig
    from geoflowslam.ops.extractor import OrbConfig
    from geoflowslam.retrieval.vocab import default_vocabulary

    w, h, fps = 640, 480, 30.0
    import glob
    cands = sorted(glob.glob(
        os.path.join(ROOT, ".cache", "hard_frames",
                     f"m12_*_{fps:g}_{w}x{h}.npy")),
        key=lambda p: -os.path.getsize(p))
    if not cands:
        print("no m12 render cache; run examples/run_hardmode.py first",
              file=sys.stderr)
        sys.exit(1)
    cache = cands[0]
    print(f"frames from {cache}", file=sys.stderr)
    stack = np.load(cache, mmap_mode="r")
    n = min(args.frames + args.warm, stack.shape[0])

    cam = Camera(fx=400.0, fy=400.0, cx=w / 2, cy=h / 2, width=w, height=h)
    world = SyntheticWorld(cam)
    seq = HardSyntheticSequence(world, fps=fps)
    orb = OrbConfig(n_features=1000, n_levels=8, height=h, width=w)
    fc = FrameConfig(orb=orb, lk_levels=4, cloud_stride=4, cloud_max_pts=4096,
                     bf=40.0, n_of_slots=0 if args.no_of else 256,
                     feed_codec="m12")
    imu_cfg = None if args.no_imu else ImuConfig()
    cfg = SystemConfig(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, bf=40.0,
                       frame=fc, imu=imu_cfg,
                       use_of=not args.no_of, use_icp=not args.no_icp)
    slam = SlamSystem(cfg, vocab=default_vocabulary())

    # IMU sample streams identical to run_hardmode's
    import jax.numpy as jnp
    from geoflowslam.io.synthetic import hard_trajectory, GRAVITY
    s_max = 32
    ts_all = np.arange(n) / fps
    dt_imu = 1.0 / seq.imu_rate
    tgrid = (ts_all[:, None] - 1.0 / fps
             + (np.arange(s_max)[None, :] + 0.5) * dt_imu)
    rot_wb, _, _, a_w, w_b = [np.asarray(x) for x in jax.jit(
        hard_trajectory)(jnp.asarray(tgrid), seq.period)]
    acc_a = np.einsum("nsij,nsj->nsi", np.swapaxes(rot_wb, -1, -2),
                      a_w - GRAVITY).astype(np.float32)
    gyro_a = w_b.astype(np.float32)
    n_per = int(round(seq.imu_rate / fps))
    dts_1 = np.where(np.arange(s_max) < n_per, dt_imu, 0.0).astype(np.float32)

    times = []
    kf_flags = []
    for i in range(n):
        t = ts_all[i]
        buf = np.asarray(stack[i])
        ref0 = slam.ref_kf
        t0 = time.perf_counter()
        if args.no_imu or i == 0:
            slam.track_rgbd(buf, None, t)
        else:
            slam.track_rgbd_inertial(buf, None, acc_a[i], gyro_a[i],
                                     dts_1, t)
        # block on THIS frame's device chain: pose + map + window are the
        # outputs every later frame depends on
        jax.block_until_ready((slam.cur_rot, slam.cur_t, slam.ms.mp_pos))
        dt = (time.perf_counter() - t0) * 1000
        if i >= args.warm:
            times.append(dt)
            kf_flags.append(slam.ref_kf != ref0)
        if i % 10 == 0:
            tn = float(np.linalg.norm(np.asarray(slam.cur_t)))
            vn = float(np.linalg.norm(np.asarray(slam.vel[1])))
            print(f"  frame {i}: {dt:8.1f} ms  state={slam.state.name} "
                  f"carried={slam._carried_streak} n_lost={slam.n_lost} "
                  f"|t_cw|={tn:.2f} |vel|={vn:.3f}",
                  file=sys.stderr)
    tt = np.asarray(times)
    kf = np.asarray(kf_flags)
    comp = clog.since(0.0)
    print(f"\nconfig: of={not args.no_of} icp={not args.no_icp} "
          f"imu={not args.no_imu}")
    print(f"drained per-frame ms over {len(tt)} frames: "
          f"median {np.median(tt):.1f}, mean {tt.mean():.1f}, "
          f"p90 {np.percentile(tt, 90):.1f}, max {tt.max():.1f}")
    if kf.any():
        print(f"  KF frames ({int(kf.sum())}): mean {tt[kf].mean():.1f} ms; "
              f"non-KF: median {np.median(tt[~kf]):.1f} ms")
    print(f"  compiles during run: {comp['n']} ({comp['sec']:.0f}s)")
    for _, sec, msg in sorted(clog.events, key=lambda e: -e[1])[:12]:
        if sec >= 2.0:
            print(f"    compile {sec:6.1f}s: {msg[:110]}")
    big = [m for m in clog.cache_notes
           if "hit" not in m.split(":")[0].lower()]
    print(f"  persistent-cache notes: {len(clog.cache_notes)} "
          f"({len(big)} non-hit); first non-hit lines:")
    for m in big[:8]:
        print("   ", m[:300])


if __name__ == "__main__":
    main()
