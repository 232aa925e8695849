#!/usr/bin/env python
"""Synthetic-room driver: end-to-end demo + ATE report with zero data deps.

    python examples/run_synthetic.py [--mode rgbd|mono|rgbd_inertial|stereo]
        [--frames 100] [--fps 30] [--out results_synth]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="rgbd",
                    choices=["rgbd", "mono", "rgbd_inertial", "stereo"])
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--fps", type=float, default=30.0)
    ap.add_argument("--out", default="results_synth")
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--t0", type=float, default=0.0,
                    help="timestamp of the first frame (e.g. 1.4e9 to "
                         "exercise epoch-scale stamps like TUM/EuRoC)")
    args = ap.parse_args()

    import jax.numpy as jnp
    from geoflowslam.utils.compile_log import enable_persistent_cache
    enable_persistent_cache()
    from geoflowslam.io.synthetic import (SyntheticWorld,
                                          SyntheticSequence, Camera)
    from geoflowslam.pipeline.system import SlamSystem, SystemConfig
    from geoflowslam.pipeline.inertial import ImuConfig
    from geoflowslam.state.frame import FrameConfig
    from geoflowslam.ops.extractor import OrbConfig
    from geoflowslam.eval.ate import ate_rmse, rpe

    w, h = args.width, args.height
    cam = Camera(fx=w * 0.625, fy=w * 0.625, cx=w / 2, cy=h / 2,
                 width=w, height=h)
    orb = OrbConfig(n_features=1000 if w >= 640 else 400,
                    n_levels=8 if w >= 640 else 4, height=h, width=w)
    fc = FrameConfig(orb=orb, bf=cam.fx * 0.1)
    imu = ImuConfig() if args.mode == "rgbd_inertial" else None
    cfg = SystemConfig(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
                       bf=cam.fx * 0.1, frame=fc, imu=imu,
                       sensor="mono" if args.mode == "mono" else "rgbd")
    world = SyntheticWorld(cam)
    seq = SyntheticSequence(world, fps=args.fps)
    slam = SlamSystem(cfg)

    gt, last_t = [], 0.0
    t0 = time.time()
    for i in range(args.frames):
        t = args.t0 + i / args.fps
        gray, depth, (rot_cw, t_cw) = seq.frame(t - args.t0)
        if args.mode == "mono":
            slam.track_monocular(gray, t)
        elif args.mode == "rgbd_inertial" and i > 0:
            acc, gyro, dts = seq.imu_between(last_t - args.t0, t - args.t0, 32)
            slam.track_rgbd_inertial(gray, depth, acc, gyro, dts, t)
        elif args.mode == "stereo":
            t_rw = t_cw + jnp.array([-0.1 * cam.fx / cam.fx, 0.0, 0.0])
            gr, _ = seq._render(rot_cw, t_rw)
            slam.track_stereo(gray, gr, t)
        else:
            slam.track_rgbd(gray, depth, t)
        last_t = t
        twc = np.eye(4)
        rwc = np.asarray(rot_cw).T
        twc[:3, :3] = rwc
        twc[:3, 3] = -rwc @ np.asarray(t_cw)
        gt.append((t, twc))

    wall = time.time() - t0
    st = slam.map_stats()
    m = ate_rmse(slam.trajectory, gt, with_scale=(args.mode == "mono"))
    r = rpe(slam.trajectory, gt)
    print(f"{args.frames} frames in {wall:.1f}s ({args.frames/wall:.1f} FPS)")
    print(f"map: {st}")
    print(f"ATE rmse {m['ate_rmse']*100:.2f} cm | RPE {r['rpe_trans']*100:.2f} cm"
          f" / {r['rpe_rot_deg']:.3f} deg")
    os.makedirs(args.out, exist_ok=True)
    slam.shutdown(args.out)


if __name__ == "__main__":
    main()
