#!/usr/bin/env python
"""TUM RGB-D dataset driver (rgbd_tum / rgbd_inertial equivalent).

Usage (same arguments as the reference binary,
/root/reference/Examples/RGB-D-Inertial/rgbd_inertial.cc:44-50):

    python examples/run_rgbd_tum.py <settings.yaml> <sequence_dir> \
        <association.txt> [--out out_dir] [--imu] [--odom] [--atlas save.npz]

Loads `imu/imu.txt` / `imu/odom.txt` from the sequence dir when --imu/--odom
are given; writes CameraTrajectory.txt, KeyFrameTrajectory.txt and the
timing stats to --out.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("settings")
    ap.add_argument("sequence")
    ap.add_argument("association")
    ap.add_argument("--out", default="results")
    ap.add_argument("--imu", action="store_true")
    ap.add_argument("--odom", action="store_true")
    ap.add_argument("--atlas", default=None, help="save atlas checkpoint")
    ap.add_argument("--load-atlas", default=None)
    ap.add_argument("--max-frames", type=int, default=0)
    args = ap.parse_args()

    from geoflowslam.io import datasets as D
    from geoflowslam.io.native_loader import FrameLoader
    from geoflowslam.io.yaml_compat import system_config_from_yaml
    from geoflowslam.pipeline.system import SlamSystem

    cfg, yaml_raw = system_config_from_yaml(args.settings, sensor="rgbd")
    frames = D.load_tum_associations(args.sequence, args.association)
    if args.max_frames:
        frames = frames[: args.max_frames]
    imu = None
    if args.imu:
        imu = D.load_imu_txt(os.path.join(args.sequence, "imu", "imu.txt"))
    odom = None
    if args.odom:
        odom = D.load_odom_txt(os.path.join(args.sequence, "imu", "odom.txt"))

    slam = SlamSystem(cfg)
    if args.load_atlas:
        slam.load_atlas(args.load_atlas)

    loader = FrameLoader([f.rgb_path for f in frames],
                         [f.depth_path for f in frames],
                         height=cfg.frame.orb.height,
                         width=cfg.frame.orb.width,
                         depth_scale=1.0)
    t0 = time.time()
    last_t = frames[0].time
    oi = 0
    for idx, gray, depth in loader:
        fr = frames[idx]
        if odom is not None:
            while oi + 1 < len(odom) and odom[oi + 1][0] <= fr.time:
                oi += 1
            slam.set_odom(odom[oi][1:4])
        if imu is not None and cfg.imu is not None and idx > 0:
            acc, gyro, dts = D.imu_between(imu, last_t, fr.time,
                                           cfg.imu.max_samples_per_frame)
            # build_frame applies cfg.frame.depth_map_factor internally
            slam.track_rgbd_inertial(gray, depth, acc, gyro, dts, fr.time)
        else:
            slam.track_rgbd(gray, depth, fr.time)
        last_t = fr.time
        if idx % 50 == 0:
            st = slam.map_stats()
            print(f"[{idx}/{len(frames)}] {st}", flush=True)

    wall = time.time() - t0
    st = slam.map_stats()
    print(f"done: {len(frames)} frames in {wall:.1f}s "
          f"({len(frames)/wall:.1f} FPS) {st}")
    os.makedirs(args.out, exist_ok=True)
    slam.shutdown(args.out)
    if args.atlas:
        slam.save_atlas(args.atlas)
    print(f"trajectories + stats written to {args.out}")


if __name__ == "__main__":
    main()
