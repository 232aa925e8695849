#!/usr/bin/env python
"""EuRoC MAV driver: monocular / mono-inertial / stereo / stereo-inertial.

    python examples/run_euroc.py <seq_dir> [--mode mono|mono_imu|stereo|stereo_imu]
        [--settings euroc.yaml] [--out results_euroc] [--max-frames N]

Equivalent of mono_inertial_euroc / stereo_inertial_euroc
(/root/reference/Examples/*-Inertial/*_euroc.cc). Default intrinsics are the
EuRoC cam0 values; pass --settings to override from a reference YAML.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("sequence")
    ap.add_argument("--mode", default="mono_imu",
                    choices=["mono", "mono_imu", "stereo", "stereo_imu"])
    ap.add_argument("--settings", default=None)
    ap.add_argument("--out", default="results_euroc")
    ap.add_argument("--max-frames", type=int, default=0)
    args = ap.parse_args()

    from geoflowslam.io import datasets as D
    from geoflowslam.io.native_loader import FrameLoader
    from geoflowslam.pipeline.system import SlamSystem, SystemConfig
    from geoflowslam.pipeline.inertial import ImuConfig
    from geoflowslam.state.frame import FrameConfig
    from geoflowslam.ops.extractor import OrbConfig

    frames, imu = D.load_euroc(args.sequence, "cam0")
    frames_r = None
    if "stereo" in args.mode:
        frames_r, _ = D.load_euroc(args.sequence, "cam1")
    if args.max_frames:
        frames = frames[: args.max_frames]

    if args.settings:
        from geoflowslam.io.yaml_compat import system_config_from_yaml
        cfg, _ = system_config_from_yaml(
            args.settings, sensor="mono" if "mono" in args.mode else "rgbd")
        if "imu" not in args.mode:
            import dataclasses as _dc
            cfg = _dc.replace(cfg, imu=None)
    else:
        # EuRoC cam0 defaults (458.654, 457.296, 367.215, 248.375; 752x480,
        # radtan distortion) — the reference ships these in its euroc yamls
        orb = OrbConfig(n_features=1000, n_levels=8, height=480, width=752)
        imu_cfg = ImuConfig(freq=200.0, noise_gyro=1.7e-4, noise_acc=2e-3,
                            walk_gyro=1.9e-5, walk_acc=3e-3) \
            if "imu" in args.mode else None
        fc = FrameConfig(orb=orb, bf=458.654 * 0.11,
                         dist_params=(-0.2834, 0.0739, 1.99e-4, 1.76e-5, 0.0))
        cfg = SystemConfig(fx=458.654, fy=457.296, cx=367.215, cy=248.375,
                           bf=458.654 * 0.11, frame=fc, imu=imu_cfg,
                           sensor="mono" if "mono" in args.mode else "rgbd")

    slam = SlamSystem(cfg)
    loader = FrameLoader([f.rgb_path for f in frames], None,
                         height=cfg.frame.orb.height,
                         width=cfg.frame.orb.width)
    loader_r = None
    if frames_r is not None:
        loader_r = iter(FrameLoader([f.rgb_path for f in frames_r], None,
                                    height=cfg.frame.orb.height,
                                    width=cfg.frame.orb.width))
    t0 = time.time()
    last_t = frames[0].time
    for idx, gray, _ in loader:
        fr = frames[idx]
        has_imu = "imu" in args.mode and idx > 0 and cfg.imu is not None
        if has_imu:
            acc, gyro, dts = D.imu_between(imu, last_t, fr.time,
                                           cfg.imu.max_samples_per_frame)
        if "stereo" in args.mode:
            _, gray_r, _ = next(loader_r)
            # dual-KB8 rigs (TUM-VI-style settings with Camera2.* blocks)
            # route through the stereo-fisheye matcher; rectified rigs use
            # the epipolar SAD path
            if cfg.stereo_fisheye is not None:
                if has_imu:
                    slam.track_stereo_fisheye_inertial(gray, gray_r, acc,
                                                       gyro, dts, fr.time)
                else:
                    slam.track_stereo_fisheye(gray, gray_r, fr.time)
            elif has_imu:
                slam.track_stereo_inertial(gray, gray_r, acc, gyro, dts, fr.time)
            else:
                slam.track_stereo(gray, gray_r, fr.time)
        else:
            if has_imu:
                slam.track_monocular_inertial(gray, acc, gyro, dts, fr.time)
            else:
                slam.track_monocular(gray, fr.time)
        last_t = fr.time
        if idx % 100 == 0:
            print(f"[{idx}/{len(frames)}] {slam.map_stats()}", flush=True)

    wall = time.time() - t0
    print(f"done: {len(frames)} frames in {wall:.1f}s "
          f"({len(frames)/wall:.1f} FPS) {slam.map_stats()}")
    os.makedirs(args.out, exist_ok=True)
    slam.shutdown(args.out)


if __name__ == "__main__":
    main()
