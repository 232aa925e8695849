#!/usr/bin/env python
"""Calibration dataset recorder (EuRoC directory layout).

Role of the reference's Examples/Calibration/recorder_realsense_*.cc: grab
a camera+IMU stream and write the EuRoC-style tree that calibration tools
(Kalibr, the repo's process_imu.py) consume:

    out/
      cam0/data/<stamp_ns>.png     cam0/times.txt
      imu0/data.csv                (stamp_ns, wx, wy, wz, ax, ay, az)

The frame/IMU source is pluggable: on a robot, wrap the camera SDK or a
ROS2 subscription (see examples/ros2_rgbd_inertial_node.py callbacks); in
this environment `--source synthetic` records the analytic synthetic rig
so the pipeline (recorder -> process_imu -> ImuConfig YAML) is exercised
end-to-end without hardware.

    python tools/calibration_recorder.py --out /tmp/calib --seconds 20
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def write_png_gray(path: str, img: np.ndarray):
    """Minimal 8-bit grayscale PNG writer (no imaging deps)."""
    import struct
    import zlib
    h, w = img.shape
    raw = b"".join(b"\x00" + img[i].astype(np.uint8).tobytes()
                   for i in range(h))

    def chunk(tag, data):
        c = struct.pack(">I", len(data)) + tag + data
        return c + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    hdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)
    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", hdr)
           + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)


def record_synthetic(out: str, seconds: float, fps: float, imu_rate: float,
                     noise_gyro=1.7e-4, noise_acc=2e-3,
                     walk_gyro=1.9e-5, walk_acc=3e-3, seed=0,
                     static: bool = True):
    """Record the synthetic rig with realistic IMU noise + bias walk so the
    downstream Allan analysis has something true to recover."""
    import jax
    jax.config.update("jax_platforms", "cpu")   # host-side tool; leaves
    import jax.numpy as jnp                      # the card to the system
    from geoflowslam.io.synthetic import (SyntheticWorld,
                                          SyntheticSequence, Camera,
                                          smooth_trajectory, GRAVITY)

    cam = Camera(width=320, height=240, fx=200.0, fy=200.0, cx=160.0, cy=120.0)
    world = SyntheticWorld(cam)
    seq = SyntheticSequence(world, fps=fps, imu_rate=imu_rate)
    rng = np.random.default_rng(seed)

    cam_dir = os.path.join(out, "cam0", "data")
    imu_dir = os.path.join(out, "imu0")
    os.makedirs(cam_dir, exist_ok=True)
    os.makedirs(imu_dir, exist_ok=True)

    times = []
    n_frames = int(seconds * fps)
    for i in range(n_frames):
        t = i / fps
        stamp_ns = int(t * 1e9)
        gray, _, _ = seq.frame(t)
        write_png_gray(os.path.join(cam_dir, f"{stamp_ns}.png"),
                       np.clip(np.asarray(gray), 0, 255).astype(np.uint8))
        times.append(stamp_ns)
    with open(os.path.join(out, "cam0", "times.txt"), "w") as f:
        f.write("\n".join(str(t) for t in times) + "\n")

    # continuous IMU at imu_rate with white noise + random-walk bias;
    # the whole stream is synthesized in ONE vectorized trajectory eval
    dt = 1.0 / imu_rate
    n_imu = int(seconds * imu_rate)
    sq = np.sqrt(imu_rate)          # discrete sigma = density * sqrt(rate)
    tt = (np.arange(n_imu) + 0.5) * dt
    if static:
        # IMU-noise calibration requires a STATIC rig (the reference's
        # recording procedure): gyro sees only noise, acc sees gravity
        gyro_b = np.zeros((n_imu, 3))
        acc_b = np.broadcast_to(-GRAVITY, (n_imu, 3)).copy()
    else:
        rot_wb, _, _, a_w, w_body = jax.jit(smooth_trajectory)(jnp.asarray(tt))
        acc_b = np.einsum("sij,sj->si",
                          np.swapaxes(np.asarray(rot_wb), -1, -2),
                          np.asarray(a_w) - GRAVITY)
        gyro_b = np.asarray(w_body)
    bg = np.cumsum(rng.normal(0, walk_gyro / sq, (n_imu, 3)), axis=0)
    ba = np.cumsum(rng.normal(0, walk_acc / sq, (n_imu, 3)), axis=0)
    g_all = gyro_b + bg + rng.normal(0, noise_gyro * sq, (n_imu, 3))
    a_all = acc_b + ba + rng.normal(0, noise_acc * sq, (n_imu, 3))
    with open(os.path.join(imu_dir, "data.csv"), "w") as f:
        f.write("#timestamp [ns],w_RS_S_x [rad s^-1],w_RS_S_y,w_RS_S_z,"
                "a_RS_S_x [m s^-2],a_RS_S_y,a_RS_S_z\n")
        for k in range(n_imu):
            g, a = g_all[k], a_all[k]
            f.write(f"{int(tt[k]*1e9)},{g[0]:.9f},{g[1]:.9f},{g[2]:.9f},"
                    f"{a[0]:.9f},{a[1]:.9f},{a[2]:.9f}\n")
    print(f"recorded {n_frames} frames + {n_imu} IMU samples -> {out}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--fps", type=float, default=10.0)
    ap.add_argument("--imu-rate", type=float, default=200.0)
    ap.add_argument("--source", default="synthetic",
                    choices=["synthetic"])  # hardware sources plug in here
    ap.add_argument("--moving", action="store_true",
                    help="record the moving rig (SLAM input) instead of the "
                         "static IMU-calibration pose")
    args = ap.parse_args()
    record_synthetic(args.out, args.seconds, args.fps, args.imu_rate,
                     static=not args.moving)


if __name__ == "__main__":
    main()
