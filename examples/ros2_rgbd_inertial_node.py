#!/usr/bin/env python
"""ROS2 RGB-D-inertial live node.

Python re-expression of the reference's ROS2 driver
(/root/reference/Examples/ROS2/RGB-D-Inertial/src/rgbd_inertial_ros2.cc):
subscribes to RGB + depth image topics and the IMU stream, buffers IMU
messages, synchronizes image pairs by stamp, batches the IMU measurements
between consecutive frames (GrabImu + SyncWithImu, :87-210), and feeds
`SlamSystem.track_rgbd_inertial` (the reference's TrackRGBD-with-IMU call,
:212). Odometry messages, when present, feed `set_odom` (UseRobotOdom).

Runs wherever rclpy is installed (a real robot / rosbag playback); in this
build environment ROS2 is absent, so the node exits with a clear message —
the synchronization/batching logic is identical to what the soak tests
drive directly.

    ros2 run <pkg> ros2_rgbd_inertial_node.py --config cfg.yaml \
        [--rgb /camera/color] [--depth /camera/depth] [--imu /imu]
"""
import argparse
import os
import sys
import threading
from collections import deque

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def img_to_gray(msg) -> np.ndarray:
    """sensor_msgs/Image -> [H,W] uint8 gray (mono8/rgb8/bgr8)."""
    h, w = msg.height, msg.width
    buf = np.frombuffer(bytes(msg.data), np.uint8)
    if msg.encoding == "mono8":
        return buf.reshape(h, w)
    if msg.encoding in ("rgb8", "bgr8"):
        c = buf.reshape(h, w, 3).astype(np.float32)
        r, g, b = (c[..., 0], c[..., 1], c[..., 2]) \
            if msg.encoding == "rgb8" else (c[..., 2], c[..., 1], c[..., 0])
        return (0.299 * r + 0.587 * g + 0.114 * b).astype(np.uint8)
    raise ValueError(f"unsupported rgb encoding {msg.encoding}")


def img_to_depth(msg) -> np.ndarray:
    """sensor_msgs/Image -> [H,W] depth in sensor units (16UC1 or 32FC1)."""
    h, w = msg.height, msg.width
    if msg.encoding == "16UC1":
        return np.frombuffer(bytes(msg.data), np.uint16).reshape(h, w)
    if msg.encoding == "32FC1":
        return np.frombuffer(bytes(msg.data), np.float32).reshape(h, w)
    raise ValueError(f"unsupported depth encoding {msg.encoding}")


def stamp_to_sec(stamp) -> float:
    return stamp.sec + stamp.nanosec * 1e-9


class RgbdInertialNode:
    """Buffers topics and drives the SLAM system from a sync thread —
    the reference's ImageGrabber + SyncWithImu structure."""

    MAX_STAMP_SKEW = 0.01      # rgb/depth pair gate (s)

    def __init__(self, node, slam, depth_scale=1.0, max_queue=200):
        self.node = node
        self.slam = slam
        self.depth_scale = depth_scale
        self.rgb_buf = deque(maxlen=max_queue)
        self.depth_buf = deque(maxlen=max_queue)
        self.imu_buf = deque(maxlen=4000)
        self.lock = threading.Lock()
        self.last_img_t = None
        self.running = True

    # -- callbacks (GrabImageRgb/GrabImageDepth/GrabImu) -------------------
    def on_rgb(self, msg):
        with self.lock:
            self.rgb_buf.append(msg)

    def on_depth(self, msg):
        with self.lock:
            self.depth_buf.append(msg)

    def on_imu(self, msg):
        with self.lock:
            self.imu_buf.append((
                stamp_to_sec(msg.header.stamp),
                (msg.linear_acceleration.x, msg.linear_acceleration.y,
                 msg.linear_acceleration.z),
                (msg.angular_velocity.x, msg.angular_velocity.y,
                 msg.angular_velocity.z)))

    def on_odom(self, msg):
        # Tracking::GrabOdomData consumes the base velocity; it is rotated
        # into the camera frame by the configured T_odom_w inside set_odom
        v = msg.twist.twist.linear
        self.slam.set_odom(np.array([v.x, v.y, v.z], np.float32))

    # -- SyncWithImu -------------------------------------------------------
    def sync_step(self) -> bool:
        """Pair the oldest rgb/depth by stamp, batch IMU in (t_prev, t],
        track. Returns True if a frame was processed."""
        with self.lock:
            while self.rgb_buf and self.depth_buf:
                t_rgb = stamp_to_sec(self.rgb_buf[0].header.stamp)
                t_dep = stamp_to_sec(self.depth_buf[0].header.stamp)
                if abs(t_rgb - t_dep) <= self.MAX_STAMP_SKEW:
                    break
                # drop the older of a skewed pair (reference drops from the
                # head until stamps align)
                (self.rgb_buf if t_rgb < t_dep else self.depth_buf).popleft()
            if not (self.rgb_buf and self.depth_buf):
                return False
            t_img = stamp_to_sec(self.rgb_buf[0].header.stamp)
            # wait until IMU has caught up past the image stamp
            if self.imu_buf and self.imu_buf[-1][0] <= t_img:
                return False
            rgb = self.rgb_buf.popleft()
            dep = self.depth_buf.popleft()
            imu = []
            while self.imu_buf and self.imu_buf[0][0] <= t_img:
                s = self.imu_buf.popleft()
                if self.last_img_t is None or s[0] > self.last_img_t:
                    imu.append(s)

        gray = img_to_gray(rgb)
        depth = img_to_depth(dep)
        if imu and self.last_img_t is not None:
            ts = np.array([s[0] for s in imu])
            acc = np.array([s[1] for s in imu], np.float32)
            gyro = np.array([s[2] for s in imu], np.float32)
            prev = np.concatenate([[self.last_img_t], ts[:-1]])
            dts = (ts - prev).astype(np.float32)
            # extend the last interval to the image stamp (the reference's
            # tstep handling in Tracking::PreintegrateIMU: the final sample
            # integrates up to mTimeStamp)
            dts[-1] += np.float32(t_img - ts[-1])
            self.slam.track_rgbd_inertial(gray, depth, acc, gyro, dts, t_img)
        else:
            self.slam.track_rgbd(gray, depth, t_img)
        self.last_img_t = t_img
        return True


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True, help="reference-format YAML")
    ap.add_argument("--vocab", default=None)
    ap.add_argument("--rgb", default="/camera/color/image_raw")
    ap.add_argument("--depth", default="/camera/aligned_depth_to_color/image_raw")
    ap.add_argument("--imu", default="/imu")
    ap.add_argument("--odom", default=None)
    ap.add_argument("--out", default="results_ros2")
    args = ap.parse_args()

    try:
        import rclpy
        from sensor_msgs.msg import Image, Imu
        from nav_msgs.msg import Odometry
    except ImportError:
        print("rclpy not available: this driver needs a ROS2 environment "
              "(robot or rosbag playback). The sync/batching logic itself "
              "is exercised by tests/test_io.py::TestRos2Sync.",
              file=sys.stderr)
        sys.exit(2)

    from geoflowslam.io.yaml_compat import system_config_from_yaml
    from geoflowslam.pipeline.system import SlamSystem
    from geoflowslam.retrieval import vocab as V

    cfg, y = system_config_from_yaml(args.config)
    if args.vocab and args.vocab.endswith(".txt"):
        vocab = V.load_dbow2_text(args.vocab)     # ORBvoc.txt format
    elif args.vocab:
        vocab = V.load_vocabulary(args.vocab)
    else:
        vocab = V.default_vocabulary()
    slam = SlamSystem(cfg, vocab=vocab)

    rclpy.init()
    node = rclpy.create_node("geoflowslam")
    grab = RgbdInertialNode(node, slam,
                            depth_scale=cfg.frame.depth_map_factor)
    node.create_subscription(Image, args.rgb, grab.on_rgb, 100)
    node.create_subscription(Image, args.depth, grab.on_depth, 100)
    node.create_subscription(Imu, args.imu, grab.on_imu, 1000)
    if args.odom:
        node.create_subscription(Odometry, args.odom, grab.on_odom, 100)

    def sync_loop():
        while grab.running:
            if not grab.sync_step():
                import time
                time.sleep(0.002)

    th = threading.Thread(target=sync_loop, daemon=True)
    th.start()
    try:
        rclpy.spin(node)
    except KeyboardInterrupt:
        pass
    finally:
        grab.running = False
        th.join(timeout=2.0)
        os.makedirs(args.out, exist_ok=True)
        slam.shutdown(args.out)
        node.destroy_node()
        rclpy.shutdown()


if __name__ == "__main__":
    main()
