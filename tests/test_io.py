import os
import numpy as np
import jax.numpy as jnp
import pytest

from geoflowslam.io import datasets, trajectory, yaml_compat
from geoflowslam.eval.ate import ate_rmse


def test_yaml_compat_parses_reference_config():
    path = "/root/reference/Examples/ROS2/RGB-D-Inertial/config/g1_op_icp_lidar_indoor1.yaml"
    if not os.path.exists(path):
        pytest.skip("reference config not mounted")
    cfg, y = yaml_compat.system_config_from_yaml(path)
    assert cfg.frame.orb.n_features > 0
    assert cfg.fx > 100
    assert y.get("Camera.fps") == 30
    # GeoFlow switches must round-trip
    assert isinstance(cfg.use_icp, bool)
    assert cfg.imu is not None and cfg.imu.freq == 200.0


def test_trajectory_roundtrip(tmp_path):
    rng = np.random.RandomState(0)
    traj = []
    for i in range(10):
        twc = np.eye(4)
        # random small rotation via rodrigues-ish
        w = rng.randn(3) * 0.1
        th = np.linalg.norm(w)
        k = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
        twc[:3, :3] = np.eye(3) + np.sin(th) / max(th, 1e-9) * k \
            + (1 - np.cos(th)) / max(th * th, 1e-12) * (k @ k)
        twc[:3, 3] = rng.randn(3)
        traj.append((float(i) * 0.1, twc))
    p = str(tmp_path / "traj.txt")
    trajectory.save_trajectory_tum(p, traj)
    loaded = trajectory.load_trajectory_tum(p)
    assert len(loaded) == 10
    m = ate_rmse(loaded, traj)
    assert m["ate_rmse"] < 1e-5

    trajectory.save_trajectory_kitti(str(tmp_path / "k.txt"), traj)
    trajectory.save_trajectory_euroc(str(tmp_path / "e.csv"), traj)
    assert os.path.getsize(tmp_path / "k.txt") > 0


def test_pnm_roundtrip(tmp_path):
    img = (np.random.RandomState(1).rand(48, 64) * 255).astype(np.uint8)
    p = str(tmp_path / "x.pgm")
    with open(p, "wb") as f:
        f.write(b"P5\n64 48\n255\n" + img.tobytes())
    loaded = datasets.load_image(p)
    np.testing.assert_array_equal(loaded, img.astype(np.float32))


def test_png_gray_roundtrip(tmp_path):
    import zlib, struct
    img = (np.random.RandomState(2).rand(32, 40) * 255).astype(np.uint8)
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(32))

    def chunk(ctype, data):
        c = ctype + data
        return struct.pack(">I", len(data)) + c + struct.pack(">I", zlib.crc32(c))

    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", struct.pack(">IIBBBBB", 40, 32, 8, 0, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(raw))
           + chunk(b"IEND", b""))
    p = str(tmp_path / "x.png")
    with open(p, "wb") as f:
        f.write(png)
    loaded = datasets.load_image(p)
    np.testing.assert_array_equal(loaded, img.astype(np.float32))


def test_imu_between():
    imu = np.zeros((100, 7))
    imu[:, 0] = np.arange(100) * 0.005
    imu[:, 1:4] = 0.1
    imu[:, 4:7] = 9.8
    acc, gyro, dts = datasets.imu_between(imu, 0.01, 0.06, 32)
    assert dts.sum() == pytest.approx(0.05, abs=1e-6)
    assert (dts > 0).sum() == 10
    np.testing.assert_allclose(acc[:10], 9.8)


def test_native_loader(tmp_path):
    from geoflowslam.io import native_loader as NL
    if not NL.native_available():
        pytest.skip("native lib not built")
    rng = np.random.RandomState(3)
    rgbs, deps, truth = [], [], []
    for i in range(6):
        img = (rng.rand(48, 64) * 255).astype(np.uint8)
        p = str(tmp_path / f"g{i}.pgm")
        with open(p, "wb") as f:
            f.write(b"P5\n64 48\n255\n" + img.tobytes())
        d16 = (rng.rand(48, 64) * 5000).astype(">u2")
        pd = str(tmp_path / f"d{i}.pgm")
        with open(pd, "wb") as f:
            f.write(b"P5\n64 48\n65535\n" + d16.tobytes())
        rgbs.append(p); deps.append(pd)
        truth.append((img.astype(np.float32), d16.astype(np.float32) / 5000.0))
    loader = NL.FrameLoader(rgbs, deps, height=48, width=64,
                            depth_scale=1.0 / 5000.0)
    seen = []
    for idx, g, d in loader:
        np.testing.assert_array_equal(g, truth[idx][0])
        np.testing.assert_allclose(d, truth[idx][1], rtol=1e-5)
        seen.append(idx)
    assert seen == list(range(6))  # strict ordering
    loader.close()


def test_async_api():
    from geoflowslam.pipeline.async_api import AsyncSlam
    from geoflowslam.pipeline.system import SlamSystem, SystemConfig
    from geoflowslam.state.frame import FrameConfig
    from geoflowslam.ops.extractor import OrbConfig
    from geoflowslam.io.synthetic import SyntheticWorld, SyntheticSequence, Camera

    w, h = 320, 240
    cam = Camera(fx=200.0, fy=200.0, cx=w / 2, cy=h / 2, width=w, height=h)
    orb = OrbConfig(n_features=200, n_levels=3, height=h, width=w)
    fc = FrameConfig(orb=orb, lk_levels=2, cloud_stride=8, cloud_max_pts=512,
                     bf=20.0)
    cfg = SystemConfig(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, bf=20.0,
                       frame=fc, k_max=8, m_max=1024)
    world = SyntheticWorld(cam)
    seq = SyntheticSequence(world, fps=10.0)
    aslam = AsyncSlam(SlamSystem(cfg))
    futs = []
    for i in range(5):
        t = i / seq.fps
        gray, depth, _ = seq.frame(t)
        futs.append(aslam.track_rgbd_async(np.asarray(gray), np.asarray(depth), t))
    poses = [f.result(timeout=300) for f in futs]
    assert all(p.shape == (4, 4) for p in poses)
    aslam.shutdown()


def test_undistortion_frame_build():
    import jax.numpy as jnp
    from geoflowslam.state.frame import FrameConfig, build_frame
    from geoflowslam.ops.extractor import OrbConfig
    from geoflowslam.io.synthetic import SyntheticWorld, Camera

    w, h = 256, 192
    cam = Camera(fx=150.0, fy=150.0, cx=w / 2, cy=h / 2, width=w, height=h)
    world = SyntheticWorld(cam)
    import jax
    gray, depth = jax.jit(world.render)(jnp.eye(3), jnp.zeros(3))
    orb = OrbConfig(n_features=100, n_levels=3, height=h, width=w)
    # mild radtan distortion: undistorted uv should differ but stay in-image
    fc = FrameConfig(orb=orb, lk_levels=2, cloud_stride=8, cloud_max_pts=256,
                     dist_params=(-0.1, 0.01, 0.0, 0.0, 0.0))
    fr = build_frame(gray, depth, fc, cam.fx, cam.fy, cam.cx, cam.cy)
    fc0 = FrameConfig(orb=orb, lk_levels=2, cloud_stride=8, cloud_max_pts=256)
    fr0 = build_frame(gray, depth, fc0, cam.fx, cam.fy, cam.cx, cam.cy)
    d = np.abs(np.asarray(fr.feat.uv) - np.asarray(fr0.feat.uv))
    sel = np.asarray(fr.feat.valid)
    assert d[sel].max() > 0.5          # undistortion moved the points
    assert d[sel].max() < 20.0         # ...but sanely
    # kb8 path compiles and runs
    fck = FrameConfig(orb=orb, lk_levels=2, cloud_stride=8, cloud_max_pts=256,
                      camera_model="kb8",
                      dist_params=(0.003, 0.0007, -0.002, 0.0002))
    frk = build_frame(gray, depth, fck, cam.fx, cam.fy, cam.cx, cam.cy)
    assert bool(jnp.isfinite(frk.feat.uv).all())


def test_viewer_smoke(tmp_path):
    import jax, jax.numpy as jnp
    from geoflowslam.viewer.viewer import Viewer
    from geoflowslam.state import map_state as M

    ms = M.create(4, 32, 128)
    ms = M.insert_keyframe(
        ms, jnp.int32(0), jnp.eye(3), jnp.zeros(3), jnp.zeros(3), jnp.zeros(6),
        jnp.float32(0.0), jnp.ones((32, 2)) * 50, jnp.zeros(32, jnp.int32),
        jnp.zeros(32), jnp.ones((32, 8), jnp.uint32), jnp.full((32,), 2.0),
        jnp.ones(32, bool), jnp.arange(32, dtype=jnp.int32), jnp.int32(-1))
    ms = M.add_map_points(ms, jnp.arange(32, dtype=jnp.int32),
                          jax.random.normal(jax.random.PRNGKey(0), (32, 3)),
                          jnp.ones((32, 8), jnp.uint32), jnp.zeros((32, 3)),
                          jnp.zeros(32), jnp.ones(32), jnp.int32(0),
                          jnp.ones(32, bool))
    v = Viewer(str(tmp_path))
    p1 = v.draw_map(ms, cur_rot=jnp.eye(3), cur_t=jnp.zeros(3))
    img = jnp.zeros((96, 128))
    p2 = v.draw_frame(img, jnp.ones((32, 2)) * 40, jnp.ones(32, bool),
                      jnp.arange(32) - 16)
    assert os.path.getsize(p1) > 1000 and os.path.getsize(p2) > 1000


class TestFeedCodec:
    """io/feed_codec m12 wire format: pack/unpack round trip and full
    equivalence of the packed feed path through build_frame."""

    def test_roundtrip(self):
        from geoflowslam.io import feed_codec as FC
        rng = np.random.default_rng(0)
        h, w = 32, 64
        gray = rng.integers(0, 256, (h, w)).astype(np.uint8)
        depth_m = rng.uniform(0, 8.0, (h, w)).astype(np.float32)
        depth_m[::7] = 0.0                       # invalid rows
        buf = FC.pack_m12(gray, depth_m, 1.0)    # depth in metres
        assert buf.shape == (FC.packed_size(h, w),) and buf.dtype == np.uint8
        g2, q = FC.unpack_m12_np(buf, h, w)
        np.testing.assert_array_equal(g2, gray)
        d2 = q.astype(np.float32) * FC.M12_STEP_M
        assert np.abs(d2 - np.clip(depth_m, 0, 4095 * FC.M12_STEP_M)).max() \
            <= FC.M12_STEP_M + 1e-6
        assert (d2[::7] == 0).all()

    def test_build_frame_packed_matches_raw(self):
        from geoflowslam.io import feed_codec as FC
        from geoflowslam.state.frame import FrameConfig, build_frame
        from geoflowslam.ops.extractor import OrbConfig
        rng = np.random.default_rng(1)
        h, w = 64, 96
        gray = rng.integers(0, 256, (h, w)).astype(np.uint8)
        # depth on the 4 mm grid so packed == raw exactly
        depth_mm = (rng.integers(0, 4000, (h, w)) * 4).astype(np.uint16)
        orb = OrbConfig(n_features=64, n_levels=2, height=h, width=w)
        fc = FrameConfig(orb=orb, lk_levels=2, cloud_stride=8,
                         cloud_max_pts=128, depth_map_factor=1e-3)
        args = (fc, 80.0, 80.0, w / 2, h / 2)
        f_raw = build_frame(jnp.asarray(gray), jnp.asarray(depth_mm), *args)
        buf = FC.pack_m12(gray, depth_mm, 1e-3)
        f_pk = build_frame(jnp.asarray(buf), jnp.zeros((1, 1)), *args)
        np.testing.assert_allclose(np.asarray(f_pk.feat.uv),
                                   np.asarray(f_raw.feat.uv))
        np.testing.assert_allclose(np.asarray(f_pk.depth_kp),
                                   np.asarray(f_raw.depth_kp), atol=1e-5)


class TestRos2Sync:
    """The ROS2 driver's sync/batching logic (examples/ros2_rgbd_inertial
    _node.py) exercised with fake messages — pairs rgb/depth by stamp, drops
    skewed heads, batches IMU in (t_prev, t_img] exactly once."""

    @staticmethod
    def _node():
        import importlib.util
        spec = importlib.util.spec_from_file_location(
            "ros2_node", os.path.join(os.path.dirname(__file__), "..",
                                      "examples", "ros2_rgbd_inertial_node.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    @staticmethod
    def _img(t, enc="mono8", w=8, h=6):
        class Stamp:
            sec = int(t)
            nanosec = int((t - int(t)) * 1e9)

        class Header:
            stamp = Stamp()

        class Msg:
            header = Header()
            height, width, encoding = h, w, enc
            data = bytes(h * w * (2 if enc == "16UC1" else 1))
        return Msg()

    def test_sync_batches_imu_between_frames(self):
        mod = self._node()

        class FakeSlam:
            calls = []

            def track_rgbd_inertial(self, g, d, acc, gyro, dts, t):
                self.calls.append(("vi", t, len(acc), float(dts.sum())))

            def track_rgbd(self, g, d, t):
                self.calls.append(("v", t, 0, 0.0))

        slam = FakeSlam()
        node = mod.RgbdInertialNode(None, slam)
        # frame at t=0.10 and t=0.20; IMU at 100 Hz
        for t in (0.10, 0.20):
            node.on_rgb(self._img(t))
            node.on_depth(self._img(t, "16UC1"))

        class ImuMsg:
            def __init__(self, t):
                class S:
                    sec = int(t)
                    nanosec = int((t - int(t)) * 1e9)

                class H:
                    stamp = S()

                class V:
                    x, y, z = 0.1, 0.2, 9.8
                self.header = H()
                self.linear_acceleration = V()
                self.angular_velocity = V()

        for k in range(30):
            node.on_imu(ImuMsg(0.005 + k * 0.01))

        assert node.sync_step()           # first frame: no previous stamp
        assert node.sync_step()           # second frame: batched VI
        assert not node.sync_step()       # nothing left
        kinds = [c[0] for c in slam.calls]
        assert kinds == ["v", "vi"], slam.calls
        # the VI call got exactly the samples in (0.10, 0.20]
        _, t, n, dt_sum = slam.calls[1]
        assert abs(t - 0.20) < 1e-9
        assert n == 10, slam.calls
        assert abs(dt_sum - 0.10) < 1e-6

    def test_skewed_pairs_dropped(self):
        mod = self._node()

        class FakeSlam:
            calls = []

            def track_rgbd(self, g, d, t):
                self.calls.append(t)
        slam = FakeSlam()
        node = mod.RgbdInertialNode(None, slam)
        node.on_rgb(self._img(0.10))      # orphan (no depth partner)
        node.on_rgb(self._img(0.30))
        node.on_depth(self._img(0.301, "16UC1"))  # within the 10 ms gate
        assert node.sync_step()
        assert len(slam.calls) == 1 and abs(slam.calls[0] - 0.30) < 1e-6


class TestImuCalibration:
    """tools/process_imu.py Allan analysis (the reference's Examples/
    Calibration python_scripts role): white-noise and random-walk densities
    must be recovered from a static recording."""

    def test_allan_recovers_densities(self):
        import tools.process_imu as P
        rng = np.random.default_rng(0)
        rate, density, walk = 200.0, 1.7e-4, 1.9e-5
        n = int(200 * 1800)
        x = rng.normal(0, density * np.sqrt(rate), n) \
            + np.cumsum(rng.normal(0, walk / np.sqrt(rate), n))
        taus, ad = P.allan_deviation(x, rate)
        n_fit, k_fit = P.fit_noise_params(taus, ad)
        assert abs(n_fit / density - 1) < 0.05, n_fit
        assert abs(k_fit / walk - 1) < 0.35, k_fit

    def test_recorder_to_analysis_roundtrip(self, tmp_path):
        """calibration_recorder (static) -> process_imu recovers the noise
        density it injected; the EuRoC layout is written completely."""
        import subprocess
        import sys as _sys
        out = str(tmp_path / "calib")
        r = subprocess.run(
            [_sys.executable, "tools/calibration_recorder.py", "--out", out,
             "--seconds", "120", "--fps", "0.5", "--imu-rate", "200"],
            capture_output=True, text=True, timeout=300,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        assert r.returncode == 0, r.stderr
        assert os.path.exists(os.path.join(out, "cam0", "times.txt"))
        assert len(os.listdir(os.path.join(out, "cam0", "data"))) == 60
        import tools.process_imu as P
        ts, gyro, acc, rate = P.load_euroc_imu(out)
        assert abs(rate - 200.0) < 1.0
        taus, ad = P.allan_deviation(gyro[:, 0] - gyro[:, 0].mean(), rate)
        n_fit, _ = P.fit_noise_params(taus, ad)
        assert abs(n_fit / 1.7e-4 - 1) < 0.2, n_fit


def test_feed_codec_native_matches_numpy():
    """native/feed_pack.cpp must produce byte-identical buffers to the
    numpy reference implementation (u16 and f32 depth variants)."""
    from geoflowslam.io import feed_codec as FC
    if FC._load_lib() is None:
        import pytest as _pytest
        _pytest.skip("native lib not built")
    rng = np.random.default_rng(3)
    h, w = 48, 64
    gray = rng.integers(0, 256, (h, w)).astype(np.uint8)
    depth_mm = rng.integers(0, 17000, (h, w)).astype(np.uint16)
    lib = FC._lib
    try:
        FC._lib = 0                       # force the numpy path
        ref_u16 = FC.pack_m12(gray, depth_mm, 1e-3)
        ref_f32 = FC.pack_m12(gray, depth_mm.astype(np.float32) * 1e-3, 1.0)
    finally:
        FC._lib = lib
    nat_u16 = FC.pack_m12(gray, depth_mm, 1e-3)
    nat_f32 = FC.pack_m12(gray, depth_mm.astype(np.float32) * 1e-3, 1.0)
    np.testing.assert_array_equal(nat_u16, ref_u16)
    np.testing.assert_array_equal(nat_f32, ref_f32)
