"""Stereo-fisheye mode: dual-KB8 matching + triangulation + e2e tracking.

Reference behaviours covered:
* Frame::ComputeStereoFishEyeMatches (/root/reference/src/Frame.cc:1503):
  lapping-area descriptor matching, Lowe 0.7, ray triangulation gates.
* KannalaBrandt8::TriangulateMatches (src/CameraModels/KannalaBrandt8.cpp:
  306): parallax + cheirality + chi2 reprojection gates, depth output.
* The 4-camera stereo Frame ctor (src/Frame.cc:1370) driving the standard
  tracking path, via SlamSystem.track_stereo_fisheye.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from geoflowslam.math import cameras as CAM
from geoflowslam.math import lie
from geoflowslam.ops.stereo import fisheye_stereo_match

KB8_L = (0.0035, 0.0007, -0.002, 0.0002)     # TUM-VI-like coefficients
KB8_R = (0.0034, 0.0018, -0.0027, 0.0003)


def _rig(baseline=0.101):
    """Right->left extrinsics: right camera at +x in the left frame with a
    tiny rotation (like the TUM-VI rig)."""
    r_lr = lie.so3_exp(jnp.array([0.002, -0.001, 0.0008]))
    t_lr = jnp.array([baseline, 0.002, 0.001])
    return r_lr, t_lr


class TestFisheyeMatcher:
    def _make(self, n=128, seed=0):
        rng = np.random.default_rng(seed)
        params_l = jnp.asarray([190.0, 190.0, 160.0, 120.0, *KB8_L])
        params_r = jnp.asarray([191.0, 190.5, 158.0, 121.0, *KB8_R])
        r_lr, t_lr = _rig()
        # depth <= 4.5 m: beyond ~5 m the 10 cm baseline drops under the
        # reference's parallax gate (cosParallaxRays > 0.9998 -> reject,
        # KannalaBrandt8.cpp:316) — by design those points stay mono
        pts = jnp.asarray(rng.uniform([-1.5, -1.0, 1.5], [1.5, 1.0, 4.5],
                                      (n, 3)), jnp.float32)
        # left cam = world; right cam: X_r = R_rl (X - t_lr)
        rot_rl = r_lr.T
        pts_r = (pts - t_lr) @ rot_rl.T
        uv_l = CAM.kb8_project(params_l, pts)
        uv_r = CAM.kb8_project(params_r, pts_r)
        rays_l = CAM.kb8_unproject(params_l, uv_l)
        rays_r = CAM.kb8_unproject(params_r, uv_r)
        desc = jnp.asarray(
            rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint64), jnp.uint32)
        return (params_l, params_r, r_lr, t_lr, pts, rays_l, rays_r, desc)

    def test_recovers_depth(self):
        (_, _, r_lr, t_lr, pts, rays_l, rays_r, desc) = self._make()
        n = pts.shape[0]
        sig2 = jnp.ones((n,))
        mask = jnp.ones((n,), bool)
        depth, p3d, midx = fisheye_stereo_match(
            rays_l, desc, mask, sig2, rays_r, desc, mask, sig2,
            r_lr, t_lr, f_err=190.0)
        ok = np.asarray(depth) > 0
        assert ok.mean() > 0.95, ok.mean()
        err = np.abs(np.asarray(depth)[ok] - np.asarray(pts[:, 2])[ok])
        assert np.median(err) < 0.01, np.median(err)
        # matched index must be the identity permutation where valid
        assert (np.asarray(midx)[ok] == np.arange(n)[ok]).all()
        perr = np.linalg.norm(np.asarray(p3d)[ok] - np.asarray(pts)[ok],
                              axis=1)
        assert np.median(perr) < 0.02, np.median(perr)

    def test_gates_reject_bad_matches(self):
        """Shuffled right descriptors produce wrong correspondences; the
        parallax/reprojection gates must kill (nearly) all of them."""
        (_, _, r_lr, t_lr, pts, rays_l, rays_r, desc) = self._make(seed=3)
        n = pts.shape[0]
        perm = np.roll(np.arange(n), 7)
        sig2 = jnp.ones((n,))
        mask = jnp.ones((n,), bool)
        depth, _, _ = fisheye_stereo_match(
            rays_l, desc, mask, sig2, rays_r[perm], desc, mask, sig2,
            r_lr, t_lr, f_err=190.0)
        assert (np.asarray(depth) > 0).mean() < 0.05

    def test_lapping_mask_respected(self):
        (_, _, r_lr, t_lr, pts, rays_l, rays_r, desc) = self._make(seed=5)
        n = pts.shape[0]
        sig2 = jnp.ones((n,))
        mask_l = jnp.zeros((n,), bool).at[: n // 2].set(True)
        depth, _, midx = fisheye_stereo_match(
            rays_l, desc, mask_l, sig2, rays_r, desc,
            jnp.ones((n,), bool), sig2, r_lr, t_lr, f_err=190.0)
        assert (np.asarray(depth)[n // 2:] <= 0).all()


@pytest.mark.slow
def test_track_stereo_fisheye_e2e():
    """Dual-KB8 stereo rig on the synthetic room: the left/right images are
    ray-cast through the KB8 model; tracking must hold an ATE comparable to
    the rectified-stereo e2e gate."""
    from geoflowslam.io.synthetic import (SyntheticWorld,
                                          SyntheticSequence, Camera)
    from geoflowslam.pipeline.system import (SlamSystem, SystemConfig,
                                             StereoFisheyeConfig)
    from geoflowslam.state.frame import FrameConfig
    from geoflowslam.ops.extractor import OrbConfig

    w, h = 320, 240
    fx = fy = 140.0
    caml = Camera(fx=fx, fy=fy, cx=w / 2, cy=h / 2, width=w, height=h,
                  kb8=KB8_L)
    camr = Camera(fx=fx + 0.5, fy=fy + 0.3, cx=w / 2 - 1.0, cy=h / 2 + 0.5,
                  width=w, height=h, kb8=KB8_R)
    r_lr, t_lr = _rig(baseline=0.1)
    rot_rl = np.asarray(r_lr.T)
    t_rl = -rot_rl @ np.asarray(t_lr)

    world_l = SyntheticWorld(caml)
    world_r = SyntheticWorld(camr)         # same seed -> same room texture
    seq = SyntheticSequence(world_l, fps=10.0)
    render_r = jax.jit(world_r.render)

    orb = OrbConfig(n_features=400, n_levels=4, height=h, width=w)
    fc = FrameConfig(orb=orb, lk_levels=3, cloud_stride=8, cloud_max_pts=512,
                     bf=fx * 0.1, camera_model="kb8", dist_params=KB8_L)
    sf = StereoFisheyeConfig(
        params_r=(camr.fx, camr.fy, camr.cx, camr.cy, *KB8_R),
        r_lr=tuple(np.asarray(r_lr).reshape(-1).tolist()),
        t_lr=tuple(np.asarray(t_lr).tolist()),
        lapping_l=(0.0, float(w)), lapping_r=(0.0, float(w)))
    cfg = SystemConfig(fx=fx, fy=fy, cx=w / 2, cy=h / 2, bf=fx * 0.1,
                       frame=fc, k_max=32, m_max=8192, sensor="stereo",
                       stereo_fisheye=sf,
                       kf_min_interval=1, kf_max_interval=4)
    slam = SlamSystem(cfg)

    from geoflowslam.eval.ate import ate_rmse
    gt = []
    for i in range(20):
        t = i / seq.fps
        gray_l, _, (rot_cw, t_cw) = seq.frame(t)
        rot_cw_r = jnp.asarray(rot_rl) @ rot_cw
        t_cw_r = jnp.asarray(rot_rl) @ t_cw + jnp.asarray(t_rl)
        gray_r, _ = render_r(rot_cw_r, t_cw_r)
        slam.track_stereo_fisheye(gray_l, gray_r, t)
        twc = np.eye(4)
        rwc = np.asarray(rot_cw).T
        twc[:3, :3] = rwc
        twc[:3, 3] = -rwc @ np.asarray(t_cw)
        gt.append((t, twc))
    assert slam.map_stats()["state"] == "OK", slam.map_stats()
    # SE3-aligned ATE (the SLAM world frame starts at the first KF, not the
    # GT origin); with_scale=False — metric scale must come out of the
    # fisheye triangulation itself
    m = ate_rmse(slam.trajectory, gt, with_scale=False)
    assert m["ate_rmse"] < 0.05, m


def test_yaml_tumvi_stereo_fisheye():
    import os
    path = "/root/reference/Examples/Stereo-Inertial/TUM-VI.yaml"
    if not os.path.exists(path):
        pytest.skip("reference config not mounted")
    from geoflowslam.io import yaml_compat
    cfg, y = yaml_compat.system_config_from_yaml(path)
    sf = cfg.stereo_fisheye
    assert sf is not None
    assert cfg.frame.camera_model == "kb8"
    assert abs(sf.params_r[0] - 190.44236969414825) < 1e-6
    assert abs(sf.t_lr[0] - 0.101063427414194) < 1e-6
    assert sf.lapping_l == (0.0, 511.0)
    r = np.asarray(sf.r_lr).reshape(3, 3)
    assert np.allclose(r @ r.T, np.eye(3), atol=1e-5)


@pytest.mark.slow
def test_track_stereo_fisheye_inertial_e2e():
    """Stereo-fisheye + IMU: preintegration drives prediction and the VI
    refinement on the dual-KB8 rig (the TUM-VI stereo-inertial regime)."""
    from geoflowslam.io.synthetic import (SyntheticWorld,
                                          SyntheticSequence, Camera)
    from geoflowslam.pipeline.system import (SlamSystem, SystemConfig,
                                             StereoFisheyeConfig)
    from geoflowslam.pipeline.inertial import ImuConfig
    from geoflowslam.state.frame import FrameConfig
    from geoflowslam.ops.extractor import OrbConfig
    from geoflowslam.eval.ate import ate_rmse

    w, h = 320, 240
    fx = fy = 140.0
    caml = Camera(fx=fx, fy=fy, cx=w / 2, cy=h / 2, width=w, height=h,
                  kb8=KB8_L)
    camr = Camera(fx=fx + 0.5, fy=fy + 0.3, cx=w / 2 - 1.0, cy=h / 2 + 0.5,
                  width=w, height=h, kb8=KB8_R)
    r_lr, t_lr = _rig(baseline=0.1)
    rot_rl = np.asarray(r_lr.T)
    t_rl = -rot_rl @ np.asarray(t_lr)

    world_l = SyntheticWorld(caml)
    world_r = SyntheticWorld(camr)
    seq = SyntheticSequence(world_l, fps=10.0)
    render_r = jax.jit(world_r.render)

    orb = OrbConfig(n_features=400, n_levels=4, height=h, width=w)
    fc = FrameConfig(orb=orb, lk_levels=3, cloud_stride=8, cloud_max_pts=512,
                     bf=fx * 0.1, camera_model="kb8", dist_params=KB8_L)
    sf = StereoFisheyeConfig(
        params_r=(camr.fx, camr.fy, camr.cx, camr.cy, *KB8_R),
        r_lr=tuple(np.asarray(r_lr).reshape(-1).tolist()),
        t_lr=tuple(np.asarray(t_lr).tolist()),
        lapping_l=(0.0, float(w)), lapping_r=(0.0, float(w)))
    cfg = SystemConfig(fx=fx, fy=fy, cx=w / 2, cy=h / 2, bf=fx * 0.1,
                       frame=fc, k_max=32, m_max=8192, sensor="stereo",
                       stereo_fisheye=sf, kf_min_interval=1,
                       kf_max_interval=4,
                       imu=ImuConfig(init_min_kfs=4, init_min_time=0.8))
    slam = SlamSystem(cfg)

    gt, last_t = [], 0.0
    for i in range(25):
        t = i / seq.fps
        gray_l, _, (rot_cw, t_cw) = seq.frame(t)
        rot_cw_r = jnp.asarray(rot_rl) @ rot_cw
        t_cw_r = jnp.asarray(rot_rl) @ t_cw + jnp.asarray(t_rl)
        gray_r, _ = render_r(rot_cw_r, t_cw_r)
        if i == 0:
            slam.track_stereo_fisheye(gray_l, gray_r, t)
        else:
            acc, gyro, dts = seq.imu_between(last_t, t, 32)
            slam.track_stereo_fisheye_inertial(gray_l, gray_r,
                                               acc, gyro, dts, t)
        last_t = t
        twc = np.eye(4)
        rwc = np.asarray(rot_cw).T
        twc[:3, :3] = rwc
        twc[:3, 3] = -rwc @ np.asarray(t_cw)
        gt.append((t, twc))
    assert slam.map_stats()["state"] == "OK", slam.map_stats()
    assert slam.imu.initialized
    m = ate_rmse(slam.trajectory, gt, with_scale=False)
    assert m["ate_rmse"] < 0.06, m
