"""Synthetic RGB-D-inertial world for integration tests and benchmarks.

The reference validates end-to-end on real datasets (TUM/EuRoC/Go2, SURVEY.md
§4); this environment has no datasets, so the e2e layer renders a procedural
textured room with exact ground truth instead: ray-cast planes with a
precomputed noise texture give photo-consistent grayscale + depth from any
pose, and analytic trajectories give exact IMU (gyro/acc) and odometry.

Everything is jit-compiled; rendering a 640x480 frame is a few fused gathers.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from geoflowslam.math import lie

GRAVITY = np.array([0.0, 0.0, -9.81], np.float32)


def _make_texture(key, size=1024, octaves=5):
    """Multi-octave value-noise texture in [0, 255], strong local gradients."""
    tex = np.zeros((size, size), np.float32)
    rng = np.random.RandomState(int(key))
    for o in range(octaves):
        cells = 8 << o
        grid = rng.rand(cells + 1, cells + 1).astype(np.float32)
        ys = np.linspace(0, cells, size, endpoint=False)
        xs = np.linspace(0, cells, size, endpoint=False)
        y0 = ys.astype(int); x0 = xs.astype(int)
        fy = (ys - y0)[:, None]; fx = (xs - x0)[None, :]
        g = grid
        v = (g[y0][:, x0] * (1 - fy) * (1 - fx)
             + g[y0][:, x0 + 1] * (1 - fy) * fx
             + g[y0 + 1][:, x0] * fy * (1 - fx)
             + g[y0 + 1][:, x0 + 1] * fy * fx)
        tex += v / (1.5 ** o)
    tex = (tex - tex.min()) / (tex.max() - tex.min())
    return jnp.asarray(tex * 215.0 + 20.0)


@dataclasses.dataclass(frozen=True)
class Camera:
    fx: float = 400.0
    fy: float = 400.0
    cx: float = 320.0
    cy: float = 240.0
    width: int = 640
    height: int = 480
    # KB8 fisheye theta-polynomial coefficients (k0..k3); empty = pinhole.
    # When set, rendering casts rays through the Kannala-Brandt model, so
    # stereo-fisheye pipelines can be exercised end-to-end without datasets.
    kb8: tuple = ()


class SyntheticWorld:
    """A textured box room: 4 walls + floor + ceiling, centered at origin.

    World frame: x right, y down, z forward (camera convention at identity).
    Room extents: [-hx, hx] x [-hy, hy] x [-hz, hz].
    """

    def __init__(self, cam: Camera = Camera(), seed: int = 7,
                 half_extent=(3.0, 2.0, 4.0), tex_scale: float = 0.7):
        self.cam = cam
        self.tex = _make_texture(seed)
        self.he = jnp.asarray(half_extent, jnp.float32)
        self.tex_scale = tex_scale
        # plane normals/offsets: 6 axis-aligned planes
        self.normals = jnp.array([
            [1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1],
        ], jnp.float32)
        self.offsets = jnp.array([
            half_extent[0], half_extent[0], half_extent[1], half_extent[1],
            half_extent[2], half_extent[2],
        ], jnp.float32)

    def render(self, rot_cw: jnp.ndarray, t_cw: jnp.ndarray):
        """Render from Tcw. Returns (gray [H,W], depth [H,W]) both float32."""
        cam = self.cam
        ys = jnp.arange(cam.height, dtype=jnp.float32)[:, None]
        xs = jnp.arange(cam.width, dtype=jnp.float32)[None, :]
        if cam.kb8:
            from geoflowslam.math import cameras as CAM
            params = jnp.asarray([cam.fx, cam.fy, cam.cx, cam.cy, *cam.kb8],
                                 jnp.float32)
            uv = jnp.stack([jnp.broadcast_to(xs, (cam.height, cam.width)),
                            jnp.broadcast_to(ys, (cam.height, cam.width))],
                           axis=-1)
            dirs_c = CAM.kb8_unproject(params, uv)
        else:
            dirs_c = jnp.stack([
                jnp.broadcast_to((xs - cam.cx) / cam.fx,
                                 (cam.height, cam.width)),
                jnp.broadcast_to((ys - cam.cy) / cam.fy,
                                 (cam.height, cam.width)),
                jnp.ones((cam.height, cam.width), jnp.float32),
            ], axis=-1)
        rot_wc = rot_cw.T
        origin = -rot_wc @ t_cw                                  # camera center, world
        dirs_w = jnp.einsum("ij,hwj->hwi", rot_wc, dirs_c)

        # intersect with each plane n.x = -offset (inward normals): t = -(o.n + d)/dir.n
        n_dot_d = jnp.einsum("pi,hwi->hwp", self.normals, dirs_w)
        n_dot_o = self.normals @ origin                           # [6]
        tt = -(n_dot_o + self.offsets)[None, None, :] / jnp.where(
            jnp.abs(n_dot_d) < 1e-6, 1e-6, n_dot_d)
        tt = jnp.where(tt > 1e-3, tt, jnp.inf)
        t_hit = jnp.min(tt, axis=-1)
        p_idx = jnp.argmin(tt, axis=-1)
        pts_w = origin[None, None, :] + dirs_w * t_hit[..., None]

        # texture coords: project world point onto the two in-plane axes
        axes_u = jnp.array([[0, 1, 0], [0, 1, 0], [1, 0, 0], [1, 0, 0],
                            [1, 0, 0], [1, 0, 0]], jnp.float32)
        axes_v = jnp.array([[0, 0, 1], [0, 0, 1], [0, 0, 1], [0, 0, 1],
                            [0, 1, 0], [0, 1, 0]], jnp.float32)
        au = axes_u[p_idx]
        av = axes_v[p_idx]
        u = jnp.sum(pts_w * au, axis=-1) / self.tex_scale + 7.3 * p_idx
        v = jnp.sum(pts_w * av, axis=-1) / self.tex_scale + 3.1 * p_idx
        size = self.tex.shape[0]
        ui = jnp.mod(u * 97.0, size - 1.0)
        vi = jnp.mod(v * 97.0, size - 1.0)
        u0 = jnp.floor(ui).astype(jnp.int32); v0 = jnp.floor(vi).astype(jnp.int32)
        du = ui - u0; dv = vi - v0
        tex = self.tex
        g = (tex[v0, u0] * (1 - du) * (1 - dv) + tex[v0, u0 + 1] * du * (1 - dv)
             + tex[v0 + 1, u0] * (1 - du) * dv + tex[v0 + 1, u0 + 1] * du * dv)

        depth = t_hit * dirs_c[..., 2]  # z-depth (dirs_c z = 1 -> depth = t * 1 along ray z)
        # depth along optical axis: z component of cam-frame point
        pc = jnp.einsum("ij,hwj->hwi", rot_cw, pts_w) + t_cw
        depth = pc[..., 2]
        return g, depth


def smooth_trajectory(t: jnp.ndarray, scale: float = 1.0,
                      freq: float = 1.0):
    """Analytic Twc trajectory inside the room: returns (R_wc, p_w, v_w, a_w,
    w_body) at times t [...]. Camera looks roughly +z with gentle yaw/pitch.

    `freq` warps time (same path, traversed freq x faster): velocities
    scale by freq, accelerations by freq^2 — the knob for IMU-excitation
    studies (mono-inertial scale observability needs accelerations well
    above the rotation-noise floor of the gravity terms)."""
    if freq != 1.0:
        rot, p, v, a, w = smooth_trajectory(t * freq, scale)
        return rot, p, v * freq, a * freq ** 2, w * freq
    # position: slow Lissajous
    p = jnp.stack([
        0.8 * scale * jnp.sin(0.5 * t),
        0.3 * scale * jnp.sin(0.7 * t + 1.0),
        0.6 * scale * jnp.sin(0.4 * t),
    ], axis=-1)
    v = jnp.stack([
        0.4 * scale * jnp.cos(0.5 * t),
        0.21 * scale * jnp.cos(0.7 * t + 1.0),
        0.24 * scale * jnp.cos(0.4 * t),
    ], axis=-1)
    a = jnp.stack([
        -0.2 * scale * jnp.sin(0.5 * t),
        -0.147 * scale * jnp.sin(0.7 * t + 1.0),
        -0.096 * scale * jnp.sin(0.4 * t),
    ], axis=-1)
    # orientation: yaw/pitch sinusoids; R_wc = exp(phi(t))
    phi = jnp.stack([
        0.10 * jnp.sin(0.3 * t),
        0.15 * jnp.sin(0.23 * t + 0.5),
        0.05 * jnp.sin(0.17 * t),
    ], axis=-1)
    rot = lie.so3_exp(phi)
    # body angular velocity: w = Jr(phi) @ phi_dot (right-local rate)
    phi_dot = jnp.stack([
        0.03 * jnp.cos(0.3 * t),
        0.0345 * jnp.cos(0.23 * t + 0.5),
        0.0085 * jnp.cos(0.17 * t),
    ], axis=-1)
    w_body = jnp.einsum("...ij,...j->...i", lie.so3_right_jacobian(phi), phi_dot)
    return rot, p, v, a, w_body


def hard_trajectory(t: jnp.ndarray, period: float = 40.0):
    """Hard-mode analytic trajectory: a large loop around the room that
    revisits its start every `period` seconds (loop-closure opportunities),
    with a high-frequency rotation component (fast-rotation stress) layered
    on the look-around. Exact analytic derivatives for IMU generation.

    Returns (R_wc, p_w, v_w, a_w, w_body) like smooth_trajectory."""
    om = 2.0 * jnp.pi / period
    # circular sweep in x-z + gentle vertical bob (stays inside the room)
    p = jnp.stack([
        1.6 * jnp.sin(om * t),
        0.4 * jnp.sin(3.0 * om * t + 1.0),
        1.6 * jnp.cos(om * t) + 0.8,
    ], axis=-1)
    v = jnp.stack([
        1.6 * om * jnp.cos(om * t),
        1.2 * om * jnp.cos(3.0 * om * t + 1.0),
        -1.6 * om * jnp.sin(om * t),
    ], axis=-1)
    a = jnp.stack([
        -1.6 * om * om * jnp.sin(om * t),
        -3.6 * om * om * jnp.sin(3.0 * om * t + 1.0),
        -1.6 * om * om * jnp.cos(om * t),
    ], axis=-1)
    # yaw sweep + fast-rotation bursts (the 1.9 rad/s component peaks at
    # ~0.5 rad/s angular rate — fast for a 30 fps camera)
    phi = jnp.stack([
        0.12 * jnp.sin(0.31 * t),
        0.35 * jnp.sin(om * 2.0 * t) + 0.25 * jnp.sin(1.9 * t),
        0.06 * jnp.sin(0.21 * t),
    ], axis=-1)
    phi_dot = jnp.stack([
        0.12 * 0.31 * jnp.cos(0.31 * t),
        0.35 * 2.0 * om * jnp.cos(om * 2.0 * t) + 0.25 * 1.9 * jnp.cos(1.9 * t),
        0.06 * 0.21 * jnp.cos(0.21 * t),
    ], axis=-1)
    rot = lie.so3_exp(phi)
    w_body = jnp.einsum("...ij,...j->...i", lie.so3_right_jacobian(phi),
                        phi_dot)
    return rot, p, v, a, w_body


def contrast_schedule(t, period: float = 40.0):
    """Texture contrast multiplier in [0.12, 1]: two low-texture windows per
    loop (the hard-mode 'blank wall' segments)."""
    s = 0.5 * (1.0 + np.cos(2.0 * np.pi * 2.0 * t / period))
    return 0.12 + 0.88 * float(s) ** 6


class HardSyntheticSequence:
    """Hard-mode sequence (the standing parity benchmark in lieu of real
    datasets, PARITY.md): loop revisits every `period` s, fast-rotation
    bursts, and periodic texture-poor segments (contrast crushed towards the
    mean — depth is unaffected, so ICP/odometry paths keep information like
    on a real blank wall)."""

    def __init__(self, world: SyntheticWorld, fps: float = 30.0,
                 imu_rate: float = 200.0, period: float = 40.0):
        self.world = world
        self.fps = fps
        self.imu_rate = imu_rate
        self.period = period
        self._render = jax.jit(world.render)

    def pose_cw(self, t: float):
        rot_wc, p, *_ = hard_trajectory(jnp.asarray(t), self.period)
        rot_cw = rot_wc.T
        return rot_cw, -rot_cw @ p

    def frame(self, t: float):
        rot_cw, t_cw = self.pose_cw(t)
        gray, depth = self._render(rot_cw, t_cw)
        c = contrast_schedule(t, self.period)
        if c < 0.999:
            gray = 110.0 + (gray - 110.0) * c
        return gray, depth, (rot_cw, t_cw)

    def imu_between(self, t0: float, t1: float, max_samples: int):
        dt = 1.0 / self.imu_rate
        n = max(int(round((t1 - t0) * self.imu_rate)), 0)
        ts = t0 + (jnp.arange(max_samples) + 0.5) * dt
        rot_wb, _, _, a_w, w_body = hard_trajectory(ts, self.period)
        acc_b = jnp.einsum("sij,sj->si", jnp.swapaxes(rot_wb, -1, -2),
                           a_w - GRAVITY)
        dts = jnp.where(jnp.arange(max_samples) < n, dt, 0.0)
        return (acc_b.astype(jnp.float32), w_body.astype(jnp.float32),
                dts.astype(jnp.float32))


class SyntheticSequence:
    """Generates frames + IMU for a camera flying `smooth_trajectory`.

    Camera = IMU body (Tbc = I) for simplicity; gravity along world -z is
    consistent with GRAVITY so inertial pipelines behave as on real data.
    """

    def __init__(self, world: SyntheticWorld, fps: float = 30.0,
                 imu_rate: float = 200.0, scale: float = 1.0,
                 freq: float = 1.0):
        self.world = world
        self.fps = fps
        self.imu_rate = imu_rate
        self.scale = scale
        self.freq = freq
        self._render = jax.jit(world.render)

    def pose_cw(self, t: float):
        """Ground-truth Tcw at time t."""
        rot_wc, p, *_ = smooth_trajectory(jnp.asarray(t), self.scale,
                                          self.freq)
        rot_cw = rot_wc.T
        return rot_cw, -rot_cw @ p

    def frame(self, t: float):
        rot_cw, t_cw = self.pose_cw(t)
        gray, depth = self._render(rot_cw, t_cw)
        return gray, depth, (rot_cw, t_cw)

    def imu_between(self, t0: float, t1: float, max_samples: int):
        """Padded IMU samples in (t0, t1]: (acc [S,3], gyro [S,3], dt [S])."""
        dt = 1.0 / self.imu_rate
        n = max(int(round((t1 - t0) * self.imu_rate)), 0)
        ts = t0 + (jnp.arange(max_samples) + 0.5) * dt
        rot_wb, _, _, a_w, w_body = smooth_trajectory(ts, self.scale,
                                                      self.freq)
        acc_b = jnp.einsum("sij,sj->si", jnp.swapaxes(rot_wb, -1, -2),
                           a_w - GRAVITY)
        dts = jnp.where(jnp.arange(max_samples) < n, dt, 0.0)
        return acc_b.astype(jnp.float32), w_body.astype(jnp.float32), dts.astype(jnp.float32)


def pack_m12_jnp(gray: jnp.ndarray, depth: jnp.ndarray) -> jnp.ndarray:
    """io.feed_codec's m12 wire format built on the device: gray u8, then
    12-bit depth at 4 mm per step, two pixels in three bytes."""
    gq = jnp.clip(jnp.round(gray), 0, 255).astype(jnp.uint8)
    q = jnp.clip(jnp.round(depth / 0.004), 0, 4095).astype(jnp.uint32)
    a, b = q[:, 0::2], q[:, 1::2]
    p = jnp.stack([a & 0xFF, (a >> 8) | ((b & 0xF) << 4), b >> 4],
                  -1).astype(jnp.uint8)
    return jnp.concatenate([gq.reshape(-1), p.reshape(-1)])


def trajectory_poses(traj_fn, ts: np.ndarray, *args):
    """Host (rot_wc [N,3,3], p_w [N,3], rot_cw, t_cw) of an analytic
    trajectory at times ts, in one dispatch."""
    rot_wc, p, *_ = [np.asarray(x) for x in
                     jax.jit(traj_fn)(jnp.asarray(ts), *args)]
    rot_cw = np.swapaxes(rot_wc, -1, -2)
    t_cw = -np.einsum("nij,nj->ni", rot_cw, p)
    return rot_wc, p, rot_cw, t_cw


def imu_samples(traj_fn, ts: np.ndarray, fps: float, *args,
                imu_rate: float = 200.0, s_max: int = 32):
    """Per-frame padded IMU samples in (t_{i-1}, t_i] of an analytic
    trajectory: (acc [N,S,3], gyro [N,S,3], dts [S]), in one dispatch.
    Every frame has the same sample count, so one dts row serves all."""
    dt_imu = 1.0 / imu_rate
    tgrid = ts[:, None] - 1.0 / fps + (np.arange(s_max)[None, :] + 0.5) * dt_imu
    rot_wb, _, _, a_w, w_b = [np.asarray(x) for x in
                              jax.jit(traj_fn)(jnp.asarray(tgrid), *args)]
    acc = np.einsum("nsij,nsj->nsi", np.swapaxes(rot_wb, -1, -2),
                    a_w - GRAVITY).astype(np.float32)
    n_per = int(round(imu_rate / fps))
    dts = np.where(np.arange(s_max) < n_per, dt_imu, 0.0).astype(np.float32)
    return acc, w_b.astype(np.float32), dts


def render_sequence(world: SyntheticWorld, rot_cw: np.ndarray,
                    t_cw: np.ndarray, contrast: np.ndarray | None = None,
                    packed: bool = True, batch: int = 32) -> np.ndarray:
    """Render a pose sequence on the default device, `batch` poses per
    dispatch, into host memory: m12 buffers [N, bytes] when `packed`, else
    gray images [N, H, W] float32. `contrast` [N] crushes texture towards
    the mean like contrast_schedule."""
    n = len(rot_cw)
    if contrast is None:
        contrast = np.ones((n,), np.float32)

    def one(rot, t, c):
        g, d = world.render(rot, t)
        g = 110.0 + (g - 110.0) * c
        return pack_m12_jnp(g, d) if packed else g.astype(jnp.float32)

    fn = jax.jit(jax.vmap(one))
    out = []
    for i in range(0, n, batch):
        j = min(i + batch, n)
        pad = batch - (j - i)
        r = np.concatenate([rot_cw[i:j]] + [rot_cw[j - 1:j]] * pad)
        t = np.concatenate([t_cw[i:j]] + [t_cw[j - 1:j]] * pad)
        c = np.concatenate([contrast[i:j]] + [contrast[j - 1:j]] * pad)
        out.append(np.asarray(fn(r, t, np.asarray(c, np.float32)))[:j - i])
    return np.concatenate(out)
