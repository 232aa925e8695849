"""Inertial pipeline glue: per-frame preintegration, prediction, VI fusion,
and the IMU initialization state machine.

Re-expresses the inertial parts of Tracking/LocalMapping
(/root/reference/src/Tracking.cc PreintegrateIMU :1724, PredictStateIMU
:1876; src/LocalMapping.cc InitializeIMU :1552, VigInit :1804, IMUAlign
:2111) on top of the jit-compiled solvers in solvers/inertial.py.

The host keeps one Preintegrated buffer per frame gap and per KF gap
(mpImuPreintegratedFromLastKF analogue); initialization follows the
closed-form decomposition (gyro-bias GN -> linear gravity/velocity/scale
solve -> gravity alignment), which covers the reference's three IMU-init
methods' shared math (ORB-SLAM3 MAP init's first stage, VIG-Init and
IMU_INITIALIZATION are all gyro-then-gravity schemes).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from geoflowslam.math import lie
from geoflowslam.imu import preintegration as pre
from geoflowslam.solvers import inertial as VI
from geoflowslam.state import map_state as M


@dataclasses.dataclass(frozen=True)
class ImuConfig:
    freq: float = 200.0
    noise_gyro: float = 1.7e-4
    noise_acc: float = 2.0e-3
    walk_gyro: float = 1.9e-5
    walk_acc: float = 3.0e-3
    t_bc: np.ndarray = dataclasses.field(
        default_factory=lambda: np.eye(4, dtype=np.float32))
    max_samples_per_frame: int = 32
    init_min_kfs: int = 5
    init_min_time: float = 1.0
    # IMU.IMUMethod (include/System.h:112): 0 = ORB-SLAM3 MAP-style
    # (gyro GN + linear gravity/scale/velocity), 1 = VIG-Init (same
    # linear closed form), 2 = IMU_INITIALIZATION (analytic/MQH
    # accelerometer: additionally estimates the accelerometer bias
    # under the |g| constraint, methods.h:127,398)
    imu_method: int = 0

    def calib(self) -> pre.ImuCalib:
        return pre.ImuCalib.create(self.t_bc, self.noise_gyro, self.noise_acc,
                                   self.walk_gyro, self.walk_acc, self.freq)


_IDENT_PREINT = None

_INIT_W = 10   # max KF window for init / scale refinement (the reference
               # initializes over ~10 recent KFs, LocalMapping.cc:1552)


@jax.jit
def _gather_kf_states(ms: M.MapState, idx):
    """One fixed-shape dispatch packing the init window's KF states
    (rot 9, t 3, vel 3, time 1) into a [_INIT_W,16] tile for a single
    host read — the numpy init machine's only device input."""
    rot = ms.kf_rot[idx].reshape(_INIT_W, 9)
    return jnp.concatenate(
        [rot, ms.kf_t[idx], ms.kf_vel[idx],
         ms.kf_time[idx].astype(jnp.float32)[:, None]], axis=1)


@jax.jit
def _apply_imu_init(ms: M.MapState, r_wg, scale, idx, valid, vels, bias):
    """One fixed-shape dispatch applying a successful IMU init: gravity/scale
    map alignment + per-KF velocity/bias writes (ApplyScaledRotation +
    UpdateFrameIMU essence)."""
    ms = M.apply_scaled_rotation(ms, r_wg, scale)
    idx_s = jnp.where(valid, idx, ms.kf_vel.shape[0])   # OOB rows dropped
    kf_vel = ms.kf_vel.at[idx_s].set(vels, mode="drop")
    kf_bias = ms.kf_bias.at[idx_s].set(
        jnp.broadcast_to(bias, (idx_s.shape[0], 6)), mode="drop")
    return ms._replace(kf_vel=kf_vel, kf_bias=kf_bias,
                       imu_initialized=jnp.ones((), bool))


_apply_scale_rot = jax.jit(M.apply_scaled_rotation)


def _identity_preint_np():
    """Host-numpy identity Preintegrated (cached)."""
    global _IDENT_PREINT
    if _IDENT_PREINT is None:
        f = np.float32
        z3 = np.zeros((3, 3), f)
        _IDENT_PREINT = pre.Preintegrated(
            dt=np.zeros((), f), dR=np.eye(3, dtype=f), dV=np.zeros(3, f),
            dP=np.zeros(3, f), JRg=z3, JVg=z3, JVa=z3, JPg=z3, JPa=z3,
            cov=np.zeros((15, 15), f), bias=np.zeros(6, f),
            meas_acc=np.zeros((1, 3), f), meas_gyro=np.zeros((1, 3), f),
            meas_dt=np.zeros((1,), f))
    return _IDENT_PREINT


class InertialTracker:
    """Host-side inertial state: preintegration buffers + init machine."""

    def __init__(self, cfg: ImuConfig):
        self.cfg = cfg
        self.calib = cfg.calib()
        t_bc = jnp.asarray(cfg.t_bc)
        self.r_bc = t_bc[:3, :3]
        self.t_bc = t_bc[:3, 3]
        self.r_cb = self.r_bc.T
        self.t_cb = -self.r_bc.T @ self.t_bc

        self.bias = jnp.zeros(6)
        # host-numpy mirror of the bias, maintained by the fused loop from
        # its lag-delayed async read-backs; `pending` prefers it so the KF
        # preintegration never blocks on an in-flight device future
        self.bias_host: Optional[np.ndarray] = None
        self.body: Optional[VI.BodyState] = None       # state at last frame
        self.initialized = False
        # (r_wg, s) of the last applied map rescale — consumed by the
        # system to transform the recorded trajectory consistently
        self.last_transform = None
        # per-KF-slot preintegration since the previous KF
        self.kf_preints: Dict[int, pre.Preintegrated] = {}
        self.kf_order: List[int] = []                  # insertion order
        self.init_time: Optional[float] = None         # mTinit analogue
        self.viba1_done = False                        # staged refinement
        self.viba2_done = False
        self.seg_capacity = 512                        # padded KF-segment size
        self._chunks: List[tuple] = []                 # raw samples since last KF
        # constant VI-BA walk information (host; avoids a per-KF eager inv)
        self.walk_info = np.linalg.inv(
            np.asarray(self.calib.cov_walk) + 1e-12 * np.eye(6))

    _calib_np = None           # (cov, cov_walk) host mirrors

    def _preintegrate_host(self, acc, gyro, dts, bias, calib):
        """Preintegrate a KF segment on the HOST: inputs and every consumer
        (build_segments, try_initialize) are host numpy, so a device
        program would only add a blocking read. Native C++ loop, numpy
        twin when the library is missing (imu/native_preint)."""
        from geoflowslam.imu import native_preint as NP

        if self._calib_np is None:
            self._calib_np = (np.asarray(calib.cov, np.float32),
                              np.asarray(calib.cov_walk, np.float32))
        cov_n, cov_w = self._calib_np
        return NP.preintegrate_host(acc, gyro, dts,
                                    np.asarray(bias, np.float32),
                                    cov_n, cov_w)

    @property
    def pending(self):
        """Preintegration since the last KF (computed on demand at a FIXED
        padded size). Computed on the host: inputs and consumers are
        host-side (see _preintegrate_host)."""
        if not self._chunks:
            return None
        acc, gyro, dts = self._stack_chunks_np()
        bias = (self.bias_host if self.bias_host is not None
                else np.asarray(self.bias))
        return self._preintegrate_host(acc, gyro, dts, bias, self.calib)

    @pending.setter
    def pending(self, value):
        if value is None:
            self._chunks = []
        else:
            self._chunks = [(value.meas_acc, value.meas_gyro, value.meas_dt,
                             None)]

    def _stack_chunks_np(self):
        """Compact + pad the raw sample chunks to the fixed capacity (host
        numpy; chunk entries may be device arrays from the staged path)."""
        acc = np.concatenate([np.asarray(c[0]) for c in self._chunks])
        gyro = np.concatenate([np.asarray(c[1]) for c in self._chunks])
        dts = np.concatenate([np.asarray(c[2]) for c in self._chunks])
        # compact valid rows first, pad/truncate to the fixed capacity
        sel = dts > 0
        acc, gyro, dts = acc[sel], gyro[sel], dts[sel]
        cap = self.seg_capacity
        while len(dts) > cap:
            # decimate pairs: sum dts, average measurements (keeps total
            # time); an odd trailing sample is carried through unmerged.
            # Loop: one halving is not enough for very long KF gaps (lost
            # stretches, delayed KF decisions at low frame rates).
            n2 = (len(dts) // 2) * 2
            tail = slice(n2, len(dts))
            acc = np.concatenate(
                [0.5 * (acc[:n2:2] + acc[1:n2:2]), acc[tail]])
            gyro = np.concatenate(
                [0.5 * (gyro[:n2:2] + gyro[1:n2:2]), gyro[tail]])
            dts = np.concatenate([dts[:n2:2] + dts[1:n2:2], dts[tail]])
        pad = cap - len(dts)
        acc = np.pad(acc, ((0, pad), (0, 0))).astype(np.float32)
        gyro = np.pad(gyro, ((0, pad), (0, 0))).astype(np.float32)
        dts = np.pad(dts, (0, pad)).astype(np.float32)
        return acc, gyro, dts

    # -- per-frame ---------------------------------------------------------

    def preintegrate_frame(self, acc, gyro, dts,
                           timestamp=None) -> pre.Preintegrated:
        """Preintegration for the gap (last frame, this frame]. `timestamp`
        (the frame's time) tags the chunk so a later deferred KF decision
        can split the pending segment exactly at the KF frame."""
        p = pre.preintegrate(jnp.asarray(acc), jnp.asarray(gyro),
                             jnp.asarray(dts), self.bias, self.calib)
        self._chunks.append((acc, gyro, dts, timestamp))
        return p

    def predict(self, p_frame: pre.Preintegrated):
        """PredictStateIMU from the last frame's body state."""
        assert self.body is not None
        r, t, v = pre.predict_state(self.body.r_wb, self.body.p, self.body.v,
                                    p_frame, self.bias)
        return VI.BodyState(r_wb=r, p=t, v=v, bg=self.bias[:3], ba=self.bias[3:])

    def body_from_cam(self, rot_cw, t_cw, v=None):
        """Tcw -> body state (world-from-body)."""
        r_wc = rot_cw.T
        t_wc = -r_wc @ t_cw
        # T_wb = T_wc ∘ T_cb  (T_bc maps cam->body, so T_cb = T_bc^-1)
        r_wb = r_wc @ self.r_cb
        p_wb = r_wc @ self.t_cb + t_wc
        if v is None:
            v = jnp.zeros(3)
        return VI.BodyState(r_wb=r_wb, p=p_wb, v=v,
                            bg=self.bias[:3], ba=self.bias[3:])

    def cam_from_body(self, s: VI.BodyState):
        return VI.cam_pose_from_body(s, self.r_cb, self.t_cb)

    def merge_segments(self, a: pre.Preintegrated, b: pre.Preintegrated):
        """MergePrevious with fixed output capacity (decimating compaction)."""
        saved = self._chunks
        self._chunks = [(a.meas_acc, a.meas_gyro, a.meas_dt, None),
                        (b.meas_acc, b.meas_gyro, b.meas_dt, None)]
        acc, gyro, dts = self._stack_chunks_np()
        self._chunks = saved
        return self._preintegrate_host(acc, gyro, dts,
                                         np.asarray(b.bias), self.calib)

    # -- keyframe hooks ----------------------------------------------------

    def on_keyframe(self, kf_slot: int, upto_ts: Optional[float] = None):
        """Bind the pending preintegration to the new KF and reset it.

        `upto_ts` = the KF frame's timestamp: KF decisions on the fused path
        run a read-batch behind dispatch, so by decision time the chunk list
        already holds IMU samples from frames AFTER the keyframe — only
        chunks up to the KF frame belong to its segment; the rest stay
        pending for the next KF (without the split, the overshooting
        segment broke the IMU-init position constraints).

        The preintegration is computed on the host and stored as a
        HOST-numpy pytree, so this never blocks on the device queue — the per-KF
        window stacking (build_segments) is pure numpy."""
        if upto_ts is None:
            take, keep = self._chunks, []
        else:
            take = [c for c in self._chunks
                    if c[3] is None or c[3] <= upto_ts + 1e-9]
            keep = [c for c in self._chunks
                    if not (c[3] is None or c[3] <= upto_ts + 1e-9)]
        saved = self._chunks
        self._chunks = take
        p = self.pending
        self._chunks = saved
        if p is not None:
            self.kf_preints[kf_slot] = jax.tree_util.tree_map(np.asarray, p)
        self.kf_order.append(kf_slot)
        self._chunks = keep

    def contiguous_window(self, max_kfs: int):
        """Longest suffix of the KF chain where every segment has a
        preintegration, capped at max_kfs (window for vi_ba_step)."""
        chain = []
        for s in reversed(self.kf_order):
            if not chain:
                chain.append(s)
                continue
            if chain[-1] in self.kf_preints:
                chain.append(s)
            else:
                break
        return list(reversed(chain))[-max_kfs:]

    def build_segments(self, slots):
        """Stack per-KF preintegrations for a temporal window into the
        ImuSegments pytree consumed by vi_ba_step. slots: oldest-first KF
        slot list; segment i connects slots[i] -> slots[i+1]."""
        from geoflowslam.solvers.inertial_ba import ImuSegments

        n = len(slots) - 1
        fields = {k: [] for k in
                  ("dR", "dV", "dP", "JRg", "JVg", "JVa", "JPg", "JPa",
                   "info9", "walk_info", "dt", "bias0")}
        valid = []
        eye9 = np.eye(9, dtype=np.float32)
        ident = _identity_preint_np()
        for i in range(n):
            s = slots[i + 1]
            p = self.kf_preints.get(s)
            ok = p is not None and float(p.dt) > 1e-6
            if p is None:
                p = ident
            fields["dR"].append(p.dR); fields["dV"].append(p.dV)
            fields["dP"].append(p.dP); fields["JRg"].append(p.JRg)
            fields["JVg"].append(p.JVg); fields["JVa"].append(p.JVa)
            fields["JPg"].append(p.JPg); fields["JPa"].append(p.JPa)
            # covariance floor = integration noise; keeps the information
            # finite when the window is short / motion is smooth
            cov = np.asarray(p.cov)
            fields["info9"].append(np.linalg.inv(cov[:9, :9] + 1e-6 * eye9))
            # segment bias random walk: cov accumulated over the segment's
            # samples (p.cov[9:15]); per-sample cov here would be ~100x too
            # much information and wrecks f32 conditioning
            fields["walk_info"].append(
                np.linalg.inv(cov[9:15, 9:15]
                              + 1e-10 * np.eye(6, dtype=np.float32)))
            fields["dt"].append(p.dt)
            fields["bias0"].append(p.bias)
            valid.append(ok)
        return ImuSegments(
            **{k: np.stack([np.asarray(x, np.float32) for x in v])
               for k, v in fields.items()},
            valid=np.asarray(valid))

    # -- initialization ----------------------------------------------------

    def _chain_suffix(self, cap: int = _INIT_W):
        """Longest suffix of the KF chain where every segment has a
        preintegration, capped at `cap` (host bookkeeping only)."""
        chain = []
        for s in reversed(self.kf_order):
            if not chain:
                chain.append(s)
                continue
            if chain[-1] in self.kf_preints:
                chain.append(s)
            else:
                break
        return list(reversed(chain))[-cap:]

    def _gather_states_np(self, ms: M.MapState, chain):
        """Host-numpy (r_wb [n,3,3], p_wb [n,3], v_wb [n,3], times [n]) for
        the chain via ONE fixed-shape device dispatch + one read."""
        idx = np.full((_INIT_W,), chain[0], np.int32)
        idx[:len(chain)] = chain
        pkt = np.asarray(jax.device_get(
            _gather_kf_states(ms, jnp.asarray(idx))))[:len(chain)]
        rots_cw = pkt[:, :9].reshape(-1, 3, 3).astype(np.float64)
        ts_cw = pkt[:, 9:12].astype(np.float64)
        vels = pkt[:, 12:15].astype(np.float64)
        times = pkt[:, 15].astype(np.float64)
        r_cb = np.asarray(self.r_cb, np.float64)
        t_cb = np.asarray(self.t_cb, np.float64)
        r_wc = np.swapaxes(rots_cw, 1, 2)
        t_wc = -np.einsum("nij,nj->ni", r_wc, ts_cw)
        r_wb = r_wc @ r_cb
        p_wb = np.einsum("nij,j->ni", r_wc, t_cb) + t_wc
        return r_wb, p_wb, vels, times

    def scale_refinement(self, ms: M.MapState):
        """LocalMapping::ScaleRefinement (/root/reference/src/LocalMapping.cc
        :2446): after IMU init, periodically re-estimate the monocular map
        scale (+ small gravity-direction correction) against the
        preintegrated segments using the map's current velocities, and
        rescale the map when it drifted (|s-1| > 0.002 gate as the
        reference's InertialOptimization(Rwg, scale) consumer). Solved on
        the host (imu/init_np.py); one device gather + one apply."""
        from geoflowslam.imu import init_np as NI

        chain = self._chain_suffix()
        if len(chain) < 4:
            return ms
        r_wb, p_wb, v_wb, _ = self._gather_states_np(ms, chain)
        bias = (self.bias_host if self.bias_host is not None
                else np.asarray(self.bias, np.float32))
        pr = [self._preintegrate_host(
                  np.asarray(p.meas_acc), np.asarray(p.meas_gyro),
                  np.asarray(p.meas_dt), bias, self.calib)
              for p in (self.kf_preints[s] for s in chain[1:])]
        s_f, grav = NI.solve_scale_refinement_np(
            r_wb, p_wb, np.asarray([float(p.dt) for p in pr]),
            np.stack([np.asarray(p.dV) for p in pr]),
            np.stack([np.asarray(p.dP) for p in pr]), v_wb[:-1])
        if not (0.3 < s_f < 3.0):
            return ms
        if abs(s_f - 1.0) <= 0.002:
            return ms
        r_wg = NI.gravity_alignment_rotation_np(grav)
        self.last_transform = (r_wg, float(s_f))
        return _apply_scale_rot(ms, r_wg, np.float32(s_f))

    def try_initialize(self, ms: M.MapState, scale_free: bool = False):
        """InitializeIMU essence. Returns (ms, did_init).

        Runs on the HOST in numpy (imu/init_np.py): the window never exceeds
        _INIT_W KFs, and the growing-chain solves as device programs would
        recompile on every pre-init keyframe.
        Device work = one fixed-shape state gather + one fixed-shape apply."""
        from geoflowslam.imu import init_np as NI

        if self.initialized or len(self.kf_order) < self.cfg.init_min_kfs:
            return ms, False
        # longest contiguous suffix of the KF chain where every segment has
        # a preintegration (mono init inserts two KFs without one), capped
        # (the reference initializes over ~10 recent KFs; older monocular
        # KFs carry accumulated scale drift)
        chain = self._chain_suffix()
        slots = chain[1:]
        if len(slots) < self.cfg.init_min_kfs - 1:
            return ms, False
        r_wb, p_wb, _, times = self._gather_states_np(ms, chain)
        t_span = float(times[-1] - times[1])
        if t_span < self.cfg.init_min_time:
            return ms, False
        return self._solve_and_apply(ms, chain, r_wb, p_wb, scale_free)

    def reinitialize(self, ms: M.MapState, scale_free: bool = False):
        """VIBA1/VIBA2 re-initialization: the reference's staged refinement
        RE-RUNS InitializeIMU at mTinit>5 s and >10 s (priorG 1/0, priorA
        1e5/0, /root/reference/src/LocalMapping.cc:327-368) — gravity
        direction, metric scale, biases and velocities are re-solved over
        the grown KF chain with poses fixed, and the map is re-scaled. This
        is what pulls a 20-30% first-init scale error to <5%: the first
        init sees ~2 s of excitation, the re-runs see the whole window."""
        if not self.initialized:
            return ms, False
        chain = self._chain_suffix()
        if len(chain) < 4:
            return ms, False
        r_wb, p_wb, _, times = self._gather_states_np(ms, chain)
        return self._solve_and_apply(ms, chain, r_wb, p_wb, scale_free)

    def _solve_and_apply(self, ms, chain, r_wb, p_wb, scale_free):
        from geoflowslam.imu import init_np as NI
        slots = chain[1:]

        pr = [self.kf_preints[s] for s in slots]

        # 1) gyro bias
        bg = NI.solve_gyro_bias_np(
            r_wb, np.stack([np.asarray(p.dR) for p in pr]),
            np.stack([np.asarray(p.JRg) for p in pr]))
        # keep the current accelerometer bias (zero at first init; the
        # VI-BA-learned value on VIBA1/VIBA2 re-runs) unless method 2
        # re-solves it below
        ba_prev = np.asarray(self.bias_host if self.bias_host is not None
                             else self.bias, np.float32)[3:]
        new_bias = np.concatenate([bg.astype(np.float32), ba_prev])
        pr = [self._preintegrate_host(
                  np.asarray(p.meas_acc), np.asarray(p.meas_gyro),
                  np.asarray(p.meas_dt), new_bias, self.calib) for p in pr]
        dts = np.asarray([float(p.dt) for p in pr])
        dVs = np.stack([np.asarray(p.dV) for p in pr])
        dPs = np.stack([np.asarray(p.dP) for p in pr])

        # 2) gravity + velocities (+ scale for mono); method 2 also
        # estimates the accelerometer bias (analytic/MQH accelerometer)
        ba = np.zeros(3, np.float32)
        if self.cfg.imu_method == 2:
            vels, grav, ba, scale = NI.solve_accelerometer_analytic_np(
                r_wb, p_wb, dts, dVs, dPs,
                np.stack([np.asarray(p.JPa) for p in pr]),
                np.stack([np.asarray(p.JVa) for p in pr]),
                solve_scale=scale_free)
            if np.linalg.norm(ba) > 1.0:
                ba = np.zeros(3, np.float32)   # implausible: keep g/s only
        else:
            vels, grav, scale = NI.solve_gravity_scale_velocities_np(
                r_wb, p_wb, dts, dVs, dPs, solve_scale=scale_free)
        g_norm = float(np.linalg.norm(grav))
        if not (7.0 < g_norm < 12.0):
            return ms, False  # bad init; retry later
        if scale_free and not (0.05 < float(scale) < 20.0):
            return ms, False
        # consistency gate: the solved (v, g, s) must actually explain the
        # position constraints (guards against degenerate mono excitation)
        resid, mags = [], []
        for i, p in enumerate(pr):
            dt = dts[i]
            lhs = float(scale) * (p_wb[i + 1] - p_wb[i])
            rhs = vels[i] * dt + 0.5 * grav * dt * dt + r_wb[i] @ dPs[i]
            resid.append(float(np.linalg.norm(lhs - rhs)))
            mags.append(float(np.linalg.norm(lhs)) + 1e-3)
        if np.median(resid) > 0.15 * np.median(mags) + 0.02:
            return ms, False

        # 3) align gravity to -z and rescale the map (one device apply).
        # Velocities from the linear solve are already METRIC; they only
        # rotate with the gravity alignment.
        r_wg = NI.gravity_alignment_rotation_np(grav)
        vels_aligned = (vels @ r_wg.T.astype(np.float64)).astype(np.float32)
        if self.cfg.imu_method == 2:
            new_bias = np.concatenate([new_bias[:3], ba])
        idx = np.full((_INIT_W,), self.seg_capacity, np.int32)
        valid = np.zeros((_INIT_W,), bool)
        idx[:len(chain)] = chain
        valid[:len(chain)] = True
        vels_p = np.zeros((_INIT_W, 3), np.float32)
        vels_p[:len(chain)] = vels_aligned
        ms = _apply_imu_init(ms, r_wg, np.float32(scale),
                             jnp.asarray(idx), jnp.asarray(valid),
                             jnp.asarray(vels_p),
                             jnp.asarray(new_bias, jnp.float32))
        self.last_transform = (r_wg, float(scale))
        self.bias = np.asarray(new_bias, np.float32)
        self.bias_host = np.asarray(new_bias, np.float32)
        self.initialized = True
        # current body state must be re-derived by the caller from the
        # (re-aligned) camera pose; velocity from the last KF
        return ms, True
