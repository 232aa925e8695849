"""On-manifold IMU preintegration as a jit-compiled scan.

JAX replacement for IMU::Preintegrated
(/root/reference/src/ImuTypes.cc, include/ImuTypes.h:146-278): the reference
integrates measurements one at a time inside Tracking::PreintegrateIMU
(/root/reference/src/Tracking.cc:1724+); here the whole inter-frame batch is a
single `lax.scan` over a fixed-capacity padded measurement buffer, producing
identical quantities:

* delta rotation/velocity/position  dR, dV, dP
* bias Jacobians  JRg, JVg, JVa, JPg, JPa
* 15x15 covariance C of [dR, dV, dP, bg, ba] (noise + bias random walk)

Semantics follow the reference exactly: per-step midpoint position update
``dP += dV*dt + 0.5*a*dt^2``, then velocity, then rotation composed on the
right; covariance propagated with the same A/B matrices
(src/ImuTypes.cc IntegrateNewMeasurement).

Measurements between two frames are stored padded to ``MAX_IMU_PER_SEG`` with
a validity mask so the scan has a static shape (dt = 0 steps are identity).
"""
from __future__ import annotations

from typing import NamedTuple

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from geoflowslam.math import lie

GRAVITY = np.array([0.0, 0.0, -9.81], np.float32)  # IMU::GRAVITY_VALUE, ImuTypes.h (host const)


class ImuCalib(NamedTuple):
    """IMU::Calib (include/ImuTypes.h:99-135): body<->cam extrinsics + noise."""
    r_bc: jnp.ndarray       # [3,3] rotation cam->body (Tbc)
    t_bc: jnp.ndarray       # [3]
    cov: jnp.ndarray        # [6,6] gyro/acc white-noise covariance (Nga)
    cov_walk: jnp.ndarray   # [6,6] bias random-walk covariance (NgaWalk)

    @staticmethod
    def create(t_bc_mat, noise_gyro, noise_acc, walk_gyro, walk_acc, freq):
        sf = jnp.sqrt(jnp.asarray(freq, jnp.float32))
        ng, na = noise_gyro * sf, noise_acc * sf
        wg, wa = walk_gyro / sf, walk_acc / sf
        cov = jnp.diag(jnp.array([ng * ng] * 3 + [na * na] * 3, jnp.float32))
        cov_walk = jnp.diag(jnp.array([wg * wg] * 3 + [wa * wa] * 3, jnp.float32))
        t_bc_mat = jnp.asarray(t_bc_mat, jnp.float32)
        return ImuCalib(t_bc_mat[:3, :3], t_bc_mat[:3, 3], cov, cov_walk)


class Preintegrated(NamedTuple):
    """Functional equivalent of IMU::Preintegrated state."""
    dt: jnp.ndarray          # [] total time
    dR: jnp.ndarray          # [3,3]
    dV: jnp.ndarray          # [3]
    dP: jnp.ndarray          # [3]
    JRg: jnp.ndarray         # [3,3] d(dR)/d(bias_gyro)
    JVg: jnp.ndarray         # [3,3]
    JVa: jnp.ndarray         # [3,3]
    JPg: jnp.ndarray         # [3,3]
    JPa: jnp.ndarray         # [3,3]
    cov: jnp.ndarray         # [15,15]
    bias: jnp.ndarray        # [6] (bg, ba) used during integration
    # raw measurements kept for reintegration (Reintegrate, ImuTypes.h:189)
    meas_acc: jnp.ndarray    # [MAX, 3]
    meas_gyro: jnp.ndarray   # [MAX, 3]
    meas_dt: jnp.ndarray     # [MAX]

    @staticmethod
    def identity(max_meas: int, bias=None, dtype=jnp.float32):
        eye = jnp.eye(3, dtype=dtype)
        zero3 = jnp.zeros((3, 3), dtype=dtype)
        if bias is None:
            bias = jnp.zeros(6, dtype=dtype)
        return Preintegrated(
            dt=jnp.zeros((), dtype),
            dR=eye, dV=jnp.zeros(3, dtype), dP=jnp.zeros(3, dtype),
            JRg=zero3, JVg=zero3, JVa=zero3, JPg=zero3, JPa=zero3,
            cov=jnp.zeros((15, 15), dtype), bias=bias,
            meas_acc=jnp.zeros((max_meas, 3), dtype),
            meas_gyro=jnp.zeros((max_meas, 3), dtype),
            meas_dt=jnp.zeros((max_meas,), dtype),
        )


def _integrate_step(carry, inputs, cov_noise, cov_walk, bias):
    """One IntegrateNewMeasurement step (src/ImuTypes.cc)."""
    dt_tot, dR, dV, dP, JRg, JVg, JVa, JPg, JPa, cov = carry
    acc_m, gyro_m, dt = inputs
    valid = dt > 0

    bg, ba = bias[:3], bias[3:]
    acc = acc_m - ba
    gyro = gyro_m - bg

    dt1 = jnp.where(valid, dt, 0.0)
    dt2 = 0.5 * dt1 * dt1

    # Position & velocity use the *old* dR (reference order).
    acc_w = dR @ acc
    dP_new = dP + dV * dt1 + acc_w * dt2
    dV_new = dV + acc_w * dt1

    acc_hat = lie.hat(acc)
    # A/B for [dR, dV, dP] 9x9 noise propagation
    a_mat = jnp.eye(9, dtype=dR.dtype)
    a_mat = a_mat.at[3:6, 0:3].set(-dR @ acc_hat * dt1)
    a_mat = a_mat.at[6:9, 0:3].set(-dR @ acc_hat * dt2)
    a_mat = a_mat.at[6:9, 3:6].set(jnp.eye(3, dtype=dR.dtype) * dt1)

    b_mat = jnp.zeros((9, 6), dtype=dR.dtype)
    b_mat = b_mat.at[3:6, 3:6].set(dR * dt1)
    b_mat = b_mat.at[6:9, 3:6].set(dR * dt2)

    # Jacobians wrt bias (reference order: JP before JV before JR update)
    JPa_new = JPa + JVa * dt1 - dR * dt2
    JPg_new = JPg + JVg * dt1 - (dR @ acc_hat) @ JRg * dt2
    JVa_new = JVa - dR * dt1
    JVg_new = JVg - (dR @ acc_hat) @ JRg * dt1

    # Rotation update
    phi = gyro * dt1
    dRi = lie.so3_exp(phi)
    rightJ = lie.so3_right_jacobian(phi)
    dR_new = lie.normalize_rotation(dR @ dRi)
    a_mat = a_mat.at[0:3, 0:3].set(dRi.T)
    b_mat = b_mat.at[0:3, 0:3].set(rightJ * dt1)

    cov99 = a_mat @ cov[:9, :9] @ a_mat.T + b_mat @ cov_noise @ b_mat.T
    cov_bias = cov[9:15, 9:15] + cov_walk
    cov_new = (
        jnp.zeros_like(cov).at[:9, :9].set(cov99).at[9:15, 9:15].set(cov_bias)
    )

    JRg_new = dRi.T @ JRg - rightJ * dt1

    new_carry = (
        dt_tot + dt1,
        jnp.where(valid, dR_new, dR),
        jnp.where(valid, dV_new, dV),
        jnp.where(valid, dP_new, dP),
        jnp.where(valid, JRg_new, JRg),
        jnp.where(valid, JVg_new, JVg),
        jnp.where(valid, JVa_new, JVa),
        jnp.where(valid, JPg_new, JPg),
        jnp.where(valid, JPa_new, JPa),
        jnp.where(valid, cov_new, cov),
    )
    return new_carry, None


@jax.jit
def preintegrate(acc: jnp.ndarray, gyro: jnp.ndarray, dts: jnp.ndarray,
                 bias: jnp.ndarray, calib: ImuCalib) -> Preintegrated:
    """Integrate a padded batch of IMU samples.

    Args:
      acc, gyro: [MAX, 3] measurements; rows with dts == 0 are ignored.
      dts: [MAX] per-sample integration intervals (0 = padding).
      bias: [6] (bg, ba).
      calib: ImuCalib with noise covariances.
    """
    dtype = acc.dtype
    init = (
        jnp.zeros((), dtype), jnp.eye(3, dtype=dtype), jnp.zeros(3, dtype),
        jnp.zeros(3, dtype), jnp.zeros((3, 3), dtype), jnp.zeros((3, 3), dtype),
        jnp.zeros((3, 3), dtype), jnp.zeros((3, 3), dtype), jnp.zeros((3, 3), dtype),
        jnp.zeros((15, 15), dtype),
    )

    def step(carry, inputs):
        return _integrate_step(carry, inputs, calib.cov, calib.cov_walk, bias)

    carry, _ = jax.lax.scan(step, init, (acc, gyro, dts))
    dt_tot, dR, dV, dP, JRg, JVg, JVa, JPg, JPa, cov = carry
    return Preintegrated(
        dt=dt_tot, dR=dR, dV=dV, dP=dP, JRg=JRg, JVg=JVg, JVa=JVa,
        JPg=JPg, JPa=JPa, cov=cov, bias=bias,
        meas_acc=acc, meas_gyro=gyro, meas_dt=dts,
    )


def reintegrate(p: Preintegrated, new_bias: jnp.ndarray, calib: ImuCalib) -> Preintegrated:
    """IMU::Preintegrated::Reintegrate with an updated bias."""
    return preintegrate(p.meas_acc, p.meas_gyro, p.meas_dt, new_bias, calib)


# --- bias-corrected deltas (GetDeltaRotation/Velocity/Position(Bias), ---
# --- include/ImuTypes.h:194-200) ----------------------------------------

def delta_rotation(p: Preintegrated, bias: jnp.ndarray) -> jnp.ndarray:
    dbg = bias[:3] - p.bias[:3]
    return lie.normalize_rotation(p.dR @ lie.so3_exp(p.JRg @ dbg))


def delta_velocity(p: Preintegrated, bias: jnp.ndarray) -> jnp.ndarray:
    dbg, dba = bias[:3] - p.bias[:3], bias[3:] - p.bias[3:]
    return p.dV + p.JVg @ dbg + p.JVa @ dba


def delta_position(p: Preintegrated, bias: jnp.ndarray) -> jnp.ndarray:
    dbg, dba = bias[:3] - p.bias[:3], bias[3:] - p.bias[3:]
    return p.dP + p.JPg @ dbg + p.JPa @ dba


@partial(jax.jit, static_argnames=())
def _predict_state_jit(rot_wb1, t_wb1, v1, p, bias, gravity):
    return _predict_state_impl(rot_wb1, t_wb1, v1, p, bias, gravity)


def predict_state(rot_wb1, t_wb1, v1, p: Preintegrated, bias: jnp.ndarray,
                  gravity=GRAVITY):
    return _predict_state_jit(rot_wb1, t_wb1, v1, p, bias,
                              jnp.asarray(gravity, jnp.float32))


def _predict_state_impl(rot_wb1, t_wb1, v1, p: Preintegrated, bias: jnp.ndarray,
                  gravity=GRAVITY):
    """IMU state propagation (Tracking::PredictStateIMU,
    /root/reference/src/Tracking.cc:1876-1941): world-from-body at frame 2."""
    dt = p.dt
    dR = delta_rotation(p, bias)
    dV = delta_velocity(p, bias)
    dP = delta_position(p, bias)
    rot_wb2 = lie.normalize_rotation(rot_wb1 @ dR)
    t_wb2 = t_wb1 + v1 * dt + 0.5 * gravity * dt * dt + rot_wb1 @ dP
    v2 = v1 + gravity * dt + rot_wb1 @ dV
    return rot_wb2, t_wb2, v2


def merge_previous(prev: Preintegrated, cur: Preintegrated, calib: ImuCalib) -> Preintegrated:
    """IMU::Preintegrated::MergePrevious: concatenate prev's measurements in
    front of cur's and reintegrate with cur's bias. Padded: both buffers must
    have the same MAX; result keeps 2*MAX capacity truncation-free by
    compacting valid rows first."""
    acc = jnp.concatenate([prev.meas_acc, cur.meas_acc], axis=0)
    gyro = jnp.concatenate([prev.meas_gyro, cur.meas_gyro], axis=0)
    dts = jnp.concatenate([prev.meas_dt, cur.meas_dt], axis=0)
    # Stable-compact valid rows to the front (order preserved).
    order = jnp.argsort(jnp.where(dts > 0, 0, 1), stable=True)
    return preintegrate(acc[order], gyro[order], dts[order], cur.bias, calib)
