"""Host IMU preintegration: the native C++ loop (native/imu_preint.cpp) with
a numpy twin for when the library cannot be built.

The per-KF segment preintegration is HOST work (raw host samples in, host
numpy out for build_segments / the IMU initializer). Running it as a device
program would queue it behind the frame and mapping programs and end in a
blocking read. The C++ loop does a 512-sample segment in ~10 us.

Parity of both with imu.preintegration.preintegrate is tested
(tests/test_native_preint.py)."""
from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

_LIB_PATH = os.path.join(os.path.dirname(__file__), "..", "..", "native",
                         "libgfs_native.so")
_lib = None
_checked = False

OUT_SIZE = 1 + 9 + 3 + 3 + 5 * 9 + 225  # 286


def _load():
    global _lib, _checked
    if _checked:
        return _lib
    _checked = True
    from geoflowslam.utils.native_build import ensure_native_lib
    if not ensure_native_lib(_LIB_PATH):
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
        fn = lib.gfs_preintegrate
    except (OSError, AttributeError):
        return None
    fn.restype = None
    fn.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def preintegrate_np(acc: np.ndarray, gyro: np.ndarray, dts: np.ndarray,
                    bias: np.ndarray, cov_noise: np.ndarray,
                    cov_walk: np.ndarray):
    """Returns an imu.preintegration.Preintegrated of HOST numpy arrays, or
    None when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    from geoflowslam.imu.preintegration import Preintegrated

    acc = np.ascontiguousarray(acc, np.float32)
    gyro = np.ascontiguousarray(gyro, np.float32)
    dts = np.ascontiguousarray(dts, np.float32)
    bias = np.ascontiguousarray(bias, np.float32)
    cov_noise = np.ascontiguousarray(cov_noise, np.float32)
    cov_walk = np.ascontiguousarray(cov_walk, np.float32)
    out = np.zeros((OUT_SIZE,), np.float32)
    fp = ctypes.POINTER(ctypes.c_float)
    lib.gfs_preintegrate(
        acc.ctypes.data_as(fp), gyro.ctypes.data_as(fp),
        dts.ctypes.data_as(fp), ctypes.c_int(len(dts)),
        bias.ctypes.data_as(fp), cov_noise.ctypes.data_as(fp),
        cov_walk.ctypes.data_as(fp), out.ctypes.data_as(fp))
    o = out
    i = 0

    def take(n, shape=None):
        nonlocal i
        v = o[i:i + n]
        i += n
        return v.reshape(shape) if shape else v

    dt = float(take(1)[0])
    dR = take(9, (3, 3))
    dV = take(3)
    dP = take(3)
    JRg = take(9, (3, 3))
    JVg = take(9, (3, 3))
    JVa = take(9, (3, 3))
    JPg = take(9, (3, 3))
    JPa = take(9, (3, 3))
    cov = take(225, (15, 15))
    return Preintegrated(
        dt=np.float32(dt), dR=dR, dV=dV, dP=dP, JRg=JRg, JVg=JVg, JVa=JVa,
        JPg=JPg, JPa=JPa, cov=cov, bias=bias,
        meas_acc=acc, meas_gyro=gyro, meas_dt=dts)


def _hat(v):
    return np.array([[0.0, -v[2], v[1]], [v[2], 0.0, -v[0]],
                     [-v[1], v[0], 0.0]])


def _right_jacobian(phi):
    th2 = float(phi @ phi)
    k = _hat(phi)
    if th2 < 1e-6:      # lie._EPS Taylor branch
        b, c = 0.5 - th2 / 24.0, 1.0 / 6.0 - th2 / 120.0
    else:
        th = np.sqrt(th2)
        b, c = (1.0 - np.cos(th)) / th2, (th - np.sin(th)) / (th2 * th)
    return np.eye(3) - b * k + c * (k @ k)


def _nearest_rotation(r):
    u, _, vt = np.linalg.svd(r)
    return u @ np.diag([1.0, 1.0, np.linalg.det(u @ vt)]) @ vt


def preintegrate_numpy(acc, gyro, dts, bias, cov_noise, cov_walk):
    """imu.preintegration.preintegrate as a float64 numpy loop (the native
    library's fallback): same step order, same padding rule (dt = 0 rows
    are skipped). Returns a Preintegrated of host float32 arrays."""
    from geoflowslam.imu.init_np import so3_exp_np
    from geoflowslam.imu.preintegration import Preintegrated

    acc_m = np.asarray(acc, np.float64)
    gyro_m = np.asarray(gyro, np.float64)
    dts = np.asarray(dts, np.float64)
    b = np.asarray(bias, np.float64)
    cov_n = np.asarray(cov_noise, np.float64)
    cov_w = np.asarray(cov_walk, np.float64)
    eye = np.eye(3)
    dt_tot = 0.0
    d_r, d_v, d_p = eye.copy(), np.zeros(3), np.zeros(3)
    jrg, jvg, jva, jpg, jpa = (np.zeros((3, 3)) for _ in range(5))
    cov = np.zeros((15, 15))
    for k in np.nonzero(dts > 0)[0]:
        dt = dts[k]
        dt2 = 0.5 * dt * dt
        a = acc_m[k] - b[3:]
        acc_w = d_r @ a
        r_ahat = d_r @ _hat(a)
        a_mat = np.eye(9)
        a_mat[3:6, 0:3] = -r_ahat * dt
        a_mat[6:9, 0:3] = -r_ahat * dt2
        a_mat[6:9, 3:6] = eye * dt
        b_mat = np.zeros((9, 6))
        b_mat[3:6, 3:6] = d_r * dt
        b_mat[6:9, 3:6] = d_r * dt2
        jpa = jpa + jva * dt - d_r * dt2
        jpg = jpg + jvg * dt - r_ahat @ jrg * dt2
        jva = jva - d_r * dt
        jvg = jvg - r_ahat @ jrg * dt
        phi = (gyro_m[k] - b[:3]) * dt
        d_ri = so3_exp_np(phi)
        right_j = _right_jacobian(phi)
        a_mat[0:3, 0:3] = d_ri.T
        b_mat[0:3, 0:3] = right_j * dt
        cov99 = a_mat @ cov[:9, :9] @ a_mat.T + b_mat @ cov_n @ b_mat.T
        cov_b = cov[9:, 9:] + cov_w
        cov = np.zeros((15, 15))
        cov[:9, :9] = cov99
        cov[9:, 9:] = cov_b
        jrg = d_ri.T @ jrg - right_j * dt
        d_p = d_p + d_v * dt + acc_w * dt2
        d_v = d_v + acc_w * dt
        d_r = _nearest_rotation(d_r @ d_ri)
        dt_tot += dt
    f = np.float32
    return Preintegrated(
        dt=f(dt_tot), dR=d_r.astype(f), dV=d_v.astype(f), dP=d_p.astype(f),
        JRg=jrg.astype(f), JVg=jvg.astype(f), JVa=jva.astype(f),
        JPg=jpg.astype(f), JPa=jpa.astype(f), cov=cov.astype(f),
        bias=np.asarray(bias, f), meas_acc=np.asarray(acc, f),
        meas_gyro=np.asarray(gyro, f), meas_dt=np.asarray(dts, f))


def preintegrate_host(acc, gyro, dts, bias, cov_noise, cov_walk):
    """Native preintegration when the library loads, else the numpy twin."""
    p = preintegrate_np(acc, gyro, dts, bias, cov_noise, cov_walk)
    if p is None:
        p = preintegrate_numpy(acc, gyro, dts, bias, cov_noise, cov_walk)
    return p
