"""Parity of the host preintegrators (native C++ and its numpy twin) vs the
jitted JAX scan."""
import numpy as np
import pytest

from geoflowslam.imu import native_preint as NP
from geoflowslam.imu import preintegration as pre
from geoflowslam.pipeline.inertial import ImuConfig


@pytest.mark.skipif(not NP.available(), reason="native lib not built")
def test_native_preintegrate_matches_jax():
    _check_matches_jax(NP.preintegrate_np)


def test_numpy_preintegrate_matches_jax():
    _check_matches_jax(NP.preintegrate_numpy)


def _check_matches_jax(impl):
    cfg = ImuConfig()
    calib = cfg.calib()
    rng = np.random.RandomState(3)
    n = 200
    acc = (np.array([0, 0, 9.81]) + 0.5 * rng.randn(n, 3)).astype(np.float32)
    gyro = (0.3 * rng.randn(n, 3)).astype(np.float32)
    dts = np.full((n,), 0.005, np.float32)
    dts[150:] = 0.0                      # padded tail must be skipped
    bias = np.array([0.01, -0.02, 0.005, 0.1, -0.05, 0.02], np.float32)

    ref = pre.preintegrate(acc, gyro, dts, bias, calib)
    got = impl(acc, gyro, dts, bias, np.asarray(calib.cov),
               np.asarray(calib.cov_walk))

    np.testing.assert_allclose(float(got.dt), float(ref.dt), atol=1e-5)
    for f in ("dR", "dV", "dP", "JRg", "JVg", "JVa", "JPg", "JPa"):
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(ref, f))
        np.testing.assert_allclose(a, b, atol=2e-4, rtol=2e-3, err_msg=f)
    # covariance: tiny magnitudes; compare with a scale-aware tolerance
    ca, cb = np.asarray(got.cov), np.asarray(ref.cov)
    scale = max(np.abs(cb).max(), 1e-12)
    assert np.abs(ca - cb).max() / scale < 5e-3


@pytest.mark.skipif(not NP.available(), reason="native lib not built")
def test_native_preintegrate_identity_on_empty():
    _check_identity_on_empty(NP.preintegrate_np)


def test_numpy_preintegrate_identity_on_empty():
    _check_identity_on_empty(NP.preintegrate_numpy)


def _check_identity_on_empty(impl):
    cfg = ImuConfig()
    calib = cfg.calib()
    z3 = np.zeros((8, 3), np.float32)
    z = np.zeros((8,), np.float32)
    p = impl(z3, z3, z, np.zeros(6, np.float32), np.asarray(calib.cov),
             np.asarray(calib.cov_walk))
    np.testing.assert_allclose(p.dR, np.eye(3), atol=1e-7)
    assert float(p.dt) == 0.0
    np.testing.assert_allclose(p.cov, 0.0, atol=1e-12)
