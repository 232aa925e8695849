// Native IMU preintegration (host runtime component).
//
// Exact port of geoflowslam/imu/preintegration.py's scan body
// (_integrate_step), itself the JAX re-expression of
// IMU::Preintegrated::IntegrateNewMeasurement
// (/root/reference/src/ImuTypes.cc). The per-KF segment preintegration runs
// on the HOST (its inputs are raw host samples and all consumers —
// build_segments, the IMU initializer — want host numpy); as a device
// program it would queue behind the frame programs and end in a blocking
// read. This C++ loop does 512 steps in ~10 us.
//
// C ABI: see gfs_preintegrate below. Double precision internally, float
// outputs (the jax path is float32; parity-tested in
// tests/test_native_preint.py to 1e-4).

#include <cmath>
#include <cstring>

namespace {

struct M3 {
  double m[9];
};
struct V3 {
  double v[3];
};

inline M3 eye() {
  M3 r{};
  r.m[0] = r.m[4] = r.m[8] = 1.0;
  return r;
}

inline M3 matmul(const M3 &a, const M3 &b) {
  M3 r{};
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      double s = 0;
      for (int k = 0; k < 3; ++k) s += a.m[i * 3 + k] * b.m[k * 3 + j];
      r.m[i * 3 + j] = s;
    }
  return r;
}

inline V3 matvec(const M3 &a, const V3 &x) {
  V3 r{};
  for (int i = 0; i < 3; ++i)
    r.v[i] = a.m[i * 3] * x.v[0] + a.m[i * 3 + 1] * x.v[1] +
             a.m[i * 3 + 2] * x.v[2];
  return r;
}

inline M3 transpose(const M3 &a) {
  M3 r{};
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) r.m[i * 3 + j] = a.m[j * 3 + i];
  return r;
}

inline M3 scale(const M3 &a, double s) {
  M3 r{};
  for (int i = 0; i < 9; ++i) r.m[i] = a.m[i] * s;
  return r;
}

inline M3 add(const M3 &a, const M3 &b) {
  M3 r{};
  for (int i = 0; i < 9; ++i) r.m[i] = a.m[i] + b.m[i];
  return r;
}

inline M3 sub(const M3 &a, const M3 &b) {
  M3 r{};
  for (int i = 0; i < 9; ++i) r.m[i] = a.m[i] - b.m[i];
  return r;
}

inline M3 hat(const V3 &v) {
  M3 r{};
  r.m[1] = -v.v[2];
  r.m[2] = v.v[1];
  r.m[3] = v.v[2];
  r.m[5] = -v.v[0];
  r.m[6] = -v.v[1];
  r.m[7] = v.v[0];
  return r;
}

// Rodrigues with the same Taylor guard structure as lie.so3_exp.
inline M3 so3_exp(const V3 &phi) {
  double t2 = phi.v[0] * phi.v[0] + phi.v[1] * phi.v[1] + phi.v[2] * phi.v[2];
  double t = std::sqrt(t2);
  double a, b;
  if (t2 < 1e-8) {
    a = 1.0 - t2 / 6.0;
    b = 0.5 - t2 / 24.0;
  } else {
    a = std::sin(t) / t;
    b = (1.0 - std::cos(t)) / t2;
  }
  M3 k = hat(phi);
  M3 k2 = matmul(k, k);
  M3 r = eye();
  for (int i = 0; i < 9; ++i) r.m[i] += a * k.m[i] + b * k2.m[i];
  return r;
}

inline M3 so3_right_jacobian(const V3 &phi) {
  double t2 = phi.v[0] * phi.v[0] + phi.v[1] * phi.v[1] + phi.v[2] * phi.v[2];
  double t = std::sqrt(t2);
  double b, c;
  if (t2 < 1e-8) {
    b = 0.5 - t2 / 24.0;
    c = 1.0 / 6.0 - t2 / 120.0;
  } else {
    b = (1.0 - std::cos(t)) / t2;
    c = (t - std::sin(t)) / (t2 * t);
  }
  M3 k = hat(phi);
  M3 k2 = matmul(k, k);
  M3 r = eye();
  for (int i = 0; i < 9; ++i) r.m[i] += -b * k.m[i] + c * k2.m[i];
  return r;
}

// Quaternion round-trip projection onto SO(3) (IMU::NormalizeRotation /
// lie.normalize_rotation parity).
inline M3 normalize_rotation(const M3 &r) {
  double tr = r.m[0] + r.m[4] + r.m[8];
  double q[4];  // w x y z
  if (tr > 0) {
    double s = std::sqrt(tr + 1.0) * 2.0;
    q[0] = 0.25 * s;
    q[1] = (r.m[7] - r.m[5]) / s;
    q[2] = (r.m[2] - r.m[6]) / s;
    q[3] = (r.m[3] - r.m[1]) / s;
  } else if (r.m[0] > r.m[4] && r.m[0] > r.m[8]) {
    double s = std::sqrt(1.0 + r.m[0] - r.m[4] - r.m[8]) * 2.0;
    q[0] = (r.m[7] - r.m[5]) / s;
    q[1] = 0.25 * s;
    q[2] = (r.m[1] + r.m[3]) / s;
    q[3] = (r.m[2] + r.m[6]) / s;
  } else if (r.m[4] > r.m[8]) {
    double s = std::sqrt(1.0 + r.m[4] - r.m[0] - r.m[8]) * 2.0;
    q[0] = (r.m[2] - r.m[6]) / s;
    q[1] = (r.m[1] + r.m[3]) / s;
    q[2] = 0.25 * s;
    q[3] = (r.m[5] + r.m[7]) / s;
  } else {
    double s = std::sqrt(1.0 + r.m[8] - r.m[0] - r.m[4]) * 2.0;
    q[0] = (r.m[3] - r.m[1]) / s;
    q[1] = (r.m[2] + r.m[6]) / s;
    q[2] = (r.m[5] + r.m[7]) / s;
    q[3] = 0.25 * s;
  }
  double n = std::sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  for (double &x : q) x /= n;
  double w = q[0], x = q[1], y = q[2], z = q[3];
  M3 out{};
  out.m[0] = 1 - 2 * (y * y + z * z);
  out.m[1] = 2 * (x * y - w * z);
  out.m[2] = 2 * (x * z + w * y);
  out.m[3] = 2 * (x * y + w * z);
  out.m[4] = 1 - 2 * (x * x + z * z);
  out.m[5] = 2 * (y * z - w * x);
  out.m[6] = 2 * (x * z - w * y);
  out.m[7] = 2 * (y * z + w * x);
  out.m[8] = 1 - 2 * (x * x + y * y);
  return out;
}

}  // namespace

extern "C" {

// acc/gyro: [n,3] row-major, dts: [n] (dt <= 0 rows skipped), bias: [6]
// cov_noise/cov_walk: [6,6] row-major.
// out: 286 floats = dt(1) dR(9) dV(3) dP(3) JRg JVg JVa JPg JPa (9 each)
// cov(15*15).
void gfs_preintegrate(const float *acc, const float *gyro, const float *dts,
                      int n, const float *bias, const float *cov_noise,
                      const float *cov_walk, float *out) {
  double dt_tot = 0.0;
  M3 dR = eye();
  V3 dV{}, dP{};
  M3 JRg{}, JVg{}, JVa{}, JPg{}, JPa{};
  double cov9[81];  // [dR,dV,dP] block
  double covb[36];  // bias block
  std::memset(cov9, 0, sizeof(cov9));
  std::memset(covb, 0, sizeof(covb));

  const double bg0 = bias[0], bg1 = bias[1], bg2 = bias[2];
  const double ba0 = bias[3], ba1 = bias[4], ba2 = bias[5];

  for (int s = 0; s < n; ++s) {
    double dt = dts[s];
    if (!(dt > 0)) continue;
    V3 a{acc[s * 3] - ba0, acc[s * 3 + 1] - ba1, acc[s * 3 + 2] - ba2};
    V3 g{gyro[s * 3] - bg0, gyro[s * 3 + 1] - bg1, gyro[s * 3 + 2] - bg2};
    double dt2 = 0.5 * dt * dt;

    // position & velocity use the OLD dR (reference order)
    V3 aw = matvec(dR, a);
    for (int i = 0; i < 3; ++i) {
      dP.v[i] += dV.v[i] * dt + aw.v[i] * dt2;
      dV.v[i] += aw.v[i] * dt;
    }

    M3 ah = hat(a);
    M3 dRah = matmul(dR, ah);

    // A (9x9) and B (9x6) noise propagation blocks
    double A[81];
    std::memset(A, 0, sizeof(A));
    for (int i = 0; i < 9; ++i) A[i * 9 + i] = 1.0;
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        A[(3 + i) * 9 + j] = -dRah.m[i * 3 + j] * dt;   // dV wrt dR
        A[(6 + i) * 9 + j] = -dRah.m[i * 3 + j] * dt2;  // dP wrt dR
      }
    for (int i = 0; i < 3; ++i) A[(6 + i) * 9 + (3 + i)] = dt;

    double B[54];
    std::memset(B, 0, sizeof(B));
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        B[(3 + i) * 6 + (3 + j)] = dR.m[i * 3 + j] * dt;
        B[(6 + i) * 6 + (3 + j)] = dR.m[i * 3 + j] * dt2;
      }

    // bias Jacobians (reference order: JP before JV)
    M3 dRahJRg = matmul(dRah, JRg);
    for (int i = 0; i < 9; ++i) {
      JPa.m[i] += JVa.m[i] * dt - dR.m[i] * dt2;
      JPg.m[i] += JVg.m[i] * dt - dRahJRg.m[i] * dt2;
      JVa.m[i] += -dR.m[i] * dt;
      JVg.m[i] += -dRahJRg.m[i] * dt;
    }

    // rotation update
    V3 phi{g.v[0] * dt, g.v[1] * dt, g.v[2] * dt};
    M3 dRi = so3_exp(phi);
    M3 rJ = so3_right_jacobian(phi);
    M3 dRiT = transpose(dRi);
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        A[i * 9 + j] = dRiT.m[i * 3 + j];
        B[i * 6 + j] = rJ.m[i * 3 + j] * dt;
      }
    dR = normalize_rotation(matmul(dR, dRi));

    // cov9 = A cov9 A^T + B Nga B^T
    double tmp[81];
    for (int i = 0; i < 9; ++i)
      for (int j = 0; j < 9; ++j) {
        double v = 0;
        for (int k = 0; k < 9; ++k) v += A[i * 9 + k] * cov9[k * 9 + j];
        tmp[i * 9 + j] = v;
      }
    double newc[81];
    for (int i = 0; i < 9; ++i)
      for (int j = 0; j < 9; ++j) {
        double v = 0;
        for (int k = 0; k < 9; ++k) v += tmp[i * 9 + k] * A[j * 9 + k];
        newc[i * 9 + j] = v;
      }
    // + B Nga B^T (Nga is 6x6)
    double bn[54];
    for (int i = 0; i < 9; ++i)
      for (int j = 0; j < 6; ++j) {
        double v = 0;
        for (int k = 0; k < 6; ++k) v += B[i * 6 + k] * cov_noise[k * 6 + j];
        bn[i * 6 + j] = v;
      }
    for (int i = 0; i < 9; ++i)
      for (int j = 0; j < 9; ++j) {
        double v = 0;
        for (int k = 0; k < 6; ++k) v += bn[i * 6 + k] * B[j * 6 + k];
        cov9[i * 9 + j] = newc[i * 9 + j] + v;
      }
    for (int i = 0; i < 36; ++i) covb[i] += cov_walk[i];

    // JRg last (uses this step's dRi, rJ)
    M3 jr = matmul(dRiT, JRg);
    for (int i = 0; i < 9; ++i) JRg.m[i] = jr.m[i] - rJ.m[i] * dt;

    dt_tot += dt;
  }

  float *o = out;
  *o++ = static_cast<float>(dt_tot);
  for (int i = 0; i < 9; ++i) *o++ = static_cast<float>(dR.m[i]);
  for (int i = 0; i < 3; ++i) *o++ = static_cast<float>(dV.v[i]);
  for (int i = 0; i < 3; ++i) *o++ = static_cast<float>(dP.v[i]);
  const M3 *js[5] = {&JRg, &JVg, &JVa, &JPg, &JPa};
  for (const M3 *j : js)
    for (int i = 0; i < 9; ++i) *o++ = static_cast<float>(j->m[i]);
  // 15x15 cov: [0:9,0:9] = cov9, [9:15,9:15] = covb
  float cov[225];
  std::memset(cov, 0, sizeof(cov));
  for (int i = 0; i < 9; ++i)
    for (int j = 0; j < 9; ++j)
      cov[i * 15 + j] = static_cast<float>(cov9[i * 9 + j]);
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j < 6; ++j)
      cov[(9 + i) * 15 + (9 + j)] = static_cast<float>(covb[i * 6 + j]);
  std::memcpy(o, cov, sizeof(cov));
}
}
