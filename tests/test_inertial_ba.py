import jax
import jax.numpy as jnp
import numpy as np

from geoflowslam.math import lie
from geoflowslam.imu import preintegration as pre
from geoflowslam.solvers import inertial_ba as VIBA
from geoflowslam.solvers.local_ba import BAProblem
from geoflowslam.io.synthetic import smooth_trajectory, GRAVITY

FX, FY, CX, CY = 400.0, 400.0, 320.0, 240.0


def make_calib():
    return pre.ImuCalib.create(np.eye(4, dtype=np.float32), 1.7e-4, 2e-3,
                               1.9e-5, 3e-3, 200.0)


def imu_seg(t0, t1, rate=200.0, max_s=64):
    dt = 1.0 / rate
    n = int(round((t1 - t0) * rate))
    ts = t0 + (jnp.arange(max_s) + 0.5) * dt
    rot_wb, p, v, a_w, w_body = smooth_trajectory(ts)
    acc = jnp.einsum("sij,sj->si", jnp.swapaxes(rot_wb, -1, -2), a_w - GRAVITY)
    dts = jnp.where(jnp.arange(max_s) < n, dt, 0.0)
    return acc.astype(jnp.float32), w_body.astype(jnp.float32), dts


def test_vi_local_ba_converges():
    calib = make_calib()
    k = 5
    times = [0.5 + 0.2 * i for i in range(k)]
    # ground-truth body=cam states
    rots_wb, ps, vs = [], [], []
    for t in times:
        r, p, v, *_ = smooth_trajectory(jnp.asarray(t))
        rots_wb.append(r); ps.append(p); vs.append(v)
    # camera poses Tcw (body == cam)
    kf_rot = jnp.stack([r.T for r in rots_wb])
    kf_t = jnp.stack([-rots_wb[i].T @ ps[i] for i in range(k)])

    # landmarks + observations
    key = jax.random.PRNGKey(0)
    m = 120
    pts = jax.random.uniform(key, (m, 3), minval=jnp.array([-2, -2, 2.5]),
                             maxval=jnp.array([2, 2, 7.0]))
    pc = jnp.einsum("kij,mj->kmi", kf_rot, pts) + kf_t[:, None, :]
    uv = pc[..., :2] / pc[..., 2:3] * FX + jnp.array([CX, CY])
    uv = uv + jax.random.normal(jax.random.PRNGKey(1), uv.shape) * 0.3

    # preintegrated segments
    segs = []
    for i in range(k - 1):
        acc, gyro, dts = imu_seg(times[i], times[i + 1])
        segs.append(pre.preintegrate(acc, gyro, dts, jnp.zeros(6), calib))
    seg = VIBA.ImuSegments(
        dR=jnp.stack([s.dR for s in segs]),
        dV=jnp.stack([s.dV for s in segs]),
        dP=jnp.stack([s.dP for s in segs]),
        JRg=jnp.stack([s.JRg for s in segs]),
        JVg=jnp.stack([s.JVg for s in segs]),
        JVa=jnp.stack([s.JVa for s in segs]),
        JPg=jnp.stack([s.JPg for s in segs]),
        JPa=jnp.stack([s.JPa for s in segs]),
        # small covariance floor = integration/discretization noise; without
        # it the noise-free synthetic IMU gets ~1e8 information and its
        # midpoint-rule bias (~mm) overwhelms the visual terms
        info9=jnp.stack([jnp.linalg.inv(s.cov[:9, :9] + 1e-6 * jnp.eye(9))
                         for s in segs]),
        walk_info=jnp.stack([jnp.linalg.inv(s.cov[9:15, 9:15] + 1e-10 * jnp.eye(6))
                             for s in segs]),
        dt=jnp.stack([s.dt for s in segs]),
        bias0=jnp.stack([s.bias for s in segs]),
        valid=jnp.ones(k - 1, bool))

    # perturb states (not the first, fixed)
    keyp = jax.random.PRNGKey(2)
    dxi = jax.random.normal(keyp, (k, 6)) * 0.01
    dxi = dxi.at[0].set(0.0)
    dr, dt_ = lie.se3_exp(dxi)
    pert_rot = jnp.einsum("kij,kjl->kil", dr, kf_rot)
    pert_t = jnp.einsum("kij,kj->ki", dr, kf_t) + dt_
    pert_vel = jnp.stack(vs) + jax.random.normal(jax.random.PRNGKey(3), (k, 3)) * 0.05
    pert_pts = pts + jax.random.normal(jax.random.PRNGKey(4), (m, 3)) * 0.02

    vis = BAProblem(
        kf_rot=pert_rot, kf_t=pert_t,
        kf_fixed=jnp.zeros(k, bool).at[0].set(True),
        kf_valid=jnp.ones(k, bool),
        pts=pert_pts, pt_valid=jnp.ones(m, bool),
        uv=uv, u_right=jnp.zeros((k, m)), is_stereo=jnp.zeros((k, m), bool),
        inv_sigma2=jnp.ones((k, m)), obs_valid=jnp.ones((k, m), bool))
    prob = VIBA.VIBAProblem(
        vis=vis, kf_vel=pert_vel, kf_bias=jnp.zeros((k, 6)),
        segs=seg, r_cb=jnp.eye(3), t_cb=jnp.zeros(3),
        walk_info=jnp.linalg.inv(calib.cov_walk + 1e-12 * jnp.eye(6)))

    out, inl = VIBA.vi_local_ba(prob, FX, FY, CX, CY)

    # absolute positions have a radial near-null gauge around the single
    # fixed KF (same as the reference's LocalInertialBA); judge RELATIVE
    # inter-KF transforms, which vision+IMU fully determine.
    def rel(rot, t, i):
        ri, ti = rot[i], t[i]
        rj, tj = rot[i + 1], t[i + 1]
        rr = ri @ rj.T
        tt = ti - rr @ tj
        return np.asarray(rr), np.asarray(tt)

    for i in range(k - 1):
        r_gt, t_gt_rel = rel(np.asarray(kf_rot), np.asarray(kf_t), i)
        r_es, t_es_rel = rel(np.asarray(out.vis.kf_rot), np.asarray(out.vis.kf_t), i)
        np.testing.assert_allclose(r_es, r_gt, atol=5e-3)
        np.testing.assert_allclose(t_es_rel, t_gt_rel, atol=1.5e-2)

    v_gt = np.stack([np.asarray(v) for v in vs])
    # velocities share the same gauge; compare relative changes
    dv_gt = np.diff(v_gt, axis=0)
    dv_es = np.diff(np.asarray(out.kf_vel), axis=0)
    np.testing.assert_allclose(dv_es, dv_gt, atol=0.05)
    assert float(np.asarray(inl).mean()) > 0.9
