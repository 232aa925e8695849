import jax
import jax.numpy as jnp
import numpy as np

from geoflowslam.math import lie
from geoflowslam.solvers import pose_opt, local_ba

FX, FY, CX, CY = 400.0, 400.0, 320.0, 240.0


def make_scene(key, n=300):
    pts = jax.random.uniform(key, (n, 3), minval=jnp.array([-3, -2, 4.0]),
                             maxval=jnp.array([3, 2, 10.0]))
    return pts


def project(rot, t, pts):
    pc = pts @ rot.T + t
    uv = pc[:, :2] / pc[:, 2:3] * FX + jnp.array([CX, CY])
    return uv, pc[:, 2]


class TestPoseOpt:
    def test_recovers_pose_mono(self):
        key = jax.random.PRNGKey(0)
        pts = make_scene(key)
        rot_gt = lie.so3_exp(jnp.array([0.05, -0.1, 0.07]))
        t_gt = jnp.array([0.3, -0.2, 0.5])
        uv, _ = project(rot_gt, t_gt, pts)
        uv = uv + jax.random.normal(jax.random.PRNGKey(1), uv.shape) * 0.3
        n = pts.shape[0]
        obs = pose_opt.PoseObs(
            pts_w=pts, uv=uv, u_right=jnp.zeros(n),
            is_stereo=jnp.zeros(n, bool), inv_sigma2=jnp.ones(n),
            valid=jnp.ones(n, bool))
        # start from a perturbed pose
        dr, dt = lie.se3_exp(jnp.array([0.1, -0.08, 0.12, 0.04, 0.06, -0.05]))
        r0, t0 = lie.se3_compose(dr, dt, rot_gt, t_gt)
        rot, t, inl, n_inl = pose_opt.pose_optimization(r0, t0, obs, FX, FY, CX, CY)
        np.testing.assert_allclose(np.asarray(rot), np.asarray(rot_gt), atol=2e-3)
        np.testing.assert_allclose(np.asarray(t), np.asarray(t_gt), atol=1.5e-2)
        assert int(n_inl) > 280

    def test_outlier_rejection(self):
        key = jax.random.PRNGKey(2)
        pts = make_scene(key)
        rot_gt, t_gt = jnp.eye(3), jnp.zeros(3)
        uv, _ = project(rot_gt, t_gt, pts)
        n = pts.shape[0]
        # 20% gross outliers
        n_out = 60
        uv = uv.at[:n_out].add(jax.random.uniform(jax.random.PRNGKey(3), (n_out, 2),
                                                  minval=30, maxval=100))
        obs = pose_opt.PoseObs(
            pts_w=pts, uv=uv, u_right=jnp.zeros(n),
            is_stereo=jnp.zeros(n, bool), inv_sigma2=jnp.ones(n),
            valid=jnp.ones(n, bool))
        dr, dt = lie.se3_exp(0.05 * jnp.ones(6))
        r0, t0 = lie.se3_compose(dr, dt, rot_gt, t_gt)
        rot, t, inl, n_inl = pose_opt.pose_optimization(r0, t0, obs, FX, FY, CX, CY)
        inl = np.asarray(inl)
        assert inl[:n_out].mean() < 0.1
        assert inl[n_out:].mean() > 0.95
        np.testing.assert_allclose(np.asarray(t), np.asarray(t_gt), atol=2e-2)

    def test_stereo_observations(self):
        key = jax.random.PRNGKey(4)
        pts = make_scene(key, 200)
        rot_gt = lie.so3_exp(jnp.array([0.02, 0.03, -0.01]))
        t_gt = jnp.array([0.1, 0.0, 0.2])
        bf = 40.0  # fx * baseline
        uv, z = project(rot_gt, t_gt, pts)
        ur = uv[:, 0] - bf / z
        n = pts.shape[0]
        obs = pose_opt.PoseObs(
            pts_w=pts, uv=uv, u_right=ur,
            is_stereo=jnp.ones(n, bool), inv_sigma2=jnp.ones(n),
            valid=jnp.ones(n, bool))
        dr, dt = lie.se3_exp(jnp.array([0.08, 0.05, -0.1, 0.03, -0.04, 0.02]))
        r0, t0 = lie.se3_compose(dr, dt, rot_gt, t_gt)
        rot, t, inl, n_inl = pose_opt.pose_optimization(r0, t0, obs, FX, FY, CX, CY, bf=bf)
        np.testing.assert_allclose(np.asarray(rot), np.asarray(rot_gt), atol=1e-3)
        np.testing.assert_allclose(np.asarray(t), np.asarray(t_gt), atol=5e-3)

    def test_prior_pulls_solution(self):
        # With few/noisy observations, a strong ICP prior should dominate.
        key = jax.random.PRNGKey(5)
        pts = make_scene(key, 50)
        rot_gt, t_gt = jnp.eye(3), jnp.zeros(3)
        uv, _ = project(rot_gt, t_gt, pts)
        uv = uv + jax.random.normal(jax.random.PRNGKey(6), uv.shape) * 3.0
        n = pts.shape[0]
        obs = pose_opt.PoseObs(
            pts_w=pts, uv=uv, u_right=jnp.zeros(n),
            is_stereo=jnp.zeros(n, bool), inv_sigma2=jnp.ones(n),
            valid=jnp.ones(n, bool))
        prior_rot, prior_t = jnp.eye(3), jnp.array([0.05, 0.0, 0.0])
        prior = pose_opt.PosePrior(rot=prior_rot, t=prior_t,
                                   info=1e6 * jnp.eye(6))
        rot, t, _, _ = pose_opt.pose_optimization(
            jnp.eye(3), jnp.zeros(3), obs, FX, FY, CX, CY, prior=prior)
        # strong prior: solution near prior pose, not the noisy visual one
        np.testing.assert_allclose(np.asarray(t), np.asarray(prior_t), atol=5e-3)


class TestLocalBA:
    def make_ba_problem(self, key, k=5, m=150, noise=0.3, perturb=True):
        kp, ks = jax.random.split(key)
        pts_gt = make_scene(kp, m)
        # K cameras along x with slight rotations
        rots, ts, uvs = [], [], []
        for i in range(k):
            phi = jnp.array([0.01 * i, -0.02 * i, 0.005 * i])
            rot = lie.so3_exp(phi)
            t = jnp.array([-0.3 * i, 0.02 * i, 0.0])
            uv, z = project(rot, t, pts_gt)
            rots.append(rot); ts.append(t); uvs.append(uv)
        kf_rot = jnp.stack(rots); kf_t = jnp.stack(ts)
        uv = jnp.stack(uvs) + jax.random.normal(ks, (k, m, 2)) * noise
        prob = local_ba.BAProblem(
            kf_rot=kf_rot, kf_t=kf_t,
            kf_fixed=jnp.zeros(k, bool).at[0].set(True).at[1].set(True),
            kf_valid=jnp.ones(k, bool),
            pts=pts_gt, pt_valid=jnp.ones(m, bool),
            uv=uv, u_right=jnp.zeros((k, m)),
            is_stereo=jnp.zeros((k, m), bool),
            inv_sigma2=jnp.ones((k, m)),
            obs_valid=jnp.ones((k, m), bool),
        )
        if perturb:
            keyp = jax.random.PRNGKey(42)
            dxi = jax.random.normal(keyp, (k, 6)) * 0.02
            dxi = dxi.at[0].set(0.0).at[1].set(0.0)  # keep fixed KFs exact
            dr, dt = lie.se3_exp(dxi)
            pr = jnp.einsum("kij,kjl->kil", dr, kf_rot)
            pt = jnp.einsum("kij,kj->ki", dr, kf_t) + dt
            dpts = jax.random.normal(jax.random.PRNGKey(43), (m, 3)) * 0.05
            prob = prob._replace(kf_rot=pr, kf_t=pt, pts=pts_gt + dpts)
        return prob, kf_rot, kf_t, pts_gt

    def test_converges_to_gt(self):
        prob, rot_gt, t_gt, pts_gt = self.make_ba_problem(jax.random.PRNGKey(7))
        out, inl = local_ba.local_bundle_adjustment(prob, FX, FY, CX, CY)
        # fixed KFs untouched
        np.testing.assert_allclose(np.asarray(out.kf_rot[0]), np.asarray(rot_gt[0]), atol=1e-6)
        np.testing.assert_allclose(np.asarray(out.kf_t[1]), np.asarray(t_gt[1]), atol=1e-6)
        # free KFs recovered
        np.testing.assert_allclose(np.asarray(out.kf_rot[2:]), np.asarray(rot_gt[2:]), atol=3e-3)
        np.testing.assert_allclose(np.asarray(out.kf_t[2:]), np.asarray(t_gt[2:]), atol=3e-2)
        # points recovered decently
        err = np.linalg.norm(np.asarray(out.pts - pts_gt), axis=1)
        assert np.median(err) < 0.03
        assert np.asarray(inl).mean() > 0.95

    def test_reduces_reprojection_error(self):
        prob, *_ = self.make_ba_problem(jax.random.PRNGKey(8), noise=0.5)
        r0, _, _, _ = local_ba._residuals(prob, FX, FY, CX, CY, 0.0)
        e0 = float(jnp.mean(jnp.sum(r0[..., :2] ** 2, axis=-1)))
        out, _ = local_ba.local_bundle_adjustment(prob, FX, FY, CX, CY)
        r1, _, _, _ = local_ba._residuals(out, FX, FY, CX, CY, 0.0)
        e1 = float(jnp.mean(jnp.sum(r1[..., :2] ** 2, axis=-1)))
        assert e1 < e0 * 0.5

    def test_padding_obs_ignored(self):
        prob, *_ = self.make_ba_problem(jax.random.PRNGKey(9))
        # corrupt invalid observations wildly; result must be unaffected
        bad_uv = prob.uv.at[:, -30:].set(9999.0)
        obs_valid = prob.obs_valid.at[:, -30:].set(False)
        pt_valid = prob.pt_valid.at[-30:].set(False)
        prob_a = prob._replace(uv=bad_uv, obs_valid=obs_valid, pt_valid=pt_valid)
        prob_b = prob._replace(obs_valid=obs_valid, pt_valid=pt_valid)
        out_a, _ = local_ba.local_bundle_adjustment(prob_a, FX, FY, CX, CY)
        out_b, _ = local_ba.local_bundle_adjustment(prob_b, FX, FY, CX, CY)
        np.testing.assert_allclose(np.asarray(out_a.kf_t), np.asarray(out_b.kf_t), atol=1e-5)
