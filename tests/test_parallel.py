"""Distributed BA over the virtual 8-device CPU mesh."""
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from geoflowslam.math import lie
from geoflowslam.parallel import dist_ba
from geoflowslam.solvers import local_ba

FX, FY, CX, CY = 400.0, 400.0, 320.0, 240.0


def make_problem(key, k=5, m=256):
    kp, ks, kn = jax.random.split(key, 3)
    pts_gt = jax.random.uniform(kp, (m, 3), minval=jnp.array([-3, -2, 4.0]),
                                maxval=jnp.array([3, 2, 10.0]))
    rots, ts, uvs = [], [], []
    for i in range(k):
        rot = lie.so3_exp(jnp.array([0.01 * i, -0.02 * i, 0.005 * i]))
        t = jnp.array([-0.3 * i, 0.02 * i, 0.0])
        pc = pts_gt @ rot.T + t
        uv = pc[:, :2] / pc[:, 2:3] * FX + jnp.array([CX, CY])
        rots.append(rot); ts.append(t); uvs.append(uv)
    uv = jnp.stack(uvs) + jax.random.normal(kn, (k, m, 2)) * 0.3
    prob = local_ba.BAProblem(
        kf_rot=jnp.stack(rots), kf_t=jnp.stack(ts),
        kf_fixed=jnp.zeros(k, bool).at[0].set(True).at[1].set(True),
        kf_valid=jnp.ones(k, bool),
        pts=pts_gt + jax.random.normal(ks, (m, 3)) * 0.05,
        pt_valid=jnp.ones(m, bool),
        uv=uv, u_right=jnp.zeros((k, m)), is_stereo=jnp.zeros((k, m), bool),
        inv_sigma2=jnp.ones((k, m)), obs_valid=jnp.ones((k, m), bool),
    )
    # perturb free poses
    dxi = jax.random.normal(jax.random.PRNGKey(9), (k, 6)) * 0.02
    dxi = dxi.at[0].set(0.0).at[1].set(0.0)
    dr, dt = lie.se3_exp(dxi)
    prob = prob._replace(
        kf_rot=jnp.einsum("kij,kjl->kil", dr, prob.kf_rot),
        kf_t=jnp.einsum("kij,kj->ki", dr, prob.kf_t) + dt)
    return prob, jnp.stack(rots), jnp.stack(ts), pts_gt


def test_distributed_ba_8dev():
    devs = jax.devices()
    assert len(devs) == 8, devs
    mesh = Mesh(np.array(devs), axis_names=("land",))
    prob, rot_gt, t_gt, pts_gt = make_problem(jax.random.PRNGKey(0))
    fn = dist_ba.make_distributed_ba(mesh, FX, FY, CX, CY, iters=12)
    out = fn(prob)
    np.testing.assert_allclose(np.asarray(out.kf_rot[2:]), np.asarray(rot_gt[2:]), atol=3e-3)
    np.testing.assert_allclose(np.asarray(out.kf_t[2:]), np.asarray(t_gt[2:]), atol=3e-2)
    err = np.linalg.norm(np.asarray(out.pts - pts_gt), axis=1)
    assert np.median(err) < 0.03


def test_distributed_matches_single_device():
    devs = jax.devices()
    mesh = Mesh(np.array(devs), axis_names=("land",))
    prob, *_ = make_problem(jax.random.PRNGKey(1))
    fn = dist_ba.make_distributed_ba(mesh, FX, FY, CX, CY, iters=5)
    out_d = fn(prob)
    mesh1 = Mesh(np.array(devs[:1]), axis_names=("land",))
    fn1 = dist_ba.make_distributed_ba(mesh1, FX, FY, CX, CY, iters=5)
    out_1 = fn1(prob)
    np.testing.assert_allclose(np.asarray(out_d.kf_t), np.asarray(out_1.kf_t),
                               rtol=1e-3, atol=1e-4)


def test_distributed_global_ba_in_system():
    """global_ba_step_distributed over the 8-device mesh on a populated map."""
    import jax.numpy as jnp
    from geoflowslam.state import map_state as M
    from geoflowslam.pipeline import local_mapping as LM

    devs = jax.devices()
    mesh = Mesh(np.array(devs), axis_names=("land",))
    ms = M.create(8, 128, 1024)
    # two KFs observing 100 shared points
    key = jax.random.PRNGKey(0)
    pts = jax.random.uniform(key, (128, 3), minval=jnp.array([-2, -2, 3.0]),
                             maxval=jnp.array([2, 2, 8.0]))
    for slot, tx in [(0, 0.0), (1, -0.3), (2, -0.6)]:
        rot = jnp.eye(3)
        t = jnp.array([tx, 0, 0])
        pc = pts @ rot.T + t
        uv = pc[:, :2] / pc[:, 2:3] * 400.0 + jnp.array([320.0, 240.0])
        ms = M.insert_keyframe(
            ms, jnp.int32(slot), rot, t, jnp.zeros(3), jnp.zeros(6),
            jnp.float32(slot * 1.0), uv, jnp.zeros(128, jnp.int32),
            jnp.zeros(128), jnp.ones((128, 8), jnp.uint32),
            jnp.full((128,), -1.0), jnp.ones(128, bool),
            jnp.arange(128, dtype=jnp.int32), jnp.int32(slot - 1))
    ms = M.add_map_points(ms, jnp.arange(128, dtype=jnp.int32),
                          pts + 0.02, jnp.ones((128, 8), jnp.uint32),
                          jnp.zeros((128, 3)), jnp.zeros(128),
                          jnp.full((128,), 100.0), jnp.int32(0),
                          jnp.ones(128, bool))
    mcfg = LM.MappingConfig()
    out = LM.global_ba_step_distributed(ms, mcfg, mesh, ba_pts=256, iters=6)
    err = np.linalg.norm(np.asarray(out.mp_pos[:128] - pts), axis=1)
    assert np.median(err) < 0.01, np.median(err)
