import jax
import jax.numpy as jnp
import numpy as np

from geoflowslam.math import lie
from geoflowslam.ops import pointcloud as pc
from geoflowslam.ops import gicp


def make_room_cloud(key, n=2000):
    """Points on three orthogonal walls of a room (plane-rich, GICP-friendly)."""
    k1, k2, k3 = jax.random.split(key, 3)
    a = jax.random.uniform(k1, (n // 3, 2), minval=0.0, maxval=4.0)
    wall1 = jnp.stack([a[:, 0], a[:, 1], jnp.zeros(n // 3)], axis=1)          # z=0
    wall2 = jnp.stack([a[:, 0], jnp.zeros(n // 3), a[:, 1]], axis=1)          # y=0
    wall3 = jnp.stack([jnp.zeros(n - 2 * (n // 3)),
                       jax.random.uniform(k2, (n - 2 * (n // 3),)) * 4,
                       jax.random.uniform(k3, (n - 2 * (n // 3),)) * 4], axis=1)
    return jnp.concatenate([wall1, wall2, wall3], axis=0)


class TestCloudOps:
    def test_depth_to_cloud(self):
        depth = jnp.full((48, 64), 2.0)
        pts, mask = pc.depth_to_cloud(depth, 50.0, 50.0, 32.0, 24.0, stride=2)
        assert pts.shape == (24 * 32, 3)
        assert bool(mask.all())
        np.testing.assert_allclose(np.asarray(pts[:, 2]), 2.0)
        # out-of-range depths masked
        depth2 = depth.at[0, 0].set(0.0).at[0, 2].set(50.0)
        _, mask2 = pc.depth_to_cloud(depth2, 50.0, 50.0, 32.0, 24.0, stride=2)
        assert not bool(mask2[0]) and not bool(mask2[1])

    def test_voxel_downsample(self):
        key = jax.random.PRNGKey(0)
        pts = jax.random.uniform(key, (500, 3)) * 1.0
        out, valid = pc.voxel_downsample(pts, jnp.ones(500, bool), 0.25, 256)
        n = int(valid.sum())
        assert 0 < n <= 4 * 4 * 4 + 10
        # no two kept points share a voxel
        kept = np.asarray(out)[np.asarray(valid)]
        vox = np.floor(kept / 0.25).astype(int)
        keys = {tuple(v) for v in vox}
        assert len(keys) == len(vox)

    def test_knn(self):
        pts = jnp.array([[0.0, 0, 0], [1, 0, 0], [0.1, 0, 0], [5, 5, 5]])
        valid = jnp.ones(4, bool)
        idx, d2, ok = pc.knn_indices(pts, valid, pts, valid, 2)
        assert int(idx[0, 0]) == 0 and int(idx[0, 1]) == 2
        np.testing.assert_allclose(float(d2[0, 1]), 0.01, atol=1e-5)

    def test_normals_on_plane(self):
        key = jax.random.PRNGKey(1)
        a = jax.random.uniform(key, (300, 2)) * 2.0
        pts = jnp.stack([a[:, 0], a[:, 1], jnp.zeros(300)], axis=1)
        cov, normal = pc.estimate_covariances(pts, jnp.ones(300, bool), k=8)
        nz = np.abs(np.asarray(normal)[:, 2])
        assert (nz > 0.99).mean() > 0.95


class TestGICP:
    def test_recovers_transform(self):
        key = jax.random.PRNGKey(2)
        tgt = make_room_cloud(key)
        rot_gt = lie.so3_exp(jnp.array([0.03, -0.05, 0.04]))
        t_gt = jnp.array([0.08, -0.05, 0.06])
        # src such that tgt = R src + t  =>  src = R^T (tgt - t)
        src = (tgt - t_gt) @ rot_gt
        valid = jnp.ones(tgt.shape[0], bool)
        res = gicp.gicp_register(src, valid, tgt, valid, max_corr_dist=0.3)
        np.testing.assert_allclose(np.asarray(res.rot), np.asarray(rot_gt), atol=3e-3)
        np.testing.assert_allclose(np.asarray(res.t), np.asarray(t_gt), atol=1e-2)
        assert int(res.n_inliers) > 1500

    def test_partial_overlap_and_noise(self):
        key = jax.random.PRNGKey(3)
        tgt = make_room_cloud(key)
        rot_gt = lie.so3_exp(jnp.array([0.02, 0.02, -0.03]))
        t_gt = jnp.array([0.05, 0.03, -0.04])
        src = (tgt - t_gt) @ rot_gt
        src = src + jax.random.normal(jax.random.PRNGKey(4), src.shape) * 0.005
        # drop 30% of source
        valid_src = jnp.arange(src.shape[0]) % 10 >= 3
        valid = jnp.ones(tgt.shape[0], bool)
        res = gicp.gicp_register(src, valid_src, tgt, valid, max_corr_dist=0.3)
        np.testing.assert_allclose(np.asarray(res.rot), np.asarray(rot_gt), atol=1e-2)
        np.testing.assert_allclose(np.asarray(res.t), np.asarray(t_gt), atol=3e-2)

    def test_ndt_recovers_transform(self):
        key = jax.random.PRNGKey(5)
        tgt = make_room_cloud(key, 3000)
        rot_gt = lie.so3_exp(jnp.array([0.02, -0.03, 0.02]))
        t_gt = jnp.array([0.06, -0.04, 0.05])
        src = (tgt - t_gt) @ rot_gt
        valid = jnp.ones(tgt.shape[0], bool)
        res = gicp.ndt_register(src, valid, tgt, valid, resolution=0.5)
        np.testing.assert_allclose(np.asarray(res.rot), np.asarray(rot_gt), atol=2e-2)
        np.testing.assert_allclose(np.asarray(res.t), np.asarray(t_gt), atol=5e-2)
