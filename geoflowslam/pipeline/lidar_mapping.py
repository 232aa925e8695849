"""Dense local/global depth-cloud mapping + point-to-plane factors.

JAX replacement for LidarMapping (reference src/LidarMapping.cc)
and the SSL_SLAM2-style factor generation (Optimizer::GenerateLidarEdge,
src/Optimizer.cc:8338-8421; LaserProcessing feature extraction,
src/LidarProcess.cc):

* the 30-KF sliding local map (insertKeyFrame :72-80, GetLocalMap :186)
  becomes a fixed-capacity world-frame point buffer: each KF's downsampled
  cloud is transformed and rolled in, then voxel-compacted — all jit.
* the global map (save :194-212) accumulates decimated clouds host-side and
  exports PCD.
* point-to-plane factors: kNN (brute-force matmul tile) against the local map
  + batched 3-point plane fit with planarity gating, the 5-NN QR solve of
  GenerateLidarEdge expressed as one eigendecomposition vmap.

The resulting PlaneObs feeds solvers/pose_opt.pose_optimization (the
EdgeLidarPoint2Plane term of PoseLidarVisualOptimization).
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from geoflowslam.ops import pointcloud as PC
from geoflowslam.solvers.pose_opt import PlaneObs


@dataclasses.dataclass(frozen=True)
class LidarConfig:
    local_capacity: int = 16384
    local_voxel: float = 0.1       # LidarMapping.LocalResolution
    global_voxel: float = 0.2      # LidarMapping.GlobalResolution
    window_kfs: int = 30           # sliding window (LidarMapping.cc:79)
    knn: int = 5                   # plane fit neighbours (Optimizer.cc:8356)
    max_plane_dist: float = 0.3    # correspondence gate
    planarity_eps: float = 0.03    # plane-fit residual gate


class LocalMap(NamedTuple):
    pts: jnp.ndarray      # [P,3] world
    valid: jnp.ndarray    # [P]
    kf_id: jnp.ndarray    # [P] int32 contributing KF slot (for eviction)


def create_local_map(cfg: LidarConfig) -> LocalMap:
    return LocalMap(pts=jnp.zeros((cfg.local_capacity, 3)),
                    valid=jnp.zeros((cfg.local_capacity,), bool),
                    kf_id=jnp.full((cfg.local_capacity,), -1, jnp.int32))


@partial(jax.jit, static_argnames=("cfg",))
def insert_kf_cloud(lm: LocalMap, cloud_c: jnp.ndarray, cloud_valid: jnp.ndarray,
                    rot_cw, t_cw, kf_slot, oldest_keep, cfg: LidarConfig) -> LocalMap:
    """Add a KF's camera-frame cloud; evict KFs older than `oldest_keep`
    (slot id below which clouds leave the sliding window)."""
    rot_wc = rot_cw.T
    pts_w = cloud_c @ rot_wc.T + (-rot_wc @ t_cw)
    keep = lm.valid & (lm.kf_id >= oldest_keep)
    all_pts = jnp.concatenate([lm.pts, pts_w], axis=0)
    all_valid = jnp.concatenate([keep, cloud_valid], axis=0)
    all_kf = jnp.concatenate([lm.kf_id,
                              jnp.full((pts_w.shape[0],), kf_slot, jnp.int32)])
    # voxel-compact back to capacity (keeps one point per voxel, newest-last
    # ordering preserved by the stable compaction in voxel_downsample)
    key = PC._voxel_keys(all_pts, all_valid, cfg.local_voxel)
    order = jnp.argsort(key)
    ks = key[order]
    first = jnp.concatenate([jnp.ones((1,), bool), ks[1:] != ks[:-1]])
    first = first & (ks != PC.INVALID_KEY)
    rank = jnp.argsort(~first, stable=True)
    sel = order[rank[: cfg.local_capacity]]
    out_valid = first[rank[: cfg.local_capacity]]
    return LocalMap(pts=all_pts[sel], valid=out_valid, kf_id=all_kf[sel])


# PlaneObs lives in solvers/pose_opt.py (shared with the optimizer).


@partial(jax.jit, static_argnames=("cfg",))
def make_plane_obs(lm: LocalMap, cloud_c: jnp.ndarray, cloud_valid: jnp.ndarray,
                   rot_cw, t_cw, cfg: LidarConfig) -> PlaneObs:
    """Associate the current cloud with local-map planes (GenerateLidarEdge:
    5-NN plane fit + residual gating)."""
    rot_wc = rot_cw.T
    cam_c = -rot_wc @ t_cw
    pts_w = cloud_c @ rot_wc.T + cam_c

    idx, d2, ok = PC.knn_indices(pts_w, cloud_valid, lm.pts, lm.valid, cfg.knn)
    nb = lm.pts[idx]                                    # [L,k,3]
    w = ok.astype(pts_w.dtype)
    n_valid = jnp.maximum(jnp.sum(w, axis=1, keepdims=True), 1.0)
    mean = jnp.sum(nb * w[..., None], axis=1) / n_valid
    c = (nb - mean[:, None, :]) * w[..., None]
    cov = jnp.einsum("lki,lkj->lij", c, c) / n_valid[..., None]
    vals, vecs = jnp.linalg.eigh(cov)
    normal = vecs[:, :, 0]
    # planarity: smallest eigenvalue (plane-fit residual^2) small, others big
    planar = (jnp.sqrt(jnp.maximum(vals[:, 0], 0.0)) < cfg.planarity_eps) \
        & (vals[:, 1] > 4.0 * vals[:, 0] + 1e-12)
    d = -jnp.einsum("li,li->l", normal, mean)
    close = d2[:, 0] < cfg.max_plane_dist ** 2
    valid = cloud_valid & ok[:, 0] & planar & close \
        & (jnp.sum(w, axis=1) >= cfg.knn - 1)
    return PlaneObs(pts_c=cloud_c, normal=normal, d=d, valid=valid)


class GlobalMap:
    """Host-side accumulated global cloud (LidarMapping global map + save)."""

    def __init__(self, cfg: LidarConfig = LidarConfig()):
        self.cfg = cfg
        self.chunks = []
        self._lazy = []          # device futures from the fused KF path

    def add(self, cloud_c, cloud_valid, rot_cw, t_cw):
        r = np.asarray(rot_cw)
        t = np.asarray(t_cw)
        pts = np.asarray(cloud_c)[np.asarray(cloud_valid)]
        self.chunks.append(pts @ r + (-r.T @ t))

    def add_lazy(self, cloud_c, cloud_valid, rot_cw, t_cw):
        """Fused-path variant: store device futures (no host sync on the
        frame path); materialized in points()/save_pcd at export time."""
        for a in (cloud_c, cloud_valid, rot_cw, t_cw):
            if hasattr(a, "copy_to_host_async"):
                a.copy_to_host_async()
        self._lazy.append((cloud_c, cloud_valid, rot_cw, t_cw))

    def _drain_lazy(self):
        for (c, v, r, t) in self._lazy:
            self.add(c, v, r, t)
        self._lazy = []

    def points(self) -> np.ndarray:
        self._drain_lazy()
        if not self.chunks:
            return np.zeros((0, 3), np.float32)
        allp = np.concatenate(self.chunks, axis=0)
        vox = np.floor(allp / self.cfg.global_voxel).astype(np.int64)
        key = vox[:, 0] * 73856093 ^ vox[:, 1] * 19349663 ^ vox[:, 2] * 83492791
        _, idx = np.unique(key, return_index=True)
        return allp[idx]

    def save_pcd(self, path: str):
        """ASCII PCD export (LidarMapping::save -> globalMap.pcd)."""
        pts = self.points()
        with open(path, "w") as f:
            f.write("# .PCD v0.7 - Point Cloud Data file format\n"
                    "VERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\n"
                    f"COUNT 1 1 1\nWIDTH {len(pts)}\nHEIGHT 1\n"
                    "VIEWPOINT 0 0 0 1 0 0 0\n"
                    f"POINTS {len(pts)}\nDATA ascii\n")
            for p in pts:
                f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f}\n")
