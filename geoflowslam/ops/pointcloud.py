"""Point-cloud primitives: depth back-projection, voxel downsample, normals.

JAX replacement for the PCL/small_gicp cloud utilities used by the
reference: Frame::ConvertDepthToPointCloud (/root/reference/src/Frame.cc:590,
10 m depth cutoff), LidarMapping::generatePointCloud (every 3rd pixel
back-projection, src/LidarMapping.cc:82-105), pcl::VoxelGrid filtering and
small_gicp's voxelgrid_sampling + covariance estimation
(Thirdparty/small_gicp/include/small_gicp/ann,util).

Fixed-capacity design: clouds are [P, 3] padded arrays + masks. Voxel
downsampling = key sort + first-per-voxel compaction (deterministic);
kNN = brute-force distance matrix as one matmul (P <= 4096 after
downsampling, so a [P, P] product is cheap; no KdTree needed).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def depth_to_cloud(depth: jnp.ndarray, fx, fy, cx, cy, stride: int = 3,
                   max_depth: float = 10.0, min_depth: float = 0.05):
    """Back-project a depth image [H, W] -> ([P,3] points, [P] mask), with
    P = (H//stride) * (W//stride) static."""
    h, w = depth.shape
    d = depth[::stride, ::stride]
    hs, ws = d.shape
    ys = (jnp.arange(hs, dtype=depth.dtype) * stride)[:, None]
    xs = (jnp.arange(ws, dtype=depth.dtype) * stride)[None, :]
    z = d
    x = (xs - cx) / fx * z
    y = (ys - cy) / fy * z
    pts = jnp.stack([x, y, z], axis=-1).reshape(-1, 3)
    mask = ((z > min_depth) & (z < max_depth) & jnp.isfinite(z)).reshape(-1)
    return pts, mask


def lidar_feature_cloud(depth: jnp.ndarray, fx, fy, cx, cy, stride: int = 3,
                        max_depth: float = 10.0, min_depth: float = 0.05,
                        edge_curv: float = 0.1, edges_per_row: int = 10):
    """SSL_SLAM2-style edge/surf feature extraction from the organized depth
    cloud (LaserProcessingClass::featureExtraction[FromSector],
    /root/reference/src/LidarProcess.cc:35-216): the depth image's rows are
    the scan lines; curvature c_j = |Σ_{k=-5..5} p_{j+k} - 10 p_j|^2 / |p_j|^2
    along each row; per row the highest-curvature points above `edge_curv`
    become edge features (±5-neighbour suppression — here a ±5 local-max
    test, the dense equivalent of the reference's picked_points set), the
    smooth remainder becomes surf features. The reference then continues
    with surf+edge as the frame's feature cloud.

    Returns ([P,3] points, [P] valid, [P] is_edge) with the same static
    P = (H//stride)*(W//stride) layout as depth_to_cloud.

    Departure from the reference noted: its curvature normalizes only the
    z-term by distance (operator precedence in LidarProcess.cc:131); we
    normalize the full squared diff, which is the SSL_SLAM2 intent.
    """
    h, w = depth.shape
    d = depth[::stride, ::stride]
    hs, ws = d.shape
    ys = (jnp.arange(hs, dtype=depth.dtype) * stride)[:, None]
    xs = (jnp.arange(ws, dtype=depth.dtype) * stride)[None, :]
    z = d
    x = (xs - cx) / fx * z
    y = (ys - cy) / fy * z
    p = jnp.stack([x, y, z], axis=-1)                       # [hs, ws, 3]
    ok = (z > min_depth) & (z < max_depth) & jnp.isfinite(z)

    # curvature along rows: Σ_{k=-5..5} p_{j+k} - 10 p_j (the k=0 term in
    # the window sum contributes p_j, hence the -11+1 = -10 net weight)
    pz = jnp.where(ok[..., None], p, 0.0)
    acc = -11.0 * pz
    win_ok = ok
    for k in range(-5, 6):
        sh = jnp.roll(pz, -k, axis=1)
        sh_ok = jnp.roll(ok, -k, axis=1)
        acc = acc + sh
        win_ok = win_ok & sh_ok
    # kill the roll wrap-around at row ends
    col = jnp.arange(ws)[None, :]
    win_ok = win_ok & (col >= 5) & (col < ws - 5)
    dist2 = jnp.maximum(jnp.sum(p * p, axis=-1), 1e-6)
    curv = jnp.where(win_ok, jnp.sum(acc * acc, axis=-1) / dist2, -1.0)

    # edges: top `edges_per_row` per row among c > edge_curv, with ±5
    # suppression via a windowed local-max test
    local_max = curv
    for k in range(1, 6):
        local_max = jnp.maximum(local_max, jnp.roll(curv, k, axis=1))
        local_max = jnp.maximum(local_max, jnp.roll(curv, -k, axis=1))
    is_peak = (curv >= local_max) & (curv > edge_curv)
    topv, topi = jax.lax.top_k(jnp.where(is_peak, curv, -1.0),
                               min(edges_per_row, ws))
    keep = jnp.zeros((hs, ws), bool)
    rows = jnp.broadcast_to(jnp.arange(hs)[:, None], topi.shape)
    keep = keep.at[rows, topi].set(topv > 0)
    is_edge = keep & win_ok

    # surf: smooth valid points not picked as edges (reference keeps all
    # non-edge sector points as surf candidates)
    is_surf = win_ok & ~is_edge
    valid = (is_edge | is_surf) & ok
    return (p.reshape(-1, 3), valid.reshape(-1), is_edge.reshape(-1))


INVALID_KEY = np.int32(0x7FFFFFFF)  # host constant; no device op at import


def _voxel_keys(pts: jnp.ndarray, valid: jnp.ndarray, voxel: float):
    """Integer voxel key per point (invalid -> huge key, sorts last).

    int32 packing, 10 bits/axis (x64 is unavailable on this platform): voxel
    coordinates are clipped to a 1024^3 grid centred at the origin — ±25 m at
    the default 0.05 m voxel, comfortably beyond RGB-D range."""
    ijk = jnp.clip(jnp.floor(pts / voxel).astype(jnp.int32) + 512, 0, 1023)
    key = (ijk[:, 0] << 20) | (ijk[:, 1] << 10) | ijk[:, 2]
    return jnp.where(valid, key, INVALID_KEY)


def voxel_downsample(pts: jnp.ndarray, valid: jnp.ndarray, voxel: float,
                     max_out: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Keep one point per voxel (first after sort), compact to [max_out].

    Deterministic analogue of small_gicp::voxelgrid_sampling (0.02 m in
    RegistrationGICP, /root/reference/src/RegistrationGICP.cc:10)."""
    key = _voxel_keys(pts, valid, voxel)
    order = jnp.argsort(key)
    ks = key[order]
    first = jnp.concatenate([jnp.ones((1,), bool), ks[1:] != ks[:-1]])
    first = first & (ks != INVALID_KEY)
    # compact: stable-sort selected to front
    rank = jnp.argsort(~first, stable=True)
    sel = order[rank[:max_out]]
    out_valid = first[rank[:max_out]]
    return pts[sel], out_valid


def knn_indices(query: jnp.ndarray, q_valid: jnp.ndarray, target: jnp.ndarray,
                t_valid: jnp.ndarray, k: int):
    """Brute-force kNN: [Q,k] indices + [Q,k] validity, matmul distance matrix."""
    d2 = (
        jnp.sum(query * query, axis=1)[:, None]
        - 2.0 * query @ target.T
        + jnp.sum(target * target, axis=1)[None, :]
    )
    d2 = jnp.where(t_valid[None, :], d2, jnp.inf)
    if k == 1:
        # argmin instead of top_k: top_k sorts the [Q,T] matrix where a
        # reduction suffices, and the GICP inner loop calls this every
        # iteration
        idx = jnp.argmin(d2, axis=1)[:, None]
        best = jnp.take_along_axis(d2, idx, axis=1)
        ok = jnp.isfinite(best) & q_valid[:, None]
        return idx, best, ok
    neg, idx = jax.lax.top_k(-d2, k)
    ok = jnp.isfinite(-neg) & q_valid[:, None]
    return idx, -neg, ok


def estimate_covariances(pts: jnp.ndarray, valid: jnp.ndarray, k: int = 10,
                         eps: float = 1e-3):
    """Per-point kNN covariance (small_gicp::estimate_covariances), with the
    GICP plane-regularization (eigenvalues -> [1, 1, eps])."""
    idx, _, ok = knn_indices(pts, valid, pts, valid, k)
    nb = pts[idx]                                       # [P,k,3]
    w = ok.astype(pts.dtype)
    n = jnp.maximum(jnp.sum(w, axis=1, keepdims=True), 1.0)
    mean = jnp.sum(nb * w[..., None], axis=1) / n
    c = nb - mean[:, None, :]
    cov = jnp.einsum("pk,pki,pkj->pij", w, c, c) / n[..., None]
    # regularize: replace eigenvalues by [eps, 1, 1] (plane-to-plane GICP).
    # With an orthonormal eigenbasis V, V diag(eps,1,1) V^T collapses to
    # I - (1-eps) n n^T where n is the smallest-eigenvalue eigenvector —
    # only the NORMAL is needed, so the batched jnp.linalg.eigh (an
    # iterative solver per 3x3) is replaced by the closed-form
    # smallest-eigenvector (trigonometric eigenvalues + cross-product
    # null vector), fully elementwise.
    normal = smallest_eigvec_sym3(cov)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=pts.dtype), cov.shape)
    cov_reg = eye - (1.0 - eps) * normal[:, :, None] * normal[:, None, :]
    return cov_reg, normal


def sym3_eigvals(a: jnp.ndarray) -> jnp.ndarray:
    """Ascending eigenvalues [..., 3] of symmetric 3x3 batches — closed
    form (trigonometric method), no iterative eigh."""
    q = jnp.trace(a, axis1=-2, axis2=-1) / 3.0
    p1 = a[..., 0, 1] ** 2 + a[..., 0, 2] ** 2 + a[..., 1, 2] ** 2
    d = jnp.stack([a[..., 0, 0], a[..., 1, 1], a[..., 2, 2]], axis=-1)
    p2 = jnp.sum((d - q[..., None]) ** 2, axis=-1) + 2.0 * p1
    p = jnp.sqrt(jnp.maximum(p2 / 6.0, 1e-30))
    b = (a - q[..., None, None] * jnp.eye(3, dtype=a.dtype)) / p[..., None,
                                                                 None]
    r = jnp.clip(0.5 * jnp.linalg.det(b), -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    lam_max = q + 2.0 * p * jnp.cos(phi)
    lam_min = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)
    lam_mid = 3.0 * q - lam_max - lam_min
    return jnp.stack([lam_min, lam_mid, lam_max], axis=-1)


def smallest_eigvec_sym3(a: jnp.ndarray) -> jnp.ndarray:
    """Unit eigenvector of the smallest eigenvalue for a batch of symmetric
    3x3 matrices [N,3,3] — closed form (no iterative eigh):
    eigenvalues by the trigonometric method, eigenvector as the largest
    cross product of two columns of (A - lambda_min I). Isotropic /
    degenerate inputs fall back to +z."""
    q = jnp.trace(a, axis1=1, axis2=2) / 3.0
    p1 = a[:, 0, 1] ** 2 + a[:, 0, 2] ** 2 + a[:, 1, 2] ** 2
    d = jnp.stack([a[:, 0, 0], a[:, 1, 1], a[:, 2, 2]], axis=1)
    p2 = jnp.sum((d - q[:, None]) ** 2, axis=1) + 2.0 * p1
    p = jnp.sqrt(jnp.maximum(p2 / 6.0, 1e-30))
    b = (a - q[:, None, None] * jnp.eye(3, dtype=a.dtype)) / p[:, None, None]
    r = jnp.clip(0.5 * jnp.linalg.det(b), -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    # ascending: lam_min = q + 2 p cos(phi + 2pi/3)
    lam_min = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)
    m = a - lam_min[:, None, None] * jnp.eye(3, dtype=a.dtype)
    c0, c1, c2 = m[:, :, 0], m[:, :, 1], m[:, :, 2]
    cands = jnp.stack([jnp.cross(c0, c1), jnp.cross(c0, c2),
                       jnp.cross(c1, c2)], axis=1)          # [N,3,3]
    norms = jnp.linalg.norm(cands, axis=2)
    best = jnp.argmax(norms, axis=1)
    v = jnp.take_along_axis(cands, best[:, None, None], axis=1)[:, 0]
    nrm = jnp.linalg.norm(v, axis=1, keepdims=True)
    fallback = jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0], a.dtype), v.shape)
    v = jnp.where(nrm > 1e-12, v / jnp.maximum(nrm, 1e-30), fallback)
    return v


def transform_cloud(rot, t, pts):
    return pts @ rot.T + t
