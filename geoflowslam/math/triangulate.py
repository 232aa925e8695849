"""Two-view triangulation (batched DLT via SVD).

Replaces GeometricTools::Triangulate (/root/reference/src/GeometricTools.cc:1-74),
which solves the 4x4 DLT system per point with Eigen::JacobiSVD inside loops;
here the whole batch is one vmapped eigendecomposition.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def triangulate_dlt(rays1: jnp.ndarray, rays2: jnp.ndarray,
                    p1: jnp.ndarray, p2: jnp.ndarray) -> jnp.ndarray:
    """Triangulate N points from two views.

    Args:
      rays1, rays2: [N, 3] normalized image coords (x, y, 1) in each camera.
      p1, p2: [3, 4] projection matrices (world->cam, [R|t]); rays are in the
        respective normalized camera planes.
    Returns:
      [N, 4] homogeneous world points (caller divides by w and checks masks).
    """
    def build(r1, r2):
        return jnp.stack([
            r1[0] * p1[2] - p1[0],
            r1[1] * p1[2] - p1[1],
            r2[0] * p2[2] - p2[0],
            r2[1] * p2[2] - p2[1],
        ])  # [4, 4]

    a = jax.vmap(build)(rays1, rays2)
    # Null vector of A = right singular vector with smallest singular value.
    # SVD of A (not eigh of A^T A) keeps the condition number linear in f32.
    _, _, vt = jnp.linalg.svd(a, full_matrices=True)
    return vt[:, 3, :]


def triangulate_points(rays1, rays2, rot21, t21):
    """Triangulate with cam1 as world: P1=[I|0], P2=[R21|t21].

    Solves the inhomogeneous least-squares system from the two cross-product
    ray constraints (cross(r1, X) = 0, cross(r2, R X + t) = 0) via 3x3 normal
    equations — much better f32 conditioning than the homogeneous 4x4 DLT
    SVD, which matters since the whole pipeline stays in float32.

    Returns (pts3d_cam1 [N,3], valid [N]) where valid requires positive finite
    depth in both cameras (cheirality), mirroring the gates in
    LocalMapping::CreateNewMapPoints (/root/reference/src/LocalMapping.cc:803+).
    """
    from geoflowslam.math.lie import hat

    # Normalize rays so both views weigh comparably.
    r1 = rays1 / jnp.linalg.norm(rays1, axis=-1, keepdims=True)
    r2 = rays2 / jnp.linalg.norm(rays2, axis=-1, keepdims=True)
    a1 = hat(r1)                                   # [N,3,3]
    a2 = jnp.einsum("nij,jk->nik", hat(r2), rot21)  # [N,3,3]
    b2 = -jnp.einsum("nij,j->ni", hat(r2), t21)    # [N,3]
    h = jnp.einsum("nji,njk->nik", a1, a1) + jnp.einsum("nji,njk->nik", a2, a2)
    g = jnp.einsum("nji,nj->ni", a2, b2)
    eye = jnp.eye(3, dtype=h.dtype)
    pts = jnp.linalg.solve(h + 1e-9 * eye, g[..., None])[..., 0]
    z1 = pts[:, 2]
    pts2 = pts @ rot21.T + t21
    z2 = pts2[:, 2]
    finite = jnp.all(jnp.isfinite(pts), axis=1)
    valid = (z1 > 0) & (z2 > 0) & finite
    return pts, valid
