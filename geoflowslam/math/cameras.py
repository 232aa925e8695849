"""Camera models: Pinhole and Kannala-Brandt-8 fisheye.

JAX replacement for the reference's GeometricCamera hierarchy
(/root/reference/include/CameraModels/GeometricCamera.h:61-86,
 src/CameraModels/Pinhole.cpp, src/CameraModels/KannalaBrandt8.cpp).

Instead of virtual dispatch over camera objects, every model is a set of pure
batched functions parameterised by a flat parameter vector, so projection,
unprojection and Jacobians vmap over any number of points and live inside jit.

Parameter layouts
-----------------
* Pinhole: ``[fx, fy, cx, cy]`` (+ optional radtan distortion handled at the
  undistortion stage, as in the reference where keypoints are undistorted once
  per frame, Frame::UndistortKeyPoints /root/reference/src/Frame.cc:1093).
* KB8 fisheye: ``[fx, fy, cx, cy, k0, k1, k2, k3]`` (theta-polynomial).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-9


# ---------------------------------------------------------------------------
# Pinhole
# ---------------------------------------------------------------------------

def pinhole_project(params: jnp.ndarray, pts_cam: jnp.ndarray) -> jnp.ndarray:
    """Project camera-frame points [..., 3] -> pixel coords [..., 2]."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    z = pts_cam[..., 2]
    inv_z = 1.0 / jnp.where(jnp.abs(z) < _EPS, _EPS, z)
    u = fx * pts_cam[..., 0] * inv_z + cx
    v = fy * pts_cam[..., 1] * inv_z + cy
    return jnp.stack([u, v], axis=-1)


def pinhole_unproject(params: jnp.ndarray, uv: jnp.ndarray) -> jnp.ndarray:
    """Pixel [..., 2] -> unit-depth ray [..., 3] (z = 1)."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    x = (uv[..., 0] - cx) / fx
    y = (uv[..., 1] - cy) / fy
    return jnp.stack([x, y, jnp.ones_like(x)], axis=-1)


def pinhole_project_jac(params: jnp.ndarray, pts_cam: jnp.ndarray) -> jnp.ndarray:
    """d(uv)/d(pt_cam): [..., 2, 3] (reference Pinhole::projectJac)."""
    fx, fy = params[0], params[1]
    x, y, z = pts_cam[..., 0], pts_cam[..., 1], pts_cam[..., 2]
    inv_z = 1.0 / jnp.where(jnp.abs(z) < _EPS, _EPS, z)
    inv_z2 = inv_z * inv_z
    zero = jnp.zeros_like(x)
    row0 = jnp.stack([fx * inv_z, zero, -fx * x * inv_z2], axis=-1)
    row1 = jnp.stack([zero, fy * inv_z, -fy * y * inv_z2], axis=-1)
    return jnp.stack([row0, row1], axis=-2)


def radtan_distort(dist: jnp.ndarray, xy: jnp.ndarray) -> jnp.ndarray:
    """Apply radial-tangential distortion [k1,k2,p1,p2,(k3)] to normalized xy."""
    k1, k2, p1, p2 = dist[0], dist[1], dist[2], dist[3]
    k3 = dist[4] if dist.shape[0] > 4 else jnp.zeros_like(k1)
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return jnp.stack([xd, yd], axis=-1)


def radtan_undistort(dist: jnp.ndarray, xy_d: jnp.ndarray, iters: int = 8) -> jnp.ndarray:
    """Invert radtan distortion by fixed-point iteration (static iter count,
    jit-friendly; replaces cv::undistortPoints used in Frame::UndistortKeyPoints)."""
    def body(_, xy):
        d = radtan_distort(dist, xy) - xy
        return xy_d - d

    return jax.lax.fori_loop(0, iters, body, xy_d)


# ---------------------------------------------------------------------------
# Kannala-Brandt 8 (fisheye)
# ---------------------------------------------------------------------------

def kb8_project(params: jnp.ndarray, pts_cam: jnp.ndarray) -> jnp.ndarray:
    """KB8 theta-polynomial projection (KannalaBrandt8::project,
    /root/reference/src/CameraModels/KannalaBrandt8.cpp)."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    k0, k1, k2, k3 = params[4], params[5], params[6], params[7]
    x, y, z = pts_cam[..., 0], pts_cam[..., 1], pts_cam[..., 2]
    r = jnp.sqrt(x * x + y * y)
    theta = jnp.arctan2(r, z)
    t2 = theta * theta
    theta_d = theta * (1.0 + t2 * (k0 + t2 * (k1 + t2 * (k2 + t2 * k3))))
    inv_r = 1.0 / jnp.maximum(r, _EPS)
    scale = jnp.where(r < _EPS, 1.0 / jnp.maximum(z, _EPS), theta_d * inv_r)
    u = fx * x * scale + cx
    v = fy * y * scale + cy
    return jnp.stack([u, v], axis=-1)


def kb8_unproject(params: jnp.ndarray, uv: jnp.ndarray, iters: int = 10) -> jnp.ndarray:
    """Invert the theta polynomial by Newton iteration (static count);
    reference uses a 10-iteration Newton solve in unprojectEig."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    k0, k1, k2, k3 = params[4], params[5], params[6], params[7]
    mx = (uv[..., 0] - cx) / fx
    my = (uv[..., 1] - cy) / fy
    theta_d = jnp.sqrt(mx * mx + my * my)
    theta_d_c = jnp.clip(theta_d, 0.0, jnp.pi / 2)

    def body(_, theta):
        t2 = theta * theta
        f = theta * (1.0 + t2 * (k0 + t2 * (k1 + t2 * (k2 + t2 * k3)))) - theta_d_c
        df = 1.0 + t2 * (3 * k0 + t2 * (5 * k1 + t2 * (7 * k2 + 9 * t2 * k3)))
        return theta - f / jnp.maximum(df, _EPS)

    theta = jax.lax.fori_loop(0, iters, body, theta_d_c)
    scale = jnp.where(theta_d < _EPS, jnp.ones_like(theta), jnp.tan(theta) / jnp.maximum(theta_d, _EPS))
    return jnp.stack([mx * scale, my * scale, jnp.ones_like(mx)], axis=-1)


def kb8_project_jac(params: jnp.ndarray, pts_cam: jnp.ndarray) -> jnp.ndarray:
    """d(uv)/d(pt_cam) for KB8 via jax.jacfwd composed per point."""
    flat = pts_cam.reshape(-1, 3)
    jac = jax.vmap(jax.jacfwd(lambda p: kb8_project(params, p)))(flat)
    return jac.reshape(*pts_cam.shape[:-1], 2, 3)


# ---------------------------------------------------------------------------
# Dispatch-free "model" facade: model id 0 = pinhole, 1 = KB8.
# Params are always padded to length 8.
# ---------------------------------------------------------------------------

PINHOLE = 0
KB8 = 1


def project(model_id: int, params: jnp.ndarray, pts_cam: jnp.ndarray) -> jnp.ndarray:
    if model_id == PINHOLE:
        return pinhole_project(params, pts_cam)
    return kb8_project(params, pts_cam)


def unproject(model_id: int, params: jnp.ndarray, uv: jnp.ndarray) -> jnp.ndarray:
    if model_id == PINHOLE:
        return pinhole_unproject(params, uv)
    return kb8_unproject(params, uv)


def project_jac(model_id: int, params: jnp.ndarray, pts_cam: jnp.ndarray) -> jnp.ndarray:
    if model_id == PINHOLE:
        return pinhole_project_jac(params, pts_cam)
    return kb8_project_jac(params, pts_cam)
