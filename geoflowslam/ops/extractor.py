"""Full ORB feature extraction: pyramid -> FAST -> orientation -> rBRIEF.

Facade equivalent of ORBextractor::operator()
(/root/reference/src/ORBextractor.cc:1145-1226): builds the scale pyramid,
detects per-level FAST keypoints with the two-threshold fallback and spatial
balancing, computes intensity-centroid orientations and steered BRIEF-256
descriptors on blurred levels, and returns one fixed-shape FeatureSet with
all levels merged and coordinates scaled to level 0.

Everything is static-shape: per-level quotas follow the reference's geometric
split (nfeatures * (1-1/s)/(1-(1/s)^L) at level 0, ORBextractor ctor).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from geoflowslam.ops import fast as fast_ops
from geoflowslam.ops import orb as orb_ops
from geoflowslam.ops import pyramid as pyr_ops


@dataclasses.dataclass(frozen=True)
class OrbConfig:
    """Mirrors the ORBextractor.* YAML block (SURVEY.md §5 Config)."""
    n_features: int = 1000
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: float = 20.0
    min_th_fast: float = 7.0
    height: int = 480
    width: int = 640
    cell_size: int = 32
    per_cell_cap: int = 8

    def per_level_quota(self):
        """Geometric distribution of features over levels (reference ctor)."""
        inv = 1.0 / self.scale_factor
        n_desired = self.n_features * (1 - inv) / (1 - inv ** self.n_levels)
        quotas, total = [], 0
        for lvl in range(self.n_levels - 1):
            q = int(round(n_desired * inv ** lvl))
            quotas.append(q)
            total += q
        quotas.append(max(self.n_features - total, 0))
        return quotas

    def scale_factors(self):
        return [self.scale_factor ** l for l in range(self.n_levels)]


class FeatureSet(NamedTuple):
    """Padded keypoint set for one image. N = config.n_features (+ OF slack
    handled by the Frame container, state/frame.py)."""
    uv: jnp.ndarray       # [N, 2] float32, level-0 pixel coords (x, y)
    response: jnp.ndarray  # [N]
    angle: jnp.ndarray    # [N] radians
    level: jnp.ndarray    # [N] int32 octave
    desc: jnp.ndarray     # [N, 8] uint32
    valid: jnp.ndarray    # [N] bool

    @property
    def capacity(self):
        return self.uv.shape[0]


def extract(img: jnp.ndarray, cfg: OrbConfig) -> FeatureSet:
    """img: [H, W] float32 grayscale in [0,255] -> FeatureSet[n_features]."""
    levels = pyr_ops.build_pyramid(img, cfg.n_levels, cfg.scale_factor)
    quotas = cfg.per_level_quota()
    scales = cfg.scale_factors()

    uvs, resps, angles, lvls, descs, valids = [], [], [], [], [], []
    for lvl, (lv_img, quota, scale) in enumerate(zip(levels, quotas, scales)):
        if quota == 0:
            continue
        kp = fast_ops.detect_level(
            lv_img, quota, cfg.ini_th_fast, cfg.min_th_fast,
            cell_size=cfg.cell_size, per_cell_cap=cfg.per_cell_cap,
        )
        # patch-based fused orientation+blur+BRIEF (bit-identical to the
        # dense compute_orientations/gaussian_blur/compute_descriptors
        # chain, ~4x less device time — see ops/orb.py patch-path header)
        ang, d = orb_ops.orient_and_describe(lv_img, kp.xy)
        uvs.append(kp.xy * scale)
        resps.append(kp.score)
        angles.append(ang)
        lvls.append(jnp.full((quota,), lvl, jnp.int32))
        descs.append(d)
        valids.append(kp.valid)

    return FeatureSet(
        uv=jnp.concatenate(uvs, axis=0),
        response=jnp.concatenate(resps, axis=0),
        angle=jnp.concatenate(angles, axis=0),
        level=jnp.concatenate(lvls, axis=0),
        desc=jnp.concatenate(descs, axis=0),
        valid=jnp.concatenate(valids, axis=0),
    )
