"""Distributed bundle adjustment over a jax.sharding.Mesh.

The reference is single-process multi-threaded (SURVEY.md §2.3: no NCCL/MPI
anywhere); its global BA (Optimizer::GlobalBundleAdjustemnt,
/root/reference/src/Optimizer.cc:47) runs on one CPU in a background thread.
Here it is re-derived as landmark-parallel SPMD over several devices:

* Landmarks (and their observations) are sharded across the `land` mesh
  axis — each device owns M/D points, their Hll blocks, and their slices of
  the [K, M] observation grid.
* KF poses are replicated; each device computes its partial contribution to
  the reduced camera system S = Hpp - Hpl Hll^-1 Hpl^T over its landmark
  shard; one `psum` over the mesh assembles the full S (the classic
  distributed Schur trick — the only cross-device traffic is the [6K, 6K]
  reduced system + [6K] rhs per iteration, riding ICI).
* The dense solve is replicated (6K is tiny); landmark back-substitution is
  local to each shard. No host round-trips inside the loop.

Built with shard_map so the collective schedule is explicit and testable on
a virtual 8-device CPU mesh (tests/conftest.py) as well as real chips.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from geoflowslam.math import lie
from geoflowslam.solvers.local_ba import (
    BAProblem, _residuals, _chi2, HUBER_MONO, HUBER_STEREO,
)
from geoflowslam.solvers.pose_opt import _huber_w

AXIS = "land"


def _sharded_gn_step(prob: BAProblem, fx, fy, cx, cy, bf, damping=1e-6):
    """One GN step; runs inside shard_map with landmark-dim sharded inputs.

    prob fields arrive with their M dimension holding only this device's
    shard; kf_* fields are replicated.
    """
    r, jp, jl, behind = _residuals(prob, fx, fy, cx, cy, bf)
    chi2 = _chi2(r, prob)
    delta = jnp.where(prob.is_stereo, HUBER_STEREO, HUBER_MONO)
    active = prob.obs_valid & prob.pt_valid[None, :] & prob.kf_valid[:, None]
    w = _huber_w(chi2, delta) * prob.inv_sigma2 * (active & ~behind).astype(r.dtype)
    row_mask = jnp.stack([jnp.ones_like(w), jnp.ones_like(w),
                          prob.is_stereo.astype(w.dtype)], axis=-1)
    wr = w[..., None] * row_mask

    k = prob.kf_rot.shape[0]
    hpp_local = jnp.einsum("kmri,kmr,kmrj->kij", jp, wr, jp)
    hll = jnp.einsum("kmri,kmr,kmrj->mij", jl, wr, jl)
    hpl = jnp.einsum("kmri,kmr,kmrj->kmij", jp, wr, jl)
    bp_local = -jnp.einsum("kmri,kmr->ki", jp, wr * r)
    bl = -jnp.einsum("kmri,kmr->mi", jl, wr * r)

    tr = jnp.trace(hll, axis1=-2, axis2=-1)[:, None, None]
    hll = hll + (1e-3 * tr / 3.0 + damping) * jnp.eye(3, dtype=hll.dtype)
    hll_inv = jnp.linalg.inv(hll)
    pt_active = (jnp.sum(w, axis=0) > 0) & prob.pt_valid
    hll_inv = hll_inv * pt_active[:, None, None]

    s_local = hpp_local_to_s(hpp_local, hpl, hll_inv, k)
    rhs_local = bp_local - jnp.einsum("kmij,mjl,ml->ki", hpl, hll_inv, bl)

    # the ONLY collective: assemble the reduced camera system across shards
    s = jax.lax.psum(s_local, AXIS)
    rhs = jax.lax.psum(rhs_local, AXIS)

    free = (prob.kf_valid & ~prob.kf_fixed).astype(s.dtype)
    fm = free[:, None]
    s = s * fm[:, :, None, None] * free[None, None, :, None]
    sd = s.reshape(k * 6, k * 6)
    diag_fix = (1.0 - (fm * jnp.ones((k, 6), s.dtype))).reshape(-1)
    sd = sd + jnp.diag(diag_fix) + damping * jnp.eye(k * 6, dtype=s.dtype)
    rhs = (rhs * fm).reshape(-1)

    dp = jnp.linalg.solve(sd, rhs).reshape(k, 6) * fm
    dp = jnp.where(jnp.all(jnp.isfinite(dp)), dp, jnp.zeros_like(dp))

    dl = jnp.einsum("mij,mj->mi", hll_inv,
                    bl - jnp.einsum("kmij,ki->mj", hpl, dp))
    dl = jnp.where(jnp.all(jnp.isfinite(dl)), dl, jnp.zeros_like(dl))

    dr_rot, dr_t = lie.se3_exp(dp)
    new_rot = lie.normalize_rotation(jnp.einsum("kij,kjl->kil", dr_rot, prob.kf_rot))
    new_t = jnp.einsum("kij,kj->ki", dr_rot, prob.kf_t) + dr_t
    new_pts = prob.pts + dl * pt_active[:, None]
    return prob._replace(kf_rot=new_rot, kf_t=new_t, pts=new_pts)


def hpp_local_to_s(hpp_local, hpl, hll_inv, k):
    """Partial reduced system from this shard's landmarks. hpp contributes
    only to diagonal blocks; psum-safe because each shard adds the partial
    hpp from observations of its own landmarks."""
    s = -jnp.einsum("kmij,mjl,qmrl->kiqr", hpl, hll_inv, hpl)
    return s.at[jnp.arange(k), :, jnp.arange(k), :].add(hpp_local)


def make_distributed_ba(mesh: Mesh, fx, fy, cx, cy, bf=0.0, iters: int = 10):
    """Build a jitted distributed-BA function for the given mesh.

    Input BAProblem must have M divisible by the mesh's `land` axis size.
    Returns fn(prob) -> prob with optimized poses/points, sharded in/out along
    the landmark dimension.
    """
    land_sharded = BAProblem(
        kf_rot=P(), kf_t=P(), kf_fixed=P(), kf_valid=P(),
        pts=P(AXIS), pt_valid=P(AXIS),
        uv=P(None, AXIS), u_right=P(None, AXIS), is_stereo=P(None, AXIS),
        inv_sigma2=P(None, AXIS), obs_valid=P(None, AXIS),
    )

    def step_fn(prob: BAProblem) -> BAProblem:
        def body(_, p):
            return _sharded_gn_step(p, fx, fy, cx, cy, bf)
        return jax.lax.fori_loop(0, iters, body, prob)

    shmapped = jax.shard_map(
        step_fn, mesh=mesh, in_specs=(land_sharded,), out_specs=land_sharded,
        check_vma=False,
    )
    return jax.jit(shmapped)
