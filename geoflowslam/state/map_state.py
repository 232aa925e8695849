"""The SLAM map as a fixed-capacity, functional state pytree.

JAX replacement for the reference's pointer-graph data model —
Frame/KeyFrame/MapPoint/Map/Atlas with dozens of mutexes
(/root/reference/src/KeyFrame.cc, MapPoint.cc, Map.cc, Atlas.cc) — as padded
structure-of-arrays tables with validity masks:

* KeyFrames live in K_MAX slots: pose (Tcw), velocity, IMU bias, per-keypoint
  arrays (uv, descriptor, octave, depth/right-u), and the observation map
  `kf_obs_mp` [K, N] (map-point id per keypoint slot, -1 = none) which
  replaces both KeyFrame::mvpMapPoints and MapPoint::mObservations.
* MapPoints live in M_MAX slots: position, descriptor, normal, scale range,
  found/visible counters (the found-ratio cull, MapPoint::GetFoundRatio).
* The covisibility graph (KeyFrame::UpdateConnections) is never cached: it is
  recomputed on demand as one matmul over the observation incidence matrix.
* Atlas multi-map: every KF/MP carries a map id; "creating a new map" is a
  counter bump (no allocation), and merging is a relabel + Sim3 transform.
* Slot allocation/culling are masked writes — no reshape, no recompile.

All mutation functions are pure (state in, state out) and jit-compatible.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

NO_MP = -1


class MapState(NamedTuple):
    # --- keyframes ---------------------------------------------------------
    kf_rot: jnp.ndarray        # [K,3,3] Tcw rotation
    kf_t: jnp.ndarray          # [K,3]   Tcw translation
    kf_vel: jnp.ndarray        # [K,3]   world velocity (inertial)
    kf_bias: jnp.ndarray       # [K,6]   (bg, ba)
    kf_time: jnp.ndarray       # [K] f32 seconds since the session's host-held
                               #     f64 time base (SlamSystem.time_base)
    kf_valid: jnp.ndarray      # [K] bool
    kf_map_id: jnp.ndarray     # [K] int32 Atlas map membership
    kf_prev: jnp.ndarray       # [K] int32 temporal predecessor (-1 none)
    kf_uv: jnp.ndarray         # [K,N,2]
    kf_level: jnp.ndarray      # [K,N] int32
    kf_angle: jnp.ndarray      # [K,N]
    kf_desc: jnp.ndarray       # [K,N,8] uint32
    kf_depth: jnp.ndarray      # [K,N]  depth per kp (<=0 = mono)
    kf_kp_valid: jnp.ndarray   # [K,N] bool
    kf_obs_mp: jnp.ndarray     # [K,N] int32 -> mp slot or -1
    # --- map points --------------------------------------------------------
    mp_pos: jnp.ndarray        # [M,3]
    mp_valid: jnp.ndarray      # [M] bool
    mp_desc: jnp.ndarray       # [M,8] uint32
    mp_normal: jnp.ndarray     # [M,3]
    mp_min_dist: jnp.ndarray   # [M]
    mp_max_dist: jnp.ndarray   # [M]
    mp_found: jnp.ndarray      # [M] f32
    mp_visible: jnp.ndarray    # [M] f32
    mp_first_kf: jnp.ndarray   # [M] int32 slot of creating KF
    mp_birth_seq: jnp.ndarray  # [M] int32 kf_counter at creation (culling age)
    mp_map_id: jnp.ndarray     # [M] int32
    kf_counter: jnp.ndarray    # [] int32 total KFs ever inserted
    # --- bookkeeping -------------------------------------------------------
    active_map: jnp.ndarray    # [] int32 current Atlas map id
    n_maps: jnp.ndarray        # [] int32
    imu_initialized: jnp.ndarray  # [] bool (per active map; reset on new map)
    viba1_done: jnp.ndarray    # [] bool (VIBA stage flags, LocalMapping.cc:327)
    viba2_done: jnp.ndarray    # [] bool

    @property
    def k_max(self):
        return self.kf_valid.shape[0]

    @property
    def m_max(self):
        return self.mp_valid.shape[0]

    @property
    def n_kp(self):
        return self.kf_uv.shape[1]


def create(k_max: int = 64, n_kp: int = 1500, m_max: int = 16384,
           dtype=jnp.float32) -> MapState:
    z = jnp.zeros
    return MapState(
        kf_rot=jnp.broadcast_to(jnp.eye(3, dtype=dtype), (k_max, 3, 3)).copy(),
        kf_t=z((k_max, 3), dtype),
        kf_vel=z((k_max, 3), dtype),
        kf_bias=z((k_max, 6), dtype),
        kf_time=z((k_max,), dtype),
        kf_valid=z((k_max,), bool),
        kf_map_id=jnp.full((k_max,), -1, jnp.int32),
        kf_prev=jnp.full((k_max,), -1, jnp.int32),
        kf_uv=z((k_max, n_kp, 2), dtype),
        kf_level=z((k_max, n_kp), jnp.int32),
        kf_angle=z((k_max, n_kp), dtype),
        kf_desc=z((k_max, n_kp, 8), jnp.uint32),
        kf_depth=jnp.full((k_max, n_kp), -1.0, dtype),
        kf_kp_valid=z((k_max, n_kp), bool),
        kf_obs_mp=jnp.full((k_max, n_kp), NO_MP, jnp.int32),
        mp_pos=z((m_max, 3), dtype),
        mp_valid=z((m_max,), bool),
        mp_desc=z((m_max, 8), jnp.uint32),
        mp_normal=z((m_max, 3), dtype),
        mp_min_dist=z((m_max,), dtype),
        mp_max_dist=z((m_max,), dtype),
        mp_found=z((m_max,), dtype),
        mp_visible=z((m_max,), dtype),
        mp_first_kf=jnp.full((m_max,), -1, jnp.int32),
        mp_birth_seq=jnp.full((m_max,), -1, jnp.int32),
        mp_map_id=jnp.full((m_max,), -1, jnp.int32),
        kf_counter=jnp.zeros((), jnp.int32),
        active_map=jnp.zeros((), jnp.int32),
        n_maps=jnp.ones((), jnp.int32),
        imu_initialized=jnp.zeros((), bool),
        viba1_done=jnp.zeros((), bool),
        viba2_done=jnp.zeros((), bool),
    )


# ---------------------------------------------------------------------------
# Slot allocation
# ---------------------------------------------------------------------------

def free_kf_slot(ms: MapState) -> jnp.ndarray:
    """Index of a free KF slot (first invalid). Under capacity pressure the
    oldest *dormant-map* KF may be evicted; live KFs of the ACTIVE map are
    never silently evicted — the host orchestrator checks
    `kf_capacity_left` before inserting and forces a cull / errors instead
    (SlamSystem._ensure_kf_capacity)."""
    score = jnp.where(~ms.kf_valid, -1e9, ms.kf_time
                      + jnp.where(ms.kf_map_id == ms.active_map, jnp.inf, 0.0))
    return jnp.argmin(score).astype(jnp.int32)


def kf_capacity_left(ms: MapState) -> jnp.ndarray:
    """Number of KF slots insertable without evicting a live active-map KF
    (invalid slots + dormant-map slots)."""
    evictable = ~ms.kf_valid | (ms.kf_map_id != ms.active_map)
    return jnp.sum(evictable.astype(jnp.int32))


def free_mp_slots(ms: MapState, count: int, use_mask=None):
    """Allocate `count` map-point slots (invalid first, then lowest found
    ratio under capacity pressure).

    `use_mask` [count] bool marks which positions the caller will actually
    register (callers keep slot lists keypoint-index-aligned, so True
    positions are scattered). The freest slots are permuted onto the True
    positions so a live point is never evicted while an invalid slot goes
    unused, and any still-live slot that *is* about to be recycled gets all
    of its kf_obs_mp references detached first (otherwise stale observations
    would attach to the new unrelated point and corrupt covisibility/BA).

    Returns (ms, slots [count] int32). With use_mask=None behaves as before
    (no detach — caller guarantees capacity)."""
    ratio = ms.mp_found / jnp.maximum(ms.mp_visible, 1.0)
    score = jnp.where(~ms.mp_valid, -1e9, ratio)
    _, idx = jax.lax.top_k(-score, count)
    idx = idx.astype(jnp.int32)
    if use_mask is None:
        return ms, idx
    # permute: freest slots (idx is best-first) onto use_mask=True positions
    order = jnp.argsort(~use_mask, stable=True)       # True positions first
    slots = jnp.zeros_like(idx).at[order].set(idx)
    # detach observations of live slots that are being recycled
    evict = jnp.zeros((ms.m_max,), bool).at[slots].set(
        use_mask & ms.mp_valid[slots])
    obs = ms.kf_obs_mp
    stale = (obs >= 0) & evict[jnp.maximum(obs, 0)]
    ms = ms._replace(
        kf_obs_mp=jnp.where(stale, NO_MP, obs),
        mp_valid=ms.mp_valid & ~evict,
    )
    return ms, slots


# ---------------------------------------------------------------------------
# Keyframe insertion
# ---------------------------------------------------------------------------

def insert_keyframe(ms: MapState, slot, rot, t, vel, bias, time, uv, level,
                    angle, desc, depth, kp_valid, obs_mp, prev_kf) -> MapState:
    return ms._replace(
        kf_rot=ms.kf_rot.at[slot].set(rot),
        kf_t=ms.kf_t.at[slot].set(t),
        kf_vel=ms.kf_vel.at[slot].set(vel),
        kf_bias=ms.kf_bias.at[slot].set(bias),
        kf_time=ms.kf_time.at[slot].set(time),
        kf_valid=ms.kf_valid.at[slot].set(True),
        kf_map_id=ms.kf_map_id.at[slot].set(ms.active_map),
        kf_prev=ms.kf_prev.at[slot].set(prev_kf),
        kf_uv=ms.kf_uv.at[slot].set(uv),
        kf_level=ms.kf_level.at[slot].set(level),
        kf_angle=ms.kf_angle.at[slot].set(angle),
        kf_desc=ms.kf_desc.at[slot].set(desc),
        kf_depth=ms.kf_depth.at[slot].set(depth),
        kf_kp_valid=ms.kf_kp_valid.at[slot].set(kp_valid),
        kf_obs_mp=ms.kf_obs_mp.at[slot].set(obs_mp),
        kf_counter=ms.kf_counter + 1,
    )


def add_map_points(ms: MapState, slots, pos, desc, normal, min_dist, max_dist,
                   first_kf, valid_new) -> MapState:
    """Batch-register new map points at `slots` [P]; valid_new masks rows."""
    def upd(arr, vals):
        cur = arr[slots]
        return arr.at[slots].set(jnp.where(_bmask(valid_new, vals.shape), vals, cur))

    return ms._replace(
        mp_pos=upd(ms.mp_pos, pos),
        mp_valid=ms.mp_valid.at[slots].set(
            jnp.where(valid_new, True, ms.mp_valid[slots])),
        mp_desc=upd(ms.mp_desc, desc),
        mp_normal=upd(ms.mp_normal, normal),
        mp_min_dist=upd(ms.mp_min_dist, min_dist),
        mp_max_dist=upd(ms.mp_max_dist, max_dist),
        mp_found=ms.mp_found.at[slots].set(jnp.where(valid_new, 1.0, ms.mp_found[slots])),
        mp_visible=ms.mp_visible.at[slots].set(jnp.where(valid_new, 1.0, ms.mp_visible[slots])),
        mp_first_kf=upd(ms.mp_first_kf, jnp.broadcast_to(first_kf, slots.shape)),
        mp_birth_seq=upd(ms.mp_birth_seq,
                         jnp.broadcast_to(ms.kf_counter, slots.shape)),
        mp_map_id=upd(ms.mp_map_id, jnp.broadcast_to(ms.active_map, slots.shape)),
    )


def _bmask(mask, shape):
    """Broadcast [P] bool over trailing dims of `shape`."""
    extra = len(shape) - 1
    return mask.reshape(mask.shape + (1,) * extra)


# ---------------------------------------------------------------------------
# Derived structure
# ---------------------------------------------------------------------------

def observation_incidence(ms: MapState) -> jnp.ndarray:
    """[K, M] float32 incidence: KF k observes MP m. Replaces the cached
    covisibility adjacency (KeyFrame::UpdateConnections).

    Built with an idempotent scatter-MAX (duplicate (k,m) pairs — e.g.
    after fusion relabels — are safe), which needs no clamp after a
    scatter-add."""
    k, n = ms.kf_obs_mp.shape
    m = ms.m_max
    obs = ms.kf_obs_mp
    valid = (obs >= 0) & ms.kf_kp_valid & ms.kf_valid[:, None]
    safe = jnp.where(valid, obs, m)          # invalid -> dropped column
    inc = jnp.zeros((k, m + 1), jnp.float32)
    flat_k = jnp.broadcast_to(jnp.arange(k)[:, None], (k, n)).reshape(-1)
    inc = inc.at[flat_k, safe.reshape(-1)].max(1.0, mode="drop")
    return inc[:, :m] * ms.mp_valid[None, :]


def covisibility(ms: MapState, incidence=None) -> jnp.ndarray:
    """[K, K] int32 shared-observation counts (diag zeroed)."""
    inc = observation_incidence(ms) if incidence is None else incidence
    cov = inc @ inc.T
    cov = cov * (1.0 - jnp.eye(ms.k_max, dtype=cov.dtype))
    return cov.astype(jnp.int32)


def mp_observation_count(ms: MapState, incidence=None) -> jnp.ndarray:
    inc = observation_incidence(ms) if incidence is None else incidence
    return jnp.sum(inc, axis=0).astype(jnp.int32)


def local_window(ms: MapState, center_kf: jnp.ndarray, k1: int = 10,
                 n_cand: int = 2048, incidence=None):
    """Local-map KF selection: top-k1 covisible + the center
    (Tracking::UpdateLocalKeyFrames, /root/reference/src/Tracking.cc:4397).
    Returns ([K] bool local-KF mask, [M] bool local-MP mask, [n_cand] int32
    compacted local-MP indices).

    The compacted index list is the per-frame tracker's working set: the
    O(M) top_k compaction runs here, ONCE per map mutation (mapping_step /
    loop events), so track_local_map projects and gates only n_cand points
    per frame instead of all m_max.

    `incidence`: optional precomputed [K,M] table — the mapping megastep
    builds it once and threads it through all consumers (the scatter build
    is the megastep's dominant repeated cost at production capacities)."""
    inc = observation_incidence(ms) if incidence is None else incidence
    cov = covisibility(ms, incidence=inc)
    row = cov[center_kf] * ms.kf_valid * (ms.kf_map_id == ms.active_map)
    _, top = jax.lax.top_k(row, min(k1, ms.k_max))
    kf_mask = jnp.zeros((ms.k_max,), bool).at[top].set(row[top] > 0)
    kf_mask = kf_mask.at[center_kf].set(True)
    mp_mask = (jnp.einsum("k,km->m", kf_mask.astype(jnp.float32), inc) > 0)
    mp_mask = mp_mask & ms.mp_valid
    # compact the first n_cand set indices via cumsum positions: exact
    # index order at O(M), vs a top_k whose f32 -1e-7*i tiebreak collides
    # beyond ~8k entries (f32 eps at 1.0 is 1.2e-7) and costs a full sort
    nc = min(n_cand, ms.m_max)
    pos = jnp.cumsum(mp_mask.astype(jnp.int32)) - 1
    tgt = jnp.where(mp_mask & (pos < nc), pos, nc)
    # filler for unused slots = first UNSET index (consumers re-gate with
    # mp_mask[cand_idx], so filler must never alias a set point); if every
    # point is set the filler is never used (n_set >= nc)
    first_unset = jnp.argmin(mp_mask).astype(jnp.int32)
    cand_idx = jnp.full((nc + 1,), first_unset, jnp.int32).at[tgt].set(
        jnp.arange(ms.m_max, dtype=jnp.int32), mode="drop")[:nc]
    return kf_mask, mp_mask, cand_idx


# ---------------------------------------------------------------------------
# Culling
# ---------------------------------------------------------------------------

def cull_map_points(ms: MapState, min_found_ratio: float = 0.25,
                    min_obs: int = 2, incidence=None) -> MapState:
    """MapPoint culling, reference semantics (LocalMapping::MapPointCulling,
    /root/reference/src/LocalMapping.cc:467): only *recent* points (within
    3 KFs of their birth) are on trial — found-ratio < 0.25 always kills;
    too-few KF observations kills once the point is >= 2 KFs old; points
    that survive 3 KFs become permanent (culled later only by BA outlier
    pruning / fusion)."""
    age = ms.kf_counter - ms.mp_birth_seq              # in KFs
    recent = age <= 3
    n_obs = mp_observation_count(ms, incidence=incidence)
    ratio = ms.mp_found / jnp.maximum(ms.mp_visible, 1.0)
    bad_ratio = ratio < min_found_ratio
    bad_obs = (age >= 2) & (n_obs < min_obs)
    bad = ms.mp_valid & recent & (bad_ratio | bad_obs)
    new_valid = ms.mp_valid & ~bad
    # detach observations of dead points
    obs = ms.kf_obs_mp
    dead_ref = (obs >= 0) & ~new_valid[jnp.maximum(obs, 0)]
    return ms._replace(
        mp_valid=new_valid,
        kf_obs_mp=jnp.where(dead_ref, NO_MP, obs),
    )


def erase_keyframe(ms: MapState, slot) -> MapState:
    """KeyFrame::SetBadFlag analogue: free the slot, detach observations."""
    return ms._replace(
        kf_valid=ms.kf_valid.at[slot].set(False),
        kf_obs_mp=ms.kf_obs_mp.at[slot].set(NO_MP),
        kf_kp_valid=ms.kf_kp_valid.at[slot].set(False),
        kf_prev=jnp.where(ms.kf_prev == slot, ms.kf_prev[slot], ms.kf_prev),
    )


# ---------------------------------------------------------------------------
# Atlas multi-map operations
# ---------------------------------------------------------------------------

def create_new_map(ms: MapState) -> MapState:
    """Tracking::CreateMapInAtlas: current map becomes dormant, new id active."""
    return ms._replace(
        active_map=ms.n_maps,
        n_maps=ms.n_maps + 1,
        imu_initialized=jnp.zeros((), bool),
        viba1_done=jnp.zeros((), bool),
        viba2_done=jnp.zeros((), bool),
    )


def merge_maps(ms: MapState, from_map, into_map, s, rot, t) -> MapState:
    """Relabel `from_map` into `into_map`, applying Sim3 (s, R, t) to its
    KFs and MPs (LoopClosing::MergeLocal essence)."""
    kf_sel = ms.kf_valid & (ms.kf_map_id == from_map)
    mp_sel = ms.mp_valid & (ms.mp_map_id == from_map)
    # world' = s R world + t ; Tcw' for a KF: R_cw' = R_cw R^T, t_cw' = s t_cw - R_cw R^T t
    new_rot = jnp.einsum("kij,lj->kil", ms.kf_rot, rot)   # R_cw @ R^T
    new_t = s * ms.kf_t - jnp.einsum("kij,j->ki", new_rot, t)
    new_pos = s * ms.mp_pos @ rot.T + t
    return ms._replace(
        kf_rot=jnp.where(kf_sel[:, None, None], new_rot, ms.kf_rot),
        kf_t=jnp.where(kf_sel[:, None], new_t, ms.kf_t),
        kf_map_id=jnp.where(kf_sel, into_map, ms.kf_map_id),
        mp_pos=jnp.where(mp_sel[:, None], new_pos, ms.mp_pos),
        mp_map_id=jnp.where(mp_sel, into_map, ms.mp_map_id),
        active_map=jnp.asarray(into_map, jnp.int32),
    )


def apply_scaled_rotation(ms: MapState, rot_gw: jnp.ndarray, scale,
                          translate_vel: bool = True) -> MapState:
    """Map::ApplyScaledRotation after IMU init: rotate gravity to -z and
    rescale (only the active map)."""
    kf_sel = ms.kf_valid & (ms.kf_map_id == ms.active_map)
    mp_sel = ms.mp_valid & (ms.mp_map_id == ms.active_map)
    # Tcw' = Tcw * [R_gw^T/s]: R_cw' = R_cw R_gw^T, t_cw' = s*t_cw (scale world)
    new_rot = jnp.einsum("kij,lj->kil", ms.kf_rot, rot_gw)
    new_t = scale * ms.kf_t
    new_pos = scale * ms.mp_pos @ rot_gw.T
    new_vel = scale * ms.kf_vel @ rot_gw.T if translate_vel else ms.kf_vel
    return ms._replace(
        kf_rot=jnp.where(kf_sel[:, None, None], new_rot, ms.kf_rot),
        kf_t=jnp.where(kf_sel[:, None], new_t, ms.kf_t),
        kf_vel=jnp.where(kf_sel[:, None], new_vel, ms.kf_vel),
        mp_pos=jnp.where(mp_sel[:, None], new_pos, ms.mp_pos),
    )
