"""Atlas + session checkpoints: save/load the whole SLAM session.

Replacement for System::SaveAtlas/LoadAtlas
(/root/reference/src/System.cc:2102-2200): the reference boost-serializes the
pointer graph with a vocabulary MD5 gate; our padded MapState pytree is a
plain npz archive — every field is already a fixed-shape array — plus the
same integrity gate (vocabulary checksum + config fingerprint).

Beyond the reference: `save_session`/`load_session` checkpoint the ENTIRE
tracking session — map, current pose/velocity/bindings, IMU body state and
per-KF preintegration buffers, loop-closer BoW database and consistency
chains — so a restored session CONTINUES tracking mid-stream. The
reference's LoadAtlas cannot do this (it always starts a new active map and
requires relocalizing into the loaded one, System.cc:2102); the padded SoA
state makes it a flat array dump here.
"""
from __future__ import annotations

import hashlib
import json
from typing import Optional, Tuple

import numpy as np
import jax.numpy as jnp

from geoflowslam.state import map_state as M

FORMAT_VERSION = 1


def _vocab_checksum(vocab) -> str:
    """MD5 over the vocabulary tree (CalculateCheckSum analogue)."""
    if vocab is None:
        return "none"
    h = hashlib.md5()
    for lvl in vocab.centers:
        h.update(np.asarray(lvl).tobytes())
    h.update(np.asarray(vocab.weights).tobytes())
    return h.hexdigest()


def save_atlas(path: str, ms: M.MapState, vocab=None, extra: Optional[dict] = None):
    """Write <path>.npz with all MapState fields + metadata."""
    arrays = {f: np.asarray(getattr(ms, f)) for f in ms._fields}
    meta = {
        "format_version": FORMAT_VERSION,
        "vocab_checksum": _vocab_checksum(vocab),
        "fields": list(ms._fields),
        "extra": extra or {},
    }
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_atlas(path: str, vocab=None, check_vocab: bool = True) -> Tuple[M.MapState, dict]:
    """Load a MapState; verifies the vocabulary checksum like LoadAtlas."""
    data = np.load(path if path.endswith(".npz") else path + ".npz")
    meta = json.loads(bytes(data["__meta__"]).decode())
    if meta["format_version"] != FORMAT_VERSION:
        raise ValueError(f"atlas format {meta['format_version']} != {FORMAT_VERSION}")
    if check_vocab and vocab is not None:
        cs = _vocab_checksum(vocab)
        if cs != meta["vocab_checksum"]:
            raise ValueError(
                "vocabulary checksum mismatch (the reference refuses to load "
                f"an atlas built with a different vocabulary): {cs} != "
                f"{meta['vocab_checksum']}")
    fields = {f: jnp.asarray(data[f]) for f in meta["fields"]}
    return M.MapState(**fields), meta.get("extra", {})


# -- full-session checkpoints (continue capability) --------------


def save_session(path: str, slam) -> None:
    """Checkpoint a SlamSystem mid-run so `load_session` can CONTINUE it.

    Captures: MapState, tracking state (pose, motion model, keypoint->map
    bindings), IMU tracker (bias, body state, per-KF preintegration buffers,
    raw pending samples, init flags), loop-closer BoW database +
    temporal-consistency chains, and the host bookkeeping mirrors. Transient
    pipeline state (pkt ring, deferred decisions, trajectory) is flushed
    first and restarts empty after load. OF/ICP/lidar per-frame chaining
    state (last_frame, KF clouds) is NOT checkpointed — after a restore
    those stages re-arm on the next frame, exactly as after a map update.
    """
    slam._flush_pending()
    arrays = {}
    for f in slam.ms._fields:
        arrays[f"ms.{f}"] = np.asarray(getattr(slam.ms, f))

    def put(key, val):
        if val is not None:
            arrays[key] = np.asarray(val)

    put("sys.cur_rot", slam.cur_rot)
    put("sys.cur_t", slam.cur_t)
    put("sys.vel_rot", slam.vel[0])
    put("sys.vel_t", slam.vel[1])
    put("sys.last_obs_mp", slam.last_obs_mp)
    put("sys.last_levels", slam._last_levels)
    put("sys.vi_prior", getattr(slam, "_vi_prior", None))

    imu = slam.imu
    imu_meta = None
    if imu is not None:
        put("imu.bias", imu.bias_host if imu.bias_host is not None
            else imu.bias)
        if imu.body is not None:
            for f in imu.body._fields:
                put(f"imu.body.{f}", getattr(imu.body, f))
        for slot, p in imu.kf_preints.items():
            for f in p._fields:
                put(f"imu.preint.{slot}.{f}", getattr(p, f))
        # raw pending samples since the last KF (so the next KF's segment
        # stays exact across the checkpoint)
        for i, (acc, gyro, dts, ts) in enumerate(imu._chunks):
            put(f"imu.chunk.{i}.acc", acc)
            put(f"imu.chunk.{i}.gyro", gyro)
            put(f"imu.chunk.{i}.dts", dts)
        imu_meta = {
            "initialized": imu.initialized,
            "init_time": imu.init_time,
            "viba1_done": imu.viba1_done,
            "viba2_done": imu.viba2_done,
            "kf_order": list(imu.kf_order),
            "preint_fields": (list(next(iter(imu.kf_preints.values()))._fields)
                              if imu.kf_preints else []),
            "chunk_ts": [c[3] for c in imu._chunks],
            "has_body": imu.body is not None,
        }

    lc = slam.loop_closer
    if lc is not None:
        put("loop.bow", lc.db.bow)
        put("loop.valid", lc.db.valid)
        put("loop.groups", lc._groups)
        put("loop.counts", lc._counts)
    elif getattr(slam, "_reloc_db", None) is not None:
        put("relocdb.bow", slam._reloc_db.bow)
        put("relocdb.valid", slam._reloc_db.valid)

    meta = {
        "format_version": FORMAT_VERSION,
        "vocab_checksum": _vocab_checksum(slam.vocab),
        "ms_fields": list(slam.ms._fields),
        "sys": {
            "state": slam.state.name,
            "has_vel": bool(slam.has_vel),
            "ref_kf": slam.ref_kf,
            "ref_kf_inliers": slam.ref_kf_inliers,
            "frames_since_kf": slam.frames_since_kf,
            "last_time": slam.last_time,
            "time_base": slam.time_base,
            "lost_since": slam.lost_since,
            "n_frames": slam.n_frames,
            "n_lost": slam.n_lost,
            "last_kf_time": slam._last_kf_time,
            "gen_counter": slam._gen_counter,
            "kf_gen": {str(k): v for k, v in slam._kf_gen.items()},
            "kf_prev": {str(k): v for k, v in slam._kf_prev_h.items()},
            "last_kf_slot": getattr(slam, "_last_kf_slot", None),
        },
        "imu": imu_meta,
        "loop": ({"n_loops": lc.n_loops, "n_merges": lc.n_merges}
                 if lc is not None else None),
    }
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8)
    np.savez(path + ".tmp.npz", **arrays)
    import os
    os.replace(path + ".tmp.npz", path if path.endswith(".npz")
               else path + ".npz")


def load_session(path: str, slam) -> dict:
    """Restore a `save_session` checkpoint INTO an existing SlamSystem
    (its SystemConfig must match the saved one's capacities) and continue
    tracking from the checkpointed frame. Returns the session meta dict."""
    data = np.load(path if path.endswith(".npz") else path + ".npz")
    meta = json.loads(bytes(data["__meta__"]).decode())
    if meta["format_version"] != FORMAT_VERSION:
        raise ValueError(
            f"session format {meta['format_version']} != {FORMAT_VERSION}")
    if slam.vocab is not None:
        cs = _vocab_checksum(slam.vocab)
        if cs != meta["vocab_checksum"]:
            raise ValueError(f"vocabulary checksum mismatch: {cs} != "
                             f"{meta['vocab_checksum']}")
    ms_fields = {f: jnp.asarray(data[f"ms.{f}"]) for f in meta["ms_fields"]}
    ms = M.MapState(**ms_fields)
    if ms.k_max != slam.cfg.k_max or ms.m_max != slam.cfg.m_max:
        raise ValueError("session capacities do not match SystemConfig")

    from geoflowslam.pipeline import system as SYS
    s = meta["sys"]
    slam.ms = ms
    slam.state = SYS.TrackingState[s["state"]]
    slam.cur_rot = jnp.asarray(data["sys.cur_rot"])
    slam.cur_t = jnp.asarray(data["sys.cur_t"])
    slam.vel = (jnp.asarray(data["sys.vel_rot"]),
                jnp.asarray(data["sys.vel_t"]))
    slam.has_vel = s["has_vel"]
    slam.last_obs_mp = (jnp.asarray(data["sys.last_obs_mp"])
                        if "sys.last_obs_mp" in data else None)
    slam._last_levels = (np.asarray(data["sys.last_levels"])
                         if "sys.last_levels" in data else None)
    slam._vi_prior = (jnp.asarray(data["sys.vi_prior"])
                      if "sys.vi_prior" in data else None)
    slam.ref_kf = int(s["ref_kf"])
    slam.ref_kf_inliers = int(s["ref_kf_inliers"])
    slam.frames_since_kf = int(s["frames_since_kf"])
    slam.last_time = float(s["last_time"])
    slam.time_base = s["time_base"]
    slam.lost_since = s["lost_since"]
    slam.n_frames = int(s["n_frames"])
    slam.n_lost = int(s["n_lost"])
    slam._last_kf_time = float(s["last_kf_time"])
    slam._gen_counter = int(s["gen_counter"])
    slam._kf_gen = {int(k): v for k, v in s["kf_gen"].items()}
    slam._kf_prev_h = {int(k): v for k, v in s["kf_prev"].items()}
    slam._last_kf_slot = s.get("last_kf_slot")
    # transient pipeline state restarts empty
    slam._traj = []
    slam._culled_rel = {}
    slam._deferred = []
    slam._pending_by_seq = {}
    slam._pkt_last_seq = slam._pkt_seq
    slam._recovering = False
    slam._mirror_dirty = True
    slam._local_masks = None
    slam._vi_state = None
    slam.last_frame = None
    slam._kf_clouds.clear()
    slam._kf_icp_rel.clear()

    im = meta.get("imu")
    if im is not None and slam.imu is not None:
        from geoflowslam.imu import preintegration as pre
        from geoflowslam.solvers import inertial as VI
        imu = slam.imu
        imu.bias = jnp.asarray(data["imu.bias"])
        imu.bias_host = np.asarray(data["imu.bias"])
        if im["has_body"]:
            imu.body = VI.BodyState(**{
                f: jnp.asarray(data[f"imu.body.{f}"])
                for f in VI.BodyState._fields})
        imu.initialized = im["initialized"]
        imu.init_time = im["init_time"]
        imu.viba1_done = im["viba1_done"]
        imu.viba2_done = im["viba2_done"]
        imu.kf_order = list(im["kf_order"])
        imu.kf_preints = {}
        for slot in imu.kf_order:
            key0 = f"imu.preint.{slot}.dt"
            if key0 in data:
                imu.kf_preints[slot] = pre.Preintegrated(**{
                    f: np.asarray(data[f"imu.preint.{slot}.{f}"])
                    for f in im["preint_fields"]})
        imu._chunks = []
        for i, ts in enumerate(im["chunk_ts"]):
            imu._chunks.append((np.asarray(data[f"imu.chunk.{i}.acc"]),
                                np.asarray(data[f"imu.chunk.{i}.gyro"]),
                                np.asarray(data[f"imu.chunk.{i}.dts"]), ts))

    lo = meta.get("loop")
    if lo is not None and slam.loop_closer is not None:
        from geoflowslam.retrieval import kf_database as DBD
        lc = slam.loop_closer
        lc.db = DBD.KFDatabase(bow=jnp.asarray(data["loop.bow"]),
                               valid=jnp.asarray(data["loop.valid"]))
        lc._groups = jnp.asarray(data["loop.groups"])
        lc._counts = jnp.asarray(data["loop.counts"])
        lc.n_loops = lo["n_loops"]
        lc.n_merges = lo["n_merges"]
    if "relocdb.bow" in data and getattr(slam, "_reloc_db", None) is not None:
        from geoflowslam.retrieval import kf_database as DBD
        slam._reloc_db = DBD.KFDatabase(
            bow=jnp.asarray(data["relocdb.bow"]),
            valid=jnp.asarray(data["relocdb.valid"]))
    return meta
