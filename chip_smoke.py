#!/usr/bin/env python
"""Smoke run of the SLAM system on one NVIDIA GPU, through its public API.

    python chip_smoke.py               # every phase below, on jax.devices()[0]
    python chip_smoke.py --multichip   # only the 4-GPU global-BA phase

Phases, in order, one line each; any failure exits non-zero:

1. device    refuse anything but a GPU; print the card, its power limit and
             whether the native host library loaded.
2. kernels   the card tests (`pytest -m gpu tests/test_on_card.py`), run in
             this process:
             FAST, the gated projection search and LK as compiled for the
             card, against the same code on the host CPU backend.
3. main      `track_rgbd_inertial` at bench.py's configuration (640x480,
             1000 ORB features on 8 levels, 200 Hz IMU, k_max=256,
             m_max=65536, loop closing on, m12 feed) on the synthetic room.
4. geoflow   `track_rgbd` with optical flow, GICP and lidar point-to-plane
             factors on, same capacities.

Both SLAM phases must end OK in one map with ATE under the end-to-end
tests' bound (tests/test_e2e_rgbd.py, tests/test_e2e_inertial.py).

The last line of stdout is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from geoflowslam.utils.device import card_info, describe, require_gpu

HERE = os.path.dirname(os.path.abspath(__file__))

# tests/test_e2e_rgbd.py and tests/test_e2e_inertial.py gate ATE at 5 cm
ATE_BOUND_M = 0.05
# 300 frames (10 s) reach IMU init, VI local BA on several KFs, the
# per-KF mapping megastep, loop-detection dispatches and VIBA1 (init + 5 s);
# 150 frames put LK, GICP and the point-to-plane factors on the card
MAIN_FRAMES = 300
GEOFLOW_FRAMES = 150
CARD_TESTS_ENV = "GEOFLOW_CARD_TESTS"   # tests/conftest.py: keep the card
# the gpu-marked tests; named alone so that collection imports no other
# test module (their imports need not resolve on the card's machine)
CARD_TESTS = os.path.join(HERE, "tests", "test_on_card.py")


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def check(ok, what) -> None:
    """A failed check fails the run (kept under python -O, unlike assert)."""
    if not ok:
        raise RuntimeError(f"check failed: {what}")


# ---------------------------------------------------------------------------
# kernels vs the plain reference on the host CPU backend
# ---------------------------------------------------------------------------

def _on(device, fn, *args):
    """Run `fn` jitted on `device` with host inputs; host results."""
    import jax
    args = jax.device_put(args, device)
    return jax.device_get(jax.jit(fn)(*args))


def _scene(h: int, w: int, seed: int, dt: float = 1.0 / 30):
    """Two consecutive renders of the synthetic room (host float32)."""
    import jax
    from geoflowslam.io import synthetic as S
    cam = S.Camera(fx=w * 0.625, fy=w * 0.625, cx=w / 2, cy=h / 2,
                   width=w, height=h)
    world = S.SyntheticWorld(cam, seed=seed)
    t0 = 1.0 + 0.1 * seed
    _, _, rot_cw, t_cw = S.trajectory_poses(S.smooth_trajectory,
                                            np.array([t0, t0 + dt]))
    render = jax.jit(world.render)
    return [np.asarray(render(rot_cw[i], t_cw[i])[0]) for i in range(2)]


def check_fast(card, host, h=480, w=640, seed=0) -> str:
    """FAST two-threshold scores on a full level and the odd pyramid widths
    (1.2 scale factor: 533, 444): scores to 1e-4 and the detected keypoint
    positions bit-exact."""
    from geoflowslam.ops import fast as F
    from geoflowslam.ops.pyramid import build_pyramid
    img = _scene(h, w, seed)[0]
    levels = _on(host, lambda x: tuple(build_pyramid(x, 3, 1.2)), img)
    worst = 0.0
    shapes = []
    for lvl in levels:
        def f(x):
            lo, hi = F.fast_score_maps(x, [7.0, 20.0])
            kp = F.detect_level(x, 1000, 20.0, 7.0)
            return lo, hi, kp.xy, kp.valid
        got = _on(card, f, lvl)
        ref = _on(host, f, lvl)
        for g, r in zip(got[:2], ref[:2]):
            err = float(np.abs(g - r).max())
            worst = max(worst, err)
            check(err <= 1e-4, f"FAST score {lvl.shape}: {err}")
        check(np.array_equal(got[2], ref[2]) and np.array_equal(
            got[3], ref[3]), f"FAST keypoints differ at {lvl.shape}")
        shapes.append(f"{lvl.shape[0]}x{lvl.shape[1]}")
    return (f"FAST {', '.join(shapes)}: keypoints bit-exact, max score "
            f"error {worst:g} (bound 1e-4)")


def check_search(card, host, n=1250, seed=0) -> str:
    """Gated projection search (motion-model radius 15 px x 1.2^octave,
    octave window [-1, +1]) at N = M: match indices bit-exact. Distances
    are integers from a product of +-1 operands, exact in any precision."""
    from geoflowslam.ops import matching as MT
    rng = np.random.RandomState(seed)
    m = n
    feat_uv = rng.uniform([0, 0], [640, 480], (m, 2)).astype(np.float32)
    feat_level = rng.randint(0, 8, m).astype(np.int32)
    feat_desc = rng.randint(0, 2 ** 32, (m, 8), dtype=np.uint64).astype(
        np.uint32)
    feat_valid = rng.rand(m) < 0.95
    # queries: noisy re-observations of the targets plus unrelated points
    src = rng.permutation(m)[:n]
    flips = rng.randint(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(
        np.uint32) & rng.randint(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(
        np.uint32) & rng.randint(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(
        np.uint32)
    desc_q = feat_desc[src] ^ flips
    uv_q = feat_uv[src] + rng.normal(0, 4, (n, 2)).astype(np.float32)
    lvl_q = np.clip(feat_level[src] + rng.randint(-1, 2, n), 0, 7).astype(
        np.int32)
    stray = rng.rand(n) < 0.2
    desc_q[stray] = rng.randint(0, 2 ** 32, (int(stray.sum()), 8),
                                dtype=np.uint64).astype(np.uint32)
    valid_q = rng.rand(n) < 0.95
    radius = (15.0 * 1.2 ** lvl_q).astype(np.float32)

    def f(*a):
        return MT.search_by_projection(*a, max_dist=MT.TH_HIGH)
    args = (uv_q, lvl_q, valid_q, desc_q, feat_uv, feat_level, feat_desc,
            feat_valid, radius)
    gi, gd = _on(card, f, *args)
    ri, rd = _on(host, f, *args)
    check(np.array_equal(gi, ri),
          f"search: {int((gi != ri).sum())} of {n} indices differ")
    check(np.array_equal(gd, rd), "search: distances differ")
    return (f"search N=M={n}: indices bit-exact, {int((gi >= 0).sum())} "
            f"matches")


# LK tolerances. The card sums each 21x21 window in another order than the
# CPU, so float32 results differ in the last bits, and 10 Gauss-Newton steps
# on 4 levels can carry that to a few thousandths of a pixel; a point whose
# structure tensor sits at the min-eigenvalue gate or whose forward-backward
# error sits at its threshold can flip status.
LK_POS_TOL_PX = 0.01      # on 99% of the points both sides track
LK_STATUS_AGREE = 0.99    # share of points with the same status


def check_lk(card, host, n=1000, h=480, w=640, seed=0) -> str:
    """klt_track and fb_klt_track at N points, win=21, 10 iterations, 4
    levels of a 640x480 pyramid, seeded at FAST corners of a real render."""
    from geoflowslam.ops import fast as F
    from geoflowslam.ops import klt as K
    prev, nxt = _scene(h, w, seed)
    pts = _on(host, lambda x: F.detect_level(x, n, 20.0, 7.0).xy, prev)

    def f(a, b, p):
        pa = K.build_lk_pyramid(a, 4)
        pb = K.build_lk_pyramid(b, 4)
        fw = K.klt_track(pa, pb, p, win=21, iters=10)
        fb = K.fb_klt_track(pa, pb, p, win=21, iters=10, fb_thresh=0.5)
        return fw.pts, fw.status, fb.pts, fb.status
    got = _on(card, f, prev, nxt, pts)
    ref = _on(host, f, prev, nxt, pts)
    parts = []
    for name, gp, gs, rp, rs in (("klt", got[0], got[1], ref[0], ref[1]),
                                 ("fb_klt", got[2], got[3], ref[2], ref[3])):
        agree = float(np.mean(gs == rs))
        both = gs & rs
        d = np.abs(gp - rp).max(axis=1)[both]
        q99 = float(np.quantile(d, 0.99)) if d.size else 0.0
        check(agree >= LK_STATUS_AGREE, f"{name}: status agreement {agree}")
        check(q99 <= LK_POS_TOL_PX, f"{name}: 99th pct position {q99} px")
        parts.append(f"{name} status agree {agree:.4f} (>= "
                     f"{LK_STATUS_AGREE}), p99 |dpos| {q99:.2e} px (<= "
                     f"{LK_POS_TOL_PX}), {int(rs.sum())} tracked")
    return f"LK N={n} win=21 4 levels: " + "; ".join(parts)


def phase_kernels() -> None:
    import jax
    import pytest
    say("kernels", f"matmul precision {jax.config.jax_default_matmul_precision}"
        "; reference = the same jitted code on the host CPU backend")
    os.environ[CARD_TESTS_ENV] = "1"
    rc = pytest.main(["-q", "-s", "-m", "gpu", "-p", "no:cacheprovider",
                      "-p", "no:randomly", CARD_TESTS])
    if rc != 0:
        raise RuntimeError(f"card tests failed (pytest rc {int(rc)})")
    say("kernels", "card tests passed")


# ---------------------------------------------------------------------------
# SLAM phases
# ---------------------------------------------------------------------------

def _run_slam(phase: str, slam, frames, gt, step, n_timed: int, clog,
              tail: float) -> dict:
    """Feed `frames` through `step(i)`, time the last n_timed, check the
    end state and the ATE of the last `tail` share of the trajectory."""
    import jax
    from geoflowslam.eval.ate import ate_rmse
    n = len(frames)
    t_begin = time.time()
    t_warm = None
    for i in range(n):
        if i == n - n_timed:
            jax.block_until_ready(slam.cur_t)
            t_warm = time.time()
        step(i)
    jax.block_until_ready(slam.cur_t)
    t_end = time.time()
    fps = n_timed / (t_end - t_warm)
    comp_all = clog.since(t_begin)
    comp_timed = clog.since(t_warm)
    st = slam.map_stats()
    k = int(n * tail)
    m = ate_rmse(slam.trajectory[-k:], gt[-k:])
    say(phase, f"{n} frames, map {st}, n_lost {slam.n_lost}")
    say(phase, f"ATE {m['ate_rmse']:.4f} m over the last {k} frames "
        f"(bound {ATE_BOUND_M} m)")
    say(phase, f"{fps:.2f} FPS over the last {n_timed} frames "
        f"(block_until_ready on the last pose) on {card_info()}")
    say(phase, f"compiles: {comp_all['n']} in the phase ({comp_all['sec']} s)"
        f", {comp_timed['n']} in the timed frames ({comp_timed['sec']} s); "
        f"phase wall {t_end - t_begin:.1f} s")
    check(st["state"] == "OK", f"{phase} final state {st}")
    check(st["n_maps"] == 1, f"{phase} map count {st}")
    check(m["ate_rmse"] < ATE_BOUND_M, f"{phase} ATE {m}")
    return {"fps": fps, "ate": m["ate_rmse"], "map": st}


def _gt(rot_wc, p, ts):
    out = []
    for i, t in enumerate(ts):
        twc = np.eye(4)
        twc[:3, :3] = rot_wc[i]
        twc[:3, 3] = p[i]
        out.append((float(t), twc))
    return out


def _bench_config(**extra):
    """bench.py's configuration: 640x480, 1000 features on 8 levels, the
    production capacities, loop closing on, m12 feed."""
    from geoflowslam.io.synthetic import Camera
    from geoflowslam.ops.extractor import OrbConfig
    from geoflowslam.pipeline.loop_closing import LoopConfig
    from geoflowslam.pipeline.system import SystemConfig
    from geoflowslam.state.frame import FrameConfig
    cam = Camera()
    orb = OrbConfig(n_features=1000, n_levels=8, height=cam.height,
                    width=cam.width)
    fc = FrameConfig(orb=orb, lk_levels=4, cloud_stride=4, cloud_max_pts=4096,
                     depth_map_factor=1.0, feed_codec="m12",
                     n_of_slots=extra.pop("n_of_slots", 0))
    cfg = SystemConfig(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, bf=40.0,
                       frame=fc, loop=LoopConfig(), **extra)
    check(cfg.k_max == 256 and cfg.m_max == 65536, "production capacities")
    return cam, cfg


def phase_main(n_frames: int, clog) -> dict:
    import jax
    from geoflowslam.io import synthetic as S
    from geoflowslam.pipeline.inertial import ImuConfig
    from geoflowslam.pipeline.system import SlamSystem
    from geoflowslam.retrieval.vocab import default_vocabulary
    # bench.py's early IMU init (4 KFs, 0.8 s)
    cam, cfg = _bench_config(imu=ImuConfig(init_min_kfs=4, init_min_time=0.8))
    fps_in = 30.0
    ts = np.arange(n_frames) / fps_in
    rot_wc, p, rot_cw, t_cw = S.trajectory_poses(S.smooth_trajectory, ts)
    acc, gyro, dts = S.imu_samples(S.smooth_trajectory, ts, fps_in)
    t0 = time.time()
    bufs = S.render_sequence(S.SyntheticWorld(cam), rot_cw, t_cw)
    say("main", f"rendered {n_frames} m12 frames in {time.time() - t0:.1f} s")
    slam = SlamSystem(cfg, vocab=default_vocabulary())

    def step(i):
        if i == 0:
            slam.track_rgbd(bufs[i], None, ts[i])
        else:
            slam.track_rgbd_inertial(bufs[i], None, acc[i], gyro[i], dts,
                                     ts[i])
    out = _run_slam("main", slam, bufs, _gt(rot_wc, p, ts), step,
                    n_timed=min(100, n_frames // 3), clog=clog, tail=0.5)
    check(slam.imu.initialized, "IMU initialized")
    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    say("main", f"IMU initialized; device peak_bytes_in_use "
        f"{peak if peak is None else f'{peak / 2**30:.3f} GiB ({peak} B)'}")
    out["peak_bytes"] = peak
    slam.shutdown()
    return out


def phase_geoflow(n_frames: int, clog) -> dict:
    from geoflowslam.io import synthetic as S
    from geoflowslam.pipeline.system import SlamSystem
    from geoflowslam.retrieval.vocab import default_vocabulary
    cam, cfg = _bench_config(use_of=True, use_icp=True, use_lidar=True,
                             n_of_slots=256)
    fps_in = 30.0
    ts = np.arange(n_frames) / fps_in
    rot_wc, p, rot_cw, t_cw = S.trajectory_poses(S.smooth_trajectory, ts)
    bufs = S.render_sequence(S.SyntheticWorld(cam), rot_cw, t_cw)
    slam = SlamSystem(cfg, vocab=default_vocabulary())
    out = _run_slam("geoflow", slam, bufs, _gt(rot_wc, p, ts),
                    lambda i: slam.track_rgbd(bufs[i], None, ts[i]),
                    n_timed=min(50, n_frames // 3), clog=clog, tail=1.0)
    slam.shutdown()
    return out


# ---------------------------------------------------------------------------
# 4 GPUs: distributed global BA against the same step on one GPU
# ---------------------------------------------------------------------------

def phase_multichip(devices) -> None:
    import jax
    from jax.sharding import Mesh
    import __graft_entry__ as G
    from geoflowslam.pipeline import local_mapping as LM
    if len(devices) < 4:
        raise SystemExit(f"--multichip needs 4 GPUs, found {len(devices)}")
    ms, pts = G._populated_production_map()
    res = {}
    for n in (1, 4):
        mesh = Mesh(np.array(devices[:n]), axis_names=("land",))
        step = lambda: LM.global_ba_step_distributed(
            ms, LM.MappingConfig(), mesh, ba_pts=4096, iters=2)
        jax.block_until_ready(step().kf_t)      # compile + warm
        t0 = time.time()
        out = step()
        jax.block_until_ready(out.kf_t)
        dt = time.time() - t0
        kf_t, mp = np.asarray(out.kf_t), np.asarray(out.mp_pos[:4096])
        check(np.isfinite(kf_t).all() and np.isfinite(mp).all(),
              f"finite global BA state on {n} device(s)")
        err = float(np.median(np.linalg.norm(mp - np.asarray(pts), axis=1)))
        res[n] = (kf_t, mp)
        say("multichip", f"{n} device(s): global BA step (256 KFs, 4096 "
            f"landmarks, 2 GN iterations) {dt * 1000:.1f} ms, median landmark "
            f"error {err:.4f} m (injected 0.02 m offset)")
        check(err < 0.02, f"landmark error {err} on {n} device(s)")
    dk = float(np.abs(res[4][0] - res[1][0]).max())
    dm = float(np.abs(res[4][1] - res[1][1]).max())
    say("multichip", f"4 vs 1 device(s): max |d kf_t| {dk:.2e} m, max |d mp_pos| "
        f"{dm:.2e} m (bound 1e-3 m: psum order differs)")
    check(dk < 1e-3 and dm < 1e-3, f"4 vs 1 device(s): {dk}, {dm}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multichip", action="store_true",
                    help="run only the 4-GPU distributed global-BA phase")
    args = ap.parse_args()

    # the kernel phase compares against the host CPU backend of this process
    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"
    import jax
    devices = jax.devices()
    require_gpu(devices)
    dev = devices[0]
    say("device", describe(devices))
    print(card_info(), flush=True)      # name, power limit as nvidia-smi has them
    from geoflowslam.imu import native_preint as NP
    from geoflowslam.utils.compile_log import (enable_persistent_cache,
                                               install)
    cache = enable_persistent_cache()
    clog = install()
    say("device", f"native host library (native/libgfs_native.so) "
        f"{'loaded' if NP.available() else 'NOT loaded: numpy fallback'}; "
        f"compile cache {cache}")

    if args.multichip:
        phase_multichip(devices)
    else:
        phase_kernels()
        phase_main(MAIN_FRAMES, clog)
        phase_geoflow(GEOFLOW_FRAMES, clog)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
