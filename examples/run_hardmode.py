#!/usr/bin/env python
"""Hard-mode standing benchmark: the parity run in lieu of real datasets.

A long synthetic sequence (default 2000 frames ≈ 66 s) with epoch-scale
timestamps (t0 = 1.4e9 s, the TUM/EuRoC regime), loop revisits every 40 s,
fast-rotation bursts, and periodic texture-poor segments. Reports ATE/RPE,
map health (no capacity eviction, tracking state), and per-KF mapping cost
flatness — the VERDICT round-2 acceptance run.

    python examples/run_hardmode.py [--mode rgbd|rgbd_inertial|mono]
        [--frames 2000] [--out results_hard]
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="rgbd_inertial",
                    choices=["rgbd", "rgbd_inertial", "mono"])
    ap.add_argument("--frames", type=int, default=2000)
    ap.add_argument("--fps", type=float, default=30.0)
    ap.add_argument("--t0", type=float, default=1.4e9)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--features", type=int, default=1000)
    ap.add_argument("--out", default="results_hard")
    ap.add_argument("--print-every", type=int, default=100,
                    help="progress/timing print cadence (frames)")
    ap.add_argument("--loop", action="store_true",
                    help="enable loop closing with the bundled vocabulary")
    ap.add_argument("--viewer", action="store_true",
                    help="render an incremental map/frame view per KF "
                         "(out/viewer/view_*.png + run.gif)")
    ap.add_argument("--pkt-interval", type=float, default=None,
                    help="override SystemConfig.pkt_read_interval (decision "
                         "ring read pacing)")
    ap.add_argument("--of", action="store_true",
                    help="enable dual-stream optical-flow tracking "
                         "(UseOpticalFlow; fused into the single-dispatch "
                         "fast path)")
    ap.add_argument("--icp", action="store_true",
                    help="enable the GICP pose predictor + inter-KF EdgeICP "
                         "(UseICP; fused into the fast path, lazy KF "
                         "registration)")
    ap.add_argument("--lidar", action="store_true",
                    help="enable the lidar point-to-plane joint refinement "
                         "against the sliding local cloud map "
                         "(UsePointCloudObs; fused into the fast path). "
                         "The flagship G1 combo is --of --icp --lidar")
    args = ap.parse_args()

    from geoflowslam.utils.compile_log import (install,
                                               enable_persistent_cache)
    import jax
    from geoflowslam.utils.device import card_info
    dev = jax.devices()[0]
    enable_persistent_cache()
    clog = install()

    from geoflowslam.io.synthetic import (SyntheticWorld,
                                          HardSyntheticSequence, Camera)
    from geoflowslam.pipeline.system import SlamSystem, SystemConfig
    from geoflowslam.pipeline.loop_closing import LoopConfig
    from geoflowslam.pipeline.inertial import ImuConfig
    from geoflowslam.state.frame import FrameConfig
    from geoflowslam.ops.extractor import OrbConfig
    from geoflowslam.eval.ate import ate_rmse, rpe

    w, h = args.width, args.height
    cam = Camera(fx=w * 0.625, fy=w * 0.625, cx=w / 2, cy=h / 2,
                 width=w, height=h)
    orb = OrbConfig(n_features=args.features, n_levels=8 if w >= 640 else 4,
                    height=h, width=w)
    # m12 packed host feed for RGB-D modes (the bench's production wire
    # format): frames are pre-rendered and packed before the loop, so the
    # tracking loop queues no render program per frame. Frame parameters
    # match bench.py so the runs share its compiled programs.
    fc = FrameConfig(orb=orb, bf=cam.fx * 0.1, lk_levels=4, cloud_stride=4,
                     cloud_max_pts=4096, depth_map_factor=1.0,
                     # OF dual-stream needs reserved append slots
                     # (Frame::AddPts capacity); 256 matches the ablation
                     # tests and changes the frame shapes, so the --of cell
                     # compiles its own fused program
                     n_of_slots=256 if args.of else 0,
                     feed_codec="raw" if args.mode == "mono" else "m12")
    imu = ImuConfig() if args.mode == "rgbd_inertial" else None
    # the vocabulary (and with it the reloc KF database + the fused
    # frame-rate recovery path) is ALWAYS loaded — the reference's
    # KeyFrameDatabase exists regardless of loop closing (System.cc:
    # mpKeyFrameDatabase feeds Tracking::Relocalization); --loop only
    # controls the LoopClosing stage
    from geoflowslam.retrieval.vocab import default_vocabulary
    vocab = default_vocabulary()
    loop_cfg = LoopConfig() if args.loop else None
    extra = {}
    if args.pkt_interval is not None:
        extra["pkt_read_interval"] = args.pkt_interval
    if args.of:
        extra["use_of"] = True
    if args.icp:
        extra["use_icp"] = True
    if args.lidar:
        extra["use_lidar"] = True
    cfg = SystemConfig(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
                       bf=cam.fx * 0.1, frame=fc, imu=imu, loop=loop_cfg,
                       sensor="mono" if args.mode == "mono" else "rgbd",
                       # bench capacities (2000 frames at the 0.5 s KF
                       # cadence plus culling stay well under 128 KFs)
                       k_max=128, m_max=32768,
                       **extra)
    world = SyntheticWorld(cam)
    seq = HardSyntheticSequence(world, fps=args.fps)
    slam = SlamSystem(cfg, vocab=vocab)

    viewer = None
    if args.viewer:
        from geoflowslam.viewer.viewer import LiveViewer
        viewer = LiveViewer(os.path.join(args.out, "viewer"))

    # ---- GT poses + IMU for the whole sequence, one dispatch each (the
    # loop below then does no per-frame device work besides SLAM) ---------
    from geoflowslam.io.synthetic import (contrast_schedule,
                                          hard_trajectory, imu_samples,
                                          render_sequence,
                                          trajectory_poses)
    ts_all = np.arange(args.frames) / args.fps
    rot_wc_a, p_a, rot_cw_a, t_cw_a = trajectory_poses(
        hard_trajectory, ts_all, seq.period)
    if args.mode == "rgbd_inertial":
        acc_a, gyro_a, dts_1 = imu_samples(hard_trajectory, ts_all, args.fps,
                                           seq.period, imu_rate=seq.imu_rate)

    # ---- pre-render the sequence to HOST memory (bench operating mode:
    # the timed loop feeds packed host buffers, no render in the queue).
    # The render is deterministic in (mode kind, frames, fps, w, h), so it
    # is cached on disk inside the checkout: a matrix run renders each
    # geometry once instead of per cell --------------------------------------
    t0r = time.time()
    kind = "gray" if args.mode == "mono" else "m12"
    cache_dir = os.environ.get("GFS_FRAME_CACHE", os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".cache", "hard_frames"))
    os.makedirs(cache_dir, exist_ok=True)
    cpath = os.path.join(
        cache_dir, f"{kind}_{args.frames}_{args.fps:g}_{w}x{h}.npy")
    if os.path.exists(cpath):
        stack = np.load(cpath, mmap_mode="r")
        frames_h = [np.asarray(stack[i]) for i in range(args.frames)]
        print(f"pre-render cache hit: {cpath} "
              f"({time.time()-t0r:.1f}s)", file=sys.stderr)
    else:
        c_all = np.asarray([contrast_schedule(ts_all[i], seq.period)
                            for i in range(args.frames)], np.float32)
        stack = render_sequence(world, rot_cw_a, t_cw_a, c_all,
                                packed=args.mode != "mono")
        frames_h = list(stack)
        np.save(cpath + ".tmp.npy", stack)
        os.replace(cpath + ".tmp.npy", cpath)
        print(f"pre-render {args.frames} frames: {time.time()-t0r:.1f}s "
              f"(cached -> {cpath})", file=sys.stderr)

    gt = []
    kf_costs = []
    ref_before = -1
    # per-frame diagnostic sidecar: wall time, host tracking state, lost
    # counter — pinpoints recovery storms (state flips + n_lost jumps) and
    # slow frames without touching the timed loop's device traffic
    diag = []
    prev_state = None
    t_start = time.time()
    t_last_print = t_start
    for i in range(args.frames):
        ts = ts_all[i]
        t_abs = args.t0 + ts              # epoch stamp fed to the system
        buf = frames_h[i]
        tk0 = time.time()
        if args.mode == "mono":
            slam.track_monocular(buf, t_abs)
        elif args.mode == "rgbd_inertial" and i > 0:
            slam.track_rgbd_inertial(buf, None, acc_a[i], gyro_a[i],
                                     dts_1, t_abs)
        else:
            slam.track_rgbd(buf, None, t_abs)
        tk = time.time() - tk0
        # KF insertion signal: the host-side reference-KF slot changes on
        # insert (no device read)
        if slam.ref_kf != ref_before:
            ref_before = slam.ref_kf
            if i > 0:
                kf_costs.append((i, tk))
            if viewer is not None:
                lf = getattr(slam, "last_frame", None)
                g_img = buf if args.mode == "mono" \
                    else buf[:h * w].reshape(h, w)
                viewer.update(
                    slam.ms, slam.cur_rot, slam.cur_t, gray=g_img,
                    feat_uv=lf.feat.uv if lf is not None else None,
                    feat_valid=lf.feat.valid if lf is not None else None,
                    obs_mp=slam.last_obs_mp, title=f"t={ts:.1f}s")
        st_now = slam.state.name
        diag.append((i, round(tk, 4), st_now, slam.n_lost))
        if st_now != prev_state:
            print(f"  [diag] frame {i} (t={ts:.2f}s): state -> {st_now} "
                  f"(n_lost={slam.n_lost}, {tk*1000:.0f} ms)",
                  file=sys.stderr)
            prev_state = st_now
        twc = np.eye(4)
        twc[:3, :3] = rot_wc_a[i]
        twc[:3, 3] = p_a[i]
        gt.append((t_abs, twc))
        if i % args.print_every == 0:
            st = slam.map_stats()
            recent = [d[1] for d in diag[-args.print_every:]]
            cw = [e for e in clog.events if e[0] >= t_last_print]
            t_last_print = time.time()
            print(f"frame {i}: {st} ({i/max(time.time()-t_start,1e-9):.1f} "
                  f"fps cum; last {len(recent)}: mean "
                  f"{1000*np.mean(recent):.0f} ms, median "
                  f"{1000*np.median(recent):.0f} ms, max "
                  f"{1000*np.max(recent):.0f} ms; carried_streak="
                  f"{slam._carried_streak}, n_lost={slam.n_lost}; "
                  f"compiles {len(cw)} ({sum(e[1] for e in cw):.0f}s)",
                  file=sys.stderr)
            for e in sorted(cw, key=lambda e: -e[1])[:3]:
                if e[1] >= 5.0:
                    print(f"    compile {e[1]:.0f}s: {e[2][:100]}",
                          file=sys.stderr)

    wall = time.time() - t_start
    st = slam.map_stats()
    m = ate_rmse(slam.trajectory, gt, with_scale=(args.mode == "mono"))
    r = rpe(slam.trajectory, gt)
    # per-KF mapping cost flatness: late-half mean vs early-half mean of the
    # New_KF stage timer (the mapping megastep's host dispatch wall — the
    # same instrument as LocalMapTimeStats.txt), NOT the KF-frame's total
    # wall time: that conflated queue-blocked waits + compile storms with
    # mapping cost and disagreed with LocalMapTimeStats by 65x (round-4
    # VERDICT weak #4). Compile events are itemized separately below.
    kf_ms = slam.timers.samples.get("New_KF", [])
    if len(kf_ms) >= 8:
        half = len(kf_ms) // 2
        early = float(np.mean(kf_ms[1:half])) / 1000.0
        late = float(np.mean(kf_ms[half:])) / 1000.0
    else:
        early = late = float("nan")
    # KF-event frame wall time (the old instrument, kept under its true
    # name: includes pipeline drains and any compile walls)
    if len(kf_costs) >= 8:
        halfw = len(kf_costs) // 2
        wall_early = float(np.mean([c for _, c in kf_costs[1:halfw]]))
        wall_late = float(np.mean([c for _, c in kf_costs[halfw:]]))
    else:
        wall_early = wall_late = float("nan")
    comp = clog.since(t_start)
    print(f"{args.frames} frames in {wall:.1f}s ({args.frames/wall:.1f} FPS)")
    print(f"map: {st} | loops: "
          f"{slam.loop_closer.n_loops if slam.loop_closer else 0} | merges: "
          f"{slam.loop_closer.n_merges if slam.loop_closer else 0} | "
          f"kf_stall_warnings: {slam.kf_stall_warnings}")
    print(f"ATE rmse {m['ate_rmse']*100:.2f} cm | RPE {r['rpe_trans']*100:.2f}"
          f" cm / {r['rpe_rot_deg']:.3f} deg")
    print(f"per-KF mapping cost (New_KF): early {early*1000:.1f} ms, late "
          f"{late*1000:.1f} ms (flat = no O(K) growth); KF-frame wall: "
          f"early {wall_early*1000:.0f} ms, late {wall_late*1000:.0f} ms; "
          f"compiles in run: {comp['n']} ({comp['sec']:.0f}s)")
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "frames_diag.jsonl"), "w") as f:
        for row in diag:
            f.write(json.dumps(row) + "\n")
    with open(os.path.join(args.out, "inliers_diag.jsonl"), "w") as f:
        for row in slam.inlier_log:
            f.write(json.dumps(row) + "\n")
    if viewer is not None:
        gif = viewer.finish()
        print(f"viewer: {viewer.n} frames" + (f" -> {gif}" if gif else ""))
    slam.shutdown(args.out)
    with open(os.path.join(args.out, "hardmode.json"), "w") as f:
        json.dump({"mode": args.mode, "frames": args.frames,
                   "of": args.of, "icp": args.icp, "loop": args.loop,
                   "ate_rmse_m": m["ate_rmse"], "rpe_trans_m": r["rpe_trans"],
                   "rpe_rot_deg": r["rpe_rot_deg"], "map": st,
                   "kf_cost_early_ms": early * 1000,
                   "kf_cost_late_ms": late * 1000,
                   "kf_wall_early_ms": wall_early * 1000,
                   "kf_wall_late_ms": wall_late * 1000,
                   "compiles": comp,
                   "loops": (slam.loop_closer.n_loops
                             if slam.loop_closer else 0),
                   "merges": (slam.loop_closer.n_merges
                              if slam.loop_closer else 0),
                   "kf_stall_warnings": slam.kf_stall_warnings,
                   "n_lost": slam.n_lost,
                   "fps": args.frames / wall,
                   "device": {"platform": dev.platform,
                              "kind": dev.device_kind,
                              "card": card_info()}},
                  f, indent=1)


if __name__ == "__main__":
    main()
