#!/usr/bin/env python
"""Run the standing hard-mode parity matrix and emit the PARITY.md table.

In lieu of TUM/EuRoC data (none is bundled), the committed substitute is
the hard synthetic sequence (epoch stamps, 40 s loop revisits, rotation
bursts, texture-poor segments) run for every primary mode, each with loop
closing off and on, on the GPU. Mirrors the role of the reference evaluator
(/root/reference/script/evaluator/ours/PoseEvaluatorTUM.py:16-53), and the
reference's config-matrix ablations (tum_icp_op.yaml vs tum_no_icp_op.yaml,
/root/reference/script/run_orbslam/RGBD/config/TUM/tum1/): the `of_icp`
cells run the SAME sequence with the GeoFlow robustness switches on —
dual-stream optical flow + GICP predictor, both fused into the
single-dispatch fast path (pipeline/fused.py:103-165) — so the matrix pins
the rescue delta vs the plain-visual cells.

    python tools/run_hardmode_matrix.py [--frames 2000] [--out results_hard]
        [--cells rgbd,rgbd_of_icp,...] [--force]

Incremental: cells already present in <out>/matrix.json are skipped unless
--force, so an interrupted matrix run resumes where it stopped. One process
per card: this parent never imports JAX, and each cell is its own child
process, run one after another, so only one process ever holds the card.
Every completed cell updates matrix.json/matrix.md immediately.
"""
import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The planned standing matrix (tests/test_hardmode_gate.py asserts all of
# these are present): every primary mode x loop closing, plus the GeoFlow
# robustness cells that exist to rescue the visual-only failure.
PLANNED = [
    "rgbd", "rgbd_loop",
    "rgbd_inertial", "rgbd_inertial_loop",
    "mono", "mono_loop",
    "rgbd_of_icp", "rgbd_of_icp_loop",
    # the flagship G1 combo: OF + ICP + lidar point-to-plane together
    # (g1_op_icp_lidar_indoor1.yaml; factors src/Optimizer.cc:8338-8421)
    "rgbd_of_icp_lidar",
]


def cell_cmd(tag: str, frames: int, out_dir: str):
    base = tag
    lidar = base.endswith("_lidar")
    if lidar:
        base = base[: -len("_lidar")]
    loop = base.endswith("_loop")
    if loop:
        base = base[: -len("_loop")]
    robust = base.endswith("_of_icp")
    if robust:
        base = base[: -len("_of_icp")]
    cmd = [sys.executable, os.path.join(HERE, "examples", "run_hardmode.py"),
           "--mode", base, "--frames", str(frames),
           "--out", os.path.join(out_dir, tag)]
    if loop:
        cmd.append("--loop")
    if robust:
        cmd += ["--of", "--icp"]
    if lidar:
        cmd.append("--lidar")
    return cmd


def write_tables(cells, out_abs):
    lines = [
        "| run (command) | FPS | ATE rmse | RPE trans / rot | "
        "per-KF cost early->late | maps/state |",
        "|---|---|---|---|---|---|",
    ]
    order = {t: i for i, t in enumerate(PLANNED)}
    for d in sorted(cells.values(),
                    key=lambda d: order.get(d["tag"], 99)):
        if "error" in d:
            lines.append(f"| `{d['cmd']}` | FAILED rc={d['error']} | | | | |")
            continue
        mp = d.get("map", {})
        lines.append(
            f"| `{d['cmd']}` | {d['fps']:.1f} | "
            f"{d['ate_rmse_m']*100:.2f} cm | "
            f"{d['rpe_trans_m']*100:.2f} cm / {d['rpe_rot_deg']:.3f} deg | "
            f"{d['kf_cost_early_ms']:.1f} -> {d['kf_cost_late_ms']:.1f} ms | "
            f"{mp.get('n_maps', '?')} maps, {mp.get('state', '?')} |")
    table = "\n".join(lines)
    os.makedirs(out_abs, exist_ok=True)
    with open(os.path.join(out_abs, "matrix.md"), "w") as f:
        f.write(table + "\n")
    with open(os.path.join(out_abs, "matrix.json"), "w") as f:
        json.dump(list(cells.values()), f, indent=1)
    return table


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=2000)
    ap.add_argument("--out", default="results_hard")
    ap.add_argument("--cells", default=",".join(PLANNED),
                    help="comma-separated cell tags (default: full matrix)")
    ap.add_argument("--force", action="store_true",
                    help="re-run cells already present in matrix.json")
    args = ap.parse_args()

    out_abs = os.path.join(HERE, args.out)
    jpath = os.path.join(out_abs, "matrix.json")
    cells = {}
    if os.path.exists(jpath) and not args.force:
        with open(jpath) as f:
            cells = {d["tag"]: d for d in json.load(f) if "error" not in d}

    for tag in args.cells.split(","):
        if tag in cells and not args.force:
            print(f"== {tag}: cached in matrix.json, skipping", flush=True)
            continue
        cmd = cell_cmd(tag, args.frames, args.out)
        print(f"== {tag}: {' '.join(cmd)}", flush=True)
        t0 = time.time()
        log = os.path.join(out_abs, f"{tag}.log")
        os.makedirs(out_abs, exist_ok=True)
        with open(log, "w") as lf:
            r = subprocess.run(cmd, cwd=HERE, stdout=lf,
                               stderr=subprocess.STDOUT, text=True)
        cpath = os.path.join(out_abs, tag, "hardmode.json")
        if r.returncode != 0 or not os.path.exists(cpath):
            print(f"   FAILED rc={r.returncode} (see {log})", flush=True)
            cells[tag] = {"tag": tag, "error": r.returncode,
                          "cmd": " ".join(c for c in cmd
                                          if c != sys.executable)}
        else:
            with open(cpath) as f:
                d = json.load(f)
            d["tag"] = tag
            d["cmd"] = " ".join(c for c in cmd if c != sys.executable)
            d["wall_s"] = round(time.time() - t0, 1)
            cells[tag] = d
            print(f"   done in {d['wall_s']}s: ATE "
                  f"{d['ate_rmse_m']*100:.2f} cm, {d['fps']:.1f} FPS",
                  flush=True)
        write_tables(cells, out_abs)   # persist after EVERY cell

    print(write_tables(cells, out_abs))


if __name__ == "__main__":
    main()
