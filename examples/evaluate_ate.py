#!/usr/bin/env python
"""Trajectory evaluation CLI (PoseEvaluatorTUM equivalent).

    python examples/evaluate_ate.py <est_tum.txt> <gt_tum.txt> [--scale]

Reports ATE RMSE/mean/max + RPE, like the reference's
script/evaluator/ours/PoseEvaluatorTUM.py (6dof/7dof alignment).
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("est")
    ap.add_argument("gt")
    ap.add_argument("--scale", action="store_true", help="7-DoF alignment")
    ap.add_argument("--max-dt", type=float, default=0.02)
    args = ap.parse_args()

    from geoflowslam.io.trajectory import load_trajectory_tum
    from geoflowslam.eval.ate import ate_rmse, rpe

    est = load_trajectory_tum(args.est)
    gt = load_trajectory_tum(args.gt)
    m = ate_rmse(est, gt, with_scale=args.scale, max_dt=args.max_dt)
    r = rpe(est, gt, max_dt=args.max_dt)
    print(f"pairs:     {m['n_pairs']}")
    print(f"ATE rmse:  {m['ate_rmse']:.4f} m")
    print(f"ATE mean:  {m['ate_mean']:.4f} m")
    print(f"ATE max:   {m['ate_max']:.4f} m")
    print(f"scale:     {m['scale']:.4f}")
    print(f"RPE trans: {r['rpe_trans']:.4f} m")
    print(f"RPE rot:   {r['rpe_rot_deg']:.4f} deg")


if __name__ == "__main__":
    main()
