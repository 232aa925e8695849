"""Regression gate over the committed hard-mode parity matrix.

The hard-mode matrix (tools/run_hardmode_matrix.py, run on the GPU) is the
standing substitute for TUM/EuRoC parity runs
(/root/reference/script/evaluator/ours/PoseEvaluatorTUM.py role). This test
gates the most recent committed results in results_hard/matrix.json so a
regression in any mode's accuracy or mapping-cost flatness fails the suite.

Skips when no matrix has been committed (the matrix is made on the card;
unit CI runs on the CPU mesh).
"""
import json
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MATRIX = os.path.join(HERE, "results_hard", "matrix.json")

# Per-mode ATE gates (meters), set at measured-result + regression margin
# from the first committed matrix run (results_hard/matrix.json, cold
# compile cache). Mono is Sim3-aligned (scale-free); inertial modes
# must hold metric scale.
#
# The plain `rgbd`/`rgbd_loop` cells run the hard sequence with the GeoFlow
# robustness switches (UseOpticalFlow / UseICP) deliberately OFF — they are
# the documented-failure baseline (map resets, meter-scale ATE) that the
# paper's contribution exists to fix. The `rgbd_of_icp*` cells run the SAME
# sequence with both switches ON — dual-stream OF + GICP predictor, fused
# into the single-dispatch fast path (pipeline/fused.py:103-165) — and are
# gated tight: the committed matrix is the standing proof of the rescue
# delta (reference ablations: tum_icp_op.yaml vs tum_no_icp_op.yaml).
ATE_GATE = {
    "rgbd": 3.5, "rgbd_loop": 3.5,
    "rgbd_inertial": 0.40, "rgbd_inertial_loop": 0.10,
    "mono": 0.40, "mono_loop": 0.15,
    # INTERIM: first committed OF/ICP cell (ATE 1.27 m vs 3.08 m plain —
    # the rescue delta is real but the cell ran at 0.18 FPS because the
    # then-eager relocalization path compiled per-op on every lost frame;
    # tighten toward 0.15 m once the post-fused-reloc rerun is committed.
    "rgbd_of_icp": 1.6, "rgbd_of_icp_loop": 1.6,
}
RPE_GATE_M = {
    "rgbd": 0.60, "rgbd_loop": 0.60,   # visual-only: includes reset jumps
    "rgbd_of_icp": 0.15, "rgbd_of_icp_loop": 0.15,   # interim, see above
}
RPE_GATE_DEFAULT_M = 0.05              # local drift, inertial/mono modes
# No FPS gate on matrix cells: their wall clock includes cold XLA compiles
# (bench.py owns the steady-state FPS claim).


@pytest.mark.skipif(not os.path.exists(MATRIX),
                    reason="no committed hard-mode matrix (made on the GPU)")
def test_hardmode_matrix_gates():
    with open(MATRIX) as f:
        cells = {d["tag"]: d for d in json.load(f)}
    assert cells, "matrix.json is empty"
    for tag, d in cells.items():
        assert "error" not in d, f"{tag} failed: {d}"
        gate = ATE_GATE.get(tag)
        if gate is not None:
            assert d["ate_rmse_m"] < gate, (tag, d["ate_rmse_m"], gate)
        rpe_gate = RPE_GATE_M.get(tag, RPE_GATE_DEFAULT_M)
        assert d["rpe_trans_m"] < rpe_gate, (tag, d["rpe_trans_m"])
        # per-KF mapping cost must stay flat as the map grows (no O(K))
        if d["kf_cost_early_ms"] == d["kf_cost_early_ms"]:  # not NaN
            assert d["kf_cost_late_ms"] < 4.0 * d["kf_cost_early_ms"] + 50, (
                tag, d["kf_cost_early_ms"], d["kf_cost_late_ms"])
    # (steady-state FPS is gated by bench.py, not here: matrix-cell wall
    # clock includes cold XLA compiles)
