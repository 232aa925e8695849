"""On-device health gate in the fused frame step (pipeline/fused.py).

The fused production path chains pose/map state on device across a
pipelined window: the host only learns a frame failed (inlier collapse) a
read-batch later. The gate must make failed frames carry the PREDICTED
state and leave the map untouched — the reference's RECENTLY_LOST
PredictStateIMU behavior (/root/reference/src/Tracking.cc:2480) — so the
frames dispatched in between never track against garbage.

Scenario: healthy fused tracking, a short burst of featureless frames
(blank wall), then normal frames again. With the gate, the system rides
the burst on motion-model prediction and re-acquires on the SAME map; a
poisoned chain would instead force LOST -> new Atlas map or a large ATE.
"""
import jax.numpy as jnp
import numpy as np

from geoflowslam.io.synthetic import SyntheticWorld, SyntheticSequence, Camera
from geoflowslam.pipeline.system import SlamSystem
from geoflowslam.eval.ate import ate_rmse

from test_e2e_rgbd import small_system


def test_blank_burst_rides_prediction_same_map():
    cam, cfg = small_system()
    world = SyntheticWorld(cam)
    seq = SyntheticSequence(world, fps=10.0)
    slam = SlamSystem(cfg)

    blank_at = range(22, 25)            # 0.3 s burst, < recently-lost budget
    blank = jnp.full((cam.height, cam.width), 100.0)
    gt = []
    for i in range(40):
        t = i / seq.fps
        gray, depth, (rot_cw, t_cw) = seq.frame(t)
        if i in blank_at:
            # depth of a flat wall 2 m out: geometrically valid, zero texture
            slam.track_rgbd(blank, jnp.full_like(depth, 2.0), t)
        else:
            slam.track_rgbd(gray, depth, t)
        twc = np.eye(4)
        rwc = np.asarray(rot_cw).T
        twc[:3, :3] = rwc
        twc[:3, 3] = -rwc @ np.asarray(t_cw)
        gt.append((t, twc))

    stats = slam.map_stats()
    # re-acquired on the same map: no Atlas reset, tracking healthy again
    assert stats["state"] == "OK", stats
    assert stats["n_maps"] == 1, stats

    # the post-burst trajectory must not have been dragged by a poisoned
    # chain; gate the whole run (blank frames ride prediction, which on
    # this smooth trajectory stays within a few cm)
    m = ate_rmse(slam.trajectory, gt)
    assert m["ate_rmse"] < 0.08, (m, stats)
