#!/usr/bin/env python
"""Time the front end's three hot kernels on the card at production shapes.

Each is the plain jitted form XLA compiles, timed alone with
block_until_ready (median of --reps):

* FAST: two-threshold scores + keypoint selection on a 480x640 level;
* search: the gated projection search at N = M = 1250 (1000 ORB + OF);
* LK: one OF frame's pair of forward-backward streams
  (pipeline/of_tracking.of_dual_stream): 1256 points, win=21,
  10 iterations, the prior stream on 3 levels and the 2D stream on all 4
  of the LK pyramid, each with one backward level.

    python tools/profile_kernels.py [--reps 50]
"""
import argparse
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def timed(fn, args, reps):
    import jax
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append((time.perf_counter() - t0) * 1000)
    return statistics.median(ts), min(ts)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()

    import jax
    from geoflowslam.utils.compile_log import enable_persistent_cache
    from geoflowslam.utils.device import describe, require_gpu
    devices = jax.devices()
    require_gpu(devices)
    enable_persistent_cache()
    import chip_smoke as CS
    from geoflowslam.ops import fast as F
    from geoflowslam.ops import klt as K
    from geoflowslam.ops import matching as MT

    print(f"device: {describe(devices)}")
    prev, nxt = CS._scene(480, 640, 0)
    pyr = jax.jit(lambda a, b: (tuple(K.build_lk_pyramid(a, 4)),
                                tuple(K.build_lk_pyramid(b, 4))))
    pp, pn = pyr(prev, nxt)
    pts = jax.jit(lambda x: F.detect_level(x, 1256, 20.0, 7.0).xy)(prev)

    @jax.jit
    def fast(img):
        kp = F.detect_level(img, 1000, 20.0, 7.0)
        return kp.xy, kp.score

    @jax.jit
    def of_pair(pp, pn, pts, guess):
        r3 = K.fb_klt_track(pp, pn, pts, guess, fb_thresh=0.5, win=21,
                            iters=10, max_levels=3)
        r2 = K.fb_klt_track(pp, pn, pts, None, fb_thresh=0.5, win=21,
                            iters=10, max_levels=6)
        return r3.pts, r3.status, r2.pts, r2.status

    rng = np.random.RandomState(0)
    n = 1250
    uv = rng.uniform([0, 0], [640, 480], (n, 2)).astype(np.float32)
    lvl = rng.randint(0, 8, n).astype(np.int32)
    desc = rng.randint(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(np.uint32)
    ok = np.ones(n, bool)
    search = jax.jit(lambda *a: MT.search_by_projection(*a))
    s_args = (uv + 2.0, lvl, ok, desc, uv, lvl, desc, ok,
              (15.0 * 1.2 ** lvl).astype(np.float32))

    for name, fn, a in (("FAST 480x640, 1000 keypoints", fast, (prev,)),
                        ("search N=M=1250", search, s_args),
                        ("LK OF pair, N=1256, 9 levels", of_pair,
                         (pp, pn, pts, pts + 0.7))):
        med, best = timed(fn, a, args.reps)
        print(f"{name}: median {med:.3f} ms, min {best:.3f} ms over "
              f"{args.reps}")


if __name__ == "__main__":
    main()
