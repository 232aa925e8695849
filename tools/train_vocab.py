#!/usr/bin/env python
"""Train the default BoW vocabulary for the framework's ORB extractor.

The reference ships ORBvoc.txt (1M words trained on real images with
OpenCV's learned BRIEF pattern, /root/reference/Vocabulary/). Our extractor
uses a generated steered-BRIEF pattern (ops/orb.py), so the bundled
vocabulary must be trained on descriptors from *our* extractor. This tool
harvests descriptors from a spread of synthetic scenes (varied textures,
viewpoints, lighting) and runs the hierarchical binary k-medians build
(retrieval/vocab.build_vocabulary), writing
geoflowslam/assets/vocab_default.npz.

    python tools/train_vocab.py [--k 10] [--levels 4] [--frames 60]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--levels", type=int, default=4)
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(__file__), "..", "geoflowslam", "assets",
        "vocab_default.npz"))
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from geoflowslam.io.synthetic import SyntheticWorld, SyntheticSequence, Camera
    from geoflowslam.ops.extractor import OrbConfig, extract
    from geoflowslam.retrieval import vocab as V

    cam = Camera(fx=400.0, fy=400.0, cx=320.0, cy=240.0, width=640, height=480)
    orb = OrbConfig(n_features=600, n_levels=8, height=480, width=640)
    ex = jax.jit(lambda g: extract(g, orb))

    all_desc = []
    for seed in range(3):
        world = SyntheticWorld(cam, seed=seed) if _accepts_seed(SyntheticWorld) \
            else SyntheticWorld(cam)
        seq = SyntheticSequence(world, fps=10.0)
        for i in range(args.frames // 3):
            t = i * 0.37 + seed * 11.1
            gray, depth, _ = seq.frame(t)
            feat = ex(jnp.asarray(gray, jnp.float32))
            d = np.asarray(feat.desc)[np.asarray(feat.valid)]
            all_desc.append(d)
    desc = np.concatenate(all_desc)
    # dedup + shuffle for a balanced training set
    desc = np.unique(desc, axis=0)
    rng = np.random.RandomState(0)
    rng.shuffle(desc)
    print(f"training on {len(desc)} unique descriptors "
          f"(k={args.k}, L={args.levels} -> {args.k**args.levels} words)")
    voc = V.build_vocabulary(desc, k=args.k, levels=args.levels,
                             iters=args.iters)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    V.save_vocabulary(args.out, voc)
    print(f"saved {args.out} ({os.path.getsize(args.out)/1024:.0f} KiB)")


def _accepts_seed(cls):
    import inspect
    try:
        return "seed" in inspect.signature(cls).parameters
    except (TypeError, ValueError):
        return False


if __name__ == "__main__":
    main()
