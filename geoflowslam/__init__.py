"""geoflowslam — a JAX/XLA rebuild of GeoFlow-SLAM for one GPU.

A from-scratch framework with the capabilities of HorizonRobotics/GeoFlowSlam
(tightly-coupled RGBD-inertial + legged-odometry SLAM on the ORB-SLAM3
architecture), re-designed for an accelerator: fixed-shape padded state
pytrees instead of pointer graphs and mutexes, jit-compiled pipeline stages
instead of threads, batched Gauss-Newton/Schur bundle adjustment as dense
matmuls instead of g2o. Every kernel is what XLA compiles from plain JAX.

See SURVEY.md at the repo root for the full map of reference components to
modules in this package.
"""

__version__ = "0.1.0"

import jax as _jax

# SLAM geometry (Rodrigues/GN/Schur solves) needs true float32 matmuls; a
# float32 matmul on the GPU may otherwise run in TF32, which corrupts
# rotation compositions at the 1e-2 level. Hot kernels that *want* bf16
# (e.g. Hamming descriptor matmuls, ops/matching.py) cast their inputs to
# bfloat16 explicitly, so they keep the tensor-core rate.
_jax.config.update("jax_default_matmul_precision", "highest")
