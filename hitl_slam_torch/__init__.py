"""hitl_slam_torch: the PyTorch/CUDA port of hitl_slam_tpu for NVIDIA Hopper.

The same Human-in-the-Loop SLAM repair cycle as the JAX package, in plain
PyTorch on tensors, with the two hand-written kernels of the hot path in CUDA
C++ (csrc/, built at first use by utils/cuda_build.py):

  - ops/em_scan.py      the EM selection sweep (inlier counts + verify minima)
  - solver/bcr_kernel.py the block-cyclic-reduction solve of the LM system

Layout mirrors hitl_slam_tpu so each counterpart sits at the same path:
  core/      MapState / ConstraintTable dataclasses, numpy <-> torch converter
  io/        .stfs.covars and correction-log readers and writers, the
             synthetic figure-8 map generator, the ROS bag reader and
             writer (host numpy only)
  ops/       geometry, factor residuals, the em_scan kernel wrapper, the
             refine's matchers, RANSAC segments, the correlative scan
             matcher, rasterization, the truncated SDF, the LTF map factors
  solver/    block-tridiagonal solves, normal equations, Levenberg-Marquardt
             (lone and batched), the refine's dense and matrix-free solvers
  models/    the HitL correction cycle and its repair step, its session
             engine, the refine and the auto-proposed corrections; the
             LTVM map curator; EnML:
             the sequential and checkerboard batch localizers, the online
             localizer, the interactive session with loop corrections, and
             their driver
  parallel/  the replica batch: perturbed copies of a map solved by one
             batched LM
  native/    the C++ .stfs.covars parser and bag record scanner (host
             code, built by g++ at first use; the Python paths otherwise)
  gui/       draw lists, the display builders, the vector-map and graph
             files, the live scan view, the websocket bridge and the viewer
             assets (host numpy, json and asyncio)
  utils/     kernel builds, images, timing, the TOML and Lua configs
  cli.py     replay, auto-repair, rendering and the interactive GUI serve
             loop
  cli_ltvm.py  the LTVM curator's entry point
  cli_enml.py  EnML: bag or stream -> .stfs.covars (sequential or
             checkerboard), online, interactive with loop corrections

Every function takes tensors on an explicit device; nothing here picks a
device on its own. The package never imports jax or hitl_slam_tpu.
"""

__version__ = "0.1.0"

import torch as _torch

# The solver's 3x3 block algebra and normal-equation products must run at
# full f32: TF32 keeps ~10 mantissa bits, and LM steps solved from a
# TF32-rounded Hessian stop decreasing the true cost.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
