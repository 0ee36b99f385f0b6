"""hitl_slam_torch: the PyTorch/CUDA port of hitl_slam_tpu for NVIDIA Hopper.

The same Human-in-the-Loop SLAM repair cycle as the JAX package, in plain
PyTorch on tensors, with the two hand-written kernels of the hot path in CUDA
C++ (csrc/, built at first use by utils/cuda_build.py):

  - ops/em_scan.py      the EM selection sweep (inlier counts + verify minima)
  - solver/bcr_kernel.py the block-cyclic-reduction solve of the LM system

Layout mirrors hitl_slam_tpu so each counterpart sits at the same path:
  core/      MapState / ConstraintTable dataclasses, numpy <-> torch converter
  io/        .stfs.covars and correction-log readers (host numpy only)
  ops/       geometry, factor residuals, the em_scan kernel wrapper
  solver/    block-tridiagonal solve, normal equations, Levenberg-Marquardt
  models/    the HitL correction cycle and its session engine
  cli.py     headless replay entry point

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
