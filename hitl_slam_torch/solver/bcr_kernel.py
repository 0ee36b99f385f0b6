"""Wrapper of the CUDA block-cyclic-reduction kernel (csrc/bcr.cu).

The kernel replaces hitl_slam_tpu/solver/pallas_bcr.py::bcr_solve_pallas:
one launch solves the whole symmetric block-tridiagonal LM system. Its
plain version is solver/tridiag.py::bcr_solve, which this wrapper runs for
CPU tensors only; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ..utils import cuda_build
from . import tridiag

Tensor = torch.Tensor

SCRATCH_PLANES = 63   # floats per lane of the kernel's scratch (bcr.cu Plane)

launches = cuda_build.LaunchCounter("bcr_solve")


def bcr_solve_cuda(D: Tensor, U: Tensor, b: Tensor) -> Tensor:
    """Launch the kernel: D [n,3,3], U [n-1,3,3], b [n,3] f32 CUDA -> x."""
    n = D.shape[0]
    dev = D.device
    if dev.type != "cuda":
        raise ValueError(f"bcr_solve_cuda needs CUDA tensors, got {dev}")
    if n < 1:
        raise ValueError("bcr_solve: empty system")
    f32 = torch.float32
    cuda_build.require("bcr_solve", "D", D, (n, 3, 3), f32, dev)
    cuda_build.require("bcr_solve", "U", U, (n - 1, 3, 3), f32, dev)
    cuda_build.require("bcr_solve", "b", b, (n, 3), f32, dev)
    m = tridiag.next_pow2(n)
    lib = cuda_build.library()
    x = torch.empty((n, 3), dtype=torch.float32, device=dev)
    ws = torch.empty((SCRATCH_PLANES * m,), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.hitl_bcr_solve(D.data_ptr(), U.data_ptr(), b.data_ptr(),
                              x.data_ptr(), ws.data_ptr(), n, m, stream)
    cuda_build.check(code, "bcr_solve")
    launches.count += 1
    return x


def bcr_solve(D: Tensor, U: Tensor, b: Tensor) -> Tensor:
    """Same signature and semantics as tridiag.bcr_solve: the kernel for
    CUDA tensors, the plain version for CPU tensors."""
    if D.device.type == "cpu":
        return tridiag.bcr_solve(D, U, b)
    if D.device.type == "cuda":
        return bcr_solve_cuda(D.contiguous(), U.contiguous(), b.contiguous())
    raise ValueError(f"bcr_solve: unsupported device {D.device}")
