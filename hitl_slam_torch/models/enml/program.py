"""EnML's sweep, a segment of it, the online window solve and the
checkerboard localizer as device programs on a CUDA device: the
reference's jitted `batch_localize` and `sweep_segment` (each one
`lax.scan`), `single_window_localize`, and `checkerboard_localize` (its
`lax.map`s over chunks and windows).

A program holds static input buffers and one `LoopGraph` of the eager
function on them (utils/device_loop.py::DeviceProgram), captured at its
first use: a sweep is one WHILE node over the nodes, a segment one WHILE
node over its `segment` trips, the window solve a straight graph, the
checkerboard 2 n_passes + 2 WHILE nodes over chunk indices (with the grid
matcher a WHILE node over a chunk's windows inside each trip). A call
copies its inputs into the buffers, replays, and returns copies of the
outputs, so it reads nothing back; the caller's read of the result is the
call's one host read. The STF match gates are made before the capture (a
host-made constant cannot enter a graph), and the window solve's
Cholesky solve is two triangular solves (localizer.py::cholesky_solve),
which a loop body can hold.

Programs are kept by shape key: (P, N, dtype, options, segment, the
number of LTF segments) for a sweep, (W, N, dtype, options, the number of
LTF segments) for a window, (P, N, dtype, options, n_passes, chunk,
force_grid) for the checkerboard, whose cache holds two (a W = 80 pool is
large); the least recently used beyond ProgramCache's size are dropped.
"""

from __future__ import annotations

import torch

from ...ops.correspond import preshuffle_on
from ...utils.device_loop import DeviceProgram, ProgramCache
from .localizer import (EnmlOptions, _match_gates, _single_window, _sweep,
                        _sweep_segment, cholesky_solve)

Tensor = torch.Tensor

_sweeps = ProgramCache()
_windows = ProgramCache()
_checkerboards = ProgramCache(size=2)


def _warm_linalg(n3: int, dtype, device) -> None:
    """One factor, solve and inverse of an [n3, n3] system on the current
    stream, so that the libraries' handles and workspaces exist before a
    capture."""
    H = torch.eye(n3, dtype=dtype, device=device)[None]
    L = torch.linalg.cholesky_ex(H)[0]
    cholesky_solve(torch.ones((1, n3, 1), dtype=dtype, device=device), L)
    torch.linalg.inv_ex(H[0])


class SweepProgram(DeviceProgram):
    """The sweep over a map of [P, N] points of `dtype` (`segment`
    None), or `segment` trips of it from a node index held in a buffer,
    for these options and `n_ltf` LTF segments (0: none).

    run(points, normals, point_mask, initial_poses, ltf_segs) of a sweep,
    and run(points, normals, point_mask, poses, covs, pre, t0, ltf_segs) of
    a segment (`t0` an int or a 0-dim integer tensor), return (poses [P,
    3], covariances [P, 3, 3]) as batch_localize and sweep_segment do."""

    def __init__(self, P: int, N: int, dtype: torch.dtype,
                 options: EnmlOptions, segment: int | None, n_ltf: int,
                 device):
        dev = torch.device(device)
        o = options
        gates = _match_gates(o, dev)
        maps = (torch.empty((P, N, 2), dtype=dtype),
                torch.empty((P, N, 2), dtype=dtype),
                torch.empty((P, N), dtype=torch.bool))
        ltf = (None if n_ltf == 0
               else torch.empty((n_ltf, 4), dtype=dtype))
        if segment is None:
            example = (*maps, torch.empty((P, 3), dtype=dtype), ltf)

            def fn(points, normals, point_mask, poses, ltf_segs):
                return _sweep(points, normals, point_mask, poses, o,
                              ltf_segs, gates)
        else:
            pre = (torch.empty((P - 1, 2, 2), dtype=dtype),
                   torch.empty((P - 1,), dtype=dtype),
                   torch.empty((P - 1,), dtype=dtype),
                   torch.empty((P - 1, 3), dtype=dtype),
                   torch.empty((P - 1, 2), dtype=dtype),
                   torch.empty((P - 1,), dtype=dtype))
            example = (*maps, torch.empty((P, 3), dtype=dtype),
                       torch.empty((P, 3, 3), dtype=dtype), pre,
                       torch.empty((), dtype=torch.int64), ltf)

            def fn(points, normals, point_mask, poses, covs, pre, t0,
                   ltf_segs):
                return _sweep_segment(points, normals, point_mask, poses,
                                      covs, pre, t0, o, segment, ltf_segs,
                                      gates)

        W = min(o.max_history, P)
        super().__init__(fn, example, dev,
                         warm=lambda: _warm_linalg(3 * W, dtype, dev),
                         name="enml_sweep")


class WindowProgram(DeviceProgram):
    """single_window_localize over a [W, N] window of `dtype` for these
    options and `n_ltf` LTF segments: run(points, normals, point_mask,
    poses, ltf_segs) -> the window's poses [W, 3]."""

    def __init__(self, W: int, N: int, dtype: torch.dtype,
                 options: EnmlOptions, n_ltf: int, device):
        dev = torch.device(device)
        o = options
        gates = _match_gates(o, dev)
        example = (torch.empty((W, N, 2), dtype=dtype),
                   torch.empty((W, N, 2), dtype=dtype),
                   torch.empty((W, N), dtype=torch.bool),
                   torch.empty((W, 3), dtype=dtype),
                   None if n_ltf == 0 else torch.empty((n_ltf, 4),
                                                       dtype=dtype))

        def fn(points, normals, point_mask, poses, ltf_segs):
            return _single_window(points, normals, point_mask, poses, o,
                                  ltf_segs, gates)

        super().__init__(fn, example, dev,
                         warm=lambda: _warm_linalg(3 * W, dtype, dev),
                         name="enml_window")


def sweep_program(points: Tensor, options: EnmlOptions,
                  segment: int | None,
                  ltf_segs: Tensor | None = None) -> SweepProgram:
    """The SweepProgram of a map with `points` ([P, N, 2] on a CUDA
    device), these options, segment length (None: the whole sweep) and LTF
    segments: the one made before, or a new one."""
    P, N = points.shape[:2]
    n_ltf = 0 if ltf_segs is None else int(ltf_segs.shape[0])
    dev = points.device
    dtype = points.dtype
    return _sweeps.get(
        (P, N, dtype, options, segment, n_ltf, dev.type, dev.index),
        lambda: SweepProgram(P, N, dtype, options, segment, n_ltf, dev))


def window_program(points: Tensor, options: EnmlOptions,
                   ltf_segs: Tensor | None = None) -> WindowProgram:
    """The WindowProgram of a window with `points` ([W, N, 2] on a CUDA
    device), these options and LTF segments."""
    W, N = points.shape[:2]
    n_ltf = 0 if ltf_segs is None else int(ltf_segs.shape[0])
    dev = points.device
    dtype = points.dtype
    return _windows.get(
        (W, N, dtype, options, n_ltf, dev.type, dev.index),
        lambda: WindowProgram(W, N, dtype, options, n_ltf, dev))


class CheckerboardProgram(DeviceProgram):
    """checkerboard_localize over a map of [P, N] points of `dtype` for
    these options, passes, chunk width and matcher route, without a mesh:
    run(points, normals, point_mask, initial_poses) -> (poses [P, 3],
    covariances [P, 3, 3]).

    warm() copies each parity's plan (window rows, masks, scatter rows) to
    the device, the grid matcher's permutation with it, and makes the
    batched factorizations of the passes at their exact shapes on the
    program's stream (a batched inverse of small matrices may take another
    library path than a single one): the GN step's [ck, 3W, 3W] Cholesky
    and triangular solves, the covariance pass's [3W, 3W] inverse (one
    window at a time, window_covariances) and the SE(2) carry's [B, 3, 3]
    inverse."""

    def __init__(self, P: int, N: int, dtype: torch.dtype,
                 options: EnmlOptions, n_passes: int, chunk: int,
                 force_grid: bool, device):
        from .parallel_localizer import (BRUTE_MATCH_LIMIT, _checkerboard,
                                         _plans)

        dev = torch.device(device)
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        o = options
        gates = _match_gates(o, dev)
        W = min(o.max_history, P)
        grid = force_grid or W * N > BRUTE_MATCH_LIMIT
        held = {}

        def warm():
            held["plans"] = plans = _plans(P, W, chunk, 1, dev)
            if grid:
                preshuffle_on(W * N, dev)
            n3 = 3 * W
            for pl in plans:
                H = torch.eye(n3, dtype=dtype, device=dev).expand(
                    pl.ck, n3, n3).contiguous()
                L = torch.linalg.cholesky_ex(H)[0]
                cholesky_solve(torch.ones((pl.ck, n3, 1), dtype=dtype,
                                          device=dev), L)
                torch.linalg.inv_ex(H[0])
                torch.linalg.inv_ex(torch.eye(3, dtype=dtype, device=dev)
                                    .expand(pl.B, 3, 3).contiguous())

        example = (torch.empty((P, N, 2), dtype=dtype),
                   torch.empty((P, N, 2), dtype=dtype),
                   torch.empty((P, N), dtype=torch.bool),
                   torch.empty((P, 3), dtype=dtype))

        def fn(points, normals, point_mask, poses):
            return _checkerboard(points, normals, point_mask, poses, o,
                                 n_passes, force_grid, held["plans"], gates)

        super().__init__(fn, example, dev, warm=warm,
                         name="enml_checkerboard")


def checkerboard_program(points: Tensor, options: EnmlOptions,
                         n_passes: int, chunk: int,
                         force_grid: bool) -> CheckerboardProgram:
    """The CheckerboardProgram of a map with `points` ([P, N, 2] on a CUDA
    device) and these arguments: the one made before, or a new one."""
    P, N = points.shape[:2]
    dev = points.device
    dtype = points.dtype
    return _checkerboards.get(
        (P, N, dtype, options, n_passes, chunk, force_grid, dev.type,
         dev.index),
        lambda: CheckerboardProgram(P, N, dtype, options, n_passes, chunk,
                                    force_grid, dev))
