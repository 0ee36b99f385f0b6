"""The LM loop's trip kernel (csrc/lm_step.cu, solver/lm_step.py): on the
CPU its launch plan, its plain version against normal_equations_soa, and a
launch counter that counts without marking the stage clock; on a card only
(marker `cuda`), the kernel against its plain version on every route, a
kernel captured and replayed bit-equal to its eager launch, and the cycle
program's LM loop with the kernel in it: its stage marks, its launch
counts and its body's graph nodes.

Nothing here imports JAX, so the card's tests run where JAX is not
installed: python -m pytest -p no:cacheprovider --noconftest -m cuda
tests/test_torch_lm_step.py (chip_smoke.py's lm_step phase times the
kernel at full size)."""

import os

import numpy as np
import pytest
import torch

from hitl_slam_torch.solver import lm_step as S
from hitl_slam_torch.solver.lm import LMConfig
from hitl_slam_torch.utils import cuda_build

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
# the routes' boundaries and the shapes of the port's solves: the cycle's
# 1024 poses, the lone LM's and repair_step's 8192, the 16384-pose sessions
SIZES = (1, 2, 3, 64, 128, 129, 1024, 2049, 8192, 16384, 16385)
CARRY = ("x", "D", "U", "g", "c", "mu", "nu")


def _problem(P, device, seed=0):
    """(problem, start poses) of P poses with a nonzero cost: from 8 poses
    bench.seeded_chain's drifting chain and its 3 human rows, below a
    random walk and an empty table; the start is the build poses with the
    x, y and theta of every pose but the first jittered."""
    from hitl_slam_torch.bench import seeded_chain
    from hitl_slam_torch.core.state import ConstraintTable
    from hitl_slam_torch.solver import joint

    rng = np.random.default_rng(seed)
    if P >= 8:
        poses, table = seeded_chain(P, seed, device)
    else:
        poses = np.cumsum(rng.uniform(0, 1, (P, 3)) * [1.0, 0.3, 0.2],
                          0).astype(np.float32)
        table = ConstraintTable.empty(4, device)
    poses = torch.as_tensor(poses, device=device)
    jitter = rng.normal(0, [0.05, 0.05, 0.01], (P, 3)).astype(np.float32)
    jitter[0] = 0.0
    return (joint.build_problem(poses, table),
            poses + torch.as_tensor(jitter, device=device))


# ------------------------------------------------------------ on the CPU

@pytest.mark.parametrize("P", SIZES + (1 << 20, S.MAX_POSES))
def test_launch_plan_holds_every_pose_once(P):
    """One thread a pose, every block holding some (the kernel refuses an
    empty one)."""
    plan = S.launch_plan(P)
    assert plan.threads % S.WARP == 0 and plan.threads <= S.MAX_THREADS
    assert plan.blocks * plan.threads >= P > (plan.blocks - 1) * plan.threads
    want = ("block" if P <= 128 else "cluster" if P <= 16384
            else "two launches")
    assert plan.route == want
    if plan.route == "cluster":
        assert plan.blocks <= S.MAX_CLUSTER


def test_launch_plan_routes_every_pose_count():
    """Every P up to past the cluster's reach has one plan, its route
    changing at 128 and 16384 poses only; a cluster's blocks hold about
    CLUSTER_POSES poses until the cluster is full."""
    routes = [S.launch_plan(P).route for P in range(1, 20001)]
    changes = [P for P in range(2, 20001) if routes[P - 1] != routes[P - 2]]
    assert changes == [129, 16385]
    assert S.launch_plan(1024).blocks == 8
    assert S.launch_plan(2048).threads == S.CLUSTER_POSES
    assert S.launch_plan(8192).threads == 512
    for bad in (0, -1, S.MAX_POSES + 1):
        with pytest.raises(ValueError):
            S.launch_plan(bad)


@pytest.mark.parametrize("P", [2, 3, 64])
def test_plain_trip_is_the_assembly_and_the_tail(P):
    """The plain version: `begin` on the CPU assembles at poses0 by
    normal_equations_soa; an accepted trip leaves the carry at the trial
    point's assembly bit for bit, a rejected one leaves D, U, g, x and c;
    `system` is D damped by mu and -g."""
    from hitl_slam_torch.solver import tridiag
    from hitl_slam_torch.solver.assembly_soa import (normal_equations_soa,
                                                     soa_constants)

    problem, start = _problem(P, "cpu", seed=P)
    config = LMConfig(max_iterations=5)
    s = S.begin(problem, start, config)
    assert s.accepted is None and s.assemble is not None
    sc = soa_constants(problem)
    want = normal_equations_soa(problem, sc, start)
    for got, w in zip((s.D, s.U, s.g, s.c), want):
        assert torch.equal(got, w)
    Dd, U, b = S.system(s, config)
    assert torch.equal(Dd, S.damped(s.D, s.mu, config))
    assert U is s.U and torch.equal(b, -s.g)
    step = tridiag.bcr_solve(Dd, U, b)
    assert bool(S.trip(s, step, config))
    for got, w in zip((s.D, s.U, s.g, s.c),
                      normal_equations_soa(problem, sc, start + step)):
        assert torch.equal(got, w)
    assert int(s.it) == 1 and float(s.nu) == 2.0
    before = {k: getattr(s, k).clone() for k in CARRY}
    assert not bool(S.trip(s, 50.0 * step, config))
    for k in ("x", "D", "U", "g", "c"):
        assert torch.equal(getattr(s, k), before[k]), k
    assert float(s.mu) == float(before["mu"] * before["nu"])
    assert int(s.it) == 2


def test_kernel_entry_points_refuse_cpu_tensors():
    problem, start = _problem(16, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        S.begin_cuda(problem, start, LMConfig())


@pytest.mark.parametrize("mark", [True, False])
def test_counter_marks_the_clock_only_when_asked(monkeypatch, mark):
    """A captured bump hands the mark kernel the clock and mark of the
    capture, or with mark=False none (the LM's edges stay lm and
    bcr_solve)."""
    from hitl_slam_torch.utils import device_loop

    calls = []

    class Lib:
        def hitl_clock_mark(self, counter, clock, mark_id, stream):
            calls.append((clock, mark_id))
            return 0

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: Stream())
    monkeypatch.setattr(cuda_build, "library", lambda: Lib())
    monkeypatch.setattr(device_loop, "capture_mark", lambda name: (1234, 7))
    c = cuda_build.LaunchCounter("probe", mark=mark)
    cuda_build.counters.remove(c)
    c._device[0] = torch.zeros((), dtype=torch.int64)
    c.bump(torch.device("cuda", 0))
    assert calls == [(1234, 7) if mark else (0, 0)]
    assert S.launches.mark is False


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel is CUDA")
    return torch.device("cuda")


def _close(got, want, scale):
    """Equal to f32 round-off: within 1e-5 of want's largest entry, and
    within 1e-6 of `scale` (the largest entry of D: g and b are sums of
    terms of up to that size that cancel)."""
    got, want = got.double(), want.double()
    if want.numel() == 0:
        return True
    tol = 1e-5 * max(float(want.abs().max()), 1.0) + 1e-6 * scale
    return float((got - want).abs().max()) <= tol


def _compare(k, p, config):
    """The kernel's carry `k` against the plain carry `p`."""
    scale = float(p.D.abs().max())
    for name in CARRY:
        assert _close(getattr(k, name), getattr(p, name), scale), name
    assert torch.equal(k.it, p.it)
    assert torch.equal(k.done, p.done)
    assert torch.equal(k.go, p.go)
    Dd, _, b = S.system(p, config)
    assert _close(k.Dd, Dd, scale) and _close(k.b, b, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["first", "accepted", "rejected_mu",
                                  "rejected_step", "exits"])
@pytest.mark.parametrize("P", SIZES)
def test_kernel_matches_plain_version(cuda_device, P, mode):
    """begin and one trip by the kernel against the plain version on the
    card, from the same carry and the same step (BCR's on the plain
    version's system): the first assembly; an accepted trip; a trip
    rejected at a huge damping (the step too small to change the f32 cost)
    and one rejected at 30 times the step; loose tolerances that end the
    loop (the accepted trip at a damping of 1). Same accept flag, count,
    done and go; the rest to f32 round-off."""
    from hitl_slam_torch.solver import bcr_kernel

    problem, start = _problem(P, cuda_device, seed=P)
    config = {"accepted": LMConfig(initial_mu=1.0),
              "rejected_mu": LMConfig(initial_mu=1e30),
              "exits": LMConfig(function_tolerance=0.5,
                                parameter_tolerance=0.5)}.get(mode,
                                                              LMConfig())
    S.launches.count = 0
    k = S.begin(problem, start, config)
    p = S.begin_reference(S.soa_assembler(problem), start, config)
    assert S.launches.count == 1 and p.accepted is None
    assert torch.equal(k.c0, k.c) and _close(k.c0, p.c0, 0.0)
    assert not bool(k.accepted.any())
    _compare(k, p, config)
    if mode == "first":
        return
    step = bcr_kernel.bcr_solve(*S.system(p, config))
    if mode == "rejected_step":
        step = 30.0 * step
    accept = S.trip_reference(p, step, config)
    assert S.trip(k, step, config) is None
    assert S.launches.count == 2
    assert bool(k.accepted[0]) == bool(accept)
    if mode != "exits" and P > 1:
        assert bool(accept) == (mode == "accepted")
    _compare(k, p, config)
    if mode == "exits" and P > 1:
        assert bool(k.done) and not bool(k.go)


def _carry_state(s):
    return {k: v.clone() for k, v in vars(s).items()
            if isinstance(v, torch.Tensor)}


def _restore(s, state):
    for k, v in state.items():
        getattr(s, k).copy_(v)


@pytest.mark.cuda
@pytest.mark.parametrize("P", [1024, 8192, 16385])
def test_captured_trip_replays_bit_equal_to_eager(cuda_device, P):
    """Three fresh captures of one trip, each replayed three times from
    the same carry: every replay bit-equal to the others and to the eager
    launch (the sums' order is fixed; no atomics)."""
    from hitl_slam_torch.solver import bcr_kernel

    problem, start = _problem(P, cuda_device, seed=3)
    config = LMConfig()
    s = S.begin(problem, start, config)
    step = bcr_kernel.bcr_solve(*S.system(s, config))
    state = _carry_state(s)
    S.trip(s, step, config)
    eager = _carry_state(s)
    S.launches.prepare(cuda_device)
    for _ in range(3):
        _restore(s, state)
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, capture_error_mode="thread_local"):
            S.trip(s, step, config)
        for _ in range(3):
            _restore(s, state)
            g.replay()
            torch.cuda.synchronize()
            for name, want in eager.items():
                assert torch.equal(getattr(s, name), want), name


def _engine(device):
    from hitl_slam_torch.io import logs, stfs
    from hitl_slam_torch.models.hitl.engine import HitLSLAM

    data = stfs.load_stfs_covars(os.path.join(DATA,
                                              "golden_large.stfs.covars.gz"))
    eng = HitLSLAM(device=device)
    eng.init(data.poses, data.covariances, data.point_clouds,
             data.normal_clouds, constraint_capacity=16384)
    return eng, logs.load_log(os.path.join(DATA, "golden_large.log"))


@pytest.mark.cuda
def test_cycle_lm_loop_counts_marks_and_nodes(cuda_device, monkeypatch):
    """The cycle program with the kernel in its LM loop: the stage clock's
    marks are the eight the readers fix; a correction launches the trip
    kernel once a trip and once a solve, BCR once a trip and em_scan twice;
    and the LM body has far fewer nodes than the same capture with the
    plain version (both printed)."""
    from hitl_slam_torch.ops import em_scan
    from hitl_slam_torch.solver import bcr_kernel
    from hitl_slam_torch.utils import device_loop

    eng, entries = _engine(cuda_device)
    for e in entries:
        ct = int(e.correction_type)
        torch.cuda.synchronize()
        for c in (S.launches, bcr_kernel.launches, em_scan.launches):
            c.count = 0
        eng.replay_log(e)
        prog = eng._program(eng.state)
        trips = int(prog.solve_iterations(ct))
        assert S.launches.count == trips + 1
        assert bcr_kernel.launches.count == trips
        assert em_scan.launches.count == 2
        marks = prog.graphs[ct].clock.marks
        assert sorted(marks) == sorted(["begin", "end", "em_scan",
                                        "em_refit", "backprop",
                                        "build_problem", "lm", "bcr_solve"])
    kernel = prog.graph(ct)
    args = (*prog.inputs, ct)

    def plain_begin(problem, poses0, config, mu0=None):
        return S.begin_reference(S.soa_assembler(problem), poses0, config,
                                 mu0)

    monkeypatch.setattr(S, "begin", plain_begin)
    plain = device_loop.LoopGraph(lambda: prog.fn(*args), prog.device,
                                  stream=prog.stream)
    print(f"LM body nodes: kernel {kernel.body_nodes[-1]}, plain "
          f"{plain.body_nodes[-1]}; graph nodes {kernel.nodes} / "
          f"{plain.nodes}")
    assert kernel.levels == plain.levels
    assert kernel.body_nodes[:-1] == plain.body_nodes[:-1]
    assert 4 <= kernel.body_nodes[-1] <= 8 < 100 < plain.body_nodes[-1]
    assert kernel.nodes < plain.nodes


@pytest.mark.cuda
def test_paths_that_keep_the_plain_code_launch_no_trip_kernel(cuda_device):
    """The batched LM, the pose-sharded SPIKE LM and the refine's
    stf_solve assemble on their own paths: none launches the trip kernel,
    replayed or eager."""
    from hitl_slam_torch.bench import seeded_chain
    from hitl_slam_torch.io import logs, stfs
    from hitl_slam_torch.models.hitl.engine import HitLSLAM
    from hitl_slam_torch.parallel import replicas, sharded_solver
    from hitl_slam_torch.parallel.mesh import make_mesh

    problem, start = _problem(256, cuda_device, seed=1)
    config = LMConfig(max_iterations=6)
    poses, table = seeded_chain(128, 2, cuda_device)
    reps, table_b = replicas.make_perturbed_replicas(poses, table, 4)
    data = stfs.load_stfs_covars(os.path.join(DATA, "golden.stfs.covars"))
    eng = HitLSLAM(device=cuda_device)
    eng.init(data.poses, data.covariances, data.point_clouds,
             data.normal_clouds, constraint_capacity=256)
    for e in logs.load_log(os.path.join(DATA, "golden.log")):
        eng.replay_log(e)
    torch.cuda.synchronize()
    S.launches.count = 0
    # eager first: a library's handle is made outside a capture
    for eager in (True, False):
        sharded_solver.sharded_lm_solve(make_mesh(1, 4, [cuda_device] * 4),
                                        problem, start, config, eager=eager)
        replicas.batched_solve(reps, table_b, config, cuda_device,
                               eager=eager)
    eng.post_optimize()
    torch.cuda.synchronize()
    assert S.launches.count == 0
