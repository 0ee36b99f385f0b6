"""The correction cycle as a device program: `device_while`'s eager
semantics, the host reads of an eager cycle (its loops' exit tests and
nothing else), the carry-form LM and EM refit against copies of the loops
they replaced (bit-equal on the CPU) and against the JAX package, and, on
a card only (marker `cuda`), replays of `CycleProgram` against eager
`cycle_step`.

On the card: python -m pytest -p no:cacheprovider -m cuda
tests/test_torch_device_program.py (chip_smoke.py phase 19 runs the same
comparisons at full size)."""

import os
import sys

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from torch_port_helpers import n, t

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(__file__), "data")
aten = torch.ops.aten
READS = (aten._local_scalar_dense.default, aten.nonzero.default,
         aten.item.default)


class _HostReads(TorchDispatchMode):
    """Records every read back to the host (scalar reads, nonzero, and
    device-to-host copies) and whether `device_while` made it."""

    def __init__(self):
        super().__init__()
        self.reads = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        to_host = (
            (func is aten._to_copy.default and args[0].device.type != "cpu"
             and str(kwargs.get("device", args[0].device)) == "cpu")
            or (func is aten.copy_.default and args[0].device.type == "cpu"
                and args[1].device.type != "cpu"))
        if func in READS or to_host:
            self.reads.append((str(func), _in_device_while()))
        return func(*args, **kwargs)


def _in_device_while() -> bool:
    from hitl_slam_torch.utils import device_loop

    f = sys._getframe()
    while f is not None:
        if f.f_code is device_loop.device_while.__code__:
            return True
        f = f.f_back
    return False


# ------------------------------------------------------------ device_while

@pytest.mark.parametrize("stop,max_trips", [(0, 5), (1, 5), (3, 5), (5, 5),
                                            (9, 5), (4, 0)])
def test_device_while_eager_stops_at_first_false(stop, max_trips):
    """Eagerly: one test of `cond` before each trip, the loop's only host
    reads; it stops at the first false test or after max_trips trips
    (without a test then)."""
    from hitl_slam_torch.utils.device_loop import device_while

    k = torch.zeros((), dtype=torch.int32)
    cond = torch.tensor(stop > 0)
    seen = []

    def body():
        seen.append(int(k))
        k.add_(1)
        cond.copy_(k < stop)

    with _HostReads() as mode:
        trips = device_while(cond, body, max_trips)
    want = min(stop, max_trips)
    assert trips == want == int(k)
    assert seen == list(range(want))
    tests = want + (1 if want < max_trips else 0)
    assert len(mode.reads) == tests + want   # + the body's own int(k)
    assert sum(inside for _, inside in mode.reads) == len(mode.reads)


def _nested(device, seed: int):
    """An outer loop of 5 trips, each with work before and after an inner
    loop whose trips the data decide ((k * 29 + seed) % 70 asked, at most
    64 run): (run, its carry)."""
    from hitl_slam_torch.utils.device_loop import device_while

    def z(dtype):
        return torch.zeros((), dtype=dtype, device=device)

    outer_k, inner_k = z(torch.int32), z(torch.int32)
    cond_o, cond_i = z(torch.bool), z(torch.bool)
    trips = torch.zeros(5, dtype=torch.int32, device=device)
    acc = torch.zeros(8, device=device)
    g = torch.Generator().manual_seed(seed)
    w = (torch.randn((8, 8), generator=g) * 0.3).to(device)
    m = torch.randn((8, 8), generator=g).to(device)

    def run():
        cond_o.fill_(True)

        def outer():
            stop = (outer_k * 29 + seed) % 70
            acc.mul_(0.5)
            inner_k.zero_()
            torch.lt(inner_k, stop, out=cond_i)

            def inner():
                m.copy_(torch.tanh(m @ w))
                acc.add_(m[0])
                inner_k.add_(1)
                torch.lt(inner_k, stop, out=cond_i)

            device_while(cond_i, inner, 64)
            trips.index_copy_(0, outer_k.long()[None], inner_k[None])
            acc.add_(inner_k.to(acc.dtype))
            outer_k.add_(1)
            torch.lt(outer_k, 5, out=cond_o)

        return device_while(cond_o, outer, 100)

    return run, (trips, acc, m, outer_k)


@pytest.mark.parametrize("seed", [0, 7, 40])
def test_device_while_nested_eager(seed):
    """A loop inside a loop's trip, run eagerly: the inner trip counts and
    the carry equal plain Python loops' on the same data, and every host
    read is a device_while test (at each level a test before each trip and
    the failing one, none after a trip cap)."""
    run, (trips, acc, m, outer_k) = _nested("cpu", seed)
    m0 = m.clone()
    with _HostReads() as mode:
        assert run() == 5
    want = [min((k * 29 + seed) % 70, 64) for k in range(5)]
    assert trips.tolist() == want and int(outer_k) == 5
    a, mm = torch.zeros(8), m0
    g = torch.Generator().manual_seed(seed)
    w = torch.randn((8, 8), generator=g) * 0.3
    for k in range(5):
        a = a * 0.5
        for _ in range(want[k]):
            mm = torch.tanh(mm @ w)
            a = a + mm[0]
        a = a + want[k]
    assert torch.equal(acc, a) and torch.equal(m, mm)
    tests = 6 + sum(t + (t < 64) for t in want)
    assert len(mode.reads) == tests
    assert all(inside for _, inside in mode.reads)


@pytest.mark.parametrize("taken", [True, False])
def test_device_while_one_trip_is_an_if(taken):
    """device_while(flag, body, max_trips=1), the reference's lax.cond:
    the body runs once when the flag holds and not at all otherwise, after
    one host read of the flag (none after the trip: the cap is reached)."""
    from hitl_slam_torch.utils.device_loop import device_while

    x = torch.ones(4)
    flag = torch.tensor(taken)

    def body():
        x.add_(torch.arange(4.0))

    with _HostReads() as mode:
        trips = device_while(flag, body, 1)
    assert trips == int(taken) and len(mode.reads) == 1
    assert torch.equal(x, 1.0 + torch.arange(4.0) * taken)


def test_loop_graph_needs_a_card():
    from hitl_slam_torch.models.hitl.cycle import CycleProgram
    from hitl_slam_torch.solver.lm import LMConfig

    with pytest.raises(ValueError):
        CycleProgram(8, 4, 16, LMConfig(), False, False, "cpu")


def test_launch_counter_eager_and_reset():
    from hitl_slam_torch.utils.cuda_build import LaunchCounter

    c = LaunchCounter("probe")
    c.bump(torch.device("cpu"))
    c.bump(torch.device("cpu"))
    assert c.count == 2
    c.count = 0
    assert c.count == 0


def test_every_kernel_counter_exists_before_a_capture():
    """In a fresh process that imported only the program layer, the
    counters a capture prepares are every kernel wrapper's: none depends on
    what the caller imported first."""
    import subprocess

    code = ("from hitl_slam_torch.utils import cuda_build, device_loop; "
            "print(' '.join(c.name for c in cuda_build.all_counters()))")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, check=True,
                         capture_output=True, text=True).stdout.split()
    assert {"em_scan", "bcr_solve", "bcr_solve_batched",
            "bcr_solve_multi"} <= set(out)


def test_capture_ticket_restores():
    from hitl_slam_torch.ops import em_scan as E

    a, b = E.new_ticket("cpu"), E.new_ticket("cpu")
    with E.capture_ticket(a):
        assert E._capture.ticket is a
        with E.capture_ticket(b):
            assert E._capture.ticket is b
        assert E._capture.ticket is a
    assert getattr(E._capture, "ticket", None) is None


# ------------------------------------------------------------ today's loops

def _em_loop(world_pts, mask, segs):
    """endpoint_adjust_batch as its round loop was before the carry form:
    (the refit segments, rounds run)."""
    from hitl_slam_torch.models.hitl import em_input as E
    from hitl_slam_torch.ops.geometry import dist_to_segment, norm2

    flat = world_pts.reshape(-1, 2)
    fmask = mask.reshape(-1)
    dtype = segs.dtype
    s = segs
    moved = torch.full((segs.shape[0],), float("inf"), dtype=dtype)
    rounds = 0
    for _ in range(E.MAX_ADJUST_ROUNDS):
        active = moved > E.ENDPOINT_STABLE
        if not bool(torch.any(active)):
            break
        rounds += 1
        p1, p2 = s[:, 0], s[:, 1]
        d = dist_to_segment(p1[:, None], p2[:, None], flat[None])
        w = (fmask[None] & (d < E.INLIER_THRESHOLD)).to(dtype)
        cm = 0.5 * (p1 + p2)
        delta = p1 - p2
        half_len = 0.5 * norm2(delta)
        theta0 = torch.atan2(delta[:, 1], delta[:, 0])
        theta = E._segfit_theta(flat, w, cm, half_len, theta0)
        a = torch.stack([torch.cos(theta), torch.sin(theta)], -1)
        new1 = cm + half_len[:, None] * a
        new2 = cm - half_len[:, None] * a
        moved_now = torch.maximum(norm2(new1 - p1), norm2(new2 - p2))
        new_s = torch.stack([new1, new2], dim=1)
        s = torch.where(active[:, None, None], new_s, s)
        moved = torch.where(active, moved_now, torch.zeros_like(moved_now))
    return s, rounds


def _lm_loop(problem, poses0, config, linear_solver, accepts):
    """lm.solve as its iteration loop was before the carry form."""
    from hitl_slam_torch.solver import lm as L

    assemble = L._assembler(problem, True)
    D, U, g, c = assemble(poses0)
    c0, x = c, poses0
    mu = torch.tensor(config.initial_mu, dtype=poses0.dtype)
    nu = torch.tensor(2.0, dtype=poses0.dtype)
    two = torch.tensor(2.0, dtype=poses0.dtype)
    third = torch.tensor(1.0 / 3.0, dtype=poses0.dtype)
    it = 0
    done = torch.zeros((), dtype=torch.bool)
    while it < config.max_iterations:
        diag = torch.clamp(torch.diagonal(D, dim1=-2, dim2=-1),
                           config.min_diagonal, config.max_diagonal)
        D_damped = D + mu * torch.diag_embed(diag)
        step = linear_solver(D_damped, U, -g)
        x_new = x + step
        D_new, U_new, g_new, c_new = assemble(x_new)
        pred = 0.5 * torch.sum(step * (mu * diag * step - g))
        rho = (c - c_new) / torch.clamp(pred, min=1e-30)
        accept = (rho > 0) & torch.isfinite(c_new)
        accepts.append(bool(accept))
        x = torch.where(accept, x_new, x)
        D = torch.where(accept, D_new, D)
        U = torch.where(accept, U_new, U)
        g = torch.where(accept, g_new, g)
        c_next = torch.where(accept, c_new, c)
        tt = 2.0 * rho - 1.0
        factor = torch.maximum(third, 1.0 - tt * (tt * tt))
        mu = torch.where(accept, mu * factor, mu * nu)
        nu = torch.where(accept, two, nu * 2.0)
        mu = torch.clamp(mu, 1e-32, 1e32)
        fdone = accept & (torch.abs(c - c_new)
                          <= config.function_tolerance * c)
        xnorm = torch.sqrt(torch.sum(x * x))
        sdone = (torch.sqrt(torch.sum(step * step))
                 <= config.parameter_tolerance
                 * (xnorm + config.parameter_tolerance))
        mdone = mu >= config.mu_collapse
        c = c_next
        it += 1
        done = done | fdone | sdone | mdone
        if bool(done):
            break
    return x, c, c0, it, done, mu


@pytest.mark.parametrize("kind", ["noop", "pulls", "LINE_SEGMENT", "COLINEAR",
                                  "PERPENDICULAR", "PARALLEL"])
def test_lm_carry_form_bit_equal_and_matches_jax(kind):
    """The carry-form lm.solve against today's loop (kept above): poses,
    costs, damping, iterations and accept sequence bit-equal on the CPU;
    against the JAX solve, tests/test_torch_solver.py's standard (equal
    iteration counts and accept sequences but at the f32 boundary it
    names, costs and poses within its tolerances)."""
    from test_torch_solver import _lm_parity, _lm_problem, _one_row_table

    from hitl_slam_torch.core.state import table_from_numpy
    from hitl_slam_torch.solver import joint as TJ, lm as TL, tridiag as TT

    poses, row, iters = _lm_problem(kind, seed=len(kind))
    tab = _one_row_table(row)
    config = TL.LMConfig(max_iterations=iters)
    prob = TJ.build_problem(t(poses), table_from_numpy(tab, "cpu"))
    acc_new, acc_old = [], []
    got = TL.solve(prob, t(poses), config, linear_solver=TT.bcr_solve,
                   accepts=acc_new)
    x, c, c0, it, done, mu = _lm_loop(prob, t(poses), config, TT.bcr_solve,
                                      acc_old)
    assert torch.equal(got.poses, x) and torch.equal(got.final_cost, c)
    assert torch.equal(got.initial_cost, c0)
    assert int(got.iterations) == it and bool(got.converged) == bool(done)
    assert torch.equal(got.final_mu, mu)
    assert [bool(a) for a in acc_new] == acc_old
    _lm_parity(kind, use_soa=True)


@pytest.mark.parametrize("jitter", [0.0, 0.02, 0.05])
def test_endpoint_adjust_carry_form_bit_equal_and_matches_jax(
        jitter, small_map, small_state):
    """The carry-form EM refit against today's round loop (kept above):
    bit-equal on the CPU, with its rounds; against the JAX refit within
    tests/test_torch_em.py's tolerance."""
    import jax.numpy as jnp
    from test_torch_em import _selection

    from hitl_slam_torch.models.hitl import em_input as TE
    from hitl_slam_tpu.models.hitl import em_input as JE

    world = np.asarray(small_state.world_points())
    mask = np.asarray(small_state.point_mask)
    sel = _selection(small_map, jitter)
    segs = np.stack([sel[0:2], sel[2:4]])
    with _HostReads() as mode:
        got = TE.endpoint_adjust_batch(t(world), t(mask), t(segs))
    old, rounds = _em_loop(t(world), t(mask), t(segs))
    assert torch.equal(got, old)
    assert rounds >= 1
    # one exit test a round and the last one, all device_while's
    assert len(mode.reads) == rounds + (rounds < TE.MAX_ADJUST_ROUNDS)
    assert all(inside for _, inside in mode.reads)
    ref = np.asarray(JE.endpoint_adjust_batch(jnp.asarray(world),
                                              jnp.asarray(mask),
                                              jnp.asarray(segs)))
    np.testing.assert_allclose(n(got), ref, atol=1e-4)


# ------------------------------------------------------------ the cycle

def _golden(name):
    from hitl_slam_torch.io import logs, stfs

    suffix = ".stfs.covars.gz" if name == "golden_large" else ".stfs.covars"
    data = stfs.load_stfs_covars(os.path.join(DATA, name + suffix))
    return data, logs.load_log(os.path.join(DATA, name + ".log"))


def _sessions():
    """(fixture, correction index) of every logged correction of both
    golden sessions."""
    return [("golden", 0), ("golden_large", 0), ("golden_large", 1)]


@pytest.mark.parametrize("name,index", _sessions())
def test_cycle_reads_host_only_at_loop_exits(name, index):
    """cycle_step on the golden fixtures from the state each logged
    correction meets: every host read comes from device_while's exit
    tests, as many as the EM rounds and LM iterations need (a test before
    each trip and the failing one), and there are no others."""
    from hitl_slam_torch.models.hitl import cycle as C, em_input as E
    from hitl_slam_torch.models.hitl.engine import HitLSLAM
    from hitl_slam_torch.ops.geometry import pose_to_world
    from hitl_slam_torch.core.state import CorrectionType

    data, entries = _golden(name)
    eng = HitLSLAM(device="cpu")
    eng.init(data.poses, data.covariances, data.point_clouds,
             data.normal_clouds, constraint_capacity=16384)
    for e in entries[:index]:
        eng.replay_log(e)
    e = entries[index]
    st = eng.state
    ct = int(e.correction_type)
    sel = t(eng._prepare_sel(e.correction_type,
                             np.asarray(e.points, np.float32)))
    with _HostReads() as mode:
        out, lm, _ = C.cycle_solve(st.points, st.point_mask, st.poses,
                                   st.covariances, st.constraints, ct, sel,
                                   eng.num_constraints)
    assert bool(out.verified) and bool(out.order_valid)
    assert all(inside for _, inside in mode.reads), mode.reads
    tests = 0
    if ct not in (int(CorrectionType.POINT), int(CorrectionType.CORNER)):
        world = pose_to_world(st.poses[:, None, :], st.points)
        _, rounds = _em_loop(world, st.point_mask,
                             torch.stack([sel[0:2], sel[2:4]]))
        tests += rounds + (rounds < E.MAX_ADJUST_ROUNDS)
    its, cap = int(lm.iterations), C.LMConfig().max_iterations
    tests += its + (its < cap)
    assert len(mode.reads) == tests, (len(mode.reads), tests)


# ------------------------------------------------------------ on the card

@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graphs and the kernels have "
                    "no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_program_replay_matches_eager_cycle(cuda_device):
    """Each golden_large correction from the state it meets: a replay of
    the map's CycleProgram bit-equal to eager cycle_step on the card."""
    from hitl_slam_torch.models.hitl import cycle as C
    from hitl_slam_torch.models.hitl.engine import HitLSLAM

    data, entries = _golden("golden_large")
    eng = HitLSLAM(device=cuda_device)
    eng.init(data.poses, data.covariances, data.point_clouds,
             data.normal_clouds, constraint_capacity=16384)
    for e in entries:
        st, num = eng.state, eng.num_constraints
        ct = int(e.correction_type)
        sel = torch.as_tensor(eng._prepare_sel(
            e.correction_type, np.asarray(e.points, np.float32)),
            device=cuda_device)
        want = C.clone_output(C.cycle_step(
            st.points, st.point_mask, st.poses, st.covariances,
            st.constraints, ct, sel, num))
        got = eng._program(st).run(ct, st.points, st.point_mask, st.poses,
                                   st.covariances, st.constraints, sel, num)
        for k in ("verified", "order_valid", "num_new_constraints",
                  "lm_iterations"):
            assert int(getattr(got, k)) == int(getattr(want, k)), k
        for k in ("poses", "covariances", "pre_solve_poses", "refit_sel",
                  "lm_initial_cost", "lm_final_cost", "lm_final_mu"):
            assert torch.equal(getattr(got, k), getattr(want, k)), k
        assert eng.replay_log(e).accepted


@pytest.mark.cuda
def test_nested_loop_graph_matches_eager(cuda_device):
    """A loop inside a loop's trip captured by LoopGraph (a WHILE node in
    a WHILE node's body) and an IF (a loop of one trip): each replay's
    inner trip counts and carry bit-equal to the same code run eagerly on
    the card, for three seeds, and the graph's loops at levels 1 and 2."""
    from hitl_slam_torch.utils.device_loop import LoopGraph, device_while

    for seed in (0, 7, 40):
        run, carry = _nested(cuda_device, seed)
        start = [c.clone() for c in carry]

        def reset():
            for c, c0 in zip(carry, start):
                c.copy_(c0)

        g = LoopGraph(run, cuda_device)
        assert g.levels == [1, 2]
        reset()
        g.replay()
        got = [c.clone() for c in carry]
        reset()
        assert run() == 5
        assert all(torch.equal(a, b) for a, b in zip(got, carry))
        assert got[0].tolist() == [min((k * 29 + seed) % 70, 64)
                                   for k in range(5)]
    flag = torch.zeros((), dtype=torch.bool, device=cuda_device)
    x = torch.zeros(4, device=cuda_device)

    def branch():
        device_while(flag, lambda: x.add_(1.0), 1)
        return x * 2.0

    g = LoopGraph(branch, cuda_device)
    for taken in (True, False):
        x.zero_()
        flag.fill_(taken)
        g.replay()
        assert torch.equal(g.outputs, torch.full_like(x, 2.0 * taken))


@pytest.mark.cuda
def test_program_chain_matches_eager_chain(cuda_device):
    """queue_chain through the program against the eager chain on the
    card: the same per-cycle flags and carried poses."""
    from hitl_slam_torch.core.state import make_map_state
    from hitl_slam_torch.models.hitl import cycle as C

    data, entries = _golden("golden_large")
    st = make_map_state(data.poses, data.covariances, data.point_clouds,
                        data.normal_clouds, constraint_capacity=16384,
                        device=cuda_device)
    sels = torch.as_tensor(np.stack([np.asarray(e.points, np.float32)
                                     for e in entries]), device=cuda_device)
    ctypes = [int(e.correction_type) for e in entries]
    args = (st.points, st.point_mask, st.poses, st.covariances,
            st.constraints, ctypes, sels, 0)
    got = C.queue_chain(*args)
    want = C.queue_chain_eager(*args)
    for a, b in zip(got[4], want[4]):
        assert torch.equal(a, b)
    assert torch.equal(got[0], want[0]) and torch.equal(got[3], want[3])
