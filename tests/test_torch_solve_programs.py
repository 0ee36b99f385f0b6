"""The lone LM (`lm.solve`), `repair_step`, the pose-sharded LM and the
bench's chained solve-only rounds as device programs: on the CPU the
rounds' carry form against a copy of the loop it replaced, kept here (bit
for bit), and the routes each entry point takes; on a card only (marker
`cuda`), replays of the four programs against `eager=True`.

The inputs are made by the port's own generators and readers, and nothing
here imports JAX, so the card's tests run where JAX is not installed:
python -m pytest -p no:cacheprovider --noconftest -m cuda
tests/test_torch_solve_programs.py (chip_smoke.py phase 23 runs the same
comparisons at full size). The JAX parity of the three solvers is held by
tests/test_torch_solver.py, tests/test_torch_cycle.py and
tests/test_torch_mesh.py, which run the same carry forms eagerly."""

import os

import numpy as np
import pytest
import torch

from test_torch_refine_program import _CardReads, cuda_device  # noqa: F401
from torch_port_helpers import t

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
LM_FIELDS = ("poses", "final_cost", "initial_cost", "iterations",
             "converged", "final_mu")


def _chain_problem(P, device, seed=0):
    """bench.seeded_chain's drifting chain of P poses with 3 LINE_SEGMENT
    rows, and its problem, on `device`."""
    from hitl_slam_torch.bench import seeded_chain
    from hitl_slam_torch.solver import joint

    poses, table = seeded_chain(P, seed, device)
    poses = torch.as_tensor(poses, device=device)
    return poses, table, joint.build_problem(poses, table)


def _golden_repair_args(device):
    """repair_step's arguments for the 64-pose golden map's first logged
    correction: the selection refit and counted by the port, ordered by
    order_and_filter (chip_smoke.py's phase 15 makes them so)."""
    from hitl_slam_torch.core.state import make_map_state
    from hitl_slam_torch.io import logs, stfs
    from hitl_slam_torch.models.hitl import em_input as EI

    data = stfs.load_stfs_covars(os.path.join(DATA, "golden.stfs.covars"))
    entry = logs.load_log(os.path.join(DATA, "golden.log"))[0]
    st = make_map_state(data.poses, data.covariances, data.point_clouds,
                        data.normal_clouds, constraint_capacity=256,
                        device=device)
    world = st.world_points()
    raw = torch.as_tensor(np.asarray(entry.points, np.float32),
                          device=device)
    refit = EI.endpoint_adjust_batch(
        world, st.point_mask, torch.stack([raw[0:2], raw[2:4]])
    ).reshape(4, 2)
    c1, c2 = EI.observation_counts(world, st.point_mask, refit)
    o = EI.order_and_filter(c1.cpu().numpy(), c2.cpu().numpy(),
                            refit.cpu().numpy())
    assert o.valid
    corr, anch = o.corrected_poses, o.anchor_poses
    breaks = np.nonzero(np.diff(corr) > 1)[0]
    group = corr[:breaks[0] + 1] if len(breaks) else corr
    gmask = np.zeros(len(data.poses), bool)
    gmask[group] = True

    def pad(ix):
        out = np.full(64, -1, np.int32)
        out[:min(len(ix), 64)] = ix[:64]
        return out

    T = lambda a: torch.as_tensor(a, device=device)   # noqa: E731
    return (st.poses, st.covariances, st.constraints,
            int(entry.correction_type),
            T(o.selected_points.astype(np.float32)), T(gmask), int(group[-1]),
            T(pad(anch)), T(pad(corr)), o.backprop_start, o.backprop_end, 0)


# ------------------------------------------------------------ on the CPU

def _old_rounds(p0, tbl, config, s_rep):
    """bench_sessions.solve_only_section's rounds as they were before the
    program: a Python loop over k."""
    from hitl_slam_torch.solver import joint, lm

    acc = torch.zeros((), dtype=p0.dtype, device=p0.device)
    for k in range(s_rep):
        p = p0 + 1e-6 * (k + 1) + acc * 0.0
        r = lm.solve(joint.build_problem(p, tbl), p, config)
        acc = torch.sum(r.poses)
    return acc, r


def test_solve_rounds_carry_form_bit_equal_to_old_loop():
    """solve_rounds' carry form (a device_for over the rounds, each
    round's offset read from a table by the device index) and the loop it
    replaced, kept above: the same checksum bit for bit, and the last
    round's iteration count."""
    from hitl_slam_torch.bench_sessions import solve_rounds
    from hitl_slam_torch.solver.lm import LMConfig

    poses, table, _ = _chain_problem(48, "cpu", seed=2)
    config = LMConfig(max_iterations=8)
    acc, its = solve_rounds(poses, table, config, 3)
    want, last = _old_rounds(poses, table, config, 3)
    assert torch.equal(acc, want)
    assert its.shape == (3,) and its.dtype == torch.int32
    assert int(its[-1]) == int(last.iterations)


def test_entry_points_run_eagerly_on_the_cpu(monkeypatch):
    """On the CPU solve, repair_step, sharded_lm_solve and solve_rounds
    run their carry forms and make no program; `eager` changes nothing
    there; a program refuses a CPU device."""
    from hitl_slam_torch.bench_sessions import solve_rounds
    from hitl_slam_torch.models.hitl import repair as R
    from hitl_slam_torch.parallel import sharded_solver as S
    from hitl_slam_torch.parallel.mesh import make_mesh
    from hitl_slam_torch.solver import lm
    from hitl_slam_torch.utils import device_loop

    def no_program(*a, **k):
        raise AssertionError("a program was made on the CPU")

    monkeypatch.setattr(device_loop.DeviceProgram, "__init__", no_program)
    poses, table, problem = _chain_problem(32, "cpu", seed=4)
    config = lm.LMConfig(max_iterations=6)
    for a, b in ((lm.solve(problem, poses, config),
                  lm.solve(problem, poses, config, eager=True)),
                 (S.sharded_lm_solve(make_mesh(1, 4, ["cpu"] * 4), problem,
                                     poses, config),
                  S.sharded_lm_solve(make_mesh(1, 4, ["cpu"] * 4), problem,
                                     poses, config, eager=True))):
        for name in LM_FIELDS:
            assert torch.equal(getattr(a, name), getattr(b, name)), name
    acc, _ = solve_rounds(poses, table, config, 2)
    assert torch.equal(acc, solve_rounds(poses, table, config, 2,
                                         eager=True)[0])
    args = _golden_repair_args("cpu")
    got = R.repair_step(*args, lm_config=config)
    want = R.repair_step(*args, lm_config=config, eager=True)
    assert torch.equal(got.poses, want.poses)
    monkeypatch.undo()
    with pytest.raises(ValueError, match="CUDA"):
        lm.solve_program((problem, poses), config)


# ------------------------------------------------------------ on the card

def _same_lm(a, b):
    return all(torch.equal(getattr(a, k), getattr(b, k)) for k in LM_FIELDS)


@pytest.mark.cuda
@pytest.mark.parametrize("warm", [False, True])
def test_solve_program_matches_eager(cuda_device, warm):
    """A replay of the lone LM's program (with and without a warm-start
    damping): bit-equal to `eager=True`, the same accept flags, one host
    read a call, BCR launched once an iteration by the replay."""
    from hitl_slam_torch.solver import bcr_kernel as B, lm

    poses, _, problem = _chain_problem(512, cuda_device)
    config = lm.LMConfig(max_iterations=20)
    mu0 = (torch.full((), 3e-3, device=cuda_device) if warm else None)
    flags_e, flags_p = [], []
    want = lm.solve(problem, poses, config, mu0=mu0, accepts=flags_e,
                    eager=True)
    got = lm.solve(problem, poses, config, mu0=mu0, accepts=flags_p)
    assert _same_lm(got, want)
    assert [bool(f) for f in flags_p] == [bool(f) for f in flags_e]
    B.launches.count = 0
    with _CardReads() as mode:
        out = lm.solve(problem, poses, config, mu0=mu0)
        out.poses.cpu()
    assert mode.reads == 1
    assert B.launches.count == int(out.iterations)


@pytest.mark.cuda
def test_repair_program_matches_eager(cuda_device):
    """A replay of repair_step's program: bit-equal to `eager=True`, one
    host read a call."""
    from hitl_slam_torch.models.hitl.repair import repair_step
    from hitl_slam_torch.solver.lm import LMConfig

    args = _golden_repair_args(cuda_device)
    config = LMConfig(max_iterations=20)
    want = repair_step(*args, lm_config=config, eager=True)
    got = repair_step(*args, lm_config=config)
    assert _same_lm(got.lm, want.lm)
    for name in ("poses", "covariances", "num_new_constraints",
                 "correction", "pre_solve_poses"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    for name in vars(want.constraints):
        assert torch.equal(getattr(got.constraints, name),
                           getattr(want.constraints, name)), name
    with _CardReads() as mode:
        repair_step(*args, lm_config=config).poses.cpu()
    assert mode.reads == 1


@pytest.mark.cuda
@pytest.mark.parametrize("d", [4, 8])
def test_sharded_program_matches_eager(cuda_device, d):
    """A replay of the pose-sharded LM's program on [cuda] x d: bit-equal
    to `eager=True`, one host read a call, the multi BCR route launched
    once an iteration by the replay and no other route."""
    from hitl_slam_torch.parallel.mesh import make_mesh
    from hitl_slam_torch.parallel.sharded_solver import sharded_lm_solve
    from hitl_slam_torch.solver import bcr_kernel as B
    from hitl_slam_torch.solver.lm import LMConfig

    poses, _, problem = _chain_problem(256, cuda_device, seed=1)
    mesh = make_mesh(1, d, [cuda_device] * d)
    config = LMConfig(max_iterations=20)
    want = sharded_lm_solve(mesh, problem, poses, config, eager=True)
    got = sharded_lm_solve(mesh, problem, poses, config)
    assert _same_lm(got, want)
    for c in (B.launches, B.batched_launches, B.multi_launches):
        c.count = 0
    with _CardReads() as mode:
        out = sharded_lm_solve(mesh, problem, poses, config)
        out.poses.cpu()
    assert mode.reads == 1
    assert (B.multi_launches.count, B.launches.count,
            B.batched_launches.count) == (int(out.iterations), 0, 0)


@pytest.mark.cuda
def test_solve_rounds_program_matches_eager(cuda_device):
    """A replay of the chained solve-only rounds: bit-equal to
    `eager=True` (checksum and each round's iterations)."""
    from hitl_slam_torch.bench_sessions import solve_rounds
    from hitl_slam_torch.solver.lm import LMConfig

    poses, table, _ = _chain_problem(256, cuda_device, seed=3)
    want = solve_rounds(poses, table, LMConfig(), 4, eager=True)
    got = solve_rounds(poses, table, LMConfig(), 4)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
