"""The EM refit round's kernel (csrc/em_refit.cu, ops/em_refit.py): on the
CPU its launch plan, the wrapper's input checks, and the exactness the
kernel rests on (the plain round over a stroke's inliers alone gives the
round over every slot, to f32 round-off); on a card only (marker `cuda`),
the kernel against its plain version on the benchmark's maps and on edge
cases (the same inliers, endpoints within 1e-5 m after a round and after
the whole loop, in as many rounds), captures replayed bit-equal to the
eager launch, and the cycle program with the kernel in its EM loop: its
stage marks, its launch counts and its loop body's graph nodes.

Nothing here imports JAX, so the card's tests run where JAX is not
installed: python -m pytest -p no:cacheprovider --noconftest -m cuda
tests/test_torch_em_refit.py (chip_smoke.py's em_refit phase times the
kernel at the benchmark's sizes)."""

import json
import os

import numpy as np
import pytest
import torch

from hitl_slam_torch.ops import em_refit as R
from hitl_slam_torch.ops.geometry import dist_to_segment
from hitl_slam_torch.utils import cuda_build

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
# endpoints, kernel against plain version: the sums' order differs, and an
# f32 angle moves an endpoint 10 m from the midpoint by ~1e-6 m an ulp
TOL_M = 1e-5


def _padded(clouds):
    """Clouds as [P, N, 2] f32 points (zeros past each cloud) and a [P, N]
    mask."""
    N = max(len(c) for c in clouds)
    pts = np.zeros((len(clouds), N, 2), np.float32)
    mask = np.zeros((len(clouds), N), bool)
    for i, c in enumerate(clouds):
        pts[i, :len(c)] = c
        mask[i, :len(c)] = True
    return pts, mask


def _map(P=96, rays=120, seed=5):
    """A figure-8 map's world points [M, 2], mask [M] and two strokes
    [2, 2, 2] on its walls (lap 2 against lap 1)."""
    from hitl_slam_torch.io.figure8 import (generate_figure8,
                                            synthesize_correction)
    from hitl_slam_torch.ops.geometry import pose_to_world

    m = generate_figure8(num_poses=P, num_rays=rays, seed=seed,
                         drift_theta_bias=8e-4)
    pts, mask = _padded(m.point_clouds)
    poses = torch.as_tensor(m.poses, dtype=torch.float32)
    world = pose_to_world(poses[:, None, :], torch.as_tensor(pts))
    sel = synthesize_correction(m, range(P - P // 3, P), range(0, P // 3),
                                (1, 0.0), (1, 0.0), min_points=5)
    segs = torch.as_tensor(np.asarray(sel, np.float32)).reshape(2, 2, 2)
    return world.reshape(-1, 2), torch.as_tensor(mask).reshape(-1), segs


def _carry(segs, moved=None):
    S = segs.shape[0]
    s = segs.clone()
    moved = (torch.full((S,), float("inf"), device=segs.device)
             if moved is None else moved.clone())
    go = torch.any(moved > R.ENDPOINT_STABLE)
    return s, moved, go


def _inliers(flat, fmask, segs):
    """The plain test's inliers [S, M] of each stroke."""
    p1, p2 = segs[:, 0], segs[:, 1]
    d = dist_to_segment(p1[:, None], p2[:, None], flat[None])
    return fmask[None] & (d < R.INLIER_THRESHOLD)


# ------------------------------------------------------------ on the CPU

@pytest.mark.parametrize("M", [1, 63, 64, 8192, 8193, 174_080, 1_474_560,
                               R.MAX_SLOTS, 262_144, 2_097_152])
def test_launch_plan_follows_the_slots(M):
    """A cluster of a block for each SLOTS_PER_BLOCK slots, up to 16: one
    block for a small map, 16 at both cells' maps."""
    plan = R.launch_plan(M)
    assert 1 <= plan.blocks <= R.MAX_CLUSTER
    assert plan.blocks == min(16, -(-M // R.SLOTS_PER_BLOCK))
    assert (plan.blocks == 1) == (M <= R.SLOTS_PER_BLOCK)


@pytest.mark.parametrize("M", [0, -1, R.MAX_SLOTS + 1])
def test_launch_plan_refuses_what_the_kernel_does_not_take(M):
    with pytest.raises(ValueError):
        R.launch_plan(M)


def _good(M=256, S=2):
    flat = torch.zeros((M, 2))
    fmask = torch.ones((M,), dtype=torch.bool)
    s = torch.zeros((S, 2, 2))
    moved = torch.zeros((S,))
    go = torch.zeros((), dtype=torch.bool)
    stats = torch.zeros((S, 2), dtype=torch.int32)
    return dict(flat=flat, fmask=fmask, s=s, moved=moved, go=go, stats=stats,
                buffers=R.scratch(M, S, "cpu"))


def _bad(case):
    a = _good()
    if case == "flat_dtype":
        a["flat"] = a["flat"].double()
    elif case == "mask_dtype":
        a["fmask"] = a["fmask"].to(torch.uint8)
    elif case == "mask_shape":
        a["fmask"] = a["fmask"][:-1]
    elif case == "s_contiguity":
        a["s"] = torch.zeros((2, 2, 2)).transpose(1, 2)
    elif case == "moved_device":
        a["moved"] = torch.zeros((2,), device="meta")
    elif case == "go_shape":
        a["go"] = torch.zeros((1,), dtype=torch.bool)
    elif case == "stats_dtype":
        a["stats"] = a["stats"].long()
    elif case == "scratch_shape":
        a["buffers"] = R.scratch(128, 2, "cpu")
    elif case == "strokes":
        a = _good(S=3)
    elif case == "alignment":
        a["flat"] = torch.zeros((257, 2))[1:]
    return a


@pytest.mark.parametrize("case", [
    "flat_dtype", "mask_dtype", "mask_shape", "s_contiguity", "moved_device",
    "go_shape", "stats_dtype", "scratch_shape", "strokes", "alignment"])
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    """Device, dtype, shape, contiguity, stroke count and alignment are
    checked before anything launches, each with its own message."""
    with pytest.raises(ValueError) as e:
        R.round_cuda(**_bad(case))
    assert "CUDA" not in str(e.value)


def test_wrapper_launches_only_on_a_card():
    """Inputs the kernel takes, on the CPU: refused for their device;
    round_body gives the plain version there and launches nothing."""
    with pytest.raises(ValueError, match="CUDA"):
        R.round_cuda(**_good())
    flat, fmask, segs = _map(48)
    s, moved, go = _carry(segs)
    s2, moved2, go2 = _carry(segs)
    before = R.launches.count
    R.round_body(flat, fmask, s, moved, go)()
    R.round_reference(flat, fmask, s2, moved2, go2)
    assert R.launches.count == before
    assert torch.equal(s, s2) and torch.equal(moved, moved2)
    assert torch.equal(go, go2)


def test_counter_marks_no_stage_and_exists_before_a_capture():
    assert R.launches.mark is False
    assert "em_refit" in [c.name for c in cuda_build.all_counters()]
    assert "em_refit.cu" in cuda_build.SOURCES
    assert cuda_build.EXTRA["em_refit.cu"] == ["--fmad=false"]


def _one_stroke(flat, fmask, seg):
    """One plain round of stroke `seg` [2, 2] over all slots, and over its
    inliers alone (gathered, every mask bit set): the two carries."""
    w = _inliers(flat, fmask, seg[None])[0]
    whole = _carry(seg[None])
    R.round_reference(flat, fmask, *whole)
    sub = flat[w].contiguous()
    alone = _carry(seg[None])
    R.round_reference(sub, torch.ones(len(sub), dtype=torch.bool), *alone)
    return whole, alone, int(w.sum())


def _strokes(flat, fmask, segs):
    """The map's strokes and the edge cases the kernel must keep: one far
    from every point (no inliers), one of zero length on a wall point, one
    reversed, and one of a stroke's halves."""
    wall = flat[_inliers(flat, fmask, segs[:1])[0]][0]
    return {"first": segs[0], "second": segs[1],
            "no_inliers": torch.tensor([[500.0, 500.0], [510.0, 500.0]]),
            "zero_length": torch.stack([wall, wall]),
            "reversed": segs[0].flip(0),
            "half": torch.stack([segs[1][0], 0.5 * (segs[1][0] +
                                                    segs[1][1])])}


@pytest.mark.parametrize("name", ["first", "second", "no_inliers",
                                  "zero_length", "reversed", "half"])
def test_plain_round_over_the_inliers_alone_gives_the_round(name):
    """What the kernel rests on: every slot that is not an inlier adds an
    exact zero to the plain version's sums, so the round over the gathered
    inliers gives the round over every slot to f32 round-off (only the
    order of the non-zero terms differs). A stroke with no inliers keeps
    its angle; a stroke of zero length stays where it is."""
    flat, fmask, segs = _map()
    seg = _strokes(flat, fmask, segs)[name]
    (s, moved, go), (s1, moved1, go1), count = _one_stroke(flat, fmask, seg)
    assert (count == 0) == (name == "no_inliers")
    assert float((s - s1).abs().max()) <= TOL_M
    assert abs(float(moved[0] - moved1[0])) <= TOL_M
    assert bool(go) == bool(go1)
    if name == "no_inliers":
        # theta unchanged: the endpoints only rounded through cm +- L a
        assert float((s[0] - seg).abs().max()) <= 1e-5
        assert torch.equal(s, s1)
    if name == "zero_length":
        assert torch.equal(s[0], seg) and float(moved[0]) == 0.0
        assert not bool(go)


def test_terms_of_the_slots_that_are_not_inliers_are_exact_zeros():
    """Padded and outlying slots: finite world points (zeros past each
    cloud), so their weighted terms (p - cm) * 0 are exact zeros, which is
    what lets the kernel leave them out of the sums."""
    flat, fmask, segs = _map()
    assert not bool(fmask.all())
    assert bool(torch.isfinite(flat).all())
    w = _inliers(flat, fmask, segs).to(flat.dtype)
    cm = 0.5 * (segs[:, 0] + segs[:, 1])
    relw = (flat - cm[:, None, :]) * w[..., None]
    out = relw[w == 0]
    assert out.numel() and bool((out == 0).all())


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel is CUDA")
    return torch.device("cuda")


def _cell_map(config, traffic):
    """The benchmark cell's map at its seed-0 jitter as the engine holds it
    (make_map_state's padding: world points flat [M, 2] and mask [M] on the
    card), and each of the traffic's strokes sketched on its initial poses
    ([2, 2, 2] on the card)."""
    from cardbench.frozen.sessions import sketch
    from cardbench.mixes.corrections import decode_specs, make_map
    from hitl_slam_torch.core.state import make_map_state

    with open(os.path.join(ROOT, "cardbench", "configs", config)) as f:
        cfg = json.load(f)
    with open(os.path.join(ROOT, "cardbench", "traffic", traffic)) as f:
        tr = json.load(f)
    m = make_map(cfg, tr, 0)
    dev = torch.device("cuda")
    st = make_map_state(np.asarray(m.poses), np.asarray(m.covariances),
                        m.point_clouds, m.normal_clouds, device=dev)
    world, mask = st.world_points(), st.point_mask
    strokes = []
    for spec in decode_specs(tr["specs"], len(m.poses)):
        try:
            sel = sketch(m, spec, m.poses)
        except ValueError:
            continue
        strokes.append(torch.as_tensor(np.asarray(sel, np.float32),
                                       device=dev).reshape(2, 2, 2))
    return world.reshape(-1, 2).contiguous(), mask.reshape(-1), strokes


MAPS = {"1024": ("hitl-figure8-1024.json", "corrections.json"),
        "8192": ("hitl-figure8-8192.json", "colinear-session.json")}


def _kernel_round(flat, fmask, segs, moved=None):
    """One kernel round from a fresh carry: (s, moved, go, stats)."""
    s, mv, go = _carry(segs, moved)
    stats = torch.full((segs.shape[0], 2), -1, dtype=torch.int32,
                       device=segs.device)
    R.round_body(flat, fmask, s, mv, go, stats)()
    return s, mv, go, stats


def _plain_round(flat, fmask, segs, moved=None):
    s, mv, go = _carry(segs, moved)
    R.round_reference(flat, fmask, s, mv, go)
    return s, mv, go


def _loop(flat, fmask, segs, body_of):
    """The whole refit loop eagerly from a fresh carry, each round by
    body_of(s, moved, go)(): (endpoints, rounds)."""
    from hitl_slam_torch.models.hitl.em_input import MAX_ADJUST_ROUNDS
    from hitl_slam_torch.utils.device_loop import device_while

    s, mv, go = _carry(segs)
    rounds = device_while(go, body_of(s, mv, go), MAX_ADJUST_ROUNDS)
    return s, rounds


def _compare(flat, fmask, segs, moved=None):
    """The kernel against the plain version from one carry: the same
    inliers and flags, endpoints and moved within TOL_M; the stats."""
    s, mv, go, stats = _kernel_round(flat, fmask, segs, moved)
    ps, pmv, pgo = _plain_round(flat, fmask, segs, moved)
    want = _inliers(flat, fmask, segs).sum(-1).to(torch.int32)
    active = (torch.full_like(mv, float("inf")) if moved is None
              else moved) > R.ENDPOINT_STABLE
    for k in range(segs.shape[0]):
        if bool(active[k]):
            assert int(stats[k, 0]) == int(want[k]), k
            assert 0 <= int(stats[k, 1]) < len(R.ROUTES)
        else:
            assert int(stats[k, 0]) == -1
            assert torch.equal(s[k], segs[k]) and float(mv[k]) == 0.0
    assert float((s - ps).abs().max()) <= TOL_M
    assert float((mv - pmv).abs().max()) <= TOL_M
    assert bool(go) == bool(pgo)
    return stats


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(MAPS))
def test_kernel_matches_plain_version_on_the_cells_maps(cuda_device, cell):
    """Both cells' maps at their strokes: one round and the whole loop,
    the kernel against the plain version on the card (printed: each
    stroke's inliers and route)."""
    flat, fmask, strokes = _cell_map(*MAPS[cell])
    assert strokes
    for k, segs in enumerate(strokes):
        stats = _compare(flat, fmask, segs)
        print(f"{cell} stroke {k}: inliers {stats[:, 0].tolist()}, route "
              f"{[R.ROUTES[int(r)] for r in stats[:, 1]]}")
        ks, kr = _loop(flat, fmask, segs, lambda s, mv, go: R.round_body(
            flat, fmask, s, mv, go))
        ps, pr = _loop(flat, fmask, segs, lambda s, mv, go: (
            lambda: R.round_reference(flat, fmask, s, mv, go)))
        assert kr == pr
        assert float((ks - ps).abs().max()) <= TOL_M


def _synthetic(M, dev, seed=0):
    """M slots of a wall along y = 0, x in [-10, 10], within 0.02 m of it
    (every slot an inlier of the stroke along it), every 7th masked out."""
    g = torch.Generator().manual_seed(seed)
    x = torch.linspace(-10.0, 10.0, M)
    y = (torch.rand(M, generator=g) - 0.5) * 0.04
    flat = torch.stack([x, y], -1).to(dev)
    fmask = torch.ones(M, dtype=torch.bool)
    fmask[::7] = False
    return flat.contiguous(), fmask.to(dev)


def _walls(dev):
    """Two strokes along the synthetic wall, each holding every slot."""
    wall = torch.tensor([[-10.0, 0.0], [10.0, 0.0]], device=dev)
    return torch.stack([wall, wall + torch.tensor([0.0, 0.005], device=dev)])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["small_map", "no_inliers", "zero_length",
                                  "one_inactive", "odd_slots", "all_shared",
                                  "all_scratch"])
def test_kernel_matches_plain_version_on_edge_cases(cuda_device, case):
    """A small map (a cluster of two), a stroke with no inliers, a
    zero-length stroke, one inactive stroke (left as it is, moved 0), an
    odd slot count that is not a multiple of 64 (one block), and every
    slot an inlier: in shared memory at 65,536 slots, from the scratch at
    524,288 (each block's share past what its shared memory holds)."""
    dev = cuda_device
    if case in ("all_shared", "all_scratch"):
        M = 65_536 if case == "all_shared" else 524_288
        flat, fmask = _synthetic(M, dev)
        wall = torch.tensor([[-10.0, 0.0], [10.0, 0.0]], device=dev)
        segs = _walls(dev)
        stats = _compare(flat, fmask, segs)
        assert [R.ROUTES[int(r)] for r in stats[:, 1]] == [
            case.split("_")[1]] * 2
        assert stats[:, 0].tolist() == [int(fmask.sum())] * 2
        return
    flat, fmask, segs = (t.to(dev) for t in _map(96 if case != "odd_slots"
                                                 else 37))
    assert R.launch_plan(flat.shape[0]).blocks > 1 or case == "odd_slots"
    moved = None
    if case == "no_inliers":
        segs[1] = torch.tensor([[500.0, 500.0], [510.0, 500.0]], device=dev)
    elif case == "zero_length":
        wall = flat[_inliers(flat, fmask, segs[:1])[0]][0]
        segs[0] = torch.stack([wall, wall])
    elif case == "one_inactive":
        moved = torch.tensor([float("inf"), 0.0], device=dev)
    elif case == "odd_slots":
        cut = flat.shape[0] - flat.shape[0] % R.GROUP - 27
        flat, fmask = flat[:cut].contiguous(), fmask[:cut].contiguous()
        assert R.launch_plan(cut).blocks == 1
    stats = _compare(flat, fmask, segs, moved)
    if case == "no_inliers":
        assert int(stats[1, 0]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("M", [6_000, 174_080, 524_288])
def test_captured_round_replays_bit_equal_to_eager(cuda_device, M):
    """Three fresh captures of one round, each replayed three times from
    the same carry: every replay bit-equal to the others and to the eager
    launch (fixed-order sums, no atomics), on a block, the cluster from
    shared memory and the cluster from the scratch."""
    dev = cuda_device
    flat, fmask = _synthetic(M, dev, seed=1)
    if M < 500_000:
        flat[:, 1] *= 20.0     # some slots outside the strokes
        segs = torch.tensor([[[-9.0, 0.1], [9.0, -0.1]],
                             [[-5.0, 0.0], [5.0, 0.05]]], device=dev)
    else:
        segs = _walls(dev)
    buffers = R.scratch(M, 2, dev)
    carry = _carry(segs)
    stats = torch.zeros((2, 2), dtype=torch.int32, device=dev)
    start = [t.clone() for t in carry]

    def restore():
        for t, v in zip(carry, start):
            t.copy_(v)

    R.round_cuda(flat, fmask, *carry, stats, buffers)
    eager = [t.clone() for t in (*carry, stats)]
    R.launches.prepare(dev)
    for _ in range(3):
        restore()
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, capture_error_mode="thread_local"):
            R.round_cuda(flat, fmask, *carry, stats, buffers)
        for _ in range(3):
            restore()
            stats.zero_()
            g.replay()
            torch.cuda.synchronize()
            for got, want in zip((*carry, stats), eager):
                assert torch.equal(got, want)


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
def test_cycle_refit_loop_counts_marks_and_nodes(cuda_device, monkeypatch):
    """The cycle program with the kernel in its EM loop: the stage clock's
    marks are the eight the readers fix; a correction launches the refit
    kernel once a round (the clock's em_refit -> em_refit hits), em_scan
    twice and BCR once an LM iteration; the program keeps each stroke's
    inliers; and the refit loop's body falls from the plain version's
    ~530 nodes to under 10 (both printed)."""
    from hitl_slam_torch.ops import em_scan
    from hitl_slam_torch.solver import bcr_kernel
    from hitl_slam_torch.utils import device_loop

    eng, entries = _engine(cuda_device)
    for e in entries:
        ct = int(e.correction_type)
        torch.cuda.synchronize()
        for c in (R.launches, bcr_kernel.launches, em_scan.launches):
            c.count = 0
        prog = eng._program(eng.state)
        g = prog.graphs.get(ct)
        before = 0
        if g is not None:
            clock = g.clock.read()
            i = clock["marks"].index("em_refit")
            before = int(clock["edge_hits"][i, i])
        eng.replay_log(e)
        g = prog.graphs[ct]
        clock = g.clock.read()
        i = clock["marks"].index("em_refit")
        rounds = int(clock["edge_hits"][i, i]) - before
        assert rounds >= 1
        assert R.launches.count == rounds
        assert bcr_kernel.launches.count == int(prog.solve_iterations(ct))
        assert em_scan.launches.count == 2
        assert sorted(g.clock.marks) == sorted(
            ["begin", "end", "em_scan", "em_refit", "backprop",
             "build_problem", "lm", "bcr_solve"])
        print(f"correction type {ct}: {rounds} rounds, inliers and routes "
              f"{prog.refit_stats.tolist()}")
        assert bool((prog.refit_stats[:, 0] >= 0).all())
        assert bool((prog.refit_stats[:, 1] >= 0).all())
        assert bool((prog.refit_stats[:, 1] < len(R.ROUTES)).all())
    kernel = prog.graph(ct)
    args = (*prog.inputs, ct)

    def plain_body(flat, fmask, s, moved, go, stats=None):
        return lambda: R.round_reference(flat, fmask, s, moved, go)

    monkeypatch.setattr(R, "round_body", plain_body)
    plain = device_loop.LoopGraph(lambda: prog.fn(*args), prog.device,
                                  stream=prog.stream)
    print(f"EM refit body nodes: kernel {kernel.body_nodes[0]}, plain "
          f"{plain.body_nodes[0]}; graph nodes {kernel.nodes} / "
          f"{plain.nodes}")
    assert kernel.levels == plain.levels
    assert kernel.body_nodes[1:] == plain.body_nodes[1:]
    assert kernel.body_nodes[0] < 10 < 400 < plain.body_nodes[0]
    assert kernel.nodes < plain.nodes
