"""Port parity: explicit correction, backprop, the constraint scatter, and the
whole correction cycle (cycle_step, queue_chain) against the JAX package on
the CPU, on the inputs of __graft_entry__.entry() (_tiny_cycle_inputs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import chain_poses as _chain, n, np_fields, t

torch.set_num_threads(2)

TYPES = ["POINT", "LINE_SEGMENT", "CORNER", "COLINEAR", "PERPENDICULAR",
         "PARALLEL"]


@pytest.mark.parametrize("ctype", TYPES)
def test_explicit_and_deltas_match(ctype):
    from hitl_slam_torch.core.state import CorrectionType
    from hitl_slam_torch.models.hitl import explicit as TX
    from hitl_slam_tpu.models.hitl import explicit as JX

    rng = np.random.default_rng(TYPES.index(ctype))
    P = 48
    poses = _chain(rng, P)
    sel = rng.normal(0, 3, (4, 2)).astype(np.float32)
    if ctype == "POINT":
        sel = np.stack([sel[0], sel[0], sel[2], sel[2]])
    group = np.zeros(P, bool)
    group[30:37] = True
    last = np.int32(36)
    anchors = np.full(64, -1, np.int32)
    anchors[:5] = [2, 3, 4, 8, 9]
    corr = np.full(64, -1, np.int32)
    corr[:7] = np.arange(30, 37)
    ct = int(CorrectionType[ctype])

    got_p, got_c = TX.apply_explicit(t(poses), ct, t(sel), t(group),
                                     torch.tensor(last))
    ref_p, ref_c = JX.apply_explicit(jnp.asarray(poses), jnp.asarray(ct),
                                     jnp.asarray(sel), jnp.asarray(group),
                                     jnp.asarray(last))
    # one rigid transform of metre-scale poses: f32 trig differs by ~1 ulp
    np.testing.assert_allclose(n(got_p), np.asarray(ref_p), atol=2e-5)
    np.testing.assert_allclose(n(got_c), np.asarray(ref_c), atol=2e-5)

    got = TX.constraint_deltas(got_p, t(sel), t(anchors), t(corr))
    ref = JX.constraint_deltas(ref_p, jnp.asarray(sel), jnp.asarray(anchors),
                               jnp.asarray(corr))
    for a, b, name in zip(got, ref, ("dpar", "dperp", "dth", "pen", "valid")):
        if name == "valid":
            np.testing.assert_array_equal(n(a), np.asarray(b))
        else:
            np.testing.assert_allclose(n(a), np.asarray(b), atol=5e-5,
                                       err_msg=name)


def _random_setup(rng, num=40):
    poses = rng.normal(size=(num, 3)).astype(np.float32)
    poses[:, :2] *= 3.0
    covs = np.zeros((num, 3, 3), np.float32)
    for i in range(num):
        a = rng.uniform(0.5, 2.0, 3)
        covs[i] = np.diag([a[0] * 1e-3, a[1] * 1e-3, a[2] * 1e-4])
        covs[i, 0, 2] = covs[i, 2, 0] = 1e-5
    return poses, covs


@pytest.mark.parametrize("window", [(8, 30), (0, 39), (5, 5), (20, 3)])
def test_backprop_matches(window, rng):
    """Against JAX backprop and (for a real window) the nested-loop
    transcription of the reference in tests/test_backprop.py."""
    from test_backprop import _naive_backprop

    from hitl_slam_torch.models.hitl.backprop import backprop
    from hitl_slam_tpu.models.hitl.backprop import backprop as jbackprop

    poses, covs = _random_setup(rng)
    corr = np.array([0.4, -0.3, 0.12], np.float32)
    lo, hi = window
    gp, gc = backprop(t(poses), t(covs), t(corr), torch.tensor(lo, dtype=torch.int32),
                      torch.tensor(hi, dtype=torch.int32))
    rp, rc = jbackprop(jnp.asarray(poses), jnp.asarray(covs), jnp.asarray(corr),
                       jnp.asarray(lo, jnp.int32), jnp.asarray(hi, jnp.int32))
    # prefix sums of ~40 f32 terms of size ~10: a few ulps of 10 (1e-5)
    np.testing.assert_allclose(n(gp), np.asarray(rp), atol=2e-5)
    np.testing.assert_allclose(n(gc), np.asarray(rc), rtol=1e-6, atol=1e-9)
    if lo < hi:
        ep, ec = _naive_backprop(poses, covs, corr, lo, hi)
        np.testing.assert_allclose(n(gp), ep, atol=2e-4)
        np.testing.assert_allclose(n(gc), ec, atol=1e-6)
    else:
        np.testing.assert_array_equal(n(gp), poses)


@pytest.mark.parametrize("offset", [10, 60])
def test_scatter_constraints_matches(offset):
    """Rows land at offset + rank; past the capacity they fall into the
    dump slot cap-1, which stays inactive. Rows [0, cap-1) and the whole
    `active` array match; the dump slot's payload is order-dependent."""
    from hitl_slam_torch.core.state import table_from_numpy
    from hitl_slam_torch.models.hitl.repair import _scatter_constraints
    from hitl_slam_tpu.core.state import ConstraintTable
    from hitl_slam_tpu.models.hitl.repair import _scatter_constraints as jsc

    rng = np.random.default_rng(offset)
    cap = 64
    tab = {
        "ctype": rng.integers(1, 7, cap).astype(np.int32),
        "constrained": rng.integers(0, 50, cap).astype(np.int32),
        "anchor": rng.integers(0, 50, cap).astype(np.int32),
        "delta_parallel": rng.normal(size=cap).astype(np.float32),
        "delta_perpendicular": rng.normal(size=cap).astype(np.float32),
        "delta_angle": rng.normal(size=cap).astype(np.float32),
        "penalty_dir": rng.normal(size=cap).astype(np.float32),
        "active": np.arange(cap) < offset,
    }
    MA, MC = 4, 5
    anchors = np.array([1, 2, 3, -1], np.int32)
    corr = np.array([40, 41, 42, 43, -1], np.int32)
    valid = (anchors[:, None] >= 0) & (corr[None, :] >= 0)
    valid[1, 2] = False
    d = [rng.normal(size=(MA, MC)).astype(np.float32) for _ in range(4)]
    got, gn = _scatter_constraints(table_from_numpy(tab, "cpu"), 4, t(anchors),
                                   t(corr), *[t(x) for x in d], t(valid),
                                   offset)
    ref, rn = jsc(ConstraintTable(**{k: jnp.asarray(v) for k, v in tab.items()}),
                  jnp.asarray(4), jnp.asarray(anchors), jnp.asarray(corr),
                  *[jnp.asarray(x) for x in d], jnp.asarray(valid),
                  jnp.asarray(offset, jnp.int32))
    assert int(gn) == int(rn) == int(valid.sum())
    refd = np_fields(ref)
    for k in tab:
        g = n(getattr(got, k))
        if k == "active":
            np.testing.assert_array_equal(g, refd[k])
            assert not g[cap - 1]
        else:
            np.testing.assert_array_equal(g[:cap - 1], refd[k][:cap - 1],
                                          err_msg=k)


# ------------------------------------------------------------ the cycle

@pytest.fixture(scope="module")
def tiny():
    import __graft_entry__ as G

    return tuple(np_fields(a) if hasattr(a, "__dataclass_fields__")
                 else np.asarray(a) for a in G._tiny_cycle_inputs())


def _port_inputs(tiny):
    from hitl_slam_torch.core.state import table_from_numpy

    points, mask, poses, covs, table, ctype, sel, off = tiny
    return (t(points), t(mask), t(poses), t(covs),
            table_from_numpy(table, "cpu"), int(ctype), t(sel), int(off))


def _jax_inputs(tiny):
    from hitl_slam_tpu.core.state import ConstraintTable

    points, mask, poses, covs, table, ctype, sel, off = tiny
    return (jnp.asarray(points), jnp.asarray(mask), jnp.asarray(poses),
            jnp.asarray(covs),
            ConstraintTable(**{k: jnp.asarray(v) for k, v in table.items()}),
            jnp.asarray(ctype, jnp.int32), jnp.asarray(sel),
            jnp.asarray(off, jnp.int32))


def _check_table(got, ref):
    cap = len(ref["active"])
    for k, v in ref.items():
        g = n(getattr(got, k))
        if k == "active":
            np.testing.assert_array_equal(g, v)
        elif v.dtype.kind == "f":
            # deltas of post-explicit metre-scale poses: ~1 ulp trig
            np.testing.assert_allclose(g[:cap - 1], v[:cap - 1], atol=5e-5,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(g[:cap - 1], v[:cap - 1], err_msg=k)


def test_cycle_step_matches(tiny):
    """Every CycleOutput field of the port's cycle_step against the JAX
    cycle_step on __graft_entry__'s tiny inputs, LMConfig(max_iterations=20).
    Ints and bools are exact; floats to f32 round-off carried through the
    EM refit and the LM solve (1e-4 m / rad on poses)."""
    from hitl_slam_torch.models.hitl.cycle import cycle_step
    from hitl_slam_torch.solver.lm import LMConfig as TCfg
    from hitl_slam_tpu.models.hitl.cycle import cycle_step as jcycle
    from hitl_slam_tpu.solver.lm import LMConfig as JCfg

    got = cycle_step(*_port_inputs(tiny), lm_config=TCfg(max_iterations=20))
    ref = np_fields(jcycle(*_jax_inputs(tiny), lm_config=JCfg(max_iterations=20)))
    for k in ("verified", "order_valid", "num_new_constraints",
              "lm_iterations"):
        assert n(getattr(got, k)).item() == ref[k].item(), k
        assert n(getattr(got, k)).dtype == ref[k].dtype, k
    assert bool(ref["verified"]) and bool(ref["order_valid"])
    for k in ("poses", "pre_solve_poses", "refit_sel"):
        np.testing.assert_allclose(n(getattr(got, k)), ref[k], atol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(n(got.covariances), ref["covariances"],
                               rtol=1e-5, atol=1e-9)
    for k in ("lm_initial_cost", "lm_final_cost"):
        np.testing.assert_allclose(n(getattr(got, k)), ref[k], rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    # exit damping: the product of per-step factors that depend on the
    # gain ratio, which is noise-dominated at convergence -> order only
    assert 0.1 < float(got.lm_final_mu) / float(ref["lm_final_mu"]) < 10
    _check_table(got.constraints, ref["constraints"])


@pytest.mark.parametrize("warm", [False, True])
def test_queue_chain_matches(tiny, warm):
    """A 3-cycle chain: the entry correction, a rejected no-op (all-zero
    selection), then a second correction drawn on the corrected map, with
    and without the damping carry. Per-cycle arrays and the carried state
    match the JAX queue_chain."""
    import dataclasses

    from hitl_slam_torch.models.hitl.cycle import cycle_step, queue_chain
    from hitl_slam_torch.solver.lm import LMConfig as TCfg
    from hitl_slam_tpu.io.figure8 import generate_figure8, synthesize_correction
    from hitl_slam_tpu.models.hitl.cycle import queue_chain as jchain
    from hitl_slam_tpu.solver.lm import LMConfig as JCfg

    points, mask, poses, covs, table, ctype, sel, off = _port_inputs(tiny)
    # the map of _tiny_cycle_inputs, moved by the first correction; the
    # second stroke pair is synthesized on it so that it verifies
    m = generate_figure8(num_poses=64, num_rays=64, seed=5,
                         drift_theta_bias=8e-4)
    first = cycle_step(points, mask, poses, covs, table, ctype, sel, off,
                       lm_config=TCfg(max_iterations=20))
    m2 = dataclasses.replace(m, poses=n(first.poses))
    sel2 = t(synthesize_correction(m2, range(64 - 64 // 3, 64),
                                   range(0, 64 // 3), (0, 0.0), (0, 0.0),
                                   min_points=5))
    sels = torch.stack([sel, torch.zeros_like(sel), sel2])
    ctypes = [ctype, ctype, ctype]
    gp, gc, gt, gn, gper = queue_chain(points, mask, poses, covs, table,
                                       ctypes, sels, off,
                                       lm_config=TCfg(max_iterations=20),
                                       warm_start_mu=warm)
    jp, jc, jt, jn_, jper = jchain(*_jax_inputs(tiny)[:5],
                                   jnp.asarray(ctypes, jnp.int32),
                                   jnp.asarray(n(sels)), jnp.asarray(off, jnp.int32),
                                   lm_config=JCfg(max_iterations=20),
                                   warm_start_mu=warm)
    names = ("accepted", "verified", "order_valid", "n_new", "lm_iterations",
             "lm_initial_cost", "lm_final_cost")
    for name, a, b in zip(names, gper, jper):
        b = np.asarray(b)
        if warm and name == "lm_iterations":
            # the carried damping is cycle 1's exit mu, set by gain ratios at
            # the f32 noise floor, so it differs between the packages
            # (test_cycle_step_matches bounds it to 10x); seeded differently,
            # the third solve may take another number of steps to the same
            # optimum. Its cost is compared below; the carry itself is
            # checked against a cycle_step seeded with the port's own mu.
            np.testing.assert_array_equal(n(a)[:2], b[:2], err_msg=name)
            again = cycle_step(points, mask, first.poses, first.covariances,
                               first.constraints, ctype, sel2,
                               int(first.num_new_constraints),
                               lm_config=TCfg(max_iterations=20),
                               mu0=first.lm_final_mu)
            assert int(again.lm_iterations) == int(a[2])
            assert float(again.lm_final_cost) == float(gper[6][2])
            continue
        if name.endswith("cost"):
            # cycle 3 starts from poses that already differ by the f32
            # noise floor of cycle 1's LM exit (<= 1e-4); its ~500 human
            # rows with residuals ~1e-2 move its cost by ~500*1e-2*1e-4
            np.testing.assert_allclose(n(a), b, rtol=1e-4, atol=2e-3,
                                       err_msg=name)
            np.testing.assert_allclose(n(a)[0], b[0], rtol=1e-4, atol=1e-7,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(n(a), b, err_msg=name)
    assert n(gper[0]).tolist() == [True, False, True]
    assert int(gn) == int(jn_)
    np.testing.assert_allclose(n(gp), np.asarray(jp), atol=1e-4)
    np.testing.assert_allclose(n(gc), np.asarray(jc), rtol=1e-5, atol=1e-9)
    _check_table(gt, np_fields(jt))


# ------------------------------------------------------------ repair_step

def _repair_args(sel_ordered):
    """repair_step's ordering inputs from an OrderedSelection: the first
    contiguous run of corrected poses and its last pose, the index lists
    padded with -1 to 64."""
    corr, anch = sel_ordered.corrected_poses, sel_ordered.anchor_poses
    breaks = np.nonzero(np.diff(corr) > 1)[0]
    group = corr[:breaks[0] + 1] if len(breaks) else corr

    def pad(ix):
        out = np.full(64, -1, np.int32)
        out[:min(len(ix), 64)] = ix[:64]
        return out

    return group, int(group[-1]), pad(anch), pad(corr)


def test_repair_step_matches_jax():
    """repair_step on the small golden map's first logged correction: the
    refit by endpoint_adjust_batch, counts by observation_counts, ordering
    by order_and_filter, then the step with LMConfig(max_iterations=6) on
    both packages. Ints exact; poses to f32 round-off (1e-4 m / rad)."""
    import os

    from hitl_slam_torch.core.state import make_map_state as tmake
    from hitl_slam_torch.io import logs, stfs
    from hitl_slam_torch.models.hitl import em_input as TE
    from hitl_slam_torch.models.hitl.repair import repair_step
    from hitl_slam_torch.solver.lm import LMConfig as TCfg
    from hitl_slam_tpu.core.state import ConstraintTable, make_map_state
    from hitl_slam_tpu.models.hitl import em_input as JE
    from hitl_slam_tpu.models.hitl.repair import repair_step as jrepair
    from hitl_slam_tpu.solver.lm import LMConfig as JCfg

    data_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
    data = stfs.load_stfs_covars(os.path.join(data_dir, "golden.stfs.covars"))
    entry = logs.load_log(os.path.join(data_dir, "golden.log"))[0]
    jst = make_map_state(data.poses, data.covariances, data.point_clouds,
                         data.normal_clouds, constraint_capacity=256)
    tst = tmake(data.poses, data.covariances, data.point_clouds,
                data.normal_clouds, constraint_capacity=256, device="cpu")
    world = np.asarray(jst.world_points())
    mask = np.asarray(jst.point_mask)
    raw = np.asarray(entry.points, np.float32)
    segs = JE.endpoint_adjust_batch(jnp.asarray(world), jnp.asarray(mask),
                                    jnp.asarray(np.stack([raw[0:2],
                                                          raw[2:4]])))
    refit = np.asarray(segs).reshape(4, 2)
    c1, c2 = (np.asarray(c) for c in JE.observation_counts(
        jnp.asarray(world), jnp.asarray(mask), jnp.asarray(refit)))
    o = TE.order_and_filter(c1, c2, refit)
    assert o.valid
    group, last, anch, corr = _repair_args(o)
    P = len(data.poses)
    gmask = np.zeros(P, bool)
    gmask[group] = True
    ctype = int(entry.correction_type)
    args = (o.selected_points.astype(np.float32), gmask, last, anch, corr,
            o.backprop_start, o.backprop_end, 0)
    got = repair_step(tst.poses, tst.covariances, tst.constraints, ctype,
                      t(args[0]), t(gmask), last, t(anch), t(corr),
                      args[5], args[6], 0, lm_config=TCfg(max_iterations=6))
    ref = jrepair(jst.poses, jst.covariances, jst.constraints,
                  jnp.asarray(ctype, jnp.int32), jnp.asarray(args[0]),
                  jnp.asarray(gmask), jnp.asarray(last, jnp.int32),
                  jnp.asarray(anch), jnp.asarray(corr),
                  jnp.asarray(args[5], jnp.int32),
                  jnp.asarray(args[6], jnp.int32), jnp.asarray(0, jnp.int32),
                  lm_config=JCfg(max_iterations=6))
    assert int(got.num_new_constraints) == int(ref.num_new_constraints) > 0
    assert int(got.lm.iterations) == int(ref.lm.iterations)
    np.testing.assert_allclose(n(got.correction), np.asarray(ref.correction),
                               atol=1e-5)
    for k in ("pre_solve_poses", "poses"):
        np.testing.assert_allclose(n(getattr(got, k)),
                                   np.asarray(getattr(ref, k)), atol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(n(got.covariances), np.asarray(ref.covariances),
                               rtol=1e-5, atol=1e-9)
    # the optimum's cost is ~1e-9: an absolute floor, as in
    # test_cycle_step_matches
    np.testing.assert_allclose(float(got.lm.final_cost),
                               float(ref.lm.final_cost), rtol=1e-4, atol=1e-7)
    _check_table(got.constraints, np_fields(ref.constraints))
    assert isinstance(ref.constraints, ConstraintTable)
