"""EnML batch-localization command line on PyTorch (CUDA by default): raw
scan stream -> episodes -> batch localize -> .stfs.covars / .poses / .stfs,
with the statistical-test hooks (--noise fault injection over seeded
trials, -t test-set lines).

Port of the batch path of hitl_slam_tpu/cli_enml.py. Input is a ROS1 .bag
(sensor_msgs/LaserScan + odometry) or an .npz stream with arrays
{scans [T, R], angles [R], rel_odometry [T, 3]}; --synthetic generates a
figure-8 stream instead. Run as

    python -m hitl_slam_torch.cli_enml -b session.bag -o out
    python -m hitl_slam_torch.cli_enml --synthetic --steps 96 -o out --device cpu

The online, GUI, replay and checkerboard (--parallel-windows) modes are not
in the port yet.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(prog="enml-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-b", "--bag", default=None,
                   help="ROS1 .bag (sensor_msgs/LaserScan + odometry) or "
                        ".npz scan stream")
    p.add_argument("--max-laser-poses", type=int, default=None,
                   help="stop after this many laser messages (bag input)")
    p.add_argument("--time-skip", type=float, default=0.0,
                   help="seconds of bag to skip from the start")
    p.add_argument("--use-kinect", action="store_true",
                   help="subscribe /Cobot/Kinect/Scan instead of the lidar "
                        "topics (exactly one scanner is ever subscribed)")
    p.add_argument("--synthetic", action="store_true",
                   help="generate a synthetic figure-8 stream instead")
    p.add_argument("--steps", type=int, default=256)
    p.add_argument("-o", "--output", default="enml_out")
    p.add_argument("--map-name", default="EnML")
    p.add_argument("--noise", type=float, default=0.0,
                   help="encoder noise factor for fault injection")
    p.add_argument("--statistical-test", type=int, default=0, metavar="N",
                   help="run N noisy trials and save per-trial poses")
    p.add_argument("-t", "--test-set", type=int, default=-1, metavar="N",
                   help="tag this run as test-set index N: APPEND one line "
                        "of result poses (x,y,theta, ...) to "
                        "non_markov_test_N.txt next to the output; composes "
                        "with --statistical-test")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-history", type=int, default=10)
    p.add_argument("--config", action="append", default=None,
                   help="config file (repeatable, evaluated in order): "
                        "executable Lua .cfg files (domain/robot override "
                        "blocks honoured) or a TOML/JSON mirror; the "
                        "NonMarkovLocalization table uses the reference's "
                        "parameter names")
    p.add_argument("--domain", default=None,
                   help="force enml_domain for the Lua config's domain "
                        "override blocks (cobot / freiburg / orebro)")
    p.add_argument("--robot", default=None,
                   help="force RobotConfig.name for the Lua config's "
                        "per-robot override blocks (e.g. Cobot3)")
    p.add_argument("--gn-unroll", type=int, default=None, metavar="K",
                   help="the reference's GN-loop unroll cap, accepted for "
                        "config parity; no effect on the eager sweep")
    p.add_argument("--scan-period", type=float, default=0.05,
                   help="seconds between scans, for the realtime factor")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the run into DIR "
                        "(open with chrome://tracing or Perfetto)")
    p.add_argument("--ltvm-map", default=None, metavar="VECTORS",
                   help="LTVM-curated vector map (vectors.txt): localize "
                        "against it; observations the map explains become "
                        "long-term features with point-to-line factors in "
                        "every window")
    p.add_argument("--device", default="cuda",
                   help="torch device, e.g. cuda, cuda:1 or cpu")
    return p


def _load_stream(args):
    if args.synthetic or args.bag is None:
        from .io.figure8 import generate_raw_stream

        scans, angles, rel, gt, _ = generate_raw_stream(
            num_steps=args.steps, seed=args.seed)
        return list(scans), angles, rel
    if args.bag.endswith(".bag"):
        from .io.rosbag import KINECT_TOPIC, bag_to_stream

        try:
            scans, angles, rel, set_loc = bag_to_stream(
                args.bag, max_laser_msgs=args.max_laser_poses,
                time_skip=args.time_skip,
                laser_topics=(KINECT_TOPIC,) if args.use_kinect else None)
        except (ValueError, OSError) as e:
            raise SystemExit(f"ERROR: {e}")
        if set_loc:
            # apply each re-localization at its STREAM position: later
            # poses integrate from the given map-frame pose
            from .io.rosbag import apply_set_locations

            for k, loc in set_loc:
                print(f"set_location @scan {k}: x={loc[0]:.2f} "
                      f"y={loc[1]:.2f} angle={loc[2]:.3f}")
            rel = apply_set_locations(rel, set_loc)
        return list(scans), angles, rel
    try:
        data = np.load(args.bag)
        return list(data["scans"]), data["angles"], data["rel_odometry"]
    except Exception as e:
        raise SystemExit(
            f"ERROR: {args.bag!r} is neither a .bag file nor an .npz "
            f"stream archive with scans/angles/rel_odometry ({e})")


def _load_options(args, opts, ep_opts):
    """(EnmlOptions, EpisodeOptions) with the --config files applied."""
    import dataclasses

    from .models.enml.driver import options_from_table
    from .utils.config import is_lua_config, load_config

    overrides = {}
    if args.domain:
        overrides["enml_domain"] = args.domain
    if args.robot:
        overrides["RobotConfig.name"] = args.robot
    # ALL Lua files evaluate in ONE shared interpreter environment, in
    # listed order, merged at the first Lua file's position: robot.cfg's
    # RobotConfig drives non_markov_localization.cfg's per-robot blocks,
    # which per-file evaluation would lose
    try:
        lua_files = [p for p in args.config if is_lua_config(p)]
    except OSError as e:
        raise SystemExit(f"ERROR: cannot load config: {e}")
    lua_merged = False
    cfg: dict = {}
    for path in args.config:
        try:
            if is_lua_config(path):
                if lua_merged:
                    continue
                from .utils.luaconfig import load_lua_config

                part = load_lua_config(lua_files, overrides or None)
                lua_merged = True
            else:
                part = load_config(path)
        except (OSError, ValueError) as e:
            raise SystemExit(f"ERROR: cannot load config {path}: {e}")
        for k, v in part.items():
            if isinstance(v, dict) and isinstance(cfg.get(k), dict):
                cfg[k].update(v)
            else:
                cfg[k] = v
    table = cfg.get("NonMarkovLocalization", cfg)
    if not isinstance(table, dict) or not table:
        raise SystemExit("ERROR: config has no NonMarkovLocalization table")
    opts, ep_cfg = options_from_table(table)
    if args.gn_unroll is not None:
        opts = dataclasses.replace(opts, gn_unroll=args.gn_unroll)
    # keep the CLI's beam clipping (synthetic/test streams are full-FOV;
    # the reference's configs clip via num_skip_readings instead)
    ep_opts = dataclasses.replace(ep_cfg, clip_low=ep_opts.clip_low,
                                  clip_high=ep_opts.clip_high)
    print(f"config: domain={cfg.get('enml_domain')!r} "
          f"map={table.get('map_name')!r} "
          f"match_threshold={opts.point_match_threshold} "
          f"max_history={opts.max_history} "
          f"gn_iterations={opts.gn_iterations} "
          f"sensor_offset={tuple(ep_opts.sensor_offset)}")
    return opts, ep_opts


def main(argv=None) -> int:
    from .utils.timing import install_crash_guard

    install_crash_guard()
    args = build_parser().parse_args(argv)

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("ERROR: --device cuda but no CUDA device is available "
              "(pass --device cpu to run on the CPU)", file=sys.stderr)
        return 2
    if args.profile:
        from .utils.timing import device_trace

        with device_trace("enml-run", enabled=True, logdir=args.profile):
            rc = _main_impl(args, device)
        print(f"profiler trace written to {args.profile}")
        return rc
    return _main_impl(args, device)


def _main_impl(args, device) -> int:
    from .models.enml.driver import (
        EpisodeOptions,
        apply_noise_model,
        build_episodes,
        consistency_metric,
        localize_and_save,
    )
    from .models.enml.localizer import EnmlOptions

    scans, angles, rel = _load_stream(args)
    print(f"stream: {len(scans)} scans x {len(angles)} beams")
    ltf_segs = None
    if args.ltvm_map:
        from .gui.map_edit import VectorMapFile

        vm = VectorMapFile(args.ltvm_map)
        if not vm.segments:
            raise SystemExit(f"ERROR: no segments in {args.ltvm_map}")
        ltf_segs = np.asarray([s[:4] for s in vm.segments], np.float32)
        print(f"ltvm map: {len(ltf_segs)} segments from {args.ltvm_map}")
    opts = EnmlOptions(max_history=args.max_history,
                       gn_unroll=args.gn_unroll)
    ep_opts = EpisodeOptions(clip_low=10, clip_high=10)
    if args.config:
        opts, ep_opts = _load_options(args, opts, ep_opts)
    elif args.domain or args.robot:
        raise SystemExit("ERROR: --domain/--robot require --config")

    def noisy(rel_odom, rng):
        out = rel_odom.copy()
        for i in range(len(out)):
            out[i] = apply_noise_model(
                *[float(v) for v in rel_odom[i]], args.noise, rng)
        return out

    def run_once(rel_odom, tag=""):
        t0 = time.perf_counter()
        poses, pcs, ncs, rels = build_episodes(
            scans, angles, rel_odom, ep_opts)
        new_poses, covs = localize_and_save(
            poses, pcs, ncs, args.output + tag, map_name=args.map_name,
            options=opts, ltf_segs=ltf_segs, device=device)
        if args.test_set >= 0:
            # appends, so a --statistical-test batch accumulates one line
            # per trial
            import os

            from .io.stfs import append_test_set_poses

            fp = append_test_set_poses(args.test_set, new_poses,
                                       os.path.dirname(args.output) or ".")
            print(f"test-set {args.test_set}: appended result poses to {fp}")
        dt = time.perf_counter() - t0
        before = consistency_metric(poses, pcs)
        after = consistency_metric(new_poses, pcs)
        # bag duration over process duration
        rtf = (len(scans) * args.scan_period) / max(dt, 1e-9)
        print(f"{tag or 'run'}: {len(poses)} episode nodes localized in "
              f"{dt:.2f}s ({rtf:.1f}x realtime at {1 / args.scan_period:.0f} "
              f"Hz scans); consistency {before:.4f} -> {after:.4f}; "
              f"wrote {args.output + tag}.stfs.covars")
        return new_poses

    if args.statistical_test > 0:
        rng = np.random.default_rng(args.seed)
        for trial in range(args.statistical_test):
            run_once(noisy(rel, rng), tag=f".trial{trial}")
        return 0
    if args.noise > 0:
        rel = noisy(rel, np.random.default_rng(args.seed))
    run_once(rel)
    return 0


if __name__ == "__main__":
    sys.exit(main())
