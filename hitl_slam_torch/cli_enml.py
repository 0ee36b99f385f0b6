"""EnML command line on PyTorch (CUDA by default): raw scan stream ->
episodes -> batch localize -> .stfs.covars / .poses / .stfs, with the
statistical-test hooks (--noise fault injection over seeded trials, -t
test-set lines).

Port of hitl_slam_tpu/cli_enml.py. Input is a ROS1 .bag
(sensor_msgs/LaserScan + odometry) or an .npz stream with arrays
{scans [T, R], angles [R], rel_odometry [T, 3]}; --synthetic generates a
figure-8 stream instead. Modes:

  (default)           the sequential sliding-window sweep
  --parallel-windows  the checkerboard solver: windows of one parity solved
                      as one batched Gauss-Newton problem
  --online            the producer/consumer live localizer (a worker thread)
  --gui               live progress frames and loop-closure corrections over
                      the websocket bridge (with --online: the live scan
                      view and GUI-initiated set_location seeds)
  --replay LOG        localize, then replay a logged correction session
                      headlessly and save the corrected map

Run as

    python -m hitl_slam_torch.cli_enml -b session.bag -o out
    python -m hitl_slam_torch.cli_enml -b session.bag -o out --parallel-windows
    python -m hitl_slam_torch.cli_enml --synthetic --steps 96 -o out --device cpu
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
    p.add_argument("--parallel-windows", action="store_true",
                   help="checkerboard-parallel window solver (batched "
                        "red/black windows instead of the sequential sweep)")
    p.add_argument("--online", action="store_true",
                   help="producer/consumer live mode: stream messages "
                        "through the background localizer thread instead of "
                        "batch solving; writes <output>.poses + <output>.stfs")
    p.add_argument("--rate", type=float, default=0.0, metavar="X",
                   help="with --online: pace the stream at X times "
                        "realtime (0 = as fast as possible)")
    p.add_argument("--gui", action="store_true",
                   help="interactive mode: publish live progress frames "
                        "(poses, covariance ellipses, STF correspondences) "
                        "to the websocket viewer during batch localization "
                        "and accept loop-closure corrections")
    p.add_argument("--gui-port", type=int, default=8765)
    p.add_argument("--maps-folder", default=None, metavar="DIR",
                   help="folder holding <name>.vectors.txt background maps "
                        "+ atlas.txt ('<index> <name>' rows) for map "
                        "switching in the live view")
    p.add_argument("--background-map", default=None, metavar="NAME_OR_PATH",
                   help="initial background vector map for the live view "
                        "(a name in --maps-folder, or a direct "
                        "VectorMapFile path)")
    p.add_argument("--hold", action="store_true",
                   help="with --online --gui: keep the websocket bridge up "
                        "after the stream completes until a shutdown "
                        "message or Ctrl-C")
    p.add_argument("--segment", type=int, default=32,
                   help="with --gui or --replay: nodes swept between "
                        "progress frames / correction splice points")
    p.add_argument("--replay", default=None, metavar="LOG",
                   help="after batch localization, replay a logged "
                        "correction session headlessly and save the "
                        "corrected map")
    p.add_argument("--log-corrections", default=None, metavar="FILE",
                   help="write applied loop-closure corrections to FILE "
                        "(default with --gui: <output>.correction.log)")
    p.add_argument("--correction-scale", type=float, default=1.0,
                   help="stddev scale factor of the covariance-weighted "
                        "chain of loop-closure corrections")
    p.add_argument("--device", default="cuda",
                   help="torch device, e.g. cuda, cuda:1 or cpu")
    return p


def _publish_frame(server, sess, t_done):
    """One live progress frame: trajectory + world points + covariance
    ellipses + STF correspondence lines of the newest window."""
    from .gui.display import display_covariances, display_poses
    from .gui.drawlist import CORRESPONDENCE_COLOR

    st = sess.state.replace(poses=sess._tensor(sess.poses))
    dl = display_poses(st)
    display_covariances(dl, sess.poses[:t_done], sess.covariances[:t_done],
                        stride=4)
    if t_done > 1:
        src, tgt = sess.correspondences(t=min(t_done - 1,
                                              sess.state.num_poses - 1))
        dl.draw_lines(src, tgt, CORRESPONDENCE_COLOR)
    dl.progress = float(t_done) / max(st.num_poses, 1)
    server.publish(dl)


def _run_gui_session(args, sess) -> int:
    """Interactive EnML: live progress + loop-closure corrections over the
    websocket bridge. Protocol:

      - a click with modifiers == 0x06 toggles loop-corrections mode (the
        original tool's use of the PARALLEL bitmask, so PARALLEL
        corrections cannot be made in this tool);
      - in loop-corrections mode, two modifier-drags select the correction
        (bitmask = correction type, as in the HitL tool); the completed
        pair applies at once, or, mid-localization, at the next segment
        boundary;
      - keys: 'v' save outputs, 'l' replay the next logged entry, 'q' or a
        shutdown message ends the session.
    """
    import threading

    from .core.state import CorrectionType
    from .gui.server import GuiServer
    from .io.stfs import save_results_poses

    server = GuiServer(port=args.gui_port)
    done = threading.Event()
    localizing = {"on": True}
    # orders a completed selection against the end of the sweep: it is
    # queued while the sweep runs and applied at once after it, and one
    # queued after the sweep's last splice point is applied when it ends
    mode_lock = threading.Lock()
    pending: dict = {"type": None, "points": []}

    def dispatch(ctype, pts):
        sel = np.stack(pts)
        with mode_lock:
            if localizing["on"]:
                sess.queue_correction(ctype, sel)
                print(f"loop correction queued ({ctype.name}) — applies at "
                      "next segment boundary")
                return
        rep = sess.add_loop_correction(ctype, sel)
        print(f"loop correction ({ctype.name}): accepted={rep.accepted} "
              f"{rep.reason}")
        _publish_frame(server, sess, sess.localized_upto)

    def on_click(ev):
        if ev.modifiers == 0x06:
            sess.loop_corrections_on = not sess.loop_corrections_on
            print(f"Loop corrections: {int(sess.loop_corrections_on)}")
            return
        if not sess.loop_corrections_on:
            return
        try:
            ctype = CorrectionType(ev.modifiers)
        except ValueError:
            return
        down = np.asarray(ev.mouse_down, np.float32)
        up = np.asarray(ev.mouse_up, np.float32)
        if pending["type"] != ctype:
            pending["type"] = ctype
            pending["points"] = [down, up]
        else:
            pts = pending["points"] + [down, up]
            pending["type"] = None
            pending["points"] = []
            dispatch(ctype, pts)

    def save_outputs():
        from .io import stfs

        stfs.save_stfs_covars(
            args.output + ".stfs.covars", args.map_name, 0.0, sess.poses,
            sess.covariances, _clouds(sess), _normals(sess))
        save_results_poses(args.output + ".poses", sess.poses)
        print(f"saved {len(sess.poses)} poses to {args.output}.poses")

    def on_key(ev):
        if ev.keycode == 0x56:      # 'v'
            save_outputs()
        elif ev.keycode == 0x4C:    # 'l': step the replay log
            rep = sess.replay_next()
            if rep is None:
                print("No more inputs to replay!")
            else:
                print(f"replay: accepted={rep.accepted} {rep.reason}")
                _publish_frame(server, sess, sess.localized_upto)
        elif ev.keycode == 0x51:    # 'q'
            done.set()

    server.on_mouse_click = on_click
    server.on_keyboard = on_key
    server.on_shutdown = done.set
    server.start()
    print(f"EnML GUI bridge listening on ws://127.0.0.1:{args.gui_port} "
          "(0x06-click toggles loop corrections; v=save l=replay-step "
          "q=quit)")
    if args.replay:
        n = sess.load_log(args.replay)
        print(f"loaded {n} logged corrections from {args.replay}")

    t0 = time.perf_counter()
    sess.localize(segment=args.segment,
                  progress_cb=lambda s, t: _publish_frame(server, s, t))
    with mode_lock:
        localizing["on"] = False
    # selections completed after the last segment boundary's splice
    sess._apply_pending()
    dt = time.perf_counter() - t0
    print(f"gui: {sess.state.num_poses} episode nodes localized in "
          f"{dt:.2f}s; interactive (corrections live)")
    _publish_frame(server, sess, sess.localized_upto)
    try:
        done.wait()
    except KeyboardInterrupt:
        pass
    save_outputs()
    log_path = args.log_corrections or (args.output + ".correction.log")
    if sess.input_history:
        sess.save_log(log_path)
        print(f"logged {len(sess.input_history)} corrections to {log_path}")
    server.stop()
    return 0


def _clouds(sess):
    st = sess.state
    mask = st.point_mask.cpu().numpy()
    pts = st.points.cpu().numpy()
    return [pts[i][mask[i]] for i in range(st.num_poses)]


def _normals(sess):
    st = sess.state
    mask = st.point_mask.cpu().numpy()
    nrm = st.normals.cpu().numpy()
    return [nrm[i][mask[i]] for i in range(st.num_poses)]


def _run_online(args, scans, angles, rel, opts, ep_opts, device) -> int:
    """Replay the stream through the OnlineLocalizer's producer/consumer
    protocol and save the live trajectory. With --gui, also serve the live
    view (the current scan at the live pose plus the background vector map)
    and accept GUI-initiated localization seeds."""
    import threading

    from .io.stfs import save_results_poses, save_stfs
    from .models.enml.online import OnlineLocalizer

    ol = OnlineLocalizer(episode_options=ep_opts, enml_options=opts,
                         device=device)

    server = live = None
    t_pub = [0.0]
    if args.gui:
        from .gui.drawlist import TRAJECTORY_COLOR, DrawList
        from .gui.live import LiveView
        from .gui.server import GuiServer

        live = LiveView(maps_folder=args.maps_folder,
                        map_name=args.background_map)
        server = GuiServer(port=args.gui_port)

        def publish(now=None, min_interval=0.0):
            now = time.monotonic() if now is None else now
            if now - t_pub[0] < min_interval:
                return   # frame-rate throttle
            t_pub[0] = now
            dl = DrawList()
            pose = ol.pose()
            live.compile(dl, pose, now)
            traj = ol.trajectory()
            if len(traj):
                dl.draw_points(traj[:, :2], TRAJECTORY_COLOR)
            dl.robot_pose = tuple(float(v) for v in pose)
            server.publish(dl)

        def on_set_location(ev):
            # programmatic initial pose; an optional "map" field drives
            # the background map's auto switch
            p = [float(v) for v in ev.get("pose", (0.0, 0.0, 0.0))][:3]
            ol.set_location(*p)
            print(f"set_location from GUI: ({p[0]:.3f}, {p[1]:.3f}, "
                  f"{p[2]:.3f})")
            live.maybe_auto_switch(ev.get("map"))
            publish()

        def on_click(ev):
            # Set Position drag (modifiers 0x04): position = mouse_down,
            # orientation = drag direction -> seed the online localizer
            if ev.modifiers == 0x04:
                d = (ev.mouse_up[0] - ev.mouse_down[0],
                     ev.mouse_up[1] - ev.mouse_down[1])
                theta = float(np.arctan2(d[1], d[0])) if (
                    abs(d[0]) + abs(d[1]) > 1e-9) else 0.0
                ol.set_location(float(ev.mouse_down[0]),
                                float(ev.mouse_down[1]), theta)
                print(f"set_location from GUI click: "
                      f"({ev.mouse_down[0]:.3f}, {ev.mouse_down[1]:.3f}, "
                      f"{theta:.3f})")
                publish()

        def on_change_map(ev):
            name = str(ev.get("name", ""))
            ok = live.change_map(name)
            print(f"change map to {name}: {'ok' if ok else 'not found'} "
                  f"(atlas: {', '.join(live.atlas()) or 'none'})")
            publish()

        def on_key(ev):
            if ev.keycode == 0x55:      # 'U': auto-update-map toggle
                live.auto_update_map = not live.auto_update_map
                print(f"AutoUpdateMap: {int(live.auto_update_map)}")
            elif ev.keycode == 0x43:    # 'C': clear live scans
                live.clear()
                publish()

        server.on_set_location = on_set_location
        server.on_mouse_click = on_click
        server.on_change_map = on_change_map
        server.on_keyboard = on_key
        # worker-driven repaint: the localizer thread publishes a frame the
        # moment a node is added or a set_location seed is applied
        ol.on_update = publish
        # latch shutdown requests from the moment the bridge is up: a
        # client may send one before the --hold wait begins
        shutdown_ev = threading.Event()
        server.on_shutdown = shutdown_ev.set
        server.start()
        print(f"EnML online live view on ws://127.0.0.1:{args.gui_port}")

    angle_min = float(angles[0])
    angle_inc = float(angles[1] - angles[0]) if len(angles) > 1 else 0.0
    ol.start()
    t0 = time.perf_counter()
    period = args.scan_period / args.rate if args.rate > 0 else 0.0
    flushed = False
    lag = 0.0
    try:
        for i in range(len(scans)):
            if i == 0:
                # driver convention: rel[0] is the absolute start pose
                if np.any(np.asarray(rel[0])):
                    ol.set_location(*[float(v) for v in rel[0]])
            else:
                ol.odometry_update(*[float(v) for v in rel[i]])
            ol.sensor_update(np.asarray(scans[i]), np.asarray(angles))
            if live is not None:
                now = time.monotonic()
                on_scan = (live.on_kinect if args.use_kinect
                           else live.on_laser)
                on_scan(scans[i], angle_min, angle_inc,
                        ep_opts.min_point_cloud_range,
                        ep_opts.max_point_cloud_range, now)
                publish(now, min_interval=1.0 / 30.0)
            if period:
                time.sleep(period)
        # the completion barrier: every message sent has been processed,
        # the final window solve included
        t_sent = time.perf_counter()
        flushed = ol.flush(timeout=1800.0)
        lag = time.perf_counter() - t_sent
        poses_list, clouds, _normals = ol.snapshot()
        if server is not None:
            publish()   # final frame with the completed trajectory
    finally:
        ol.stop()
        if server is not None and not args.hold:
            server.stop()
    dt = time.perf_counter() - t0
    if not flushed:
        print("online: localizer did not finish within 30 min; "
              "aborting without writing outputs", file=sys.stderr)
        return 1
    n = len(poses_list)
    if n == 0:
        print("online: no episode nodes created (stream too short or "
              "all scans empty)", file=sys.stderr)
        return 1
    poses = np.stack(poses_list)
    save_results_poses(args.output + ".poses", poses)
    save_stfs(args.output + ".stfs", args.map_name, time.time(),
              poses, clouds)
    rtf = (len(scans) * args.scan_period) / max(dt, 1e-9)
    x, y, th = poses[-1]
    print(f"online: {n} episode nodes localized live in {dt:.2f}s "
          f"({rtf:.1f}x realtime at {1 / args.scan_period:.0f} Hz scans; "
          f"lag at flush {lag:.3f}s); final pose ({x:.3f}, {y:.3f}, "
          f"{th:.3f}); wrote {args.output}.poses and {args.output}.stfs")
    if server is not None and args.hold:
        print('holding live view open; send {"type": "shutdown"} '
              "or Ctrl-C to exit")
        try:
            shutdown_ev.wait()
        except KeyboardInterrupt:
            pass
        server.stop()
    return 0


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

    def test_set_append(result_poses):
        # appends, so a --statistical-test batch accumulates one line per
        # trial
        if args.test_set >= 0:
            import os

            from .io.stfs import append_test_set_poses

            fp = append_test_set_poses(args.test_set, result_poses,
                                       os.path.dirname(args.output) or ".")
            print(f"test-set {args.test_set}: appended result poses to {fp}")

    def run_once(rel_odom, tag=""):
        t0 = time.perf_counter()
        poses, pcs, ncs, rels = build_episodes(
            scans, angles, rel_odom, ep_opts)
        new_poses, covs = localize_and_save(
            poses, pcs, ncs, args.output + tag, map_name=args.map_name,
            options=opts, parallel_windows=args.parallel_windows,
            ltf_segs=ltf_segs, device=device)
        test_set_append(new_poses)
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

    if args.replay and args.online:
        raise SystemExit("ERROR: --replay is incompatible with --online")
    if (args.gui or args.replay) and not args.online:
        if args.statistical_test > 0 or args.parallel_windows:
            raise SystemExit("ERROR: --gui/--replay are incompatible with "
                             "--statistical-test/--parallel-windows")
        from .models.enml.session import EnmlSession

        if args.noise > 0:
            rel = noisy(rel, np.random.default_rng(args.seed))
        poses, pcs, ncs, _rels = build_episodes(scans, angles, rel, ep_opts)
        sess = EnmlSession(poses, pcs, ncs, options=opts,
                           correction_scale=args.correction_scale,
                           ltf_segs=ltf_segs, device=device)
        if args.gui:
            return _run_gui_session(args, sess)
        # headless replay: localize, re-apply the logged corrections, save
        n = sess.load_log(args.replay)
        print(f"loaded {n} logged corrections from {args.replay}")
        t0 = time.perf_counter()
        sess.localize(segment=args.segment)
        reps = sess.replay_all()
        dt = time.perf_counter() - t0
        n_ok = sum(r.accepted for r in reps)
        from .io import stfs as _stfs

        _stfs.save_stfs_covars(
            args.output + ".stfs.covars", args.map_name, 0.0, sess.poses,
            sess.covariances, _clouds(sess), _normals(sess))
        _stfs.save_results_poses(args.output + ".poses", sess.poses)
        test_set_append(sess.poses)
        before = consistency_metric(poses, pcs)
        after = consistency_metric(sess.poses, pcs)
        print(f"replay: {len(poses)} nodes localized + {n_ok}/{len(reps)} "
              f"corrections applied in {dt:.2f}s; consistency "
              f"{before:.4f} -> {after:.4f}; wrote "
              f"{args.output}.stfs.covars")
        return 0

    if args.online:
        if args.statistical_test > 0 or args.parallel_windows:
            raise SystemExit("ERROR: --online is incompatible with "
                             "--statistical-test/--parallel-windows")
        if args.noise > 0:
            rel = noisy(rel, np.random.default_rng(args.seed))
        return _run_online(args, scans, angles, rel, opts, ep_opts, device)

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
