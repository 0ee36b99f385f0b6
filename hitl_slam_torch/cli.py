"""HitL-SLAM command-line entry point on PyTorch (CUDA by default).

Port of hitl_slam_tpu/cli.py:
  -P / --pose-graph   .stfs.covars pose-graph file (.gz accepted; required
                      except in --test-mode)
  -L / --log          correction log to replay
  -V / --save         output name for repaired poses (default
                      hitl_results.txt, one `x y theta` row per pose)
  --replay-all        replay every log entry in turn, save results, exit
  --replay-fused      same, but the whole log runs as one device-carried
                      chain (engine.run_queue)
  --post-optimize     run the STF correspondence refinement after the
                      replay (or on the loaded map when no replay mode is
                      given)
  --refine-matcher    auto | global | pair: the refinement's correspondence
                      search
  --auto-repair N     headless auto-repair: up to N rounds of propose-and-
                      apply loop-closure corrections, no human input
  --render PATH       write a PNG render of the (repaired) map
  --info-mat PATH     write the factor-adjacency PNG after a replay mode
  --config FILE       TOML/JSON engine parameters; its [lm] table sets the
                      LM solver (config/hitl_slam.toml)
  --profile DIR       write a torch.profiler trace of the session into DIR
  --gui               serve the map over the websocket GUI bridge and take
                      corrections from viewers (--gui-port, default 8765)
  --map, --nav-map, --semantic-map
                      vector map / navigation graph / semantic graph files
                      to edit over the bridge
  --test-mode         stream synthetic draw-lists to viewers (no map)
  --device            torch device to run on (default cuda)

The keyboard protocol over the bridge: 'p' toggles correction mode (the
second press runs the correction), 'u' undo, 'v' save, 'l' replay the next
logged entry, 'a' propose / accept an automatic correction, 'c' covariance
ellipses, 'o' the post-human STF refine. Ctrl-C writes the session log.

Run as `python -m hitl_slam_torch.cli -P map.stfs.covars -L session.log
--replay-all -V repaired.txt`.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="hitl-slam-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-P", "--pose-graph", default=None,
                   help="required except in --test-mode")
    p.add_argument("-L", "--log", default=None)
    p.add_argument("-V", "--save", default="hitl_results.txt")
    p.add_argument("--replay-all", action="store_true")
    p.add_argument("--replay-fused", action="store_true",
                   help="replay the log as one device-carried chain "
                        "(engine.run_queue)")
    p.add_argument("--post-optimize", action="store_true",
                   help="run the STF correspondence refinement after the "
                        "replay (dense solve up to 2048 poses, matrix-free "
                        "PCG above)")
    p.add_argument("--refine-matcher", default="auto",
                   choices=("auto", "global", "pair"),
                   help="correspondence search for --post-optimize: "
                        "'global' 1-NN grid, 'pair' per-pose-pair dense "
                        "tiles (needed on heavily re-traversed maps), "
                        "'auto' falls back from global to pair when the "
                        "global matcher yields zero gated bundles")
    p.add_argument("--auto-repair", type=int, default=0, metavar="N",
                   help="headless auto-repair: up to N rounds of "
                        "propose-and-apply loop-closure corrections "
                        "(batched correlative matcher), no human input")
    p.add_argument("--render", default=None, metavar="PATH",
                   help="write a PNG render of the (repaired) map")
    p.add_argument("--info-mat", default=None, metavar="PATH",
                   help="write the factor-adjacency PNG after a replay mode")
    p.add_argument("--config", default=None,
                   help="TOML/JSON engine parameters (config/hitl_slam.toml); "
                        "its [lm] table sets the LM solver")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the whole session "
                        "into DIR (open with chrome://tracing or Perfetto)")
    p.add_argument("--gui", action="store_true",
                   help="start the websocket GUI bridge and serve draw-lists")
    p.add_argument("--gui-port", type=int, default=8765)
    p.add_argument("--map", default=None,
                   help="vector map file for GUI edit mode (add/delete/save "
                        "line segments over the bridge)")
    p.add_argument("--nav-map", default=None,
                   help="navigation graph file for GUI graph-edit mode "
                        "(Shift adds vertices/edges, Ctrl deletes, Alt "
                        "moves, Ctrl+Alt edits params)")
    p.add_argument("--semantic-map", default=None,
                   help="semantic graph file for GUI graph-edit mode "
                        "(typed/labelled vertices and edges)")
    p.add_argument("--test-mode", action="store_true",
                   help="GUI stress mode: stream synthetic draw-lists")
    p.add_argument("--device", default="cuda",
                   help="torch device, e.g. cuda, cuda:1 or cpu")
    return p


def _run_test_mode(port: int) -> int:
    """Synthetic-drawing loop: streams rotating lines, points and text
    frames so viewers can be exercised without a map. Host only."""
    import math

    from .gui.drawlist import DrawList
    from .gui.server import GuiServer

    server = GuiServer(port=port)
    stop = threading.Event()
    server.on_shutdown = stop.set
    server.start()
    print(f"test-mode GUI bridge on ws://127.0.0.1:{port} (Ctrl-C to stop)")
    t0 = time.time()
    frames = 0
    try:
        while not stop.is_set():
            dl = DrawList()
            phase = time.time() - t0
            for k in range(64):
                a = phase + k * math.pi / 32
                dl.draw_line((0, 0), (10 * math.cos(a), 10 * math.sin(a)),
                             0x404040 + k * 997)
                dl.draw_point((6 * math.cos(2 * a), 6 * math.sin(2 * a)),
                              0xDE2352)
            dl.draw_text((0, 11), f"frame {frames}", 1.0, 0xFFFFFF)
            server.publish(dl)
            frames += 1
            stop.wait(1.0 / 60.0)
    except KeyboardInterrupt:
        pass
    print(f"\n{frames} frames in {time.time() - t0:.1f}s")
    server.stop()
    return 0


def _sync(device) -> None:
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def _post_optimize(engine, matcher: str, device, timed: bool) -> None:
    t0 = time.perf_counter()
    rep = engine.post_optimize(matcher=matcher)
    _sync(device)
    dt = (time.perf_counter() - t0) * 1e3
    print(f"post-optimize (STF refine): lm_iters={rep.lm_iterations} "
          f"cost {rep.initial_cost:.4g} -> {rep.final_cost:.4g}"
          + (f" ({dt:.1f} ms)" if timed else ""))


def auto_repair(engine, rounds: int, device) -> list:
    """Rounds of {batched proposals -> apply} until a round yields nothing
    or the round budget is spent. The applied corrections land in the input
    history, so the session can be logged and replayed like a human one.
    Returns [(round, proposal, report)] of every correction tried."""
    import numpy as np

    t_start = time.perf_counter()
    applied = 0
    tried = []
    for rnd in range(rounds):
        props = engine.propose_corrections(max_proposals=4, seed=rnd)
        if not props:
            print(f"[round {rnd}] no proposals; stopping")
            break
        for i, p in enumerate(props):
            rep = engine.replay_log(p.input, record=True)
            status = "ok" if rep.accepted else f"rejected: {rep.reason}"
            applied += int(rep.accepted)
            tried.append((rnd, p, rep))
            print(f"[round {rnd}] ({p.anchor_pose},{p.corrected_pose}) "
                  f"score={p.score:.2f} "
                  f"drift={np.linalg.norm(p.drift[:2]):.2f}m: {status}")
            if rep.accepted and i + 1 < len(props):
                # an accepted correction moves poses, so the remaining
                # proposals (computed from the pre-round state) are stale:
                # drop them and propose afresh next round
                break
    _sync(device)
    total = time.perf_counter() - t_start
    print(f"auto-repair: {applied} corrections applied in {total:.2f} s")
    return tried


def _write_info_mat(engine, path: str) -> None:
    from .ops.raster import info_matrix_image
    from .utils.image import write_png

    t = engine.state.constraints
    img = info_matrix_image(engine.state.poses[:, 0], t.anchor,
                            t.constrained, t.active)
    write_png(path, img.cpu().numpy())


def _render(engine, path: str) -> None:
    from .ops.raster import render_map
    from .utils.image import write_png

    st = engine.state
    img = render_map(st.world_points(), st.point_mask, st.poses)
    write_png(path, img.cpu().numpy())
    print(f"rendered map to {path}")


def main(argv=None) -> int:
    from .utils.timing import install_crash_guard

    install_crash_guard()
    args = build_parser().parse_args(argv)
    if args.test_mode:
        return _run_test_mode(args.gui_port)
    if not args.pose_graph:
        print("ERROR: -P/--pose-graph is required", file=sys.stderr)
        return 2

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("ERROR: --device cuda but no CUDA device is available "
              "(pass --device cpu to run on the CPU)", file=sys.stderr)
        return 2
    if args.profile:
        from .utils.timing import device_trace

        with device_trace("hitl-session", enabled=True, logdir=args.profile):
            rc = _main_impl(args, device)
        print(f"profiler trace written to {args.profile}")
        return rc
    return _main_impl(args, device)


def _main_impl(args, device) -> int:
    from .io import logs, stfs
    from .models.hitl.engine import HitLSLAM
    from .solver.lm import LMConfig
    from .utils.config import load_config

    try:
        cfg = load_config(args.config) if args.config else None
        lm_config = LMConfig(**cfg.get("lm", {})) if cfg else LMConfig()
    except (OSError, ValueError, TypeError) as e:
        print(f"ERROR: cannot load config {args.config}: {e}",
              file=sys.stderr)
        return 1

    print(f"loading pose graph: {args.pose_graph}")
    try:
        data = stfs.load_stfs_covars(args.pose_graph)
    except (OSError, ValueError) as e:
        print(f"ERROR: Unable to open specified pose-graph file: "
              f"{args.pose_graph} ({e})", file=sys.stderr)
        return 1
    print(f"loaded {len(data.poses)} poses, "
          f"{sum(len(pc) for pc in data.point_clouds)} points "
          f"(map '{data.map_name}') on {device}")

    engine = HitLSLAM(device=device, lm_config=lm_config)
    engine.init(data.poses, data.covariances, data.point_clouds,
                data.normal_clouds)

    input_log = []
    if args.log:
        try:
            input_log = logs.load_log(args.log)
        except (OSError, ValueError, IndexError) as e:
            print(f"ERROR: Unable to parse correction log: {args.log} ({e})",
                  file=sys.stderr)
            return 1
        print(f"loaded {len(input_log)} logged corrections from {args.log}")

    def handle_sigint(sig, frame):
        # auto-log the session on Ctrl-C, as the original tool does
        history = engine.get_input_history()
        if history:
            name = logs.default_log_name(args.pose_graph)
            logs.save_log(name, history)
            print(f"\nsession log written to {name}")
        print("Terminating.")
        sys.exit(0)

    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGINT, handle_sigint)

    replayed = True
    if args.auto_repair > 0:
        auto_repair(engine, args.auto_repair, device)
        if args.post_optimize:
            _post_optimize(engine, args.refine_matcher, device, timed=False)
    elif args.replay_fused:
        live = [e for e in input_log if not e.undone]
        t_start = time.perf_counter()
        reports = engine.run_queue(live)
        _sync(device)
        total = time.perf_counter() - t_start
        for i, (entry, rep) in enumerate(zip(live, reports)):
            status = "ok" if rep.accepted else f"rejected: {rep.reason}"
            print(f"[{i}] {entry.correction_type.name}: {status} "
                  f"(lm_iters={rep.lm_iterations}, "
                  f"cost {rep.initial_cost:.4g} -> {rep.final_cost:.4g})")
        n_ok = sum(r.accepted for r in reports)
        print(f"fused-replayed {len(live)} corrections ({n_ok} accepted) in "
              f"{total:.2f} s ({total * 1e3 / max(len(live), 1):.1f} ms/cycle)")
        if args.post_optimize:
            _post_optimize(engine, args.refine_matcher, device, timed=False)
    elif args.replay_all:
        t_start = time.perf_counter()
        for i, entry in enumerate(input_log):
            if entry.undone:
                print(f"[{i}] skipping undone entry")
                continue
            t0 = time.perf_counter()
            rep = engine.replay_log(entry)
            _sync(device)
            dt = (time.perf_counter() - t0) * 1e3
            status = "ok" if rep.accepted else f"rejected: {rep.reason}"
            print(f"[{i}] {entry.correction_type.name}: {status} "
                  f"({dt:.1f} ms, lm_iters={rep.lm_iterations}, "
                  f"cost {rep.initial_cost:.4g} -> {rep.final_cost:.4g})")
        total = time.perf_counter() - t_start
        print(f"replayed {len(input_log)} corrections in {total:.2f} s")
        if args.post_optimize:
            _post_optimize(engine, args.refine_matcher, device, timed=True)
    elif args.gui:
        return _serve_gui(args, engine, input_log, handle_sigint)
    else:
        replayed = False
        if args.post_optimize:
            _post_optimize(engine, args.refine_matcher, device, timed=True)

    stfs.save_results_poses(args.save, engine.get_poses())
    print(f"saved {len(data.poses)} poses to {args.save}")
    if args.info_mat and replayed:
        _write_info_mat(engine, args.info_mat)
    if args.render:
        _render(engine, args.render)
    return 0



def _serve_gui(args, engine, input_log, handle_sigint) -> int:
    """The interactive serve loop: draw-lists out, mouse and keyboard
    events in (keys in the module docstring), the capture service, and
    vector-map and graph edits. Ends on a shutdown message or Ctrl-C."""
    import numpy as np

    from .gui.display import (display_covariances, display_poses,
                              display_proposals, display_selection)
    from .gui.server import GuiServer
    from .io import stfs

    server = GuiServer(port=args.gui_port)
    correction_mode = {"on": False}
    replay_idx = {"i": 0}
    proposals = {"list": []}
    show_cov = {"on": False}

    vmap = None
    if args.map:
        from .gui.map_edit import VectorMapFile

        vmap = VectorMapFile(args.map)
    graph = None
    if args.nav_map or args.semantic_map:
        from .gui.graph_edit import GraphMap

        graph = GraphMap(args.semantic_map or args.nav_map,
                         semantic=bool(args.semantic_map))

    def save_results():
        poses = engine.get_poses()
        stfs.save_results_poses(args.save, poses)
        print(f"saved {len(poses)} poses to {args.save}")

    def publish():
        dl = display_poses(engine.state)
        display_selection(dl, engine.selected_points)
        if proposals["list"]:
            display_proposals(dl, proposals["list"])
        if show_cov["on"]:
            poses = engine.get_poses()
            display_covariances(dl, poses, engine.get_covariances(),
                                stride=max(len(poses) // 128, 1))
        if vmap is not None:
            vmap.to_drawlist(dl)
        if graph is not None:
            graph.to_drawlist(dl)
        server.publish(dl)

    def on_map_edit(msg):
        if vmap is None:
            return
        from .gui.map_edit import handle_map_edit

        if handle_map_edit(vmap, msg):
            publish()

    def on_graph_edit(msg):
        if graph is None:
            return
        from .gui.graph_edit import handle_graph_edit

        if handle_graph_edit(graph, msg):
            publish()

    def on_click(ev):
        if correction_mode["on"]:
            engine.add_correction_points(
                ev.modifiers, np.asarray(ev.mouse_down),
                np.asarray(ev.mouse_up))
            publish()

    def on_capture(filename: str):
        # headless render of the current map to a PNG
        _render(engine, filename)

    def on_key(ev):
        if ev.keycode == 0x50:      # 'p'
            correction_mode["on"] = not correction_mode["on"]
            if not correction_mode["on"]:
                rep = engine.run()
                print(f"cycle: accepted={rep.accepted} {rep.reason}")
                if args.info_mat:
                    _write_info_mat(engine, args.info_mat)
                publish()
        elif ev.keycode == 0x55:    # 'u'
            if engine.undo():
                publish()
        elif ev.keycode == 0x56:    # 'v'
            save_results()
        elif ev.keycode == 0x4C:    # 'l'
            if replay_idx["i"] < len(input_log):
                engine.replay_log(input_log[replay_idx["i"]])
                replay_idx["i"] += 1
                publish()
        elif ev.keycode == 0x41:    # 'a': propose / accept suggestion
            if not proposals["list"]:
                proposals["list"] = engine.propose_corrections()
                print(f"{len(proposals['list'])} correction proposals")
            else:
                p = proposals["list"][0]
                rep = engine.replay_log(p.input)
                print(f"proposal ({p.anchor_pose},{p.corrected_pose}) "
                      f"accepted={rep.accepted} {rep.reason}")
                proposals["list"] = []
            publish()
        elif ev.keycode == 0x43:    # 'c': toggle covariance ellipses
            show_cov["on"] = not show_cov["on"]
            publish()
        elif ev.keycode == 0x4F:    # 'o': post-human STF refine
            if correction_mode["on"]:
                print("cannot post-optimize while in correction mode")
            else:
                rep = engine.post_optimize(matcher=args.refine_matcher)
                print(f"post-optimize: {rep.reason} "
                      f"lm_iters={rep.lm_iterations} cost "
                      f"{rep.initial_cost:.4g} -> {rep.final_cost:.4g}")
                publish()

    stop = threading.Event()
    server.on_mouse_click = on_click
    server.on_keyboard = on_key
    server.on_capture = on_capture
    server.on_map_edit = on_map_edit
    server.on_graph_edit = on_graph_edit
    server.on_shutdown = stop.set
    server.start()
    publish()
    print(f"GUI bridge listening on ws://127.0.0.1:{args.gui_port} "
          f"(keys: p=correct u=undo v=save l=replay a=propose/accept "
          f"c=covariances o=post-optimize)")
    try:
        while not stop.wait(0.5):
            pass
    except KeyboardInterrupt:
        handle_sigint(None, None)
    server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
