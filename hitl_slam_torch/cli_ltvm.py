"""LTVM command line: load one or more .stfs.covars pose graphs, curate the
long-term vector map over them in order, and write the vector map and the
last SDF's rasters.

Port of hitl_slam_tpu/cli_ltvm.py. Run as
`python -m hitl_slam_torch.cli_ltvm -P map.stfs.covars -o out`; writes
out.vectors.txt, out.weights.png and out.values.png. Runs on the card unless
--device says otherwise.
"""

from __future__ import annotations

import argparse
import sys
import time


def build_parser():
    p = argparse.ArgumentParser(prog="ltvm-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-P", "--pose-graph", required=True, nargs="+",
                   help="one or more .stfs.covars sessions to curate in order")
    p.add_argument("-o", "--output", default="ltvm_out")
    p.add_argument("--resolution", type=float, default=0.04)
    p.add_argument("--device", default="cuda",
                   help="torch device, e.g. cuda, cuda:1 or cpu")
    return p


def main(argv=None) -> int:
    from .utils.timing import install_crash_guard

    install_crash_guard()
    args = build_parser().parse_args(argv)

    import torch

    from .core.state import make_map_state
    from .io import stfs
    from .models.ltvm.curator import CuratorParams, LongTermVectorMap
    from .ops.sdf import SdfParams

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("ERROR: --device cuda but no CUDA device is available "
              "(pass --device cpu to run on the CPU)", file=sys.stderr)
        return 2

    params = CuratorParams()
    params.sdf = SdfParams(image_resolution=args.resolution)
    curator = LongTermVectorMap(params)
    for path in args.pose_graph:
        try:
            data = stfs.load_stfs_covars(path)
        except (OSError, ValueError) as e:
            print(f"ERROR: Unable to open specified pose-graph file: "
                  f"{path} ({e})", file=sys.stderr)
            return 1
        st = make_map_state(data.poses, data.covariances, data.point_clouds,
                            data.normal_clouds, device=device)
        t0 = time.perf_counter()
        vectors = curator.curate(st.poses, st.points, st.point_mask)
        print(f"curated {path}: {len(vectors)} vectors "
              f"({time.perf_counter() - t0:.2f}s)")
    curator.save_vectors(args.output + ".vectors.txt")
    curator.save_sdf(args.output + ".weights.png", args.output + ".values.png")
    print(f"wrote {args.output}.vectors.txt and SDF rasters")
    return 0


if __name__ == "__main__":
    sys.exit(main())
