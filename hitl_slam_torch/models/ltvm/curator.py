"""Long-Term Vector Mapping: the SDF-based map curator.

Port of hitl_slam_tpu/models/ltvm/curator.py (design: "Curating Long-Term
Vector Maps", IROS 2016). One curation pass =
  build the SDF -> filter dynamic observations -> RANSAC line extraction
  -> merge new vectors into the master map -> self-merge -> prune.
The three device stages run on the device of the tensors handed to
`curate`; the merge logic is host numpy.

MappingVector: {mass, p1, p2, p_bar (centroid), scatter}. Endpoint
covariances are derived from the inlier scatter about the line
(perpendicular variance / mass): more support gives tighter endpoints.

The RANSAC hypotheses of each pass are uniforms drawn from a CPU generator
seeded with `seed` (ops/ransac.py::uniform_draws' scheme; the generator
advances from pass to pass), unless `curate` is handed `draws`.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ...ops.geometry import pose_to_world
from ...ops.ransac import (RansacParams, Segments, extract_segments,
                           uniform_draws)
from ...ops.sdf import SdfImage, SdfParams, build_sdf, filter_points, sdf_bounds


@dataclass
class MappingVector:
    mass: float
    p1: np.ndarray
    p2: np.ndarray
    p_bar: np.ndarray
    scatter: np.ndarray          # [2, 2]
    endpoint_cov: np.ndarray     # [2, 2] shared endpoint covariance


@dataclass
class CuratorParams:
    sdf: SdfParams = field(default_factory=SdfParams)
    ransac: RansacParams = field(default_factory=RansacParams)
    merge_angle: float = np.deg2rad(10.0)
    merge_lateral: float = 0.15
    merge_gap: float = 0.5       # max along-line gap to merge
    prune_min_mass: float = 12.0
    prune_min_length: float = 0.3


class LongTermVectorMap:
    """Stateful curator accumulating a master vector map across sessions."""

    def __init__(self, params: CuratorParams | None = None, seed: int = 0):
        self.params = params or CuratorParams()
        self.vectors: list[MappingVector] = []
        self._gen = torch.Generator(device="cpu")
        self._gen.manual_seed(int(seed))
        self.last_sdf: SdfImage | None = None

    # -- device stages -----------------------------------------------------

    def _extract(self, poses, points, point_mask, draws,
                 timings_ms: dict | None) -> Segments:
        dev = poses.device

        def now():
            if timings_ms is not None and dev.type == "cuda":
                torch.cuda.synchronize(dev)
            return time.perf_counter()

        def lap(name, t0):
            t1 = now()
            if timings_ms is not None:
                timings_ms[name] = (t1 - t0) * 1e3
            return t1

        t0 = now()
        world = pose_to_world(poses[:, None, :], points)
        lo, hi = sdf_bounds(world, point_mask, self.params.sdf.image_border)
        res = self.params.sdf.image_resolution
        width = int(np.ceil((hi[0] - lo[0]) / res))
        height = int(np.ceil((hi[1] - lo[1]) / res))
        sdf = build_sdf(poses, points, point_mask,
                        torch.as_tensor(lo, device=dev), height, width,
                        self.params.sdf)
        self.last_sdf = sdf
        t0 = lap("sdf_ms", t0)
        keep = filter_points(sdf, world, point_mask, self.params.sdf)
        t0 = lap("filter_ms", t0)
        rp = self.params.ransac
        if draws is None:
            # drawn on every pass, so the generator advances as the
            # reference's key does
            draws = uniform_draws(None, rp, dev, generator=self._gen)
        segs = extract_segments(world.reshape(-1, 2), keep.reshape(-1),
                                draws, rp)
        lap("ransac_ms", t0)
        return segs

    # -- host merge logic --------------------------------------------------

    @staticmethod
    def _to_vectors(segs: Segments) -> list[MappingVector]:
        out = []
        # one device -> host transfer per field
        valid = segs.valid.cpu().numpy()
        masses = segs.mass.cpu().numpy()
        scatters = segs.scatter.cpu().numpy()
        p1s = segs.p1.cpu().numpy()
        p2s = segs.p2.cpu().numpy()
        centroids = segs.centroid.cpu().numpy()
        for i in np.flatnonzero(valid):
            mass = float(masses[i])
            scatter = scatters[i]
            d = p2s[i] - p1s[i]
            d = d / max(np.linalg.norm(d), 1e-9)
            n = np.array([-d[1], d[0]])
            perp_var = float(n @ scatter @ n) / max(mass, 1.0)
            out.append(MappingVector(
                mass=mass,
                p1=p1s[i].copy(),
                p2=p2s[i].copy(),
                p_bar=centroids[i].copy(),
                scatter=scatter.copy(),
                endpoint_cov=np.eye(2) * max(perp_var, 1e-6),
            ))
        return out

    def _mergeable(self, a: MappingVector, b: MappingVector) -> bool:
        p = self.params
        da = a.p2 - a.p1
        db = b.p2 - b.p1
        la, lb = np.linalg.norm(da), np.linalg.norm(db)
        if la < 1e-6 or lb < 1e-6:
            return False
        da, db = da / la, db / lb
        ang = np.arccos(np.clip(abs(da @ db), 0.0, 1.0))
        if ang > p.merge_angle:
            return False
        n = np.array([-da[1], da[0]])
        lateral = abs(n @ (b.p_bar - a.p_bar))
        if lateral > p.merge_lateral:
            return False
        ta = sorted([da @ (a.p1 - a.p_bar), da @ (a.p2 - a.p_bar)])
        tb = sorted([da @ (b.p1 - a.p_bar), da @ (b.p2 - a.p_bar)])
        gap = max(ta[0], tb[0]) - min(ta[1], tb[1])
        return gap <= p.merge_gap

    @staticmethod
    def _merge(a: MappingVector, b: MappingVector) -> MappingVector:
        mass = a.mass + b.mass
        p_bar = (a.mass * a.p_bar + b.mass * b.p_bar) / mass
        # combine scatters about the new centroid
        sa = a.scatter + a.mass * np.outer(a.p_bar - p_bar, a.p_bar - p_bar)
        sb = b.scatter + b.mass * np.outer(b.p_bar - p_bar, b.p_bar - p_bar)
        scatter = sa + sb
        evals, evecs = np.linalg.eigh(scatter)
        d = evecs[:, 1]
        ts = [d @ (q - p_bar) for q in (a.p1, a.p2, b.p1, b.p2)]
        p1 = p_bar + min(ts) * d
        p2 = p_bar + max(ts) * d
        n = np.array([-d[1], d[0]])
        perp_var = float(n @ scatter @ n) / max(mass, 1.0)
        return MappingVector(mass=mass, p1=p1, p2=p2, p_bar=p_bar,
                             scatter=scatter,
                             endpoint_cov=np.eye(2) * max(perp_var, 1e-6))

    def _self_merge(self, vectors: list[MappingVector]) -> list[MappingVector]:
        merged = True
        while merged:
            merged = False
            out: list[MappingVector] = []
            used = [False] * len(vectors)
            for i in range(len(vectors)):
                if used[i]:
                    continue
                v = vectors[i]
                for j in range(i + 1, len(vectors)):
                    if used[j]:
                        continue
                    if self._mergeable(v, vectors[j]):
                        v = self._merge(v, vectors[j])
                        used[j] = True
                        merged = True
                out.append(v)
                used[i] = True
            vectors = out
        return vectors

    def _prune(self, vectors: list[MappingVector]) -> list[MappingVector]:
        p = self.params
        return [v for v in vectors
                if v.mass >= p.prune_min_mass
                and np.linalg.norm(v.p2 - v.p1) >= p.prune_min_length]

    # -- public API --------------------------------------------------------

    def curate(self, poses, points, point_mask, draws=None,
               timings_ms: dict | None = None) -> list[MappingVector]:
        """One curation pass over a session's observations: tensors
        poses [P, 3], points [P, N, 2] (robot frame), point_mask [P, N] on
        one device. `draws` is what ops/ransac.py::extract_segments takes.
        `timings_ms`, when given, receives the wall ms of the three device
        stages ("sdf_ms", "filter_ms", "ransac_ms", each synchronised) and
        of the host merge ("merge_ms")."""
        segs = self._extract(poses, points, point_mask, draws, timings_ms)
        t0 = time.perf_counter()
        new_vectors = self._to_vectors(segs)
        self.vectors = self._prune(self._self_merge(self.vectors + new_vectors))
        if timings_ms is not None:
            timings_ms["merge_ms"] = (time.perf_counter() - t0) * 1e3
        return self.vectors

    def save_sdf(self, weights_path: str, values_path: str):
        """Write the last SDF's weight and value rasters as PNGs."""
        from ...utils.image import write_png

        if self.last_sdf is None:
            raise RuntimeError("save_sdf before any curate()")
        w = self.last_sdf.weights.cpu().numpy()
        v = self.last_sdf.values.cpu().numpy()
        wn = (255 * w / max(w.max(), 1e-9)).astype(np.uint8)
        vn = (255 * (v - v.min()) / max(v.max() - v.min(), 1e-9)).astype(np.uint8)
        write_png(weights_path, wn[::-1])
        write_png(values_path, vn[::-1])

    def save_vectors(self, path: str):
        with open(path, "w") as f:
            for v in self.vectors:
                f.write(f"{v.p1[0]:.4f},{v.p1[1]:.4f},"
                        f"{v.p2[0]:.4f},{v.p2[1]:.4f},{v.mass:.1f}\n")
