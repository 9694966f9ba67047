"""Host-side dataset-creation throughput: graph construction and ground-truth
boxes.

Port of `benchmarks/preprocessing_bench.py`. The reference's preprocessing
is its only parallel stage (a process fan-out over sequences) because its
per-edge feature loop and its kNN dominate. This measures the port's
vectorised replacement on the same work, a kNN graph with invariant node
and edge features and the ground-truth boxes of each frame
(`graph.build.build_geometric_graph`, `data.ground_truth`, with the
compiled helper `native/geometry.cpp` unless --no-native). It is host work,
as in the JAX package, and takes no device.

    python -m radargnn_tpu_torch.benchmarks.preprocessing_bench [--points N]
        [--frames N] [--k K] [--workers N] [--no-native]

Prints the points/s and edges/s of one process and of a process pool
(spawned workers), as the JAX tool does.
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
import time
from concurrent.futures import ProcessPoolExecutor
from typing import List, Optional

import numpy as np


def make_frames(num_frames: int, num_points: int, seed: int) -> list:
    """Random frames (positions, velocities, RCS, time, track ids) as the
    JAX tool draws them."""
    rng = np.random.default_rng(seed)
    frames = []
    for _ in range(num_frames):
        pos = rng.uniform(0, 100, (num_points, 2)).astype(np.float64)
        vel = rng.normal(0, 3, (num_points, 2)).astype(np.float64)
        rcs = rng.normal(0, 5, (num_points, 1)).astype(np.float64)
        t = rng.uniform(0, 0.5, (num_points, 1)).astype(np.float64)
        n_obj = max(num_points // 60, 1)
        track = rng.integers(-1, n_obj, num_points)
        frames.append((pos, vel, rcs, t, track))
    return frames


def process_frame(args):
    """One frame's graph and boxes; returns (edges, finite box values)."""
    frame, k = args
    from radargnn_tpu_torch.configs import GraphConstructionConfiguration
    from radargnn_tpu_torch.data.ground_truth import create_2d_bounding_boxes
    from radargnn_tpu_torch.graph.build import build_geometric_graph

    pos, vel, rcs, t, track = frame
    cfg = GraphConstructionConfiguration(
        graph_construction_algorithm="knn",
        graph_construction_settings={"k": k, "r": 1.0},
        node_features=["rcs", "time_index", "degree"],
        edge_features=["point_pair_features"],
        edge_mode="directed",
        distance_definition="X")
    g = build_geometric_graph(cfg, pos, vel, rcs, t)
    boxes = create_2d_bounding_boxes(pos, track, aligned=False,
                                     bb_invariance="translation")
    return g.edges.shape[0], int(np.isfinite(boxes).sum())


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--points", type=int, default=2816)
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--k", type=int, default=20)
    ap.add_argument("--workers", type=int, default=os.cpu_count())
    ap.add_argument("--no-native", action="store_true",
                    help="disable the C++ host kernels (numpy fallbacks)")
    args = ap.parse_args(argv)
    if args.no_native:
        # read where the helper is first loaded, here and in the workers
        os.environ["RADARGNN_NO_NATIVE"] = "1"

    frames = make_frames(args.frames, args.points, seed=0)
    work = [(f, args.k) for f in frames]

    process_frame(work[0])                    # imports and the native build
    t0 = time.perf_counter()
    edges = sum(process_frame(w)[0] for w in work)
    dt1 = time.perf_counter() - t0
    pts = args.frames * args.points
    print(f"single-process: {pts / dt1:,.0f} points/s, "
          f"{edges / dt1:,.0f} edges/s ({dt1:.2f} s, native="
          f"{not args.no_native})", flush=True)

    if args.workers and args.workers > 1:
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(max_workers=args.workers,
                                 mp_context=ctx) as ex:
            list(ex.map(process_frame, work[:2]))   # pool warm-up
            t0 = time.perf_counter()
            total = sum(e for e, _ in ex.map(process_frame, work))
            dt2 = time.perf_counter() - t0
        print(f"{args.workers}-process pool: {pts / dt2:,.0f} points/s, "
              f"{total / dt2:,.0f} edges/s ({dt2:.2f} s)")


if __name__ == "__main__":
    main()
