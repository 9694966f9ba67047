"""Halo-exchange wire accounting and flagship-scale plan build, host only.

Port of `benchmarks/halo_accounting.py`. For flagship-shaped frames (2816
points, k = 20, configuration_radarscenes.yml's workload) it

  1. builds the halo plans at mp in {2, 4, 8} with the port's planner (the
     dense one by default, as the port's kNN path; `--tiling windowed` for
     the windowed one) and records its wall time on the host,
  2. derives the bytes of the per-layer boundary all_to_all from the plans'
     static send budgets (each rank ships outbound [mp, B, D] and receives
     as much, forward and transposed backward per conv layer, bf16-wide
     features as on the card's compute path),
  3. where `--step-ms` gives a measured single-card step time, predicts the
     weak-scaling efficiency against an assumed link rate (LINK_BYTES_PER_S:
     NVLink 4 of an H100 SXM card, 450 GB/s a direction, NVIDIA's data
     sheet; an assumption, not a measurement):

         t_comp(mp) = step_ms / mp
         t_link(mp) = per-rank wire bytes / link bytes per s
         efficiency = t_comp / max(t_comp, t_link)

     The exchange is issued before the tile compute, which does not depend
     on it, so a transfer shorter than the compute can hide behind it;
     collective latency floors are ignored.

    python -m radargnn_tpu_torch.benchmarks.halo_accounting [--points 2816]
        [--graphs 5] [--mps 2,4,8] [--tiling dense|windowed] [--step-ms T]

One JSON line per mp, then one of the frames' set-up. Nothing here runs on
a card; the sharded step itself runs under `python -m
radargnn_tpu_torch.parallel.dryrun`.
"""

from __future__ import annotations

import argparse
import json
import time

# per conv layer input widths of the flagship stack (after the 224-wide node
# embedding): conv dims [224, 224, 128, 64, 32]
LAYER_DIMS = [224, 224, 224, 128, 64]
BYTES_PER_EL = 2        # features ship bf16 on the card's compute path
LINK_BYTES_PER_S = 450e9
K = 20


def plan_rows(samples, mp: int, tiling: str):
    """(plans, seconds) of the graphs' halo plans over mp shards, nodes in
    Morton order as the loader orders them."""
    from radargnn_tpu_torch.graph.batch import morton_sort_sample
    from radargnn_tpu_torch.models.layers import (
        FUSED_DENSE_EXTRA_SLOTS, FUSED_DENSE_R_TILE, FUSED_EDGE_TILE,
        FUSED_NODE_BLOCK, FUSED_WINDOW_BLOCKS,
    )
    from radargnn_tpu_torch.parallel.halo_dense import build_halo_dense_plan
    from radargnn_tpu_torch.parallel.halo_windowed import (
        build_halo_windowed_plan,
    )
    plans = []
    t0 = time.perf_counter()
    for s in samples:
        s = morton_sort_sample(s)
        n = -(-s.num_nodes // (FUSED_NODE_BLOCK * mp)) * FUSED_NODE_BLOCK * mp
        if tiling == "dense":
            plans.append(build_halo_dense_plan(
                s.senders, s.receivers, n, mp, K + FUSED_DENSE_EXTRA_SLOTS,
                FUSED_DENSE_R_TILE, FUSED_NODE_BLOCK, FUSED_WINDOW_BLOCKS,
                ovf_frac=0.5))
        else:
            plans.append(build_halo_windowed_plan(
                s.senders, s.receivers, n, mp, node_block=FUSED_NODE_BLOCK,
                edge_tile=FUSED_EDGE_TILE, window_blocks=FUSED_WINDOW_BLOCKS,
                ovf_frac=0.5))
    return plans, time.perf_counter() - t0


def account(plans, mp: int, step_ms=None) -> dict:
    """The wire bytes per rank and step of a batch's plans, and the
    predicted efficiency where a step time is given."""
    b_per_graph = [p.halo.send_idx.shape[-1] for p in plans]
    real = [int((p.halo.send_idx >= 0).sum()) / mp for p in plans]
    per_rank = sum(2 * sum(LAYER_DIMS) * BYTES_PER_EL * mp * b
                   for b in b_per_graph)
    t_link_ms = per_rank / LINK_BYTES_PER_S * 1e3
    row = dict(mp=mp, halo_b=b_per_graph, real_avg=[round(r) for r in real],
               n_aug=[int(p.n_aug) for p in plans],
               wire_mb_per_rank=round(per_rank / 1e6, 3),
               t_link_ms=round(t_link_ms, 4))
    if step_ms is not None:
        t_comp = step_ms / mp
        row.update(t_comp_ms=round(t_comp, 3),
                   predicted_efficiency=round(
                       t_comp / max(t_comp, t_link_ms), 3))
    return row


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--points", type=int, default=2816)
    ap.add_argument("--graphs", type=int, default=5)
    ap.add_argument("--mps", type=str, default="2,4,8")
    ap.add_argument("--tiling", choices=("dense", "windowed"),
                    default="dense")
    ap.add_argument("--step-ms", type=float, default=None,
                    help="a single-card step time measured on the card "
                         "(the model's compute term; none: no prediction)")
    args = ap.parse_args(argv)

    from radargnn_tpu_torch.data.synthetic import make_samples

    t0 = time.perf_counter()
    samples = make_samples(num_frames=args.graphs, num_points=args.points,
                           seed=0)
    t_gen = time.perf_counter() - t0
    for mp in map(int, args.mps.split(",")):
        plans, t_plan = plan_rows(samples, mp, args.tiling)
        row = account(plans, mp, args.step_ms)
        row.update(tiling=args.tiling, plan_s=round(t_plan, 3))
        print(json.dumps(row))
    print(json.dumps({"frame_gen_s": round(t_gen, 3), "points": args.points,
                      "graphs": args.graphs,
                      "assumed_link_gbs": LINK_BYTES_PER_S / 1e9}))


if __name__ == "__main__":
    main()
