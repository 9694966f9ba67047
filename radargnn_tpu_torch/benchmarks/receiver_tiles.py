"""B1 (the node projection and the dense gather-max) and B2 (the dense
backward) at several dense receiver tiles (`r_tile`), on the flagship kNN
batch (5 x 2816 points, k = 20; the node bucket aligned to the node block
and to `r_tile`), on one card.

For each receiver tile it holds the kernels against their plain versions
at the flagship's five layer shapes and times them with CUDA events
(`smoke.check_routed_kernels`: 20 calls after a warm-up), and prints one
JSON line per tile: the per-shape times summed over the five shapes (the
gather-max in serving and in VJP mode), the bounds, the largest errors,
and the card's name and power limit. Run it in two trees in one call to
compare them (r_tile 64 is the YAML's default).

    python -m radargnn_tpu_torch.benchmarks.receiver_tiles \
        [--r-tiles 8,24,64] [--reps 20]
"""

from __future__ import annotations

import argparse
import json
from typing import Dict

import numpy as np
import torch

from radargnn_tpu_torch.data.synthetic import make_samples
from radargnn_tpu_torch.graph.batch import stack_samples
from radargnn_tpu_torch.models.layers import fused_csr_tiling
from radargnn_tpu_torch.smoke import (
    card_description, check_routed_kernels, flagship_configs,
)

# the flagship's five conv layers: (d_in, d_e, H)
SHAPES = [(224, 16, 464)] * 3 + [(128, 16, 272), (64, 16, 144)]


def run(r_tile: int, points: int = 2816, graphs: int = 5, reps: int = 20,
        seed: int = 0) -> Dict:
    dev = torch.device("cuda")
    arch, graph_cfg, bg_index, _ = flagship_configs("knn")
    spec = dict(fused_csr_tiling(arch, k=graph_cfg.k), r_tile=r_tile)
    align = int(np.lcm(spec["node_block"], r_tile))
    max_nodes = -(-points // align) * align
    batch = stack_samples(
        make_samples(num_frames=graphs, num_points=points, seed=seed,
                     graph_config=graph_cfg, bg_index=bg_index),
        max_nodes=max_nodes, bg_index=bg_index,
        max_edges=max_nodes * graph_cfg.k, csr_tiling=spec, device=dev)
    with torch.no_grad():
        proj, fwd, bwd = check_routed_kernels(batch.flat_tiling(), SHAPES,
                                              seed, reps, out=lambda s: None)

    def total(rows, key):
        return sum(r[key] for r in rows)

    return {"r_tile": r_tile, "nodes": max_nodes * graphs,
            "proj_ms": total(proj, "ms"),
            "fwd_ms": total(fwd, "ms"), "fwd_plain_ms": total(fwd,
                                                              "plain_ms"),
            "fwd_vjp_ms": sum(r["vjp"]["ms"] for r in fwd),
            "fwd_bound_ms": total(fwd, "bound_ms"),
            "bwd_ms": total(bwd, "ms"), "bwd_plain_ms": total(bwd,
                                                              "plain_ms"),
            "bwd_bound_ms": total(bwd, "bound_ms"),
            "fwd_max_rel_err": max(r["max_rel_err"] for r in fwd),
            "bits_flipped": sum(r["bits_flipped"] for r in fwd),
            "bwd_max_rel_err": max(r["max_rel_err"] for r in bwd),
            "card": card_description()}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--r-tiles", default="8,24,64")
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("receiver_tiles: no CUDA device is available")
    for r_tile in (int(v) for v in args.r_tiles.split(",")):
        print(json.dumps(run(r_tile, reps=args.reps)), flush=True)


if __name__ == "__main__":
    main()
