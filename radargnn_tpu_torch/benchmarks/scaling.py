"""Scaling efficiency of data-parallel training: train edges/s at 1, 2, 4
... ranks.

Port of `benchmarks/scaling.py`. Each world size trains the flagship DetNet
(conv [224, 224, 128, 64, 32], bf16) for `--steps` timed steps after one
warm-up, `--graphs-per-device` frames of `--points` points (k 20) per rank,
on a {"data": world} mesh of ranks (the port's Trainer and shard_batch, on
the dense tiling and its kernels, the port's kNN path; the JAX tool runs
its unfused path). World 1 runs in this
process, larger worlds as spawned ranks: one card each over NCCL where the
machine has them (gloo on the CPU). Each rank's part of the batch is
built and moved to its card once, before the warm-up, at every world size
alike, so the timed steps hold no host-side batch work. Every step ends
when its losses reach the host, so the wall of the timed steps is the
steps' own.

    python -m radargnn_tpu_torch.benchmarks.scaling [--worlds 1,2,4]
        [--graphs-per-device 2] [--points 1024] [--steps 4] [--dtype D]
        [--device cpu]

One JSON line per world size: edges/s, efficiency against world 1
(edges/s over world × world 1's), the device and the backend.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import torch

K = 20


def _arch(dtype: str):
    from radargnn_tpu_torch.configs import GNNArchitectureConfig

    return GNNArchitectureConfig(
        node_feature_dimension=5, edge_feature_dimension=2,
        conv_layer_dimensions=[224, 224, 128, 64, 32],
        classification_head_layer_dimensions=[6],
        regression_head_layer_dimensions=[16, 5],
        initial_node_feature_embedding=True,
        initial_edge_feature_embedding=True,
        node_feature_embedding_layer_dimensions=[32, 64, 128, 224],
        edge_feature_embedding_layer_dimensions=[4, 8, 16],
        batch_norm_in_mlps=False, compute_dtype=dtype,
        assume_sorted_edges=True, use_fused_aggregation=True,
        fused_tiling="dense")


def run_world(rank: int, world: int, device, args: dict) -> float:
    """Train edges/s of `args["steps"]` steps on this rank's mesh (the
    batch's edges over all ranks, per second of wall)."""
    from radargnn_tpu_torch.configs import TrainingConfig
    from radargnn_tpu_torch.data.synthetic import make_samples
    from radargnn_tpu_torch.graph.batch import stack_samples
    from radargnn_tpu_torch.models.detnet import DetNet
    from radargnn_tpu_torch.models.layers import fused_csr_tiling
    from radargnn_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from radargnn_tpu_torch.train.trainer import Trainer

    device = torch.device(device)
    g = args["graphs_per_device"] * world
    arch = _arch(args["dtype"])
    mesh = make_mesh({"data": world}, device=device) if world > 1 else None
    samples = make_samples(num_frames=g, num_points=args["points"], seed=0)
    n = -(-args["points"] // 256) * 256
    batch = stack_samples(samples, n, 5, max_edges=n * K,
                          csr_tiling=fused_csr_tiling(arch, k=K),
                          device="cpu")
    # every world times its steps on a batch already on its card: the
    # rank's part, built once as the CLI's loaders build it
    batch = batch.to(device) if mesh is None else shard_batch(batch, mesh)
    trainer = Trainer(TrainingConfig(
        dataset="radarscenes", learning_rate=1e-3, epochs=1, batch_size=g,
        shuffle=False, bg_index=5, adapt_orientation_angle=True),
        DetNet(arch, device=device), mesh=mesh)
    float(trainer.train_step(batch)[0])            # warm-up: builds, caches
    t0 = time.perf_counter()
    for _ in range(args["steps"]):
        float(trainer.train_step(batch)[0])        # waits for the step
    wall = time.perf_counter() - t0
    return batch.host_valid_edges * args["steps"] / wall


def measure(world: int, args: dict, device: Optional[str] = None) -> dict:
    """One world size's line (module docstring)."""
    from radargnn_tpu_torch.parallel.comm import run_ranks

    on_card = device != "cpu"
    if on_card and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu")
    cards = torch.cuda.device_count() if on_card else 0
    if on_card and world > cards:
        raise ValueError(f"world {world} needs {world} cards, have {cards}")
    backend = "nccl" if on_card else "gloo"
    if world == 1:
        eps = run_world(0, 1, "cuda" if on_card else "cpu", args)
        backend = None
    else:
        devices = [f"cuda:{r}" for r in range(world)] if on_card \
            else ["cpu"]
        eps = run_ranks(run_world, world, backend, args=(args,),
                        devices=devices, timeout_s=900)[0]
    return {"metric": "scaling_train_edges_per_s", "devices": world,
            "value": eps, "unit": "edges/s", "backend": backend,
            "device": torch.cuda.get_device_name(0) if on_card else "cpu"}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--worlds", type=str, default=None,
                    help="world sizes (default: 1, 2, 4, ... up to the "
                         "cards, or 1,2 on the CPU)")
    ap.add_argument("--graphs-per-device", type=int, default=2)
    ap.add_argument("--points", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--dtype", type=str, default="bfloat16")
    ap.add_argument("--device", type=str, default=None,
                    help="cpu for gloo ranks on the CPU (default: the cards)")
    args = ap.parse_args(argv)
    if args.worlds:
        worlds = [int(w) for w in args.worlds.split(",")]
    elif args.device == "cpu":
        worlds = [1, 2]
    else:
        cards = torch.cuda.device_count()
        worlds = [w for w in (1, 2, 4, 8) if w <= max(cards, 1)]
    opts = dict(graphs_per_device=args.graphs_per_device,
                points=args.points, steps=args.steps, dtype=args.dtype)
    base = None
    for world in worlds:
        row = measure(world, opts, args.device)
        base = base or row["value"]
        row["efficiency_vs_1"] = row["value"] / (base * world)
        print(json.dumps(row))


if __name__ == "__main__":
    main()
