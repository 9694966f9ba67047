"""CLI: model training. Port of `radargnn_tpu/cli/train.py`.

    python -m radargnn_tpu_torch.cli.train --data D --results R --config C
        [--resume] [--device cpu] [--backend nccl|gloo]

    torchrun --nproc-per-node N -m radargnn_tpu_torch.cli.train ...

The fused tiling resolves as in the JAX package ("auto" is the dense tiling
on a kNN graph, the windowed one otherwise), and the kernels of that tiling
run on the card. TRAINING's `mesh_axes` lays the ranks out as the JAX
package lays out its devices (-1: every remaining rank): under `torchrun`
each process is one rank (NCCL by default, one card each; `--backend gloo`
lets ranks share a card, and is the CPU's), and a `model` axis of more than
one rank partitions every graph's edges with halo exchange
(`halo_partition_from_configs`). A mesh the processes cannot fill raises;
nothing trains on one device in its place. Only rank 0 prints the epochs
and writes the results and checkpoints; every rank resumes.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from radargnn_tpu_torch.configs import UserConfigurationReader
from radargnn_tpu_torch.data.loader import get_data_loaders
from radargnn_tpu_torch.device import DeviceLike, resolve_device
from radargnn_tpu_torch.models.detnet import DetNet
from radargnn_tpu_torch.models.layers import fused_csr_tiling
from radargnn_tpu_torch.parallel.mesh import (
    Mesh, init_distributed, make_mesh, resolve_axes,
)
from radargnn_tpu_torch.train.trainer import Trainer, set_seeds


def halo_partition_from_configs(model_config, mesh: Optional[Mesh],
                                csr_tiling=None) -> Optional[dict]:
    """The loader's `halo_partition` for a mesh with a model axis of more
    than one rank (None otherwise), as the JAX package's: its data and
    model sizes and the MODEL_ARCHITECTURE's `halo_overflow_fraction`. The
    halo path runs the fused kernels per shard, so it needs the dense or
    the windowed tiling (SystemExit otherwise; `csr_tiling` is the
    already-resolved tiling, else it is derived)."""
    if mesh is None or mesh.shape.get("model", 1) <= 1:
        return None
    if csr_tiling is None:
        csr_tiling = fused_csr_tiling(model_config)
    if csr_tiling is None or (not isinstance(csr_tiling, dict)
                              and len(csr_tiling) < 3):
        raise SystemExit(
            "mesh_axes with model>1 requires use_fused_aggregation with "
            "windowed or dense tiling (the halo path runs the fused "
            "kernels per shard)")
    return {"dp": mesh.shape.get("data", 1),
            "mp": mesh.shape["model"],
            "ovf_frac": getattr(model_config, "halo_overflow_fraction", 0.5)}


def mesh_from_configs(mesh_axes: Optional[dict], device: torch.device,
                      backend: Optional[str] = None
                      ) -> Tuple[Optional[Mesh], torch.device]:
    """The mesh of `mesh_axes` over this run's processes, and this rank's
    device. One process (no WORLD_SIZE above 1 in the environment, no
    process group) runs a mesh of one device, which is no mesh; a mesh of
    more devices than processes raises. Several processes join the process
    group `torchrun` describes (unless the caller already has one) and
    must fill the mesh exactly (all of them on `data` without
    mesh_axes)."""
    initialised = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialised \
        else int(os.environ.get("WORLD_SIZE", "1"))
    axes = resolve_axes(mesh_axes, world) if mesh_axes else {"data": world}
    if world == 1:
        return None, device
    if not initialised:
        device = init_distributed(backend, device)
    elif device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return make_mesh(axes, device=device), device


def resolve_tiling(model_config, config_dict: dict):
    """The fused tiling of MODEL_ARCHITECTURE: "dense" needs a kNN graph
    (SystemExit otherwise), "auto" is dense on a kNN graph."""
    graph_k = None
    tiling_mode = getattr(model_config, "fused_tiling", None)
    if tiling_mode in ("dense", "auto"):
        graph_config = UserConfigurationReader.get_config_object(
            "GRAPH_CONSTRUCTION", config_dict)
        is_knn = graph_config.graph_construction_algorithm == "knn"
        if tiling_mode == "dense" and not is_knn:
            raise SystemExit('fused_tiling "dense" requires a kNN graph '
                             "(fixed in-degree); use windowed tiling for "
                             "radius graphs")
        if is_knn:
            graph_k = graph_config.k
    return fused_csr_tiling(model_config, k=graph_k)


def main(path_to_graph_data: str, path_to_results: str,
         path_to_config: str, resume: bool = False,
         device: DeviceLike = None, backend: Optional[str] = None) -> None:
    device = resolve_device(device)
    config_dict = UserConfigurationReader.read_config_file(path_to_config)
    model_config = UserConfigurationReader.get_config_object(
        "MODEL_ARCHITECTURE", config_dict)
    training_config = UserConfigurationReader.get_config_object(
        "TRAINING", config_dict)
    joined = dist.is_available() and dist.is_initialized()
    mesh, device = mesh_from_configs(training_config.mesh_axes, device,
                                     backend)
    main_rank = mesh is None or mesh.rank == 0

    def say(*args) -> None:
        if main_rank:
            print(*args)

    say("Train device: " + (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else str(device)))
    if mesh is not None:
        say(f">>> mesh {mesh.shape} over {mesh.world_size} ranks "
            f"({dist.get_backend()})")

    was_deterministic = torch.are_deterministic_algorithms_enabled()
    try:
        seed = 0
        if training_config.deterministic:
            seed = training_config.seed
            set_seeds(seed, deterministic=True)

        say(">>> loading data")
        csr_tiling = resolve_tiling(model_config, config_dict)
        if csr_tiling is None:
            say(">>> fused aggregation: off (unfused aggregation path)")
        elif isinstance(csr_tiling, dict):
            say(f">>> fused aggregation: dense (v4) kernels, "
                f"{csr_tiling['k']} slots/receiver")
        elif len(csr_tiling) == 2:
            say(f">>> fused aggregation: CSR (v2) kernels, "
                f"tiling {csr_tiling}")
        else:
            say(f">>> fused aggregation: windowed (v3) kernels, "
                f"tiling {csr_tiling}")
        halo_partition = halo_partition_from_configs(model_config, mesh,
                                                     csr_tiling)
        if halo_partition is not None:
            say(f">>> halo edge partitioning: {halo_partition}")
        # over a mesh each loader yields this rank's part of its batches
        data_loaders, dataset_config_dict = get_data_loaders(
            ["train", "validate"], path_to_graph_data,
            training_config.batch_size, training_config.shuffle,
            bg_index=training_config.bg_index, seed=training_config.seed,
            csr_tiling=csr_tiling, halo_partition=halo_partition,
            device=device, mesh=mesh)

        say(">>> creating model")
        model = DetNet(model_config, device=device, seed=seed)

        say(">>> starting training")
        trainer = Trainer(training_config, model, mesh=mesh)
        ckpt_dir = os.path.join(path_to_results, "_checkpoint") \
            if training_config.checkpoint_every_epochs else None
        resume_from = ckpt_dir if (resume and ckpt_dir and os.path.exists(
            os.path.join(ckpt_dir, "meta.json"))) else None
        if resume_from:
            say(f">>> resuming from {resume_from}")
        trainer.fit(data_loaders, resume_from=resume_from,
                    checkpoint_dir=ckpt_dir)

        if main_rank:
            trainer.save_results(path_to_results, model_config,
                                 dataset_config_dict)
        trainer.barrier()
    finally:
        torch.use_deterministic_algorithms(was_deterministic)
        if mesh is not None and not joined:
            dist.destroy_process_group()


def cli(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--data", type=str, required=True)
    parser.add_argument("--results", type=str, required=True)
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--resume", action="store_true",
                        help="resume from the _checkpoint folder if present")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the CUDA card)")
    parser.add_argument("--backend", type=str, default=None,
                        choices=("nccl", "gloo"),
                        help="torch.distributed backend under torchrun "
                             "(default: nccl on the card, gloo on the CPU)")
    args = parser.parse_args(argv)
    if not os.path.isdir(args.data):
        raise SystemExit("Invalid path for graph data folder")
    if not os.path.isdir(args.results):
        raise SystemExit("Invalid path for results folder")
    if not os.path.isfile(args.config):
        raise SystemExit("Invalid path to config file")
    main(args.data, args.results, args.config, resume=args.resume,
         device=args.device, backend=args.backend)


if __name__ == "__main__":
    cli()
