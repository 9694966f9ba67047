"""CLI: model training. Port of `radargnn_tpu/cli/train.py`.

    python -m radargnn_tpu_torch.cli.train --data D --results R --config C
        [--resume] [--device cpu]

The fused tiling resolves as in the JAX package ("auto" is the dense tiling
on a kNN graph, the windowed one otherwise), and the kernels of that tiling
run on the card. The port trains on one card: a `mesh_axes` that asks for
more waits for ROADMAP.md §A, multi-GPU.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import torch

from radargnn_tpu_torch.configs import UserConfigurationReader
from radargnn_tpu_torch.data.loader import get_data_loaders
from radargnn_tpu_torch.device import DeviceLike, resolve_device
from radargnn_tpu_torch.models.detnet import DetNet
from radargnn_tpu_torch.models.layers import fused_csr_tiling
from radargnn_tpu_torch.train.trainer import Trainer, set_seeds


def halo_partition_from_configs(mesh_axes: Optional[dict],
                                device: torch.device) -> None:
    """The loader's halo partition for `mesh_axes`: None on one device.
    An axis of -1 takes every card of the machine, as the JAX package's
    mesh does; a mesh of more than one device raises, since the sharded
    batch and the halo paths are not ported."""
    cards = torch.cuda.device_count() if device.type == "cuda" else 1
    for axis, size in (mesh_axes or {}).items():
        if (cards if size == -1 else size) > 1:
            raise NotImplementedError(
                f"mesh_axes {mesh_axes} spreads training over several "
                f"devices (axis {axis!r}); the port trains on one "
                "(ROADMAP.md §A, multi-GPU)")
    return None


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
         device: DeviceLike = None) -> None:
    device = resolve_device(device)
    config_dict = UserConfigurationReader.read_config_file(path_to_config)
    model_config = UserConfigurationReader.get_config_object(
        "MODEL_ARCHITECTURE", config_dict)
    training_config = UserConfigurationReader.get_config_object(
        "TRAINING", config_dict)

    print("Train device: " + (torch.cuda.get_device_name(device)
                              if device.type == "cuda" else str(device)))

    was_deterministic = torch.are_deterministic_algorithms_enabled()
    try:
        seed = 0
        if training_config.deterministic:
            seed = training_config.seed
            set_seeds(seed, deterministic=True)

        print(">>> loading data")
        csr_tiling = resolve_tiling(model_config, config_dict)
        if csr_tiling is None:
            print(">>> fused aggregation: off (unfused aggregation path)")
        elif isinstance(csr_tiling, dict):
            print(f">>> fused aggregation: dense (v4) kernels, "
                  f"{csr_tiling['k']} slots/receiver")
        elif len(csr_tiling) == 2:
            print(f">>> fused aggregation: CSR (v2) kernels, "
                  f"tiling {csr_tiling}")
        else:
            print(f">>> fused aggregation: windowed (v3) kernels, "
                  f"tiling {csr_tiling}")
        halo_partition_from_configs(training_config.mesh_axes, device)
        data_loaders, dataset_config_dict = get_data_loaders(
            ["train", "validate"], path_to_graph_data,
            training_config.batch_size, training_config.shuffle,
            bg_index=training_config.bg_index, seed=training_config.seed,
            csr_tiling=csr_tiling, device=device)

        print(">>> creating model")
        model = DetNet(model_config, device=device, seed=seed)

        print(">>> starting training")
        trainer = Trainer(training_config, model)
        ckpt_dir = os.path.join(path_to_results, "_checkpoint") \
            if training_config.checkpoint_every_epochs else None
        resume_from = ckpt_dir if (resume and ckpt_dir and os.path.exists(
            os.path.join(ckpt_dir, "meta.json"))) else None
        if resume_from:
            print(f">>> resuming from {resume_from}")
        trainer.fit(data_loaders, resume_from=resume_from,
                    checkpoint_dir=ckpt_dir)

        trainer.save_results(path_to_results, model_config,
                             dataset_config_dict)
    finally:
        torch.use_deterministic_algorithms(was_deterministic)


def cli(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--data", type=str, required=True)
    parser.add_argument("--results", type=str, required=True)
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--resume", action="store_true",
                        help="resume from the _checkpoint folder if present")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the CUDA card)")
    args = parser.parse_args(argv)
    if not os.path.isdir(args.data):
        raise SystemExit("Invalid path for graph data folder")
    if not os.path.isdir(args.results):
        raise SystemExit("Invalid path for results folder")
    if not os.path.isfile(args.config):
        raise SystemExit("Invalid path to config file")
    main(args.data, args.results, args.config, resume=args.resume,
         device=args.device)


if __name__ == "__main__":
    cli()
