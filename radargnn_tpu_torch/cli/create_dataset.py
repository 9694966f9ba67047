"""CLI: graph-dataset creation. Port of `radargnn_tpu/cli/create_dataset.py`.

    python -m radargnn_tpu_torch.cli.create_dataset --dataset D --config C
        [--device cpu]

The graphs are made on the host (numpy); like every entry point of the
port it expects the CUDA card unless `--device` names another device.
"""

from __future__ import annotations

import argparse
import os

from radargnn_tpu_torch.configs import UserConfigurationReader
from radargnn_tpu_torch.device import DeviceLike, resolve_device
from radargnn_tpu_torch.train.trainer import set_seeds


def dataset_selector(dataset: str):
    if dataset == "radarscenes":
        from radargnn_tpu_torch.data.radarscenes.dataset_creation import (
            RadarScenesGraphDataset,
        )
        return RadarScenesGraphDataset
    if dataset == "nuscenes":
        from radargnn_tpu_torch.data.nuscenes.dataset_creation import (
            NuScenesGraphDataset,
        )
        return NuScenesGraphDataset
    raise KeyError(dataset)


def main(path_to_dataset: str, path_to_config: str,
         device: DeviceLike = None) -> None:
    resolve_device(device)
    config_dict = UserConfigurationReader.read_config_file(path_to_config)
    dataset_config = UserConfigurationReader.get_config_object(
        "DATASET_PROCESSING", config_dict)
    graph_config = UserConfigurationReader.get_config_object(
        "GRAPH_CONSTRUCTION", config_dict)

    if dataset_config.deterministic:
        set_seeds(dataset_config.seed)

    dataset = config_dict["CREATE_DATASET"]["dataset"]
    GraphDataset = dataset_selector(dataset)
    GraphDataset(path_to_dataset, graph_config, dataset_config)


def cli(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", type=str, required=True)
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the CUDA card)")
    args = parser.parse_args(argv)
    if not os.path.isdir(args.dataset):
        raise SystemExit("Invalid path for dataset folder")
    if not os.path.isfile(args.config):
        raise SystemExit("Invalid path to config file")
    main(args.dataset, args.config, device=args.device)


if __name__ == "__main__":
    cli()
