"""CLI: the full pipeline (create dataset -> train -> evaluate). Port of
`radargnn_tpu/cli/main.py`: the next model folder is worked out up front,
so that the evaluation reads the model `train` writes.

    python -m radargnn_tpu_torch.cli.main --dataset D --results R --config C
        [--device cpu]
"""

from __future__ import annotations

import argparse
import os

from radargnn_tpu_torch.cli.create_dataset import main as create_dataset
from radargnn_tpu_torch.cli.evaluate import main as evaluate
from radargnn_tpu_torch.cli.train import main as train
from radargnn_tpu_torch.device import DeviceLike, resolve_device
from radargnn_tpu_torch.train.trainer import get_new_result_folder_path


def main(path_to_dataset: str, path_to_results: str, path_to_config: str,
         device: DeviceLike = None) -> None:
    device = resolve_device(device)
    path_to_graph_data = f"{path_to_dataset}/processed"
    path_to_model_folder = get_new_result_folder_path(path_to_results)

    print("\n============ CREATING GRAPH DATASET =============\n")
    create_dataset(path_to_dataset, path_to_config, device=device)

    print("\n================ TRAINING MODEL =================\n")
    train(path_to_graph_data, path_to_results, path_to_config, device=device)

    print("\n================ EVALUATING MODEL ===============\n")
    evaluate(path_to_dataset, path_to_model_folder, path_to_config,
             device=device)


def cli(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", type=str, required=True)
    parser.add_argument("--results", type=str, required=True)
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the CUDA card)")
    args = parser.parse_args(argv)
    if not os.path.isdir(args.dataset):
        raise SystemExit("Invalid path for dataset folder")
    if not os.path.isdir(args.results):
        raise SystemExit("Invalid path for results folder")
    if not os.path.isfile(args.config):
        raise SystemExit("Invalid path to config file")
    main(args.dataset, args.results, args.config, device=args.device)


if __name__ == "__main__":
    cli()
