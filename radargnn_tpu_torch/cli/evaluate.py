"""CLI: model evaluation. Port of `radargnn_tpu/cli/evaluate.py`.

    python -m radargnn_tpu_torch.cli.evaluate --data D --model M --config C
        [--batch-size 8] [--plot N] [--device cpu]

The model is rebuilt from the folder's `gnn_configs.json` and
`trained_model.msgpack` (flax's variable tree, which `weights` maps onto
the port's parameters), so a model folder written by either package
evaluates in the port. The fused tiling follows MODEL_ARCHITECTURE as in
the train CLI; the forward, NMS and the mAP engine's IoU run on the device.
"""

from __future__ import annotations

import argparse
import glob
import importlib.util
import json
import os
from typing import Dict

from radargnn_tpu_torch import weights
from radargnn_tpu_torch.cli.train import resolve_tiling
from radargnn_tpu_torch.configs import (
    GNNArchitectureConfig, UserConfigurationReader, dataclass_from_dict,
)
from radargnn_tpu_torch.data.loader import get_data_loaders
from radargnn_tpu_torch.device import DeviceLike, resolve_device
from radargnn_tpu_torch.models.detnet import DetNet
from radargnn_tpu_torch.postprocess.evaluation import evaluation_selector
from radargnn_tpu_torch.postprocess.extraction import (
    Postprocessor, PredictionExtractor,
)
from radargnn_tpu_torch.postprocess.inference import Predictor
from radargnn_tpu_torch.train import checkpoint as ckpt


def load_model(path_to_model_folder: str,
               device: DeviceLike = None) -> DetNet:
    """A DetNet on `device` from gnn_configs.json + trained_model.msgpack."""
    with open(os.path.join(path_to_model_folder, "gnn_configs.json")) as f:
        configs = json.load(f)
    model_config = dataclass_from_dict(
        GNNArchitectureConfig, configs["GNN_ARCHITECTURE_CONFIG"])
    variables = ckpt.load_variables(
        os.path.join(path_to_model_folder, "trained_model.msgpack"))
    model = DetNet(model_config, device=device)
    model.load_state_dict(weights.from_jax_variables(variables))
    return model


def main(path_to_data: str, path_to_model_folder: str,
         path_to_config: str, batch_size: int = 8,
         plot_predictions: int = 0, device: DeviceLike = None) -> Dict:
    """Evaluates the model folder on the configured split and writes the
    next `evaluation_NN` folder into it. Returns the predictions, the
    evaluator and that folder."""
    device = resolve_device(device)
    path_to_raw_data = os.path.join(path_to_data, "raw")
    path_to_graph_data = os.path.join(path_to_data, "processed")

    config_dict = UserConfigurationReader.read_config_file(path_to_config)
    config = UserConfigurationReader.get_config_object(
        "POSTPROCESSING", config_dict)

    dataset = config_dict["CREATE_DATASET"].get("dataset")
    version = config_dict["CREATE_DATASET"]["DATASET_PROCESSING"].get("version")

    graph_names = sorted(
        glob.glob(f"{path_to_graph_data}/{config.split}/*.npz"))

    model_config = UserConfigurationReader.get_config_object(
        "MODEL_ARCHITECTURE", config_dict)
    csr_tiling = resolve_tiling(model_config, config_dict)

    eval_loaders, _ = get_data_loaders(
        [config.split], path_to_graph_data, batch_size=batch_size,
        shuffle=False, bg_index=config.bg_index, csr_tiling=csr_tiling,
        device=device)
    eval_loader = eval_loaders[config.split]

    model = load_model(path_to_model_folder, device)

    predictor = Predictor(model, eval_loader)
    predictions, ground_truth, pos, vel = predictor.predict()

    post_processor = Postprocessor(device)
    bb_pred, bb_ground_truth, cls_pred, cls_ground_truth = \
        post_processor.process(config, pos, vel, predictions, ground_truth)

    cls_pred_label = PredictionExtractor().extract(predictions)

    EvaluatorCls = evaluation_selector(dataset)
    evaluator = EvaluatorCls(config=config, version=version,
                             dataset_path=path_to_raw_data,
                             model_path=path_to_model_folder, device=device)
    evaluator.evaluate(bb_pred, bb_ground_truth, cls_pred, cls_pred_label,
                       cls_ground_truth, vel, graph_names=graph_names)
    eval_folder = evaluator.save_results(path_to_model_folder)

    if plot_predictions and eval_folder:
        if importlib.util.find_spec("matplotlib") is None:
            print(f"{eval_folder}/prediction_*.png not drawn: matplotlib is "
                  "not installed")
        else:
            from radargnn_tpu_torch.postprocess.visualization import (
                PredictionVisualizer,
            )
            names = list(config.min_object_score.keys())
            names.insert(config.bg_index, "background")
            for i in range(min(plot_predictions, len(bb_pred))):
                fig, _ = PredictionVisualizer.plot_detections(
                    bb_pred[i], cls_pred[i], label_names=names)
                fig.savefig(os.path.join(eval_folder,
                                         f"prediction_{i:03d}.png"))
    return {"predictions": predictions, "evaluator": evaluator,
            "eval_folder": eval_folder}


def cli(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--data", type=str, required=True)
    parser.add_argument("--model", type=str, required=True)
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--plot", type=int, default=0,
                        help="save prediction plots for the first N graphs")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the CUDA card)")
    args = parser.parse_args(argv)
    if not os.path.isdir(args.data):
        raise SystemExit("Invalid path for graph data folder")
    if not os.path.isdir(args.model):
        raise SystemExit("Invalid path for model folder")
    if not os.path.isfile(args.config):
        raise SystemExit("Invalid path to config file")
    main(args.data, args.model, args.config, args.batch_size, args.plot,
         device=args.device)


if __name__ == "__main__":
    cli()
