"""Evaluators: metric computation + numbered result folders.

Port of `radargnn_tpu/postprocess/evaluation.py` (parity:
`postprocessor/evaluation.py:8-61`, the abstract Evaluator and the folder
numbering, and `postprocessor/radarscenes/evaluation.py:12-97` of the
reference); the nuScenes evaluator is `data.nuscenes.evaluation`.

`save_results` writes the JAX package's artifacts, `confusion.png` among
them, drawn by the port's own figure code (`postprocess.visualization`).
"""

from __future__ import annotations

import abc
import glob
import json
import os
from dataclasses import asdict

import numpy as np

from radargnn_tpu_torch.configs import PostProcessingConfiguration
from radargnn_tpu_torch.device import DeviceLike
from radargnn_tpu_torch.postprocess.segmentation_metrics import (
    ObjectDetectionMetrics, SegmentationMetrics,
)
from radargnn_tpu_torch.postprocess.visualization import plot_confusion_matrix


class Evaluator(abc.ABC):
    def __init__(self, config: PostProcessingConfiguration, *args, **kwargs):
        self.config = config
        self.names = list(self.config.min_object_score.keys())
        self.names.insert(self.config.bg_index, "background")

    @abc.abstractmethod
    def evaluate(self, *args, **kwargs) -> None:
        ...

    @abc.abstractmethod
    def save_results(self, path_to_model_folder: str, *args, **kwargs) -> None:
        ...


def get_new_evaluation_folder_path(path: str) -> str:
    """evaluation_NN numbered folders. Parity: `evaluation.py:23-61`."""
    folders = glob.glob(path + "/*/")
    numbers = []
    for folder in folders:
        tail = folder.split("_")[-1][:-1]
        try:
            numbers.append(int(tail))
        except ValueError:
            pass
    next_number = (max(numbers) + 1) if numbers else 1
    return f"{path}/evaluation_{next_number:02d}"


class RadarscenesEvaluator(Evaluator):
    """mAP + F1 + confusion; eval_configs/eval_results artifacts. The mAP
    engine's box IoU runs on `device` (None: the card)."""

    def __init__(self, config: PostProcessingConfiguration, *args,
                 device: DeviceLike = None, **kwargs):
        self.device = device
        self.mAP = None
        self.mAP_per_class = None
        self.f1_segmentation = None
        self.confusion_absolute = None
        self.confusion_relative = None
        super().__init__(config, *args, **kwargs)

    def evaluate(self, bb_pred, bb_ground_truth, cls_pred, cls_pred_label,
                 cls_ground_truth, *args, **kwargs) -> None:
        if self.config.get_mAP:
            res = ObjectDetectionMetrics.get_map(
                self.config, bb_pred, bb_ground_truth, cls_pred, self.device)
            self.mAP = float(res["map"])
            self.mAP_per_class = np.asarray(res["map_per_class"])

        seg = SegmentationMetrics(cls_pred_label, cls_ground_truth)
        if self.config.get_segmentation_f1:
            self.f1_segmentation = seg.get_f1(
                len(self.names), self.config.f1_class_averaging)

        if self.config.get_confusion:
            self.confusion_absolute = seg.get_confusion_matrix(len(self.names))
            sums = self.confusion_absolute.astype(float).sum(axis=1).reshape(-1, 1)
            sums[sums == 0] = 1e-8
            self.confusion_relative = self.confusion_absolute / sums

    def save_results(self, path_to_model_folder, *args, **kwargs):
        folder = get_new_evaluation_folder_path(path_to_model_folder)
        os.makedirs(folder)

        with open(f"{folder}/eval_configs.json", "w") as f:
            json.dump({"EVALUATION_CONFIG": asdict(self.config)}, f, indent=4)

        detection_results = {}
        if self.config.get_mAP:
            detection_results["mAP"] = self.mAP
            detection_results["mAP_per_class"] = [
                None if np.isnan(v) else float(v) for v in self.mAP_per_class]

        segmentation_results = {}
        if self.config.get_segmentation_f1:
            f1 = self.f1_segmentation
            segmentation_results["f1"] = (
                f1.tolist() if isinstance(f1, np.ndarray) else f1)

        with open(f"{folder}/eval_results.json", "w") as f:
            json.dump({"OBJECT_DETECTION_METRICS": detection_results,
                       "SEMANTIC_SEGMENTATION_METRICS": segmentation_results},
                      f, indent=4)

        if self.config.get_confusion:
            with open(f"{folder}/confusion_abs.npy", "wb") as f:
                np.save(f, self.confusion_absolute)
            with open(f"{folder}/confusion_rel.npy", "wb") as f:
                np.save(f, self.confusion_relative)
            conf_perc = np.round(self.confusion_relative * 100, 2)
            fig = plot_confusion_matrix(conf_perc, self.names,
                                        normalize=False)
            fig.savefig(f"{folder}/confusion.png")
        return folder


def evaluation_selector(dataset: str):
    """Dataset-name → evaluator class. Parity: `postprocessor/__init__.py:8-11`."""
    if dataset == "radarscenes":
        return RadarscenesEvaluator
    if dataset == "nuscenes":
        from radargnn_tpu_torch.data.nuscenes.evaluation import (
            NuscenesEvaluator,
        )
        return NuscenesEvaluator
    raise KeyError(dataset)
