"""nuScenes evaluator: the submission writer, the official-protocol
detection metrics (mAP, NDS) and the shared mAP / F1 / confusion metrics.

Port of `radargnn_tpu/data/nuscenes/evaluation.py`. The detection metrics
come from the nuScenes devkit's `DetectionEval` where the devkit imports,
else from the native protocol (`detection_eval`). The mAP engine's box IoU
runs on `device` (None: the card), as in `RadarscenesEvaluator`.
`confusion.png` is drawn by the port's own figure code.
"""

from __future__ import annotations

import json
import os
from dataclasses import asdict
from typing import List

import numpy as np

from radargnn_tpu_torch.configs import PostProcessingConfiguration
from radargnn_tpu_torch.data.nuscenes.db import NuScenes
from radargnn_tpu_torch.data.nuscenes.detection_eval import (
    NuScenesDetectionEval, ground_truth_from_db,
)
from radargnn_tpu_torch.data.nuscenes.submission import (
    get_sample_token, get_submission,
)
from radargnn_tpu_torch.device import DeviceLike
from radargnn_tpu_torch.postprocess.evaluation import (
    Evaluator, get_new_evaluation_folder_path,
)
from radargnn_tpu_torch.postprocess.segmentation_metrics import (
    ObjectDetectionMetrics, SegmentationMetrics,
)
from radargnn_tpu_torch.postprocess.visualization import plot_confusion_matrix


class NuscenesEvaluator(Evaluator):
    def __init__(self, config: PostProcessingConfiguration, version: str,
                 dataset_path: str, model_path: str, *args,
                 device: DeviceLike = None, **kwargs):
        self.device = device
        self.version = version
        self.path_to_nuscenes = dataset_path
        self.path_to_model_folder = model_path
        self.evaluation_folder_path = get_new_evaluation_folder_path(model_path)
        self.mAP = None
        self.mAP_per_class = None
        self.metrics_summary = None
        self.f1_segmentation = None
        self.f1_class_averaging = (None if config.f1_class_averaging == "None"
                                   else config.f1_class_averaging)
        self.confusion_absolute = None
        self.confusion_relative = None

        super().__init__(config, *args, **kwargs)
        os.makedirs(self.evaluation_folder_path)

    def evaluate(self, bb_pred, bb_ground_truth, cls_pred, cls_pred_label,
                 cls_ground_truth, vel, graph_names: List[str],
                 *args, **kwargs) -> None:
        nusc = NuScenes(version=self.version, dataroot=self.path_to_nuscenes,
                        verbose=False)

        submission = get_submission(nusc, bb_pred, vel, graph_names)
        submission_path = os.path.join(self.evaluation_folder_path,
                                       "submission.json")
        with open(submission_path, "w") as f:
            json.dump(submission, f, indent=4)

        sample_tokens = [get_sample_token(n) for n in graph_names]
        self.metrics_summary = self._run_detection_eval(
            nusc, submission, submission_path, sample_tokens)

        if self.config.get_mAP:
            res = ObjectDetectionMetrics.get_map(
                self.config, bb_pred, bb_ground_truth, cls_pred, self.device)
            self.mAP = float(res["map"])
            self.mAP_per_class = np.asarray(res["map_per_class"])

        seg = SegmentationMetrics(cls_pred_label, cls_ground_truth)
        if self.config.get_segmentation_f1:
            self.f1_segmentation = seg.get_f1(len(self.names),
                                              self.f1_class_averaging)
        if self.config.get_confusion:
            self.confusion_absolute = seg.get_confusion_matrix(len(self.names))
            sums = self.confusion_absolute.astype(float).sum(axis=1).reshape(-1, 1)
            sums[sums == 0] = 1e-8
            self.confusion_relative = self.confusion_absolute / sums

    def _run_detection_eval(self, nusc, submission, submission_path,
                            sample_tokens):
        try:
            from nuscenes.eval.detection.evaluate import DetectionEval  # type: ignore
            from nuscenes.eval.common.config import config_factory  # type: ignore

            eval_set = {"v1.0-trainval": "val",
                        "v1.0-mini": "mini_val"}.get(self.version)
            if eval_set is None:
                raise ValueError("Version must be either trainval or mini!")
            nusc_eval = DetectionEval(
                nusc, config=config_factory("detection_cvpr_2019"),
                result_path=submission_path, eval_set=eval_set,
                output_dir=self.evaluation_folder_path, verbose=True)
            metrics, _ = nusc_eval.evaluate()
            return metrics.serialize()
        except ImportError:
            gt, ego = ground_truth_from_db(nusc, sample_tokens)
            return NuScenesDetectionEval(submission, gt, ego).evaluate()

    def save_results(self, *args, **kwargs):
        folder = self.evaluation_folder_path
        with open(f"{folder}/eval_configs.json", "w") as f:
            json.dump({"EVALUATION_CONFIG": asdict(self.config)}, f, indent=4)

        if self.metrics_summary:
            with open(f"{folder}/nuscenes_metrics.json", "w") as f:
                json.dump(self.metrics_summary, f, indent=4)

        detection_results = {}
        if self.config.get_mAP:
            detection_results["mAP"] = self.mAP
            detection_results["mAP_per_class"] = [
                None if np.isnan(v) else float(v) for v in self.mAP_per_class]

        segmentation_results = {}
        if self.config.get_segmentation_f1:
            f1 = self.f1_segmentation
            segmentation_results["f1"] = (f1.tolist()
                                          if isinstance(f1, np.ndarray) else f1)

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
