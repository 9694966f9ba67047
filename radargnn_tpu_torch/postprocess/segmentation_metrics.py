"""Semantic-segmentation metrics: F1, confusion matrices; and the mAP call.

Port of `radargnn_tpu/postprocess/segmentation_metrics.py`. The JAX module
calls scikit-learn's `f1_score`, `confusion_matrix` and
`multilabel_confusion_matrix` with `labels=range(C)`; this one computes
the same numbers in numpy (sklearn 1.x semantics: samples whose label lies
outside the range are dropped, a class with no true and no predicted
sample scores 0.0, the "weighted" average weighs by true counts and falls
back to the plain mean when they sum to 0), so it needs no scikit-learn.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from radargnn_tpu_torch.configs import PostProcessingConfiguration
from radargnn_tpu_torch.device import DeviceLike
from radargnn_tpu_torch.postprocess.mean_ap import MeanAveragePrecision


def _class_counts(y_true: np.ndarray, y_pred: np.ndarray, num_classes: int):
    """Per class in range(num_classes): true positives, true and predicted
    counts."""
    tp = np.bincount(y_true[(y_true == y_pred) & (y_true >= 0)
                            & (y_true < num_classes)],
                     minlength=num_classes)[:num_classes]

    def count(y):
        return np.bincount(y[(y >= 0) & (y < num_classes)],
                           minlength=num_classes)[:num_classes]

    return tp, count(y_true), count(y_pred)


def f1_score(y_true, y_pred, num_classes: int, average: Optional[str]):
    """sklearn's `f1_score(y_true, y_pred, labels=range(num_classes),
    average=average)` for `average` None (per-class array), "micro",
    "macro" or "weighted"."""
    y_true = np.asarray(y_true, np.int64).reshape(-1)
    y_pred = np.asarray(y_pred, np.int64).reshape(-1)
    tp, true_sum, pred_sum = _class_counts(y_true, y_pred, num_classes)
    if average == "micro":
        tp, true_sum, pred_sum = (np.asarray([v.sum()])
                                  for v in (tp, true_sum, pred_sum))
    elif average not in (None, "macro", "weighted"):
        raise ValueError(f"average has to be one of (None, 'micro', "
                         f"'macro', 'weighted'), not {average!r}")
    denom = (true_sum + pred_sum).astype(np.float64)
    empty = denom == 0
    f1 = 2.0 * tp.astype(np.float64) / np.where(empty, 1.0, denom)
    f1[empty] = 0.0
    if average is None:
        return f1
    if average == "weighted" and true_sum.sum() > 0:
        return float(np.average(f1, weights=true_sum))
    return float(np.mean(f1))


def confusion_matrix(y_true, y_pred, num_classes: int) -> np.ndarray:
    """sklearn's `confusion_matrix(y_true, y_pred,
    labels=range(num_classes))`: [C, C] int64 counts, rows true."""
    y_true = np.asarray(y_true, np.int64).reshape(-1)
    y_pred = np.asarray(y_pred, np.int64).reshape(-1)
    if y_true.size == 0:
        return np.zeros((num_classes, num_classes), np.int64)
    in_range = (y_true >= 0) & (y_true < num_classes)
    if not in_range.any():
        raise ValueError("At least one label specified must be in y_true")
    ok = in_range & (y_pred >= 0) & (y_pred < num_classes)
    return np.bincount(y_true[ok] * num_classes + y_pred[ok],
                       minlength=num_classes ** 2).reshape(num_classes,
                                                           num_classes)


def multilabel_confusion_matrix(y_true, y_pred,
                                num_classes: int) -> np.ndarray:
    """sklearn's `multilabel_confusion_matrix(y_true, y_pred,
    labels=range(num_classes))`: [C, 2, 2] of [[tn, fp], [fn, tp]] per
    class, every sample counted."""
    y_true = np.asarray(y_true, np.int64).reshape(-1)
    y_pred = np.asarray(y_pred, np.int64).reshape(-1)
    tp, true_sum, pred_sum = _class_counts(y_true, y_pred, num_classes)
    fp = pred_sum - tp
    fn = true_sum - tp
    tn = y_true.shape[0] - tp - fp - fn
    return np.stack([tn, fp, fn, tp], axis=1).reshape(-1, 2, 2)


class ObjectDetectionMetrics:
    """mAP from postprocessed predictions. Parity: `metrics.py:12-133`."""

    @staticmethod
    def _prediction_dicts(bb_pred: List) -> List[dict]:
        dicts = []
        for res in bb_pred:
            boxes = res["boxes"]
            if len(boxes) == 0:
                matrix = np.empty([0, 0])
            elif boxes.aligned:
                matrix = boxes.to_two_point()
            else:
                matrix = boxes.to_xylwt()
            dicts.append({"boxes": matrix,
                          "scores": np.asarray(res["scores"], np.float64),
                          "labels": np.asarray(res["labels"], np.int64)})
        return dicts

    @staticmethod
    def _ground_truth_dicts(bb_ground_truth: List) -> List[dict]:
        dicts = []
        for res in bb_ground_truth:
            boxes = res["boxes"]
            if len(boxes) == 0:
                matrix = np.empty([0, 0])
            elif boxes.aligned:
                matrix = boxes.to_two_point()
            else:
                matrix = boxes.to_xylwt()
            dicts.append({"boxes": matrix,
                          "labels": np.asarray(res["labels"], np.int64)})
        return dicts

    @classmethod
    def get_map(cls, eval_config: PostProcessingConfiguration, bb_pred: List,
                bb_ground_truth: List, cls_pred: List,
                device: DeviceLike = None) -> dict:
        """The mAP engine's result; its box IoU runs on `device` (None: the
        card)."""
        iou_thresholds = [eval_config.iou_for_mAP]
        pos = [d["pos"] for d in cls_pred]
        aligned = next((p["boxes"].aligned for p in bb_pred
                        if len(p["boxes"])), True)

        prediction_dicts = cls._prediction_dicts(bb_pred)
        ground_truth_dicts = cls._ground_truth_dicts(bb_ground_truth)

        if not aligned and not eval_config.use_point_iou:
            raise ValueError(
                "so far only Point-IOU based mAP calculation is possible for "
                "rotated bounding boxes, select 'use_point_iou = True' in "
                "configuration for rotated boxes")

        metric = MeanAveragePrecision(iou_thresholds, class_metrics=True,
                                      device=device)
        if eval_config.use_point_iou:
            metric.update(prediction_dicts, ground_truth_dicts, True, pos, aligned)
        else:
            metric.update(prediction_dicts, ground_truth_dicts)
        return metric.compute()


class SegmentationMetrics:
    def __init__(self, cls_pred_label: List, cls_ground_truth: List):
        self.y_true = self._ground_truth_vector(cls_ground_truth)
        self.y_pred = self._prediction_vector(cls_pred_label)

    def get_f1(self, num_classes: int, average):
        return f1_score(self.y_true, self.y_pred, num_classes, average)

    def get_confusion_matrix(self, num_classes: int) -> np.ndarray:
        return confusion_matrix(self.y_true, self.y_pred, num_classes)

    def get_confusion_matrices_per_class(self, num_classes: int) -> np.ndarray:
        return multilabel_confusion_matrix(self.y_true, self.y_pred,
                                           num_classes)

    @staticmethod
    def _prediction_vector(cls_pred_label) -> list:
        y = np.concatenate([np.asarray(c).reshape(-1, 1)
                            for c in cls_pred_label], axis=0)
        return y.astype(int).tolist()

    @staticmethod
    def _ground_truth_vector(cls_ground_truth) -> list:
        y = np.concatenate(
            [np.asarray(c["labels"]).reshape(-1, 1) for c in cls_ground_truth],
            axis=0)
        return y.astype(int).tolist()
