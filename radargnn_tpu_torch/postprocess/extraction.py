"""Postprocessing: raw GNN outputs → final detections + segmentation.

Port of `radargnn_tpu/postprocess/extraction.py` (numpy, vectorized): score
filtering, box decode for all three invariance encodings (1-NN recompute
for "en"), NMS (`postprocess.nms`, on the device the caller names: the card
by default), ground-truth decode and duplicate-box removal.

Boxes travel as a `BoxArray` (corner matrix + aligned flag).

One difference in arithmetic: the inverse of the orientation-angle
adaption runs in float64 here, where the JAX package, with 64-bit mode
off, rounds it through float32.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

import torch

from radargnn_tpu_torch.configs import PostProcessingConfiguration
from radargnn_tpu_torch.device import DeviceLike, resolve_device
from radargnn_tpu_torch.ops.knn import nearest_neighbor_host
from radargnn_tpu_torch.postprocess import boxes as bx
from radargnn_tpu_torch.postprocess.nms import nms_indices
from radargnn_tpu_torch.train.losses import \
    invert_bb_orientation_angle_adaption


@dataclasses.dataclass
class BoxArray:
    """A batch of absolute boxes: corners [B,4,2] + aligned flag."""

    corners: np.ndarray
    aligned: bool

    def __len__(self) -> int:
        return self.corners.shape[0]

    @property
    def is_rotated(self) -> bool:
        return not self.aligned

    def to_two_point(self) -> np.ndarray:
        """[B,4] (x_min, y_min, x_max, y_max) — torchvision-NMS format."""
        return bx.aligned_corners_to_two_point(self.corners)

    def to_xylwt(self) -> np.ndarray:
        """[B,5] (x, y, l, w, θdeg) — rotated-NMS format."""
        return bx.corners_to_xylwt(self.corners)

    def select(self, idx) -> "BoxArray":
        return BoxArray(self.corners[idx], self.aligned)

    @staticmethod
    def empty(aligned: bool) -> "BoxArray":
        return BoxArray(np.zeros((0, 4, 2)), aligned)


class PredictionExtractor:
    """Raw class probabilities / box regressions → filtered absolute boxes."""

    @staticmethod
    def get_predicted_label(class_prob: np.ndarray) -> np.ndarray:
        """argmax class per node, [N,1]. Parity: `postprocessing.py:175-183`."""
        return np.argmax(class_prob, axis=1).astype(float).reshape(-1, 1)

    @staticmethod
    def get_prediction_scores(class_prob: np.ndarray) -> np.ndarray:
        return np.max(class_prob, axis=1).reshape(-1, 1)

    @staticmethod
    def get_clutter_scores(class_prob: np.ndarray, bg_index: int) -> np.ndarray:
        return class_prob[:, bg_index].reshape(-1, 1)

    @classmethod
    def get_absolute_object_bounding_box_predictions(
            cls, class_prob: np.ndarray, bb_pred: np.ndarray, pos: np.ndarray,
            config: PostProcessingConfiguration
    ) -> Tuple[BoxArray, np.ndarray, np.ndarray]:
        """Score filtering + box decode. Parity: `postprocessing.py:198-319`."""
        labels = cls.get_predicted_label(class_prob)
        scores = cls.get_prediction_scores(class_prob)
        clutter = cls.get_clutter_scores(class_prob, config.bg_index)

        remove = (clutter[:, 0] >= config.max_score_for_background) \
            | (labels[:, 0] == config.bg_index)
        for i, min_score in enumerate(config.min_object_score.values()):
            remove |= (scores[:, 0] <= min_score) & (labels[:, 0] == i)
        keep = ~remove

        nn_pos = None
        if config.bb_invariance == "en" and pos.shape[0] > 1:
            nn_pos = pos[nearest_neighbor_host(pos)][keep]

        bb = bb_pred[keep]
        pts = pos[keep]
        box_scores = scores[keep]
        box_labels = labels[keep]

        corners = decode_boxes_to_corners(
            bb, pts, nn_pos, config.bb_invariance,
            config.adapt_orientation_angle)
        aligned = bb_pred.shape[1] == 4
        return BoxArray(corners, aligned), box_scores, box_labels

    def extract(self, predictions: Dict) -> List[np.ndarray]:
        """Per-graph argmax label lists. Parity: `postprocessing.py:321-333`."""
        return [self.get_predicted_label(cls_raw)
                for cls_raw in predictions.get("class_probability_prediction")]


def decode_boxes_to_corners(bb: np.ndarray, pts: np.ndarray,
                            nn_pos, bb_invariance: str,
                            adapt_orientation_angle: bool = False) -> np.ndarray:
    """Relative box matrix [B,4|5] → absolute corners [B,4,2], vectorized.

    Angle convention parity (`postprocessing.py:248-317`): stored angles are
    rad; rotated decodes convert to degrees; the sin-encoding is inverted
    first when `adapt_orientation_angle`.
    """
    bb = np.asarray(bb, dtype=np.float64)
    if bb.shape[0] == 0:
        return np.zeros((0, 4, 2))

    if bb.shape[1] == 4:                                     # aligned
        return bx.relative_aligned_to_absolute_corners(bb, pts)

    if bb_invariance == "en":
        boxes = bb.copy()
        boxes[:, 1] = np.rad2deg(boxes[:, 1])
        boxes[:, 4] = np.rad2deg(boxes[:, 4])
        return bx.rotation_invariant_to_absolute_corners(boxes, pts, nn_pos)

    boxes = bb.copy()
    if adapt_orientation_angle:
        boxes[:, 4] = np.rad2deg(invert_bb_orientation_angle_adaption(
            torch.from_numpy(boxes[:, 4])).numpy())
    else:
        boxes[:, 4] = np.rad2deg(boxes[:, 4])

    if bb_invariance == "translation":
        absolute = bx.relative_rotated_to_absolute(boxes, pts)
    elif bb_invariance == "none":
        absolute = boxes
    else:
        raise ValueError(f"invalid bb_invariance '{bb_invariance}'")
    return bx.corners_from_absolute(absolute)


class BoxSuppressor:
    """NMS dispatch. Parity: `postprocessing.py:336-435` (shift hack dropped:
    the IoU is translation invariant)."""

    @classmethod
    def apply_nms(cls, boxes: BoxArray, box_scores: np.ndarray,
                  box_labels: np.ndarray, iou_nms: float,
                  device: DeviceLike = None):
        """NMS on `device` (None: the card)."""
        if len(boxes) == 0:
            return boxes, box_scores, box_labels
        if boxes.is_rotated:
            matrix = boxes.to_xylwt()
        else:
            matrix = boxes.to_two_point()
        idx = nms_indices(matrix, box_scores[:, 0], iou_nms,
                          rotated=boxes.is_rotated, device=device)
        return (boxes.select(idx), box_scores[idx].reshape(-1, 1),
                box_labels[idx].reshape(-1, 1))


class GroundTruthExtractor:
    """GT decode + duplicate removal. Parity: `postprocessing.py:438-575`."""

    @staticmethod
    def get_absolute_object_bounding_boxes(class_labels: np.ndarray,
                                           bounding_boxes: np.ndarray,
                                           pos: np.ndarray, bb_invariance: str,
                                           bg_index: int):
        class_labels = np.asarray(class_labels).reshape(-1)
        keep = class_labels != bg_index

        nn_pos = None
        if bb_invariance == "en" and pos.shape[0] > 1:
            nn_pos = pos[nearest_neighbor_host(pos)][keep]

        bb = np.asarray(bounding_boxes)[keep]
        pts = pos[keep]
        labels = class_labels[keep].reshape(-1, 1)

        corners = decode_boxes_to_corners(bb, pts, nn_pos, bb_invariance,
                                          adapt_orientation_angle=False)
        aligned = bounding_boxes.shape[1] == 4
        return BoxArray(corners, aligned), labels

    @staticmethod
    def remove_duplicate_boxes(boxes: BoxArray, box_labels: np.ndarray):
        """One box per object: drop later boxes whose corner matrices are
        (near-)identical (< 0.1 summed distance). Parity: `:552-575`."""
        n = len(boxes)
        if n == 0:
            return boxes, box_labels.reshape(-1, 1)
        flat = boxes.corners.reshape(n, -1)
        diff = np.abs(flat[:, None, :] - flat[None, :, :]).sum(-1)
        same = (diff < 0.1) | np.all(flat[:, None, :] == flat[None, :, :], -1)
        earlier = np.tril(np.ones((n, n), bool), k=-1)
        dup = (same & earlier).any(axis=1)
        keep = ~dup
        return boxes.select(keep), box_labels[keep].reshape(-1, 1)


class Postprocessor:
    """Runs the stage over a batch of graphs. Parity:
    `postprocessing.py:13-162`.

    NMS runs on `device` (`device.resolve_device`: None is the card, and
    there is no fallback to the CPU)."""

    def __init__(self, device: DeviceLike = None):
        self.device = resolve_device(device)

    @staticmethod
    def process_one_raw_prediction(config: PostProcessingConfiguration,
                                   pos: np.ndarray, raw_bb_pred: np.ndarray,
                                   raw_cls_prob_pred: np.ndarray,
                                   device: DeviceLike = None):
        boxes, scores, labels = \
            PredictionExtractor.get_absolute_object_bounding_box_predictions(
                raw_cls_prob_pred, raw_bb_pred, pos, config)
        boxes, scores, labels = BoxSuppressor.apply_nms(
            boxes, scores, labels, config.iou_for_nms, device)

        object_detection_result = {
            "boxes": boxes,
            "scores": scores[:, 0] if scores.size else np.zeros((0,)),
            "labels": labels[:, 0] if labels.size else np.zeros((0,)),
        }
        semantic_segmentation_result = {
            "pos": pos,
            "labels": PredictionExtractor.get_predicted_label(raw_cls_prob_pred)[:, 0],
            "scores": PredictionExtractor.get_prediction_scores(raw_cls_prob_pred)[:, 0],
            "clutter_scores": PredictionExtractor.get_clutter_scores(
                raw_cls_prob_pred, config.bg_index)[:, 0],
        }
        return object_detection_result, semantic_segmentation_result

    @staticmethod
    def process_one_ground_truth(pos, vel, raw_bb_gt, raw_cls_gt,
                                 bb_invariance: str, bg_index: int):
        boxes, labels = GroundTruthExtractor.get_absolute_object_bounding_boxes(
            raw_cls_gt, raw_bb_gt, pos, bb_invariance, bg_index)
        boxes, labels = GroundTruthExtractor.remove_duplicate_boxes(boxes, labels)
        ground_truth_objects = {
            "boxes": boxes,
            "labels": labels[:, 0] if labels.size else np.zeros((0,)),
        }
        ground_truth_segmentation = {"pos": pos, "vel": vel,
                                     "labels": raw_cls_gt}
        return ground_truth_objects, ground_truth_segmentation

    def process(self, config: PostProcessingConfiguration, raw_pos, raw_vel,
                predictions: Dict, ground_truth: Dict):
        bb_pred, bb_ground_truth, cls_pred, cls_ground_truth = [], [], [], []

        raw_bb_pred = predictions.get("bounding_box_predictions")
        raw_cls_prob = predictions.get("class_probability_prediction")
        raw_bb_gt = ground_truth.get("bounding_box_true")
        raw_cls_gt = ground_truth.get("class_true")

        for pos_raw, bb_raw, cls_raw in zip(raw_pos, raw_bb_pred, raw_cls_prob):
            bb, seg = self.process_one_raw_prediction(
                config, pos_raw, bb_raw, cls_raw, self.device)
            bb_pred.append(bb)
            cls_pred.append(seg)

        for pos_raw, vel_raw, bb_gt_raw, cls_gt_raw in zip(
                raw_pos, raw_vel, raw_bb_gt, raw_cls_gt):
            bb_gt, cls_gt = self.process_one_ground_truth(
                pos_raw, vel_raw, bb_gt_raw, cls_gt_raw,
                config.bb_invariance, config.bg_index)
            bb_ground_truth.append(bb_gt)
            cls_ground_truth.append(cls_gt)

        return bb_pred, bb_ground_truth, cls_pred, cls_ground_truth
