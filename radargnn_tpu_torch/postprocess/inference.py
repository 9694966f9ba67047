"""Predictor: batched inference over an evaluation loader.

Port of `radargnn_tpu/postprocess/inference.py`: the forward + softmax run on
the device, only the per-graph unpadding happens on the host.

Faithful quirk: the reference never switches the model to eval mode, so
BatchNorm uses batch statistics during inference (`use_batch_stats=True`,
the default). Like the JAX Predictor, which drops the updated batch_stats,
this one leaves the model's running statistics as they were.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch

from radargnn_tpu_torch.graph.batch import GraphBatch


class Predictor:
    """Runs `model` (a DetNet) over `dataloader`, an iterable of GraphBatches
    on the model's device."""

    def __init__(self, model, dataloader: Iterable[GraphBatch],
                 verbose: bool = True, use_batch_stats: bool = True):
        self.model = model
        self.dataloader = dataloader
        self.verbose = verbose
        self.use_batch_stats = use_batch_stats

    @torch.no_grad()
    def forward(self, batch: GraphBatch) -> Tuple[torch.Tensor, torch.Tensor]:
        """Class probabilities [G·N, C] and boxes [G·N, B] for one batch.
        Under no_grad, batch statistics leave the running ones untouched
        (models.mlp.MaskedBatchNorm)."""
        model = self.model
        was_training = model.training
        model.train(self.use_batch_stats)
        try:
            cls, bb = model.forward_batch(batch)
        finally:
            model.train(was_training)
        return torch.softmax(cls, dim=1), bb

    def predict(self) -> Tuple[Dict, Dict, List, List]:
        """Returns (predictions, ground_truth, pos, vel): per-graph numpy
        lists with padding stripped, matching the reference structure."""
        pos, vel = [], []
        predictions = {"bounding_box_predictions": [],
                       "class_probability_prediction": []}
        ground_truth = {"bounding_box_true": [], "class_true": []}

        num_batches = len(self.dataloader)
        for i, batch in enumerate(self.dataloader):
            cls_prob, bb = self.forward(batch)
            g, n = batch.node_mask.shape
            cls_prob = cls_prob.reshape(g, n, -1).cpu().numpy()
            bb = bb.reshape(g, n, -1).cpu().numpy()
            mask = batch.node_mask.cpu().numpy()
            b_pos = batch.pos.cpu().numpy()
            b_vel = batch.vel.cpu().numpy()
            b_labels = batch.labels.cpu().numpy()
            b_boxes = batch.boxes.cpu().numpy()

            for gi in range(g):
                m = mask[gi]
                if not m.any():
                    continue        # graph-count padding
                pos.append(b_pos[gi][m].astype(np.float64))
                vel.append(b_vel[gi][m].astype(np.float64))
                ground_truth["class_true"].append(
                    b_labels[gi][m].astype(np.float64))
                ground_truth["bounding_box_true"].append(
                    b_boxes[gi][m].astype(np.float64))
                predictions["bounding_box_predictions"].append(
                    bb[gi][m].astype(np.float64))
                predictions["class_probability_prediction"].append(
                    cls_prob[gi][m].astype(np.float64))

            if self.verbose and ((i + 1) == 1 or (i + 1) % 10 == 0
                                 or (i + 1) == num_batches):
                print(f"{i + 1}/{num_batches} inference batches finished")

        return predictions, ground_truth, pos, vel
