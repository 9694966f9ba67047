"""Prediction / ground-truth / confusion-matrix plotting.

Port of `radargnn_tpu/postprocess/visualization.py` (parity:
`postprocessor/visualization.py:10-159` of the reference: prediction plots
with boxes, labels and scores; the confusion heatmap). The JAX package
draws these with matplotlib; the port lays the same figures out and draws
them with its own code (`postprocess.figure`), on every machine: each
function returns a figure whose `savefig(path)` writes the PNG.
"""

from __future__ import annotations

import itertools

import numpy as np

from radargnn_tpu_torch.postprocess.figure import BLUES, Figure
from radargnn_tpu_torch.utils.properties import Colors


class Visualizer:
    """Scatter plot of a point cloud colored by class label."""

    @staticmethod
    def plot_point_cloud(pos: np.ndarray, labels: np.ndarray, ax=None):
        if ax is None:
            ax = Figure().ax
        colors = [Colors.label_id_to_color.get(int(l), Colors.gray)
                  for l in np.asarray(labels).reshape(-1)]
        ax.scatter(pos[:, 0], pos[:, 1], c=colors, s=4)
        ax.axis_equal()
        return ax


class PredictionVisualizer:
    """Plots detections (corner boxes + labels + scores) over the cloud."""

    @staticmethod
    def plot_detections(detection_result: dict, segmentation_result: dict,
                        label_names=None, show_scores: bool = True):
        fig = Figure()
        ax = fig.ax
        Visualizer.plot_point_cloud(segmentation_result["pos"],
                                    segmentation_result["labels"], ax)
        boxes = detection_result["boxes"]
        scores = np.asarray(detection_result.get("scores", []))
        labels = np.asarray(detection_result.get("labels", []))
        for i in range(len(boxes)):
            corners = boxes.corners[i]
            order = [0, 1, 2, 3, 0]
            ax.plot(corners[order, 0], corners[order, 1], color="black", lw=1)
            if show_scores and scores.size:
                name = (label_names[int(labels[i])] if label_names
                        else str(int(labels[i])))
                ax.text(corners[:, 0].mean(), corners[:, 1].max() + 0.3,
                        f"{name} {scores[i]:.2f}", fontsize=6)
        return fig, ax


def plot_graph(pos: np.ndarray, senders: np.ndarray, receivers: np.ndarray,
               vel: np.ndarray = None, node_size: float = 8,
               vec_scale: float = 10):
    """Plots a geometric graph at its spatial coordinates (edges as segments,
    optional velocity quiver). Parity: `GeometricGraph.show`
    (`graph_constructor/graph.py:277-302` of the reference)."""
    fig = Figure()
    ax = fig.ax
    segs = np.stack([pos[senders], pos[receivers]], axis=1)
    ax.add_segments(segs, color="gray", linewidth=0.4)
    ax.scatter(pos[:, 0], pos[:, 1], s=node_size, c=Colors.blue, zorder=2)
    if vel is not None:
        ax.quiver(pos[:, 0], pos[:, 1], vel[:, 0], vel[:, 1],
                  scale=vec_scale, color="red")
    ax.axis_equal()
    return fig, ax


def plot_confusion_matrix(cm: np.ndarray, class_names, normalize: bool = False):
    """Confusion-matrix heatmap. Parity: `visualization.py` confusion plot."""
    if normalize:
        sums = cm.sum(axis=1, keepdims=True).astype(float)
        sums[sums == 0] = 1e-8
        cm = cm / sums

    fig = Figure(figsize=(6, 6))
    ax = fig.ax
    im = ax.imshow(cm, cmap=BLUES)
    fig.colorbar(im)
    ticks = np.arange(len(class_names))
    ax.set_xticks(ticks, class_names, rotation=45, ha="right")
    ax.set_yticks(ticks, class_names)

    thresh = cm.max() / 2.0 if cm.size else 0.5
    for i, j in itertools.product(range(cm.shape[0]), range(cm.shape[1])):
        ax.text(j, i, format(cm[i, j]), ha="center", va="center",
                color="white" if cm[i, j] > thresh else "black", fontsize=7)
    ax.set_ylabel("True label")
    ax.set_xlabel("Predicted label")
    fig.tight_layout()
    return fig
