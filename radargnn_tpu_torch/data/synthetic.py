"""Synthetic radar-frame generator for tests, benchmarks and smoke runs.

Port of `radargnn_tpu/data/synthetic.py` (numpy, unchanged): point clouds
that mimic RadarScenes statistics (background clutter + a few object
clusters with coherent velocity), run through the host graph pipeline (kNN
+ invariant features + GT boxes) into `GraphSample`s. The same seed gives
the same samples as the JAX package.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from radargnn_tpu_torch.configs import GraphConstructionConfiguration
from radargnn_tpu_torch.graph.batch import GraphSample
from radargnn_tpu_torch.graph.build import build_geometric_graph
from radargnn_tpu_torch.data.ground_truth import create_2d_bounding_boxes

DEFAULT_GRAPH_CONFIG = GraphConstructionConfiguration(
    graph_construction_algorithm="knn",
    graph_construction_settings={"k": 20, "r": 1.0},
    node_features=["rcs", "velocity_vector", "time_index", "degree"],
    edge_features=["relative_position"],
    edge_mode="directed",
    distance_definition="X",
)

# Non-invariant configuration: bb_invariance="none" regresses ABSOLUTE box
# centers, which is only learnable when the nodes carry their absolute
# position ("spatial_coordinates", the reference's non-invariant node
# feature).
NONE_INVARIANCE_GRAPH_CONFIG = GraphConstructionConfiguration(
    graph_construction_algorithm="knn",
    graph_construction_settings={"k": 20, "r": 1.0},
    node_features=["rcs", "velocity_vector", "spatial_coordinates",
                   "time_index", "degree"],
    edge_features=["relative_position"],
    edge_mode="directed",
    distance_definition="X",
)


# RadarScenes object-class frequency profile (utils.properties
# ClassDistribution.get_radar_point_dict, radar-point counts): car /
# pedestrian / pedestrian_group / two_wheeler / large_vehicle shares of all
# OBJECT points, plus the object-vs-background point fraction (~3.6%)
RADARSCENES_CLASS_PROBS = np.array([2.1e6, 5.1e5, 1.1e6, 2.7e5, 9.0e5])
RADARSCENES_CLASS_PROBS = RADARSCENES_CLASS_PROBS / RADARSCENES_CLASS_PROBS.sum()
RADARSCENES_OBJECT_FRACTION = 4.89e6 / (4.89e6 + 1.3e8)


def synthetic_frame(rng: np.random.Generator, num_points: int = 1000,
                    num_objects: int = 6, num_classes: int = 5,
                    bg_index: int = 5, extent: float = 80.0,
                    object_fraction: float = 0.15,
                    class_probs: Optional[np.ndarray] = None):
    """One frame: (pos, vel, rcs, timestamps, labels, track_ids).

    `object_fraction` / `class_probs` default to the mild, near-balanced
    profile used by the throughput benches; pass
    RADARSCENES_OBJECT_FRACTION / RADARSCENES_CLASS_PROBS for a frame whose
    class imbalance matches the real dataset's radar-point statistics
    (~96% background, car-dominated objects)."""
    # at least 2 points per object, but never more than the frame holds
    n_obj_pts = min(max(int(num_points * object_fraction),
                        2 * num_objects), num_points)
    n_bg = num_points - n_obj_pts

    pos = np.empty((num_points, 2))
    vel = np.zeros((num_points, 2))
    labels = np.full((num_points,), bg_index, dtype=np.int64)
    track_ids = np.full((num_points,), b"", dtype=object)

    pos[:n_bg, 0] = rng.uniform(0, extent, n_bg)
    pos[:n_bg, 1] = rng.uniform(-extent / 2, extent / 2, n_bg)

    start = n_bg
    sizes = np.maximum(rng.multinomial(
        n_obj_pts, np.ones(num_objects) / num_objects), 2)
    sizes[-1] = max(2, n_obj_pts - sizes[:-1].sum())
    for obj in range(num_objects):
        size = sizes[obj]
        end = min(start + size, num_points)
        if end <= start:
            break
        center = np.array([rng.uniform(5, extent - 5),
                           rng.uniform(-extent / 2 + 5, extent / 2 - 5)])
        heading = rng.uniform(0, 2 * np.pi)
        # class determined by geometry/kinematics so segmentation is
        # learnable: size and speed ranges per class (car, pedestrian,
        # pedestrian_group, two_wheeler, large_vehicle)
        if class_probs is None:
            cls = int(rng.integers(0, num_classes))
        else:
            cls = int(rng.choice(num_classes, p=class_probs))
        length, width, speed = {
            0: (4.5, 1.8, 10.0),   # car: large, fast
            1: (0.6, 0.6, 1.2),    # pedestrian: tiny, slow
            2: (2.5, 2.5, 1.2),    # pedestrian group: wide, slow
            3: (1.8, 0.7, 5.0),    # two-wheeler: narrow, medium
            4: (8.0, 2.5, 8.0),    # large vehicle: very large
        }[cls]
        length *= rng.uniform(0.8, 1.2)
        width *= rng.uniform(0.8, 1.2)
        speed *= rng.uniform(0.7, 1.3)
        d = np.array([np.cos(heading), np.sin(heading)])
        o = np.array([-d[1], d[0]])
        local = (rng.uniform(-0.5, 0.5, (end - start, 1)) * length * d
                 + rng.uniform(-0.5, 0.5, (end - start, 1)) * width * o)
        pos[start:end] = center + local
        vel[start:end] = speed * d + rng.normal(0, 0.2, (end - start, 2))
        labels[start:end] = cls
        track_ids[start:end] = str(obj).encode()
        start = end

    rcs = rng.normal(0, 5, (num_points, 1))
    timestamps = np.repeat(
        np.arange(4), -(-num_points // 4))[:num_points].reshape(-1, 1)
    return pos, vel, rcs, timestamps, labels, track_ids


def make_samples(num_frames: int = 8, num_points: int = 1000,
                 seed: int = 0, aligned: bool = False,
                 bb_invariance: str = "translation",
                 graph_config: Optional[GraphConstructionConfiguration] = None,
                 bg_index: int = 5,
                 imbalanced: bool = False) -> List[GraphSample]:
    """`imbalanced` generates frames with the REAL RadarScenes class
    profile (~96% background; objects car-dominated, few points each) —
    the protocol-faithful convergence proxy."""
    cfg = graph_config or (NONE_INVARIANCE_GRAPH_CONFIG
                           if bb_invariance == "none"
                           else DEFAULT_GRAPH_CONFIG)
    rng = np.random.default_rng(seed)
    frame_kw = {}
    if imbalanced:
        frame_kw = dict(object_fraction=RADARSCENES_OBJECT_FRACTION,
                        class_probs=RADARSCENES_CLASS_PROBS)
    samples = []
    for _ in range(num_frames):
        pos, vel, rcs, ts, labels, track_ids = synthetic_frame(
            rng, num_points, bg_index=bg_index, **frame_kw)
        g = build_geometric_graph(cfg, pos, vel, rcs=rcs, timestamps=ts)
        boxes = create_2d_bounding_boxes(pos, track_ids, aligned, bb_invariance)
        samples.append(GraphSample(
            node_feat=g.node_feat.astype(np.float32),
            edge_feat=g.edge_feat.astype(np.float32),
            senders=g.senders.astype(np.int32),
            receivers=g.receivers.astype(np.int32),
            labels=labels.astype(np.int32),
            boxes=boxes.astype(np.float32),
            pos=pos.astype(np.float32), vel=vel.astype(np.float32)))
    return samples
