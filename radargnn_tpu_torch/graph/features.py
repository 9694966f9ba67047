"""Vectorized SE(n)-invariant node / edge feature extraction (numpy, host).

Port of `radargnn_tpu/graph/features.py` for the host pipeline: one gather
plus vectorized trig over all edges at once. Semantics:
  * zero-velocity vectors stay zero after normalization (-> 90° angles via
    arccos(0)),
  * dot products are clamped to [-1, 1] before arccos,
  * coincident points give a zero connection vector,
  * all angles in degrees,
  * undirected mode takes min over ±connection per velocity, then min/max.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from radargnn_tpu_torch import native

_EDGE_FEATURE_DIMS = {
    "point_pair_features": 4,
    "spatial_euclidean_distance": 1,
    "velocity_euclidean_distance": 1,
    "relative_position": 2,
    "relative_velocity": 2,
}

_NODE_FEATURE_DIMS = {
    "rcs": 1,
    "time_index": 1,
    "degree": 1,
    "velocity_vector_length": 1,
    "velocity_vector": 2,
    "spatial_coordinates": 2,
}


def edge_feature_dimension(features: List[str]) -> int:
    return sum(_EDGE_FEATURE_DIMS[f] for f in features)


def node_feature_dimension(features: List[str]) -> int:
    return sum(_NODE_FEATURE_DIMS[f] for f in features)


def _safe_normalize(v):
    """v / ||v|| with exact-zero vectors mapped to zero."""
    norm = np.linalg.norm(v, axis=-1, keepdims=True)
    return np.where(norm == 0, np.zeros_like(v), v / np.where(norm == 0, 1.0, norm))


def _angle_deg(a_norm, b_norm):
    """Angle in degrees between pre-normalized vectors, clamped dot."""
    dot = np.sum(a_norm * b_norm, axis=-1)
    dot = np.clip(dot, -1.0, 1.0)
    return np.degrees(np.arccos(dot))


def point_pair_features(p1, p2, v1, v2, mode: str):
    """E(n)-equivariant point-pair metrics for all edges at once.

    p1, p2: [E, D] positions of sender (p1) / receiver (p2) per edge;
    v1, v2: [E, D] velocities; mode "directed" | "undirected".
    Returns [E, 4]: (distance, angle(v1,v2), theta_d_v_min, theta_d_v_max)
    in degrees (directed mode returns (theta_d_v1, theta_d_v2) under the
    min/max names, as the reference does).
    """
    v1n = _safe_normalize(v1)
    v2n = _safe_normalize(v2)

    d = np.linalg.norm(p1 - p2, axis=-1)
    theta_v1_v2 = _angle_deg(v1n, v2n)

    if mode == "directed":
        d_vec = _safe_normalize(p2 - p1)
        theta_d_v_min = _angle_deg(v1n, d_vec)
        theta_d_v_max = _angle_deg(v2n, d_vec)
    elif mode == "undirected":
        d1 = _safe_normalize(p1 - p2)
        d2 = _safe_normalize(p2 - p1)
        theta_d_v1 = np.minimum(_angle_deg(v1n, d1), _angle_deg(v1n, d2))
        theta_d_v2 = np.minimum(_angle_deg(v2n, d1), _angle_deg(v2n, d2))
        theta_d_v_min = np.minimum(theta_d_v1, theta_d_v2)
        theta_d_v_max = np.maximum(theta_d_v1, theta_d_v2)
    else:
        raise ValueError(f"Invalid edge mode '{mode}'")

    return np.stack([d, theta_v1_v2, theta_d_v_min, theta_d_v_max], axis=-1)


def edge_features(features: List[str], edge_mode: str,
                  pos, vel, senders, receivers):
    """Per-edge feature matrix [E, sum(dims)] in config order.

    pos/vel: [N, 2] node arrays; senders/receivers: [E] int edge endpoints
    (sender = the node whose neighborhood query created the edge).
    """
    p1, p2 = pos[senders], pos[receivers]
    v1, v2 = vel[senders], vel[receivers]

    cols = []
    for feature in features:
        if feature == "point_pair_features":
            if edge_mode not in ("directed", "undirected"):
                raise ValueError(f"unknown edge_mode: {edge_mode!r}")
            col = None
            if np.asarray(pos).shape[-1] == 2:
                # compiled single-pass kernel; None when it did not build
                col = native.point_pair_features_2d(
                    pos, vel, np.stack([senders, receivers], axis=-1),
                    edge_mode == "directed")
            if col is None:
                col = point_pair_features(p1, p2, v1, v2, edge_mode)
            cols.append(col)
        elif feature == "spatial_euclidean_distance":
            cols.append(np.linalg.norm(p1 - p2, axis=-1)[..., None])
        elif feature == "velocity_euclidean_distance":
            cols.append(np.linalg.norm(v1 - v2, axis=-1)[..., None])
        elif feature == "relative_position":
            rel = p1 - p2
            if edge_mode == "undirected":
                rel = np.abs(rel)
            cols.append(rel)
        elif feature == "relative_velocity":
            rel = v1 - v2
            if edge_mode == "undirected":
                rel = np.abs(rel)
            cols.append(rel)
        else:
            raise ValueError(f"Invalid edge feature '{feature}' specified")
    return np.concatenate(cols, axis=-1)


def node_degrees(senders, receivers, num_nodes: int,
                 edge_mask: Optional[np.ndarray] = None):
    """Undirected degree per node: number of distinct neighbors over the
    symmetrized adjacency (an edge in either direction counts once)."""
    ones = np.ones(np.shape(senders), dtype=bool) if edge_mask is None \
        else edge_mask
    s = np.asarray(senders)[ones].astype(np.int64)
    r = np.asarray(receivers)[ones].astype(np.int64)
    lo, hi = np.minimum(s, r), np.maximum(s, r)
    keys = np.unique(lo * num_nodes + hi)
    lo_u, hi_u = keys // num_nodes, keys % num_nodes
    deg = (np.bincount(lo_u, minlength=num_nodes)
           + np.bincount(hi_u, minlength=num_nodes))
    self_u = lo_u[lo_u == hi_u]
    if self_u.size:
        deg -= np.bincount(self_u, minlength=num_nodes)
    return deg


def node_features(features: List[str], pos, vel, inv_features: dict,
                  senders=None, receivers=None, edge_mask=None):
    """Per-node feature matrix in config order. `inv_features` holds the
    [N, 1] invariant features ("rcs", "time_index"); degree is computed on
    demand from the edges."""
    n = pos.shape[0]
    cols = []
    for feature in features:
        if feature in ("rcs", "time_index"):
            feat = np.reshape(inv_features[feature], (n, 1))
        elif feature == "degree":
            deg = node_degrees(senders, receivers, n, edge_mask)
            feat = np.reshape(deg, (n, 1))
        elif feature == "velocity_vector_length":
            feat = np.linalg.norm(vel, axis=-1)[..., None]
        elif feature == "velocity_vector":
            feat = vel
        elif feature == "spatial_coordinates":
            feat = pos
        else:
            raise ValueError(f"Invalid node feature '{feature}' specified")
        cols.append(feat)
    return np.concatenate(cols, axis=-1)


def time_index_feature(timestamps):
    """Densified time index: rank of each point's timestamp among the unique
    timestamps of the frame."""
    ts = np.reshape(timestamps, (-1,))
    uniq = np.unique(ts)
    idx = np.searchsorted(uniq, ts)
    return idx.astype(np.float64).reshape(-1, 1)
