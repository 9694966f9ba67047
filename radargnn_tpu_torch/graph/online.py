"""Graph construction from raw padded point-cloud frames on the device.

Port of `radargnn_tpu/graph/online.py`: padded frames in, a GraphBatch out,
on the frames' device, without a dataset-creation pass. kNN or radius
edges come from `ops.knn` (a dense distance matrix and `topk`), the
invariant edge and node features from the formulas of `graph.features` in
torch, in float64 as on the host (the JAX package's are float32). The time
index is the host's dense rank of each timestamp among the frame's unique
timestamps, by a sort instead of numpy's `unique`. The degree counts
distinct neighbors over the symmetrized adjacency, a dense [N, N] matrix a
graph, as in the JAX package.

The batch carries no tiling: the fused paths tile on the host
(`graph.batch.stack_samples`).
"""

from __future__ import annotations

import functools
from typing import List, Optional

import torch

from radargnn_tpu_torch.configs import GraphConstructionConfiguration
from radargnn_tpu_torch.graph.batch import GraphBatch
from radargnn_tpu_torch.ops.knn import knn_graph, radius_graph


def time_index_device(timestamps: torch.Tensor,
                      valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dense rank of each timestamp among the frame's unique timestamps
    (float32): sort, flag value changes, sum the flags, un-sort. Padded
    entries are pushed past the last valid one, so they rank no valid one
    lower."""
    ts = timestamps.reshape(-1).to(torch.float64)
    if valid is not None:
        big = torch.where(valid, ts, -torch.inf).max() + 1.0
        ts = torch.where(valid, ts, big)
    sorted_ts, order = torch.sort(ts, stable=True)
    changed = torch.cat([torch.zeros(1, dtype=ts.dtype, device=ts.device),
                         (sorted_ts[1:] != sorted_ts[:-1]).to(ts.dtype)])
    ranks = torch.empty_like(changed).scatter_(0, order,
                                               torch.cumsum(changed, 0))
    return ranks.to(torch.float32)


def _normalize(v: torch.Tensor) -> torch.Tensor:
    """v / |v|, with exact-zero vectors mapped to zero."""
    norm = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return torch.where(norm == 0, torch.zeros_like(v),
                       v / torch.where(norm == 0, 1.0, norm))


def _angle_deg(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.rad2deg(torch.arccos((a * b).sum(-1).clamp(-1.0, 1.0)))


def point_pair_features(p1, p2, v1, v2, mode: str) -> torch.Tensor:
    """[E, 4] (distance, angle(v1, v2), two connection angles) in degrees,
    as `graph.features.point_pair_features`."""
    v1n, v2n = _normalize(v1), _normalize(v2)
    d = torch.linalg.vector_norm(p1 - p2, dim=-1)
    theta_v1_v2 = _angle_deg(v1n, v2n)
    if mode == "directed":
        d_vec = _normalize(p2 - p1)
        lo, hi = _angle_deg(v1n, d_vec), _angle_deg(v2n, d_vec)
    elif mode == "undirected":
        d1, d2 = _normalize(p1 - p2), _normalize(p2 - p1)
        t1 = torch.minimum(_angle_deg(v1n, d1), _angle_deg(v1n, d2))
        t2 = torch.minimum(_angle_deg(v2n, d1), _angle_deg(v2n, d2))
        lo, hi = torch.minimum(t1, t2), torch.maximum(t1, t2)
    else:
        raise ValueError(f"Invalid edge mode '{mode}'")
    return torch.stack([d, theta_v1_v2, lo, hi], dim=-1)


def edge_features(features: List[str], edge_mode: str, pos, vel, senders,
                  receivers) -> torch.Tensor:
    """Per-edge feature matrix [E, sum(dims)] in config order, as
    `graph.features.edge_features`."""
    p1, p2 = pos[senders], pos[receivers]
    v1, v2 = vel[senders], vel[receivers]
    cols = []
    for feature in features:
        if feature == "point_pair_features":
            cols.append(point_pair_features(p1, p2, v1, v2, edge_mode))
        elif feature == "spatial_euclidean_distance":
            cols.append(torch.linalg.vector_norm(p1 - p2, dim=-1)[:, None])
        elif feature == "velocity_euclidean_distance":
            cols.append(torch.linalg.vector_norm(v1 - v2, dim=-1)[:, None])
        elif feature in ("relative_position", "relative_velocity"):
            rel = p1 - p2 if feature == "relative_position" else v1 - v2
            cols.append(rel.abs() if edge_mode == "undirected" else rel)
        else:
            raise ValueError(f"Invalid edge feature '{feature}' specified")
    return torch.cat(cols, dim=-1)


def node_degrees(senders, receivers, num_nodes: int,
                 edge_mask: torch.Tensor) -> torch.Tensor:
    """Distinct neighbors per node over the symmetrized adjacency."""
    keys = (senders.to(torch.int64) * num_nodes + receivers)[edge_mask]
    adj = torch.zeros(num_nodes * num_nodes, dtype=torch.bool,
                      device=senders.device)
    adj[keys] = True
    adj = adj.reshape(num_nodes, num_nodes)
    return (adj | adj.T).sum(1)


def node_features(features: List[str], pos, vel, rcs, time_index, senders,
                  receivers, edge_mask) -> torch.Tensor:
    """Per-node feature matrix in config order, as
    `graph.features.node_features`."""
    n = pos.shape[0]
    cols = []
    for feature in features:
        if feature == "rcs":
            cols.append(rcs.reshape(n, 1))
        elif feature == "time_index":
            cols.append(time_index.reshape(n, 1))
        elif feature == "degree":
            cols.append(node_degrees(senders, receivers, n,
                                     edge_mask).reshape(n, 1))
        elif feature == "velocity_vector_length":
            cols.append(torch.linalg.vector_norm(vel, dim=-1)[:, None])
        elif feature == "velocity_vector":
            cols.append(vel)
        elif feature == "spatial_coordinates":
            cols.append(pos)
        else:
            raise ValueError(f"Invalid node feature '{feature}' specified")
    return torch.cat([c.to(torch.float64) for c in cols],
                     dim=-1).to(torch.float32)


def make_online_graph_builder(config: GraphConstructionConfiguration,
                              bg_index: int = 5, max_degree: int = 32):
    """`build_graph_batch_on_device` with the configuration bound."""
    return functools.partial(build_graph_batch_on_device, config,
                             bg_index=bg_index, max_degree=max_degree)


def _one_graph(config, pos, vel, rcs, ts, valid, max_degree: int):
    if config.distance_definition == "X":
        basis = pos
    elif config.distance_definition == "XV":
        basis = torch.cat([pos, vel], dim=1)
    else:
        raise ValueError(config.distance_definition)
    if config.graph_construction_algorithm == "knn":
        senders, receivers, edge_mask = knn_graph(basis, config.k, valid)
    elif config.graph_construction_algorithm == "radius":
        senders, receivers, edge_mask = radius_graph(basis, config.r,
                                                     max_degree, valid)
    else:
        raise ValueError(config.graph_construction_algorithm)
    # the features in float64, as the host computes them: an angle near 0
    # or 180 degrees is arccos near +-1, where float32 loses ~0.03 degrees
    pos, vel = pos.to(torch.float64), vel.to(torch.float64)
    e_feat = edge_features(config.edge_features, config.edge_mode, pos, vel,
                           senders, receivers)
    e_feat = torch.where(edge_mask[:, None], e_feat, 0.0)
    t_idx = time_index_device(ts, valid) \
        if "time_index" in config.node_features else None
    n_feat = node_features(config.node_features, pos, vel, rcs, t_idx,
                           senders, receivers, edge_mask)
    n_feat = torch.where(valid[:, None], n_feat, 0.0)
    return (n_feat, e_feat.to(torch.float32), senders, receivers, edge_mask)


def build_graph_batch_on_device(config: GraphConstructionConfiguration,
                                pos: torch.Tensor, vel: torch.Tensor,
                                rcs: torch.Tensor, timestamps: torch.Tensor,
                                valid: torch.Tensor,
                                labels: Optional[torch.Tensor] = None,
                                boxes: Optional[torch.Tensor] = None,
                                bg_index: int = 5,
                                max_degree: int = 32) -> GraphBatch:
    """Raw padded frames -> GraphBatch on their device.

    Leading G axis everywhere: pos [G, N, 2], vel [G, N, 2], rcs [G, N],
    timestamps [G, N], valid [G, N] bool; optional labels [G, N] and boxes
    [G, N, B] (background and NaN where not given, for inference)."""
    g, n, _ = pos.shape
    pos = pos.to(torch.float32)
    vel = vel.to(torch.float32)
    graphs = [_one_graph(config, pos[i], vel[i], rcs[i], timestamps[i],
                         valid[i], max_degree) for i in range(g)]
    n_feat, e_feat, senders, receivers, edge_mask = (
        torch.stack(parts) for parts in zip(*graphs))
    if labels is None:
        labels = torch.full((g, n), bg_index, dtype=torch.int32,
                            device=pos.device)
    labels = torch.where(valid, labels, bg_index).to(torch.int32)
    if boxes is None:
        boxes = torch.full((g, n, 5), float("nan"), dtype=torch.float32,
                           device=pos.device)
    return GraphBatch(
        node_feat=n_feat, edge_feat=e_feat, senders=senders,
        receivers=receivers, node_mask=valid, edge_mask=edge_mask,
        labels=labels, boxes=boxes.to(torch.float32), pos=pos, vel=vel,
        host_valid_edges=int(edge_mask.sum()))
