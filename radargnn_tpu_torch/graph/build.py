"""Host-side geometric-graph construction for dataset creation.

Port of `radargnn_tpu/graph/build.py`: kNN/radius edge building, invariant
edge features in one shot, node-feature assembly (numpy).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from radargnn_tpu_torch.configs import GraphConstructionConfiguration
from radargnn_tpu_torch.graph import features as F
from radargnn_tpu_torch.ops.knn import knn_edges_host, radius_edges_host


@dataclasses.dataclass
class GeometricGraphArrays:
    """Result of host graph construction (un-padded, numpy)."""

    node_feat: np.ndarray      # [n, Dn]
    edge_feat: np.ndarray      # [e, De]
    edges: np.ndarray          # [e, 2]  (sender, receiver)
    pos: np.ndarray            # [n, 2]
    vel: np.ndarray            # [n, 2]

    @property
    def senders(self) -> np.ndarray:
        return self.edges[:, 0]

    @property
    def receivers(self) -> np.ndarray:
        return self.edges[:, 1]


def build_edges(distance_basis: np.ndarray, algorithm: str,
                k: Optional[int] = None, r: Optional[float] = None) -> np.ndarray:
    """kNN or radius edge list (sender, receiver) in sklearn order."""
    if distance_basis.shape[0] <= 1:
        return np.zeros((0, 2), dtype=np.int64)
    if algorithm == "knn":
        return knn_edges_host(distance_basis, k)
    if algorithm == "radius":
        return radius_edges_host(distance_basis, r)
    raise ValueError(f"Invalid graph construction algorithm '{algorithm}'")


def build_geometric_graph(config: GraphConstructionConfiguration,
                          pos: np.ndarray, vel: np.ndarray,
                          rcs: Optional[np.ndarray] = None,
                          timestamps: Optional[np.ndarray] = None
                          ) -> GeometricGraphArrays:
    """Builds edges + node/edge features for one point-cloud frame: distance
    basis "X" (position) or "XV" (position ‖ velocity), time-index
    densification, then edge and node features in config order."""
    pos = np.asarray(pos, dtype=np.float64)
    vel = np.asarray(vel, dtype=np.float64)

    if config.distance_definition == "X":
        basis = pos
    elif config.distance_definition == "XV":
        basis = np.concatenate([pos, vel], axis=1)
    else:
        raise ValueError(f"Invalid distance definition '{config.distance_definition}'")

    inv = {}
    if rcs is not None:
        inv["rcs"] = np.reshape(np.asarray(rcs, dtype=np.float64), (-1, 1))
    if "time_index" in config.node_features:
        if timestamps is None:
            raise ValueError("time_index requested but no timestamps given")
        inv["time_index"] = F.time_index_feature(timestamps)

    edges = build_edges(basis, config.graph_construction_algorithm,
                        k=config.k, r=config.r)
    senders = edges[:, 0]
    receivers = edges[:, 1]

    e_feat = F.edge_features(config.edge_features, config.edge_mode,
                             pos, vel, senders, receivers)
    n_feat = F.node_features(config.node_features, pos, vel, inv,
                             senders, receivers)

    return GeometricGraphArrays(node_feat=n_feat, edge_feat=e_feat,
                                edges=edges, pos=pos, vel=vel)
