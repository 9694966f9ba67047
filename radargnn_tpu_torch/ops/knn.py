"""Graph construction: kNN / radius edges and 1-NN, on the device and on
the host.

Port of `radargnn_tpu/ops/knn.py`. An edge (s, r) means r is one of the k
nearest neighbors of s; messages flow s -> r and aggregate at the receiver
r.

The device functions (`knn_graph`, `radius_graph`, `nearest_neighbor`)
take one padded frame as a torch tensor with a validity mask and give
fixed-size edge arrays with an edge mask, on the frame's device: a dense
[N, N] matrix of squared distances (self and invalid partners +inf), then
`topk` or the radius cut. Radar frames hold a few thousand points, so the
matrix is small. The distances are float64 sums of coordinate differences,
as the host's are, not the JAX package's float32 |a|^2 + |b|^2 - 2ab,
which cancels at frame scale: so the device picks the host's neighbors,
but where two lie at exactly one distance, `topk` may keep the other.

The host functions keep the reference's sklearn order: rows grouped by
sender, neighbors in ascending-distance order (kNN) or ascending index
(radius). The compiled helper is used when it builds; the numpy code gives
the same edges, ties included.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from radargnn_tpu_torch import native


def _pairwise_sq_dists(x: torch.Tensor,
                       valid: Optional[torch.Tensor]) -> torch.Tensor:
    """Squared euclidean distances [N, N] in float64, summed over the
    coordinates; self and invalid partners +inf."""
    x = x.to(torch.float64)
    d2 = torch.zeros(x.shape[0], x.shape[0], dtype=torch.float64,
                     device=x.device)
    for col in x.unbind(1):
        d2 += (col[:, None] - col[None, :]).square()
    d2.fill_diagonal_(float("inf"))
    if valid is not None:
        out = ~(valid[None, :] & valid[:, None])
        d2 = d2.masked_fill(out, float("inf"))
    return d2


def _nearest(d2: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest entries of each row of d2 and their columns, nearest
    first, padded with (+inf, 0) where a row has fewer than k columns."""
    n = d2.shape[0]
    kk = min(k, n)
    dist, idx = torch.topk(d2, kk, dim=1, largest=False, sorted=True)
    if kk < k:
        dist = torch.nn.functional.pad(dist, (0, k - kk),
                                       value=float("inf"))
        idx = torch.nn.functional.pad(idx, (0, k - kk))
    return dist, idx


def _edges(n: int, k: int, idx: torch.Tensor, edge_mask: torch.Tensor,
           valid: Optional[torch.Tensor]):
    if valid is not None:
        edge_mask = edge_mask & valid[:, None]
    senders = torch.arange(n, dtype=torch.int32,
                           device=idx.device)[:, None].expand(n, k)
    receivers = torch.where(edge_mask, idx.to(torch.int32), 0)
    return (senders.reshape(-1), receivers.reshape(-1),
            edge_mask.reshape(-1))


def knn_graph(x: torch.Tensor, k: int,
              valid: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """k-nearest-neighbor edges of a padded point set x [N, D] (positions,
    or positions and velocities) with node mask `valid` [N].

    Returns senders [N*k] int32, receivers [N*k] int32, edge_mask [N*k]
    bool: edge i*k+j connects sender i to its j-th nearest neighbor.
    Invalid edges (padded nodes, or fewer than k valid partners) are masked
    and point at node 0."""
    dist, idx = _nearest(_pairwise_sq_dists(x, valid), k)
    return _edges(x.shape[0], k, idx, torch.isfinite(dist), valid)


def radius_graph(x: torch.Tensor, r: float, max_degree: int,
                 valid: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Radius-neighborhood edges (dist <= r), at most `max_degree` a node
    (the nearest are kept), laid out and masked as `knn_graph`'s."""
    dist, idx = _nearest(_pairwise_sq_dists(x, valid), max_degree)
    mask = (dist <= r * r) & torch.isfinite(dist)
    return _edges(x.shape[0], max_degree, idx, mask, valid)


def nearest_neighbor(x: torch.Tensor,
                     valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Index of each point's nearest neighbor (1-NN, self excluded). [N]
    int32."""
    return torch.argmin(_pairwise_sq_dists(x, valid), dim=1).to(torch.int32)


def _pairwise_sq_dists_np(x: np.ndarray) -> np.ndarray:
    sq = np.sum(x * x, axis=-1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)
    np.fill_diagonal(d2, np.inf)
    return np.maximum(d2, 0.0, out=d2, where=~np.isinf(d2))


def knn_edges_host(x: np.ndarray, k: int) -> np.ndarray:
    """Edge list [(sender, receiver)], rows grouped by sender, neighbors in
    ascending-distance order within each row (sklearn
    `kneighbors_graph(...).nonzero()` order)."""
    x = np.asarray(x, dtype=np.float64)
    n = x.shape[0]
    k = min(k, n - 1)
    res = native.knn_edges(x, k)
    if res is not None:
        return res
    d2 = _pairwise_sq_dists_np(x)
    part = np.argpartition(d2, k - 1, axis=1)[:, :k]
    part_d = np.take_along_axis(d2, part, axis=1)
    order = np.argsort(part_d, axis=1, kind="stable")
    idx = np.take_along_axis(part, order, axis=1)       # distance ascending
    senders = np.repeat(np.arange(n), k)
    return np.stack([senders, idx.reshape(-1)], axis=1)


def radius_edges_host(x: np.ndarray, r: float) -> np.ndarray:
    """Edge list for dist <= r, sorted by (sender, receiver); self excluded."""
    x = np.asarray(x, dtype=np.float64)
    res = native.radius_edges(x, r)
    if res is not None:
        return res
    d2 = _pairwise_sq_dists_np(x)
    s, t = np.nonzero(d2 <= r * r)
    return np.stack([s, t], axis=1)


def nearest_neighbor_host(x: np.ndarray) -> np.ndarray:
    """1-NN index per point (self excluded); native C++ or numpy."""
    x = np.asarray(x, dtype=np.float64)
    res = native.nearest_neighbor(x)
    if res is not None:
        return res
    d2 = _pairwise_sq_dists_np(x)
    return np.argmin(d2, axis=1)
