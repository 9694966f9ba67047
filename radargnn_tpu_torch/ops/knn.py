"""Host (numpy) graph construction: kNN / radius edge lists and 1-NN.

Port of the host functions of `radargnn_tpu/ops/knn.py`. The edge lists keep
the reference's sklearn order: rows grouped by sender, neighbors in
ascending-distance order (kNN) or ascending index (radius). An edge (s, r)
means r is one of the k nearest neighbors of s; messages flow s -> r and
aggregate at the receiver r. The compiled helper is used when it builds;
the numpy code gives the same edges, ties included.
"""

from __future__ import annotations

import numpy as np

from radargnn_tpu_torch import native


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
