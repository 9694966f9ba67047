"""The port's graph construction on the device (radargnn_tpu_torch.graph.online
and ops.knn's knn_graph / radius_graph / nearest_neighbor) against the host
pipeline and the JAX package's online builder: the cases of
`tests/test_online_graph.py`, run here on the CPU. Edge sets are compared
per receiver, since `topk` may order or break ties differently; features
by edge pair. The port computes them in float64 and rounds them to
float32, so they are the host's within float32 rounding (1e-6); the JAX
package's are float32 throughout, within 1e-4 but for the angles of the
point-pair features, arccos near +-1, where float32 loses up to ~0.03
degrees (atol 0.05)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radargnn_tpu.configs import GraphConstructionConfiguration as JGraphConfig
from radargnn_tpu.graph import online as jonline
from radargnn_tpu_torch.configs import GraphConstructionConfiguration
from radargnn_tpu_torch.graph import online
from radargnn_tpu_torch.graph.build import build_geometric_graph
from radargnn_tpu_torch.graph.features import time_index_feature
from radargnn_tpu_torch.ops import knn

from tests.test_online_graph import _frames

KNN_ARGS = ("knn", {"k": 5, "r": 1.0},
            ["rcs", "velocity_vector", "time_index", "degree"],
            ["relative_position"], "directed", "X")


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _edge_dict(senders, receivers, mask, feat):
    return {(int(s), int(r)): f for s, r, m, f in zip(
        np.asarray(senders), np.asarray(receivers), np.asarray(mask),
        np.asarray(feat)) if m}


def _by_receiver(edges):
    out = {}
    for s, r in edges:
        out.setdefault(r, set()).add(s)
    return out


def test_time_index_device_matches_host():
    rng = np.random.default_rng(0)
    ts = rng.integers(100, 110, 50).astype(np.float64)
    host = time_index_feature(ts).reshape(-1)
    np.testing.assert_array_equal(
        online.time_index_device(torch.from_numpy(ts)).numpy(), host)
    np.testing.assert_array_equal(
        online.time_index_device(torch.from_numpy(ts)).numpy(),
        np.asarray(jonline.time_index_device(jnp.asarray(ts))))
    # padded entries rank past every valid one
    valid = np.arange(60) < 50
    padded = np.concatenate([ts, np.zeros(10)])
    got = online.time_index_device(*_t(padded, valid)).numpy()
    np.testing.assert_array_equal(got[:50], host)
    assert (got[50:] > host.max()).all()


@pytest.mark.parametrize("edge_mode,edge_features,jax_atol", [
    ("directed", ["relative_position"], 1e-4),
    ("undirected", ["point_pair_features", "relative_velocity",
                    "spatial_euclidean_distance",
                    "velocity_euclidean_distance"], 5e-2),
])
def test_online_graph_matches_host_pipeline(edge_mode, edge_features,
                                            jax_atol):
    """Per graph: the valid edges are the host's kNN edges, each edge's
    features and each valid node's features the host's; the JAX online
    builder gives the same edges and features on the same frames."""
    rng = np.random.default_rng(1)
    args = list(KNN_ARGS)
    args[3], args[4] = edge_features, edge_mode
    config = GraphConstructionConfiguration(*args)
    j_config = JGraphConfig(*args)
    pos, vel, rcs, ts, valid = _frames(rng, g=2, n_valid=60, n_pad=64)
    batch = online.make_online_graph_builder(config)(
        *_t(pos, vel, rcs, ts, valid))
    j_batch = jonline.make_online_graph_builder(j_config)(
        *map(jnp.asarray, (pos, vel, rcs, ts, valid)))
    assert batch.node_feat.shape == tuple(j_batch.node_feat.shape)
    assert batch.edge_feat.shape == tuple(j_batch.edge_feat.shape)
    assert batch.host_valid_edges == int(np.asarray(j_batch.edge_mask).sum())
    np.testing.assert_array_equal(batch.labels.numpy(),
                                  np.asarray(j_batch.labels))
    assert torch.isnan(batch.boxes).all()
    for gi in range(2):
        host = build_geometric_graph(
            config, pos[gi, :60].astype(np.float64),
            vel[gi, :60].astype(np.float64), rcs=rcs[gi, :60],
            timestamps=ts[gi, :60])
        dev = _edge_dict(batch.senders[gi], batch.receivers[gi],
                         batch.edge_mask[gi], batch.edge_feat[gi])
        jdev = _edge_dict(j_batch.senders[gi], j_batch.receivers[gi],
                          j_batch.edge_mask[gi], j_batch.edge_feat[gi])
        host_edges = list(map(tuple, host.edges.tolist()))
        assert _by_receiver(dev) == _by_receiver(host_edges) \
            == _by_receiver(jdev)
        for edge, f_host in zip(host_edges, host.edge_feat):
            np.testing.assert_allclose(dev[edge], f_host, rtol=1e-6,
                                       atol=1e-6)
            np.testing.assert_allclose(dev[edge], jdev[edge], rtol=1e-4,
                                       atol=jax_atol)
        np.testing.assert_allclose(batch.node_feat[gi][:60].numpy(),
                                   host.node_feat, rtol=1e-6, atol=1e-6)
        assert not batch.node_feat[gi][60:].any()
        assert not batch.edge_feat[gi][~batch.edge_mask[gi]].any()


def test_online_graph_radius():
    """Radius edges within r, at most max_degree a node: with fewer
    neighbors than that, exactly the host's radius edges."""
    rng = np.random.default_rng(2)
    args = ("radius", {"k": 5, "r": 6.0}, ["rcs"],
            ["spatial_euclidean_distance"], "directed", "X")
    config = GraphConstructionConfiguration(*args)
    pos, vel, rcs, ts, valid = _frames(rng, g=1, n_valid=40, n_pad=48)
    batch = online.build_graph_batch_on_device(
        config, *_t(pos, vel, rcs, ts, valid), max_degree=16)
    s, r, m = (t[0].numpy() for t in (batch.senders, batch.receivers,
                                      batch.edge_mask))
    d = np.linalg.norm(pos[0][s] - pos[0][r], axis=1)
    assert (d[m] <= 6.0 + 1e-4).all() and m.any()
    assert np.bincount(s[m], minlength=48).max() < 16
    host = knn.radius_edges_host(pos[0, :40].astype(np.float64), 6.0)
    assert {(int(a), int(b)) for a, b, k in zip(s, r, m) if k} == \
        set(map(tuple, host.tolist()))
    j_batch = jonline.build_graph_batch_on_device(
        JGraphConfig(*args), *map(jnp.asarray, (pos, vel, rcs, ts, valid)),
        max_degree=16)
    np.testing.assert_array_equal(m, np.asarray(j_batch.edge_mask[0]))


def test_device_knn_pads_and_masks():
    """Fewer valid partners than k: the missing edges are masked and point
    at node 0; padded senders have no edges; 1-NN is the host's."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(10, 2)).astype(np.float32) * 5
    valid = np.arange(10) < 4
    s, r, m = knn.knn_graph(*_t(x), k=5, valid=torch.from_numpy(valid))
    m = m.reshape(10, 5).numpy()
    assert m[:4, :3].all() and not m[:4, 3:].any() and not m[4:].any()
    assert (r.reshape(10, 5).numpy()[~m] == 0).all()
    assert s.reshape(10, 5)[:, 0].tolist() == list(range(10))
    s, r, m = knn.knn_graph(*_t(x[:3]), k=5)           # k > N - 1
    assert m.reshape(3, 5).sum(1).tolist() == [2, 2, 2]
    np.testing.assert_array_equal(
        knn.nearest_neighbor(*_t(x)).numpy(),
        knn.nearest_neighbor_host(x.astype(np.float64)))
