"""The PyTorch port's host side (radargnn_tpu_torch) against the JAX package:
configuration loading, synthetic frames, graph construction, box geometry and
the padded dense-tiled batch. These are numpy paths in both packages, so the
port must give identical arrays (exact equality, NaN == NaN), except where a
float computation is stated with its tolerance."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from radargnn_tpu import configs as jcfg
from radargnn_tpu.data import synthetic as jsyn
from radargnn_tpu.graph import batch as jbatch
from radargnn_tpu.ops import knn as jknn
from radargnn_tpu.postprocess import boxes as jboxes
from radargnn_tpu.utils import geometry as jgeo
from radargnn_tpu_torch import configs as tcfg
from radargnn_tpu_torch.data import synthetic as tsyn
from radargnn_tpu_torch.graph import batch as tbatch
from radargnn_tpu_torch.ops import knn as tknn
from radargnn_tpu_torch.postprocess import boxes as tboxes
from radargnn_tpu_torch.utils import geometry as tgeo

_CFG_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configurations")


def _fields(obj):
    """Dataclass fields plus the attributes __post_init__ adds (k, r)."""
    return dict(vars(obj))


@pytest.mark.parametrize("name", ["configuration_radarscenes.yml",
                                  "configuration_description.yml"])
@pytest.mark.parametrize("section", ["GRAPH_CONSTRUCTION",
                                     "MODEL_ARCHITECTURE", "TRAINING",
                                     "POSTPROCESSING", "DATASET_PROCESSING"])
def test_config_sections_load_like_jax(name, section):
    path = os.path.join(_CFG_DIR, name)
    jd = jcfg.UserConfigurationReader.read_config_file(path)
    td = tcfg.UserConfigurationReader.read_config_file(path)
    assert jd == td
    j = jcfg.UserConfigurationReader.get_config_object(section, jd)
    t = tcfg.UserConfigurationReader.get_config_object(section, td)
    assert type(t).__name__ == type(j).__name__
    assert _fields(t) == _fields(j)


def test_nuscenes_split_lookup_waits_for_the_data_slice():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tcfg.NuScenesSplitConfiguration()


def test_arch_config_auto_fused_rule_matches_jax():
    base = dict(node_feature_dimension=5, edge_feature_dimension=2,
                conv_layer_dimensions=[8],
                classification_head_layer_dimensions=[6],
                regression_head_layer_dimensions=[5])
    for extra in ({}, {"conv_pre_mlp_layer_number": 2},
                  {"aggregation_function": "sum"},
                  {"use_fused_aggregation": False}):
        j = jcfg.GNNArchitectureConfig(**base, **extra)
        t = tcfg.GNNArchitectureConfig(**base, **extra)
        assert t.use_fused_aggregation == j.use_fused_aggregation, extra
        assert dataclasses.asdict(t) == dataclasses.asdict(j)


def _assert_samples_equal(ts, js):
    assert len(ts) == len(js)
    for t, j in zip(ts, js):
        for f in dataclasses.fields(j):
            a, b = getattr(t, f.name), getattr(j, f.name)
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)


@pytest.mark.parametrize("kw", [
    dict(num_frames=2, num_points=200, seed=0),
    dict(num_frames=1, num_points=300, seed=3, bb_invariance="none"),
    dict(num_frames=1, num_points=250, seed=5, aligned=True,
         imbalanced=True),
])
def test_make_samples_match_jax(kw):
    _assert_samples_equal(tsyn.make_samples(**kw), jsyn.make_samples(**kw))


def test_make_samples_flagship_graph_config_match_jax():
    path = os.path.join(_CFG_DIR, "configuration_radarscenes.yml")
    jg = jcfg.UserConfigurationReader.get_config_object(
        "GRAPH_CONSTRUCTION",
        jcfg.UserConfigurationReader.read_config_file(path))
    tg = tcfg.UserConfigurationReader.get_config_object(
        "GRAPH_CONSTRUCTION",
        tcfg.UserConfigurationReader.read_config_file(path))
    _assert_samples_equal(
        tsyn.make_samples(num_frames=1, num_points=256, seed=1,
                          graph_config=tg),
        jsyn.make_samples(num_frames=1, num_points=256, seed=1,
                          graph_config=jg))


@pytest.mark.parametrize("native", [True, False])
def test_host_knn_matches_jax(native, monkeypatch):
    """Edge lists, including the tie order (duplicated points), are the same
    from the compiled helper and from the numpy fallback."""
    if not native:
        import radargnn_tpu.native as jn
        import radargnn_tpu_torch.native as tn
        for mod in (jn, tn):
            monkeypatch.setattr(mod, "_LIB", None)
            monkeypatch.setattr(mod, "_TRIED", True)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(120, 2))
    x[10] = x[11] = x[12]                       # ties
    np.testing.assert_array_equal(tknn.knn_edges_host(x, 7),
                                  jknn.knn_edges_host(x, 7))
    np.testing.assert_array_equal(tknn.radius_edges_host(x, 0.4),
                                  jknn.radius_edges_host(x, 0.4))
    np.testing.assert_array_equal(tknn.nearest_neighbor_host(x),
                                  jknn.nearest_neighbor_host(x))


def test_box_geometry_matches_jax():
    """Box encodings and rectangle fits: numpy in both packages, so equal to
    float64 round-off (rtol 1e-12)."""
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(40, 2)) * [4.0, 1.5]
    ref = pts[rng.integers(0, 40, 6)]
    boxes = np.concatenate([rng.normal(size=(6, 2)), rng.uniform(1, 4, (6, 2)),
                            rng.uniform(0, 180, (6, 1))], axis=1)
    for fn in ("minimum_bounding_rectangle_with_rotation",
               "minimum_bounding_rectangle_without_rotation", "convex_hull"):
        np.testing.assert_allclose(getattr(tgeo, fn)(pts),
                                   getattr(jgeo, fn)(pts), rtol=1e-12,
                                   err_msg=fn)
    for fn, args in (
            ("relative_rotated_to_absolute", (boxes, ref)),
            ("relative_rotated_to_rotation_invariant", (boxes, ref, ref[::-1])),
            ("rotation_invariant_to_absolute_corners", (boxes, ref, ref[::-1])),
    ):
        np.testing.assert_allclose(getattr(tboxes, fn)(*args),
                                   getattr(jboxes, fn)(*args), rtol=1e-12,
                                   err_msg=fn)


def _eval_geometry_case(fn):
    """Arguments for each point-in-box / point-IoU / box-conversion helper
    the port carries for the evaluation slice."""
    rng = np.random.default_rng(2)
    pts = np.round(rng.normal(size=(60, 2)) * 3.0, 1)   # rounding: duplicates
    rot = np.concatenate([rng.normal(size=(4, 2)), rng.uniform(1, 5, (4, 2)),
                          rng.uniform(0, 180, (4, 1))], axis=1)
    lo = rng.normal(size=(3, 2))
    aligned = np.concatenate([lo, lo + rng.uniform(1, 5, (3, 2))], axis=1)
    rel = np.concatenate([rng.normal(size=(5, 2)), rng.uniform(1, 4, (5, 2))],
                         axis=1)
    corners = rng.normal(size=(5, 4, 2))
    return {
        "box_area_rotated": (tgeo, jgeo, (rot,)),
        "is_point_in_rect": (tgeo, jgeo, (
            tgeo.get_box_corners(*rot[0]), rot[0, :2])),
        "get_points_in_rotated_box": (tgeo, jgeo, (rot[1], pts)),
        "get_points_in_box": (tgeo, jgeo, (aligned[0], pts)),
        "get_stats_of_predicted_box_points": (tgeo, jgeo, (pts[:30], pts[20:])),
        "get_discrete_iou": (tgeo, jgeo, (0, 0, 0)),
        "point_iou_rotated": (tgeo, jgeo, (rot, rot[::-1], pts, False)),
        "point_iou_aligned": (tgeo, jgeo, (aligned, aligned[::-1], pts, True)),
        "aligned_corners_to_two_point": (tboxes, jboxes, (corners,)),
        "relative_aligned_to_absolute_corners": (tboxes, jboxes,
                                                 (rel, pts[:5])),
    }[fn]


@pytest.mark.parametrize("fn", [
    "box_area_rotated", "is_point_in_rect", "get_points_in_rotated_box",
    "get_points_in_box", "get_stats_of_predicted_box_points",
    "get_discrete_iou", "point_iou_rotated", "point_iou_aligned",
    "aligned_corners_to_two_point", "relative_aligned_to_absolute_corners"])
def test_eval_geometry_matches_jax(fn):
    """numpy in both packages: the same arrays (rtol 1e-12, float64)."""
    tmod, jmod, args = _eval_geometry_case(fn)
    name = fn.replace("_rotated", "").replace("_aligned", "") \
        if fn.startswith("point_iou") else fn
    np.testing.assert_allclose(np.asarray(getattr(tmod, name)(*args),
                                          dtype=np.float64),
                               np.asarray(getattr(jmod, name)(*args),
                                          dtype=np.float64), rtol=1e-12)


def test_one_hot_vectors_match_jax():
    from radargnn_tpu.data import ground_truth as jgt
    from radargnn_tpu_torch.data import ground_truth as tgt
    labels = np.array([0, 5, 2, 2, 1])
    np.testing.assert_array_equal(tgt.build_one_hot_vectors(labels),
                                  jgt.build_one_hot_vectors(labels))


def _dense_spec(node_block=64, r_tile=16, k=24, ovf_frac=0.3):
    return {"mode": "dense", "node_block": node_block, "r_tile": r_tile,
            "k": k, "window_blocks": 3, "ovf_frac": ovf_frac}


@pytest.mark.parametrize("tiled", [True, False])
def test_stack_samples_match_jax(tiled):
    """The geometry of tests/test_pallas.py's dense DetNet test (2 frames of
    200 points, k=20, bucket 256): every batch array and the flat tiling
    are identical."""
    k = 20
    samples = jsyn.make_samples(num_frames=2, num_points=200, seed=0)
    spec = _dense_spec(k=k + 4) if tiled else None
    jb = jbatch.stack_samples(samples, max_nodes=256, bg_index=5,
                              max_edges=256 * k, csr_tiling=spec)
    tb = tbatch.stack_samples(
        tsyn.make_samples(num_frames=2, num_points=200, seed=0),
        max_nodes=256, bg_index=5, max_edges=256 * k, csr_tiling=spec,
        device="cpu")
    tensors = tb.tensors()
    for name, t in tensors.items():
        j = np.asarray(getattr(jb, name))
        assert t.numpy().dtype == j.dtype, name
        np.testing.assert_array_equal(t.numpy(), j, err_msg=name)
    assert tb.host_valid_edges == sum(s.num_edges for s in samples)
    if not tiled:
        assert tb.flat_tiling() is None
        return
    assert tb.tile_geometry == jb.tile_geometry
    jt, tt = jb.flat_tiling(64), tb.flat_tiling()
    for name in ("senders", "receivers", "blocks", "edge_feat"):
        np.testing.assert_array_equal(getattr(tt, name).numpy(),
                                      np.asarray(getattr(jt, name)),
                                      err_msg=name)
    for i, (a, b) in enumerate(zip(tt.win, jt.win)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=f"win[{i}]")
    assert (tt.node_block, tt.edge_tile, tt.dense) == \
        (jt.node_block, jt.edge_tile, jt.dense)
    for name in ("flat_senders", "flat_receivers", "flat_nodes",
                 "flat_edges"):
        np.testing.assert_array_equal(getattr(tb, name)().numpy(),
                                      np.asarray(getattr(jb, name)()),
                                      err_msg=name)


def test_stack_samples_refuses_unported_tilings():
    """The sender-sorted overflow tiling of the dense layout (ovf_ssum)
    waits for its kernel variant; the windowed tuple and the CSR 2-tuple
    are ported (tests/test_torch_windowed.py, tests/test_torch_csr.py)."""
    samples = tsyn.make_samples(num_frames=1, num_points=64, seed=0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tbatch.stack_samples(samples, max_nodes=128, bg_index=5,
                             csr_tiling=dict(_dense_spec(), ovf_ssum=True),
                             device="cpu")


def test_batch_to_moves_every_tensor():
    samples = tsyn.make_samples(num_frames=1, num_points=64, seed=0)
    b = tbatch.stack_samples(samples, max_nodes=128, bg_index=5,
                             csr_tiling=_dense_spec(), device="cpu")
    moved = b.to(torch.device("cpu"))
    assert moved.tensors().keys() == b.tensors().keys()
    assert moved.tile_geometry == b.tile_geometry
