"""The port's evaluation stage (`radargnn_tpu_torch.postprocess`: NMS and
the IoU matrices, box extraction, the mAP engine, the segmentation metrics,
the evaluator) against the JAX package on the CPU, on the same seeded
inputs.

Tolerances: the IoU matrices are float32 in both packages, with sin/cos
and the clip's products in other orders, so they agree to 1e-5 absolute;
NMS keeps the same indices in the same order where no IoU lies within
1e-4 of the threshold (checked on each input); the decoded boxes are the
same float64 host arithmetic (1e-9 relative; the adapted orientation angle
is compared with the JAX package in 64-bit mode, where it does not round
that angle through float32); the mAP engine's numbers are the same host
arithmetic downstream of the IoUs (1e-12); F1 and the confusion matrices
equal scikit-learn's, which the JAX package calls.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn import metrics as skm

from radargnn_tpu.configs import PostProcessingConfiguration as JaxConfig
from radargnn_tpu.data.ground_truth import create_2d_bounding_boxes
import radargnn_tpu.postprocess as jpp
from radargnn_tpu.postprocess import mean_ap as jmap
from radargnn_tpu.postprocess import nms as jnms
from radargnn_tpu_torch.configs import PostProcessingConfiguration
import radargnn_tpu_torch.postprocess as pp
from radargnn_tpu_torch.postprocess import evaluation as pev
from radargnn_tpu_torch.postprocess import nms
from radargnn_tpu_torch.postprocess import segmentation_metrics as psm
from radargnn_tpu_torch.postprocess import visualization as pvis
from radargnn_tpu_torch.utils import png
from radargnn_tpu_torch.utils.geometry import (
    get_box_corners, points_in_rect_mask,
)

CPU = torch.device("cpu")
IOU_ATOL = 1e-5
NMS_MARGIN = 1e-4
BOX_RTOL = 1e-9
MAP_ATOL = 1e-12


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _rotated_boxes(rng, n, spread=5.0):
    return np.stack([rng.uniform(-spread, spread, n),
                     rng.uniform(-spread, spread, n),
                     rng.uniform(0.5, 4, n), rng.uniform(0.5, 3, n),
                     rng.uniform(0, 180, n)], axis=1).astype(np.float32)


def _aligned_boxes(rng, n, spread=5.0):
    lo = rng.uniform(-spread, spread, (n, 2))
    return np.concatenate([lo, lo + rng.uniform(0.5, 4, (n, 2))],
                          axis=1).astype(np.float32)


# -- IoU matrices ------------------------------------------------------------

@pytest.mark.parametrize("rotated", [False, True])
def test_iou_matrix_matches_jax(rotated):
    rng = np.random.default_rng(0)
    make = _rotated_boxes if rotated else _aligned_boxes
    a, b = make(rng, 40), make(rng, 30)
    j = jnms.rotated_iou_matrix if rotated else jnms.aligned_iou_matrix
    t = nms.rotated_iou_matrix if rotated else nms.aligned_iou_matrix
    want = np.asarray(j(jnp.asarray(a), jnp.asarray(b)))
    got = t(_t(a), _t(b)).numpy()
    assert got.dtype == np.float32 and got.shape == (40, 30)
    assert (want > 0).mean() > 0.1          # partial overlaps are exercised
    np.testing.assert_allclose(got, want, rtol=0, atol=IOU_ATOL)


def test_batched_iou_matrices_match_jax():
    """Zero-padded frames in one batched call, as the mAP engine pads: the
    real rows' IoUs match the JAX package's, the padding rows' are 0 (the
    JAX clip can leave rounding noise over a zero union there, which its
    engine slices away)."""
    rng = np.random.default_rng(1)
    for rotated in (False, True):
        make = _rotated_boxes if rotated else _aligned_boxes
        det, gt = make(rng, 3 * 12).reshape(3, 12, -1), \
            make(rng, 3 * 9).reshape(3, 9, -1)
        det[1, 7:] = 0.0
        gt[2, 4:] = 0.0
        want = np.asarray(jnms.batched_iou_matrices(
            jnp.asarray(det), jnp.asarray(gt), rotated=rotated))
        got = nms.batched_iou_matrices(_t(det), _t(gt), rotated).numpy()
        for f, (nd, ng) in enumerate(((12, 9), (7, 9), (12, 4))):
            np.testing.assert_allclose(got[f, :nd, :ng], want[f, :nd, :ng],
                                       rtol=0, atol=IOU_ATOL)
        assert not got[1, 7:].any() and not got[2, :, 4:].any()


def test_box_corners_match_jax():
    rng = np.random.default_rng(3)
    boxes = _rotated_boxes(rng, 16, spread=40.0)
    np.testing.assert_allclose(
        nms._box_corners(_t(boxes)).numpy(),
        np.asarray(jnms._box_corners(jnp.asarray(boxes))), rtol=0,
        atol=1e-5)


def test_rotated_iou_keeps_its_precision_far_from_the_origin():
    """Overlapping float32 boxes 60 m from the origin (a radar frame's
    range) give the IoUs of the same boxes at the origin, to 1e-5: each
    pair is clipped about its first box's centre. Clipped in absolute
    coordinates, the shoelace sum cancels to ~1e-4 there."""
    rng = np.random.default_rng(4)
    near = _rotated_boxes(rng, 60, spread=2.0)
    far = near.copy()
    far[:, :2] += np.float32([60.0, -45.0])
    want = nms.rotated_iou_matrix(_t(near).double(), _t(near).double())
    for boxes in (near, far):
        got = nms.rotated_iou_matrix(_t(boxes), _t(boxes))
        assert float((got.double() - want).abs().max()) <= IOU_ATOL
    assert float((want > 0).double().mean()) > 0.3


def test_rotated_iou_is_chunked_alike(monkeypatch):
    """Rows formed in chunks give the matrix formed at once."""
    rng = np.random.default_rng(2)
    a, b = _t(_rotated_boxes(rng, 23)), _t(_rotated_boxes(rng, 17))
    whole = nms.rotated_iou_matrix(a, b)
    monkeypatch.setattr(nms, "_PAIR_CHUNK", 40)
    assert torch.equal(nms.rotated_iou_matrix(a, b), whole)


def test_aligned_iou_analytic():
    a = _t([[0.0, 0, 2, 2]])
    b = _t([[1.0, 1, 3, 3], [2.0, 2, 3, 3], [0.0, 0, 2, 2]])
    np.testing.assert_allclose(nms.aligned_iou_matrix(a, b).numpy()[0],
                               [1 / 7, 0.0, 1.0], atol=1e-6)


def test_rotated_iou_axis_aligned_case():
    iou = nms.rotated_iou_matrix(_t([[1.0, 1, 2, 2, 0]]),
                                 _t([[2.0, 2, 2, 2, 0]]))
    np.testing.assert_allclose(iou.numpy(), [[1 / 7]], atol=1e-6)


def test_rotated_iou_45deg_diamond():
    iou = float(nms.rotated_iou_matrix(_t([[0.0, 0, 2, 2, 0]]),
                                       _t([[0.0, 0, 2, 2, 45]]))[0, 0])
    inter = 8 * (np.sqrt(2) - 1)
    assert abs(iou - inter / (8 - inter)) < 1e-6


def test_rotated_iou_identical_and_disjoint():
    a = _t([[3.0, -2, 4, 1.5, 33.0]])
    assert abs(float(nms.rotated_iou_matrix(a, a)[0, 0]) - 1.0) < 1e-6
    b = _t([[30.0, 40, 2, 2, 70.0]])
    assert float(nms.rotated_iou_matrix(a, b)[0, 0]) == 0.0


def test_rotated_iou_monte_carlo():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-6, 6, size=(200_000, 2))
    for _ in range(8):
        a, b = (np.array([rng.uniform(-2, 2), rng.uniform(-2, 2),
                          rng.uniform(1, 4), rng.uniform(0.5, 3),
                          rng.uniform(0, 180)]) for _ in range(2))
        in_a = points_in_rect_mask(get_box_corners(*a), pts)
        in_b = points_in_rect_mask(get_box_corners(*b), pts)
        iou_mc = (in_a & in_b).mean() / max((in_a | in_b).mean(), 1e-12)
        iou = float(nms.rotated_iou_matrix(_t(a[None]), _t(b[None]))[0, 0])
        assert abs(iou - iou_mc) < 0.02, (a, b, iou, iou_mc)


# -- NMS ---------------------------------------------------------------------

def _clear_of_threshold(boxes, rotated, thr):
    f = nms.rotated_iou_matrix if rotated else nms.aligned_iou_matrix
    iou = f(_t(boxes), _t(boxes)).numpy()
    return np.abs(iou - thr).min() >= NMS_MARGIN


@pytest.mark.parametrize("rotated", [False, True])
@pytest.mark.parametrize("thr", [0.01, 0.1, 0.3, 0.5])
def test_nms_indices_match_jax(rotated, thr):
    rng = np.random.default_rng(int(thr * 100) + rotated)
    make = _rotated_boxes if rotated else _aligned_boxes
    boxes = make(rng, 40, spread=4.0)
    scores = rng.random(40).astype(np.float32)
    assert _clear_of_threshold(boxes, rotated, thr)
    got = nms.nms_indices(boxes, scores, thr, rotated, device="cpu")
    want = jnms.nms_indices(boxes, scores, thr, rotated)
    assert got.dtype == want.dtype
    assert got.tolist() == want.tolist()
    assert 1 < len(got) < 40


def test_nms_tied_scores_keep_input_order():
    """Tied scores break by input order in both packages (stable sorts):
    identical boxes keep the first of each tie."""
    rng = np.random.default_rng(4)
    base = _rotated_boxes(rng, 6, spread=20.0)
    boxes = np.repeat(base, 3, axis=0)
    scores = np.repeat(np.float32([0.5, 0.9, 0.5, 0.7, 0.9, 0.1]), 3)
    got = nms.nms_indices(boxes, scores, 0.3, True, device="cpu")
    want = jnms.nms_indices(boxes, scores, 0.3, True)
    assert got.tolist() == want.tolist()
    assert sorted(got.tolist()) == [0, 3, 6, 9, 12, 15]


def test_nms_valid_mask_and_keep_mask():
    """Padding rows (valid False) are never kept and suppress nothing."""
    rng = np.random.default_rng(5)
    boxes = _t(_rotated_boxes(rng, 12, spread=3.0))
    scores = _t(rng.random(12))
    valid = torch.arange(12) < 9
    got = nms.nms_keep_mask(boxes, scores, 0.2, True, valid)
    want = np.asarray(jnms.nms_keep_mask(
        jnp.asarray(boxes.numpy()), jnp.asarray(scores.numpy()), 0.2, True,
        jnp.asarray(valid.numpy())))
    assert got.numpy().tolist() == want.tolist()
    assert not got[9:].any()


def test_nms_rotated_threshold_characterization():
    boxes = np.array([[1, 2, 1, 1, 90], [1, 2.9, 1, 1, 90]], np.float64)
    scores = np.array([0.2, 0.7])
    iou = 0.1 / (2 - 0.1)
    assert nms.nms_indices(boxes, scores, iou - 0.01, True,
                           device="cpu").tolist() == [1]
    assert nms.nms_indices(boxes, scores, iou + 0.01, True,
                           device="cpu").tolist() == [1, 0]


def test_nms_aligned_basic_and_negative_coordinates():
    boxes = np.array([[0, 0, 2, 2], [0.1, 0, 2.1, 2], [5, 5, 6, 6]])
    scores = np.array([0.9, 0.8, 0.5])
    assert nms.nms_indices(boxes, scores, 0.5, False,
                           device="cpu").tolist() == [0, 2]
    assert nms.nms_indices(boxes, scores, 0.99, False,
                           device="cpu").tolist() == [0, 1, 2]
    neg = np.array([[-10, -10, -8, -8], [-9.9, -10, -7.9, -8]], np.float64)
    got = nms.nms_indices(neg, np.array([0.3, 0.6]), 0.5, False,
                          device="cpu")
    assert got.tolist() == jnms.nms_indices(
        neg, np.array([0.3, 0.6]), 0.5, False).tolist() == [1]


def test_nms_empty():
    got = nms.nms_indices(np.zeros((0, 5)), np.zeros((0,)), 0.5, True,
                          device="cpu")
    assert got.dtype == np.int64 and got.size == 0


def test_nms_invariance_under_rigid_transform():
    rng = np.random.default_rng(3)
    boxes = np.stack([rng.uniform(-5, 5, 12), rng.uniform(-5, 5, 12),
                      rng.uniform(1, 4, 12), rng.uniform(0.5, 2, 12),
                      rng.uniform(0, 180, 12)], axis=1)
    scores = rng.random(12)
    base = nms.nms_indices(boxes, scores, 0.3, True, device="cpu").tolist()
    assert base == jnms.nms_indices(boxes, scores, 0.3, True).tolist()
    for phi, shift in ((37.0, (11.0, -4.0)), (120.0, (-30.0, 8.0))):
        t = np.deg2rad(phi)
        rot = np.array([[np.cos(t), -np.sin(t)], [np.sin(t), np.cos(t)]])
        moved = boxes.copy()
        moved[:, :2] = boxes[:, :2] @ rot.T + np.asarray(shift)
        moved[:, 4] = np.mod(boxes[:, 4] + phi, 180.0)
        assert nms.nms_indices(moved, scores, 0.3, True,
                               device="cpu").tolist() == base


def test_nms_needs_a_device_it_can_use():
    """None is the card: without one it raises, with no CPU fallback."""
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a card")
    boxes = np.array([[0.0, 0, 2, 2, 0]])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nms.nms_indices(boxes, np.ones(1), 0.5, True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pp.Postprocessor()


# -- extraction --------------------------------------------------------------

def _config(cls, **kw):
    base = dict(
        split="validate", iou_for_nms=0.01,
        min_object_score={"car": 0.5, "pedestrian": 0.5,
                          "pedestrian_group": 0.5, "two_wheeler": 0.5,
                          "large_vehicle": 0.5},
        max_score_for_background=0.2, iou_for_mAP=0.3, use_point_iou=True,
        bg_index=5, bb_invariance="translation")
    base.update(kw)
    return cls(**base)


def _frame(rng, n=60, bb_invariance="translation", aligned=False):
    """tests/test_postprocess.py's synthetic frame: 3 objects."""
    pos = rng.uniform(0, 50, size=(n, 2))
    labels = np.full(n, 5)
    tracks = np.full(n, b"", object)
    centers = [np.array([10.0, 10.0]), np.array([25.0, 40.0]),
               np.array([42.0, 15.0])]
    for obj, (lo, hi) in enumerate([(0, 6), (6, 14), (14, 19)]):
        pos[lo:hi] = centers[obj] + rng.uniform(-2, 2, size=(hi - lo, 2))
        labels[lo:hi] = obj % 5
        tracks[lo:hi] = str(obj).encode()
    boxes = create_2d_bounding_boxes(pos, tracks, aligned, bb_invariance)
    return pos, rng.normal(size=(n, 2)), labels.astype(float), boxes


def _problem(seed, bb_invariance, aligned, adapt, frames=3):
    """Noisy predictions over synthetic frames: the objects' points regress
    jittered boxes with their class likely, the rest random probabilities."""
    rng = np.random.default_rng(seed)
    pos_l, vel_l = [], []
    preds = {"bounding_box_predictions": [],
             "class_probability_prediction": []}
    gts = {"bounding_box_true": [], "class_true": []}
    for _ in range(frames):
        pos, vel, labels, boxes = _frame(rng, bb_invariance=bb_invariance,
                                         aligned=aligned)
        bb = np.nan_to_num(boxes, nan=0.0) + rng.normal(scale=0.05,
                                                        size=boxes.shape)
        if adapt:
            theta = np.where(bb[:, 4] > np.pi / 2, bb[:, 4] - np.pi,
                             bb[:, 4])
            bb[:, 4] = np.sin(theta)
        probs = rng.dirichlet(np.full(6, 0.3), size=len(labels))
        probs[:19] = 0.02
        probs[np.arange(19), labels[:19].astype(int)] = 0.9
        pos_l.append(pos)
        vel_l.append(vel)
        preds["bounding_box_predictions"].append(bb)
        preds["class_probability_prediction"].append(probs)
        gts["bounding_box_true"].append(boxes)
        gts["class_true"].append(labels)
    return pos_l, vel_l, preds, gts


def _assert_boxes_equal(got, want):
    assert got.aligned == want.aligned and len(got) == len(want)
    scale = np.maximum(np.abs(want.corners), 1.0)
    assert np.all(np.abs(got.corners - want.corners) <= BOX_RTOL * scale)


@pytest.mark.parametrize("bb_invariance,aligned,adapt", [
    ("translation", False, False), ("translation", False, True),
    ("none", False, False), ("en", False, False), ("translation", True, False),
])
def test_postprocessor_matches_jax(bb_invariance, aligned, adapt):
    pos, vel, preds, gts = _problem(7, bb_invariance, aligned, adapt)
    kw = dict(bb_invariance=bb_invariance, adapt_orientation_angle=adapt)
    got = pp.Postprocessor("cpu").process(
        _config(PostProcessingConfiguration, **kw), pos, vel, preds, gts)
    with jax.enable_x64(adapt):
        want = jpp.Postprocessor().process(_config(JaxConfig, **kw), pos,
                                           vel, preds, gts)
    kept = 0
    for g, w in zip(got[0], want[0]):                   # detections
        _assert_boxes_equal(g["boxes"], w["boxes"])
        np.testing.assert_array_equal(g["scores"], w["scores"])
        np.testing.assert_array_equal(g["labels"], w["labels"])
        kept += len(g["boxes"])
    assert kept > 3                                      # NMS kept boxes
    for g, w in zip(got[1], want[1]):                   # ground truth
        _assert_boxes_equal(g["boxes"], w["boxes"])
        np.testing.assert_array_equal(g["labels"], w["labels"])
    for g, w in zip(got[2], want[2]):                   # segmentation
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])
    assert [d["labels"] for d in got[3]] == [d["labels"] for d in want[3]]


def test_prediction_extractor_matches_jax():
    _, _, preds, _ = _problem(8, "translation", False, False)
    got = pp.PredictionExtractor().extract(preds)
    want = jpp.PredictionExtractor().extract(preds)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for name in ("get_prediction_scores",):
        for p in preds["class_probability_prediction"]:
            np.testing.assert_array_equal(
                getattr(pp.PredictionExtractor, name)(p),
                getattr(jpp.PredictionExtractor, name)(p))


def test_decode_boxes_matches_jax_for_every_encoding():
    rng = np.random.default_rng(9)
    bb, pts, nn = rng.normal(size=(20, 5)), rng.normal(size=(20, 2)) * 10, \
        rng.normal(size=(20, 2)) * 10
    for inv in ("translation", "none", "en"):
        got = pp.decode_boxes_to_corners(bb, pts, nn, inv)
        want = jpp.decode_boxes_to_corners(bb, pts, nn, inv)
        np.testing.assert_allclose(got, want, rtol=BOX_RTOL, atol=0)
    np.testing.assert_allclose(
        pp.decode_boxes_to_corners(bb[:, :4], pts, None, "translation"),
        jpp.decode_boxes_to_corners(bb[:, :4], pts, None, "translation"),
        rtol=BOX_RTOL, atol=0)


# -- the mAP engine ----------------------------------------------------------

def _map_problem(seed, rotated, frames=5, classes=3):
    rng = np.random.default_rng(seed)
    make = _rotated_boxes if rotated else _aligned_boxes
    preds, target, clouds = [], [], []
    for _ in range(frames):
        n_gt = int(rng.integers(0, 7))
        gt = make(rng, n_gt, spread=8.0).astype(np.float64)
        dets = [gt + rng.normal(scale=0.3, size=gt.shape)] if n_gt else []
        dets.append(make(rng, int(rng.integers(0, 5)), spread=8.0))
        det = np.concatenate(dets).astype(np.float64)
        if not rotated:
            det[:, 2:] = np.maximum(det[:, 2:], det[:, :2] + 0.1)
        preds.append({"boxes": det, "scores": rng.random(len(det)),
                      "labels": rng.integers(0, classes, len(det))})
        target.append({"boxes": gt,
                       "labels": rng.integers(0, classes, n_gt)})
        clouds.append(rng.uniform(-10, 12, size=(300, 2)))
    return preds, target, clouds


def _assert_map_equal(got, want):
    assert got.keys() == want.keys()
    for k in got:
        g, w = np.asarray(got[k], np.float64), np.asarray(want[k], np.float64)
        np.testing.assert_allclose(g, w, rtol=0, atol=MAP_ATOL, err_msg=k)


@pytest.mark.parametrize("rotated,point_iou", [
    (False, False), (True, False), (False, True), (True, True)])
def test_mean_ap_matches_jax(rotated, point_iou):
    kw = dict(iou_thresholds=[0.1, 0.3, 0.5, 0.75],
              max_detection_thresholds=[1, 3, 100])
    for seed in range(3):
        preds, target, clouds = _map_problem(seed, rotated)
        got_m = pp.MeanAveragePrecision(device="cpu", **kw)
        want_m = jpp.MeanAveragePrecision(**kw)
        for m in (got_m, want_m):
            m.update(preds, target, point_iou, clouds if point_iou else None,
                     is_aligned=not rotated)
        got, want = got_m.compute(), want_m.compute()
        _assert_map_equal(got, want)
        assert 0.0 < got["map"] < 1.0


def test_mean_ap_area_ranges_match_jax():
    """COCO area ranges (scaled to the boxes' metres) and the max-dets
    summaries."""
    areas = {"all": (0.0, 1e10), "small": (0.0, 2.0), "medium": (2.0, 6.0),
             "large": (6.0, 1e10)}
    for rotated in (False, True):
        preds, target, _ = _map_problem(11, rotated, frames=6)
        got_m = pp.MeanAveragePrecision([0.3, 0.5], area_ranges=areas,
                                        max_detection_thresholds=[1, 10, 100],
                                        device="cpu")
        want_m = jmap.MeanAveragePrecision(
            [0.3, 0.5], area_ranges=areas,
            max_detection_thresholds=[1, 10, 100])
        for m in (got_m, want_m):
            m.update(preds, target, is_aligned=not rotated)
        got = got_m.compute()
        _assert_map_equal(got, want_m.compute())
        assert {"map_small", "mar_large", "mar_1"} <= set(got)
    coco = pp.MeanAveragePrecision(area_ranges="coco", device="cpu")
    assert list(coco.area_ranges) == ["all", "small", "medium", "large"]


def test_mean_ap_box_iou_is_one_batched_call(monkeypatch):
    """Every frame's box IoU comes from one batched call (of up to 256
    frames, as the JAX package dispatches them), and smaller chunks of
    frames give the same matrices."""
    from radargnn_tpu_torch.postprocess import mean_ap
    calls = []
    real = mean_ap.batched_iou_matrices
    monkeypatch.setattr(mean_ap, "batched_iou_matrices",
                        lambda *a, **k: calls.append(a[0].shape)
                        or real(*a, **k))
    preds, target, _ = _map_problem(3, True)
    m = pp.MeanAveragePrecision([0.5], device="cpu")
    m.update(preds, target, is_aligned=False)
    m.compute()
    assert len(calls) == 1 and calls[0][0] == sum(
        1 for p, t in zip(preds, target)
        if len(p["boxes"]) and len(t["boxes"]))
    whole, chunked = {}, {}
    m._precompute_geometric_ious(whole)
    m._precompute_geometric_ious(chunked, chunk=2)
    assert len(calls) == 1 + 1 + -(-calls[0][0] // 2)
    assert whole.keys() == chunked.keys()
    for i in whole:
        np.testing.assert_array_equal(whole[i], chunked[i])


# -- segmentation metrics ----------------------------------------------------

def _labels(seed, n=400, classes=6):
    """Seeded labels of which class 4 appears in neither vector, and one
    prediction outside the label range."""
    rng = np.random.default_rng(seed)
    choice = [0, 1, 2, 3, 5]
    y_true = rng.choice(choice, n, p=[0.1, 0.05, 0.1, 0.05, 0.7])
    y_pred = np.where(rng.random(n) < 0.7, y_true, rng.choice(choice, n))
    y_pred[3] = classes + 1
    return y_true.tolist(), y_pred.tolist()


@pytest.mark.parametrize("average", [None, "micro", "macro", "weighted"])
def test_f1_matches_sklearn(average):
    for seed in range(3):
        y_true, y_pred = _labels(seed)
        got = psm.f1_score(y_true, y_pred, 6, average)
        want = skm.f1_score(y_true, y_pred, labels=range(6), average=average)
        np.testing.assert_array_equal(got, want)
        if average is None:
            assert got[4] == 0.0 and got.dtype == np.float64
        else:
            assert isinstance(got, float)


def test_f1_weighted_without_true_samples_is_the_mean():
    y_true, y_pred = [6, 6, 7], [0, 1, 1]
    for average in ("weighted", "macro", "micro"):
        assert psm.f1_score(y_true, y_pred, 3, average) == skm.f1_score(
            y_true, y_pred, labels=range(3), average=average)


def test_confusion_matrices_match_sklearn():
    for seed in range(3):
        y_true, y_pred = _labels(seed)
        cm = psm.confusion_matrix(y_true, y_pred, 6)
        want = skm.confusion_matrix(y_true, y_pred, labels=range(6))
        assert cm.dtype == want.dtype
        np.testing.assert_array_equal(cm, want)
        np.testing.assert_array_equal(
            psm.multilabel_confusion_matrix(y_true, y_pred, 6),
            skm.multilabel_confusion_matrix(y_true, y_pred, labels=range(6)))
    with pytest.raises(ValueError, match="y_true"):
        psm.confusion_matrix([7, 8], [0, 1], 6)
    assert not psm.confusion_matrix([], [], 3).any()


def test_segmentation_metrics_match_jax():
    rng = np.random.default_rng(5)
    cls_pred = [rng.integers(0, 6, (50, 1)).astype(float) for _ in range(3)]
    cls_gt = [{"labels": rng.integers(0, 6, 50).astype(float)}
              for _ in range(3)]
    got = pp.SegmentationMetrics(cls_pred, cls_gt)
    want = jpp.SegmentationMetrics(cls_pred, cls_gt)
    for average in (None, "micro", "macro", "weighted"):
        np.testing.assert_array_equal(got.get_f1(6, average),
                                      want.get_f1(6, average))
    np.testing.assert_array_equal(got.get_confusion_matrix(6),
                                  want.get_confusion_matrix(6))
    np.testing.assert_array_equal(got.get_confusion_matrices_per_class(6),
                                  want.get_confusion_matrices_per_class(6))


# -- the evaluator -----------------------------------------------------------

def _perfect_class_probs(labels, n_classes=6):
    probs = np.full((len(labels), n_classes), 0.01)
    probs[np.arange(len(labels)), labels.astype(int)] = 0.9
    return probs


def _evaluate(module, config, seed=2):
    rng = np.random.default_rng(seed)
    pos, vel, labels, boxes = _frame(rng)
    preds = {"bounding_box_predictions": [np.nan_to_num(boxes, nan=0.0)],
             "class_probability_prediction": [_perfect_class_probs(labels)]}
    gts = {"bounding_box_true": [boxes], "class_true": [labels]}
    if module is pp:
        post, ev = pp.Postprocessor("cpu"), pp.RadarscenesEvaluator(
            config, device="cpu")
    else:
        post, ev = jpp.Postprocessor(), jpp.RadarscenesEvaluator(config)
    bb_p, bb_g, cls_p, cls_g = post.process(config, [pos], [vel], preds, gts)
    ev.evaluate(bb_p, bb_g, cls_p, module.PredictionExtractor().extract(
        preds), cls_g)
    return ev


def test_radarscenes_evaluator_end_to_end(tmp_path):
    ev = _evaluate(pp, _config(PostProcessingConfiguration))
    want = _evaluate(jpp, _config(JaxConfig))
    assert ev.mAP == pytest.approx(1.0) and ev.mAP == want.mAP
    np.testing.assert_array_equal(ev.f1_segmentation, want.f1_segmentation)
    np.testing.assert_array_equal(ev.confusion_absolute,
                                  want.confusion_absolute)
    np.testing.assert_array_equal(ev.confusion_relative,
                                  want.confusion_relative)

    folder = ev.save_results(str(tmp_path))
    assert folder == f"{tmp_path}/evaluation_01"
    assert sorted(os.listdir(folder)) == [
        "confusion.png", "confusion_abs.npy", "confusion_rel.npy",
        "eval_configs.json", "eval_results.json"]
    with open(os.path.join(folder, "eval_results.json")) as f:
        res = json.load(f)
    assert res["OBJECT_DETECTION_METRICS"]["mAP"] == pytest.approx(1.0)
    assert len(res["SEMANTIC_SEGMENTATION_METRICS"]["f1"]) == 6
    np.testing.assert_array_equal(
        np.load(os.path.join(folder, "confusion_abs.npy")),
        ev.confusion_absolute)
    ev.save_results(str(tmp_path))
    assert os.path.isdir(os.path.join(str(tmp_path), "evaluation_02"))
    assert pev.get_new_evaluation_folder_path(str(tmp_path)) == \
        jpp.get_new_evaluation_folder_path(str(tmp_path)) == \
        f"{tmp_path}/evaluation_03"


def test_evaluator_without_matplotlib_writes_every_number(tmp_path, capsys,
                                                          monkeypatch):
    """Where matplotlib does not import, every artifact is written,
    confusion.png included (the port's own figure code draws it: a
    600 x 600 PNG its reader reads), and nothing is printed."""
    ev = _evaluate(pp, _config(PostProcessingConfiguration))
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    capsys.readouterr()
    folder = ev.save_results(str(tmp_path))
    assert sorted(os.listdir(folder)) == [
        "confusion.png", "confusion_abs.npy", "confusion_rel.npy",
        "eval_configs.json", "eval_results.json"]
    assert capsys.readouterr().out == ""
    image = png.read_png(os.path.join(folder, "confusion.png"))
    assert image.shape == (600, 600, 4)
    assert (image[..., :3] < 255).any(axis=-1).mean() > 0.01


def test_evaluation_selector():
    assert pp.evaluation_selector("radarscenes") is pp.RadarscenesEvaluator
    from radargnn_tpu_torch.data.nuscenes.evaluation import NuscenesEvaluator
    assert pp.evaluation_selector("nuscenes") is NuscenesEvaluator
    with pytest.raises(KeyError):
        pp.evaluation_selector("kitti")


def test_plots_draw(tmp_path, monkeypatch):
    """The plotting functions draw with matplotlib blocked: the port's own
    figure code lays them out and writes PNGs its reader reads."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    rng = np.random.default_rng(6)
    pos, _, labels, boxes = _frame(rng)
    dets = pp.Postprocessor("cpu").process_one_raw_prediction(
        _config(PostProcessingConfiguration), pos,
        np.nan_to_num(boxes, nan=0.0), _perfect_class_probs(labels),
        device="cpu")
    fig, _ = pvis.PredictionVisualizer.plot_detections(
        dets[0], dets[1], label_names=["car", "ped", "group", "two", "large",
                                       "bg"])
    fig.savefig(tmp_path / "dets.png")
    fig, _ = pvis.plot_graph(pos, np.arange(10), np.arange(1, 11))
    fig.savefig(tmp_path / "graph.png")
    fig = pvis.plot_confusion_matrix(np.eye(3) * 4, ["a", "b", "c"], True)
    fig.savefig(tmp_path / "cm.png")
    for name, size in (("dets", (480, 640)), ("graph", (480, 640)),
                       ("cm", (600, 600))):
        assert png.read_png(str(tmp_path / f"{name}.png")).shape == (*size, 4)
