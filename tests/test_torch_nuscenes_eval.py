"""The port's nuScenes evaluation (radargnn_tpu_torch.data.nuscenes:
`detection_eval`, `submission`, `evaluation.NuscenesEvaluator`) on the
CPU: every case `tests/test_nuscenes_pipeline.py` asserts of the native
detection eval, against the port's modules, and the port against the JAX
package on the same inputs (the metrics dict of a noisy submission, the
submission itself, the evaluator's files end to end)."""

import json
import os
import sys

import numpy as np
import pytest

from radargnn_tpu import configs as jcfg
from radargnn_tpu.data.nuscenes import dataset_creation as jdc
from radargnn_tpu.data.nuscenes import db as jdb
from radargnn_tpu.data.nuscenes import detection_eval as jde
from radargnn_tpu.data.nuscenes import evaluation as jev
from radargnn_tpu.data.nuscenes import submission as jsub
from radargnn_tpu.postprocess import extraction as jext
from radargnn_tpu_torch import configs as tcfg
from radargnn_tpu_torch.benchmarks import nuscenes_e2e
from radargnn_tpu_torch.data.nuscenes import db as tdb
from radargnn_tpu_torch.data.nuscenes import detection_eval as tde
from radargnn_tpu_torch.data.nuscenes import evaluation as tev
from radargnn_tpu_torch.data.nuscenes import submission as tsub
from radargnn_tpu_torch.data.nuscenes import splits_vendored as tvendored
from radargnn_tpu_torch.graph.batch import GraphSample
from radargnn_tpu_torch.postprocess import extraction as text
from tests import test_nuscenes_pipeline as jtests

METRIC_ATOL = 1e-9
TP_NAMES = ("trans_err", "scale_err", "orient_err", "vel_err", "attr_err")


def _box(translation, score=None, velocity=(0, 0), name="car", token="s1"):
    box = {"translation": translation, "size": (2, 4, 1.5),
           "rotation": (1, 0, 0, 0), "detection_name": name,
           "attribute_name": "vehicle.moving", "velocity": velocity}
    if score is not None:
        box.update(detection_score=score, sample_token=token)
    return box


# -- the JAX tests' cases, on the port's modules -----------------------------

def test_native_detection_eval_perfect_predictions(tmp_path):
    root = jtests._make_nuscenes_root(tmp_path)
    nusc = tdb.NuScenes("v1.0-mini", os.path.join(root, "raw"))
    tokens = [s["token"] for s in nusc.sample]
    gt, ego = tde.ground_truth_from_db(nusc, tokens)
    results = {t: [dict(b, detection_score=0.9, sample_token=t)
                   for b in gt[t]] for t in tokens}
    out = tde.NuScenesDetectionEval({"results": results}, gt, ego).evaluate()
    assert out["label_aps"]["car"] == pytest.approx(1.0)
    # the mean over all 10 classes: the 9 absent ones score AP 0, TP 1.0
    assert out["mean_ap"] == pytest.approx(0.1)
    assert out["tp_errors"]["trans_err"] == pytest.approx(0.9)
    assert out["tp_errors"]["scale_err"] == pytest.approx(0.9)
    # traffic_cone's orientation is excluded: the mean over 9
    assert out["tp_errors"]["orient_err"] == pytest.approx(8 / 9)
    # single annotations: NaN velocities, so the car's vel_err is 1.0;
    # traffic_cone and barrier are excluded from vel and attr
    assert out["tp_errors"]["vel_err"] == pytest.approx(1.0)
    assert out["tp_errors"]["attr_err"] == pytest.approx(7 / 8)
    tp = sum(max(1.0 - out["tp_errors"][n], 0.0) for n in TP_NAMES)
    assert out["nd_score"] == pytest.approx((5 * 0.1 + tp) / 10)


def test_native_detection_eval_misses():
    gt = {"s1": [_box((0, 0, 0))]}
    results = {"s1": [_box((10, 0, 0), 0.9)]}     # no match at any threshold
    out = tde.NuScenesDetectionEval({"results": results}, gt,
                                    {"s1": (0.0, 0.0)}).evaluate()
    assert out["label_aps"]["car"] == 0.0


def test_calc_ap_clipping():
    assert tde._calc_ap(np.ones(101)) == pytest.approx(1.0)
    assert tde._calc_ap(np.full(101, 0.1)) == pytest.approx(0.0)


def test_tp_error_cumulative_mean_over_recall_oracle():
    """Two TPs at scores .9/.8 with translation errors 1.0 and 0.0: the TP
    curve is 1.0 to recall bin 50, then 1.0 - 0.01 (i - 50); its mean over
    bins 11..100 is 77.25 / 90."""
    gt = {"s1": [_box((0, 0, 0)), _box((30, 0, 0))]}
    results = {"s1": [_box((1.0, 0, 0), 0.9), _box((30.0, 0, 0), 0.8)]}
    ev = tde.NuScenesDetectionEval({"results": results}, gt,
                                   {"s1": (0.0, 0.0)})
    md = ev._accumulate("car", 2.0, {"s1": ev._filter(gt["s1"], "s1")},
                        {"s1": ev._filter(results["s1"], "s1")}, ["s1"])
    assert tde._calc_tp(md, "trans_err") == pytest.approx(77.25 / 90)
    assert tde._calc_tp(md, "scale_err") == pytest.approx(0.0)
    assert tde._calc_ap(md.precision) == pytest.approx(1.0)
    np.testing.assert_allclose(tde._cummean(np.array([np.nan, np.nan])),
                               [1.0, 1.0])
    np.testing.assert_allclose(tde._cummean(np.array([np.nan, 2.0, 4.0])),
                               [0.0, 2.0, 3.0])


def test_box_velocity_devkit_oracle(tmp_path):
    """Centered differences inside a track, one-sided at its ends, NaN for
    a single annotation and past the time-gap rule."""
    root, _, ann = jtests._make_moving_instance_root(tmp_path)
    nusc = tdb.NuScenes("v1.0-mini", root)
    for a in ann:
        np.testing.assert_allclose(nusc.box_velocity(a), [4.0, 0.0, 0.0],
                                   atol=1e-9)
    assert np.isnan(nusc.box_velocity("a_ped")).all()
    root2, _, ann2 = jtests._make_moving_instance_root(tmp_path / "g",
                                                       dts=(2.0, 2.0))
    nusc2 = tdb.NuScenes("v1.0-mini", root2)
    assert np.isnan(nusc2.box_velocity(ann2[0])).all()
    assert np.isnan(nusc2.box_velocity(ann2[1])).all()
    root3, _, ann3 = jtests._make_moving_instance_root(tmp_path / "h",
                                                       dts=(1.4, 1.4))
    nusc3 = tdb.NuScenes("v1.0-mini", root3)
    for a in ann3[:2]:
        np.testing.assert_allclose(nusc3.box_velocity(a), [4.0, 0.0, 0.0],
                                   atol=1e-9)


def test_gt_velocity_reaches_ave(tmp_path):
    """A perfect-position prediction of velocity 0 against the 4 m/s car:
    vel_err 4, so the mean over the eight velocity-scored classes is
    (7 + 4) / 8."""
    root, toks, _ = jtests._make_moving_instance_root(tmp_path)
    nusc = tdb.NuScenes("v1.0-mini", root)
    gt, ego = tde.ground_truth_from_db(nusc, toks)
    for tok in toks:
        car = [b for b in gt[tok] if b["detection_name"] == "car"]
        np.testing.assert_allclose(car[0]["velocity"], [4.0, 0.0], atol=1e-9)
    ped = [b for b in gt[toks[0]] if b["detection_name"] == "pedestrian"]
    assert len(ped) == 1 and np.isnan(ped[0]["velocity"]).all()
    results = {tok: [dict(b, velocity=[0.0, 0.0], sample_token=tok,
                          detection_score=0.9 - 0.1 * i)
                     for b in gt[tok] if b["detection_name"] == "car"]
               for i, tok in enumerate(toks)}
    out = tde.NuScenesDetectionEval({"results": results}, gt, ego).evaluate()
    np.testing.assert_allclose(out["tp_errors"]["vel_err"], (7 + 4.0) / 8,
                               atol=1e-6)


def test_gt_zero_point_boxes_excluded(tmp_path):
    root, toks, ann = jtests._make_moving_instance_root(tmp_path)
    path = os.path.join(root, "v1.0-mini", "sample_annotation.json")
    with open(path) as f:
        rows = json.load(f)
    for row in rows:
        if row["token"] == ann[0]:
            row["num_lidar_pts"] = row["num_radar_pts"] = 0
    with open(path, "w") as f:
        json.dump(rows, f)
    gt, _ = tde.ground_truth_from_db(tdb.NuScenes("v1.0-mini", root), toks)
    assert [b["detection_name"] for b in gt[toks[0]]] == ["pedestrian"]
    assert [b["detection_name"] for b in gt[toks[1]]] == ["car"]


# -- the port against the JAX package ----------------------------------------

@pytest.fixture(scope="module")
def writer_raw(tmp_path_factory):
    """The writer's trainval tables: 3 samples of a train and a val scene,
    moving instances of eight classes, one zero-point annotation."""
    root = nuscenes_e2e.write_nuscenes_tables(
        str(tmp_path_factory.mktemp("nusc")),
        ((tvendored.train_detect[0], "scene-9001", 3),
         (tvendored.val[0], "scene-9003", 3)),
        version="v1.0-trainval", sweeps=2, points_per_sweep=16)
    return os.path.join(root, "raw")


def _assert_metrics_close(got, want, atol=METRIC_ATOL, where="metrics"):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            _assert_metrics_close(got[k], want[k], atol, f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_metrics_close(a, b, atol, f"{where}[{i}]")
    elif isinstance(want, float) and np.isnan(want):
        assert np.isnan(got), where
    elif isinstance(want, (int, float)) and not isinstance(want, bool):
        assert got == pytest.approx(want, abs=atol), where
    else:
        assert got == want, where


def _noisy_submission(gt, seed=0):
    """Per ground-truth box: kept with probability 0.8, its centre moved by
    N(0, 0.8 m), its size, yaw and velocity perturbed, a random score, one
    in ten renamed to another class; plus false positives."""
    rng = np.random.default_rng(seed)
    names = sorted(tde.CLASS_RANGE)
    results = {}
    for tok, boxes in gt.items():
        preds = []
        for b in boxes:
            if rng.uniform() > 0.8:
                continue
            x, y, z = b["translation"]
            yaw = tde._yaw_from_rotation(b["rotation"]) + rng.normal(0, 0.3)
            preds.append({
                "sample_token": tok,
                "translation": (x + rng.normal(0, 0.8),
                                y + rng.normal(0, 0.8), z),
                "size": tuple(np.asarray(b["size"])
                              * rng.uniform(0.8, 1.2, 3)),
                "rotation": (np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)),
                "velocity": tuple(rng.normal(0, 2, 2)),
                "detection_name": (names[rng.integers(len(names))]
                                   if rng.uniform() < 0.1
                                   else b["detection_name"]),
                "detection_score": float(rng.uniform(0.05, 1.0)),
                "attribute_name": b["attribute_name"]})
        for _ in range(3):
            preds.append(dict(preds[0] if preds else {}, **{
                "sample_token": tok,
                "translation": tuple(rng.uniform(-20, 20, 3)),
                "size": (2.0, 4.0, 1.5), "rotation": (1.0, 0.0, 0.0, 0.0),
                "velocity": (0.0, 0.0),
                "detection_name": names[rng.integers(len(names))],
                "detection_score": float(rng.uniform(0.05, 1.0)),
                "attribute_name": ""}))
        results[tok] = preds
    return results


def test_detection_eval_matches_jax(writer_raw):
    """The same tables give both packages the same ground truth and ego
    positions, and a noisy submission over them the same metrics dict
    within 1e-9."""
    t, j = (mod.NuScenes("v1.0-trainval", writer_raw) for mod in (tdb, jdb))
    tokens = [s["token"] for s in j.sample]
    gt_t, ego_t = tde.ground_truth_from_db(t, tokens)
    gt_j, ego_j = jde.ground_truth_from_db(j, tokens)
    _assert_metrics_close(gt_t, gt_j, atol=0.0, where="ground truth")
    assert ego_t == ego_j
    # the zero-point annotation is dropped, every box has a finite velocity
    assert sum(len(v) for v in gt_j.values()) == 6 * 8 - 1
    assert all(np.isfinite(b["velocity"]).all() for v in gt_j.values()
               for b in v)
    for seed in range(3):
        sub = {"results": _noisy_submission(gt_j, seed)}
        got = tde.NuScenesDetectionEval(sub, gt_t, ego_t).evaluate()
        want = jde.NuScenesDetectionEval(sub, gt_j, ego_j).evaluate()
        _assert_metrics_close(got, want)
        assert 0.0 < got["mean_ap"] < 1.0


class _Boxes:
    """The one method of a box array that `convert_results` reads."""

    def __init__(self, xylwt):
        self.xylwt = xylwt

    def __len__(self):
        return len(self.xylwt)

    def to_xylwt(self):
        return self.xylwt.copy()


def test_get_submission_matches_jax(writer_raw):
    rng = np.random.default_rng(3)
    j = jdb.NuScenes("v1.0-trainval", writer_raw)
    t = tdb.NuScenes("v1.0-trainval", writer_raw)
    names, preds, vels = [], [], []
    for k, sample in enumerate(j.sample):
        names.append(f"/data/validate/graph_{sample['timestamp']}_"
                     f"{sample['scene_token']}_{sample['token']}.npz")
        n = k % 4
        xylwt = np.column_stack([rng.uniform(-30, 30, (n, 2)),
                                 rng.uniform(0.5, 5, (n, 2)),
                                 rng.uniform(-180, 180, n)])
        preds.append({"boxes": _Boxes(xylwt),
                      "labels": rng.integers(1, 11, n),
                      "scores": rng.uniform(0, 1, n)})
        vels.append(rng.normal(0, 1, (n, 2)))
    got = tsub.get_submission(t, preds, vels, names)
    want = jsub.get_submission(j, preds, vels, names)
    assert json.dumps(got) == json.dumps(want)
    assert sum(map(len, got["results"].values())) == sum(
        k % 4 for k in range(len(names)))
    assert tsub.get_sample_token(names[0]) == j.sample[0]["token"]
    for name in ("HEIGHT_MAP", "DETECTION_NAMES", "ATTRIBUTE_NAME_MAP"):
        assert getattr(tsub, name) == getattr(jsub, name)


def _perfect_predictions(graph_names):
    """`tests/test_nuscenes_pipeline.py`'s perfect predictions from the
    stored ground truth."""
    raw_pos, raw_vel = [], []
    preds = {"bounding_box_predictions": [],
             "class_probability_prediction": []}
    gts = {"bounding_box_true": [], "class_true": []}
    for name in graph_names:
        s = GraphSample.load_npz(name)
        raw_pos.append(s.pos.astype(np.float64))
        raw_vel.append(s.vel.astype(np.float64))
        probs = np.full((s.num_nodes, 11), 0.005)
        probs[np.arange(s.num_nodes), s.labels] = 0.9
        preds["bounding_box_predictions"].append(
            np.nan_to_num(s.boxes.astype(np.float64)))
        preds["class_probability_prediction"].append(probs)
        gts["bounding_box_true"].append(s.boxes.astype(np.float64))
        gts["class_true"].append(s.labels.astype(np.float64))
    return raw_pos, raw_vel, preds, gts


def _post_config(pkg):
    return pkg.PostProcessingConfiguration(
        split="validate", iou_for_nms=0.01,
        min_object_score={n: 0.3 for n in
                          ("barrier", "bicycle", "bus", "car", "construction",
                           "motorcycle", "pedestrian", "trafficcone",
                           "trailer", "truck")},
        max_score_for_background=0.5, iou_for_mAP=0.3, use_point_iou=True,
        bg_index=0, bb_invariance="translation")


@pytest.mark.parametrize("tables", ["jax_fixture", "writer_trainval"])
def test_nuscenes_evaluator_matches_jax(tmp_path, monkeypatch, capsys,
                                        tables):
    """The JAX test's end-to-end evaluation with perfect predictions (its
    v1.0-mini root, or the writer's trainval tables with eight classes),
    by each package: the same submission.json, nuscenes_metrics.json,
    eval_results.json and confusion matrices. On the port's side matplotlib
    does not import: confusion.png is not drawn, one line says so, every
    other file is written."""
    if tables == "jax_fixture":
        root, version = jtests._make_nuscenes_root(tmp_path), "v1.0-mini"
    else:
        root = nuscenes_e2e.write_nuscenes_tables(
            str(tmp_path / "nusc"),
            ((tvendored.train_detect[0], "scene-9001", 2),
             (tvendored.val[0], "scene-9003", 3)),
            version="v1.0-trainval", sweeps=2, points_per_sweep=16)
        version = "v1.0-trainval"
    jdc.NuScenesGraphDataset(root, jcfg.GraphConstructionConfiguration(
        "knn", {"k": 4, "r": 1.0}, ["rcs", "velocity_vector", "degree"],
        ["relative_position"], "directed", "X"),
        jcfg.NuScenesDatasetConfiguration(
            version=version, nsweeps=2, crop_point_cloud=True,
            crop_settings={"x": 100, "y": 100}, bb_invariance="translation"))
    graph_names = sorted(
        os.path.join(root, "processed", "validate", n)
        for n in os.listdir(os.path.join(root, "processed", "validate")))
    pos, vel, preds, gts = _perfect_predictions(graph_names)
    folders = {}
    for name in ("jax", "port"):
        model = str(tmp_path / f"model_{name}")
        os.makedirs(model)
        if name == "jax":
            config = _post_config(jcfg)
            post = jext.Postprocessor().process(config, pos, vel, preds, gts)
            labels = jext.PredictionExtractor().extract(preds)
            ev = jev.NuscenesEvaluator(
                config=config, version=version,
                dataset_path=os.path.join(root, "raw"), model_path=model)
        else:
            monkeypatch.setitem(sys.modules, "matplotlib", None)
            config = _post_config(tcfg)
            post = text.Postprocessor("cpu").process(config, pos, vel, preds,
                                                     gts)
            labels = text.PredictionExtractor().extract(preds)
            ev = tev.NuscenesEvaluator(
                config=config, version=version,
                dataset_path=os.path.join(root, "raw"), model_path=model,
                device="cpu")
            capsys.readouterr()
        bb_p, bb_g, cls_p, cls_g = post
        ev.evaluate(bb_p, bb_g, cls_p, labels, cls_g, vel,
                    graph_names=graph_names)
        folders[name] = ev.save_results()
    said = capsys.readouterr().out.strip().splitlines()
    assert len(said) == 1 and "confusion.png not drawn" in said[0] \
        and "matplotlib" in said[0]
    port, jax_ = folders["port"], folders["jax"]
    assert port.endswith("model_port/evaluation_01")
    assert sorted(os.listdir(port)) == sorted(
        f for f in os.listdir(jax_) if f != "confusion.png")
    for name in ("submission.json", "nuscenes_metrics.json",
                 "eval_results.json", "eval_configs.json"):
        with open(os.path.join(port, name)) as f:
            with open(os.path.join(jax_, name)) as g:
                _assert_metrics_close(json.load(f), json.load(g),
                                      where=name)
    for name in ("confusion_abs.npy", "confusion_rel.npy"):
        np.testing.assert_array_equal(np.load(os.path.join(port, name)),
                                      np.load(os.path.join(jax_, name)))
    with open(os.path.join(port, "nuscenes_metrics.json")) as f:
        metrics = json.load(f)
    present = [c for c, ap in metrics["label_aps"].items() if ap > 0]
    assert len(present) == (1 if tables == "jax_fixture" else 8)
    assert all(metrics["label_aps"][c] > 0.9 for c in present)
    assert metrics["mean_ap"] == pytest.approx(
        sum(metrics["label_aps"].values()) / 10)
