"""The port's command line on nuScenes (radargnn_tpu_torch.cli) on the CPU,
against the JAX package's: `cli.main.main` under
`configurations/configuration_nuscenes.yml` at narrow widths (conv
[16, 16], k 4, v1.0-mini; NARROW) on `tests/test_nuscenes_pipeline.py`'s
tables resolves the dense (v4) tiling and writes the JAX CLI's files, and
a model folder the JAX train CLI wrote evaluates in the port's evaluate
CLI to the JAX evaluation's results, and the other way round.

One JAX pipeline run and one port pipeline run, each on its own copy of
the tables, are shared by the module's tests. The JAX run trains on the
unfused path (`use_fused_aggregation: False`): its dense (v4) training on
these frames (150 points in a 256-node bucket, receivers left empty) is
non-finite from the second step (ROADMAP.md C7). The port's run takes
the configuration as NARROW leaves it, on the dense tiling."""

import io
import json
import os
import shutil
from contextlib import redirect_stdout

import numpy as np
import pytest

from radargnn_tpu.cli import evaluate as jevaluate
from radargnn_tpu.cli import main as jmain
from radargnn_tpu_torch import smoke
from radargnn_tpu_torch.cli import evaluate as tevaluate
from radargnn_tpu_torch.cli import main as tmain
from tests import test_nuscenes_pipeline as jtests

import host_backends
from host_backends import native_cache  # noqa: F401

# the nuScenes YAML's fields the tests replace: the mini split and narrow
# widths, two epochs
NARROW = {"version": "v1.0-mini",
          "graph_construction_settings": {"k": 4, "r": 1},
          "conv_layer_dimensions": [16, 16],
          "node_feature_embedding_layer_dimensions": [8, 16],
          "edge_feature_embedding_layer_dimensions": [4, 8],
          "regression_head_layer_dimensions": [8, 5], "epochs": 2}
MODEL_FILES = {"gnn_configs.json", "dataset_configs.json",
               "trained_model.msgpack", "loss_train.npy",
               "loss_validation.npy", "loss_train_cls.npy",
               "loss_train_bb.npy", "loss_curves.png"}
EVAL_FILES = {"eval_configs.json", "eval_results.json", "confusion_abs.npy",
              "confusion_rel.npy", "confusion.png", "submission.json",
              "nuscenes_metrics.json"}
# one model folder evaluated by the two packages: the same weights and
# inputs, float32 forwards in other summation orders
METRIC_ATOL = 1e-4


def _config(tmp, fused=True):
    path = smoke.cli_config(str(tmp), smoke.NUSCENES_CONFIG, NARROW,
                            "nuscenes.yml" if fused else "unfused.yml")
    if not fused:
        with open(path) as f:
            text = f.read()
        text = text.replace("        batch_norm_in_mlps: False",
                            "        batch_norm_in_mlps: False\n"
                            "        use_fused_aggregation: False")
        assert "use_fused_aggregation: False" in text
        with open(path, "w") as f:
            f.write(text)
    return path


@pytest.fixture(scope="module")
def runs(tmp_path_factory, native_cache):  # noqa: F811
    """The JAX package's main (unfused) and the port's main on their own
    copies of the tables, both packages on one pair of host backends; the
    port's printed lines."""
    tmp = tmp_path_factory.mktemp("cli_nuscenes")
    out = {"port_config": _config(tmp), "jax_config": _config(tmp, False)}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RADARGNN_NATIVE_CACHE", str(native_cache))
        host_backends.pin(mp.setattr)
        for name in ("jax", "port"):
            root = jtests._make_nuscenes_root(tmp / name)
            results = str(tmp / name / "results")
            os.makedirs(results)
            if name == "port":
                buf = io.StringIO()
                with redirect_stdout(buf):
                    tmain.main(root, results, out["port_config"],
                               device="cpu")
                out["printed"] = buf.getvalue()
            else:
                jmain.main(root, results, out["jax_config"])
            out[name] = (root, results)
    return out


def _listing(root, results):
    processed = os.path.join(root, "processed")
    model = os.path.join(results, "model_01")
    return {
        "processed": sorted(os.listdir(processed)),
        "splits": {s: sorted(os.listdir(os.path.join(processed, s)))
                   for s in ("train", "validate")},
        "results": sorted(os.listdir(results)),
        "model": sorted("trained_model_low_val.msgpack" if f.startswith(
            "trained_model_low_val_ep") else f for f in os.listdir(model)),
        "evaluation": sorted(os.listdir(os.path.join(model,
                                                     "evaluation_01"))),
    }


def test_main_writes_the_jax_packages_files(runs):
    """The same processed splits (graph_<timestamp>_<scene>_<sample>.npz),
    model folder and evaluation folder; the port on the dense tiling
    (auto on the kNN graph), finite losses and metrics."""
    port, jax_ = _listing(*runs["port"]), _listing(*runs["jax"])
    assert port == jax_
    assert MODEL_FILES <= set(port["model"])
    assert set(port["evaluation"]) == EVAL_FILES
    assert port["splits"]["train"][0].startswith("graph_1000000_scenetok0_")
    printed = runs["printed"]
    assert ">>> fused aggregation: dense (v4) kernels, 8 slots/receiver" \
        in printed
    assert "Train device: cpu" in printed
    losses = np.load(os.path.join(runs["port"][1], "model_01",
                                  "loss_train.npy"))
    assert losses.shape == (1, 2) and np.isfinite(losses).all()
    folder = os.path.join(runs["port"][1], "model_01", "evaluation_01")
    with open(os.path.join(folder, "nuscenes_metrics.json")) as f:
        metrics = json.load(f)
    assert 0.0 <= metrics["mean_ap"] <= 1.0
    assert 0.0 <= metrics["nd_score"] <= 1.0
    with open(os.path.join(folder, "eval_results.json")) as f:
        res = json.load(f)
    assert res["OBJECT_DETECTION_METRICS"] == {}      # get_mAP: False
    assert np.isfinite(res["SEMANTIC_SEGMENTATION_METRICS"]["f1"]).all()
    with open(os.path.join(folder, "submission.json")) as f:
        sub = json.load(f)
    assert sorted(sub["results"]) == ["sample1x0", "sample1x1"]


def _results(folder):
    with open(os.path.join(folder, "nuscenes_metrics.json")) as f:
        metrics = json.load(f)
    with open(os.path.join(folder, "eval_results.json")) as f:
        res = json.load(f)
    return (metrics,
            np.asarray(res["SEMANTIC_SEGMENTATION_METRICS"]["f1"], float),
            np.load(os.path.join(folder, "confusion_abs.npy")))


def _assert_close(got, want, where):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            _assert_close(got[k], want[k], f"{where}.{k}")
    else:
        assert got == pytest.approx(want, abs=METRIC_ATOL, nan_ok=True), where


@pytest.mark.parametrize("trained_by", ["jax", "port"])
def test_model_folders_evaluate_across_packages(runs, tmp_path, trained_by):
    """A model folder one package's CLI trained and evaluated, evaluated by
    the other package's evaluate CLI on the same processed split and
    configuration (the JAX folder on the unfused path, the port's on the
    dense tiling): the first evaluation's nuscenes_metrics.json and F1
    within METRIC_ATOL, the same confusion matrix."""
    root, results = runs[trained_by]
    model = str(tmp_path / "model_01")
    shutil.copytree(os.path.join(results, "model_01"), model,
                    ignore=shutil.ignore_patterns("evaluation_*"))
    if trained_by == "jax":
        tevaluate.main(root, model, runs["jax_config"], device="cpu")
    else:
        jevaluate.main(root, model, runs["port_config"])
    got = _results(os.path.join(model, "evaluation_01"))
    want = _results(os.path.join(results, "model_01", "evaluation_01"))
    np.testing.assert_array_equal(got[2], want[2])
    _assert_close(got[0], want[0], "nuscenes_metrics")
    np.testing.assert_allclose(got[1], want[1], atol=METRIC_ATOL)
    assert set(os.listdir(os.path.join(model, "evaluation_01"))) == \
        EVAL_FILES
