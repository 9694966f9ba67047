"""The port's command-line pipeline (radargnn_tpu_torch.cli) on the CPU,
against the JAX package's: `cli.main.main` on `tests/test_cli_e2e.py`'s
configuration (create_dataset -> train -> evaluate) writes the same files
and resolves the same tiling (dense, from "auto" on the kNN graph); a
model folder written by either package's train CLI evaluates in the other
package's evaluate CLI to the same results; the argument checks; and
`Trainer.save_results` where matplotlib does not import.

One JAX pipeline run and one port pipeline run, each on its own copy of
the raw data, are shared by the module's tests. The JAX run trains on the
unfused path (`use_fused_aggregation: False`): its dense (v4) backward,
in interpret mode on this configuration, gives non-finite gradients at
the first step, so its losses are NaN from the second (ROADMAP.md C7). The
port's run takes the configuration verbatim, on the dense tiling."""

import io
import json
import os
import shutil
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

pytest.importorskip("h5py")

from radargnn_tpu.cli import evaluate as jevaluate  # noqa: E402
from radargnn_tpu.cli import main as jmain  # noqa: E402
from radargnn_tpu_torch.cli import create_dataset as tcreate  # noqa: E402
from radargnn_tpu_torch.cli import evaluate as tevaluate  # noqa: E402
from radargnn_tpu_torch.cli import main as tmain  # noqa: E402
from radargnn_tpu_torch.cli import train as ttrain  # noqa: E402
from radargnn_tpu_torch.configs import UserConfigurationReader  # noqa: E402
from radargnn_tpu_torch.models.detnet import DetNet  # noqa: E402
from radargnn_tpu_torch.train.trainer import Trainer  # noqa: E402
from tests.test_cli_e2e import CONFIG_YAML  # noqa: E402
from tests.test_radarscenes_pipeline import _make_dataset_root  # noqa: E402

import host_backends  # noqa: E402
from host_backends import native_cache  # noqa: E402,F401

MODEL_FILES = {"gnn_configs.json", "dataset_configs.json",
               "trained_model.msgpack", "loss_train.npy",
               "loss_validation.npy", "loss_train_cls.npy",
               "loss_train_bb.npy", "loss_curves.png"}
EVAL_FILES = {"eval_configs.json", "eval_results.json", "confusion_abs.npy",
              "confusion_rel.npy", "confusion.png"}
# mAP and F1 of one model folder evaluated by the two packages: the same
# weights and inputs, float32 forwards in other summation orders (1e-6 in
# the class probabilities)
METRIC_ATOL = 1e-4


def _config(tmp, name="config.yml", epochs=2, fused=True):
    text = CONFIG_YAML.format(epochs=epochs)
    if not fused:
        text = text.replace("        batch_norm_in_mlps: False",
                            "        batch_norm_in_mlps: False\n"
                            "        use_fused_aggregation: False")
        assert "use_fused_aggregation: False" in text
    path = str(tmp / name)
    with open(path, "w") as f:
        f.write(text)
    return path


@pytest.fixture(scope="module")
def runs(tmp_path_factory, native_cache):  # noqa: F811
    """The JAX package's main (unfused) and the port's main (the
    configuration verbatim) on the same raw data, two epochs, both packages
    on one pair of host backends; the port's printed lines."""
    tmp = tmp_path_factory.mktemp("cli")
    out = {"port_config": _config(tmp),
           "jax_config": _config(tmp, "unfused.yml", fused=False)}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RADARGNN_NATIVE_CACHE", str(native_cache))
        host_backends.pin(mp.setattr)
        for name, main in (("jax", jmain.main), ("port", tmain.main)):
            root = _make_dataset_root(tmp / name, num_train=2, num_val=1)
            results = str(tmp / name / "results")
            os.makedirs(results)
            if name == "port":
                buf = io.StringIO()
                with redirect_stdout(buf):
                    main(root, results, out["port_config"], device="cpu")
                out["printed"] = buf.getvalue()
            else:
                main(root, results, out["jax_config"])
            out[name] = (root, results)
    return out


def _listing(root, results):
    processed = os.path.join(root, "processed")
    model = os.path.join(results, "model_01")
    return {
        "processed": sorted(os.listdir(processed)),
        "splits": {s: sorted(os.listdir(os.path.join(processed, s)))
                   for s in ("train", "test", "validate")},
        "results": sorted(os.listdir(results)),
        # the best-validation snapshot is named by its epoch, which the
        # two packages' different initial weights may choose differently
        "model": sorted("trained_model_low_val.msgpack" if f.startswith(
            "trained_model_low_val_ep") else f for f in os.listdir(model)),
        "evaluation": sorted(os.listdir(os.path.join(model,
                                                     "evaluation_01"))),
    }


def test_main_writes_the_jax_packages_files(runs):
    port, jax_ = _listing(*runs["port"]), _listing(*runs["jax"])
    assert port == jax_
    assert MODEL_FILES <= set(port["model"])
    assert set(port["evaluation"]) == EVAL_FILES
    assert port["results"] == ["model_01"]
    printed = runs["printed"]
    assert ">>> fused aggregation: dense (v4) kernels, 9 slots/receiver" \
        in printed
    assert "Train device: cpu" in printed
    for name in ("jax", "port"):
        losses = np.load(os.path.join(runs[name][1], "model_01",
                                      "loss_train.npy"))
        assert losses.shape == (1, 2) and np.isfinite(losses).all(), name
    root, results = runs["port"]
    model = os.path.join(results, "model_01")
    with open(os.path.join(model, "evaluation_01", "eval_results.json")) as f:
        res = json.load(f)
    assert isinstance(res["OBJECT_DETECTION_METRICS"]["mAP"], float)
    assert np.isfinite(res["SEMANTIC_SEGMENTATION_METRICS"]["f1"]).all()
    configs = []
    for name in ("jax", "port"):
        with open(os.path.join(runs[name][1], "model_01",
                               "gnn_configs.json")) as f:
            configs.append(json.load(f))
    assert configs[0]["GNN_ARCHITECTURE_CONFIG"].pop(
        "use_fused_aggregation") is False
    assert configs[1]["GNN_ARCHITECTURE_CONFIG"].pop(
        "use_fused_aggregation") is True
    assert configs[0] == configs[1]


def _results(folder):
    with open(os.path.join(folder, "eval_results.json")) as f:
        res = json.load(f)
    return (res["OBJECT_DETECTION_METRICS"],
            np.asarray(res["SEMANTIC_SEGMENTATION_METRICS"]["f1"], float),
            np.load(os.path.join(folder, "confusion_abs.npy")))


def _assert_same_results(got_folder, want_folder):
    got_det, got_f1, got_conf = _results(got_folder)
    want_det, want_f1, want_conf = _results(want_folder)
    np.testing.assert_array_equal(got_conf, want_conf)
    assert got_det["mAP"] == pytest.approx(want_det["mAP"], abs=METRIC_ATOL)
    np.testing.assert_allclose(
        np.asarray(got_det["mAP_per_class"], float),
        np.asarray(want_det["mAP_per_class"], float), atol=METRIC_ATOL)
    np.testing.assert_allclose(got_f1, want_f1, atol=METRIC_ATOL)
    with open(os.path.join(got_folder, "eval_configs.json")) as f:
        with open(os.path.join(want_folder, "eval_configs.json")) as g:
            assert json.load(f) == json.load(g)


@pytest.mark.parametrize("trained_by", ["jax", "port"])
def test_model_folders_evaluate_across_packages(runs, tmp_path, trained_by):
    """A model folder one package's CLI trained and evaluated, evaluated by
    the other package's evaluate CLI on the same processed split and
    configuration (the JAX folder on the unfused path, the port's on the
    dense tiling): the same confusion matrix, mAP and F1 within
    METRIC_ATOL."""
    root, results = runs[trained_by]
    model = str(tmp_path / "model_01")
    shutil.copytree(os.path.join(results, "model_01"), model,
                    ignore=shutil.ignore_patterns("evaluation_*"))
    if trained_by == "jax":
        tevaluate.main(root, model, runs["jax_config"], device="cpu")
    else:
        jevaluate.main(root, model, runs["port_config"])
    _assert_same_results(os.path.join(model, "evaluation_01"),
                         os.path.join(results, "model_01", "evaluation_01"))


def test_evaluate_returns_the_predictions(runs, tmp_path):
    """The evaluate CLI's return: its predictions over the split, the
    evaluator and the folder it wrote; a second evaluation at the same
    batch size gives the first's results (BatchNorm runs on the batch's
    statistics, the reference's quirk, so the batch size is part of the
    result)."""
    root, results = runs["port"]
    model = str(tmp_path / "model")
    shutil.copytree(os.path.join(results, "model_01"), model)
    res = tevaluate.main(root, model, runs["port_config"], device="cpu")
    assert res["eval_folder"] == f"{model}/evaluation_02"
    probs = res["predictions"]["class_probability_prediction"]
    assert len(probs) == len(os.listdir(os.path.join(root, "processed",
                                                     "validate")))
    assert all(np.allclose(p.sum(1), 1.0, atol=1e-5) for p in probs)
    assert res["evaluator"].mAP is not None
    _assert_same_results(res["eval_folder"],
                         os.path.join(model, "evaluation_01"))


def test_arguments_are_checked(tmp_path):
    """The JAX CLIs' SystemExit messages for missing folders and files."""
    config = _config(tmp_path)
    folder = str(tmp_path)
    missing = str(tmp_path / "missing")
    cases = [
        (tcreate.cli, ["--dataset", missing, "--config", config],
         "Invalid path for dataset folder"),
        (tcreate.cli, ["--dataset", folder, "--config", missing],
         "Invalid path to config file"),
        (ttrain.cli, ["--data", missing, "--results", folder, "--config",
                      config], "Invalid path for graph data folder"),
        (ttrain.cli, ["--data", folder, "--results", missing, "--config",
                      config], "Invalid path for results folder"),
        (ttrain.cli, ["--data", folder, "--results", folder, "--config",
                      missing], "Invalid path to config file"),
        (tevaluate.cli, ["--data", missing, "--model", folder, "--config",
                         config], "Invalid path for graph data folder"),
        (tevaluate.cli, ["--data", folder, "--model", missing, "--config",
                         config], "Invalid path for model folder"),
        (tevaluate.cli, ["--data", folder, "--model", folder, "--config",
                         missing], "Invalid path to config file"),
        (tmain.cli, ["--dataset", missing, "--results", folder, "--config",
                     config], "Invalid path for dataset folder"),
        (tmain.cli, ["--dataset", folder, "--results", missing, "--config",
                     config], "Invalid path for results folder"),
        (tmain.cli, ["--dataset", folder, "--results", folder, "--config",
                     missing], "Invalid path to config file"),
    ]
    for cli, argv, message in cases:
        with pytest.raises(SystemExit, match=message):
            cli(argv)
    with pytest.raises(SystemExit):
        tmain.cli(["--dataset", folder])              # argparse: required
    # "dense" on a radius graph stops before any data is read
    radius = str(tmp_path / "radius.yml")
    with open(radius, "w") as f:
        f.write(CONFIG_YAML.format(epochs=1).replace(
            'graph_construction_algorithm: "knn"',
            'graph_construction_algorithm: "radius"').replace(
            "        batch_norm_in_mlps: False",
            "        batch_norm_in_mlps: False\n"
            "        fused_tiling: \"dense\""))
    with pytest.raises(SystemExit, match='"dense" requires a kNN graph'):
        ttrain.main(missing, folder, radius, device="cpu")


def test_entry_points_ask_for_the_card(tmp_path):
    """Without --device the CLIs run on the card, and there is none here:
    each raises rather than fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    config = _config(tmp_path)
    folder = str(tmp_path)
    for cli, argv in (
            (tcreate.cli, ["--dataset", folder, "--config", config]),
            (ttrain.cli, ["--data", folder, "--results", folder,
                          "--config", config]),
            (tevaluate.cli, ["--data", folder, "--model", folder,
                             "--config", config]),
            (tmain.cli, ["--dataset", folder, "--results", folder,
                         "--config", config])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli(argv)


def test_mesh_axes_of_more_than_one_device_wait_for_multi_gpu():
    """Multi-GPU training is ported: one process runs a mesh of one device
    as no mesh (an axis of -1 takes the one rank there is); a mesh of more
    devices than processes raises instead of training on one device; the
    halo partition comes from a model axis only (tests/test_torch_halo.py
    trains under one on two ranks)."""
    cpu = torch.device("cpu")
    for axes in (None, {}, {"data": 1}, {"data": -1}, {"data": 1, "model": 1}):
        assert ttrain.mesh_from_configs(axes, cpu) == (None, cpu)
    for axes, n in (({"data": 2}, 2), ({"data": 1, "model": 4}, 4)):
        with pytest.raises(ValueError, match=f"needs {n} devices, have 1"):
            ttrain.mesh_from_configs(axes, cpu)
    assert ttrain.halo_partition_from_configs(None, None) is None


def test_save_results_without_matplotlib(tmp_path, capsys, monkeypatch):
    """Where matplotlib does not import, save_results writes every file
    but loss_curves.png and says in one line that the figure was not
    drawn and why."""
    cfg = UserConfigurationReader.read_config_file(_config(tmp_path))
    arch = UserConfigurationReader.get_config_object("MODEL_ARCHITECTURE", cfg)
    train_cfg = UserConfigurationReader.get_config_object("TRAINING", cfg)
    trainer = Trainer(train_cfg, DetNet(arch, device="cpu"))
    for name in ("train_loss", "train_loss_cls", "train_loss_bb",
                 "valid_loss"):
        getattr(trainer, name).extend([1.0, 0.5])
    trainer.model_lowest_valid = {
        "state_dict": trainer.model.state_dict(), "epoch": 2}
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    capsys.readouterr()
    trainer.save_results(str(tmp_path / "results"), arch, {"d": 1})
    folder = tmp_path / "results" / "model_01"
    assert set(os.listdir(folder)) == (
        MODEL_FILES - {"loss_curves.png"}
        | {"trained_model_low_val_ep2.msgpack"})
    said = capsys.readouterr().out.strip().splitlines()
    assert len(said) == 1 and "loss_curves.png not drawn" in said[0] \
        and "matplotlib" in said[0]
    np.testing.assert_array_equal(np.load(folder / "loss_validation.npy"),
                                  [[1.0, 0.5]])
