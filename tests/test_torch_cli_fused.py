"""The port's train and evaluate CLIs under each fused tiling the YAML can
name, on the CPU (where the kernels' plain versions run): the counterparts
of `tests/test_cli_e2e.py`'s fused windowed and dense CLI runs, and the CSR
tiling. Each trains an epoch through `cli.train`, prints its tiling and
evaluates the model folder through `cli.evaluate`."""

import json
import os

import numpy as np
import pytest

pytest.importorskip("h5py")

from radargnn_tpu_torch.cli import create_dataset as tcreate  # noqa: E402
from radargnn_tpu_torch.cli import evaluate as tevaluate  # noqa: E402
from radargnn_tpu_torch.cli import train as ttrain  # noqa: E402
from tests.test_cli_e2e import CONFIG_YAML  # noqa: E402
from tests.test_radarscenes_pipeline import _make_dataset_root  # noqa: E402

PRINTED = {
    "windowed": ">>> fused aggregation: windowed (v3) kernels, tiling "
                "(256, 512, 3, 0.5, 4)",
    "dense": ">>> fused aggregation: dense (v4) kernels, 9 slots/receiver",
    "csr": ">>> fused aggregation: CSR (v2) kernels, tiling (256, 512)",
}


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fused")
    root = _make_dataset_root(tmp, num_train=2, num_val=1)
    config = str(tmp / "config.yml")
    with open(config, "w") as f:
        f.write(CONFIG_YAML.format(epochs=1))
    tcreate.main(root, config, device="cpu")
    return root


@pytest.mark.parametrize("tiling", sorted(PRINTED))
def test_train_then_evaluate_fused(dataset, tmp_path, capsys, tiling):
    yaml = CONFIG_YAML.format(epochs=1).replace(
        "        batch_norm_in_mlps: False",
        "        batch_norm_in_mlps: False\n"
        "        use_fused_aggregation: True\n"
        f"        fused_tiling: \"{tiling}\"\n"
        "        fused_overflow_fraction: 0.5\n"
        "        assume_sorted_edges: True")
    config = str(tmp_path / "config.yml")
    with open(config, "w") as f:
        f.write(yaml)
    results = str(tmp_path / "results")
    os.makedirs(results)
    ttrain.main(os.path.join(dataset, "processed"), results, config,
                device="cpu")
    assert PRINTED[tiling] in capsys.readouterr().out
    model = os.path.join(results, "model_01")
    losses = np.load(os.path.join(model, "loss_train.npy"))
    assert losses.shape == (1, 1) and np.isfinite(losses).all()
    tevaluate.main(dataset, model, config, device="cpu")
    with open(os.path.join(model, "evaluation_01", "eval_results.json")) as f:
        res = json.load(f)
    assert np.isfinite(res["OBJECT_DETECTION_METRICS"]["mAP"])
    assert np.isfinite(res["SEMANTIC_SEGMENTATION_METRICS"]["f1"]).all()
