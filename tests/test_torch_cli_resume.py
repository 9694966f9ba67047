"""A `_checkpoint` written by the JAX package's train CLI, resumed by both
packages' train CLIs with `--resume`: the same losses, within
`test_torch_trainer.py::test_fit_matches_jax`'s rtol 2e-3, atol 1e-4.

The JAX package trains one epoch of `tests/test_cli_e2e.py`'s
configuration with a checkpoint every epoch, then each package resumes it
to two epochs on the same processed data. Both run the unfused path: the
JAX package's dense (v4) training is non-finite on this configuration
(ROADMAP.md C7). The second epoch is the best or not: either way the JAX
package's best-validation snapshot is its last epoch or none, so its
`save_results` does not meet C4."""

import json
import os
import shutil

import numpy as np
import pytest

pytest.importorskip("h5py")

from radargnn_tpu.cli import create_dataset as jcreate  # noqa: E402
from radargnn_tpu.cli import train as jtrain  # noqa: E402
from radargnn_tpu_torch.cli import train as ttrain  # noqa: E402
from tests.test_cli_e2e import CONFIG_YAML  # noqa: E402
from tests.test_radarscenes_pipeline import _make_dataset_root  # noqa: E402

LOSS_FILES = ("loss_train", "loss_validation", "loss_train_cls",
              "loss_train_bb")


def _config(tmp, epochs):
    text = CONFIG_YAML.format(epochs=epochs).replace(
        "        batch_norm_in_mlps: False",
        "        batch_norm_in_mlps: False\n"
        "        use_fused_aggregation: False").replace(
        "        regularization_strength: 0.000005\n",
        "        regularization_strength: 0.000005\n"
        "        checkpoint_every_epochs: 1\n")
    assert "checkpoint_every_epochs: 1" in text
    path = str(tmp / f"config_{epochs}.yml")
    with open(path, "w") as f:
        f.write(text)
    return path


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("resume")
    root = _make_dataset_root(tmp, num_train=2, num_val=1)
    first, second = _config(tmp, 1), _config(tmp, 2)
    jcreate.main(root, first)
    data = os.path.join(root, "processed")
    start = str(tmp / "start")
    os.makedirs(start)
    jtrain.main(data, start, first)
    out = {"start": start}
    for name, train in (("jax", jtrain.main), ("port", ttrain.main)):
        results = str(tmp / name)
        shutil.copytree(os.path.join(start, "_checkpoint"),
                        os.path.join(results, "_checkpoint"))
        if name == "port":
            train(data, results, second, resume=True, device="cpu")
        else:
            train(data, results, second, resume=True)
        out[name] = os.path.join(results, "model_01")
    return out


def test_resumed_losses_match_jax(resumed):
    for name in LOSS_FILES:
        got = np.load(os.path.join(resumed["port"], f"{name}.npy"))
        want = np.load(os.path.join(resumed["jax"], f"{name}.npy"))
        assert got.shape == want.shape == (1, 2), name
        assert np.isfinite(want).all(), name
        # the first epoch comes from the checkpoint's history
        assert got[0, 0] == want[0, 0], name
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=1e-4,
                                   err_msg=name)
    first = np.load(os.path.join(resumed["start"], "model_01",
                                 "loss_train.npy"))
    assert first[0, 0] == pytest.approx(
        np.load(os.path.join(resumed["port"], "loss_train.npy"))[0, 0])


def test_resume_writes_the_next_checkpoint(resumed):
    """Both packages checkpoint epoch 2 over the resumed folder, with the
    whole history, and write the same model-folder files."""
    metas = []
    for name in ("jax", "port"):
        folder = os.path.join(os.path.dirname(resumed[name]), "_checkpoint")
        assert sorted(os.listdir(folder)) == ["meta.json", "model.msgpack",
                                              "opt_state.msgpack"]
        with open(os.path.join(folder, "meta.json")) as f:
            metas.append(json.load(f))
    assert metas[0]["epoch"] == metas[1]["epoch"] == 2
    assert {k: len(v) for k, v in metas[1]["losses"].items()} == \
        {k: len(v) for k, v in metas[0]["losses"].items()}
    np.testing.assert_allclose(metas[1]["scheduler_lr"],
                               metas[0]["scheduler_lr"], rtol=1e-6)
    files = [sorted(os.listdir(resumed[name])) for name in ("jax", "port")]
    assert files[0] == files[1]
