"""The on-card smoke's seventh phase (`smoke.cli_phase`) rehearsed on the
CPU as the smoke runs it: raw RadarScenes sequences written and read by
the port's HDF5 code, create_dataset, train and evaluate through
`cli.main` under the flagship YAML (epochs 2, a checkpoint every epoch),
the evaluate CLI as a child process, and the model folder evaluated on
the CPU against the phase's device (here the CPU as well), with
matplotlib blocked: every figure (loss_curves.png, each confusion.png,
the prediction plots of `--plot`) is drawn by the port's own code and read
back by its PNG reader. Its writer, its
configuration and the phase with h5py blocked are
tests/test_torch_cli_smoke.py's."""

import sys

import numpy as np
import pytest
import torch

from radargnn_tpu_torch import smoke
from torch_threads import few_threads  # noqa: F401


@pytest.mark.usefixtures("few_threads")
def test_cli_phase_rehearses_on_cpu(monkeypatch):
    """The phase at the smoke rehearsal's size (frames of about 200
    points), with every check it makes; off the card the wrappers take
    their plain versions, so no launch is counted. matplotlib is blocked
    in this process: the figures are drawn, read back and sized all the
    same, and those drawn here are timed."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    before = torch.are_deterministic_algorithms_enabled()
    lines = []
    res = smoke.cli_phase(torch.device("cpu"), 200, out=lines.append)
    assert torch.are_deterministic_algorithms_enabled() == before
    assert res["create_dataset_s"] > 0 and res["raw_bytes"] > 0
    assert res["train_launches"] == res["evaluate_launches"] == \
        [0] * len(smoke.KERNEL_NAMES)
    assert len(res["train_epoch_s"]) == 2
    assert res["max_abs_dprob"] == res["max_rel_dbox"] == 0.0
    assert np.isfinite(res["map"]) and np.isfinite(res["f1"]).all()
    assert lines[-2].startswith("CLI phase on cpu: ")
    assert "create_dataset" in lines[-1] and "raw bytes read" in lines[-1]
    assert res["reader"]["mb_per_s"] > 0
    _assert_figures(res["figures"])
    assert any(line.startswith("figures of the CLI run") for line in lines)


def _assert_figures(figures):
    """The CLI run's figures: the loss curves, the confusion matrix of each
    of the three evaluations, the child's and the CPU evaluation's
    prediction plots; each read back at its size with ink on it, and
    timed where this process drew it."""
    plots = [f"prediction_{i:03d}.png" for i in range(smoke.CLI_PLOTS)]
    assert sorted(figures) == sorted(
        ["loss_curves.png"]
        + [f"evaluation_0{k}/confusion.png" for k in (1, 2, 3)]
        + [f"evaluation_0{k}/{p}" for k in (2, 3) for p in plots])
    for name, fig in figures.items():
        want = (600, 600, 4) if name.endswith("confusion.png") else \
            (480, 640, 4)
        assert fig["shape"] == list(want) and fig["bytes"] > 0
        assert fig["ink"] > smoke.FIGURE_MIN_INK
        assert (fig["draw_s"] is None) == name.startswith("evaluation_02")
        assert fig["draw_s"] is None or fig["draw_s"] > 0


def test_check_figure_refuses_a_blank_or_missized_png(tmp_path):
    """The smoke's figure check fails a blank figure and one of the wrong
    size, and passes the port's own loss curves."""
    from types import SimpleNamespace
    from radargnn_tpu_torch.train.trainer import Trainer
    from radargnn_tpu_torch.utils import png
    blank = np.full((480, 640, 4), 255, np.uint8)
    png.write_png(str(tmp_path / "loss_curves.png"), blank)
    with pytest.raises(AssertionError, match="inked"):
        smoke.check_figure(str(tmp_path / "loss_curves.png"))
    png.write_png(str(tmp_path / "prediction_000.png"), blank[:100] * 0)
    with pytest.raises(AssertionError, match="want"):
        smoke.check_figure(str(tmp_path / "prediction_000.png"))
    fig, _ = Trainer.show_learning_curves(SimpleNamespace(
        train_loss=[2.0, 1.0], valid_loss=[2.5, 1.5],
        train_loss_cls=[1.0, 0.5], train_loss_bb=[1.0, 0.5]))
    fig.savefig(str(tmp_path / "loss_curves.png"))
    got = smoke.check_figure(str(tmp_path / "loss_curves.png"))
    assert got["shape"] == [480, 640, 4] and got["ink"] > 0.01
