"""The on-card smoke's seventh phase (`smoke.cli_phase`) rehearsed on the
CPU as the smoke runs it: raw RadarScenes sequences written and read by
the port's HDF5 code, create_dataset, train and evaluate through
`cli.main` under the flagship YAML (epochs 2, a checkpoint every epoch),
the evaluate CLI as a child process, and the model folder evaluated on
the CPU against the phase's device (here the CPU as well). Its writer, its
configuration and the phase with h5py blocked are
tests/test_torch_cli_smoke.py's."""

import numpy as np
import pytest
import torch

from radargnn_tpu_torch import smoke
from torch_threads import few_threads  # noqa: F401


@pytest.mark.usefixtures("few_threads")
def test_cli_phase_rehearses_on_cpu():
    """The phase at the smoke rehearsal's size (frames of about 200
    points), with every check it makes; off the card the wrappers take
    their plain versions, so no launch is counted."""
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
