"""The on-card smoke's seventh phase (`smoke.cli_phase`, the command-line
pipeline) rehearsed on the CPU: its raw RadarScenes writer, its
configuration, and the phase itself with h5py blocked (the card's machine
has none): the port writes and reads the raw sequences with its own HDF5
code (`data.hdf5`). The phase at the rehearsal's size is
tests/test_torch_smoke_cli.py's."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from radargnn_tpu_torch import smoke
from radargnn_tpu_torch.configs import (
    RADARSCENES_TEST_SPLIT_INDICES, UserConfigurationReader,
)
from radargnn_tpu_torch.data.radarscenes import reader
from radargnn_tpu_torch.data.radarscenes.dataset_creation import (
    create_point_cloud_frames,
)
from torch_threads import few_threads  # noqa: F401


def test_cli_configuration_replaces_two_fields(tmp_path):
    path = smoke.cli_config(str(tmp_path))
    got = UserConfigurationReader.read_config_file(path)
    want = UserConfigurationReader.read_config_file(smoke.FLAGSHIP_CONFIG)
    training = want["TRAIN"]["TRAINING"]
    assert (training["epochs"], training["checkpoint_every_epochs"]) != (2, 1)
    training.update(smoke.CLI_REPLACED)
    assert got == want


def test_raw_sequences_hold_every_class(tmp_path):
    """The writer's layout reads back through the port's reader: four
    sequences (three train sequences outside the test split, one
    validation), frames of about the asked-for points after the crop,
    and every one of the five classes with a track id of its own."""
    root = str(tmp_path)
    smoke.write_radarscenes(root, scans=24, points_per_scan=340)
    with open(os.path.join(root, "raw", "data", "sequences.json")) as f:
        sequences = json.load(f)["sequences"]
    train = [n for n, m in sequences.items() if m["category"] == "train"]
    assert len(train) == 3 and min(RADARSCENES_TEST_SPLIT_INDICES) >= 3
    assert [m["category"] for m in sequences.values()].count(
        "validation") == 1
    cfg = UserConfigurationReader.read_config_file(smoke.FLAGSHIP_CONFIG)
    dataset_cfg = UserConfigurationReader.get_config_object(
        "DATASET_PROCESSING", cfg)
    for name in sequences:
        seq = reader.Sequence.from_json(
            os.path.join(root, "raw", "data", name, "scenes.json"))
        assert len(seq.timestamps) == 24
        assert np.array_equal(np.diff(seq.timestamps), np.full(23, 70_000))
        assert set(seq.radar_data["sensor_id"]) == {1, 2, 3, 4}
        frames = create_point_cloud_frames(os.path.join(root, "raw"), name,
                                           dataset_cfg)
        assert len(frames) == 3
        for pc in frames:
            assert 2400 < pc.num_points < 3000     # the last frame: 8 scans
            labels = pc.label_id[:, 0]
            assert set(labels.astype(int)) == {0, 1, 2, 3, 4, 5}
            tracks = pc.track_id[:, 0]
            assert (tracks[labels == 5] == b"").all()
            for cls in range(5):
                ids = set(tracks[labels == cls])
                assert len(ids) == 2 and b"" not in ids
            assert np.isfinite(pc.V_cc_compensated).all()


@pytest.mark.usefixtures("few_threads")
def test_cli_phase_without_h5py(monkeypatch):
    """With h5py blocked the phase writes raw sequences, runs create_dataset
    on them (the YAML's spawned workers) and trains and evaluates through
    the CLI, with every check (here the kernels' plain versions run, so no
    launch is counted), and times the HDF5 reader."""
    monkeypatch.setitem(sys.modules, "h5py", None)
    before = torch.are_deterministic_algorithms_enabled()
    lines = []
    res = smoke.cli_phase(torch.device("cpu"), points=120, scans=17,
                          out=lines.append)
    assert torch.are_deterministic_algorithms_enabled() == before
    assert not any("did not run" in line for line in lines)
    assert res["create_dataset_s"] > 0
    assert res["raw_bytes"] > 17 * 4 * 40 * smoke.RADAR_DTYPE.itemsize
    # 17 scans a sequence: frames of 8 scans, three train sequences
    assert res["frames"] == {"train": 6, "validate": 2}
    assert 0 < res["points"][0] <= res["points"][1]
    reader_line = lines[-1]
    assert reader_line.startswith("CLI phase: the HDF5 reader on 500000 "
                                  "rows")
    assert res["reader"]["bytes"] == 500_000 * 110
    assert len(res["reader"]["read_s"]) == 5
    assert res["train_launches"] == res["evaluate_launches"] == [0] * len(smoke.KERNEL_NAMES)
    assert len(res["train_epoch_s"]) == 2
    assert res["max_abs_dprob"] == res["max_rel_dbox"] == 0.0
    assert np.isfinite(res["map"]) and np.isfinite(res["f1"]).all()
    assert all(np.isfinite(v).all() and len(v) == 2
               for v in res["losses"].values())
