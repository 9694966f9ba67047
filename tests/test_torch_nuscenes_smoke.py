"""The nuScenes e2e (`python -m radargnn_tpu_torch.benchmarks.nuscenes_e2e`)
on the CPU, and the on-card smoke's eighth phase (`smoke.nuscenes_phase`)
rehearsed: its configuration, its table writer and the phase itself at a
tiny size, with matplotlib blocked (the port draws and reads back its
figures on its own)."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from radargnn_tpu_torch import smoke
from radargnn_tpu_torch.benchmarks import nuscenes_e2e
from radargnn_tpu_torch.configs import (
    GraphConstructionConfiguration, NuScenesDatasetConfiguration,
    NuScenesSplitConfiguration, UserConfigurationReader,
)
from radargnn_tpu_torch.data.nuscenes import db
from radargnn_tpu_torch.data.nuscenes.dataset_creation import (
    CLASS_NAME_TO_ID, NuScenesGraphDataset,
)
from radargnn_tpu_torch.graph.batch import GraphSample
from test_torch_smoke_cli import _assert_figures
from torch_threads import few_threads  # noqa: F401

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_e2e_runs_on_the_cpu():
    """The e2e as a user runs it, with `--device cpu`: tables, dataset
    creation, four epochs, NMS and the native detection eval; it exits 0
    and ends with its line."""
    proc = subprocess.run(
        [sys.executable, "-m", "radargnn_tpu_torch.benchmarks.nuscenes_e2e",
         "--device", "cpu"], cwd=_REPO, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert lines[0] == "device: cpu"
    assert re.fullmatch(r"NUSC-TORCH ok: mAP=\d\.\d{4} NDS=\d\.\d{4}",
                        lines[-1]), lines[-1]


def test_e2e_needs_a_card_unless_told_otherwise(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nuscenes_e2e.run(None, str(tmp_path))
    assert os.listdir(tmp_path) == []


def test_nuscenes_configuration_replaces_one_field(tmp_path):
    path = smoke.cli_config(str(tmp_path), smoke.NUSCENES_CONFIG,
                            smoke.NUSCENES_REPLACED, "nuscenes.yml")
    got = UserConfigurationReader.read_config_file(path)
    want = UserConfigurationReader.read_config_file(smoke.NUSCENES_CONFIG)
    assert smoke.NUSCENES_REPLACED == {"epochs": 2}
    assert want["TRAIN"]["TRAINING"]["epochs"] != 2
    want["TRAIN"]["TRAINING"]["epochs"] = 2
    assert got == want
    arch = UserConfigurationReader.get_config_object("MODEL_ARCHITECTURE",
                                                     got)
    assert arch.conv_layer_dimensions == [224, 224, 128, 64, 32]
    assert got["TRAIN"]["TRAINING"]["batch_size"] == 32


@pytest.fixture(scope="module")
def phase_tables(tmp_path_factory):
    """The phase's tables at a tiny size: its three scenes cut to 4, 4 and
    2 samples, 6 sweeps a radar of about 8 returns."""
    root = str(tmp_path_factory.mktemp("phase"))
    nuscenes_e2e.write_nuscenes_tables(
        root, smoke.nuscenes_scenes(0.125), version="v1.0-trainval",
        sweeps=6, points_per_sweep=8)
    return root, db.NuScenes("v1.0-trainval", os.path.join(root, "raw"))


def test_phase_scenes_are_in_the_yamls_splits(phase_tables):
    _, nusc = phase_tables
    split = NuScenesSplitConfiguration("v1.0-trainval").sequence_dict
    scenes = [s["token"] for s in nusc.scene]
    assert scenes[0] in split["train"] and scenes[1] in split["train"]
    assert scenes[2] in split["validate"]
    assert [s["nbr_samples"] for s in nusc.scene] == [4, 4, 2]


def test_phase_sweeps_chain_with_poses_of_their_own(phase_tables):
    """Each radar's key-frame sweep and five earlier non-key sweeps 75 ms
    apart, each with its own ego pose on the moving path; the chain runs
    on into the previous sample's sweeps and stops at the scene's first;
    the PCD header mixes F4 with 1- and 2-byte I and U fields."""
    root, nusc = phase_tables
    scene = nusc.scene[0]
    sample = nusc.get("sample", scene["first_sample_token"])
    sample = nusc.get("sample", sample["next"])
    for chan in db.RADAR_CHANNELS:
        sd = nusc.get("sample_data", sample["data"][chan])
        assert sd["is_key_frame"] and sd["timestamp"] == sample["timestamp"]
        chain = [sd]
        while chain[-1]["prev"]:
            chain.append(nusc.get("sample_data", chain[-1]["prev"]))
        assert len(chain) == 12           # two samples of 6 sweeps
        assert [c["is_key_frame"] for c in chain] == [True] + [False] * 5 \
            + [True] + [False] * 5
        assert np.diff([c["timestamp"] for c in chain[:6]]).tolist() == \
            [-75_000] * 5
        poses = [tuple(nusc.get("ego_pose", c["ego_pose_token"])
                       ["translation"]) for c in chain]
        assert len(set(poses)) == 12
        for a, b in zip(chain, chain[1:]):
            assert b["next"] == a["token"]
        cs = nusc.get("calibrated_sensor", sd["calibrated_sensor_token"])
        assert cs["translation"] == list(nuscenes_e2e.RADAR_MOUNTS[chan][:3])
    with open(nusc.get_sample_data_path(sd["token"]), "rb") as f:
        header = f.read(600).split(b"DATA binary")[0].decode()
    types = dict(line.split(" ", 1) for line in header.splitlines()
                 if line[:4] in ("TYPE", "SIZE"))
    assert set(types["TYPE"].split()) == {"F", "I", "U"}
    assert set(types["SIZE"].split()) == {"1", "2", "4"}
    assert db.parse_pcd(nusc.get_sample_data_path(sd["token"])).shape[0] \
        == 18


def test_phase_objects_move_and_are_seen(phase_tables, tmp_path):
    """Eight instances a scene of eight detection classes, chained
    annotations that move between samples with finite velocities, one
    annotation without points; after the dataset creation every box with
    points has labelled returns inside it in its key frame."""
    root, nusc = phase_tables
    categories = {r["token"]: r["name"] for r in nusc._tables["category"]}
    instances = {r["token"]: categories[r["category_token"]]
                 for r in nusc._tables["instance"]}
    assert len({CLASS_NAME_TO_ID[c] for c in instances.values()}) == 8
    anns = nusc.sample_annotation
    assert sum(a["num_lidar_pts"] + a["num_radar_pts"] == 0
               for a in anns) == 1
    for a in anns:
        assert np.isfinite(nusc.box_velocity(a["token"])).all()
        if a["next"]:
            b = nusc.get("sample_annotation", a["next"])
            assert a["instance_token"] == b["instance_token"]
            assert a["translation"] != b["translation"]
    NuScenesGraphDataset(root, GraphConstructionConfiguration(
        "knn", {"k": 20, "r": 1}, ["rcs", "velocity_vector", "time_index",
                                   "degree"], ["relative_position"],
        "directed", "X"), NuScenesDatasetConfiguration(
            version="v1.0-trainval", nsweeps=6, bb_invariance="translation"))
    for split in ("train", "validate"):
        folder = os.path.join(root, "processed", split)
        for name in sorted(os.listdir(folder)):
            token = name[:-4].split("_")[-1]
            sample = GraphSample.load_npz(os.path.join(folder, name))
            want = {CLASS_NAME_TO_ID[instances[a["instance_token"]]]
                    for a in (nusc.get("sample_annotation", t)
                              for t in nusc.get("sample", token)["anns"])
                    if a["num_lidar_pts"] + a["num_radar_pts"] > 0}
            assert set(np.unique(sample.labels[sample.labels > 0])) == want
            assert 200 < sample.num_nodes < 400
            assert len(np.unique(sample.node_feat[:, 3])) == 6  # time index


@pytest.mark.usefixtures("few_threads")
def test_nuscenes_phase_rehearses_on_cpu(monkeypatch):
    """The eighth phase at a tiny size (the YAML's widths, batches of 4): 4
    + 4 train and 2 validate samples of about 300 points, its checks, the
    oracle and the e2e child; B1 and B2 held against their plain versions
    on the train CLI's first batch (4 frames here, the YAML's 32 on the
    card). matplotlib is blocked in this process: the loss curves, the
    confusion matrices and the prediction plots are drawn, read back and
    sized all the same."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    lines = []
    nus = smoke.nuscenes_phase(
        torch.device("cpu"), scale=0.125, points_per_sweep=8,
        replaced=dict(smoke.NUSCENES_REPLACED, batch_size=4), seed=0,
        reps=1, out=lines.append)
    assert nus["replaced"] == {"epochs": 2, "batch_size": 4}
    assert nus["frames"] == {"train": 8, "validate": 2}
    assert nus["train_launches"] == nus["evaluate_launches"] == \
        [0] * len(smoke.KERNEL_NAMES)
    assert len(nus["train_epoch_s"]) == 2 and len(nus["train_batch_edges"]) \
        == 2
    assert nus["max_abs_dprob"] == nus["max_rel_dbox"] == 0.0
    assert 0.0 <= nus["map"] <= 1.0 and 0.0 <= nus["nds"] <= 1.0
    assert np.isfinite(nus["f1"]).all() and len(nus["f1"]) == 11
    assert nus["oracle"]["max_abs_dmetric"] == 0.0
    assert len(nus["oracle"]["label_aps"]) == 8
    assert all(ap > 0.9 for ap in nus["oracle"]["label_aps"].values())
    assert nus["e2e"].startswith("NUSC-TORCH ok: mAP=")
    _assert_figures(nus["figures"])
    assert nus["validate_tiling"]["overflow_budget"] > 0
    assert len(nus["train_tiling"]["valid_edges"]) == 4
    assert max(nus["train_tiling"]["overflow_edges"]) > 0
    assert [r["d_in"] for r in nus["per_shape"]] == [224, 224, 224, 128, 64]
    assert all(r["bits_flipped"] == 0 for r in nus["per_shape"])
    assert all(r["bitwise_repeat"] and r["routed"] > 0
               for r in nus["per_shape_bwd"])
