"""The seventh phase's HDF5 check (`smoke_hdf5.fixture_check`, which
`smoke.cli_phase` runs after its CLI run) rehearsed on the CPU as the smoke
runs it, with h5py blocked (the card's machine has none): every committed
file h5py wrote under libver "latest" read to its manifest, and the dataset
creation making the same graphs from the committed sequence as from its
port-written copy; and the check failing where a file does not read as its
manifest says or the graphs differ. The fixture itself is
tests/test_torch_hdf5_fixture.py's."""

import json
import os
import shutil
import sys

import numpy as np
import pytest

from radargnn_tpu_torch import smoke, smoke_hdf5 as sh
from radargnn_tpu_torch.data import hdf5
from torch_threads import few_threads  # noqa: F401


def _manifest(folder: str = sh.FIXTURE) -> dict:
    with open(os.path.join(folder, "manifest.json")) as f:
        return json.load(f)


@pytest.mark.usefixtures("few_threads")
def test_fixture_check_rehearses_without_h5py(monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    lines = []
    res = sh.fixture_check(smoke.FLAGSHIP_CONFIG, None, lines.append)
    assert sorted(res["read_ms"]) == sorted(_manifest()["files"])
    assert all(ms > 0 for ms in res["read_ms"].values())
    assert res["graphs"] >= 2
    assert res["latest_creation_s"] > 0 and res["port_creation_s"] > 0
    assert res["check_s"] > res["latest_creation_s"] + res["port_creation_s"]
    assert len(lines) == 1 and lines[0].startswith("HDF5 fixtures")
    assert f"{res['graphs']} graphs equal" in lines[0]


@pytest.mark.parametrize("change", ["sha256", "shape", "dtype"])
def test_read_fixtures_refuses_a_wrong_manifest(tmp_path, change):
    folder = str(tmp_path / "fixture")
    shutil.copytree(sh.FIXTURE, folder)
    manifest = _manifest(folder)
    want = manifest["files"]["vlen_strings.h5"]["rows"]
    if change == "sha256":
        want["sha256"] = "0" * 64
    elif change == "shape":
        want["shape"] = [31]
    else:
        want["dtype"]["formats"][1] = "|S8"
    with open(os.path.join(folder, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    assert sh.read_fixtures(sh.FIXTURE)
    with pytest.raises(AssertionError, match="'rows' read as"):
        sh.read_fixtures(folder)


def test_port_written_copy_holds_the_same_rows(tmp_path):
    """The copy's tables: the strings as fixed S32 holding the same bytes,
    every other field and the odometry as read from the fixture."""
    src = os.path.join(sh.FIXTURE, sh.SEQUENCE_ROOT)
    dst = str(tmp_path / "copy")
    sh.port_written_copy(src, dst)
    rel = os.path.join("raw", "data", "sequence_1", "radar_data.h5")
    fixture = hdf5.read_dataset(os.path.join(src, rel), "radar_data")
    copy = hdf5.read_dataset(os.path.join(dst, rel), "radar_data")
    assert copy.dtype.names == fixture.dtype.names
    for name in fixture.dtype.names:
        if name in sh.STRING_FIELDS:
            assert fixture.dtype[name] == object
            assert copy.dtype[name] == np.dtype("S32")
            assert copy[name].tolist() == fixture[name].tolist()
        else:
            np.testing.assert_array_equal(copy[name], fixture[name])
    np.testing.assert_array_equal(
        hdf5.read_dataset(os.path.join(dst, rel), "odometry"),
        hdf5.read_dataset(os.path.join(src, rel), "odometry"))
    assert sorted(os.listdir(os.path.join(dst, "raw", "data"))) == sorted(
        os.listdir(os.path.join(src, "raw", "data")))


def test_same_graphs_refuses_a_difference(tmp_path):
    dirs = [tmp_path / p / "train" for p in ("a", "b")]
    for d in dirs:
        d.mkdir(parents=True)
        np.savez(d / "graph_0.npz", x=np.array([1.0, np.nan]), k=np.arange(2))
    assert sh._same_graphs(str(tmp_path / "a"), str(tmp_path / "b")) == 1
    np.savez(dirs[1] / "graph_0.npz", x=np.array([1.0, np.nan]),
             k=np.arange(2) + 1)
    with pytest.raises(AssertionError, match="graph_0.npz differs"):
        sh._same_graphs(str(tmp_path / "a"), str(tmp_path / "b"))
