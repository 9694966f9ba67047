"""The port's nuScenes pipeline (radargnn_tpu_torch.data.nuscenes) against
the JAX package's on the same tables: the quaternion algebra, the PCD
reader (all-float, mixed-type and ASCII headers), the table index, the
multisweep aggregation, the split tables, and whole dataset creations.
These are numpy paths in both packages, so every array must be equal
(NaN == NaN), the files' names, keys and dtypes too.

The tables are `tests/test_nuscenes_pipeline.py`'s (`_make_nuscenes_root`
and the multisweep root its `test_multisweep_transforms` writes) and those
of the port's own writer (`benchmarks.nuscenes_e2e.write_nuscenes_tables`,
the on-card smoke's data): several sweeps a radar, moving ego poses,
mounted and rotated radars, moving instances of several classes. The
dataset creations run with both packages on one pair of host backends
(`host_backends.host_pair`)."""

import importlib
import json
import os

import numpy as np
import pytest

from radargnn_tpu import configs as jcfg
from radargnn_tpu.data.nuscenes import db as jdb
from radargnn_tpu.data.nuscenes import dataset_creation as jdc
from radargnn_tpu.data.nuscenes import quaternion as jq
from radargnn_tpu.data.nuscenes import splits as jsplits
from radargnn_tpu_torch import configs as tcfg
from radargnn_tpu_torch.benchmarks import nuscenes_e2e
from radargnn_tpu_torch.data.nuscenes import db as tdb
from radargnn_tpu_torch.data.nuscenes import dataset_creation as tdc
from radargnn_tpu_torch.data.nuscenes import quaternion as tq
from radargnn_tpu_torch.data.nuscenes import splits as tsplits
from radargnn_tpu_torch.data.nuscenes import splits_vendored as tvendored
from tests import test_nuscenes_pipeline as jtests

from host_backends import host_pair, native_cache  # noqa: F401

# the writer's trainval scenes: one of the train split, one of val
TRAINVAL_SCENES = ((tvendored.train_detect[0], "scene-9001", 3),
                   (tvendored.val[0], "scene-9003", 3))


def _writer_root(path):
    return nuscenes_e2e.write_nuscenes_tables(
        str(path), TRAINVAL_SCENES, version="v1.0-trainval", sweeps=3,
        points_per_sweep=24)


def _assert_same(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, what
    np.testing.assert_array_equal(a, b, err_msg=what)


def test_quaternion_matches_jax():
    rng = np.random.default_rng(0)
    for _ in range(20):
        wxyz = rng.normal(size=4)
        axis, angle = rng.normal(size=3), rng.uniform(-np.pi, np.pi)
        v = rng.normal(size=3)
        for args in ({"wxyz": wxyz}, {"axis": axis, "angle": angle}):
            t, j = tq.Quaternion(**args), jq.Quaternion(**args)
            _assert_same(t.elements, j.elements)
            _assert_same(t.rotation_matrix, j.rotation_matrix)
            _assert_same(t.inverse.elements, j.inverse.elements)
            _assert_same(t.rotate(v), j.rotate(v))
            assert t.yaw_pitch_roll == j.yaw_pitch_roll
            assert (t.w, t.x, t.y, t.z) == (j.w, j.x, j.y, j.z)
            other = rng.normal(size=4)
            _assert_same((t * tq.Quaternion(other)).elements,
                         (j * jq.Quaternion(other)).elements)


# every (TYPE, SIZE) pair of the reader's table, each with a value it can
# only carry at its own width, and one field of COUNT 2
ALL_TYPES = (("F", 4, 1.5), ("F", 8, 1.0 + 2.0 ** -40),
             ("I", 1, -128), ("I", 2, -32768), ("I", 4, -2 ** 31),
             ("I", 8, -2 ** 63 + 1), ("U", 1, 255), ("U", 2, 65535),
             ("U", 4, 2 ** 32 - 1), ("U", 8, 2 ** 64 - 1))


def _write_all_types(path, n):
    dtype = np.dtype([(f"f{i}", {"F": "<f", "I": "<i", "U": "<u"}[t]
                       + str(s), (2,) if i == 3 else ())
                      for i, (t, s, _) in enumerate(ALL_TYPES)])
    rows = np.zeros(n, dtype)
    for i, (_, _, extreme) in enumerate(ALL_TYPES):
        col = rows[f"f{i}"]
        col[...] = (np.arange(col.size).reshape(col.shape) % 7)
        col[(0,) * col.ndim] = extreme
    header = "\n".join([
        "# .PCD v0.7", "VERSION 0.7",
        "FIELDS " + " ".join(f"f{i}" for i in range(len(ALL_TYPES))),
        "SIZE " + " ".join(str(s) for _, s, _ in ALL_TYPES),
        "TYPE " + " ".join(t for t, _, _ in ALL_TYPES),
        "COUNT " + " ".join("2" if i == 3 else "1"
                            for i in range(len(ALL_TYPES))),
        f"WIDTH {n}", "HEIGHT 1", "VIEWPOINT 0 0 0 1 0 0 0",
        f"POINTS {n}", "DATA binary", ""])
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(rows.tobytes())


def _write_ascii(path, rows):
    n, d = rows.shape
    header = "\n".join([
        "VERSION 0.7", "FIELDS " + " ".join(f"c{i}" for i in range(d)),
        "SIZE " + " ".join(["4"] * d), "TYPE " + " ".join(["F"] * d),
        f"WIDTH {n}", "HEIGHT 1", f"POINTS {n}", "DATA ascii", ""])
    with open(path, "w") as f:
        f.write(header)
        for row in rows:
            f.write(" ".join(repr(float(v)) for v in row) + "\n")


@pytest.mark.parametrize("kind", ["all_float", "nuscenes_mixed", "all_types",
                                  "ascii"])
def test_parse_pcd_matches_jax(tmp_path, kind):
    """The port reads the binary payload in one structured-dtype pass; its
    float64 array equals the JAX reader's row-by-row struct unpacking for
    every TYPE/SIZE pair, mixed fields in one header (COUNT 2 too), and
    an ASCII payload."""
    rng = np.random.default_rng(1)
    path = str(tmp_path / f"{kind}.pcd")
    if kind == "all_float":
        jtests._write_radar_pcd(path, rng.normal(0, 30, (18, 11)))
    elif kind == "nuscenes_mixed":
        rows = np.zeros(13, nuscenes_e2e.PCD_DTYPE)
        for name in rows.dtype.names:
            info = np.iinfo(rows.dtype[name]) \
                if rows.dtype[name].kind in "iu" else None
            rows[name] = (rng.integers(info.min, info.max, 13,
                                       endpoint=True) if info
                          else rng.normal(0, 30, 13))
        nuscenes_e2e.write_pcd(path, rows)
    elif kind == "all_types":
        _write_all_types(path, 9)
    else:
        _write_ascii(path, rng.normal(0, 30, (7, 5)))
    got, want = tdb.parse_pcd(path), jdb.parse_pcd(path)
    _assert_same(got, want)
    assert got.dtype == np.float64 and got.shape == want.shape
    if kind == "nuscenes_mixed":
        assert got.shape == (18, 13)
        for i, name in enumerate(rows.dtype.names):
            _assert_same(got[i], rows[name].astype(np.float64))


def test_parse_pcd_refuses_what_jax_refuses(tmp_path):
    path = str(tmp_path / "x.pcd")
    with open(path, "w") as f:
        f.write("FIELDS x\nSIZE 4\nTYPE F\nPOINTS 1\nDATA binary_compressed\n")
    for mod in (tdb, jdb):
        with pytest.raises(ValueError, match="unsupported PCD DATA mode"):
            mod.parse_pcd(path)


def test_parse_pcd_reads_an_empty_sweep(tmp_path):
    """A binary sweep of no points reads as an (18, 0) array, as the devkit
    reads it; the JAX reader's reshape of its empty row list raises."""
    path = str(tmp_path / "empty.pcd")
    nuscenes_e2e.write_pcd(path, np.zeros(0, nuscenes_e2e.PCD_DTYPE))
    got = tdb.parse_pcd(path)
    assert got.shape == (18, 0) and got.dtype == np.float64
    with pytest.raises(ValueError, match="reshape"):
        jdb.parse_pcd(path)


@pytest.fixture(scope="module")
def writer_root(tmp_path_factory):
    return _writer_root(tmp_path_factory.mktemp("writer"))


def test_table_index_and_multisweep_match_jax(writer_root):
    """On the writer's tables (3 sweeps a radar, moving ego and objects):
    the boxes of every key frame, every annotation's velocity and every
    radar's multisweep aggregation at 1, 3 and 5 sweeps (the walk stops at
    the scene's first sweep) equal the JAX package's."""
    raw = os.path.join(writer_root, "raw")
    t, j = (mod.NuScenes("v1.0-trainval", raw) for mod in (tdb, jdb))
    assert tdb.RADAR_CHANNELS == jdb.RADAR_CHANNELS
    assert tdb.RADAR_NBR_DIMS == jdb.RADAR_NBR_DIMS == 18
    for sample in j.sample:
        for chan in ("LIDAR_TOP",) + jdb.RADAR_CHANNELS:
            tb = t.get_boxes(sample["data"][chan])
            jb = j.get_boxes(sample["data"][chan])
            assert [(b.name, b.token, b.label) for b in tb] == \
                [(b.name, b.token, b.label) for b in jb]
            for a, b in zip(tb, jb):
                _assert_same(a.center, b.center)
                _assert_same(a.wlh, b.wlh)
                _assert_same(a.orientation.elements, b.orientation.elements)
                _assert_same(a.corners(1.3), b.corners(1.3))
        for chan in jdb.RADAR_CHANNELS:
            for nsweeps in (1, 3, 5):
                got = tdb.RadarPointCloudLoader.from_file_multisweep(
                    t, sample, chan, chan, nsweeps=nsweeps)
                want = jdb.RadarPointCloudLoader.from_file_multisweep(
                    j, sample, chan, chan, nsweeps=nsweeps)
                _assert_same(got[0], want[0], f"{chan} points")
                _assert_same(got[1], want[1], f"{chan} lags")
    finite = 0
    for ann in j.sample_annotation:
        v = t.box_velocity(ann["token"])
        _assert_same(v, j.box_velocity(ann["token"]))
        finite += np.isfinite(v).all()
    assert finite == len(j.sample_annotation)


def test_multisweep_root_matches_jax(tmp_path):
    """The JAX test's hand-checked two-sweep root (a previous sweep at
    another ego pose and yaw) gives the port the same points and lags."""
    jtests.test_multisweep_transforms(tmp_path)
    raw = os.path.join(str(tmp_path / "nusc"), "raw")
    t, j = tdb.NuScenes("v1.0-mini", raw), jdb.NuScenes("v1.0-mini", raw)
    got = tdb.RadarPointCloudLoader.from_file_multisweep(
        t, t.get("sample", "samp"), "RADAR_FRONT", "RADAR_FRONT", nsweeps=2)
    want = jdb.RadarPointCloudLoader.from_file_multisweep(
        j, j.get("sample", "samp"), "RADAR_FRONT", "RADAR_FRONT", nsweeps=2)
    _assert_same(got[0], want[0])
    _assert_same(got[1], want[1])
    np.testing.assert_allclose(got[0][:3, 1], [-11.0, 6.0, 0.0], atol=1e-6)


def _dataset_configs(pkg, version, crop):
    graph = pkg.GraphConstructionConfiguration(
        "knn", {"k": 5, "r": 1.0},
        ["rcs", "velocity_vector", "time_index", "degree"],
        ["relative_position"], "directed", "X")
    dataset = pkg.NuScenesDatasetConfiguration(
        version=version, nsweeps=3, crop_point_cloud=crop,
        crop_settings={"x": 30, "y": 20}, wlh_factor=1.1, wlh_offset=0.1,
        bb_invariance="translation")
    return graph, dataset


def _assert_same_dataset(port_root, jax_root):
    port = os.path.join(port_root, "processed")
    jax_ = os.path.join(jax_root, "processed")
    assert sorted(os.listdir(port)) == sorted(os.listdir(jax_))
    with open(os.path.join(port, "config.json")) as f:
        with open(os.path.join(jax_, "config.json")) as g:
            assert json.load(f) == json.load(g)
    files = 0
    for split in sorted(os.listdir(jax_)):
        if split == "config.json":
            continue
        names = sorted(os.listdir(os.path.join(jax_, split)))
        assert sorted(os.listdir(os.path.join(port, split))) == names
        for name in names:
            with np.load(os.path.join(port, split, name)) as za, \
                    np.load(os.path.join(jax_, split, name)) as zb:
                assert list(za.keys()) == list(zb.keys())
                for key in zb:
                    _assert_same(za[key], zb[key], f"{name} {key}")
            files += 1
    return files


@pytest.mark.parametrize("tables,crop", [("jax_fixture", True),
                                         ("jax_fixture", False),
                                         ("writer_trainval", True),
                                         ("writer_trainval", False)])
def test_dataset_creation_matches_jax(tmp_path, host_pair,  # noqa: F811
                                      tables, crop):
    """A whole dataset creation by each package on its own copy of the same
    tables (the JAX test's v1.0-mini root, or the writer's v1.0-trainval
    root with vendored scene tokens, 3 sweeps a radar), with and without
    the crop: the same files, array for array, and the same config.json.
    On the writer's tables this is the on-card smoke's data passing
    through the reference."""
    version = "v1.0-mini" if tables == "jax_fixture" else "v1.0-trainval"
    roots = {}
    for name in ("port", "jax"):
        if tables == "jax_fixture":
            roots[name] = jtests._make_nuscenes_root(tmp_path / name)
        else:
            roots[name] = _writer_root(tmp_path / name)
    tdc.NuScenesGraphDataset(roots["port"], *_dataset_configs(
        tcfg, version, crop))
    jdc.NuScenesGraphDataset(roots["jax"], *_dataset_configs(
        jcfg, version, crop))
    assert _assert_same_dataset(roots["port"], roots["jax"]) == (
        4 if tables == "jax_fixture" else 6)
    assert tdc.CLASS_NAME_TO_ID == jdc.CLASS_NAME_TO_ID


def test_split_tables_match_jax():
    assert tsplits.mini_train == jsplits.mini_train
    assert tsplits.mini_val == jsplits.mini_val
    for name in ("train_detect", "train_track", "val", "test"):
        assert getattr(tsplits, name) == getattr(jsplits, name), name
    tsplits.require_full_splits()


def test_splits_json_override_matches_jax(tmp_path, monkeypatch):
    """A NUSCENES_SPLITS_JSON file takes precedence over the vendored
    constants in both packages, and gives the same split tables."""
    path = str(tmp_path / "splits.json")
    with open(path, "w") as f:
        json.dump({"train_detect": ["b", "a"], "train_track": ["c", "a"],
                   "val": ["v"], "test": ["t"]}, f)
    monkeypatch.setenv("NUSCENES_SPLITS_JSON", path)
    try:
        for mod in (tsplits, jsplits):
            importlib.reload(mod)
        for version in ("v1.0-trainval", "v1.0-test"):
            got = tcfg.NuScenesSplitConfiguration(version).sequence_dict
            assert got == jcfg.NuScenesSplitConfiguration(
                version).sequence_dict
        assert tcfg.NuScenesSplitConfiguration(
            "v1.0-trainval").sequence_dict == {"train": ["a", "b", "c"],
                                               "validate": ["v"]}
    finally:
        monkeypatch.delenv("NUSCENES_SPLITS_JSON")
        for mod in (tsplits, jsplits):
            importlib.reload(mod)
    assert tsplits.val == tvendored.val
