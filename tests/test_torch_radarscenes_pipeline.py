"""The port's RadarScenes pipeline (radargnn_tpu_torch.data) against the JAX
package's on the same raw sequences: the reader, the scene accumulation,
the point-cloud filters and a whole dataset creation. These are numpy
paths in both packages, so every array must be equal (NaN == NaN), the
files' keys and dtypes too.

The raw data is `tests/test_radarscenes_pipeline.py`'s miniature
RadarScenes layout (written by h5py), and the smoke's sequences written by
the port's own HDF5 writer (`smoke.write_radarscenes`); the port reads both
with its own HDF5 reader, the JAX package with h5py. The dataset creations run with both packages on one
pair of host backends (`host_backends.pin`), serially: spawned workers do
not inherit the pin, so the port's parallel run is held to its own serial
one."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("h5py")

from radargnn_tpu import configs as jcfg  # noqa: E402
from radargnn_tpu.data import point_cloud as jpc  # noqa: E402
from radargnn_tpu.data.radarscenes import dataset_creation as jdc  # noqa: E402
from radargnn_tpu.data.radarscenes import reader as jrd  # noqa: E402
from radargnn_tpu.data.radarscenes import scene_collection as jsc  # noqa: E402
from radargnn_tpu.graph import batch as jbatch  # noqa: E402
from radargnn_tpu_torch import configs as tcfg  # noqa: E402
from radargnn_tpu_torch import smoke  # noqa: E402
from radargnn_tpu_torch.cli import create_dataset as tcreate  # noqa: E402
from radargnn_tpu_torch.data import point_cloud as tpc  # noqa: E402
from radargnn_tpu_torch.data.radarscenes import dataset_creation as tdc  # noqa: E402
from radargnn_tpu_torch.data.radarscenes import reader as trd  # noqa: E402
from radargnn_tpu_torch.data.radarscenes import scene_collection as tsc  # noqa: E402
from radargnn_tpu_torch.graph import batch as tbatch  # noqa: E402
from tests.test_radarscenes_pipeline import _make_dataset_root  # noqa: E402

import host_backends  # noqa: E402
from host_backends import native_cache  # noqa: E402,F401

GRAPH_CASES = {
    # the e2e test's kNN graph with time index and degree, rotated boxes
    "knn": (("knn", {"k": 5, "r": 1.0},
             ["rcs", "velocity_vector", "time_index", "degree"],
             ["relative_position"], "directed", "X"),
            dict(bounding_boxes_aligned=False, bb_invariance="translation")),
    # a radius graph on positions and velocities, point-pair features,
    # E(n)-invariant boxes, an even subset of two frames a sequence
    "radius_en_subset": (("radius", {"k": 5, "r": 6.0},
                          ["rcs", "velocity_vector_length", "degree"],
                          ["point_pair_features", "relative_velocity"],
                          "undirected", "XV"),
                         dict(bounding_boxes_aligned=False, bb_invariance="en",
                              create_small_subset=True,
                              subset_settings={"num_clouds_per_sequence": 2})),
    # axis-aligned boxes without invariance, no crop
    "knn_aligned": (("knn", {"k": 3, "r": 1.0}, ["rcs", "spatial_coordinates"],
                     ["spatial_euclidean_distance"], "directed", "X"),
                    dict(bounding_boxes_aligned=True, bb_invariance="none",
                         crop_point_cloud=False)),
}


def _config_args(case: str, **over):
    graph_args, dataset_kw = GRAPH_CASES[case]
    kw = dict(time_per_point_cloud_frame=0.2, crop_point_cloud=True,
              crop_settings={"front": 100, "sides": 50},
              create_small_subset=False, subset_settings={},
              deterministic=True, seed=1, parallelize=False)
    kw.update(dataset_kw, **over)
    return graph_args, kw


def _configs(pkg, case: str, **over):
    graph_args, kw = _config_args(case, **over)
    return (pkg.GraphConstructionConfiguration(*graph_args),
            pkg.RadarScenesDatasetConfiguration(**kw))


@pytest.fixture(scope="module")
def pinned(native_cache):  # noqa: F811
    """Both packages on one pair of host backends for this module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RADARGNN_NATIVE_CACHE", str(native_cache))
        yield host_backends.pin(mp.setattr)


@pytest.fixture(scope="module")
def raw_root(tmp_path_factory):
    return _make_dataset_root(tmp_path_factory.mktemp("raw"))


def _scenes_json(root, name="sequence_1"):
    return os.path.join(root, "raw", "data", name, "scenes.json")


def _assert_same_cloud(a, b):
    va, vb = vars(a), vars(b)
    assert sorted(va) == sorted(vb)
    for key in va:
        if va[key] is None:
            assert vb[key] is None, key
            continue
        assert va[key].dtype == vb[key].dtype, key
        np.testing.assert_array_equal(va[key], vb[key], err_msg=key)


def _assert_same_npz(path_a, path_b):
    with np.load(path_a) as za, np.load(path_b) as zb:
        assert list(za.keys()) == list(zb.keys())
        for key in za:
            assert za[key].dtype == zb[key].dtype, key
            np.testing.assert_array_equal(za[key], zb[key], err_msg=key)


def test_reader_matches_jax(raw_root):
    """The same tables, scenes and walk; the same constants and mappings."""
    for name in ("sequence_1", "sequence_val_1"):
        js = jrd.Sequence.from_json(_scenes_json(raw_root, name))
        ts = trd.Sequence.from_json(_scenes_json(raw_root, name))
        np.testing.assert_array_equal(ts.radar_data, js.radar_data)
        np.testing.assert_array_equal(ts.odometry, js.odometry)
        np.testing.assert_array_equal(ts.timestamps, js.timestamps)
        for t in js.timestamps:
            a, b = js.get_scene(t), ts.get_scene(t)
            assert (b.timestamp, b.sensor_id, b.camera_image_name) == (
                a.timestamp, a.sensor_id, a.camera_image_name)
            np.testing.assert_array_equal(b.radar_data, a.radar_data)
            np.testing.assert_array_equal(b.odometry_data, a.odometry_data)
            assert ts.next_timestamp_after(t) == js.next_timestamp_after(t)
    seq_file = os.path.join(raw_root, "raw", "data", "sequences.json")
    for fn in ("get_training_sequences", "get_validation_sequences"):
        assert getattr(trd, fn)(seq_file) == getattr(jrd, fn)(seq_file)
    assert trd.SENSOR_MOUNTING == jrd.SENSOR_MOUNTING
    assert trd.LABEL_TO_CLABEL == jrd.LABEL_TO_CLABEL
    labels = np.arange(-1, 13)
    np.testing.assert_array_equal(trd.label_to_clabel_array(labels),
                                  jrd.label_to_clabel_array(labels))
    rng = np.random.default_rng(0)
    x, y = rng.normal(size=(2, 50)) * 30
    odo = js.odometry[3]
    for got, want in zip(trd.transform_detections_sequence_to_car(x, y, odo),
                         jrd.transform_detections_sequence_to_car(x, y, odo)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("window", [0.2, 0.5])
def test_scene_collection_matches_jax(raw_root, window):
    """Each window's scenes and its processed cloud, every attribute, then
    the crop and invalid-point filters on it."""
    js = jrd.Sequence.from_json(_scenes_json(raw_root))
    ts = trd.Sequence.from_json(_scenes_json(raw_root))
    _, jcfg_ds = _configs(jcfg, "knn")
    _, tcfg_ds = _configs(tcfg, "knn")
    for start in js.timestamps[:-1]:
        jcol = jsc.concatenate_subsequent_scenes(js, int(start), window)
        tcol = tsc.concatenate_subsequent_scenes(ts, int(start), window)
        assert [s.timestamp for s in tcol.scenes] == \
            [s.timestamp for s in jcol.scenes]
        jcol.process()
        tcol.process()
        _assert_same_cloud(tcol.point_cloud, jcol.point_cloud)
        _assert_same_cloud(
            tdc.PointCloudProcessor.transform(tcfg_ds, tcol.point_cloud),
            jdc.PointCloudProcessor.transform(jcfg_ds, jcol.point_cloud))


def test_point_cloud_filters_match_jax():
    """The filters on a cloud with NaN labels and velocities, points behind
    the car and beyond the crop."""
    rng = np.random.default_rng(3)
    n = 200
    clouds = [jpc.RadarPointCloud(), tpc.RadarPointCloud()]
    arrays = dict(
        X_cc=rng.uniform(-20, 150, (n, 2)) * [1, 0.6],
        V_cc_compensated=np.where(rng.random((n, 2)) < 0.05, np.nan,
                                  rng.normal(size=(n, 2))),
        label_id=np.where(rng.random((n, 1)) < 0.1, np.nan,
                          rng.integers(0, 6, (n, 1))),
        rcs=rng.normal(size=(n, 1)),
        track_id=rng.integers(0, 5, (n, 1)).astype("S4"))
    for cloud in clouds:
        for key, value in arrays.items():
            setattr(cloud, key, value.copy())
        cloud.remove_points_out_of_range(100, 50)
        cloud.remove_points_without_labelID()
        cloud.remove_points_without_valid_velocity()
        cloud.remove_points_based_on_index(np.array([0, 3]))
    _assert_same_cloud(clouds[1], clouds[0])
    assert clouds[1].num_points == clouds[0].num_points > 0
    assert tpc.RadarPointCloud().num_points == 0


@pytest.mark.parametrize("case", sorted(GRAPH_CASES))
def test_dataset_creation_matches_jax(tmp_path, pinned, case):
    """A whole creation run: every split's graph_<i>.npz equal array for
    array (keys and dtypes too), and config.json equal."""
    roots = [_make_dataset_root(tmp_path / p) for p in ("jax", "port")]
    jdc.RadarScenesGraphDataset(roots[0], *_configs(jcfg, case))
    ds = tdc.RadarScenesGraphDataset(roots[1], *_configs(tcfg, case))
    total = 0
    for split in ("train", "test", "validate"):
        dirs = [os.path.join(r, "processed", split) for r in roots]
        names = sorted(os.listdir(dirs[0]))
        assert sorted(os.listdir(dirs[1])) == names
        assert ds.len(split) == len(names)
        for name in names:
            _assert_same_npz(*(os.path.join(d, name) for d in dirs))
        total += len(names)
    assert total >= 3
    configs = []
    for root in roots:
        with open(os.path.join(root, "processed", "config.json")) as f:
            configs.append(json.load(f))
    assert configs[1] == configs[0]
    sample = ds.get("validate", 0)
    assert isinstance(sample, tbatch.GraphSample) and sample.num_edges > 0


def test_parallel_creation_matches_serial(tmp_path):
    """The port's spawned workers write the serial run's files."""
    roots = [_make_dataset_root(tmp_path / p) for p in ("serial", "pool")]
    for root, parallel in zip(roots, (False, True)):
        tdc.RadarScenesGraphDataset(
            root, *_configs(tcfg, "knn", parallelize=parallel), num_workers=2)
    for split in ("train", "validate"):
        dirs = [os.path.join(r, "processed", split) for r in roots]
        names = sorted(os.listdir(dirs[0]))
        assert names and sorted(os.listdir(dirs[1])) == names
        for name in names:
            _assert_same_npz(*(os.path.join(d, name) for d in dirs))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_reads_the_others_npz(tmp_path, writer):
    rng = np.random.default_rng(5)
    arrays = dict(
        node_feat=rng.normal(size=(30, 5)).astype(np.float32),
        edge_feat=rng.normal(size=(90, 2)).astype(np.float32),
        senders=rng.integers(0, 30, 90).astype(np.int32),
        receivers=rng.integers(0, 30, 90).astype(np.int32),
        labels=rng.integers(0, 6, 30).astype(np.int32),
        boxes=np.where(rng.random((30, 5)) < 0.5, np.nan,
                       rng.normal(size=(30, 5))).astype(np.float32),
        pos=rng.normal(size=(30, 2)).astype(np.float32),
        vel=rng.normal(size=(30, 2)).astype(np.float32))
    write, read = (jbatch, tbatch) if writer == "jax" else (tbatch, jbatch)
    path = str(tmp_path / "graph_0.npz")
    write.GraphSample(**arrays).save_npz(path)
    back = read.GraphSample.load_npz(path)
    for key, value in arrays.items():
        got = getattr(back, key)
        assert got.dtype == value.dtype, key
        np.testing.assert_array_equal(got, value, err_msg=key)
    other = str(tmp_path / "graph_1.npz")
    read.GraphSample(**arrays).save_npz(other)
    _assert_same_npz(path, other)


def test_reader_without_h5py_raises(raw_root, monkeypatch):
    """With h5py blocked (sys.modules["h5py"] = None, as on the card's
    machine, which lacks it) the port still reads a sequence, through its
    own HDF5 reader, equal to what the JAX package reads with h5py."""
    want = jrd.Sequence.from_json(_scenes_json(raw_root))
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError):
        import h5py  # noqa: F401
    got = trd.Sequence.from_json(_scenes_json(raw_root))
    for table in ("radar_data", "odometry"):
        assert getattr(got, table).dtype == getattr(want, table).dtype
        np.testing.assert_array_equal(getattr(got, table),
                                      getattr(want, table), err_msg=table)


def _rewrite_latest(root: str) -> None:
    """Each sequence's radar_data.h5 under `root` written anew by h5py in
    what libver="latest" gives an appendable table: radar_data in chunks
    of 16 rows with an unlimited maximum (the extensible-array chunk
    index), gzip and shuffle; odometry unlimited too; uuid and track_id as
    variable-length ASCII strings; all in one dense group (with the
    sequence's own tables, more than 8 links)."""
    import h5py
    data = os.path.join(root, "raw", "data")
    vlen = h5py.string_dtype("ascii")
    for name in sorted(os.listdir(data)):
        path = os.path.join(data, name, "radar_data.h5")
        if not os.path.isfile(path):
            continue
        with h5py.File(path, "r") as f:
            radar, odometry = f["radar_data"][()], f["odometry"][()]
        rows = np.empty(len(radar), [
            (n, vlen if n in ("uuid", "track_id") else radar.dtype[n])
            for n in radar.dtype.names])
        for n in radar.dtype.names:
            rows[n] = radar[n]
        with h5py.File(path, "w", libver="latest") as f:
            f.create_dataset("radar_data", data=rows, chunks=(16,),
                             maxshape=(None,), compression="gzip",
                             shuffle=True)
            f.create_dataset("odometry", data=odometry, maxshape=(None,))
            for i in range(9):
                f.create_dataset(f"note_{i}", data=np.arange(i + 1))


@pytest.mark.parametrize("case", sorted(GRAPH_CASES))
def test_latest_layout_creation_matches_jax(tmp_path, pinned, monkeypatch,
                                            case):
    """The miniature sequences in h5py's libver="latest" layout
    (`_rewrite_latest`): the JAX package's creation (h5py) and the port's
    (its own reader, h5py blocked) write the same graph_<i>.npz files,
    array for array, keys and dtypes too; the port reads uuid and track_id
    as h5py does, objects of bytes."""
    roots = [_make_dataset_root(tmp_path / p) for p in ("jax", "port")]
    for root in roots:
        _rewrite_latest(root)
    jdc.RadarScenesGraphDataset(roots[0], *_configs(jcfg, case))
    want = jrd.Sequence.from_json(_scenes_json(roots[0])).radar_data
    monkeypatch.setitem(sys.modules, "h5py", None)
    got = trd.Sequence.from_json(_scenes_json(roots[1])).radar_data
    assert got.dtype == want.dtype and got.dtype["uuid"] == object
    for name in ("uuid", "track_id"):
        assert got[name].tolist() == want[name].tolist()
        assert got.dtype[name].metadata == want.dtype[name].metadata
    tdc.RadarScenesGraphDataset(roots[1], *_configs(tcfg, case))
    total = 0
    for split in ("train", "test", "validate"):
        dirs = [os.path.join(r, "processed", split) for r in roots]
        names = sorted(os.listdir(dirs[0]))
        assert sorted(os.listdir(dirs[1])) == names
        for name in names:
            _assert_same_npz(*(os.path.join(d, name) for d in dirs))
        total += len(names)
    assert total >= 3


@pytest.fixture(scope="module")
def port_written_root(tmp_path_factory):
    """The smoke's raw sequences (four of 12 scans of ~60 detections),
    written by the port's HDF5 writer."""
    root = str(tmp_path_factory.mktemp("port_raw"))
    smoke.write_radarscenes(root, scans=12, points_per_scan=60)
    return root


def test_port_written_sequences_read_the_same(port_written_root):
    """h5py (the JAX package's reader) and the port's reader give the same
    tables, dtypes and scenes on sequences the port wrote."""
    for name, _ in smoke.CLI_SEQUENCES:
        js = jrd.Sequence.from_json(_scenes_json(port_written_root, name))
        ts = trd.Sequence.from_json(_scenes_json(port_written_root, name))
        for table in ("radar_data", "odometry"):
            assert getattr(ts, table).dtype == getattr(js, table).dtype
            np.testing.assert_array_equal(getattr(ts, table),
                                          getattr(js, table))
        assert ts.radar_data.dtype == smoke.RADAR_DTYPE
        np.testing.assert_array_equal(ts.timestamps, js.timestamps)
        for t in js.timestamps:
            np.testing.assert_array_equal(ts.get_scene(t).radar_data,
                                          js.get_scene(t).radar_data)


# the port's dataset creation in a fresh interpreter where h5py cannot be
# imported, on the host backend the JAX side is pinned to (argv[2])
_CREATE_WITHOUT_H5PY = """
import json, sys
sys.modules["h5py"] = None
import radargnn_tpu_torch.native as native
if sys.argv[2] == "numpy":
    native._LIB, native._TRIED = None, True
elif native.load() is None:
    raise SystemExit("the port's compiled host helper did not load")
from radargnn_tpu_torch import configs
from radargnn_tpu_torch.data.radarscenes.dataset_creation import (
    RadarScenesGraphDataset)
graph_args, kw = json.loads(sys.argv[3])
RadarScenesGraphDataset(sys.argv[1],
                        configs.GraphConstructionConfiguration(*graph_args),
                        configs.RadarScenesDatasetConfiguration(**kw))
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "radargnn_tpu")]
assert not bad and sys.modules["h5py"] is None, bad
"""


def test_creation_on_port_written_sequences_matches_jax(
        tmp_path, pinned, port_written_root):
    """Both packages' dataset creations turn the port-written sequences
    into the same graph_<i>.npz files, array for array: the JAX package's
    here (h5py), the port's in a fresh interpreter with h5py blocked."""
    roots = []
    for pkg in ("jax", "port"):
        root = str(tmp_path / pkg)
        os.makedirs(root)
        os.symlink(os.path.join(port_written_root, "raw"),
                   os.path.join(root, "raw"))
        roots.append(root)
    jdc.RadarScenesGraphDataset(roots[0], *_configs(jcfg, "knn"))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-c", _CREATE_WITHOUT_H5PY, roots[1], pinned,
         json.dumps(_config_args("knn"))], cwd=repo,
        env=dict(os.environ, PYTHONPATH=repo), capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    total = 0
    for split in ("train", "test", "validate"):
        dirs = [os.path.join(r, "processed", split) for r in roots]
        names = sorted(os.listdir(dirs[0]))
        assert sorted(os.listdir(dirs[1])) == names
        for name in names:
            _assert_same_npz(*(os.path.join(d, name) for d in dirs))
        total += len(names)
    assert total >= 8


def test_dataset_selector():
    assert tcreate.dataset_selector("radarscenes") is \
        tdc.RadarScenesGraphDataset
    from radargnn_tpu_torch.data.nuscenes.dataset_creation import (
        NuScenesGraphDataset,
    )
    assert tcreate.dataset_selector("nuscenes") is NuScenesGraphDataset
    with pytest.raises(KeyError):
        tcreate.dataset_selector("kitti")
