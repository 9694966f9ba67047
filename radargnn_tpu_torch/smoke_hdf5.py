"""The seventh phase's check of the port's HDF5 reader on files h5py wrote
under libver="latest" (`smoke.cli_phase` runs `fixture_check` after its CLI
run). The card's machine has no h5py, so what h5py wrote is committed:
`testdata/hdf5_latest/` holds one file for each structure the reader took on
last (the extensible-array and v2 B-tree chunk indexes, dense link storage,
variable-length strings, array members) and one RadarScenes sequence in
libver "latest" (an extensible-array index, gzip and shuffle, uuid and
track_id as variable-length strings), with `manifest.json`: each dataset's
dtype as h5py gives it, its shape and a SHA-256 of its values as h5py read
them (`entry`). tests/test_torch_hdf5_fixture.py writes the folder.

`fixture_check` reads every dataset of the manifest and holds it to its
entry, then runs the port's dataset creation on the sequence and on a copy
of its rows that the port's own writer wrote (the strings as fixed `S32`):
both must give the same graphs, array for array."""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import time
from typing import Callable, Dict

import numpy as np

from radargnn_tpu_torch.configs import UserConfigurationReader
from radargnn_tpu_torch.data import hdf5
from radargnn_tpu_torch.data.radarscenes.dataset_creation import (
    RadarScenesGraphDataset,
)

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "testdata", "hdf5_latest")
# the RadarScenes dataset root in the fixture (raw/data/sequences.json and
# a sequence's scenes.json and radar_data.h5)
SEQUENCE_ROOT = "radarscenes"
STRING_FIELDS = ("uuid", "track_id")


def describe(dtype: np.dtype):
    """`dtype` as JSON: a scalar's `dtype.str`, a variable-length string's
    h5py metadata ({"vlen": "bytes"} or "str"), a subarray's base and shape,
    a compound's names, formats, offsets and itemsize."""
    if dtype.names is not None:
        return {"names": list(dtype.names),
                "formats": [describe(dtype.fields[n][0]) for n in dtype.names],
                "offsets": [dtype.fields[n][1] for n in dtype.names],
                "itemsize": dtype.itemsize}
    if dtype.subdtype is not None:
        return {"base": describe(dtype.subdtype[0]),
                "shape": list(dtype.subdtype[1])}
    vlen = (dtype.metadata or {}).get("vlen")
    return {"vlen": vlen.__name__} if vlen is not None else dtype.str


def _columns(array: np.ndarray):
    if array.dtype.names is None:
        yield array
        return
    for name in array.dtype.names:
        yield from _columns(array[name])


def digest(array: np.ndarray) -> str:
    """A SHA-256 of `array`'s values: each field's bytes in turn, an object
    field's values (bytes) each after its length in 8 bytes."""
    h = hashlib.sha256()
    for values in _columns(array):
        if values.dtype.kind == "O":
            for value in values.ravel():
                h.update(len(value).to_bytes(8, "little") + value)
        else:
            h.update(np.ascontiguousarray(values).tobytes())
    return h.hexdigest()


def entry(array: np.ndarray) -> Dict:
    """A dataset's line in the manifest."""
    return {"dtype": describe(array.dtype), "shape": list(array.shape),
            "sha256": digest(array)}


def read_fixtures(folder: str = FIXTURE) -> Dict[str, float]:
    """Every dataset the manifest lists, read by the port and held to its
    entry; each file's read ms (every dataset of it, the file cache warm
    after the first call)."""
    with open(os.path.join(folder, "manifest.json")) as f:
        manifest = json.load(f)
    read_ms = {}
    for name, datasets in manifest["files"].items():
        path = os.path.join(folder, name)
        t0 = time.perf_counter()
        got = {key: entry(hdf5.read_dataset(path, key)) for key in datasets}
        read_ms[name] = (time.perf_counter() - t0) * 1e3
        for key, want in datasets.items():
            if got[key] != want:
                raise AssertionError(f"{path}: {key!r} read as {got[key]}, "
                                     f"the manifest says {want}")
    return read_ms


def port_written_copy(src: str, dst: str) -> None:
    """The RadarScenes root `src` copied to `dst` with each sequence's
    radar_data.h5 written anew by the port's writer (its default layout),
    the string fields as fixed `S32`."""
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns("*.h5"))
    data = os.path.join(src, "raw", "data")
    for name in sorted(os.listdir(data)):
        path = os.path.join(data, name, "radar_data.h5")
        if not os.path.isfile(path):
            continue
        radar = hdf5.read_dataset(path, "radar_data")
        rows = np.empty(len(radar), [
            (n, "S32" if n in STRING_FIELDS else radar.dtype[n])
            for n in radar.dtype.names])
        for n in radar.dtype.names:
            rows[n] = radar[n]
        hdf5.write_datasets(
            os.path.join(dst, "raw", "data", name, "radar_data.h5"),
            {"radar_data": rows,
             "odometry": hdf5.read_dataset(path, "odometry")})


def _same_graphs(a: str, b: str) -> int:
    """The graph_<i>.npz files of two processed folders, array for array
    (NaN equal to NaN), keys and dtypes too; their number."""
    count = 0
    for split in sorted(os.listdir(a)):
        if not os.path.isdir(os.path.join(a, split)):
            continue
        names = sorted(os.listdir(os.path.join(a, split)))
        if sorted(os.listdir(os.path.join(b, split))) != names:
            raise AssertionError(f"the {split} graphs differ: {names}")
        for name in names:
            with np.load(os.path.join(a, split, name)) as za, \
                    np.load(os.path.join(b, split, name)) as zb:
                if list(za.keys()) != list(zb.keys()) or not all(
                        za[k].dtype == zb[k].dtype and np.array_equal(
                            za[k], zb[k], equal_nan=za[k].dtype.kind == "f")
                        for k in za):
                    raise AssertionError(f"{split}/{name} differs")
        count += len(names)
    return count


def fixture_check(config: str, card: str = None,
                  out: Callable = print) -> Dict:
    """Every fixture file read to its manifest (`read_fixtures`), then the
    dataset creation under the YAML `config` on the fixture's sequence and
    on its port-written copy (`port_written_copy`): the same graphs, at
    least two. Prints one line: each file's read ms, the two creations'
    seconds, the whole check's seconds, the card (`card`)."""
    start = time.perf_counter()
    res: Dict = {"read_ms": read_fixtures()}
    cfg = UserConfigurationReader.read_config_file(config)
    configs = [UserConfigurationReader.get_config_object(key, cfg)
               for key in ("GRAPH_CONSTRUCTION", "DATASET_PROCESSING")]
    with tempfile.TemporaryDirectory() as tmp:
        roots = {"latest": os.path.join(tmp, "latest"),
                 "port": os.path.join(tmp, "port")}
        shutil.copytree(os.path.join(FIXTURE, SEQUENCE_ROOT), roots["latest"])
        port_written_copy(roots["latest"], roots["port"])
        for kind, root in roots.items():
            t0 = time.perf_counter()
            RadarScenesGraphDataset(root, *configs)
            res[f"{kind}_creation_s"] = time.perf_counter() - t0
        res["graphs"] = _same_graphs(*(os.path.join(r, "processed")
                                       for r in roots.values()))
    if res["graphs"] < 2:
        raise AssertionError(f"the fixture's sequence made {res['graphs']} "
                             "graphs, want at least 2")
    res["check_s"] = time.perf_counter() - start
    out("HDF5 fixtures (libver latest, written by h5py): read ms "
        + ", ".join(f"{k} {v:.2f}" for k, v in res["read_ms"].items())
        + f"; create_dataset on the fixture's sequence "
        f"{res['latest_creation_s']:.3f} s, on its port-written copy "
        f"{res['port_creation_s']:.3f} s, {res['graphs']} graphs equal; "
        f"the check {res['check_s']:.3f} s in all; card {card}")
    return res
