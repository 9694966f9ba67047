"""The committed HDF5 fixture (`radargnn_tpu_torch/testdata/hdf5_latest`,
`smoke_hdf5.FIXTURE`, which the on-card smoke reads; the card's machine has
no h5py): rebuilt here by h5py under libver "latest" (`write_fixture`), it
holds the values of the committed files (values, not bytes), the committed
files hold what their manifest says as h5py reads them, and each holds the
structure it stands for.

To write the fixture anew: `JAX_PLATFORMS=cpu python
tests/test_torch_hdf5_fixture.py`.
"""

import json
import os
import shutil
import sys
import tempfile

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

from radargnn_tpu_torch import smoke, smoke_hdf5 as sh  # noqa: E402

# the fixture's elements past the first paged data block of an extensible
# array (elements from 131,060 on: super block 13's)
FIRST_PAGED = 131_060
MAX_BYTES = 400 * 1024
# the fixture's RadarScenes sequence: the smoke's first raw sequence at a
# size that makes two frames under the flagship YAML's 0.5 s windows
SEQUENCE, SCANS, POINTS_PER_SCAN = "sequence_1", 17, 60


def _extensible_array(f, rng):
    f.create_dataset("rows", data=rng.integers(0, 255, 1000, "u1"),
                     chunks=(1,), maxshape=(None,))
    d = f.create_dataset("sparse", shape=(FIRST_PAGED + 2000,), dtype="<i2",
                         chunks=(1,), maxshape=(None,), fillvalue=-3)
    d[:300] = rng.integers(-999, 999, 300)
    d[FIRST_PAGED + 1500] = 7
    f.create_dataset("first", data=rng.normal(size=(40, 3)), chunks=(2, 2),
                     maxshape=(None, 3), compression="gzip", shuffle=True)
    f.create_dataset("last", data=rng.normal(size=(4, 30)).astype("<f4"),
                     chunks=(1, 2), maxshape=(4, None), fletcher32=True)


def _btree2(f, rng):
    f.create_dataset("grid", data=rng.integers(0, 9, (20, 20), "u1"),
                     chunks=(1, 1), maxshape=(None, None))
    f.create_dataset("cube", data=rng.normal(size=(5, 4, 6)),
                     chunks=(2, 3, 2), maxshape=(None, 4, None),
                     compression="gzip")


def _dense_links(f, rng):
    g = f.create_group("g", track_order=True)
    tables = [g.create_dataset(f"d{i:05d}", data=rng.normal(size=i + 2))
              for i in range(0, 300, 100)]
    for i in range(300):
        if f"d{i:05d}" not in g:
            g[f"d{i:05d}"] = tables[i % 3]
    sub = g.create_group("sub")
    for i in range(12):
        sub.create_dataset(f"é{i}", data=np.full(2, i, "<i2"))
    return ["g/d00000", "g/d00299", "g/sub/é11"]


def _vlen_strings(f, rng):
    vlen = h5py.string_dtype("ascii")
    f.create_dataset("ascii", data=np.array([b"", b"a", b"xyz" * 5] * 60,
                                            object), dtype=vlen)
    f.create_dataset("utf8", data=np.array(["é", "", "ab"], object),
                     dtype=h5py.string_dtype())
    rows = np.zeros(30, [("x", "<i4"), ("s", vlen), ("t", "<f8")])
    rows["x"] = np.arange(30)
    rows["s"] = [bytes(rng.integers(97, 123, k).astype("u1"))
                 for k in rng.integers(0, 20, 30)]
    rows["t"] = rng.normal(size=30)
    f.create_dataset("rows", data=rows)
    f.create_dataset("rows_chunked", data=rows, chunks=(7,),
                     maxshape=(None,), compression="gzip")
    f.create_dataset("filled", shape=(3,), fillvalue=b"fill", dtype=vlen)


def _array_members(f, rng):
    rows = np.zeros(9, [("v", "<f4", (2,)), ("m", ">i2", (2, 3)),
                        ("pts", [("x", "<f8"), ("y", "u1")], (2,))])
    rows["v"] = rng.normal(size=(9, 2))
    rows["m"] = rng.integers(-99, 99, (9, 2, 3))
    rows["pts"]["x"] = rng.normal(size=(9, 2))
    rows["pts"]["y"] = rng.integers(0, 255, (9, 2))
    f.create_dataset("rows", data=rows)
    names = np.zeros(3, [("id", "<i8"), ("names", h5py.string_dtype(
        "ascii"), (2,))])
    names["names"] = [[b"a", b"bc"], [b"", b"d"], [b"eee", b""]]
    f.create_dataset("names", data=names)
    top = h5py.h5t.array_create(h5py.h5t.IEEE_F32LE, (2, 3))
    h5py.h5d.create(f.id, b"top", top, h5py.h5s.create_simple((4,))).write(
        h5py.h5s.ALL, h5py.h5s.ALL, rng.normal(size=(4, 2, 3)).astype("<f4"),
        mtype=top)


FEATURES = {"extensible_array.h5": _extensible_array, "btree2.h5": _btree2,
            "dense_links.h5": _dense_links, "vlen_strings.h5": _vlen_strings,
            "array_members.h5": _array_members}


def _write_sequence(root: str) -> str:
    """The smoke's first raw sequence (`smoke.write_radarscenes`) under
    `root`/raw/data as the only (train) sequence, its tables written by
    h5py under libver "latest": radar_data in chunks of 64 rows with an
    unlimited maximum (the extensible-array index), gzip and shuffle,
    uuid and track_id as variable-length ASCII strings. Its
    radar_data.h5's path in the fixture."""
    vlen = h5py.string_dtype("ascii")
    with tempfile.TemporaryDirectory() as tmp:
        smoke.write_radarscenes(tmp, SCANS, POINTS_PER_SCAN)
        src = os.path.join(tmp, "raw", "data", SEQUENCE)
        with h5py.File(os.path.join(src, "radar_data.h5"), "r") as f:
            radar, odometry = f["radar_data"][()], f["odometry"][()]
        data = os.path.join(root, "raw", "data")
        os.makedirs(os.path.join(data, SEQUENCE))
        shutil.copy(os.path.join(src, "scenes.json"),
                    os.path.join(data, SEQUENCE))
    with open(os.path.join(data, "sequences.json"), "w") as f:
        json.dump({"sequences": {SEQUENCE: {"category": "train"}}}, f)
    rows = np.empty(len(radar), [
        (n, vlen if n in sh.STRING_FIELDS else radar.dtype[n])
        for n in radar.dtype.names])
    for n in radar.dtype.names:
        rows[n] = radar[n]
    path = os.path.join(data, SEQUENCE, "radar_data.h5")
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("radar_data", data=rows, chunks=(64,),
                         maxshape=(None,), compression="gzip", shuffle=True)
        f.create_dataset("odometry", data=odometry, maxshape=(None,))
    return os.path.relpath(path, os.path.dirname(root))


def write_fixture(folder: str) -> None:
    """The fixture's files, written by h5py from seeded values, and their
    manifest: each dataset's entry (`smoke_hdf5.entry`) as h5py reads it
    (every dataset of a file's root where its writer names none)."""
    os.makedirs(folder)
    rng = np.random.default_rng(22)
    files = {}
    for name, write in FEATURES.items():
        with h5py.File(os.path.join(folder, name), "w", libver="latest") as f:
            files[name] = write(f, rng)
    files[_write_sequence(os.path.join(folder, sh.SEQUENCE_ROOT))] = \
        ["radar_data", "odometry"]
    manifest = {}
    for name, datasets in files.items():
        with h5py.File(os.path.join(folder, name), "r") as f:
            if datasets is None:
                datasets = sorted(f)
            manifest[name] = {k: sh.entry(f[k][()]) for k in datasets}
    with open(os.path.join(folder, "manifest.json"), "w") as f:
        json.dump({"files": manifest}, f, indent=1, sort_keys=True)


def _manifest(folder: str) -> dict:
    with open(os.path.join(folder, "manifest.json")) as f:
        return json.load(f)["files"]


def test_fixture_is_what_h5py_writes(tmp_path):
    """h5py, from the seed, writes files whose values, dtypes and shapes
    are the committed manifest's; and h5py reads the committed files as
    their manifest says."""
    folder = str(tmp_path / "fixture")
    write_fixture(folder)
    committed = _manifest(sh.FIXTURE)
    assert _manifest(folder) == committed
    for name, datasets in committed.items():
        with h5py.File(os.path.join(sh.FIXTURE, name), "r") as f:
            for key, want in datasets.items():
                assert sh.entry(f[key][()]) == want, (name, key)


def test_fixture_holds_each_structure():
    """Each file holds the structure it stands for (the extensible array's
    super blocks and a paged data block, a v2 B-tree chunk index with an
    internal node, of both record types, a fractal heap of links, global
    heap strings, array datatypes), the sequence an extensible array and
    strings; the folder is under MAX_BYTES."""
    def raw(name):
        with open(os.path.join(sh.FIXTURE, name), "rb") as f:
            return f.read()

    ea = raw("extensible_array.h5")
    assert ea.count(b"EASB") >= 2 and any(
        int.from_bytes(ea[i + 14:i + 18], "little") >= FIRST_PAGED - 4
        for i in range(len(ea)) if ea.startswith(b"EADB", i))
    bt = raw("btree2.h5")
    assert b"BTIN" in bt and {bt[i + 5] for i in range(len(bt))
                              if bt.startswith(b"BTHD", i)} == {10, 11}
    assert b"FRHP" in raw("dense_links.h5")
    assert b"GCOL" in raw("vlen_strings.h5")
    sequence = raw(os.path.join(sh.SEQUENCE_ROOT, "raw", "data", SEQUENCE,
                                "radar_data.h5"))
    assert b"EAHD" in sequence and b"GCOL" in sequence
    with h5py.File(os.path.join(sh.FIXTURE, "array_members.h5"), "r") as f:
        assert f["top"].dtype.subdtype is not None
    size = sum(os.path.getsize(os.path.join(d, n))
               for d, _, names in os.walk(sh.FIXTURE) for n in names)
    assert size < MAX_BYTES, size


if __name__ == "__main__":
    shutil.rmtree(sh.FIXTURE, ignore_errors=True)
    write_fixture(sh.FIXTURE)
    print(f"wrote {sh.FIXTURE}")
