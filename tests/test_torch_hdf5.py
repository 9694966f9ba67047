"""The port's HDF5 reader and writer (radargnn_tpu_torch.data.hdf5) against
h5py, the oracle: every layout h5py writes under libver "earliest" and
"latest" for the RadarScenes tables and the other dtypes a table may hold
must read back with h5py's dtype (names, formats, offsets, itemsize) and
values; the layouts the reader leaves out raise errors that name them; h5py
reads back what the writer writes. The structures only "latest" writes
(the extensible-array and v2 B-tree chunk indexes, dense link storage) and
variable-length strings and array datatypes at their sizes are
tests/test_torch_hdf5_latest.py's."""

import mmap
import os
import tempfile

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

h5py = pytest.importorskip("h5py")

from radargnn_tpu_torch.data import hdf5  # noqa: E402
from radargnn_tpu_torch.smoke import ODO_DTYPE, RADAR_DTYPE  # noqa: E402

LIBVERS = ("earliest", "latest")
ROWS = 23

NESTED = np.dtype([("id", "<u4"), ("pose", [("x", "<f8"), ("y", ">f4")]),
                   ("tag", "S3")])
HOLE = np.dtype({"names": ["a", "b", "c"], "formats": ["<i2", "<f8", "u1"],
                 "offsets": [0, 8, 20], "itemsize": 24})
DTYPES = {
    "radar": RADAR_DTYPE, "odometry": ODO_DTYPE, "i1": np.dtype("i1"),
    "be_i4": np.dtype(">i4"), "be_u2": np.dtype(">u2"),
    "be_f8": np.dtype(">f8"), "be_f4": np.dtype(">f4"),
    "f2": np.dtype("<f2"), "u8": np.dtype("<u8"), "bool": np.dtype(bool),
    "nested": NESTED, "hole": HOLE, "s7": np.dtype("S7"),
    "complex": np.dtype("<c8"),
    "be_compound": np.dtype([("t", ">i8"), ("v", ">f4"), ("ok", bool)]),
    "enum": h5py.enum_dtype({"RED": 0, "GREEN": 1, "BLUE": 7},
                            basetype=">i2"),
}


def _values(dt: np.dtype, n: int, rng) -> np.ndarray:
    """Seeded values for every field of `dt` (strings of every length up
    to the full width, no NaN)."""
    out = np.zeros(n, dt)
    enum = h5py.check_enum_dtype(dt)
    if dt.names is not None:
        for name in dt.names:
            out[name] = _values(dt.fields[name][0], n, rng)
    elif enum:
        out[...] = rng.choice(list(enum.values()), n)
    elif dt.kind in "iu":
        info = np.iinfo(dt)
        out[...] = rng.integers(info.min, info.max, n, endpoint=True,
                                dtype=dt.newbyteorder("="))
    elif dt.kind == "f":
        out[...] = rng.normal(0, 100, n)
    elif dt.kind == "c":
        out[...] = rng.normal(size=n) + 1j * rng.normal(size=n)
    elif dt.kind == "b":
        out[...] = rng.random(n) < 0.5
    elif dt.kind == "S":
        out[...] = [bytes(rng.integers(33, 127, rng.integers(
            0, dt.itemsize, endpoint=True)).astype(np.uint8)) for _ in range(n)]
    return out


def _assert_same(got: np.ndarray, want: np.ndarray, msg: str = "") -> None:
    # names, formats, offsets and itemsize (h5py's string metadata aside)
    assert got.dtype == want.dtype, (msg, got.dtype, want.dtype)
    assert got.dtype.itemsize == want.dtype.itemsize, msg
    assert got.dtype.names == want.dtype.names, msg
    if want.dtype.names is not None:
        assert [got.dtype.fields[n][1] for n in got.dtype.names] == \
            [want.dtype.fields[n][1] for n in want.dtype.names], msg
    assert got.shape == want.shape, msg
    if want.dtype.names is None:
        np.testing.assert_array_equal(got, want, err_msg=msg)
        return
    for name in want.dtype.names:
        _assert_same(got[name], want[name], f"{msg}.{name}")


def _check_all(path: str, names) -> None:
    with h5py.File(path, "r") as f:
        wants = {name: f[name][()] for name in names}
    for name, want in wants.items():
        _assert_same(hdf5.read_dataset(path, name), want, name)


def _dcpl(chunks=None, layout=None, early=False):
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    if layout is not None:
        dcpl.set_layout(layout)
    if chunks is not None:
        dcpl.set_chunk(chunks)
    if early:
        dcpl.set_alloc_time(h5py.h5d.ALLOC_TIME_EARLY)
    return dcpl


# each layout as create_dataset keywords for ROWS rows
LAYOUTS = {
    "contiguous": lambda: {},
    "compact": lambda: {"dcpl": _dcpl(layout=h5py.h5d.COMPACT)},
    "gzip_shuffle": lambda: dict(chunks=(6,), compression="gzip",
                                 shuffle=True),
    "fletcher32": lambda: dict(chunks=(5,), fletcher32=True),
    "gzip_shuffle_fletcher32": lambda: dict(
        chunks=(4,), compression="gzip", compression_opts=9, shuffle=True,
        fletcher32=True),
    "ragged_chunks": lambda: dict(chunks=(10,)),
    "single_chunk": lambda: dict(chunks=(ROWS,)),
    "single_chunk_gzip": lambda: dict(chunks=(ROWS,), compression="gzip"),
    "implicit": lambda: {"dcpl": _dcpl(chunks=(4,), early=True)},
    "unlimited": lambda: dict(chunks=(4,), maxshape=(None,)),
}


# "latest" with an unlimited maximum writes the extensible array index
@pytest.mark.parametrize("libver, layout", [
    (libver, layout) for libver in LIBVERS for layout in sorted(LAYOUTS)])
def test_reader_matches_h5py(tmp_path, libver, layout):
    """Every dtype under one layout, in one file, in two groups (under
    "latest" each holds its 8 links compact)."""
    rng = np.random.default_rng(7)
    path = str(tmp_path / "t.h5")
    names = [f"g{i % 2}/{name}" for i, name in enumerate(DTYPES)]
    with h5py.File(path, "w", libver=libver) as f:
        for name, dt in zip(names, DTYPES.values()):
            f.create_dataset(name, data=_values(dt, ROWS, rng),
                             **LAYOUTS[layout]())
    _check_all(path, names)


@pytest.mark.parametrize("libver", LIBVERS)
def test_zero_rows_and_fill_values(tmp_path, libver):
    """0 rows (contiguous and chunked), data never written (the fill value,
    or zeros), and chunks partly written (the fill value where a chunk was
    never written), for a float and a compound."""
    path = str(tmp_path / "t.h5")
    rng = np.random.default_rng(1)
    fill = _values(ODO_DTYPE, 1, rng)[0]
    with h5py.File(path, "w", libver=libver) as f:
        f.create_dataset("empty", data=np.zeros(0, RADAR_DTYPE))
        f.create_dataset("empty_chunked", data=np.zeros(0, ODO_DTYPE),
                         chunks=(4,), maxshape=(None,) if libver ==
                         "earliest" else (8,))
        f.create_dataset("unwritten", shape=(9,), dtype="<f4",
                         fillvalue=2.5)
        f.create_dataset("unwritten_zeros", shape=(5,), dtype=ODO_DTYPE)
        d = f.create_dataset("partial", shape=(20,), dtype=ODO_DTYPE,
                             chunks=(4,), fillvalue=fill)
        d[4:9] = _values(ODO_DTYPE, 5, rng)
        g = f.create_dataset("partial_gzip", shape=(ROWS,), dtype=">f8",
                             chunks=(3,), compression="gzip", fillvalue=-1)
        g[10:12] = [4.0, 5.0]
    _check_all(path, ["empty", "empty_chunked", "unwritten",
                      "unwritten_zeros", "partial", "partial_gzip"])
    assert (hdf5.read_dataset(path, "unwritten") == 2.5).all()


@pytest.mark.parametrize("libver", LIBVERS)
def test_null_terminated_strings(tmp_path, libver):
    """Null-terminated strings (written through the low-level API, as C
    code writes them), alone, in a compound and in a compound's compound:
    h5py reads each up to its first null."""
    path = str(tmp_path / "t.h5")
    strings = np.array([b"", b"a", b"abcde", b"abcdef", b"ab\0cd"], "S6")
    compound = np.zeros(len(strings), [("a", "<i2"), ("s", "S6")])
    compound["a"] = np.arange(len(strings))
    compound["s"] = strings
    with h5py.File(path, "w", libver=libver) as f:
        tid = h5py.h5t.C_S1.copy()
        tid.set_size(6)
        tid.set_strpad(h5py.h5t.STR_NULLTERM)
        space = h5py.h5s.create_simple((len(strings),))
        h5py.h5d.create(f.id, b"s", tid, space).write(
            h5py.h5s.ALL, h5py.h5s.ALL, strings, mtype=tid)
        ct = h5py.h5t.create(h5py.h5t.COMPOUND, compound.dtype.itemsize)
        ct.insert(b"a", 0, h5py.h5t.STD_I16LE)
        ct.insert(b"s", 2, tid)
        h5py.h5d.create(f.id, b"c", ct, space).write(
            h5py.h5s.ALL, h5py.h5s.ALL, compound, mtype=ct)
        outer = np.zeros(len(strings), [("k", "u1"), ("c", compound.dtype)])
        outer["c"] = compound
        ot = h5py.h5t.create(h5py.h5t.COMPOUND, outer.dtype.itemsize)
        ot.insert(b"k", 0, h5py.h5t.STD_U8LE)
        ot.insert(b"c", outer.dtype.fields["c"][1], ct)
        h5py.h5d.create(f.id, b"outer", ot, space).write(
            h5py.h5s.ALL, h5py.h5s.ALL, outer, mtype=ot)
    _check_all(path, ["s", "c", "outer"])
    assert hdf5.read_dataset(path, "s").tolist() == [
        b"", b"a", b"abcde", b"abcdef", b"ab"]


@pytest.mark.parametrize("libver", LIBVERS)
def test_groups_and_paths(tmp_path, libver):
    """A group of 40 datasets (several SNOD nodes under "earliest"; dense
    link storage under "latest"), nested groups walked by path, a dataset
    whose header grew by attributes after it was written (continuation
    blocks), and one in a 2-D chunked layout whose maximum shape exceeds
    its shape (the chunk grid follows the maximum)."""
    path = str(tmp_path / "t.h5")
    rng = np.random.default_rng(2)
    many = 40
    with h5py.File(path, "w", libver=libver) as f:
        for i in range(many):
            f.create_dataset(f"d{i:02d}", data=np.full(3, i, "<i4"))
        g = f.create_group("a").create_group("b")
        table = g.create_dataset("radar_data",
                                 data=_values(RADAR_DTYPE, 9, rng))
        for i in range(12):             # the header continues elsewhere
            table.attrs[f"note_{i}"] = np.full(40, i, "<f8")
        grid = f.create_dataset("a/grid", shape=(7, 5), maxshape=(12, 9),
                                chunks=(3, 2), dtype="<f4")
        grid[...] = rng.normal(size=(7, 5))
    _check_all(path, [f"d{i:02d}" for i in range(many)]
               + ["a/b/radar_data", "/a/grid"])


def _root_btree_level(path: str) -> int:
    with open(path, "rb") as f, mmap.mmap(
            f.fileno(), 0, access=mmap.ACCESS_READ) as mm:
        file = hdf5._File(path, f, mm)
        for mtype, _, data in file.messages(file.root):
            if mtype == 0x11:
                return file.mm[file.base + file.cursor(0, data).addr() + 5]
    raise AssertionError("no symbol table")


def test_group_btree_of_two_levels(tmp_path):
    """A symbol-table group whose B-tree has a level above its leaves."""
    path = str(tmp_path / "t.h5")
    names = [f"n{i:03d}" for i in range(300)]
    with h5py.File(path, "w") as f:
        for i, name in enumerate(names):
            f.create_dataset(name, data=np.array([i], "<i2"))
    assert _root_btree_level(path) >= 1
    _check_all(path, names[::23] + names[-1:])


@pytest.mark.parametrize("gzip", [False, True])
@pytest.mark.parametrize("libver", LIBVERS)
def test_fixed_array_pages(tmp_path, libver, gzip):
    """More than 1,024 chunks: under "latest" the fixed array's data block
    is paged (and its filtered entries carry size and mask); under
    "earliest" the chunks' B-tree has a level above its leaves. Then 3,000
    chunks of which two were written (pages never written hold no
    entries)."""
    path = str(tmp_path / "t.h5")
    data = _values(ODO_DTYPE, 1100, np.random.default_rng(3))
    compression = "gzip" if gzip else None
    with h5py.File(path, "w", libver=libver) as f:
        f.create_dataset("odometry", data=data, chunks=(1,),
                         compression=compression)
        sparse = f.create_dataset("sparse", shape=(3000,), dtype="<i4",
                                  chunks=(1,), fillvalue=-7,
                                  compression=compression)
        sparse[5], sparse[2500] = 3, 4
    _check_all(path, ["odometry", "sparse"])


@settings(max_examples=25, deadline=None)
@given(rows=st.integers(1, 70), chunk=st.integers(1, 16),
       libver=st.sampled_from(LIBVERS), gzip=st.booleans(),
       shuffle=st.booleans())
def test_reader_on_drawn_chunkings(rows, chunk, libver, gzip, shuffle):
    rng = np.random.default_rng(rows * 31 + chunk)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "t.h5")
        with h5py.File(path, "w", libver=libver) as f:
            f.create_dataset("radar_data",
                             data=_values(RADAR_DTYPE, rows, rng),
                             chunks=(min(chunk, rows),), shuffle=shuffle,
                             compression="gzip" if gzip else None)
        _check_all(path, ["radar_data"])


def test_filter_mask_is_honoured(tmp_path):
    """A chunk whose filter mask skips deflate (an optional filter that
    did not help) is read as stored."""
    path = str(tmp_path / "t.h5")
    data = np.arange(12, dtype="<i4")
    with h5py.File(path, "w", libver="latest") as f:
        d = f.create_dataset("x", shape=(12,), dtype="<i4", chunks=(4,),
                             compression="gzip")
        d.id.write_direct_chunk((0,), data[:4].tobytes(), filter_mask=1)
        d[4:] = data[4:]
    _check_all(path, ["x"])


def _write(path, libver="earliest", **kw):
    with h5py.File(path, "w", libver=libver) as f:
        f.create_dataset("x", **kw)


@pytest.mark.parametrize("case, match", [
    ("lzf", "filter id 32000"),
    ("scaleoffset", "filter id 6"),
    ("soft_link", "soft or external link"),
    ("vlen_sequence", "variable-length sequence"),
    ("huge_heap_object", "huge fractal heap object"),
])
def test_unsupported_features_name_themselves(tmp_path, case, match):
    """What h5py writes that the reader refuses, among them a
    variable-length sequence of numbers (h5py.vlen_dtype) and a link whose
    message outgrows the link heap's largest managed object (a
    5,000-character name in a dense group), stored as a huge object."""
    path = str(tmp_path / "t.h5")
    name = "x"
    if case == "vlen_sequence":
        _write(path, data=np.array([np.arange(3), np.arange(2)], object),
               dtype=h5py.vlen_dtype("<i4"))
    elif case == "huge_heap_object":
        name = "h" * 5000
        with h5py.File(path, "w", libver="latest") as f:
            for i in range(9):
                f.create_dataset(f"d{i}", data=np.arange(3))
            f.create_dataset(name, data=np.arange(3))
        _check_all(path, ["d0", "d8"])          # the other links read
    elif case == "lzf":
        _write(path, data=np.arange(50), chunks=(10,), compression="lzf")
    elif case == "scaleoffset":
        _write(path, data=np.arange(50), chunks=(10,), scaleoffset=0)
    elif case == "soft_link":
        with h5py.File(path, "w") as f:
            f.create_dataset("y", data=np.arange(3))
            f["x"] = h5py.SoftLink("/y")
    with pytest.raises(NotImplementedError, match=match) as err:
        hdf5.read_dataset(path, name)
    assert path in str(err.value)


def test_errors_for_what_is_not_there(tmp_path):
    path = str(tmp_path / "t.h5")
    with h5py.File(path, "w") as f:
        f.create_group("g")
        f.create_dataset("x", data=np.arange(3))
    with pytest.raises(KeyError, match="'nope'"):
        hdf5.read_dataset(path, "nope")
    with pytest.raises(ValueError, match="not a dataset"):
        hdf5.read_dataset(path, "g")
    other = str(tmp_path / "text.h5")
    for content in (b"", b"not hdf5" * 200):
        with open(other, "wb") as f:
            f.write(content)
        with pytest.raises(ValueError, match="not an HDF5 file"):
            hdf5.read_dataset(other, "x")


@pytest.mark.parametrize("what", ["object header", "superblock",
                                  "fletcher32"])
def test_corruption_is_detected(tmp_path, what):
    path = str(tmp_path / "t.h5")
    data = np.arange(40, dtype="<i8")
    _write(path, "latest", data=data, chunks=(8,), fletcher32=True)
    with open(path, "rb") as f:
        raw = bytearray(f.read())
    if what == "fletcher32":
        at = raw.rindex(data[20:21].tobytes())
    elif what == "superblock":
        at = 20                         # the extension's address
    else:
        at = raw.index(b"OHDR", raw.index(b"OHDR") + 4) + 12
    raw[at] ^= 0x40
    with open(path, "wb") as f:
        f.write(raw)
    with pytest.raises(ValueError, match="checksum"):
        hdf5.read_dataset(path, "x")


def test_checksums_match_hdf5():
    """lookup3's published test vectors (hashlittle, initval 0 and
    0xdeadbeef) and Fletcher-32's folding of an all-0xff block."""
    assert hdf5.lookup3(b"") == 0xDEADBEEF
    assert hdf5.lookup3(b"", 0xDEADBEEF) == 0xBD5B7DDE
    assert hdf5.lookup3(b"Four score and seven years ago") == 0x17770551
    assert hdf5.lookup3(b"Four score and seven years ago", 1) == 0xCD628161
    assert hdf5.fletcher32(b"") == 0
    assert hdf5.fletcher32(b"\0" * 10) == 0
    assert hdf5.fletcher32(b"\xff\xff") == 0xFFFFFFFF
    assert hdf5.fletcher32(b"\x01") == (0x0100 << 16) | 0x0100


# -- the writer ------------------------------------------------------------

def _tables(rng) -> dict:
    return {"radar_data": _values(RADAR_DTYPE, 57, rng),
            "odometry": _values(ODO_DTYPE, 9, rng),
            "nested": _values(NESTED, 4, rng), "hole": _values(HOLE, 5, rng),
            "be_f8": _values(np.dtype(">f8"), 6, rng),
            "u1": _values(np.dtype("u1"), 3, rng),
            "f2": _values(np.dtype("<f2"), 3, rng),
            "s5": _values(np.dtype("S5"), 8, rng),
            "empty": np.zeros(0, RADAR_DTYPE)}


def test_writer_round_trips(tmp_path):
    """Port -> h5py and port -> port, dtype and values; the same arrays
    give the same bytes."""
    tables = _tables(np.random.default_rng(4))
    paths = [str(tmp_path / f"{i}.h5") for i in range(2)]
    for path in paths:
        hdf5.write_datasets(path, tables)
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    with h5py.File(paths[0], "r") as f:
        assert sorted(f) == sorted(tables)
        for name, want in tables.items():
            assert f[name].chunks is None and f[name].compression is None
            _assert_same(f[name][()], want, f"h5py {name}")
    for name, want in tables.items():
        _assert_same(hdf5.read_dataset(paths[0], name), want, f"port {name}")


def test_writer_many_datasets(tmp_path):
    """More names than one default-sized symbol node holds."""
    path = str(tmp_path / "t.h5")
    tables = {f"t{i}": np.arange(i, dtype="<i8") for i in range(20)}
    hdf5.write_datasets(path, tables)
    _check_all(path, tables)
    for name, want in tables.items():
        np.testing.assert_array_equal(hdf5.read_dataset(path, name), want)


@pytest.mark.parametrize("arrays", [
    {}, {"x": np.zeros((2, 2))}, {"": np.zeros(2)}, {"a/b": np.zeros(2)},
    {"x": np.zeros(2, bool)}, {"x": np.zeros(2, "U3")},
    {"x": np.zeros(2, [("v", "<f4", (2,))])}], ids=lambda a: str(a)[:20])
def test_writer_refuses_what_it_does_not_write(tmp_path, arrays):
    with pytest.raises(ValueError):
        hdf5.write_datasets(str(tmp_path / "t.h5"), arrays)
