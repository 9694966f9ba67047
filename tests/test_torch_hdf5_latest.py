"""The port's HDF5 reader (radargnn_tpu_torch.data.hdf5) against h5py on
what h5py writes under libver "latest" beyond the default layout: the
extensible-array chunk index (one unlimited dimension; its super blocks and
paged data blocks), the version 2 B-tree chunk index (more than one), dense
link storage (a fractal heap indexed by v2 B-trees; more than 8 links in a
group), variable-length strings and array datatypes. Every dataset must
read with h5py's dtype (names, formats, offsets, itemsize, the string
metadata) and values, object fields element for element; each new
structure with a flipped byte raises ValueError."""

import mmap
import os
import tempfile

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

h5py = pytest.importorskip("h5py")

from radargnn_tpu_torch.data import hdf5  # noqa: E402

# the extensible array h5py writes: 4 elements in its index block, data
# blocks of 16 elements and more, pages of 1,024 elements; the first paged
# data block holds elements from 131,060 on (super block 13)
FIRST_PAGED = 131_060
FILTERS = {"none": {}, "gzip": dict(compression="gzip"),
           "gzip_shuffle_fletcher32": dict(compression="gzip", shuffle=True,
                                           fletcher32=True),
           "fletcher32": dict(fletcher32=True)}
LONG = "n" * 250


def assert_same(got: np.ndarray, want: np.ndarray, msg: str = "") -> None:
    """h5py's dtype (a variable-length string's metadata too) and values,
    object fields element for element."""
    assert got.dtype == want.dtype, (msg, got.dtype, want.dtype)
    assert got.dtype.itemsize == want.dtype.itemsize, msg
    if want.dtype.kind == "O":
        assert got.dtype.metadata == want.dtype.metadata, msg
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    if want.dtype.names is not None:
        assert [got.dtype.fields[n][1] for n in got.dtype.names] == \
            [want.dtype.fields[n][1] for n in want.dtype.names], msg
        for name in want.dtype.names:
            assert_same(got[name], want[name], f"{msg}.{name}")
    elif want.dtype.kind == "O":
        assert got.ravel().tolist() == want.ravel().tolist(), msg
        assert all(type(v) is bytes for v in got.ravel()), msg
    else:
        np.testing.assert_array_equal(got, want, err_msg=msg)


def check_all(path: str, names) -> None:
    with h5py.File(path, "r") as f:
        wants = {name: f[name][()] for name in names}
    for name, want in wants.items():
        assert_same(hdf5.read_dataset(path, name), want, name)


def _btree2_depth(raw: bytes, at: int) -> int:
    return int.from_bytes(raw[at + 12:at + 14], "little")


# -- the extensible array chunk index ----------------------------------------

@pytest.mark.parametrize("filters", sorted(FILTERS))
def test_extensible_array_matches_h5py(tmp_path, filters):
    """Thousands of one-row chunks of a small dtype (several super blocks),
    elements written past FIRST_PAGED (paged data blocks, of which only the
    written pages are there; the rest reads as the fill value), and 2-D and
    3-D tables with the unlimited dimension first and not first."""
    path = str(tmp_path / "t.h5")
    kw = FILTERS[filters]
    rng = np.random.default_rng(11)
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("rows", data=rng.integers(0, 255, 3000, "u1"),
                         chunks=(1,), maxshape=(None,), **kw)
        d = f.create_dataset("sparse", shape=(FIRST_PAGED + 9000,),
                             dtype="<i2", chunks=(1,), maxshape=(None,),
                             fillvalue=-3, **kw)
        d[:700] = rng.integers(-999, 999, 700)
        d[FIRST_PAGED + 1500] = 7               # the second page of a block
        d[FIRST_PAGED + 8190] = 9               # another data block
        f.create_dataset("first", data=rng.normal(size=(90, 3)),
                         chunks=(2, 2), maxshape=(None, 3), **kw)
        f.create_dataset("last", data=rng.normal(size=(4, 75)).astype("<f4"),
                         chunks=(1, 2), maxshape=(4, None), **kw)
        f.create_dataset("middle", data=np.arange(3 * 40 * 5).reshape(
            3, 40, 5).astype(">i4"), chunks=(2, 3, 2), maxshape=(3, None, 5),
            **kw)
    with open(path, "rb") as f:
        raw = f.read()
    header = raw.index(b"EAHD")
    assert raw[header + 6:header + 12] == bytes([8 + 6 * bool(kw), 32, 4,
                                                 16, 4, 10])
    assert raw.count(b"EASB") >= 5 and raw.count(b"EADB") >= 20
    check_all(path, ["rows", "sparse", "first", "last", "middle"])
    sparse = hdf5.read_dataset(path, "sparse")
    assert sparse[FIRST_PAGED + 1500] == 7 and sparse[FIRST_PAGED + 8190] == 9
    assert (sparse[700:FIRST_PAGED + 1500] == -3).all()


def test_extensible_array_after_resize(tmp_path):
    """A table appended to (resize, then write) and one shrunk: chunks
    past the shape are left out."""
    path = str(tmp_path / "t.h5")
    with h5py.File(path, "w", libver="latest") as f:
        d = f.create_dataset("grown", shape=(0,), dtype="<u8", chunks=(5,),
                             maxshape=(None,), compression="gzip")
        for i in range(40):
            d.resize((len(d) + 7,))
            d[-7:] = np.arange(7) + 100 * i
        s = f.create_dataset("shrunk", data=np.arange(500.0), chunks=(3,),
                             maxshape=(None,))
        s.resize((101,))
    check_all(path, ["grown", "shrunk"])


# -- the version 2 B-tree chunk index ---------------------------------------

@pytest.mark.parametrize("filtered", [False, True])
def test_v2_btree_chunk_index_of_depth_two(tmp_path, filtered):
    """One chunk a cell of an 80 x 80 table with two unlimited dimensions:
    thousands of records, a B-tree of depth 2 (internal nodes carry their
    children's record counts and, above level 1, their totals); and a 3-D
    table with a fixed dimension between two unlimited ones."""
    path = str(tmp_path / "t.h5")
    kw = dict(compression="gzip", shuffle=True, fletcher32=True) \
        if filtered else {}
    rng = np.random.default_rng(12)
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("grid", data=rng.integers(0, 9, (80, 80), "u1"),
                         chunks=(1, 1), maxshape=(None, None), **kw)
        f.create_dataset("cube", data=rng.normal(size=(7, 4, 9)),
                         chunks=(2, 3, 2), maxshape=(None, 4, None), **kw)
        d = f.create_dataset("holes", shape=(30, 30), dtype="<i4",
                             chunks=(4, 4), maxshape=(None, None),
                             fillvalue=5, **kw)
        d[3:9, 20:29] = 1
    with open(path, "rb") as f:
        raw = f.read()
    assert _btree2_depth(raw, raw.index(b"BTHD")) >= 2
    check_all(path, ["grid", "cube", "holes"])


# -- dense link storage ----------------------------------------------------

def _file_links(path: str, group: str) -> dict:
    """Every link of `group` as the port lists it (name -> target)."""
    with open(path, "rb") as f, mmap.mmap(
            f.fileno(), 0, access=mmap.ACCESS_READ) as mm:
        file = hdf5._File(path, f, mm)
        return file.links(file.messages(file.find(group)))


@pytest.mark.parametrize("links, prefix, track_order", [
    (9, "d", False), (300, "d", True), (300, "d", False),
    (3000, LONG, True)], ids=["9", "300_tracked", "300", "3000_long_names"])
def test_dense_links_match_h5py(tmp_path, links, prefix, track_order):
    """A group of `links` links in a fractal heap (3,000 250-character
    names fill its direct blocks and reach nested indirect blocks), with
    and without creation order tracked and indexed: the port lists h5py's
    names, and reads datasets by path through dense groups."""
    path = str(tmp_path / "t.h5")
    with h5py.File(path, "w", libver="latest") as f:
        g = f.create_group("g", track_order=track_order)
        shared = g.create_dataset("shared", data=np.arange(4.0))
        for i in range(links):
            if i % 50 == 0:
                g.create_dataset(f"{prefix}{i:05d}", data=np.arange(i, i + 3))
            else:
                g[f"{prefix}{i:05d}"] = shared
        inner = g.create_group("sub", track_order=track_order)
        for i in range(12):
            inner.create_dataset(f"é{i}", data=np.full(2, i, "<i2"))
        g["soft"] = h5py.SoftLink("/g/shared")
    with open(path, "rb") as f:
        raw = f.read()
    if links == 3000:
        assert raw.count(b"FHIB") >= 3
    with h5py.File(path, "r") as f:
        assert sorted(_file_links(path, "g")) == sorted(f["g"])
        assert sorted(_file_links(path, "/g/sub")) == sorted(f["g/sub"])
    assert _file_links(path, "g")["soft"] is None
    names = [f"g/{prefix}{i:05d}" for i in range(0, links, 50)]
    check_all(path, names + [f"g/{prefix}{links - 1:05d}", "g/sub/é11",
                             "/g/sub/é0"])
    with pytest.raises(KeyError):
        hdf5.read_dataset(path, "g/nope")


def test_dense_groups_nested_and_compact_inside(tmp_path):
    """Dense groups inside dense groups, a compact group inside a dense
    one, and a dataset under each."""
    path = str(tmp_path / "t.h5")
    with h5py.File(path, "w", libver="latest") as f:
        g = f
        for level in range(3):
            for i in range(10):
                g.create_dataset(f"x{i}", data=np.arange(level + i))
            g = g.create_group(f"level{level}")
        g.create_dataset("leaf", data=np.arange(6).reshape(2, 3))
    check_all(path, ["x9", "level0/x3", "level0/level1/x0",
                     "level0/level1/level2/leaf"])


# -- variable-length strings and array datatypes ----------------------------

VLEN_COMPOUND = np.dtype([
    ("x", "<i4"), ("s", h5py.string_dtype("ascii")), ("v", "<f4", (2,)),
    ("u", h5py.string_dtype()), ("t", "<f8")])


def _vlen_rows(n: int, rng) -> np.ndarray:
    rows = np.zeros(n, VLEN_COMPOUND)
    rows["x"] = np.arange(n)
    rows["s"] = [bytes(rng.integers(33, 127, rng.integers(0, 40)).astype(
        "u1")) for _ in range(n)]
    rows["v"] = rng.normal(size=(n, 2))
    rows["u"] = [("é" * int(k)) for k in rng.integers(0, 5, n)]
    rows["t"] = rng.normal(size=n)
    return rows


@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_variable_length_strings(tmp_path, libver):
    """ASCII and UTF-8 strings (h5py.string_dtype) at the top and in a
    compound, contiguous and chunked, empty ones, strings never written
    (b""), a string fill value, strings longer than a global heap
    collection, and a compound nested in a compound."""
    path = str(tmp_path / "t.h5")
    rng = np.random.default_rng(13)
    with h5py.File(path, "w", libver=libver) as f:
        f.create_dataset("ascii", data=np.array(
            [b"", b"a", b"xyz" * 20] * 400, object),
            dtype=h5py.string_dtype("ascii"))
        f.create_dataset("utf8", data=np.array(["é", "", "ab"], object),
                         dtype=h5py.string_dtype())
        f.create_dataset("long", data=np.array([b"q" * 70000, b"r"],
                                               object),
                         dtype=h5py.string_dtype("ascii"))
        f.create_dataset("rows", data=_vlen_rows(50, rng))
        f.create_dataset("rows_chunked", data=_vlen_rows(50, rng),
                         chunks=(7,), maxshape=(None,), compression="gzip")
        d = f.create_dataset("partial", shape=(6,), chunks=(2,),
                             dtype=h5py.string_dtype("ascii"))
        d[3] = b"only"
        f.create_dataset("filled", shape=(3,), fillvalue=b"fill",
                         dtype=h5py.string_dtype("ascii"))
        nested = np.dtype([("k", "u1"), ("in", [("s", h5py.string_dtype(
            "ascii")), ("m", "<i2", (3,))]), ("z", "<f8")])
        rows = np.zeros(4, nested)
        rows["in"]["s"] = [b"a", b"", b"ccc", b"dddd"]
        rows["in"]["m"] = np.arange(12).reshape(4, 3)
        rows["z"] = np.arange(4)
        f.create_dataset("nested", data=rows)
    check_all(path, ["ascii", "utf8", "long", "rows", "rows_chunked",
                     "partial", "filled", "nested"])
    assert hdf5.read_dataset(path, "partial").tolist() == [
        b"", b"", b"", b"only", b"", b""]


@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_array_datatypes(tmp_path, libver):
    """Array members of a compound (1-D and 2-D, of a float, a fixed
    string and a compound), an array of variable-length strings, and an
    array datatype at the top (h5py gives its dimensions after the
    dataset's)."""
    path = str(tmp_path / "t.h5")
    rng = np.random.default_rng(14)
    dt = np.dtype([("v", "<f4", (2,)), ("m", ">i2", (2, 3)),
                   ("tags", "S4", (3,)), ("pts", [("x", "<f8"), ("y", "u1")],
                                          (2,))])
    rows = np.zeros(9, dt)
    rows["v"] = rng.normal(size=(9, 2))
    rows["m"] = rng.integers(-99, 99, (9, 2, 3))
    rows["tags"] = [[b"ab", b"", b"wxyz"]] * 9
    rows["pts"]["x"] = rng.normal(size=(9, 2))
    rows["pts"]["y"] = rng.integers(0, 255, (9, 2))
    names = np.zeros(3, [("id", "<i8"), ("names", h5py.string_dtype(
        "ascii"), (2,))])
    names["names"] = [[b"a", b"bc"], [b"", b"d"], [b"eee", b""]]
    with h5py.File(path, "w", libver=libver) as f:
        f.create_dataset("rows", data=rows)
        f.create_dataset("rows_chunked", data=rows, chunks=(4,),
                         compression="gzip")
        f.create_dataset("names", data=names)
        top = h5py.h5t.array_create(h5py.h5t.IEEE_F32LE, (2, 3))
        h5py.h5d.create(f.id, b"top", top, h5py.h5s.create_simple((4,))).write(
            h5py.h5s.ALL, h5py.h5s.ALL,
            np.arange(24, dtype="<f4").reshape(4, 2, 3), mtype=top)
    check_all(path, ["rows", "rows_chunked", "names", "top"])
    assert hdf5.read_dataset(path, "top").shape == (4, 2, 3)


def test_version_1_compound_member_with_dimensions(tmp_path):
    """A version 1 compound member with dimensions (HDF5 1.2's arrays in
    compounds) reads as the subarray HDF5 makes of it: the port's writer's
    file of one (a, b) float64 compound, its member `b` made a (2,) array of
    float32 by hand."""
    path = str(tmp_path / "t.h5")
    want = np.zeros(5, [("a", "<f8"), ("b", "<f4", (2,))])
    want["a"] = np.arange(5)
    want["b"] = np.arange(10).reshape(5, 2) / 4
    stand_in = np.zeros(5, [("a", "<f8"), ("b", "<f8")])
    stand_in["a"] = want["a"]
    stand_in["b"] = want["b"].view("<f8")[:, 0]
    hdf5.write_datasets(path, {"x": stand_in})
    with open(path, "rb") as f:
        raw = bytearray(f.read())
    member = raw.index(b"b\0")
    raw[member + 12] = 1                        # one dimension
    raw[member + 24:member + 28] = (2).to_bytes(4, "little")
    f8 = hdf5._type_message(np.dtype("<f8"))
    at = raw.index(f8, member)
    raw[at:at + len(f8)] = hdf5._type_message(np.dtype("<f4"))
    with open(path, "wb") as f:
        f.write(raw)
    with h5py.File(path, "r") as f:
        assert_same(f["x"][()], want, "h5py")
    assert_same(hdf5.read_dataset(path, "x"), want, "port")


# -- drawn sizes -----------------------------------------------------------

@settings(max_examples=12, deadline=None)
@given(chunks=st.integers(1, 700), links=st.integers(0, 80),
       unlimited_first=st.booleans(), gzip=st.booleans(),
       strings=st.booleans())
def test_drawn_chunk_and_link_counts(chunks, links, unlimited_first, gzip,
                                     strings):
    """An extensible array of `chunks` chunks (2-D, the unlimited dimension
    first or last), a v2 B-tree index of about as many, and a group of
    `links` links (compact up to 8, dense above)."""
    rng = np.random.default_rng(chunks * 97 + links)
    kw = dict(compression="gzip") if gzip else {}
    shape, maxshape = ((chunks, 2), (None, 2)) if unlimited_first else \
        ((2, chunks), (2, None))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "t.h5")
        with h5py.File(path, "w", libver="latest") as f:
            if strings:
                values = np.array([bytes(rng.integers(97, 123, 3).astype(
                    "u1")) for _ in range(2 * chunks)], object).reshape(shape)
                f.create_dataset("ea", data=values, chunks=(1, 1),
                                 maxshape=maxshape, **kw,
                                 dtype=h5py.string_dtype("ascii"))
            else:
                f.create_dataset("ea", data=rng.integers(0, 99, shape, "u1"),
                                 chunks=(1, 1), maxshape=maxshape, **kw)
            f.create_dataset("bt", data=rng.normal(size=shape),
                             chunks=(1, 1), maxshape=(None, None), **kw)
            g = f.create_group("g")
            for i in range(links):
                g.create_dataset(f"l{i}", data=np.arange(i + 1))
        check_all(path, ["ea", "bt"] + [f"g/l{i}" for i in range(
            0, links, 7)])
        with h5py.File(path, "r") as f:
            assert sorted(_file_links(path, "g")) == sorted(f["g"])


# -- errors ----------------------------------------------------------------

def _structures_file(path: str) -> dict:
    """A file holding each new structure, and the dataset whose read meets
    it: (signature -> (dataset, bytes past the signature to flip))."""
    with h5py.File(path, "w", libver="latest") as f:
        d = f.create_dataset("ea", shape=(FIRST_PAGED + 2000,), dtype="<i4",
                             chunks=(1,), maxshape=(None,))
        d[:300] = np.arange(300)
        d[FIRST_PAGED + 5] = 1                  # the first page of a block
        f.create_dataset("bt", data=np.arange(1600).reshape(40, 40),
                         chunks=(1, 1), maxshape=(None, None))
        g = f.create_group("dense", track_order=True)
        for i in range(300):
            g.create_dataset(f"d{i}", data=np.arange(3))
        f.create_dataset("vlen", data=np.array([b"ab", b"c"], object),
                         dtype=h5py.string_dtype("ascii"))
    return {"EAHD": ("ea", 6), "EAIB": ("ea", 15), "EASB": ("ea", 18),
            "EADB": ("ea", 19), "EADB page": ("ea", 22 + 20),
            "BTHD": ("bt", 10), "BTIN": ("bt", 7), "BTLF": ("bt", 7),
            "FRHP": ("dense/d150", 12), "FHIB": ("dense/d150", 25),
            "FHDB": ("dense/d150", 40), "GCOL": ("vlen", 0)}


@pytest.mark.parametrize("what", [
    "EAHD", "EAIB", "EASB", "EADB", "EADB page", "BTHD", "BTIN", "BTLF",
    "FRHP", "FHIB", "FHDB", "GCOL"])
def test_flipped_byte_raises(tmp_path, what):
    """A byte flipped in every block of one kind (in the paged data block's
    first page for "EADB page"), where a checksum covers it (the global
    heap has none: its signature), fails the read with ValueError."""
    path = str(tmp_path / "t.h5")
    name, at = _structures_file(path)[what]
    sig = what.split()[0].encode()
    with open(path, "rb") as f:
        raw = bytearray(f.read())
    check_all(path, [name])
    starts = [i for i in range(len(raw)) if raw.startswith(sig, i)]
    if what == "EADB page":                     # the block holding the page
        starts = [i for i in starts if int.from_bytes(
            raw[i + 14:i + 18], "little") >= FIRST_PAGED - 4]
        assert len(starts) == 1
    for start in starts:
        raw[start + at] ^= 0x10
    with open(path, "wb") as f:
        f.write(raw)
    with pytest.raises(ValueError):
        hdf5.read_dataset(path, name)
