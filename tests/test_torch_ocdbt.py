"""The port's OCDBT store (`radargnn_tpu_torch/train/ocdbt.py`) and zarr v2
layer (`train/orbax_format.py`) against tensorstore: the reader lists and
reads every key tensorstore does on stores tensorstore wrote (orbax's
config, interior B-tree nodes, every value out of line, no compression,
many commits with version-tree nodes, a merged two-process store), and
tensorstore reads back every value of the stores the port writes and
merges; the zarr layer reads tensorstore's arrays (C and F order, zstd and
no compressor, fill values, several chunks, only the chunks a slice
touches) and names what it does not read."""

import json
import os
import random

import google_crc32c
import numpy as np
import pytest
import tensorstore as ts

from radargnn_tpu_torch.train import ocdbt, orbax_format

ORBAX = {"max_inline_value_bytes": 1024, "max_decoded_node_bytes": 100000000,
         "manifest_kind": "single"}
_CONTEXT = {"cache_pool#ocdbt": {"total_bytes_limit": 100000000}}


def _kvstore(path, config=None, context=None):
    spec = {"driver": "ocdbt", "base": {"driver": "file", "path": path},
            "cache_pool": "cache_pool#ocdbt"}
    if config:
        spec.update(config=config)
    return ts.KvStore.open(spec, context=context or ts.Context(_CONTEXT)
                           ).result()


def _items(n=40, seed=0, prefix="params"):
    """n keys with shared prefixes, values from 0 bytes to past 1024."""
    rng = np.random.default_rng(seed)
    return {f"{prefix}.layer_{i // 7}/{'.zarray' if i % 7 == 0 else i}"
            .encode(): rng.integers(0, 256, int(rng.choice(
                [0, 5, 300, 1024, 1025, 3000])), dtype=np.uint8).tobytes()
            for i in range(n)}


def _write(kv, items, commits=1):
    keys = sorted(items)
    for c in range(commits):
        txn = ts.Transaction()
        for k in keys[c::commits]:
            kv.with_transaction(txn).write(k, items[k]).result()
        txn.commit_async().result()


def _assert_reads_as_tensorstore(path):
    kv = _kvstore(path)
    keys = sorted(kv.list().result())
    store = ocdbt.Store(path)
    assert store.list() == keys
    want = [kv.read(k).result().value for k in keys]
    assert [store.read(k) for k in keys] == want
    assert store.read_many(keys) == want
    assert store.read(b"no such key") is None
    return store


def _store_orbax(path):
    _write(_kvstore(path, ORBAX), _items())


def _store_interior(path):
    _write(_kvstore(path, dict(ORBAX, max_decoded_node_bytes=300)),
           _items(120))


def _store_all_out_of_line(path):
    _write(_kvstore(path, dict(ORBAX, max_inline_value_bytes=0)), _items())


def _store_uncompressed(path):
    _write(_kvstore(path, dict(ORBAX, compression=None,
                               max_inline_value_bytes=64)), _items())


def _store_many_commits(path):
    _write(_kvstore(path, dict(ORBAX, version_tree_arity_log2=2)),
           _items(22), commits=22)


def _store_merged(path):
    """orbax's merge: two processes' stores copied into the folder's."""
    context = ts.Context(_CONTEXT)
    for p in range(2):
        _write(_kvstore(os.path.join(path, f"ocdbt.process_{p}"), ORBAX,
                        context), _items(30, seed=p, prefix=f"p{p}"),
               commits=3)
    parent = _kvstore(path, ORBAX, context)
    txn = ts.Transaction(atomic=True)
    for p in range(2):
        _kvstore(os.path.join(path, f"ocdbt.process_{p}"),
                 context=context).experimental_copy_range_to(
            parent.with_transaction(txn)).result()
    txn.commit_async().result()


STORES = {"orbax_config": _store_orbax, "interior_nodes": _store_interior,
          "all_out_of_line": _store_all_out_of_line,
          "uncompressed": _store_uncompressed,
          "many_commits": _store_many_commits, "merged": _store_merged}


@pytest.mark.parametrize("case", sorted(STORES))
def test_reader_reads_what_tensorstore_wrote(tmp_path, case):
    path = str(tmp_path / case)
    STORES[case](path)
    store = _assert_reads_as_tensorstore(path)
    if case == "interior_nodes":
        assert store.height >= 2
    if case == "many_commits":
        # 22 commits after the empty first version, the older ones in
        # version-tree nodes
        assert [v[0] for v in store.versions()] == list(range(1, 24))
        assert [v[1] for v in store.versions()] == list(range(23))
        assert store._nodes
    if case == "merged":
        refs = [v for v in store.entries().values()
                if isinstance(v, ocdbt.Ref)]
        assert {r.base for r in refs} == {"ocdbt.process_0/",
                                          "ocdbt.process_1/"}
    if case == "uncompressed":
        assert store.config.compression is None


def test_tensorstore_reads_the_ports_stores(tmp_path):
    """A store the port writes (orbax's config, uuid and file names from
    a seeded source), and the store merging two of them: tensorstore lists
    and reads every value, and opens them under orbax's config."""
    rng = random.Random(0)
    for p in range(2):
        config = ocdbt.write_store(str(tmp_path / f"ocdbt.process_{p}"),
                                   _items(50, seed=p, prefix=f"p{p}"),
                                   rng.randbytes)
        assert config == ocdbt.Config(uuid=config.uuid)
    ocdbt.merge_stores(str(tmp_path), ["ocdbt.process_0",
                                       "ocdbt.process_1"], rng.randbytes)
    for sub in ("ocdbt.process_0", "ocdbt.process_1", ""):
        path = str(tmp_path / sub)
        assert len(_assert_reads_as_tensorstore(path).list()) >= 40
        assert _kvstore(path, ORBAX).list().result()
    merged = {**_items(50, seed=0, prefix="p0"),
              **_items(50, seed=1, prefix="p1")}
    kv = _kvstore(str(tmp_path))
    assert {k: kv.read(k).result().value for k in kv.list().result()} \
        == merged
    # the merged store's out-of-line values stay in the processes' files:
    # its own data file holds its node alone
    refs = [v for v in ocdbt.Store(str(tmp_path)).entries().values()
            if isinstance(v, ocdbt.Ref)]
    assert {r.base for r in refs} == {"ocdbt.process_0/",
                                      "ocdbt.process_1/"}
    (node,) = os.listdir(tmp_path / "d")
    assert os.path.getsize(tmp_path / "d" / node) < sum(
        len(v) for v in merged.values() if len(v) > 1024)


def test_an_empty_store(tmp_path):
    ocdbt.write_store(str(tmp_path), {}, random.Random(1).randbytes)
    assert _kvstore(str(tmp_path)).list().result() == []
    assert ocdbt.Store(str(tmp_path)).list() == []


def test_crc32c_is_castagnolis():
    rng = np.random.default_rng(2)
    for n in (0, 1, 7, 64, 1000):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert ocdbt.crc32c(data) == google_crc32c.value(data)


def test_corrupt_files_raise(tmp_path):
    path = str(tmp_path)
    ocdbt.write_store(path, _items(), random.Random(3).randbytes)
    manifest = os.path.join(path, ocdbt.MANIFEST)
    with open(manifest, "rb") as f:
        good = f.read()
    for bad, match in ((good[:-1], "bytes where its header says"),
                       (good[:30] + bytes([good[30] ^ 4]) + good[31:],
                        "crc32c"),
                       (b"\x0c\xdb\x20\xde" + good[4:], "magic")):
        with open(manifest, "wb") as f:
            f.write(bad)
        with pytest.raises(ValueError, match=match):
            ocdbt.Store(path)
    with open(manifest, "wb") as f:
        f.write(good)
    (name,) = os.listdir(os.path.join(path, "d"))
    data_file = os.path.join(path, "d", name)
    with open(data_file, "rb") as f:
        data = f.read()
    with open(data_file, "wb") as f:
        f.write(data[:-20] + bytes([data[-20] ^ 1]) + data[-19:])
    with pytest.raises(ValueError, match="crc32c"):
        ocdbt.Store(path)


def test_a_numbered_manifest_is_named(tmp_path):
    _write(_kvstore(str(tmp_path), dict(ORBAX, manifest_kind="numbered")),
           _items(5))
    with pytest.raises(NotImplementedError, match="numbered"):
        ocdbt.Store(str(tmp_path))


# -- the zarr v2 layer ----------------------------------------------------

def _zarr_checkpoint(folder, arrays):
    """tensorstore's zarr arrays {name: (array, metadata)} in the OCDBT
    store of `folder`, with orbax's `_METADATA` naming them."""
    tree = {}
    for name, (arr, meta) in arrays.items():
        spec = {"driver": "zarr",
                "kvstore": {"driver": "ocdbt", "base": {
                    "driver": "file", "path": folder}, "path": name},
                "metadata": dict({"shape": list(arr.shape),
                                  "dtype": arr.dtype.str}, **meta)}
        out = ts.open(spec, create=True, open=True).result()
        if meta.get("fill_value") is not None:
            out[tuple(slice(0, c) for c in meta["chunks"])].write(
                arr[tuple(slice(0, c) for c in meta["chunks"])]).result()
        else:
            out.write(arr).result()
        path = name.split(".")
        tree[str(tuple(path))] = {
            "key_metadata": [{"key": k, "key_type": 2} for k in path],
            "value_metadata": {"value_type": "jax.Array",
                               "skip_deserialize": False}}
    with open(os.path.join(folder, "_METADATA"), "w") as f:
        json.dump({"tree_metadata": tree, "use_zarr3": False}, f)


def test_zarr_arrays_tensorstore_wrote(tmp_path, monkeypatch):
    rng = np.random.default_rng(4)
    w = rng.standard_normal((10, 12)).astype(np.float32)
    c = np.arange(60, dtype=np.int32).reshape(6, 10)
    f = rng.standard_normal((7, 5)).astype(np.float32)
    folder = str(tmp_path)
    _zarr_checkpoint(folder, {
        "p.w": (w, {"chunks": [4, 5],
                    "compressor": {"id": "zstd", "level": 1}}),
        "p.c": (c, {"chunks": [6, 10], "compressor": None}),
        "p.f": (f, {"chunks": [3, 5], "order": "F",
                    "compressor": {"id": "zstd", "level": 3}}),
        # only the first chunk written: the others hold the fill value
        "p.g": (w, {"chunks": [5, 12], "fill_value": 3.5,
                    "compressor": {"id": "zstd", "level": 1}})})
    tree = orbax_format.load_pytree(folder)
    np.testing.assert_array_equal(tree["p"]["w"], w)
    np.testing.assert_array_equal(tree["p"]["c"], c)
    np.testing.assert_array_equal(tree["p"]["f"], f)
    assert tree["p"]["c"].dtype == np.int32
    g = np.full_like(w, 3.5)
    g[:5] = w[:5]
    np.testing.assert_array_equal(tree["p"]["g"], g)

    read = []
    real = ocdbt.Store.read_many

    def spy(self, keys):
        keys = list(keys)
        read.extend(keys)
        return real(self, keys)

    monkeypatch.setattr(ocdbt.Store, "read_many", spy)
    tree = orbax_format.load_pytree(
        folder, lambda path, shape: (slice(5, 8), slice(3, 9))
        if path == ("p", "w") else (slice(None), slice(0, 4))
        if path == ("p", "c") else None)
    np.testing.assert_array_equal(tree["p"]["w"], w[5:8, 3:9])
    np.testing.assert_array_equal(tree["p"]["c"], c[:, :4])
    # w's slice touches chunks (1, 0) and (1, 1) of its 3 x 3 grid
    assert sorted(k for k in read if k.startswith(b"p.w/")) == [
        b"p.w/1.0", b"p.w/1.1"]


@pytest.mark.parametrize("dtype,compressor,match", [
    ("<f8", {"id": "zstd", "level": 1}, "'<f8'"),
    ("<f4", {"id": "zlib", "level": 1}, "zlib"),
    ("|u1", None, "'|u1'")])
def test_zarr_arrays_not_read_are_named(tmp_path, dtype, compressor, match):
    folder = str(tmp_path)
    _zarr_checkpoint(folder, {"p.x": (np.ones(4, dtype), {
        "chunks": [4], "compressor": compressor})})
    with pytest.raises(ValueError, match=match):
        orbax_format.load_pytree(folder)


def test_the_writer_refuses_other_dtypes(tmp_path):
    with pytest.raises(ValueError, match="float64"):
        orbax_format.save_pytree(str(tmp_path / "ck"),
                                 {"p": {"x": np.ones(3)}})
