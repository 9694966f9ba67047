"""tensorstore's OCDBT key-value store in numpy and the standard library.

orbax keeps a checkpoint's arrays in OCDBT stores (an append-only B-tree
of keys and values on plain files). A store in a folder is

  manifest.ocdbt  magic 0x0cdb3a2a, the store's config (uuid, manifest
                  kind, inline-value and node-size limits, version-tree
                  arity, node compression), its data-file table, the
                  newest versions inline (generation, root reference and
                  statistics, commit time) and references to version-tree
                  nodes holding older ones
  d/<name>        data files: values stored out of line, B-tree nodes
                  (magic 0x0cdb20de) and version-tree nodes (0x0cdb1234)

Every manifest and node is: its magic (big-endian u32), its length
(little-endian u64), a format version (0), a compression byte (0 none, 1
zstd over the rest, `train.zstd`), its fields as varints in
structure-of-arrays order, and a crc32c footer of all that precedes it.
A node's keys are prefix-compressed against the key before them and are
relative to the common prefix its parent names; a value is inline or a
(data file, offset, length) reference, and a data file is named by a
base path and a path relative to it, both relative to the store's folder
(so a merged store refers into `ocdbt.process_<i>/d/`).

`Store` reads a store (`list`, `read`, the values' references for a
merge). `write_store` writes one commit of (key, value) pairs as a single
root leaf and a "single" manifest, out-of-line values in one data file;
`merge_stores` writes a store whose entries refer to other stores' data
files, as tensorstore's `experimental_copy_range_to` does for orbax's
per-process stores. Data-file names and uuids come from the `random_bytes`
source the caller passes. A file that breaks the format raises ValueError;
a feature this module does not read (numbered manifests) raises
NotImplementedError naming it.
"""

from __future__ import annotations

import dataclasses
import os
import struct
import time
from typing import Callable, Dict, Iterable, List, Optional, Sequence, \
    Tuple, Union

import numpy as np

from radargnn_tpu_torch.train import zstd

MANIFEST = "manifest.ocdbt"
MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_MAGIC = 0x0CDB20DE
VERSION_TREE_MAGIC = 0x0CDB1234
_NONE = (1 << 64) - 1            # the empty tree's root offset and length
_SINGLE, _NUMBERED = 0, 1
_INLINE, _INDIRECT = 0, 1


def _crc32c_table() -> np.ndarray:
    crc = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        crc = np.where(crc & 1, (crc >> 1) ^ np.uint32(0x82F63B78),
                       crc >> 1)
    return crc


_CRC_TABLE = _crc32c_table().tolist()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), table-driven a byte at a time."""
    table = _CRC_TABLE
    crc = 0xFFFFFFFF
    for byte in data:
        crc = table[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class Config:
    """A store's config as its manifest records it. `compression` is the
    zstd level nodes are compressed at, or None for none."""

    uuid: bytes
    manifest_kind: int = _SINGLE
    max_inline_value_bytes: int = 1024
    max_decoded_node_bytes: int = 100_000_000
    version_tree_arity_log2: int = 4
    compression: Optional[int] = 0


@dataclasses.dataclass(frozen=True)
class Ref:
    """A value stored out of line: `length` bytes at `offset` of the data
    file `base + path` (relative to the store's folder)."""

    base: str
    path: str
    offset: int
    length: int


Value = Union[bytes, Ref]


# -- decoding -------------------------------------------------------------

class _Reader:
    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def fail(self, why: str) -> ValueError:
        return ValueError(f"{self.what}: {why}")

    def varint(self) -> int:
        value = shift = 0
        data = self.data
        while True:
            if self.pos >= len(data) or shift > 63:
                raise self.fail("a truncated or overlong varint")
            byte = data[self.pos]
            self.pos += 1
            value |= (byte & 0x7F) << shift
            if byte < 0x80:
                return value
            shift += 7

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def bytes(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise self.fail("truncated")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.bytes(1)[0]

    def end(self) -> None:
        if self.pos != len(self.data):
            raise self.fail(f"{len(self.data) - self.pos} bytes after its "
                            "fields")


def _unwrap(raw: bytes, magic: int, what: str) -> _Reader:
    """The fields of a manifest or node: magic, length, crc32c and format
    version checked, the zstd frame decompressed."""
    if len(raw) < 18:
        raise ValueError(f"{what}: truncated ({len(raw)} bytes)")
    got, length = struct.unpack_from(">I", raw)[0], \
        struct.unpack_from("<Q", raw, 4)[0]
    if got != magic:
        raise ValueError(f"{what}: magic {got:#010x}, not {magic:#010x}")
    if length != len(raw):
        raise ValueError(f"{what}: {len(raw)} bytes where its header says "
                         f"{length}")
    if crc32c(raw[:-4]) != struct.unpack_from("<I", raw, len(raw) - 4)[0]:
        raise ValueError(f"{what}: crc32c mismatch")
    head = _Reader(raw[:-4], what)
    head.pos = 12
    version = head.varint()
    if version != 0:
        raise ValueError(f"{what}: format version {version}")
    compression = head.varint()
    body = raw[head.pos:-4]
    if compression == 1:
        body = zstd.decompress(body)
    elif compression != 0:
        raise ValueError(f"{what}: compression format {compression}")
    return _Reader(body, what)


def _file_table(r: _Reader) -> List[Tuple[str, str]]:
    """A data-file table: (base path, path relative to it) a file."""
    n = r.varint()
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    base = r.varints(n)
    out: List[Tuple[str, str]] = []
    full = b""
    for i in range(n):
        if prefix[i] > len(full):
            raise r.fail("a data-file path prefix past the path before it")
        full = full[:prefix[i]] + r.bytes(suffix[i])
        if base[i] > len(full):
            raise r.fail("a data-file base path past its path")
        out.append((full[:base[i]].decode(), full[base[i]:].decode()))
    return out


def _config(r: _Reader) -> Config:
    uuid = r.bytes(16)
    kind = r.varint()
    inline = r.varint()
    node_bytes = r.varint()
    arity = r.u8()
    method = r.varint()
    if method == 0:
        level = None
    elif method == 1:
        level = struct.unpack("<i", r.bytes(4))[0]
    else:
        raise r.fail(f"compression method {method}")
    return Config(uuid, kind, inline, node_bytes, arity, level)


@dataclasses.dataclass(frozen=True)
class _Version:
    generation: int
    height: int
    root: Optional[Ref]
    num_keys: int
    commit_time_ns: int


def _versions(r: _Reader, files: List[Tuple[str, str]]) -> List[_Version]:
    n = r.varint()
    generation = r.varints(n)
    height = [r.u8() for _ in range(n)]
    file_id = r.varints(n)
    offset = r.varints(n)
    length = r.varints(n)
    num_keys = r.varints(n)
    r.varints(2 * n)             # tree bytes, out-of-line value bytes
    times = struct.unpack(f"<{n}Q", r.bytes(8 * n))
    out = []
    for i in range(n):
        root = None
        if offset[i] != _NONE:
            if file_id[i] >= len(files):
                raise r.fail(f"data file {file_id[i]} of {len(files)}")
            root = Ref(*files[file_id[i]], offset[i], length[i])
        out.append(_Version(generation[i], height[i], root, num_keys[i],
                            times[i]))
    return out


def _version_nodes(r: _Reader, files) -> List[Tuple[int, Ref, int]]:
    """Version-tree node references: (last generation, where, height)."""
    n = r.varint()
    generation = r.varints(n)
    file_id = r.varints(n)
    offset = r.varints(n)
    length = r.varints(n)
    r.varints(n)                 # generations under the node
    r.bytes(8 * n)               # commit times
    height = [r.u8() for _ in range(n)]
    out = []
    for i in range(n):
        if file_id[i] >= len(files):
            raise r.fail(f"data file {file_id[i]} of {len(files)}")
        out.append((generation[i], Ref(*files[file_id[i]], offset[i],
                                       length[i]), height[i]))
    return out


class Store:
    """An OCDBT store in `directory`, at its newest version (the manifest
    holds it inline; older ones are in version-tree nodes, `versions`):
    `config`, `generation`, the B-tree's `height`, `list`, `read`,
    `read_many`, and `entries` (each key's
    inline value or out-of-line reference). The whole B-tree is read on
    opening."""

    def __init__(self, directory: str):
        self.directory = directory
        path = os.path.join(directory, MANIFEST)
        with open(path, "rb") as f:
            r = _unwrap(f.read(), MANIFEST_MAGIC, path)
        self.config = _config(r)
        if self.config.manifest_kind == _NUMBERED:
            raise NotImplementedError(
                f"{path}: a numbered manifest (manifest_kind 1); only "
                "single manifests are read")
        if self.config.manifest_kind != _SINGLE:
            raise r.fail(f"manifest kind {self.config.manifest_kind}")
        files = _file_table(r)
        self._inline = _versions(r, files)
        self._nodes = _version_nodes(r, files)
        r.end()
        if not self._inline and self._nodes:
            raise r.fail("version-tree nodes without the newest version "
                         "inline")
        version = self._inline[-1] if self._inline else None
        self.generation = version.generation if version else 0
        self.height = version.height if version else 0
        self._entries: Dict[bytes, Value] = {}
        if version is not None and version.root is not None:
            self._walk(version.root, version.height, b"")

    def _raw(self, ref: Ref) -> bytes:
        with open(os.path.join(self.directory, ref.base, ref.path),
                  "rb") as f:
            f.seek(ref.offset)
            raw = f.read(ref.length)
        if len(raw) != ref.length:
            raise ValueError(f"{ref.base}{ref.path}: {len(raw)} bytes at "
                             f"{ref.offset} where {ref.length} were named")
        return raw

    def _node_versions(self, ref: Ref, height: int) -> List[_Version]:
        """The versions under a version-tree node, oldest first."""
        what = f"{self.directory}: version-tree node {ref.base}{ref.path}"
        r = _unwrap(self._raw(ref), VERSION_TREE_MAGIC, what)
        r.u8()                                   # arity log2
        if r.u8() != height:
            raise r.fail("a version-tree node of the wrong height")
        files = _file_table(r)
        if height == 0:
            versions = _versions(r, files)
            r.end()
            return versions
        n = r.varint()
        r.varints(n)                             # last generations
        file_id = r.varints(n)
        offset = r.varints(n)
        length = r.varints(n)
        if any(f >= len(files) for f in file_id):
            raise r.fail("a reference past the data-file table")
        out: List[_Version] = []
        for f, off, size in zip(file_id, offset, length):
            out += self._node_versions(Ref(*files[f], off, size), height - 1)
        return out

    def versions(self) -> List[Tuple[int, int, int]]:
        """Every version the store records, oldest first: (generation,
        number of keys, commit time in ns)."""
        out: List[_Version] = []
        for _, ref, height in sorted(self._nodes, key=lambda n: n[0]):
            out += self._node_versions(ref, height)
        out += self._inline
        return [(v.generation, v.num_keys, v.commit_time_ns) for v in out]

    def _walk(self, ref: Ref, height: int, prefix: bytes) -> None:
        what = f"{self.directory}: B-tree node {ref.base}{ref.path}@" \
               f"{ref.offset}"
        r = _unwrap(self._raw(ref), BTREE_MAGIC, what)
        if r.u8() != height:
            raise r.fail("a B-tree node of the wrong height")
        files = _file_table(r)
        n = r.varint()
        shared = [0] + r.varints(n - 1) if n else []
        suffix = r.varints(n)
        common = r.varints(n) if height else None
        keys: List[bytes] = []
        key = b""
        for i in range(n):
            if shared[i] > len(key):
                raise r.fail("a key prefix past the key before it")
            key = key[:shared[i]] + r.bytes(suffix[i])
            keys.append(key)

        def refs(kinds=None):
            m = n if kinds is None else sum(kinds)
            file_id = r.varints(m)
            offset = r.varints(m)
            if any(f >= len(files) for f in file_id):
                raise r.fail("a reference past the data-file table")
            return file_id, offset

        if height:
            file_id, offset = refs()
            length = r.varints(n)
            r.varints(3 * n)         # keys, tree bytes, value bytes
            r.end()
            for i in range(n):
                if common[i] > len(keys[i]):
                    raise r.fail("a subtree prefix past its key")
                self._walk(Ref(*files[file_id[i]], offset[i], length[i]),
                           height - 1, prefix + keys[i][:common[i]])
            return
        length = r.varints(n)
        kinds = r.varints(n)
        if any(k not in (_INLINE, _INDIRECT) for k in kinds):
            raise r.fail("a value kind other than inline or indirect")
        file_id, offset = refs(kinds)
        indirect = iter(zip(file_id, offset))
        for key, size, kind in zip(keys, length, kinds):
            if kind == _INDIRECT:
                f, off = next(indirect)
                value: Value = Ref(*files[f], off, size)
            else:
                value = r.bytes(size)
            self._entries[prefix + key] = value
        r.end()

    def entries(self) -> Dict[bytes, Value]:
        return dict(self._entries)

    def list(self, prefix: bytes = b"") -> List[bytes]:
        """The keys that start with `prefix`, sorted."""
        return sorted(k for k in self._entries if k.startswith(prefix))

    def read(self, key: Union[bytes, str]) -> Optional[bytes]:
        """The value of `key`, or None where the store lacks it."""
        if isinstance(key, str):
            key = key.encode()
        value = self._entries.get(key)
        if isinstance(value, Ref):
            return self._raw(value)
        return value

    def read_many(self, keys: Iterable[bytes]) -> List[Optional[bytes]]:
        """The values of `keys` (None where missing), each data file
        opened once."""
        keys = list(keys)
        out: List[Optional[bytes]] = [None] * len(keys)
        by_file: Dict[Tuple[str, str], List[Tuple[int, Ref]]] = {}
        for i, key in enumerate(keys):
            value = self._entries.get(key)
            if isinstance(value, Ref):
                by_file.setdefault((value.base, value.path), []).append(
                    (i, value))
            else:
                out[i] = value
        for (base, path), wanted in by_file.items():
            fd = os.open(os.path.join(self.directory, base, path),
                         os.O_RDONLY)
            try:
                for i, ref in wanted:
                    raw = os.pread(fd, ref.length, ref.offset)
                    if len(raw) != ref.length:
                        raise ValueError(f"{base}{path}: {len(raw)} bytes "
                                         f"at {ref.offset} where "
                                         f"{ref.length} were named")
                    out[i] = raw
            finally:
                os.close(fd)
        return out


# -- encoding -------------------------------------------------------------

def _varint(value: int) -> bytes:
    out = bytearray()
    while value >= 0x80:
        out.append(value & 0x7F | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def _varints(values: Iterable[int]) -> bytes:
    return b"".join(_varint(v) for v in values)


def _wrap(magic: int, fields: bytes) -> bytes:
    """A manifest or node around its fields, uncompressed."""
    head = struct.pack(">I", magic)
    tail = _varint(0) + _varint(0) + fields
    length = len(head) + 8 + len(tail) + 4
    body = head + struct.pack("<Q", length) + tail
    return body + struct.pack("<I", crc32c(body))


def _encode_file_table(files: Sequence[Tuple[str, str]]) -> bytes:
    full = [(b + p).encode() for b, p in files]
    prefix = []
    for prev, cur in zip(full, full[1:]):
        n = 0
        while n < min(len(prev), len(cur)) and prev[n] == cur[n]:
            n += 1
        prefix.append(n)
    shared = [0] + prefix
    return (_varint(len(files)) + _varints(prefix)
            + _varints(len(f) - s for f, s in zip(full, shared))
            + _varints(len(b.encode()) for b, _ in files)
            + b"".join(f[s:] for f, s in zip(full, shared)))


def _encode_config(config: Config) -> bytes:
    out = (config.uuid + _varint(config.manifest_kind)
           + _varint(config.max_inline_value_bytes)
           + _varint(config.max_decoded_node_bytes)
           + bytes([config.version_tree_arity_log2]))
    if config.compression is None:
        return out + _varint(0)
    return out + _varint(1) + struct.pack("<i", config.compression)


def _leaf(entries: Sequence[Tuple[bytes, Value]]) -> Tuple[bytes, int]:
    """A leaf node over sorted (key, value) pairs, and the out-of-line
    bytes it refers to."""
    files = sorted({(v.base, v.path) for _, v in entries
                    if isinstance(v, Ref)}, key=lambda f: f[0] + f[1])
    index = {f: i for i, f in enumerate(files)}
    keys = [k for k, _ in entries]
    shared = [0]
    for prev, cur in zip(keys, keys[1:]):
        n = 0
        while n < min(len(prev), len(cur)) and prev[n] == cur[n]:
            n += 1
        shared.append(n)
    refs = [v for _, v in entries if isinstance(v, Ref)]
    values = [v for _, v in entries]
    fields = b"".join([
        bytes([0]), _encode_file_table(files), _varint(len(entries)),
        _varints(shared[1:]),
        _varints(len(k) - s for k, s in zip(keys, shared)),
        b"".join(k[s:] for k, s in zip(keys, shared)),
        _varints(v.length if isinstance(v, Ref) else len(v)
                 for v in values),
        _varints(_INDIRECT if isinstance(v, Ref) else _INLINE
                 for v in values),
        _varints(index[(v.base, v.path)] for v in refs),
        _varints(v.offset for v in refs),
        b"".join(v for v in values if not isinstance(v, Ref))])
    return fields, sum(v.length for v in refs)


def write_store(directory: str, items: Dict[bytes, Value],
                random_bytes: Callable[[int], bytes] = os.urandom) -> Config:
    """Writes `items` ({key: value bytes, or a `Ref` into another data
    file, relative to `directory`}) as a new store in `directory` under
    orbax's config (`Config`'s defaults: inline values up to 1024 bytes,
    nodes up to 1e8, a single manifest, zstd level 0 named for nodes,
    which this writer stores uncompressed): one version, a single root
    leaf, the longer values in one new data file `d/<name>` (the leaf
    after them), the rest inline. The uuid and the data file's name come
    from `random_bytes`. Returns the config written."""
    config = Config(uuid=random_bytes(16))
    name = "d/" + random_bytes(16).hex()
    data = bytearray()
    entries: List[Tuple[bytes, Value]] = []
    for key in sorted(items):
        value = items[key]
        key = key.encode() if isinstance(key, str) else bytes(key)
        if not isinstance(value, Ref) \
                and len(value) > config.max_inline_value_bytes:
            ref = Ref("", name, len(data), len(value))
            data += value
            value = ref
        entries.append((key, bytes(value) if not isinstance(value, Ref)
                        else value))
    files = [("", name)]
    if entries:
        fields, indirect = _leaf(entries)
        if len(fields) > config.max_decoded_node_bytes:
            raise ValueError(f"a leaf of {len(fields)} bytes exceeds the "
                             f"store's {config.max_decoded_node_bytes}")
        node = _wrap(BTREE_MAGIC, fields)
        root = (0, len(data), len(node))
        stats = (len(entries), len(node), indirect)
        data += node
    else:
        files = [("", "")]
        root = (0, _NONE, _NONE)
        stats = (0, 0, 0)
    os.makedirs(os.path.join(directory, "d"), exist_ok=True)
    if data:
        with open(os.path.join(directory, name), "wb") as f:
            f.write(data)
    manifest = b"".join([
        _encode_config(config), _encode_file_table(files),
        _varint(1), _varint(1), bytes([0]), _varints(root),
        _varints(stats), struct.pack("<Q", time.time_ns()), _varint(0)])
    with open(os.path.join(directory, MANIFEST), "wb") as f:
        f.write(_wrap(MANIFEST_MAGIC, manifest))
    return config


def merge_stores(directory: str, children: Sequence[str],
                 random_bytes: Callable[[int], bytes] = os.urandom) -> Config:
    """Writes the store in `directory` holding every entry of the stores
    in its subfolders `children` (a later child's entry replacing an
    earlier one's of the same key): inline values copied, out-of-line ones
    referred to in the child's data files by their path from
    `directory`."""
    items: Dict[bytes, Value] = {}
    for child in children:
        for key, value in Store(os.path.join(directory, child)) \
                .entries().items():
            if isinstance(value, Ref):
                value = Ref(f"{child}/{value.base}", value.path,
                            value.offset, value.length)
            items[key] = value
    return write_store(directory, items, random_bytes)
