"""HDF5 files in numpy and the standard library, in place of h5py.

RadarScenes stores each sequence's tables (`radar_data`, `odometry`) in a
`radar_data.h5`. This module reads a dataset of such a file
(`read_dataset`) and writes the layout h5py writes by default
(`write_datasets`), so the dataset creation needs no h5py. It follows the
HDF5 file format specification (version 3.0) as far as h5py and HDF5 1.14
write it, under libver "earliest" and "latest":

- superblocks v0-v3; v1 object headers (with continuation blocks) and v2
  ones (`OHDR`/`OCHK`), their checksums verified;
- symbol-table groups (a v1 B-tree of `SNOD` nodes over a local heap),
  compact link messages, and dense link storage (link messages in a
  fractal heap, `FRHP`/`FHIB`/`FHDB`, found by their names' hashes in a v2
  B-tree, `BTHD`/`BTIN`/`BTLF`; a creation-order index is checked against
  the name index when a group is listed whole);
- fixed-point, IEEE float, fixed-length string, compound (v1-v4), enum and
  array datatypes, as the numpy dtype h5py gives (field names, formats,
  offsets and itemsize; the enum `FALSE`/`TRUE` as bool, the compound
  `r`/`i` as complex, an array as a subarray, a v1 compound member with
  dimensions too); variable-length strings from global heap collections
  (`GCOL`), as objects of bytes under h5py's dtype (its `vlen` metadata,
  the members after them moved as in HDF5's memory layout);
- compact, contiguous and chunked layouts: a v1 B-tree of chunks (layout
  v3), and the single-chunk, implicit, fixed-array, extensible-array
  (`EAHD`/`EAIB`/`EASB`/`EADB`, paged data blocks too) and v2 B-tree
  chunk indexes (layout v4); the deflate, shuffle and fletcher32 filters,
  under each chunk's filter mask; fill values where no data was written.

What else a file may hold (variable-length sequences of numbers, huge
fractal heap objects and filtered heaps, soft and external links, external
or virtual storage, other filters) raises NotImplementedError naming the
feature and the file; a file that breaks the format raises ValueError, and
every structure that carries a checksum has it verified before it is used.
Every call opens its file and keeps no state between calls.
"""

from __future__ import annotations

import bisect
import mmap
import struct
import sys
import zlib
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
# layout v4's chunk indexes, by type number
CHUNK_INDEXES = {1: "single chunk", 2: "implicit", 3: "fixed array",
                 4: "extensible array", 5: "version 2 B-tree"}
# IEEE formats by size: (exponent bits, mantissa bits)
_IEEE = {2: (5, 10), 4: (8, 23), 8: (11, 52)}
_DATATYPE_CLASSES = ("fixed-point", "floating-point", "time", "string",
                     "bitfield", "opaque", "compound", "reference", "enum",
                     "variable-length", "array", "complex")


def _rot(x: int, k: int) -> int:
    return ((x << k) | (x >> (32 - k))) & 0xFFFFFFFF


def lookup3(data: bytes, initval: int = 0) -> int:
    """Bob Jenkins' lookup3 `hashlittle`, HDF5's metadata checksum."""
    m = 0xFFFFFFFF
    n = len(data)
    a = b = c = (0xDEADBEEF + n + initval) & m
    pos = 0
    while n - pos > 12:
        x, y, z = struct.unpack_from("<III", data, pos)
        a, b, c = (a + x) & m, (b + y) & m, (c + z) & m
        a = ((a - c) & m) ^ _rot(c, 4)
        c = (c + b) & m
        b = ((b - a) & m) ^ _rot(a, 6)
        a = (a + c) & m
        c = ((c - b) & m) ^ _rot(b, 8)
        b = (b + a) & m
        a = ((a - c) & m) ^ _rot(c, 16)
        c = (c + b) & m
        b = ((b - a) & m) ^ _rot(a, 19)
        a = (a + c) & m
        c = ((c - b) & m) ^ _rot(b, 4)
        b = (b + a) & m
        pos += 12
    if n == pos:
        return c
    x, y, z = struct.unpack("<III", data[pos:] + bytes(12 - (n - pos)))
    a, b, c = (a + x) & m, (b + y) & m, (c + z) & m
    c = (c ^ b) - _rot(b, 14) & m
    a = (a ^ c) - _rot(c, 11) & m
    b = (b ^ a) - _rot(a, 25) & m
    c = (c ^ b) - _rot(b, 16) & m
    a = (a ^ c) - _rot(c, 4) & m
    b = (b ^ a) - _rot(a, 14) & m
    c = (c ^ b) - _rot(b, 24) & m
    return c


def fletcher32(data: bytes) -> int:
    """HDF5's Fletcher-32 (`H5_checksum_fletcher32`): big-endian 16-bit
    words, both sums folded by end-around carry into [1, 0xffff] (0 only
    where every word is 0)."""
    raw = np.frombuffer(data, np.uint8)
    if len(raw) % 2:
        raw = np.append(raw, np.uint8(0))
    words = raw.view(">u2").astype(np.uint64)
    if not words.any():
        return 0
    n = len(words)
    s1 = int(words.sum())
    weights = (n - np.arange(n, dtype=np.uint64)) % 65535
    step = 1 << 20                  # products < 2^32, block sums < 2^52
    s2 = sum(int((words[i:i + step] * weights[i:i + step]).sum())
             for i in range(0, n, step))
    fold = lambda s: (s % 65535 - 1) % 65535 + 1  # noqa: E731
    return fold(s2) << 16 | fold(s1)


class _Cursor:
    """Little-endian fields of a byte string, read in order."""

    def __init__(self, data: bytes, pos: int = 0, offsets: int = 8,
                 lengths: int = 8):
        self.data, self.pos = data, pos
        self.offsets, self.lengths = offsets, lengths

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated metadata")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u(self, n: int) -> int:
        return int.from_bytes(self.take(n), "little")

    def addr(self) -> int:
        return self.u(self.offsets)

    def length(self) -> int:
        return self.u(self.lengths)

    def name(self, pad: int) -> str:
        """A null-terminated name whose bytes (terminator included) are
        padded to a multiple of `pad`."""
        end = self.data.index(b"\0", self.pos)
        name = self.data[self.pos:end].decode()
        self.pos += -(-(end + 1 - self.pos) // pad) * pad
        return name


class _Type(NamedTuple):
    """A datatype: the dtype of its bytes in the file (`stored`; a
    variable-length string is `V<size>` there) and the dtype h5py gives it
    (`given`), with the paths of names (fields) that hold null-terminated
    strings and variable-length strings."""

    stored: np.dtype
    given: np.dtype
    nullterm: List[tuple]
    vlen: List[tuple]


def _plain(dtype) -> _Type:
    dtype = np.dtype(dtype)
    return _Type(dtype, dtype, [], [])


def _subarray(base: _Type, dims: Tuple[int, ...]) -> _Type:
    return _Type(np.dtype((base.stored, dims)), np.dtype((base.given, dims)),
                 base.nullterm, base.vlen)


def _enc_size(n: int) -> int:
    """The bytes HDF5 gives a count of at most `n` (`H5VM_limit_enc_size`)."""
    return max(n.bit_length() - 1, 0) // 8 + 1


def _log2(n: int) -> int:
    return n.bit_length() - 1


def _le(raw: np.ndarray) -> np.ndarray:
    """Little-endian unsigned integers from the bytes on `raw`'s last
    axis (at most 8)."""
    shifts = 8 * np.arange(raw.shape[-1], dtype=np.uint64)
    return (raw.astype(np.uint64) << shifts).sum(axis=-1, dtype=np.uint64)


class _File:
    """One open file (its metadata read through `mm`, contiguous data
    straight from `file`): its superblock's sizes and the parsers of its
    metadata. Addresses are relative to the superblock's base address."""

    def __init__(self, path: str, file, mm: mmap.mmap):
        self.path, self.file, self.mm = path, file, mm
        self.collections: Dict[int, Dict[int, bytes]] = {}
        base = 0
        while mm[base:base + 8] != SIGNATURE:
            base = 512 if base == 0 else 2 * base
            if base + 8 > len(mm):
                raise ValueError(f"{path} is not an HDF5 file")
        c = _Cursor(mm, base + 8)
        version = c.u(1)
        if version in (0, 1):
            c.pos += 4
            self.offsets, self.lengths = c.u(1), c.u(1)
            c.pos += 9 + 4 * version
        elif version in (2, 3):
            self.offsets, self.lengths = c.u(1), c.u(1)
            c.pos += 1
        else:
            self.unsupported(f"superblock version {version}")
        self.undefined = (1 << 8 * self.offsets) - 1
        c.offsets, c.lengths = self.offsets, self.lengths
        self.base = c.addr()
        if version < 2:
            c.addr()                            # free-space info
            c.addr()                            # end of file
            if c.addr() != self.undefined:
                self.unsupported("a file driver information block (a "
                                 "family or multi file)")
            c.addr()                            # root link name offset
            self.root = c.addr()
        else:
            c.addr()                            # superblock extension
            c.addr()                            # end of file
            self.root = c.addr()
            self.verify(base, c.pos, "superblock")

    def unsupported(self, feature: str):
        raise NotImplementedError(f"{self.path}: {feature} is not supported "
                                  "by radargnn_tpu_torch.data.hdf5")

    def corrupt(self, what: str):
        raise ValueError(f"{self.path}: {what}")

    def cursor(self, addr: int, data: Optional[bytes] = None) -> _Cursor:
        if data is None:
            return _Cursor(self.mm, self.base + addr, self.offsets,
                           self.lengths)
        return _Cursor(data, addr, self.offsets, self.lengths)

    def verify(self, start: int, end: int, what: str) -> None:
        """The lookup3 checksum stored at `end` over [start, end) (absolute
        positions)."""
        stored = int.from_bytes(self.mm[end:end + 4], "little")
        if lookup3(self.mm[start:end]) != stored:
            self.corrupt(f"{what} checksum mismatch at {start - self.base}")

    def signature(self, addr: int, sig: bytes) -> _Cursor:
        c = self.cursor(addr)
        if c.take(4) != sig:
            self.corrupt(f"no {sig.decode()} signature at {addr}")
        return c

    def block(self, addr: int, sig: bytes, kind: Optional[int], what: str,
              owner: Optional[int] = None) -> _Cursor:
        """The cursor past the prefix of a version 0 metadata block at
        `addr`: its signature, version, `kind` (a type or client id, where
        the block has one) and, where `owner` is given, the address of its
        header."""
        c = self.signature(addr, sig)
        if c.u(1) != 0:
            self.unsupported(f"a {what} version other than 0")
        if kind is not None and c.u(1) != kind:
            self.corrupt(f"the {what} at {addr} is not of type {kind}")
        if owner is not None and c.addr() != owner:
            self.corrupt(f"the {what} at {addr} belongs to another header")
        return c

    # -- object headers ---------------------------------------------------

    def messages(self, addr: int) -> List[Tuple[int, int, bytes]]:
        """An object header's messages as (type, flags, data), every
        continuation block followed."""
        c = self.cursor(addr)
        if c.take(4) == b"OHDR":
            if c.u(1) != 2:
                self.unsupported("an OHDR object header version other "
                                 "than 2")
            flags = c.u(1)
            c.pos += (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
            size = c.u(1 << (flags & 3))
            self.verify(self.base + addr, c.pos + size, "object header")
            head, sig = (6 if flags & 0x04 else 4), b"OCHK"
        else:
            c.pos -= 4
            if c.u(1) != 1:
                self.corrupt(f"no object header at {addr}")
            c.pos += 7                          # message count, references
            size = c.u(4)
            c.pos += 4                          # messages 8-byte aligned
            head, sig = 8, None
        out: List[Tuple[int, int, bytes]] = []
        blocks, seen = [(c.pos, c.pos + size)], set()
        while blocks:
            start, end = blocks.pop(0)
            if start in seen:
                self.corrupt(f"the object header at {addr} continues in a "
                             "loop")
            seen.add(start)
            c.pos = start
            while end - c.pos >= head:
                if sig:
                    mtype, msize, mflags = c.u(1), c.u(2), c.u(1)
                else:
                    mtype, msize, mflags = c.u(2), c.u(2), c.u(1)
                c.pos += head - 4 if sig else 3
                self._message(mtype, mflags, c.take(msize), out, blocks, sig)
        return out

    def _message(self, mtype: int, mflags: int, data: bytes, out: list,
                 blocks: list, sig: Optional[bytes]) -> None:
        if mtype != 0x10:
            out.append((mtype, mflags, data))
            return
        c = self.cursor(0, data)
        at, length = c.addr(), c.length()
        start = self.base + at
        if sig is None:
            blocks.append((start, start + length))
            return
        self.signature(at, sig)
        self.verify(start, start + length - 4, "object header continuation")
        blocks.append((start + 4, start + length - 4))

    # -- version 2 B-trees ------------------------------------------------

    def btree2(self, addr: int, kind: int,
               info: Optional[Tuple[int, int, int]] = None) -> List[bytes]:
        """Every record of the version 2 B-tree whose header is at `addr`
        (records of type `kind`), in key order; `info` is the node size and
        split and merge percentages its owner expects."""
        c = self.block(addr, b"BTHD", kind, "v2 B-tree header")
        node, size, depth = c.u(4), c.u(2), c.u(2)
        split, merge = c.u(1), c.u(1)
        root, count, total = c.addr(), c.u(2), c.length()
        self.verify(self.base + addr, c.pos, "v2 B-tree header")
        if info is not None and info != (node, split, merge):
            self.corrupt(f"a v2 B-tree of {(node, split, merge)} where its "
                         f"owner says {info}")
        if not size or node <= 10 + size:
            self.corrupt(f"a v2 B-tree of {size}-byte records in "
                         f"{node}-byte nodes")
        # A child pointer holds the child's address, its record count and,
        # below an internal node above level 1, the records under it: each
        # count in the bytes its most records need (`H5B2__hdr_init`).
        most = (node - 10) // size              # a leaf's
        count_size = _enc_size(most)
        total_sizes = [0]
        for _ in range(depth):
            pointer = self.offsets + count_size + total_sizes[-1]
            here = (node - 10 - pointer) // (size + pointer)
            most = (here + 1) * most + here
            total_sizes.append(_enc_size(most))
        out: List[bytes] = []
        if root != self.undefined:
            self._btree2_node(root, count, depth, kind, size, count_size,
                              total_sizes, out)
        if len(out) != total:
            self.corrupt(f"a v2 B-tree at {addr} of {len(out)} records, "
                         f"its header says {total}")
        return out

    def _btree2_node(self, addr: int, count: int, depth: int, kind: int,
                     size: int, count_size: int, total_sizes: List[int],
                     out: List[bytes]) -> None:
        c = self.block(addr, b"BTIN" if depth else b"BTLF", kind,
                       "v2 B-tree node")
        records = [c.take(size) for _ in range(count)]
        children = []
        for _ in range(count + 1 if depth else 0):
            children.append((c.addr(), c.u(count_size)))
            c.u(total_sizes[depth - 1])         # 0 bytes above a leaf
        self.verify(self.base + addr, c.pos, "v2 B-tree node")
        if not depth:
            out += records
            return
        for i, (child, n) in enumerate(children):
            self._btree2_node(child, n, depth - 1, kind, size, count_size,
                              total_sizes, out)
            if i < count:
                out.append(records[i])

    # -- groups -----------------------------------------------------------

    def links(self, messages, name: Optional[str] = None
              ) -> Dict[str, Optional[int]]:
        """A group's links: name -> object header address (None for a
        soft or external link). Given `name`, a group in dense storage
        gives only the links whose name hashes as `name`'s does."""
        links: Dict[str, Optional[int]] = {}
        for mtype, _, data in messages:
            c = self.cursor(0, data)
            if mtype == 0x11:
                btree, heap = c.addr(), c.addr()
                self._symbol_table(btree, self._heap(heap), links)
            elif mtype == 0x02:
                c.pos += 1
                flags = c.u(1)
                c.pos += 8 if flags & 1 else 0
                heap, names = c.addr(), c.addr()
                order = c.addr() if flags & 2 else None
                if heap != self.undefined:
                    self._dense_links(heap, names, order, name, links)
            elif mtype == 0x06:
                link, target = self._link(c)
                links[link] = target
        return links

    def _link(self, c: _Cursor) -> Tuple[str, Optional[int]]:
        """A link message's name and hard link target (None for a soft or
        external link)."""
        if c.u(1) != 1:
            self.corrupt("a link message version other than 1")
        flags = c.u(1)
        kind = c.u(1) if flags & 0x08 else 0
        c.pos += (8 if flags & 0x04 else 0) + (1 if flags & 0x10 else 0)
        name = c.take(c.u(1 << (flags & 3))).decode()
        return name, (c.addr() if kind == 0 else None)

    def _dense_links(self, heap: int, names: int, order: Optional[int],
                     name: Optional[str], links: dict) -> None:
        """The links of a group in dense storage: link messages in the
        fractal heap at `heap`, indexed by the v2 B-tree `names` (records
        of type 5: the name's lookup3 hash, a heap ID) and, where creation
        order is indexed, `order` (type 6: the creation index, a heap ID).
        The whole group is checked against its creation-order index."""
        objects = _FractalHeap(self, heap)
        want = None if name is None else lookup3(name.encode())
        records = self.btree2(names, 5)
        for record in records:
            hashed = int.from_bytes(record[:4], "little")
            if want is not None and hashed != want:
                continue
            link, target = self._link(self.cursor(0, objects.get(record[4:])))
            if lookup3(link.encode()) != hashed:
                self.corrupt(f"the link {link!r} under another name's hash")
            links[link] = target
        if name is None and order is not None and sorted(
                r[8:] for r in self.btree2(order, 6)) != sorted(
                    r[4:] for r in records):
            self.corrupt("a group's name and creation-order indexes name "
                         "different links")

    def _heap(self, addr: int) -> bytes:
        c = self.signature(addr, b"HEAP")
        c.pos += 4
        size = c.length()
        c.length()                              # free list
        return self.cursor(c.addr()).take(size)

    def _symbol_table(self, addr: int, heap: bytes, links: dict) -> None:
        c = self.signature(addr, b"TREE")
        if c.u(1) != 0:
            self.corrupt(f"the group B-tree at {addr} is not a group node")
        level, used = c.u(1), c.u(2)
        c.pos += 2 * self.offsets
        for _ in range(used):
            c.length()
            child = c.addr()
            if level:
                self._symbol_table(child, heap, links)
                continue
            node = self.signature(child, b"SNOD")
            node.pos += 2
            for _ in range(node.u(2)):
                name, header = node.addr(), node.addr()
                soft = node.u(4) == 2           # the cache type
                links[heap[name:heap.index(b"\0", name)].decode()] = (
                    None if soft else header)
                node.pos += 20

    def find(self, name: str) -> int:
        addr = self.root
        for part in name.strip("/").split("/"):
            links = self.links(self.messages(addr), part)
            if part not in links:
                raise KeyError(f"{self.path}: no object named {name!r}")
            if links[part] is None:
                self.unsupported(f"the soft or external link {name!r}")
            addr = links[part]
        return addr

    # -- datatypes ----------------------------------------------------------

    def datatype(self, c: _Cursor) -> _Type:
        """The datatype at `c`: its bytes' dtype, the dtype h5py gives it,
        and where it holds null-terminated and variable-length strings."""
        head = c.u(1)
        cls, version = head & 15, head >> 4
        bits, size = c.u(3), c.u(4)
        order = ">" if bits & 1 else "<"
        if cls == 0:
            c.pos += 4
            if size not in (1, 2, 4, 8):
                self.unsupported(f"a {size}-byte integer")
            return _plain(f"{order}{'i' if bits & 8 else 'u'}{size}")
        if cls == 1:
            c.pos += 5
            exponent = c.u(1)
            c.pos += 1
            mantissa = c.u(1)
            c.pos += 4
            if bits & 0x40 or _IEEE.get(size) != (exponent, mantissa):
                self.unsupported(f"a {size}-byte float that is not IEEE "
                                 "754 in little- or big-endian order")
            return _plain(f"{order}f{size}")
        if cls == 3:
            if bits & 15 not in (0, 1):
                self.unsupported("a space-padded string")
            t = _plain(f"S{size}")
            return t._replace(nullterm=[()]) if bits & 15 == 0 else t
        if cls == 6:
            return self._compound(c, version, bits & 0xFFFF, size)
        if cls == 8:
            base = self.datatype(c).stored
            names = [c.name(8 if version < 3 else 1)
                     for _ in range(bits & 0xFFFF)]
            values = np.frombuffer(c.take(len(names) * base.itemsize), base)
            if dict(zip(names, values.tolist())) == {"FALSE": 0, "TRUE": 1}:
                return _plain(bool)
            return _plain(base)
        if cls == 9:
            if bits & 15 != 1:
                self.unsupported("a variable-length sequence (h5py."
                                 "vlen_dtype; only variable-length strings "
                                 "are read)")
            self.datatype(c)                    # one character
            if size != 8 + self.offsets:
                self.corrupt(f"a {size}-byte variable-length string")
            # h5py marks the charset (bits 8-11: ASCII 0, UTF-8 1) in the
            # dtype's metadata and gives the values as bytes either way
            vlen = str if bits >> 8 & 15 else bytes
            return _Type(np.dtype(f"V{size}"),
                         np.dtype("O", metadata={"vlen": vlen}), [], [()])
        if cls == 10:
            rank = c.u(1)
            c.pos += 3 if version < 3 else 0
            dims = tuple(c.u(4) for _ in range(rank))
            c.pos += 4 * rank if version < 3 else 0     # permutations
            t = _subarray(self.datatype(c), dims)
            if t.stored.itemsize != size:
                self.corrupt(f"a {size}-byte array of {t.stored}")
            return t
        self.unsupported(f"the {_DATATYPE_CLASSES[cls]} datatype"
                         if cls < len(_DATATYPE_CLASSES)
                         else f"datatype class {cls}")

    def _compound(self, c: _Cursor, version: int, n: int,
                  size: int) -> _Type:
        members = []
        for _ in range(n):
            name = c.name(8 if version < 3 else 1)
            if version < 3:
                offset = c.u(4)
            else:
                offset = c.u((size.bit_length() - 1) // 8 + 1)
            dims: Tuple[int, ...] = ()
            if version == 1:
                rank = c.u(1)
                c.pos += 11                     # reserved, permutation
                dims = tuple(c.u(4) for _ in range(4))[:rank]
            member = self.datatype(c)
            members.append((name, offset,
                            _subarray(member, dims) if dims else member))
        formats = [t.stored for _, _, t in members]
        if ([m[0] for m in members] == ["r", "i"] and formats[0] == formats[1]
                and formats[0].kind == "f"
                and [m[1] for m in members] == [0, formats[0].itemsize]
                and size == 2 * formats[0].itemsize):
            return _plain(f"{formats[0].byteorder}c{size}".replace("=", ""))
        # h5py lists the members by offset; a variable-length string is
        # 8 bytes (a pointer) in its dtype, which moves the members after
        # it as HDF5's memory layout does (`H5T_set_loc`)
        members.sort(key=lambda m: m[1])
        names = [m[0] for m in members]
        stored = np.dtype({"names": names,
                           "formats": [t.stored for _, _, t in members],
                           "offsets": [offset for _, offset, _ in members],
                           "itemsize": size})
        nullterm = [(name,) + p for name, _, t in members for p in t.nullterm]
        vlen = [(name,) + p for name, _, t in members for p in t.vlen]
        if not vlen:
            return _Type(stored, stored, nullterm, vlen)
        offsets, shift = [], 0
        for _, offset, t in members:
            offsets.append(offset + shift)
            shift += t.given.itemsize - t.stored.itemsize
        return _Type(stored, np.dtype({
            "names": names, "formats": [t.given for _, _, t in members],
            "offsets": offsets, "itemsize": size + shift}), nullterm, vlen)

    # -- datasets ---------------------------------------------------------

    def dataset(self, name: str) -> np.ndarray:
        shape = dtype = layout = None
        maxshape: Tuple = ()
        filters: List[Tuple[int, List[int]]] = []
        fill: Optional[bytes] = None
        for mtype, mflags, data in self.messages(self.find(name)):
            if mflags & 0x02 and mtype in (0x1, 0x3, 0x4, 0x5, 0x8, 0xB):
                self.unsupported(f"a shared message of type {mtype:#x}")
            c = self.cursor(0, data)
            if mtype == 0x1:
                shape, maxshape = self._dataspace(c)
            elif mtype == 0x3:
                dtype = self.datatype(c)
            elif mtype == 0x4 and fill is None:
                fill = c.take(c.u(4))
            elif mtype == 0x5:
                fill = self._fill(c)
            elif mtype == 0x7:
                self.unsupported("external data files")
            elif mtype == 0x8:
                layout = c
            elif mtype == 0xB:
                filters = self._filters(c)
            elif mflags & 0x80:
                self.unsupported(f"a message of type {mtype:#x} marked "
                                 "fail-if-unknown")
        if shape is None or dtype is None or layout is None:
            raise ValueError(f"{self.path}: {name!r} is not a dataset")
        if fill and len(fill) != dtype.stored.itemsize:
            self.corrupt(f"{name!r}: a {len(fill)}-byte fill value")
        # an array datatype at the top reads as h5py gives it: its
        # dimensions after the dataset's
        top = dtype.stored.subdtype is not None
        stored = np.dtype([("v", dtype.stored)]) if top else dtype.stored
        out = self._read(layout, shape, stored, fill, maxshape or shape,
                         filters)
        if top:
            out = out["v"]
        if dtype.vlen:
            out = self._given(out, dtype)
        for path in dtype.nullterm:
            _null_terminate(_field(out, path))
        return out

    def _given(self, raw: np.ndarray, t: _Type) -> np.ndarray:
        """`raw` (read as `t.stored`) as h5py gives it: each variable-length
        string as bytes, in the layout of `t.given`."""
        if t.vlen == [()]:
            return self._strings(raw, t.given)
        out = np.zeros(raw.shape, t.given)
        for path in _leaves(t.stored):
            src = _field(raw, path)
            dst = _field(out, path)
            dst[...] = self._strings(src, dst.dtype) if path in t.vlen \
                else src
        return out

    def _strings(self, raw: np.ndarray, dtype: np.dtype) -> np.ndarray:
        """Variable-length strings (each a length, then a global heap ID:
        a collection's address and an object's index) as bytes, cut at the
        first null as h5py cuts them (an empty or null one is b""), in an
        array of the object `dtype`."""
        flat = np.ascontiguousarray(raw).view(np.uint8).reshape(
            -1, raw.dtype.itemsize)
        lengths = _le(flat[:, :4]).tolist()
        addrs = _le(flat[:, 4:4 + self.offsets]).tolist()
        index = _le(flat[:, 4 + self.offsets:]).tolist()
        out = np.empty(len(flat), dtype)
        for i, (n, at, k) in enumerate(zip(lengths, addrs, index)):
            if not n:
                out[i] = b""
                continue
            value = self._collection(at).get(k)
            if value is None or len(value) < n:
                self.corrupt(f"no {n}-byte object {k} in the global heap "
                             f"collection at {at}")
            out[i] = value[:n].split(b"\0", 1)[0]
        return out.reshape(raw.shape)

    def _collection(self, addr: int) -> Dict[int, bytes]:
        """The objects of the global heap collection at `addr` by index."""
        if addr in self.collections:
            return self.collections[addr]
        c = self.signature(addr, b"GCOL")
        if c.u(1) != 1:
            self.unsupported("a global heap collection version other than 1")
        c.pos += 3
        end = c.pos - 8 + c.length()
        objects: Dict[int, bytes] = {}
        while end - c.pos >= 8 + self.lengths:
            index = c.u(2)
            c.pos += 6                          # references, reserved
            size = c.length()
            if not index:                       # the free space, last
                break
            objects[index] = c.take(size)
            c.pos += -size % 8
        self.collections[addr] = objects
        return objects

    def _dataspace(self, c: _Cursor) -> Tuple[Tuple, Tuple]:
        version, rank, flags = c.u(1), c.u(1), c.u(1)
        if version == 1:
            c.pos += 5
        elif c.u(1) == 2:
            self.unsupported("a null dataspace")
        shape = tuple(c.length() for _ in range(rank))
        limits = tuple(c.length() for _ in range(rank)) if flags & 1 else ()
        undefined = (1 << 8 * self.lengths) - 1
        return shape, tuple(None if m == undefined else m for m in limits)

    def _fill(self, c: _Cursor) -> Optional[bytes]:
        version = c.u(1)
        if version == 1:
            c.pos += 3
            return c.take(c.u(4))
        if version == 2:
            c.pos += 2
            return c.take(c.u(4)) if c.u(1) else None
        return c.take(c.u(4)) if c.u(1) & 0x20 else None

    def _filters(self, c: _Cursor) -> List[Tuple[int, List[int]]]:
        version, n = c.u(1), c.u(1)
        c.pos += 6 if version == 1 else 0
        out = []
        for _ in range(n):
            fid = c.u(2)
            named = c.u(2) if version == 1 or fid >= 256 else 0
            c.u(2)                              # flags
            nvalues = c.u(2)
            c.pos += named
            out.append((fid, [c.u(4) for _ in range(nvalues)]))
            c.pos += 4 if version == 1 and nvalues % 2 else 0
        return out

    def _read(self, c: _Cursor, shape: Tuple, dtype: np.dtype,
              fill: Optional[bytes], maxshape: Tuple, filters) -> np.ndarray:
        """The data under the layout message at `c`; the fill value (else
        zeros) where none was written."""
        version, cls = c.u(1), c.u(1)
        if version not in (3, 4):
            self.unsupported(f"data layout message version {version}")
        if cls == 0:
            data = c.take(c.u(2))
            return np.frombuffer(data, dtype).reshape(shape).copy()
        count = int(np.prod(shape))
        if cls == 1:
            addr, size = c.addr(), c.length()
            if addr == self.undefined or not count:
                return _filled(shape, dtype, fill)
            if size != count * dtype.itemsize:
                self.corrupt(f"contiguous storage of {size} bytes for "
                             f"{count * dtype.itemsize}")
            self._check_span(addr, size)
            self.file.seek(0)
            return np.fromfile(self.file, dtype, count,
                               offset=self.base + addr).reshape(shape)
        if cls != 2:
            self.unsupported("virtual dataset storage" if cls == 3
                             else f"layout class {cls}")
        if version == 3:
            rank = c.u(1)
            addr = c.addr()
            dims = [c.u(4) for _ in range(rank)]
            index, info = 0, None
        else:
            flags, rank, width = c.u(1), c.u(1), c.u(1)
            dims = [c.u(width) for _ in range(rank)]
            index = c.u(1)
            if flags & 1 and filters:
                self.unsupported("unfiltered partial edge chunks")
            if index not in CHUNK_INDEXES:
                self.unsupported(f"layout v4 chunk index type {index}")
            info = ((c.length(), c.u(4)) if index == 1 and flags & 2
                    else c.u(1) if index == 3
                    else tuple(c.u(1) for _ in range(5)) if index == 4
                    else (c.u(4), c.u(1), c.u(1)) if index == 5 else None)
            addr = c.addr()
        chunk, element = tuple(dims[:-1]), dims[-1]
        if element != dtype.itemsize or len(chunk) != len(shape):
            self.corrupt(f"chunks of {dims} for {dtype.itemsize}-byte "
                         f"elements in {len(shape)} dimensions")
        out = _filled(shape, dtype, fill)
        if addr == self.undefined:
            return out
        nbytes = int(np.prod(chunk)) * element
        if index == 0:
            chunks = self._btree_chunks(addr, out.ndim + 1)
        elif index == 1:
            size, mask = info or (nbytes, 0)
            chunks = [((0,) * out.ndim, addr, size, mask)]
        elif index == 5:
            chunks = self._btree2_chunks(addr, info, chunk, bool(filters),
                                         nbytes)
        else:
            if index == 2:
                grid = [-(-m // k) for m, k in zip(maxshape, chunk)]
                entries = [(i, addr + i * nbytes, nbytes, 0)
                           for i in range(int(np.prod(grid)))]
            elif index == 3:
                entries = self._fixed_array(addr, info, bool(filters),
                                            nbytes)
            else:
                entries = self._extensible_array(addr, info, bool(filters),
                                                 nbytes)
            offsets = _grid_offsets([e[0] for e in entries], chunk, maxshape)
            chunks = [(o, a, n, m)
                      for o, (_, a, n, m) in zip(offsets, entries)]
        for offset, at, size, mask in chunks:
            region = tuple(slice(o, min(o + k, s))
                           for o, k, s in zip(offset, chunk, out.shape))
            if any(r.start >= r.stop for r in region):
                continue
            self._check_span(at, size)
            data = self._unfilter(self.mm[self.base + at:self.base + at + size],
                                  filters, mask)
            if len(data) != nbytes:
                self.corrupt(f"a chunk at {at} of {len(data)} bytes, "
                             f"expected {nbytes}")
            block = np.frombuffer(data, out.dtype).reshape(chunk)
            out[region] = block[tuple(slice(0, r.stop - r.start)
                                      for r in region)]
        return out

    def _check_span(self, addr: int, size: int) -> None:
        if self.base + addr + size > len(self.mm):
            self.corrupt(f"data at {addr} of {size} bytes runs past the end "
                         "of the file")

    def _btree_chunks(self, addr: int, dims: int) -> List[tuple]:
        """The (offset, address, size, filter mask) of every chunk under
        the v1 B-tree node at `addr` (node type 1)."""
        c = self.signature(addr, b"TREE")
        if c.u(1) != 1:
            self.corrupt(f"the chunk B-tree at {addr} is not a chunk node")
        level, used = c.u(1), c.u(2)
        c.pos += 2 * self.offsets
        out = []
        for _ in range(used):
            size, mask = c.u(4), c.u(4)
            offset = tuple(c.u(8) for _ in range(dims))[:-1]
            child = c.addr()
            if level:
                out += self._btree_chunks(child, dims)
            else:
                out.append((offset, child, size, mask))
        return out

    def _btree2_chunks(self, addr: int, info: Tuple[int, int, int],
                       chunk: Tuple[int, ...], filtered: bool,
                       nbytes: int) -> List[tuple]:
        """The (offset, address, size, filter mask) of every chunk in the
        v2 B-tree chunk index at `addr`: records of type 10 (address,
        scaled offsets) or, filtered, 11 (address, size, filter mask,
        scaled offsets)."""
        out = []
        for record in self.btree2(addr, 11 if filtered else 10, info):
            c = self.cursor(0, record)
            at = c.addr()
            width = len(record) - self.offsets - 4 - 8 * len(chunk)
            if filtered and width < 1:
                self.corrupt(f"a {len(record)}-byte chunk record")
            size, mask = (c.u(width), c.u(4)) if filtered else (nbytes, 0)
            out.append((tuple(c.u(8) * k for k in chunk), at, size, mask))
        return out

    def _entries(self, segments: List[Tuple[int, bytes]], entry: int,
                 filtered: bool, nbytes: int) -> List[tuple]:
        """The (index, address, size, filter mask) of every chunk written,
        from runs of array elements (the index of the first, their bytes):
        each an address, then, filtered, the chunk's size in all but the
        last 4 bytes and its filter mask in those (unfiltered chunks are
        `nbytes` long)."""
        if filtered and entry <= self.offsets + 4 or \
                not filtered and entry != self.offsets:
            self.corrupt(f"{entry}-byte chunk entries")
        out: List[tuple] = []
        for first, raw in segments:
            n = len(raw) // entry
            cols = np.frombuffer(raw, np.uint8, n * entry).reshape(n, entry)
            addrs = _le(cols[:, :self.offsets])
            keep = np.flatnonzero(addrs != np.uint64(self.undefined))
            if filtered:
                sizes = _le(cols[keep, self.offsets:-4]).tolist()
                masks = _le(cols[keep, -4:]).tolist()
            else:
                sizes, masks = [nbytes] * len(keep), [0] * len(keep)
            out += zip((first + keep).tolist(), addrs[keep].tolist(), sizes,
                       masks)
        return out

    def _fixed_array(self, addr: int, page_bits: int, filtered: bool,
                     nbytes: int) -> List[tuple]:
        """The chunks of a fixed array (`_entries`); a page never written
        holds none."""
        c = self.block(addr, b"FAHD", int(filtered), "fixed array header")
        entry, bits = c.u(1), c.u(1)
        count, block = c.length(), c.addr()
        self.verify(self.base + addr, c.pos, "fixed array header")
        if bits != page_bits:
            self.corrupt(f"fixed array page bits {bits}, layout {page_bits}")
        c = self.block(block, b"FADB", int(filtered), "fixed array data "
                       "block", addr)
        per_page = 1 << bits
        if count <= per_page:
            segments = [(0, c.take(count * entry))]
            self.verify(self.base + block, c.pos, "fixed array data block")
        else:
            pages = -(-count // per_page)
            bitmap = c.take(-(-pages // 8))
            self.verify(self.base + block, c.pos, "fixed array data block")
            c.pos += 4
            segments = []
            for p in range(pages):
                n = min(per_page, count - p * per_page)
                if bitmap[p // 8] & 0x80 >> p % 8:
                    start = c.pos
                    segments.append((p * per_page, c.take(n * entry)))
                    self.verify(start, c.pos, "fixed array page")
                else:                           # never written
                    c.pos += n * entry
                c.pos += 4
        return self._entries(segments, entry, filtered, nbytes)

    def _extensible_array(self, addr: int, info: Tuple[int, ...],
                          filtered: bool, nbytes: int) -> List[tuple]:
        """The chunks of an extensible array (`_entries`). Its first
        elements lie in its index block; the rest in data blocks, which
        the index block lists for the first super blocks and super blocks
        list for the others: super block u holds 2^(u // 2) data blocks of
        2^((u + 1) // 2) times the least elements a data block holds. A
        data block of more elements than a page is paged, its super block
        holding which pages were written (`H5EA__hdr_init`)."""
        c = self.block(addr, b"EAHD", int(filtered),
                       "extensible array header")
        entry, bits, first, least, pointers, page_bits = (
            c.u(1) for _ in range(6))
        for _ in range(4):
            c.length()                          # block statistics
        count = c.length()                      # elements up to the last set
        c.length()
        index = c.addr()
        self.verify(self.base + addr, c.pos, "extensible array header")
        if info != (bits, first, pointers, least, page_bits):
            self.corrupt(f"extensible array parameters {info} in the layout "
                         f"and {(bits, first, pointers, least, page_bits)} "
                         "in its header")
        if least & least - 1 or pointers & pointers - 1 or least < 1 or \
                pointers < 2 or bits < _log2(least):
            self.corrupt(f"extensible array parameters {info}")
        # (data blocks, elements each, first element) of each super block
        supers, start = [], first
        for u in range(1 + bits - _log2(least)):
            supers.append((1 << u // 2, least << (u + 1) // 2, start))
            start += supers[-1][0] * supers[-1][1]
        inline = 2 * _log2(pointers)            # listed in the index block
        listed = sum(n for n, _, _ in supers[:inline])
        c = self.block(index, b"EAIB", int(filtered),
                       "extensible array index block", addr)
        segments = [(0, c.take(first * entry))]
        blocks = [c.addr() for _ in range(listed)]
        super_addrs = [c.addr() for _ in range(len(supers) - inline)]
        self.verify(self.base + index, c.pos, "extensible array index block")
        offset_size = (bits + 7) // 8
        page = 1 << page_bits
        for u, (n, size, start) in enumerate(supers):
            if start >= count:
                break
            if u < inline:
                at, written = blocks[:n], None
                blocks = blocks[n:]
            else:
                at, written = self._super_block(
                    super_addrs[u - inline], n, size, start - first, page,
                    offset_size, filtered, addr)
            if size > page and written is None:
                self.corrupt("a paged extensible array data block listed by "
                             "the index block")
            for d, block in enumerate(at):
                if block != self.undefined:
                    # HDF5 writes the offset of a data block the index
                    # block lists wrongly (the block's index among all the
                    # index block's, not its super block's); it reads none
                    segments += self._data_block(
                        block, size, start + d * size,
                        None if u < inline else start + d * size - first,
                        page, written and written[d], entry, offset_size,
                        filtered, addr)
        return self._entries(segments, entry, filtered, nbytes)

    def _super_block(self, addr: int, n: int, size: int, offset: int,
                     page: int, offset_size: int, filtered: bool,
                     header: int) -> Tuple[List[int], Optional[list]]:
        """A super block's data block addresses and, where its data blocks
        are paged, which pages of each were written (one bitmap over all
        its data blocks' pages, `H5EA__lookup_elmt`)."""
        if addr == self.undefined:
            return [self.undefined] * n, None
        c = self.block(addr, b"EASB", int(filtered),
                       "extensible array super block", header)
        if c.u(offset_size) != offset:
            self.corrupt(f"an extensible array super block at {addr} for "
                         f"another offset")
        written = None
        if size > page:
            pages = size // page
            bitmap = c.take(n * -(-pages // 8))
            bits = [bool(bitmap[i // 8] & 0x80 >> i % 8)
                    for i in range(n * pages)]
            written = [bits[d * pages:(d + 1) * pages] for d in range(n)]
        blocks = [c.addr() for _ in range(n)]
        self.verify(self.base + addr, c.pos, "extensible array super block")
        return blocks, written

    def _data_block(self, addr: int, size: int, start: int,
                    offset: Optional[int], page: int,
                    written: Optional[List[bool]], entry: int,
                    offset_size: int, filtered: bool,
                    header: int) -> List[Tuple[int, bytes]]:
        """The runs of elements (`_entries`) of the data block at `addr`
        that holds elements [start, start + size) (its pages `written`,
        where it is paged), its offset checked where `offset` is given."""
        c = self.block(addr, b"EADB", int(filtered),
                       "extensible array data block", header)
        stored = c.u(offset_size)
        if offset is not None and stored != offset:
            self.corrupt(f"an extensible array data block at {addr} for "
                         "another offset")
        if size <= page:
            raw = c.take(size * entry)
            self.verify(self.base + addr, c.pos, "extensible array data "
                        "block")
            return [(start, raw)]
        self.verify(self.base + addr, c.pos, "extensible array data block")
        c.pos += 4
        segments = []
        for p, done in enumerate(written):
            if done:
                at = c.pos
                segments.append((start + p * page, c.take(page * entry)))
                self.verify(at, c.pos, "extensible array data block page")
            else:                               # never written
                c.pos += page * entry
            c.pos += 4
        return segments

    def _unfilter(self, data: bytes, filters, mask: int) -> bytes:
        for i in reversed(range(len(filters))):
            if mask >> i & 1:
                continue
            fid, values = filters[i]
            if fid == 1:
                data = zlib.decompress(data)
            elif fid == 2:
                size = values[0]
                n = len(data) // size
                planes = np.frombuffer(data, np.uint8, n * size)
                data = (planes.reshape(size, n).T.tobytes()
                        + data[n * size:])
            elif fid == 3:
                stored = int.from_bytes(data[-4:], "little")
                data = data[:-4]
                if fletcher32(data) != stored:
                    self.corrupt("a chunk's fletcher32 checksum mismatch")
            else:
                self.unsupported(f"filter id {fid}")
        return data


class _FractalHeap:
    """The managed objects of a fractal heap (`FRHP`): its direct blocks
    (`FHDB`) laid out by a doubling table of `width` blocks a row under
    the root indirect block (`FHIB`) or as the root itself, each block's
    checksum verified when it is first read. Tiny objects are decoded from
    their IDs; huge objects and filtered heaps are refused."""

    def __init__(self, file: _File, addr: int):
        self.file, self.addr = file, addr
        c = file.block(addr, b"FRHP", None, "fractal heap header")
        self.id_size, filtered, self.flags = c.u(2), c.u(2), c.u(1)
        managed = c.u(4)                        # the largest managed object
        c.pos += 10 * file.lengths + 2 * file.offsets     # counters
        width, start, direct = c.u(2), c.length(), c.length()
        bits, _ = c.u(2), c.u(2)
        root, rows = c.addr(), c.u(2)
        if filtered:
            c.pos += file.lengths + 4 + filtered
        file.verify(file.base + addr, c.pos, "fractal heap header")
        if filtered:
            file.unsupported("a fractal heap with I/O filters")
        if start & start - 1 or direct & direct - 1 or width & width - 1 \
                or not start <= direct or not width:
            file.corrupt(f"a fractal heap of {width} blocks a row from "
                         f"{start} to {direct} bytes")
        self.offset_size = (bits + 7) // 8
        self.length_size = min((_log2(direct) + 7) // 8, _enc_size(managed))
        if 1 + self.offset_size + self.length_size > self.id_size:
            file.corrupt(f"{self.id_size}-byte fractal heap IDs")
        self.width, self.start = width, start
        self.direct_rows = _log2(direct) - _log2(start) + 2
        self.first_row_bits = _log2(start) + _log2(width)
        self.blocks: List[Tuple[int, int, int]] = []    # offset, addr, size
        self.checked: set = set()
        if rows:
            self._indirect(root, rows, 0)
        elif root != file.undefined:            # the root a direct block
            self.blocks.append((0, root, start))
        self.blocks.sort()
        self.starts = [b[0] for b in self.blocks]

    def _row_size(self, row: int) -> int:
        return self.start << max(row - 1, 0)

    def _indirect(self, addr: int, rows: int, offset: int) -> None:
        f = self.file
        c = f.block(addr, b"FHIB", None, "fractal heap indirect block",
                    self.addr)
        if c.u(self.offset_size) != offset:
            f.corrupt(f"a fractal heap block at {addr} for another offset")
        children = [(r, c.addr()) for r in range(rows)
                    for _ in range(self.width)]
        f.verify(f.base + addr, c.pos, "fractal heap indirect block")
        at = offset
        for row, child in children:
            size = self._row_size(row)
            if child != f.undefined and row < self.direct_rows:
                self.blocks.append((at, child, size))
            elif child != f.undefined:          # an indirect block's rows
                self._indirect(child, _log2(size) - self.first_row_bits + 1,
                               at)
            at += size

    def get(self, heap_id: bytes) -> bytes:
        """The object of the heap ID `heap_id`."""
        f = self.file
        if len(heap_id) != self.id_size or heap_id[0] >> 6:
            f.corrupt(f"a fractal heap ID {heap_id.hex()}")
        kind = heap_id[0] >> 4 & 3
        if kind == 2:                           # tiny: the object itself
            if self.id_size > 17:
                n = ((heap_id[0] & 15) << 8 | heap_id[1]) + 1
                return heap_id[2:2 + n]
            return heap_id[1:2 + (heap_id[0] & 15)]
        if kind != 0:
            f.unsupported("a huge fractal heap object (a link or attribute "
                          "larger than the heap's largest managed object)")
        c = f.cursor(1, heap_id)
        offset, size = c.u(self.offset_size), c.u(self.length_size)
        i = bisect.bisect_right(self.starts, offset) - 1
        if i < 0:
            f.corrupt(f"no fractal heap block holds offset {offset}")
        start, addr, block = self.blocks[i]
        head = 5 + f.offsets + self.offset_size + (4 if self.flags & 2 else 0)
        if offset - start < head or offset - start + size > block:
            f.corrupt(f"a fractal heap object of {size} bytes at {offset} "
                      f"outside its block")
        if addr not in self.checked:
            self._check_direct(addr, start, block)
            self.checked.add(addr)
        at = f.base + addr + offset - start
        return bytes(f.mm[at:at + size])

    def _check_direct(self, addr: int, offset: int, size: int) -> None:
        f = self.file
        c = f.block(addr, b"FHDB", None, "fractal heap direct block",
                    self.addr)
        if c.u(self.offset_size) != offset:
            f.corrupt(f"a fractal heap block at {addr} for another offset")
        if not self.flags & 2:
            return
        f._check_span(addr, size)
        image = bytearray(f.mm[f.base + addr:f.base + addr + size])
        stored = int.from_bytes(image[c.pos - f.base - addr:
                                      c.pos - f.base - addr + 4], "little")
        image[c.pos - f.base - addr:c.pos - f.base - addr + 4] = bytes(4)
        if lookup3(bytes(image)) != stored:
            f.corrupt(f"fractal heap direct block checksum mismatch at "
                      f"{addr}")


def _leaves(dtype: np.dtype, path: tuple = ()):
    """The paths of names to every field of `dtype` that has none."""
    if dtype.names is not None:
        for name in dtype.names:
            yield from _leaves(dtype.fields[name][0], path + (name,))
    elif dtype.subdtype is not None:
        yield from _leaves(dtype.subdtype[0], path)
    else:
        yield path


def _field(array: np.ndarray, path: tuple) -> np.ndarray:
    """The view of `array` at a path of field names."""
    for name in path:
        array = array[name]
    return array


def _grid_offsets(indices: List[int], chunk: Tuple[int, ...],
                  maxshape: Tuple) -> List[tuple]:
    """The offsets of the chunks of the given indices in a fixed or
    extensible array: HDF5 numbers the chunk grid of the maximum shape in
    row-major order with the unlimited dimension, if any, moved first (it
    "swizzles" it to the slowest position)."""
    rank = len(chunk)
    order = sorted(range(rank), key=lambda d: maxshape[d] is not None)
    counts = [-(-maxshape[d] // chunk[d]) for d in order[1:]]
    per = int(np.prod(counts))
    if not per or not indices:
        return []
    i = np.asarray(indices, np.int64)
    coords = [i // per] + (list(np.unravel_index(i % per, counts))
                           if counts else [])
    offsets = np.empty((len(i), rank), np.int64)
    for d, coord in zip(order, coords):
        offsets[:, d] = coord * chunk[d]
    return [tuple(o) for o in offsets.tolist()]


def _filled(shape: Tuple, dtype: np.dtype,
            fill: Optional[bytes]) -> np.ndarray:
    if not fill:
        return np.zeros(shape, dtype)
    out = np.empty(shape, dtype)
    out[...] = np.frombuffer(fill, dtype)[0]
    return out


def _null_terminate(strings: np.ndarray) -> None:
    """What HDF5 makes of null-terminated strings read as h5py reads them
    (null-padded): the bytes up to the first null."""
    raw = np.array(strings).view(np.uint8).reshape(
        strings.shape + (strings.dtype.itemsize,))
    raw[np.cumsum(raw == 0, axis=-1) > 0] = 0
    strings[...] = raw.view(strings.dtype).reshape(strings.shape)


def read_dataset(path: str, name: str) -> np.ndarray:
    """The dataset `name` ("radar_data", or "group/name") of the HDF5 file
    at `path`, as h5py's `f[name][()]` gives it (dtype and values)."""
    with open(path, "rb") as f:
        try:
            mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        except ValueError:
            raise ValueError(f"{path} is not an HDF5 file") from None
        with mm:
            return _File(path, f, mm).dataset(name)


# -- the writer ------------------------------------------------------------

_UNDEF = b"\xff" * 8


def _pad8(data: bytes) -> bytes:
    return data + bytes(-len(data) % 8)


def _type_message(dt: np.dtype) -> bytes:
    """A version 1 datatype message for a numeric, fixed-string or compound
    dtype (in its own byte order)."""
    big = 1 if dt.byteorder == ">" or (dt.byteorder == "="
                                       and sys.byteorder == "big") else 0
    if dt.names is not None:
        members = b""
        for name in dt.names:
            member, offset = dt.fields[name][:2]
            members += (_pad8(name.encode() + b"\0")
                        + struct.pack("<I28x", offset)
                        + _type_message(member))
        n = len(dt.names)
        return struct.pack("<BBBBI", 0x16, n & 0xFF, n >> 8, 0,
                           dt.itemsize) + members
    if dt.kind in "iu" and dt.itemsize in (1, 2, 4, 8):
        return struct.pack("<BBBBIHH", 0x10, big | (8 if dt.kind == "i"
                                                    else 0), 0, 0,
                           dt.itemsize, 0, 8 * dt.itemsize)
    if dt.kind == "f" and dt.itemsize in _IEEE:
        exponent, mantissa = _IEEE[dt.itemsize]
        bits = 8 * dt.itemsize
        return struct.pack("<BBBBIHHBBBBI", 0x11, big | 0x20, bits - 1, 0,
                           dt.itemsize, 0, bits, mantissa, exponent, 0,
                           mantissa, (1 << exponent - 1) - 1)
    if dt.kind == "S" and dt.itemsize:
        return struct.pack("<BBBBI", 0x13, 1, 0, 0, dt.itemsize)
    raise ValueError(f"cannot write the dtype {dt} (numeric, fixed-length "
                     "bytes and compounds of them only)")


def _object_header(messages: List[Tuple[int, int, bytes]]) -> bytes:
    body = b"".join(struct.pack("<HHB3x", mtype, len(_pad8(data)), flags)
                    + _pad8(data) for mtype, flags, data in messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


def write_datasets(path: str, arrays: Dict[str, np.ndarray]) -> None:
    """Writes each 1-D array of `arrays` (numeric, fixed-length bytes or a
    compound of them; 0 rows allowed) as a dataset of the root group, in
    the layout h5py writes by default: superblock v0, v1 object headers, a
    symbol-table root group, contiguous data. The same arrays give the
    same bytes."""
    names = sorted(arrays, key=str.encode)
    if not names:
        raise ValueError("nothing to write")
    for name in names:
        if not name or "/" in name:
            raise ValueError(f"cannot name a dataset {name!r}")
        if np.ndim(arrays[name]) != 1:
            raise ValueError(f"{name!r} is not a 1-D array")
    heap, offsets = bytes(8), []
    for name in names:
        offsets.append(len(heap))
        heap += _pad8(name.encode() + b"\0")
    leaf_k, internal_k = max(4, -(-len(names) // 2)), 16
    root = 96
    btree = root + 16 + 8 + 16
    heap_at = btree + 24 + 2 * internal_k * 8 + (2 * internal_k + 1) * 8
    snod = heap_at + 32 + len(heap)
    at = snod + 8 + 2 * leaf_k * 40
    entries, blobs = b"", []
    for name, offset in zip(names, offsets):
        arr = np.ascontiguousarray(arrays[name])
        dt = arr.dtype
        type_msg = _type_message(dt)
        messages = [(0x1, 0, struct.pack("<BBBB4xQQ", 1, 1, 1, 0, len(arr),
                                         len(arr))),
                    (0x3, 1, type_msg),
                    (0x5, 1, struct.pack("<BBBBI", 2, 2, 2, 1, 0)),
                    (0x8, 0, struct.pack("<BB", 3, 1) + bytes(16))]
        header_size = len(_object_header(messages))
        data_at = at + header_size if arr.size else None
        messages[-1] = (0x8, 0, struct.pack("<BB", 3, 1)
                        + (_UNDEF if data_at is None
                           else struct.pack("<Q", data_at))
                        + struct.pack("<Q", arr.nbytes))
        blobs += [_object_header(messages), arr.tobytes()]
        entries += struct.pack("<QQII16x", offset, at, 0, 0)
        at += header_size + arr.nbytes
    out = bytearray(SIGNATURE)
    out += struct.pack("<8BHHI", 0, 0, 0, 0, 0, 8, 8, 0, leaf_k, internal_k,
                       0)
    out += struct.pack("<Q", 0) + _UNDEF + struct.pack("<Q", at) + _UNDEF
    out += struct.pack("<QQII", 0, root, 1, 0) + struct.pack("<QQ", btree,
                                                             heap_at)
    out += _object_header([(0x11, 0, struct.pack("<QQ", btree, heap_at))])
    node = (b"TREE" + struct.pack("<BBH", 0, 0, 1) + _UNDEF + _UNDEF
            + struct.pack("<QQQ", 0, snod, offsets[-1]))
    out += node + bytes(heap_at - btree - len(node))
    out += b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap), 1, heap_at + 32)
    out += heap
    out += b"SNOD" + struct.pack("<BBH", 1, 0, len(names)) + entries
    out += bytes(snod + 8 + 2 * leaf_k * 40 - len(out))
    for blob in blobs:
        out += blob
    assert len(out) == at
    with open(path, "wb") as f:
        f.write(out)
