"""HDF5 files in numpy and the standard library, in place of h5py.

RadarScenes stores each sequence's tables (`radar_data`, `odometry`) in a
`radar_data.h5`. This module reads a dataset of such a file
(`read_dataset`) and writes the layout h5py writes by default
(`write_datasets`), so the dataset creation needs no h5py. It follows the
HDF5 file format specification (version 3.0) as far as h5py and HDF5 1.14
write it:

- superblocks v0-v3; v1 object headers (with continuation blocks) and v2
  ones (`OHDR`/`OCHK`), their checksums verified;
- symbol-table groups (a v1 B-tree of `SNOD` nodes over a local heap) and
  compact link messages;
- fixed-point, IEEE float, fixed-length string, compound (v1-v4) and enum
  datatypes, as the numpy dtype h5py gives (field names, formats, offsets
  and itemsize; the enum `FALSE`/`TRUE` as bool, the compound `r`/`i` as
  complex);
- compact, contiguous and chunked layouts: a v1 B-tree of chunks (layout
  v3), and the single-chunk, implicit and fixed-array indexes (layout v4);
  the deflate, shuffle and fletcher32 filters, under each chunk's filter
  mask; fill values where no data was written.

What else a file may hold (dense link storage, the extensible-array and
v2 B-tree chunk indexes, variable-length and array datatypes, external or
virtual storage, other filters) raises NotImplementedError naming the
feature and the file; a file that breaks the format raises ValueError.
Every call opens its file and keeps no state between calls.
"""

from __future__ import annotations

import mmap
import struct
import sys
import zlib
from typing import Dict, List, Optional, Tuple

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


class _File:
    """One open file (its metadata read through `mm`, contiguous data
    straight from `file`): its superblock's sizes and the parsers of its
    metadata. Addresses are relative to the superblock's base address."""

    def __init__(self, path: str, file, mm: mmap.mmap):
        self.path, self.file, self.mm = path, file, mm
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

    # -- groups -----------------------------------------------------------

    def links(self, messages) -> Dict[str, Optional[int]]:
        """A group's links: name -> object header address (None for a
        soft or external link)."""
        links: Dict[str, Optional[int]] = {}
        for mtype, _, data in messages:
            c = self.cursor(0, data)
            if mtype == 0x11:
                btree, heap = c.addr(), c.addr()
                self._symbol_table(btree, self._heap(heap), links)
            elif mtype == 0x02:
                c.pos += 1
                tracked = c.u(1) & 1
                c.pos += 8 if tracked else 0
                if c.addr() != self.undefined:
                    self.unsupported("dense link storage (a group's links "
                                     "in a fractal heap)")
            elif mtype == 0x06:
                c.pos += 1
                flags = c.u(1)
                kind = c.u(1) if flags & 0x08 else 0
                c.pos += (8 if flags & 0x04 else 0) + (1 if flags & 0x10
                                                       else 0)
                name = c.take(c.u(1 << (flags & 3))).decode()
                links[name] = c.addr() if kind == 0 else None
        return links

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
            links = self.links(self.messages(addr))
            if part not in links:
                raise KeyError(f"{self.path}: no object named {name!r}")
            if links[part] is None:
                self.unsupported(f"the soft or external link {name!r}")
            addr = links[part]
        return addr

    # -- datasets ---------------------------------------------------------

    def datatype(self, c: _Cursor) -> Tuple[np.dtype, List[tuple]]:
        """The dtype h5py gives the datatype at `c`, and the fields (paths
        of names) that hold null-terminated strings."""
        head = c.u(1)
        cls, version = head & 15, head >> 4
        bits, size = c.u(3), c.u(4)
        order = ">" if bits & 1 else "<"
        if cls == 0:
            c.pos += 4
            if size not in (1, 2, 4, 8):
                self.unsupported(f"a {size}-byte integer")
            return np.dtype(f"{order}{'i' if bits & 8 else 'u'}{size}"), []
        if cls == 1:
            c.pos += 5
            exponent = c.u(1)
            c.pos += 1
            mantissa = c.u(1)
            c.pos += 4
            if bits & 0x40 or _IEEE.get(size) != (exponent, mantissa):
                self.unsupported(f"a {size}-byte float that is not IEEE "
                                 "754 in little- or big-endian order")
            return np.dtype(f"{order}f{size}"), []
        if cls == 3:
            if bits & 15 not in (0, 1):
                self.unsupported("a space-padded string")
            return np.dtype(f"S{size}"), ([()] if bits & 15 == 0 else [])
        if cls == 6:
            return self._compound(c, version, bits & 0xFFFF, size)
        if cls == 8:
            base, _ = self.datatype(c)
            names = [c.name(8 if version < 3 else 1)
                     for _ in range(bits & 0xFFFF)]
            values = np.frombuffer(c.take(len(names) * base.itemsize), base)
            if dict(zip(names, values.tolist())) == {"FALSE": 0, "TRUE": 1}:
                return np.dtype(bool), []
            return base, []
        self.unsupported(f"the {_DATATYPE_CLASSES[cls]} datatype"
                         if cls < len(_DATATYPE_CLASSES)
                         else f"datatype class {cls}")

    def _compound(self, c: _Cursor, version: int, n: int,
                  size: int) -> Tuple[np.dtype, List[tuple]]:
        names, formats, offsets, nullterm = [], [], [], []
        for _ in range(n):
            names.append(c.name(8 if version < 3 else 1))
            if version < 3:
                offsets.append(c.u(4))
            else:
                offsets.append(c.u((size.bit_length() - 1) // 8 + 1))
            if version == 1:
                dims = c.u(1)
                c.pos += 27
                if dims:
                    self.unsupported("a compound member with dimensions")
            member, strings = self.datatype(c)
            formats.append(member)
            nullterm += [(names[-1],) + p for p in strings]
        if (names == ["r", "i"] and formats[0] == formats[1]
                and formats[0].kind == "f"
                and offsets == [0, formats[0].itemsize]
                and size == 2 * formats[0].itemsize):
            return np.dtype(f"{formats[0].byteorder}c{size}"
                            .replace("=", "")), []
        return np.dtype({"names": names, "formats": formats,
                         "offsets": offsets, "itemsize": size}), nullterm

    def dataset(self, name: str) -> np.ndarray:
        shape = dtype = layout = None
        maxshape: Tuple = ()
        filters: List[Tuple[int, List[int]]] = []
        fill: Optional[bytes] = None
        nullterm: List[tuple] = []
        for mtype, mflags, data in self.messages(self.find(name)):
            if mflags & 0x02 and mtype in (0x1, 0x3, 0x4, 0x5, 0x8, 0xB):
                self.unsupported(f"a shared message of type {mtype:#x}")
            c = self.cursor(0, data)
            if mtype == 0x1:
                shape, maxshape = self._dataspace(c)
            elif mtype == 0x3:
                dtype, nullterm = self.datatype(c)
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
        if fill and len(fill) != dtype.itemsize:
            self.corrupt(f"{name!r}: a {len(fill)}-byte fill value")
        out = self._read(layout, shape, dtype, fill, maxshape or shape,
                         filters)
        for path in nullterm:
            strings = out
            for field in path:
                strings = strings[field]        # a view into `out`
            _null_terminate(strings)
        return out

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
            if index not in (1, 2, 3):
                self.unsupported(
                    f"the {CHUNK_INDEXES.get(index, index)} chunk index "
                    f"(layout v4 index type {index})")
            info = (c.length(), c.u(4)) if index == 1 and flags & 2 else \
                c.u(1) if index == 3 else None
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
        else:
            grid = [-(-m // k) for m, k in zip(maxshape, chunk)]
            if index == 2:
                entries = [(addr + i * nbytes, nbytes, 0)
                           for i in range(int(np.prod(grid)))]
            else:
                entries = self._fixed_array(addr, info, nbytes)
            chunks = [(tuple(int(s) * k for s, k in
                             zip(np.unravel_index(i, grid), chunk)), a, n, m)
                      for i, (a, n, m) in enumerate(entries)
                      if a != self.undefined]
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

    def _fixed_array(self, addr: int, page_bits: int,
                     nbytes: int) -> List[tuple]:
        """The (address, size, filter mask) entries of a fixed array
        (unfiltered chunks are `nbytes` long)."""
        c = self.signature(addr, b"FAHD")
        c.pos += 1
        filtered, entry, bits = c.u(1), c.u(1), c.u(1)
        count, block = c.length(), c.addr()
        self.verify(self.base + addr, c.pos, "fixed array header")
        if bits != page_bits:
            self.corrupt(f"fixed array page bits {bits}, layout {page_bits}")
        c = self.signature(block, b"FADB")
        c.pos += 2 + self.offsets
        per_page = 1 << bits
        if count <= per_page:
            raw = c.take(count * entry)
            self.verify(self.base + block, c.pos, "fixed array data block")
        else:
            pages = -(-count // per_page)
            bitmap = c.take(-(-pages // 8))
            self.verify(self.base + block, c.pos, "fixed array data block")
            c.pos += 4
            parts = []
            for p in range(pages):
                n = min(per_page, count - p * per_page)
                start = c.pos
                page = c.take(n * entry)
                if bitmap[p // 8] & 0x80 >> p % 8:
                    self.verify(start, c.pos, "fixed array page")
                    parts.append(page)
                else:                           # never written: undefined
                    parts.append(b"\xff" * len(page))
                c.pos += 4
            raw = b"".join(parts)
        entries = []
        size_bytes = entry - self.offsets - 4
        for i in range(count):
            e = self.cursor(i * entry, raw)
            at = e.addr()
            entries.append((at, e.u(size_bytes), e.u(4)) if filtered
                           else (at, nbytes, 0))
        return entries

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
