"""Zstandard frames (RFC 8878) in numpy and the standard library.

The orbax checkpoint layout compresses every zarr chunk and every OCDBT
node with zstd. This module reads any frame a conforming encoder writes
without a dictionary (`decompress`, `decompress_many`):

- frames back to back, skippable frames among them;
- raw, RLE and compressed blocks (at most 128 KiB each);
- literals raw, RLE, Huffman-coded in 1 or 4 streams, or treeless (the
  frame's previous Huffman table);
- sequences under predefined, RLE, FSE-described and repeated tables, the
  three repeat offsets with their `literal_length == 0` rule;
- the optional XXH64 content checksum, checked where the frame has one.

It writes one frame an input (`compress`), each 32 KiB piece the smallest
of a raw block, an RLE block (one byte repeated) and a compressed block:
the literals Huffman-coded (a length-limited code of at most 11 bits,
its weights FSE-compressed, in four streams; a later block reuses the
frame's table as treeless literals), the runs of a repeated 4 or 8 bytes
as a few long sequences under the predefined FSE tables. Matches are
kept few because the decoder spends a Python step on each sequence. Any
zstd decoder reads the frames, and the values stay bit for bit.

The Huffman streams of every compressed block of every input are decoded
together, one numpy step a symbol position across all streams (11-bit
table lookups); the FSE sequence streams are decoded one sequence at a
time, one table lookup a state. A frame that names a dictionary raises
ValueError saying so; so does corrupt or truncated input: the decoder
never returns wrong bytes without raising.
"""

from __future__ import annotations

import heapq
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

MAGIC = 0xFD2FB528
_MAGIC_BYTES = struct.pack("<I", MAGIC)
_SKIPPABLE = 0x184D2A50          # to 0x184D2A5F
BLOCK_MAX = 1 << 17
_HUF_BITS = 11                   # Huffman codes are at most 11 bits long
_RAW, _RLE, _COMPRESSED = 0, 1, 2
_TREELESS = 3                    # literals under the frame's last table

# literal-length and match-length codes: (baseline, extra bits)
_LL = [(i, 0) for i in range(16)] + [
    (16, 1), (18, 1), (20, 1), (22, 1), (24, 2), (28, 2), (32, 3), (40, 3),
    (48, 4), (64, 6), (128, 7), (256, 8), (512, 9), (1024, 10), (2048, 11),
    (4096, 12), (8192, 13), (16384, 14), (32768, 15), (65536, 16)]
_ML = [(i + 3, 0) for i in range(32)] + [
    (35, 1), (37, 1), (39, 1), (41, 1), (43, 2), (47, 2), (51, 3), (59, 3),
    (67, 4), (83, 4), (99, 5), (131, 7), (259, 8), (515, 9), (1027, 10),
    (2051, 11), (4099, 12), (8195, 13), (16387, 14), (32771, 15),
    (65539, 16)]
_OF_MAX = 31
# the predefined distributions: (accuracy log, normalized counts)
_PREDEFINED = {
    "ll": (6, [4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2,
               2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1]),
    "ml": (6, [1, 4, 3, 2, 2, 2, 2, 2, 2] + [1] * 37 + [-1] * 7),
    "of": (5, [1, 1, 1, 1, 1, 1, 2, 2, 2] + [1] * 15 + [-1] * 5)}
# per kind: (largest symbol, largest accuracy log)
_LIMITS = {"ll": (35, 9), "ml": (52, 9), "of": (_OF_MAX, 8)}


def _corrupt(what: str) -> ValueError:
    return ValueError(f"corrupt zstd input: {what}")


# -- XXH64, the frames' content checksum ----------------------------------

_M64 = (1 << 64) - 1
_P1, _P2, _P3 = 0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9
_P4, _P5 = 0x85EBCA77C2B2AE63, 0x27D4EB2F165667C5


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, lane: int) -> int:
    return _rotl((acc + lane * _P2) & _M64, 31) * _P1 & _M64


def xxh64(data: bytes, seed: int = 0) -> int:
    """XXH64 of `data` (the zstd content checksum is its low 32 bits)."""
    n = len(data)
    pos = 0
    if n >= 32:
        v = [(seed + _P1 + _P2) & _M64, (seed + _P2) & _M64, seed,
             (seed - _P1) & _M64]
        stripes = n // 32
        for a, b, c, d in struct.iter_unpack("<4Q", data[:stripes * 32]):
            v = [_round(v[0], a), _round(v[1], b), _round(v[2], c),
                 _round(v[3], d)]
        pos = stripes * 32
        h = (_rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12)
             + _rotl(v[3], 18)) & _M64
        for x in v:
            h = ((h ^ _round(0, x)) * _P1 + _P4) & _M64
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while pos + 8 <= n:
        (k,) = struct.unpack_from("<Q", data, pos)
        h = (_rotl(h ^ _round(0, k), 27) * _P1 + _P4) & _M64
        pos += 8
    if pos + 4 <= n:
        (k,) = struct.unpack_from("<I", data, pos)
        h = (_rotl(h ^ (k * _P1 & _M64), 23) * _P2 + _P3) & _M64
        pos += 4
    for byte in data[pos:]:
        h = _rotl(h ^ (byte * _P5 & _M64), 11) * _P1 & _M64
    h ^= h >> 33
    h = h * _P2 & _M64
    h ^= h >> 29
    h = h * _P3 & _M64
    return h ^ (h >> 32)


# -- bit streams ----------------------------------------------------------

class _Backward:
    """A bit stream read from its last bit towards its first, as zstd's
    Huffman, FSE and sequence streams are: the highest set bit of the last
    byte marks the end, and the bits below it are read high to low."""

    def __init__(self, data: bytes):
        if not data or data[-1] == 0:
            raise _corrupt("a bit stream lacks its end mark")
        self.data = data
        self.pos = (len(data) - 1) * 8 + data[-1].bit_length() - 1

    def read(self, n: int) -> int:
        """The next `n` bits; bits past the stream's start read as zeros,
        and `pos` goes negative (an overflow the caller checks)."""
        if n == 0:
            return 0
        self.pos -= n
        pos = self.pos
        if pos >= 0:
            i = pos >> 3
            return (int.from_bytes(self.data[i:i + 8], "little")
                    >> (pos & 7)) & ((1 << n) - 1)
        if pos + n <= 0:
            return 0
        return (int.from_bytes(self.data[:8], "little") << -pos) \
            & ((1 << n) - 1)


def _read_ncount(data: bytes, pos: int, end: int, max_symbol: int,
                 max_log: int) -> Tuple[int, List[int], int]:
    """An FSE table description at `data[pos:end]`: (accuracy log,
    normalized counts with -1 for "less than one", the position after
    it)."""
    bit = pos * 8
    limit = end * 8

    def peek(n):
        i = bit >> 3
        return (int.from_bytes(data[i:min(i + 8, end)], "little")
                >> (bit & 7)) & ((1 << n) - 1)

    log = peek(4) + 5
    bit += 4
    if log > max_log:
        raise _corrupt(f"an FSE accuracy log of {log} (at most {max_log})")
    remaining = (1 << log) + 1
    threshold = 1 << log
    nbits = log + 1
    counts: List[int] = []
    previous0 = False
    while remaining > 1 and len(counts) <= max_symbol:
        if previous0:
            n0 = len(counts)
            while True:
                repeat = peek(2)
                bit += 2
                n0 += repeat
                if repeat != 3:
                    break
            if n0 > max_symbol:
                raise _corrupt("an FSE table past its largest symbol")
            counts.extend([0] * (n0 - len(counts)))
        most = 2 * threshold - 1 - remaining
        low = peek(nbits - 1)
        if low < most:
            count = low
            bit += nbits - 1
        else:
            count = peek(nbits)
            if count >= threshold:
                count -= most
            bit += nbits
        count -= 1
        remaining -= -count if count < 0 else count
        counts.append(count)
        previous0 = count == 0
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
        if bit > limit:
            raise _corrupt("a truncated FSE table description")
    if remaining != 1:
        raise _corrupt("FSE probabilities that do not sum to the table")
    return log, counts, (bit + 7) >> 3


class _Fse:
    """An FSE decoding table: per state its symbol, the bits its update
    reads and the base the bits are added to."""

    __slots__ = ("log", "symbol", "nbits", "base")

    def __init__(self, log: int, counts: Sequence[int]):
        size = 1 << log
        symbol = [0] * size
        high = size - 1
        nxt = list(counts)
        for s, c in enumerate(counts):
            if c == -1:
                symbol[high] = s
                high -= 1
                nxt[s] = 1
        step = (size >> 1) + (size >> 3) + 3
        mask = size - 1
        p = 0
        for s, c in enumerate(counts):
            for _ in range(max(c, 0)):
                symbol[p] = s
                p = (p + step) & mask
                while p > high:
                    p = (p + step) & mask
        if p != 0:
            raise _corrupt("an FSE table whose symbols do not fill it")
        nbits = [0] * size
        base = [0] * size
        for u in range(size):
            x = nxt[symbol[u]]
            nxt[symbol[u]] = x + 1
            n = log - (x.bit_length() - 1)
            nbits[u] = n
            base[u] = (x << n) - size
        self.log, self.symbol, self.nbits, self.base = log, symbol, nbits, \
            base

    @classmethod
    def rle(cls, symbol: int) -> "_Fse":
        table = cls.__new__(cls)
        table.log, table.symbol, table.nbits, table.base = 0, [symbol], [0], \
            [0]
        return table


_PREDEFINED_TABLES = {kind: _Fse(*table)
                      for kind, table in _PREDEFINED.items()}


# -- Huffman tables -------------------------------------------------------

def _huffman_weights(data: bytes, pos: int, end: int) -> Tuple[List[int],
                                                                int]:
    """The Huffman tree description at `data[pos:end]`: the weights of
    every symbol but the last, and the position after it."""
    if pos >= end:
        raise _corrupt("a truncated Huffman tree description")
    header = data[pos]
    pos += 1
    if header >= 128:
        n = header - 127
        size = (n + 1) // 2
        if pos + size > end:
            raise _corrupt("a truncated Huffman tree description")
        raw = data[pos:pos + size]
        weights = [(raw[i >> 1] >> 4) if i % 2 == 0 else raw[i >> 1] & 15
                   for i in range(n)]
        return weights, pos + size
    if pos + header > end or header == 0:
        raise _corrupt("a truncated Huffman tree description")
    log, counts, start = _read_ncount(data, pos, pos + header, 12, 6)
    table = _Fse(log, counts)
    stream = _Backward(data[start:pos + header])
    s1, s2 = stream.read(log), stream.read(log)
    weights: List[int] = []
    states = [s1, s2]
    turn = 0
    while True:
        state = states[turn]
        weights.append(table.symbol[state])
        states[turn] = table.base[state] + stream.read(table.nbits[state])
        if stream.pos < 0:
            weights.append(table.symbol[states[1 - turn]])
            break
        turn = 1 - turn
        if len(weights) > 255:
            raise _corrupt("more than 255 Huffman weights")
    return weights, pos + header


def _huffman_table(weights: List[int]) -> Tuple[np.ndarray, np.ndarray]:
    """The decoding table of the weights (the last one implied), indexed
    by the next 11 bits of the stream: (symbols, code lengths)."""
    if any(w > _HUF_BITS for w in weights) or len(weights) > 255:
        raise _corrupt("a Huffman weight past 11 bits")
    total = sum(1 << (w - 1) for w in weights if w)
    if total == 0:
        raise _corrupt("a Huffman tree without weights")
    max_bits = total.bit_length()
    rest = (1 << max_bits) - total
    if max_bits > _HUF_BITS or rest & (rest - 1):
        raise _corrupt("Huffman weights that do not complete a tree")
    w = np.asarray(weights + [rest.bit_length()], np.int64)
    symbols = np.nonzero(w)[0]
    order = symbols[np.argsort(w[symbols], kind="stable")]
    spans = (1 << w[order]) >> 1
    sym = np.repeat(order.astype(np.uint8), spans)
    nbits = np.repeat((max_bits + 1 - w[order]).astype(np.int64), spans)
    scale = 1 << (_HUF_BITS - max_bits)
    return np.repeat(sym, scale), np.repeat(nbits, scale)


class _Lanes:
    """The Huffman streams of every block to decode, gathered so that one
    pass decodes them together."""

    def __init__(self):
        self.tables_sym: List[np.ndarray] = []
        self.tables_nbits: List[np.ndarray] = []
        self.chunks: List[bytes] = []
        self.size = 0
        # (table, first bit, end bit, symbols, output offset) a stream
        self.lanes: List[Tuple[int, int, int, int, int]] = []
        self.out_size = 0

    def table(self, weights: List[int]) -> int:
        sym, nbits = _huffman_table(weights)
        self.tables_sym.append(sym)
        self.tables_nbits.append(nbits)
        return len(self.tables_sym) - 1

    def add(self, table: int, stream: bytes, count: int) -> int:
        """Queues a stream of `count` symbols; returns where its symbols
        will start in the output."""
        if not stream or stream[-1] == 0:
            raise _corrupt("a Huffman stream lacks its end mark")
        self.chunks.append(bytes(8))
        self.size += 8
        start_bit = self.size * 8
        end_bit = start_bit + (len(stream) - 1) * 8 \
            + stream[-1].bit_length() - 1
        self.chunks.append(bytes(stream))
        self.size += len(stream)
        out = self.out_size
        self.lanes.append((table, start_bit, end_bit, count, out))
        self.out_size += count
        return out

    def decode(self) -> np.ndarray:
        out = np.zeros(self.out_size, np.uint8)
        if not self.lanes:
            return out
        buf = np.frombuffer(b"".join(self.chunks) + bytes(8), np.uint8)
        b32 = buf.astype(np.uint32)
        word = (b32[:-3] | (b32[1:-2] << 8) | (b32[2:-1] << 16)
                | (b32[3:] << 24))
        sym = np.concatenate(self.tables_sym)
        nbits = np.concatenate(self.tables_nbits)
        lanes = np.asarray(self.lanes, np.int64)
        lanes = lanes[np.argsort(-lanes[:, 3], kind="stable")]
        base = lanes[:, 0] << _HUF_BITS
        floor = lanes[:, 1]
        pos = lanes[:, 2].copy()
        counts = lanes[:, 3]
        dest = lanes[:, 4]
        # lanes still decoding at step i: a prefix, counts descending
        active = np.searchsorted(-counts, -np.arange(int(counts[0])),
                                 side="left")
        mask = (1 << _HUF_BITS) - 1
        try:
            for i in range(int(counts[0])):
                k = active[i]
                p = pos[:k]
                b = p - _HUF_BITS
                t = base[:k] + ((word[b >> 3] >> (b & 7)) & mask)
                out[dest[:k] + i] = sym[t]
                p -= nbits[t]
        except IndexError:
            raise _corrupt("a Huffman stream read past its start") from None
        if not np.array_equal(pos, floor):
            raise _corrupt("a Huffman stream not consumed to its start")
        return out


# -- frames ---------------------------------------------------------------

class _Frame:
    """One frame's parsed blocks, to be executed once the Huffman streams
    are decoded."""

    def __init__(self, window: int, content_size: Optional[int],
                 checksum: bool):
        self.window = window
        self.block_max = min(window, BLOCK_MAX)
        self.content_size = content_size
        self.checksum: Optional[int] = None
        self.has_checksum = checksum
        # (kind, payload): raw bytes, (byte, n), or (literals, sequences)
        self.blocks: List[Tuple] = []
        self.huffman: Optional[int] = None
        self.tables: Dict[str, Optional[_Fse]] = {"ll": None, "of": None,
                                                  "ml": None}


def _u(data: bytes, pos: int, n: int) -> int:
    if pos + n > len(data):
        raise _corrupt("truncated input")
    return int.from_bytes(data[pos:pos + n], "little")


def _parse(data: bytes, lanes: _Lanes) -> List[_Frame]:
    frames = []
    pos = 0
    while pos < len(data):
        magic = _u(data, pos, 4)
        if magic & 0xFFFFFFF0 == _SKIPPABLE:
            pos += 8 + _u(data, pos + 4, 4)
            if pos > len(data):
                raise _corrupt("a truncated skippable frame")
            continue
        if magic != MAGIC:
            raise _corrupt(f"not a zstd frame (magic {magic:#010x})")
        frame, pos = _parse_frame(data, pos + 4, lanes)
        frames.append(frame)
    return frames


def _parse_frame(data: bytes, pos: int, lanes: _Lanes) -> Tuple[_Frame,
                                                                 int]:
    fhd = _u(data, pos, 1)
    pos += 1
    single = fhd >> 5 & 1
    if fhd >> 3 & 1:
        raise _corrupt("a frame header with its reserved bit set")
    window = 0
    if not single:
        wd = _u(data, pos, 1)
        pos += 1
        base = 1 << (10 + (wd >> 3))
        window = base + (base >> 3) * (wd & 7)
    did_size = (0, 1, 2, 4)[fhd & 3]
    dictionary = _u(data, pos, did_size) if did_size else 0
    pos += did_size
    if dictionary:
        raise ValueError(f"the zstd frame names dictionary {dictionary}; "
                         "frames that need a dictionary are not supported")
    fcs_size = (1 if single else 0, 2, 4, 8)[fhd >> 6]
    content_size = None
    if fcs_size:
        content_size = _u(data, pos, fcs_size) + (256 if fcs_size == 2
                                                  else 0)
        pos += fcs_size
    if single:
        window = content_size
    frame = _Frame(window, content_size, bool(fhd >> 2 & 1))
    while True:
        header = _u(data, pos, 3)
        pos += 3
        last, kind, size = header & 1, header >> 1 & 3, header >> 3
        if kind == _RLE:
            if size > frame.block_max:
                raise _corrupt("an RLE block larger than the block limit")
            frame.blocks.append((_RLE, (_u(data, pos, 1), size)))
            pos += 1
        elif kind == _RAW:
            if size > frame.block_max or pos + size > len(data):
                raise _corrupt("a truncated or oversized raw block")
            frame.blocks.append((_RAW, data[pos:pos + size]))
            pos += size
        elif kind == _COMPRESSED:
            if size > frame.block_max or pos + size > len(data):
                raise _corrupt("a truncated or oversized compressed block")
            frame.blocks.append((_COMPRESSED, _parse_block(
                data, pos, pos + size, frame, lanes)))
            pos += size
        else:
            raise _corrupt("a block of the reserved type")
        if last:
            break
    if frame.has_checksum:
        frame.checksum = _u(data, pos, 4)
        pos += 4
    return frame, pos


def _parse_block(data: bytes, pos: int, end: int, frame: _Frame,
                 lanes: _Lanes) -> Tuple:
    """A compressed block: (literals, sequences), the literals as bytes or
    as (output offset, size) of the queued Huffman streams."""
    if pos >= end:
        raise _corrupt("an empty compressed block")
    b0 = data[pos]
    kind, size_format = b0 & 3, b0 >> 2 & 3
    if kind in (_RAW, _RLE):
        if size_format in (0, 2):
            regen, pos = b0 >> 3, pos + 1
        elif size_format == 1:
            regen, pos = (b0 >> 4) + (_u(data, pos + 1, 1) << 4), pos + 2
        else:
            regen, pos = (b0 >> 4) + (_u(data, pos + 1, 2) << 4), pos + 3
        if regen > frame.block_max:
            raise _corrupt("literals larger than the block limit")
        if kind == _RAW:
            if pos + regen > end:
                raise _corrupt("truncated raw literals")
            literals = data[pos:pos + regen]
            pos += regen
        else:
            if pos >= end:
                raise _corrupt("truncated RLE literals")
            literals = bytes([data[pos]]) * regen
            pos += 1
    else:
        header_size = (3, 3, 4, 5)[size_format]
        h = _u(data, pos, header_size)
        bits = (10, 10, 14, 18)[size_format]
        regen = (h >> 4) & ((1 << bits) - 1)
        compressed = (h >> (4 + bits)) & ((1 << bits) - 1)
        pos += header_size
        lit_end = pos + compressed
        if regen > frame.block_max or lit_end > end:
            raise _corrupt("truncated or oversized Huffman literals")
        if kind == _COMPRESSED:
            weights, pos = _huffman_weights(data, pos, lit_end)
            frame.huffman = lanes.table(weights)
        elif frame.huffman is None:
            raise _corrupt("treeless literals before any Huffman table")
        if size_format == 0:
            start = lanes.add(frame.huffman, data[pos:lit_end], regen)
        else:
            if pos + 6 > lit_end:
                raise _corrupt("a truncated jump table")
            s1, s2, s3 = struct.unpack_from("<3H", data, pos)
            pos += 6
            s4 = lit_end - pos - s1 - s2 - s3
            seg = (regen + 3) // 4
            if s4 < 1 or regen - 3 * seg < 0:
                raise _corrupt("a jump table past the literals")
            start = None
            for n, count in ((s1, seg), (s2, seg), (s3, seg),
                             (s4, regen - 3 * seg)):
                out = lanes.add(frame.huffman, data[pos:pos + n], count)
                start = out if start is None else start
                pos += n
        literals = (start, regen)
        pos = lit_end
    return literals, _parse_sequences(data, pos, end, frame)


def _parse_sequences(data: bytes, pos: int, end: int,
                     frame: _Frame) -> List[Tuple[int, int, int]]:
    """The block's sequences as (literal length, match length, offset
    value) triples."""
    n = _u(data, pos, 1)
    if n == 0:
        if pos + 1 != end:
            raise _corrupt("bytes after a block without sequences")
        return []
    if n < 128:
        pos += 1
    elif n < 255:
        n = ((n - 128) << 8) + _u(data, pos + 1, 1)
        pos += 2
    else:
        n = _u(data, pos + 1, 2) + 0x7F00
        pos += 3
    modes = _u(data, pos, 1)
    pos += 1
    if modes & 3:
        raise _corrupt("sequence modes with their reserved bits set")
    for kind, shift in (("ll", 6), ("of", 4), ("ml", 2)):
        mode = modes >> shift & 3
        max_symbol, max_log = _LIMITS[kind]
        if mode == 0:
            frame.tables[kind] = _PREDEFINED_TABLES[kind]
        elif mode == 1:
            symbol = _u(data, pos, 1)
            pos += 1
            if symbol > max_symbol:
                raise _corrupt(f"an RLE {kind} symbol of {symbol}")
            frame.tables[kind] = _Fse.rle(symbol)
        elif mode == 2:
            log, counts, pos = _read_ncount(data, pos, end, max_symbol,
                                            max_log)
            frame.tables[kind] = _Fse(log, counts)
        elif frame.tables[kind] is None:
            raise _corrupt(f"a repeated {kind} table before any table")
    if pos >= end:
        raise _corrupt("a block without its sequence stream")
    ll_t, of_t, ml_t = (frame.tables[k] for k in ("ll", "of", "ml"))
    stream = _Backward(data[pos:end])
    ll_s, of_s, ml_s = (stream.read(t.log) for t in (ll_t, of_t, ml_t))
    data, pos = stream.data, stream.pos
    ll_sym, ll_nb, ll_base = ll_t.symbol, ll_t.nbits, ll_t.base
    ml_sym, ml_nb, ml_base = ml_t.symbol, ml_t.nbits, ml_t.base
    of_sym, of_nb, of_base = of_t.symbol, of_t.nbits, of_t.base
    seqs = []
    # a sequence's extra bits (offset, match, literal length, read high to
    # low) in one read, then its three state updates (literal length,
    # match length, offset) in another
    for i in range(n):
        of_code = of_sym[of_s]
        ml_first, ml_bits = _ML[ml_sym[ml_s]]
        ll_first, ll_bits = _LL[ll_sym[ll_s]]
        if of_code > _OF_MAX:
            raise _corrupt(f"an offset code of {of_code}")
        pos -= of_code + ml_bits + ll_bits
        if pos < 0:
            raise _corrupt("a sequence stream read past its start")
        v = int.from_bytes(data[pos >> 3:(pos >> 3) + 9], "little") \
            >> (pos & 7)
        ll = ll_first + (v & ((1 << ll_bits) - 1))
        v >>= ll_bits
        ml = ml_first + (v & ((1 << ml_bits) - 1))
        seqs.append((ll, ml, (1 << of_code) + ((v >> ml_bits)
                                                & ((1 << of_code) - 1))))
        if i == n - 1:
            break
        nl, nm, no = ll_nb[ll_s], ml_nb[ml_s], of_nb[of_s]
        pos -= nl + nm + no
        if pos < 0:
            raise _corrupt("a sequence stream read past its start")
        v = int.from_bytes(data[pos >> 3:(pos >> 3) + 5], "little") \
            >> (pos & 7)
        of_s = of_base[of_s] + (v & ((1 << no) - 1))
        v >>= no
        ml_s = ml_base[ml_s] + (v & ((1 << nm) - 1))
        ll_s = ll_base[ll_s] + ((v >> nm) & ((1 << nl) - 1))
    if pos != 0:
        raise _corrupt("a sequence stream not consumed to its start")
    return seqs


def _execute(frame: _Frame, lits: np.ndarray) -> bytes:
    out = bytearray()
    reps = [1, 4, 8]
    for kind, payload in frame.blocks:
        start = len(out)
        if kind == _RAW:
            out += payload
        elif kind == _RLE:
            out += bytes([payload[0]]) * payload[1]
        else:
            literals, seqs = payload
            if isinstance(literals, tuple):
                at, size = literals
                literals = lits[at:at + size].tobytes()
            lp, n_lit, size = 0, len(literals), len(out)
            for ll, ml, value in seqs:
                if ll:
                    if lp + ll > n_lit:
                        raise _corrupt("sequences past the block's "
                                       "literals")
                    out += literals[lp:lp + ll]
                    lp += ll
                    size += ll
                if value > 3:
                    off = value - 3
                    reps = [off, reps[0], reps[1]]
                else:
                    idx = value - 1 + (ll == 0)
                    if idx == 0:
                        off = reps[0]
                    elif idx == 1:
                        off = reps[1]
                        reps = [off, reps[0], reps[2]]
                    elif idx == 2:
                        off = reps[2]
                        reps = [off, reps[0], reps[1]]
                    else:
                        off = reps[0] - 1
                        reps = [off, reps[0], reps[1]]
                if off == 0 or off > size:
                    raise _corrupt(f"a match offset of {off} past the "
                                   "frame's start")
                at = size - off
                if off >= ml:
                    out += out[at:at + ml]
                else:
                    out += (out[at:] * (ml // off + 1))[:ml]
                size += ml
            out += literals[lp:]
        if len(out) - start > frame.block_max:
            raise _corrupt("a block larger than the block limit")
    if frame.content_size is not None and len(out) != frame.content_size:
        raise _corrupt(f"{len(out)} bytes where the frame declares "
                       f"{frame.content_size}")
    if frame.checksum is not None \
            and xxh64(bytes(out)) & 0xFFFFFFFF != frame.checksum:
        raise _corrupt("the content checksum does not match")
    return bytes(out)


def decompress_many(inputs: Sequence[bytes]) -> List[bytes]:
    """Each input (one or more frames back to back) decompressed; the
    Huffman streams of all of them are decoded in one pass."""
    lanes = _Lanes()
    parsed = [_parse(bytes(data), lanes) for data in inputs]
    lits = lanes.decode()
    return [b"".join(_execute(f, lits) for f in frames)
            for frames in parsed]


def decompress(data: bytes) -> bytes:
    """The content of `data`: zstd frames back to back (skippable frames
    among them contribute nothing)."""
    return decompress_many([data])[0]


# -- the encoder ----------------------------------------------------------

# The encoder writes compressed blocks of at most 32 KiB: the decoder
# steps through the Huffman streams of all blocks together, one literal
# of each stream a numpy step, so a stream of a 32 KiB block (8 Ki
# literals) takes a quarter of the steps of one of a 128 KiB block.
_PIECE = 1 << 15
_MIN_RUN = 32                    # bytes: shorter repeats stay literals
_STATE_BITS = 17                 # a sequence's three state updates, about


class _Bits:
    """A bit stream written from its first bit on, to be read backward
    (`_Backward`); `close` adds the end mark."""

    def __init__(self):
        self.acc, self.n = 0, 0

    def add(self, value: int, nbits: int):
        self.acc |= value << self.n
        self.n += nbits

    def close(self) -> bytes:
        return (self.acc | 1 << self.n).to_bytes(self.n // 8 + 1, "little")


def _cover(table: _Fse) -> Dict[int, List[int]]:
    """Per symbol, per state the encoder holds (the decoding state of the
    symbol after it): the decoding state of the symbol whose update leads
    there."""
    size = 1 << table.log
    cover: Dict[int, List[int]] = {}
    for u in range(size):
        lo, span = table.base[u], 1 << table.nbits[u]
        cover.setdefault(table.symbol[u], [0] * size)[lo:lo + span] = \
            [u] * span
    return cover


_PREDEFINED_COVER = {kind: _cover(table)
                     for kind, table in _PREDEFINED_TABLES.items()}


def _fse_step(table: _Fse, cover, bits: _Bits, state: int,
              symbol: int) -> int:
    """Encodes `symbol` from `state`: writes the bits the decoder's update
    from the returned state reads to reach `state`."""
    u = cover[symbol][state]
    bits.add(state - table.base[u], table.nbits[u])
    return u


def _write_ncount(log: int, counts: Sequence[int]) -> bytes:
    """The FSE table description `_read_ncount` reads."""
    bits = _Bits()
    bits.add(log - 5, 4)
    remaining = (1 << log) + 1
    threshold = 1 << log
    nbits = log + 1
    previous0 = False
    s = 0
    while remaining > 1:
        if previous0:
            zeros = 0
            while counts[s + zeros] == 0:
                zeros += 1
            for _ in range(zeros // 3):
                bits.add(3, 2)
            bits.add(zeros % 3, 2)
            s += zeros
        count = counts[s]
        most = 2 * threshold - 1 - remaining
        remaining -= abs(count)
        value = count + 1
        if value >= threshold:
            value += most
        bits.add(value, nbits - (value < most))
        previous0 = count == 0
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
        s += 1
    return bits.acc.to_bytes((bits.n + 7) // 8, "little")


def _fse_weights(weights: List[int]) -> Optional[bytes]:
    """The Huffman weights FSE-compressed (the table description and the
    two-state stream `_huffman_weights` reads), or None where one weight
    value makes up all of them."""
    n = len(weights)
    hist = np.bincount(weights, minlength=_HUF_BITS + 1)
    if n < 2 or hist.max() == n:
        return None
    log = 6
    size = 1 << log
    norm = np.where(hist > 0, np.maximum(1, hist * size // n), 0)
    while norm.sum() > size:
        norm[np.argmax(norm)] -= 1
    norm[np.argmax(hist)] += size - norm.sum()
    counts = [int(c) for c in norm[:int(np.flatnonzero(norm)[-1]) + 1]]
    table = _Fse(log, counts)
    cover = _cover(table)
    bits = _Bits()
    # the first state emits the even weights, the second the odd ones;
    # the update after the second-to-last weight must read a bit, since
    # reading past the stream's start is what ends it
    states = [0, 0]
    states[(n - 1) % 2] = cover[weights[-1]][0]
    states[n % 2] = next(u for u in range(size) if table.symbol[u]
                         == weights[-2] and table.nbits[u])
    for i in range(n - 3, -1, -1):
        states[i % 2] = _fse_step(table, cover, bits, states[i % 2],
                                  weights[i])
    bits.add(states[1], log)
    bits.add(states[0], log)
    return _write_ncount(log, counts) + bits.close()


def _huffman_lengths(counts: np.ndarray) -> np.ndarray:
    """Code lengths of at most 11 bits forming a complete prefix code over
    the bytes of nonzero count (two or more): Huffman's, with the counts
    halved until the longest code fits."""
    present = np.flatnonzero(counts)
    weight = counts[present].astype(np.int64)
    n = len(present)
    while True:
        heap = [(int(c), i) for i, c in enumerate(weight)]
        heapq.heapify(heap)
        parent = [0] * (2 * n - 1)
        for node in range(n, 2 * n - 1):
            c1, a = heapq.heappop(heap)
            c2, b = heapq.heappop(heap)
            parent[a] = parent[b] = node
            heapq.heappush(heap, (c1 + c2, node))
        depth = [0] * (2 * n - 1)
        for node in range(2 * n - 3, -1, -1):
            depth[node] = depth[parent[node]] + 1
        if max(depth[:n]) <= _HUF_BITS:
            break
        weight = (weight + 1) >> 1
    lengths = np.zeros(256, np.int64)
    lengths[present] = depth[:n]
    return lengths


class _Huffman:
    """A literals table: per byte its code and length (0 for a byte it
    cannot code), and the tree description that introduces it."""

    def __init__(self, lengths: np.ndarray, description: bytes):
        present = np.flatnonzero(lengths)
        weight = np.where(lengths > 0, lengths.max() + 1 - lengths, 0)
        # the decoder's canonical order: weights ascending, then bytes
        order = present[np.argsort(weight[present], kind="stable")]
        span = 1 << (weight[order] - 1)
        self.codes = np.zeros(256, np.uint64)
        self.codes[order] = (np.cumsum(span) - span) >> (weight[order] - 1)
        self.lengths = lengths
        self.description = description

    @classmethod
    def build(cls, counts: np.ndarray) -> Optional["_Huffman"]:
        """The table of byte `counts` (two bytes or more), or None where
        its description does not fit the format."""
        lengths = _huffman_lengths(counts)
        longest = int(lengths.max())
        last = int(np.flatnonzero(lengths)[-1])
        weights = [longest + 1 - int(x) if x else 0 for x in lengths[:last]]
        forms = []
        fse = _fse_weights(weights)
        if fse is not None and len(fse) < 128:
            forms.append(bytes([len(fse)]) + fse)
        if len(weights) <= 128:
            padded = weights + [0]
            forms.append(bytes([127 + len(weights)]) + bytes(
                padded[i] << 4 | padded[i + 1]
                for i in range(0, len(weights), 2)))
        if not forms:
            return None
        return cls(lengths, min(forms, key=len))


def _stream_split(n: int) -> List[int]:
    """The literal counts of a section's streams: one stream below 1024
    literals, else four, the first three of ceil(n / 4)."""
    if n < 1024:
        return [n]
    seg = (n + 3) // 4
    return [seg, seg, seg, n - 3 * seg]


def _huffman_streams(lits: np.ndarray, table: _Huffman) -> bytes:
    """The literals' Huffman streams, after the jump table where there are
    four: a stream holds its literals last first from bit 0 on, so that
    the decoder, reading down from the end mark, meets them in order."""
    split = _stream_split(len(lits))
    ends = np.cumsum(split)
    cum = np.cumsum(table.lengths[lits])
    top = cum[ends - 1]
    total = np.diff(top, prepend=0)              # each stream's bits
    size = total // 8 + 1
    start = np.cumsum(size) - size
    pos = np.repeat(8 * start + top, split) - cum
    word = table.codes[lits] << (pos & 31).astype(np.uint64)
    # the codes starting in each 32-bit unit, summed (they do not overlap)
    # with what runs past it into the next
    acc = np.zeros(int(size.sum()) // 4 + 2, np.uint64)
    np.add.at(acc, pos >> 5, word)
    units = acc & 0xFFFFFFFF
    units[1:] += acc[:-1] >> 32
    buf = units.astype("<u4").view(np.uint8)[:int(size.sum())].copy()
    buf[start + total // 8] |= (1 << (total & 7)).astype(np.uint8)
    jump = struct.pack("<3H", *size[:3]) if len(split) == 4 else b""
    return jump + buf.tobytes()


def _literals_header(kind: int, regen: int, csize: int,
                     streams: int) -> bytes:
    if kind in (_RAW, _RLE):
        if regen < 32:
            return bytes([kind | regen << 3])
        if regen < 4096:
            return (kind | 1 << 2 | regen << 4).to_bytes(2, "little")
        return (kind | 3 << 2 | regen << 4).to_bytes(3, "little")
    top = max(regen, csize)
    size_format, bits = ((0 if streams == 1 else 1, 10) if top < 1024
                         else (2, 14) if top < 16384 else (3, 18))
    return (kind | size_format << 2 | regen << 4 | csize << (4 + bits)
            ).to_bytes((4 + 2 * bits + 7) // 8, "little")


def _literals(lits: np.ndarray, counts: np.ndarray,
              previous: Optional[_Huffman]) -> Tuple[bytes,
                                                     Optional[_Huffman]]:
    """The literals section of `lits` (byte `counts`): raw, RLE, or
    Huffman-coded, whichever is smallest, and the frame's table after it.
    The frame's previous table is kept unless a new one (its description
    included) takes 1 % fewer bits: each table costs the decoder about
    half a millisecond of Python, and the blocks of one array share their
    bytes' distribution."""
    n = len(lits)
    raw = _literals_header(_RAW, n, 0, 0) + lits.tobytes()
    if n and counts.max() == n:
        return _literals_header(_RLE, n, 0, 0) + lits[:1].tobytes(), \
            previous
    if n < 32:
        return raw, previous
    present = counts > 0
    c = counts[present]
    entropy = float((c * np.log2(n / c)).sum())
    choice = None
    if previous is not None and (previous.lengths[present] > 0).all():
        choice = (_TREELESS, previous, int(counts @ previous.lengths))
    # a new table is built only where it may save 1 % (a Huffman code
    # takes at least the entropy)
    if choice is None or choice[2] > 1.01 * (
            entropy + 8 * len(previous.description)):
        table = _Huffman.build(counts)
        if table is not None:
            new = int(counts @ table.lengths) + 8 * len(table.description)
            if choice is None or choice[2] > 1.01 * new:
                choice = (_COMPRESSED, table, new)
    if choice is None or choice[2] // 8 + 10 >= len(raw):
        return raw, previous
    kind, table, _ = choice
    body = (table.description if kind == _COMPRESSED else b"") \
        + _huffman_streams(lits, table)
    streams = len(_stream_split(n))
    section = _literals_header(kind, n, len(body), streams) + body
    return (section, table) if len(section) < len(raw) else (raw, previous)


def _code(value: int, table: List[Tuple[int, int]]) -> int:
    """The length code whose range holds `value`."""
    return next(c for c in range(len(table) - 1, -1, -1)
                if table[c][0] <= value)


def _sequences(seqs: List[Tuple[int, int, int]]) -> bytes:
    """The sequences section of (literal length, match length, offset)
    triples under the predefined tables, every offset a new one (no
    repeat codes)."""
    n = len(seqs)
    if n == 0:
        return b"\0"
    head = bytes([n]) if n < 128 else bytes([128 + (n >> 8), n & 255]) \
        if n < 0x7F00 else b"\xff" + struct.pack("<H", n - 0x7F00)
    codes = [(_code(ll, _LL), _code(ml, _ML), (off + 3).bit_length() - 1,
              ll, ml, off + 3) for ll, ml, off in seqs]
    kinds = ("ll", "ml", "of")
    tables = [_PREDEFINED_TABLES[k] for k in kinds]
    covers = [_PREDEFINED_COVER[k] for k in kinds]
    bits = _Bits()

    def extras(c):
        lc, mc, oc, ll, ml, value = c
        bits.add(ll - _LL[lc][0], _LL[lc][1])
        bits.add(ml - _ML[mc][0], _ML[mc][1])
        bits.add(value - (1 << oc), oc)

    # written last sequence first; the decoder reads a sequence's offset,
    # match and literal extra bits, then updates its literal, match and
    # offset states, and starts from the literal, offset and match states
    states = [cover[c][0] for cover, c in zip(covers, codes[-1])]
    extras(codes[-1])
    for c in reversed(codes[:-1]):
        for k in (2, 1, 0):
            states[k] = _fse_step(tables[k], covers[k], bits, states[k],
                                  c[k])
        extras(c)
    for k in (1, 2, 0):
        bits.add(states[k], tables[k].log)
    return head + b"\0" + bits.close()


def _runs(block: np.ndarray, counts: np.ndarray) -> List[Tuple[int, int,
                                                                 int]]:
    """The block's repeats worth a sequence each, as (start, length,
    offset) in order: runs of at least `_MIN_RUN` bytes that repeat the 4
    or 8 bytes before them (a repeated float32 or float64, or a pair),
    where the literals' bits (at least one a byte, as Huffman codes take)
    exceed the sequence's."""
    u = block[:len(block) // 4 * 4].view("<u4")
    found = []
    for words in (1, 2):
        same = u[words:] == u[:-words]
        edges = np.flatnonzero(np.diff(same, prepend=False, append=False))
        first, stop = edges[::2], edges[1::2]
        long = 4 * (stop - first) >= _MIN_RUN
        found += [(4 * (a + words), 4 * (b + words), 4 * words)
                  for a, b in zip(first[long].tolist(), stop[long].tolist())]
    if not found:
        return []
    cost = np.maximum(1, np.log2(len(block) / np.maximum(counts, 1)))
    out, end = [], 0
    for s, e, off in sorted(found):
        s = max(s, end)
        if e - s < _MIN_RUN:
            continue
        ll, ml = s - end, e - s
        seq_bits = _STATE_BITS + _LL[_code(ll, _LL)][1] \
            + _ML[_code(ml, _ML)][1] + (off + 3).bit_length() - 1
        if cost[block[s:e]].sum() > seq_bits:
            out.append((s, ml, off))
            end = e
    return out


def _block(block: np.ndarray, previous: Optional[_Huffman]) -> Tuple[
        int, bytes, Optional[_Huffman]]:
    """The smallest encoding of one block: (block type, content, the
    frame's Huffman table after it)."""
    counts = np.bincount(block, minlength=256)
    if counts.max() == len(block) > 1:
        return _RLE, block[:1].tobytes(), previous
    seqs, lits, at = [], [], 0
    for s, n, off in _runs(block, counts):
        seqs.append((s - at, n, off))
        lits.append(block[at:s])
        at = s + n
    if seqs:
        lits = np.concatenate(lits + [block[at:]])
        counts = np.bincount(lits, minlength=256)
    else:
        lits = block
    section, table = _literals(lits, counts, previous)
    body = section + _sequences(seqs)
    if len(body) < len(block):
        return _COMPRESSED, body, table
    return _RAW, block.tobytes(), previous


def compress(data: bytes, checksum: bool = False) -> bytes:
    """One zstd frame holding `data`, with its content size and, where
    `checksum`, its XXH64 checksum. Each 32 KiB piece is the smallest of
    raw, RLE (one byte repeated) and a compressed block: its literals
    Huffman-coded, its long runs of a repeated 4 or 8 bytes as sequences
    under the predefined tables. Neighbouring raw pieces, and RLE pieces
    of one byte, join into blocks of up to 128 KiB."""
    data = bytes(data)
    arr = np.frombuffer(data, np.uint8)
    blocks: List[list] = []              # [type, size, content parts]
    table = None
    for at in range(0, len(data), _PIECE):
        piece = arr[at:at + _PIECE]
        kind, body, table = _block(piece, table)
        last = blocks[-1] if blocks else None
        if last and kind == last[0] != _COMPRESSED \
                and last[1] + len(piece) <= BLOCK_MAX \
                and (kind == _RAW or body == last[2][0]):
            last[1] += len(piece)
            if kind == _RAW:
                last[2].append(body)
        else:
            blocks.append([kind, len(piece), [body]])
    # a 128 KiB window (exponent 7), the content size in 8 bytes
    parts = [_MAGIC_BYTES, bytes([0xC0 | (4 if checksum else 0), 7 << 3]),
             struct.pack("<Q", len(data))]
    for i, (kind, size, body) in enumerate(blocks or [[_RAW, 0, []]]):
        body = b"".join(body)
        if kind == _COMPRESSED:
            size = len(body)
        parts += [(size << 3 | kind << 1 | (i == max(len(blocks), 1) - 1)
                   ).to_bytes(3, "little"), body]
    if checksum:
        parts.append(struct.pack("<I", xxh64(data) & 0xFFFFFFFF))
    return b"".join(parts)
