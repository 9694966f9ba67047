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

It writes frames of raw blocks, or RLE blocks where a block is one byte
repeated (`compress`): any zstd decoder reads them, and the values stay
bit for bit.

The Huffman streams of every compressed block of every input are decoded
together, one numpy step a symbol position across all streams (11-bit
table lookups); the FSE sequence streams are decoded one sequence at a
time, one table lookup a state. A frame that names a dictionary raises
ValueError saying so; so does corrupt or truncated input: the decoder
never returns wrong bytes without raising.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

MAGIC = 0xFD2FB528
_MAGIC_BYTES = struct.pack("<I", MAGIC)
_SKIPPABLE = 0x184D2A50          # to 0x184D2A5F
BLOCK_MAX = 1 << 17
_HUF_BITS = 11                   # Huffman codes are at most 11 bits long
_RAW, _RLE, _COMPRESSED = 0, 1, 2

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


def compress(data: bytes, checksum: bool = False) -> bytes:
    """One zstd frame holding `data` in raw blocks of up to 128 KiB, or
    RLE blocks where a block is one byte repeated; with its content size,
    and its XXH64 checksum where `checksum`."""
    data = bytes(data)
    # a 128 KiB window (exponent 7), the content size in 8 bytes
    parts = [_MAGIC_BYTES, bytes([0xC0 | (4 if checksum else 0), 7 << 3]),
             struct.pack("<Q", len(data))]
    starts = range(0, max(len(data), 1), BLOCK_MAX)
    for i, at in enumerate(starts):
        block = data[at:at + BLOCK_MAX]
        last = int(i == len(starts) - 1)
        if len(block) > 1 and block.count(block[:1]) == len(block):
            parts += [(len(block) << 3 | _RLE << 1 | last).to_bytes(3,
                                                                    "little"),
                      block[:1]]
        else:
            parts += [(len(block) << 3 | _RAW << 1 | last).to_bytes(3,
                                                                    "little"),
                      block]
    if checksum:
        parts.append(struct.pack("<I", xxh64(data) & 0xFFFFFFFF))
    return b"".join(parts)
