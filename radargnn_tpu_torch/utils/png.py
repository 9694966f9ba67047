"""8-bit RGBA PNG files in numpy and the standard library.

The port's figures are written with `write_png` (one IHDR, one IDAT that
`zlib` compresses, IEND; every chunk's CRC from `zlib.crc32`), the layout
matplotlib's Agg backend saves too. `read_png` reads back the files this
writer writes, and any other 8-bit non-interlaced truecolour or greyscale
PNG with or without alpha: it undoes the five scanline filters.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels (greyscale, RGB, greyscale + alpha, RGBA)
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def encode_png(rgba: np.ndarray, level: int = 6) -> bytes:
    """The PNG bytes of an (H, W, 4) uint8 array: filter type 0 on every
    scanline, the scanlines deflated by zlib at `level`."""
    rgba = np.ascontiguousarray(rgba)
    if rgba.dtype != np.uint8 or rgba.ndim != 3 or rgba.shape[2] != 4:
        raise ValueError(f"want an (H, W, 4) uint8 array, got {rgba.dtype} "
                         f"{rgba.shape}")
    h, w = rgba.shape[:2]
    rows = np.zeros((h, 1 + 4 * w), np.uint8)
    rows[:, 1:] = rgba.reshape(h, 4 * w)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + _chunk(b"IEND", b""))


def write_png(path: str, rgba: np.ndarray) -> None:
    """Writes an (H, W, 4) uint8 array to `path` as an RGBA PNG."""
    data = encode_png(rgba)
    with open(path, "wb") as f:
        f.write(data)


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undoes the per-scanline filters (None, Sub, Up, Average, Paeth)."""
    lines = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        kind, line = int(lines[y, 0]), lines[y, 1:].astype(np.int32)
        if kind == 0:
            cur = line
        elif kind == 2:
            cur = (line + prev) & 0xFF
        elif kind in (1, 3, 4):
            # each byte depends on the byte bpp to its left: walk the row in
            # steps of one pixel, all channels at once
            cur = np.zeros(stride, np.int32)
            for x in range(0, stride, bpp):
                left = cur[x - bpp:x] if x else np.zeros(bpp, np.int32)
                up = prev[x:x + bpp]
                if kind == 1:
                    pred = left
                elif kind == 3:
                    pred = (left + up) >> 1
                else:
                    upleft = (prev[x - bpp:x] if x
                              else np.zeros(bpp, np.int32))
                    p = left + up - upleft
                    pa, pb, pc = (np.abs(p - left), np.abs(p - up),
                                  np.abs(p - upleft))
                    pred = np.where((pa <= pb) & (pa <= pc), left,
                                    np.where(pb <= pc, up, upleft))
                cur[x:x + bpp] = (line[x:x + bpp] + pred) & 0xFF
        else:
            raise ValueError(f"unknown PNG filter type {kind}")
        out[y] = cur
        prev = cur
    return out


def decode_png(data: bytes) -> np.ndarray:
    """An (H, W, C) uint8 array from PNG bytes (C = 1, 2, 3 or 4 as the
    file's colour type says). Raises ValueError on a file it does not
    read: a bad signature or CRC, a bit depth other than 8, a palette, or
    interlacing."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(data):
        if pos + 12 > len(data):
            raise ValueError("truncated PNG chunk")
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if len(body) != n or zlib.crc32(kind + body) != crc:
            raise ValueError(f"bad CRC in the {kind!r} chunk")
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError("a PNG file without IHDR or IDAT")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type "
                         f"{ctype}, interlace {interlace}")
    ch = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (w * ch + 1):
        raise ValueError("the PNG's image data has the wrong size")
    return _unfilter(raw, h, w * ch, ch).reshape(h, w, ch)


def read_png(path: str) -> np.ndarray:
    """The image of a PNG file as an (H, W, C) uint8 array."""
    with open(path, "rb") as f:
        return decode_png(f.read())
