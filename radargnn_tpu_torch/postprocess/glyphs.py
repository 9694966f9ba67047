"""The figures' text: DejaVu Sans from a committed glyph table.

`fonts/dejavu_sans.npz` holds, at the four sizes the figures print
(6, 7, 10 and 12 pt at 100 dpi), each printable ASCII character, the minus
sign and the font's missing-glyph box as FreeType draws them under
matplotlib's Agg settings (hinting factor 8, forced autohinting): the
advance and control box in 1/64 px, the alpha bitmap at each of the eight
pen phases the hinted pens take (multiples of 1/8 px) with FreeType's
bitmap left and top, and the kerning pairs. `tests/test_torch_font_fixture.py` rebuilds
the table from matplotlib's DejaVuSans.ttf and holds it to the committed
file.

`text_extent` gives a string's width, height and descent as Agg's
`get_text_width_height_descent` does (the numbers matplotlib lays text out
by); `string_bitmap` composes the string's alpha bitmap as FT2Font's
`draw_glyphs_to_bitmap` does, bit for bit. A character outside the table is drawn as the missing-
glyph box and one printed line names it: a figure never raises for text.
"""

from __future__ import annotations

import functools
import math
import os
from typing import Dict, List, Tuple

import numpy as np

TABLE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fonts",
                     "dejavu_sans.npz")
SIZES = (6.0, 7.0, 10.0, 12.0)
# code 0 is the missing-glyph box
CODES = (0, *range(32, 127), 0x2212)
PHASES = 8  # pens fall on multiples of 1/8 px (8 of 64 FreeType units)
_WARNED: set = set()


def size_key(size: float) -> str:
    return f"s{size:g}"


class _Face:
    """One size of the table: per code its advance and control box
    (x0, y0, x1, y1) in FreeType's 1/64 px units, and per code and pen
    phase its bitmap with FreeType's left (relative to the pen's whole
    pixel) and top (above the baseline)."""

    def __init__(self, arrays, size: float):
        key = size_key(size)
        self.index = {int(c): i for i, c in enumerate(arrays["codes"])}
        self.advance = arrays[f"{key}_advance"].astype(np.int64)
        self.cbox = arrays[f"{key}_cbox"].astype(np.int64)
        place = arrays[f"{key}_place"]
        flat = arrays[f"{key}_alpha"]
        sizes = (place[..., 0] * place[..., 1]).reshape(-1)
        ends = np.cumsum(sizes)
        bitmaps = [flat[e - n:e] for n, e in zip(sizes, ends)]
        self.bitmaps = [[(bitmaps[i * PHASES + p].reshape(place[i, p, :2]),
                          int(place[i, p, 2]), int(place[i, p, 3]))
                         for p in range(PHASES)]
                        for i in range(len(place))]
        self.kerning = {(int(a), int(b)): int(v)
                        for a, b, v in arrays[f"{key}_kerning"]}


@functools.lru_cache(maxsize=None)
def _faces() -> Dict[float, _Face]:
    with np.load(TABLE) as arrays:
        loaded = {k: arrays[k] for k in arrays.files}
    return {float(s): _Face(loaded, float(s)) for s in loaded["sizes"]}


def face(size: float) -> _Face:
    faces = _faces()
    if float(size) not in faces:
        raise ValueError(f"the glyph table has sizes {sorted(faces)} pt, "
                         f"not {size}")
    return faces[float(size)]


def _codes(s: str, f: _Face) -> List[int]:
    codes = [ord(c) if ord(c) in f.index else 0 for c in s]
    missing = sorted({c for c in s if ord(c) not in f.index} - _WARNED)
    if missing:
        _WARNED.update(missing)
        names = ", ".join(f"{c!r} (U+{ord(c):04X})" for c in missing)
        print(f"figure text: no glyph for {names} in the figure font; "
              "drawn as the missing-glyph box")
    return codes


def _layout(s: str, size: float):
    """Each glyph's code and pen, the string's advance and its control
    box, as FT2Font.set_text lays the string out (kerning between two
    glyphs the font has)."""
    f = face(size)
    codes = _codes(s, f)
    pens, pen, prev = [], 0, 0
    x0 = y0 = 32000
    x1 = y1 = -32000
    for code in codes:
        if prev and code:
            pen += f.kerning.get((prev, code), 0)
        gx0, gy0, gx1, gy1 = f.cbox[f.index[code]]
        if gx0 or gy0 or gx1 or gy1:
            gx0, gx1 = gx0 + pen, gx1 + pen
        # else an empty outline (a space): FreeType's box is (0, 0, 0, 0)
        # wherever the pen is
        x0, x1 = min(x0, gx0), max(x1, gx1)
        y0, y1 = min(y0, gy0), max(y1, gy1)
        pens.append(pen)
        pen += int(f.advance[f.index[code]])
        prev = code
    if x0 > x1:
        x0 = y0 = x1 = y1 = 0
    return f, codes, pens, pen, (x0, y0, x1, y1)


@functools.lru_cache(maxsize=4096)
def text_extent(s: str, size: float) -> Tuple[float, float, float]:
    """(width, height, descent) in pixels, as Agg measures the string."""
    _, _, _, advance, (_, y0, _, y1) = _layout(s, size)
    return advance / 64.0, (y1 - y0) / 64.0, -y0 / 64.0


@functools.lru_cache(maxsize=4096)
def string_bitmap(s: str, size: float) -> Tuple[np.ndarray, float]:
    """The string's alpha bitmap (uint8, rows top down) and its left edge
    relative to the pen's start in pixels (FT2Font's bitmap offset): each
    glyph's bitmap at its pen, OR-ed in where FT2Font puts it, in an image
    two pixels wider and taller than the control box."""
    f, codes, pens, _, (x0, y0, x1, y1) = _layout(s, size)
    h, w = (y1 - y0) // 64 + 2, (x1 - x0) // 64 + 2
    out = np.zeros((h, w), np.uint8)
    for code, pen in zip(codes, pens):
        g, left, top = f.bitmaps[f.index[code]][(pen % 64) // 8]
        if not g.size:
            continue
        c = math.trunc(pen // 64 + left - x0 / 64.0)
        r = math.trunc(y1 / 64.0 - top + 1)
        rs, cs = min(max(r, 0), h), min(max(c, 0), w)
        re, ce = min(max(r + g.shape[0], 0), h), min(max(c + g.shape[1], 0), w)
        if re > rs and ce > cs:
            np.bitwise_or(out[rs:re, cs:ce], g[rs - r:re - r, cs - c:ce - c],
                          out=out[rs:re, cs:ce])
    return out, x0 / 64.0
