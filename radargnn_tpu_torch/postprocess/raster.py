"""A small antialiased rasteriser in numpy for the port's figures.

The canvas is an RGB float image over an opaque background; every drawing
call composites one shape with one colour ("over", the colour's alpha times
the shape's coverage of each pixel). Coordinates are canvas pixels with y
pointing down, pixel (row r, column c) covering [c, c + 1] x [r, r + 1], as
in Agg, whose output these figures follow:

- strokes (`stroke`): a polyline of a width in pixels, each pixel's
  coverage the share of its square between the stroke's edges, times the
  share between its ends (exact for a long segment at any angle), round
  joins, butt or projecting ends; a pixel two pieces of the stroke cover
  in part takes their union's coverage from 16 x 16 samples; `snap` moves
  a path of horizontal and vertical segments onto the pixel grid as Agg's
  path snapper does;
- disks (`disks`): scatter markers, drawn one after another in order;
- polygons (`fill_polygon`): coverage from 4 x 4 samples a pixel;
- rounded rectangles (`rounded_rect`): the legend's frame, face and edge;
- text bitmaps (`blit`, `blit_rotated`): an alpha bitmap at a whole-pixel
  position, or turned about its lower-left corner with bilinear sampling;
- images (`image_nearest`): a colour per cell, each pixel taking the cell
  under its centre.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np

Color = Tuple[float, float, float, float]


def _overlap(lo, hi):
    """Length of [lo, hi] inside the pixel's [-0.5, 0.5]."""
    return np.clip(np.minimum(hi, 0.5) - np.maximum(lo, -0.5), 0.0, 1.0)


def _square_cdf(x, a, b):
    """The share of a unit pixel on the near side of a line at signed
    distance x from its centre, the line's normal at an angle whose
    |cos| and |sin| are a >= b: the pixel projects onto the normal as the
    sum of two uniform widths a and b."""
    if b < 1e-9:
        return np.clip(x / a + 0.5, 0.0, 1.0)
    s = np.clip(x + (a + b) / 2.0, 0.0, a + b)
    return np.where(s <= b, s * s / (2 * a * b),
                    np.where(s <= a, (s - b / 2.0) / a,
                             1 - (a + b - s) ** 2 / (2 * a * b)))


def _band(lo, hi, a, b):
    """The share of the pixel between two parallel lines at signed
    distances lo < hi from its centre (its exact area for straight
    edges)."""
    return _square_cdf(hi, a, b) - _square_cdf(lo, a, b)


def snap(points: np.ndarray, width: float) -> np.ndarray:
    """Agg's snapping of a path of horizontal and vertical segments (at most
    1024 vertices): each vertex to the pixel grid, onto pixel centres where
    the rounded width is odd. Other paths come back as they are."""
    pts = np.asarray(points, np.float64)
    d = np.abs(np.diff(pts, axis=0))
    if len(pts) > 1024 or not ((d[:, 0] < 1e-4) | (d[:, 1] < 1e-4)).all():
        return pts
    offset = 0.5 if int(np.floor(width + 0.5)) % 2 else 0.0
    return np.floor(pts + 0.5) + offset


def _union_cover(xs, ys, pieces, hw, k: int = 16):
    """The share of each pixel (centres xs, ys) inside the union of a
    stroke's pieces, from k x k samples: each segment's rectangle (its
    ends extended by e0 and e1) and, where it has one, the round join at
    its start."""
    s = (np.arange(k) + 0.5) / k - 0.5
    px = (xs[:, None, None] + s[None, None, :]).astype(np.float64)
    py = (ys[:, None, None] + s[None, :, None]).astype(np.float64)
    inside = np.zeros((len(xs), k, k), bool)
    for ax, ay, ux, uy, length, e0, e1, join in pieces:
        dx, dy = px - ax, py - ay
        u = dx * ux + dy * uy
        v = dx * -uy + dy * ux
        inside |= (np.abs(v) <= hw) & (u >= -e0) & (u <= length + e1)
        if join:
            inside |= dx * dx + dy * dy <= hw * hw
    return inside.mean(axis=(1, 2))


class Canvas:
    """An RGB float image, opaque, `height` x `width` pixels."""

    def __init__(self, width: int, height: int,
                 face: Sequence[float] = (1.0, 1.0, 1.0)):
        self.width, self.height = int(width), int(height)
        self.rgb = np.empty((self.height, self.width, 3), np.float64)
        self.rgb[:] = np.asarray(face[:3], np.float64)

    # -- compositing ------------------------------------------------------

    def composite(self, r0: int, c0: int, cover: np.ndarray,
                  color: Color) -> None:
        """Composites `color` at `cover` (an alpha per pixel in [0, 1]) on
        the block whose top-left pixel is (r0, c0); clipped to the canvas."""
        h, w = cover.shape
        rs, cs = max(r0, 0), max(c0, 0)
        re, ce = min(r0 + h, self.height), min(c0 + w, self.width)
        if re <= rs or ce <= cs:
            return
        a = cover[rs - r0:re - r0, cs - c0:ce - c0] * color[3]
        block = self.rgb[rs:re, cs:ce]
        block += a[..., None] * (np.asarray(color[:3]) - block)

    def composite_colors(self, r0: int, c0: int, alpha: np.ndarray,
                         rgb: np.ndarray) -> None:
        """Composites an (h, w, 3) colour block at per-pixel `alpha`."""
        h, w = alpha.shape
        rs, cs = max(r0, 0), max(c0, 0)
        re, ce = min(r0 + h, self.height), min(c0 + w, self.width)
        if re <= rs or ce <= cs:
            return
        a = alpha[rs - r0:re - r0, cs - c0:ce - c0, None]
        block = self.rgb[rs:re, cs:ce]
        block += a * (rgb[rs - r0:re - r0, cs - c0:ce - c0] - block)

    def rgba8(self) -> np.ndarray:
        """The canvas as (H, W, 4) uint8, alpha 255."""
        out = np.empty((self.height, self.width, 4), np.uint8)
        out[..., :3] = np.clip(np.floor(self.rgb * 255.0 + 0.5), 0, 255)
        out[..., 3] = 255
        return out

    # -- shapes -----------------------------------------------------------

    def _grid(self, x0, y0, x1, y1, pad):
        c0 = max(int(math.floor(x0 - pad)), 0)
        r0 = max(int(math.floor(y0 - pad)), 0)
        c1 = min(int(math.ceil(x1 + pad)) + 1, self.width)
        r1 = min(int(math.ceil(y1 + pad)) + 1, self.height)
        if c1 <= c0 or r1 <= r0:
            return None
        xs = np.arange(c0, c1) + 0.5
        ys = np.arange(r0, r1) + 0.5
        return r0, c0, xs[None, :], ys[:, None]

    def stroke(self, points: np.ndarray, width: float, color: Color,
               cap: str = "projecting", clip=None) -> None:
        """A polyline `width` pixels wide, composited once (its own overlaps
        do not darken it): round joins, `cap` "butt" or "projecting" at
        its two ends. NaN vertices break the line."""
        pts = np.asarray(points, np.float64)
        ok = np.isfinite(pts).all(axis=1)
        if not ok.all():
            runs, start = [], None
            for i, good in enumerate(list(ok) + [False]):
                if good and start is None:
                    start = i
                elif not good and start is not None:
                    runs.append(pts[start:i])
                    start = None
            for run in runs:
                self.stroke(run, width, color, cap, clip)
            return
        if len(pts) < 2 or width <= 0:
            return
        hw = width / 2.0
        ext = hw if cap == "projecting" else 0.0
        lo, hi = pts.min(axis=0), pts.max(axis=0)
        g = self._grid(lo[0], lo[1], hi[0], hi[1], hw + ext + 1)
        if g is None:
            return
        r0, c0, xs, ys = g
        cover = np.zeros((ys.shape[0], xs.shape[1]))
        # pixels that two pieces (segments or joins) cover in part: their
        # coverage is the union's, from samples
        shared = np.zeros(cover.shape, np.int32)
        pieces = []
        n = len(pts) - 1
        for i in range(n):
            (ax, ay), (bx, by) = pts[i], pts[i + 1]
            length = math.hypot(bx - ax, by - ay)
            e0 = ext if i == 0 else 0.0
            e1 = ext if i == n - 1 else 0.0
            pad = hw + max(e0, e1) + 1
            sub = (slice(max(int(math.floor(min(ay, by) - pad)) - r0, 0),
                         max(int(math.ceil(max(ay, by) + pad)) + 1 - r0, 0)),
                   slice(max(int(math.floor(min(ax, bx) - pad)) - c0, 0),
                         max(int(math.ceil(max(ax, bx) + pad)) + 1 - c0, 0)))
            px, py = xs[:, sub[1]], ys[sub[0], :]
            if not px.size or not py.size:
                continue
            if length == 0:
                ux, uy = 1.0, 0.0
            else:
                ux, uy = (bx - ax) / length, (by - ay) / length
            pieces.append((ax, ay, ux, uy, length, e0, e1, 0 < i))
            dx, dy = px - ax, py - ay
            u = dx * ux + dy * uy
            v = dx * -uy + dy * ux
            a, b = max(abs(ux), abs(uy)), min(abs(ux), abs(uy))
            cov = _band(v - hw, v + hw, a, b) * _band(-e0 - u, length + e1 - u,
                                                      a, b)
            shared[sub] += (cov > 0) & (cov < 1)
            if 0 < i:
                # the round join at this segment's start
                join = np.clip(hw + 0.5 - np.hypot(dx, dy), 0, 1)
                shared[sub] += (join > 0) & (join < 1)
                cov = np.maximum(cov, join)
            np.maximum(cover[sub], cov, out=cover[sub])
        rr, cc = np.nonzero((shared > 1) & (cover < 1))
        if len(rr) and len(pieces) > 1:
            cover[rr, cc] = _union_cover(xs[0, cc], ys[rr, 0], pieces, hw)
        if clip is not None:
            cover *= self._clip_mask(r0, c0, cover.shape, clip)
        self.composite(r0, c0, cover, color)

    def _clip_mask(self, r0, c0, shape, clip):
        x0, y0, x1, y1 = clip
        xs = np.arange(c0, c0 + shape[1]) + 0.5
        ys = np.arange(r0, r0 + shape[0]) + 0.5
        cx = np.clip(np.minimum(xs + 0.5, x1) - np.maximum(xs - 0.5, x0),
                     0, 1)
        cy = np.clip(np.minimum(ys + 0.5, y1) - np.maximum(ys - 0.5, y0),
                     0, 1)
        return cy[:, None] * cx[None, :]

    def segments(self, segs: np.ndarray, width: float, color: Color,
                 clip=None) -> None:
        """Separate two-point lines (a line collection), each composited on
        its own, in order."""
        for seg in np.asarray(segs, np.float64):
            self.stroke(seg, width, color, cap="butt", clip=clip)

    def disks(self, centers: np.ndarray, radius: float,
              colors: np.ndarray, clip=None) -> None:
        """Filled disks of one radius, one colour each (an (N, 4) array or
        one colour for all), composited one after another."""
        centers = np.asarray(centers, np.float64)
        colors = np.broadcast_to(np.asarray(colors, np.float64),
                                 (len(centers), 4))
        k = int(math.ceil(radius + 1))
        off = np.arange(-k, k + 1)
        for (x, y), color in zip(centers, colors):
            if not (np.isfinite(x) and np.isfinite(y)):
                continue
            c0, r0 = int(math.floor(x)) - k, int(math.floor(y)) - k
            d = np.hypot((c0 + k + off + 0.5 - x)[None, :],
                         (r0 + k + off + 0.5 - y)[:, None])
            cover = np.clip(radius + 0.5 - d, 0, 1)
            if clip is not None:
                cover = cover * self._clip_mask(r0, c0, cover.shape, clip)
            self.composite(r0, c0, cover, tuple(color))

    def fill_polygon(self, points: np.ndarray, color: Color,
                     clip=None) -> None:
        """A filled polygon (even-odd rule), 16 samples a pixel."""
        pts = np.asarray(points, np.float64)
        if len(pts) < 3 or not np.isfinite(pts).all():
            return
        lo, hi = pts.min(axis=0), pts.max(axis=0)
        g = self._grid(lo[0], lo[1], hi[0], hi[1], 1)
        if g is None:
            return
        r0, c0, xs, ys = g
        s = (np.arange(4) + 0.5) / 4 - 0.5
        sx = (xs.reshape(-1, 1) + s).reshape(1, -1)     # (1, 4w)
        sy = (ys.reshape(-1, 1) + s).reshape(-1, 1)     # (4h, 1)
        inside = np.zeros((sy.shape[0], sx.shape[1]), bool)
        q = np.roll(pts, -1, axis=0)
        for (ax, ay), (bx, by) in zip(pts, q):
            if ay == by:
                continue
            cross = (ay > sy) != (by > sy)
            xint = ax + (sy - ay) * (bx - ax) / (by - ay)
            inside ^= cross & (sx < xint)
        cover = inside.reshape(ys.shape[0], 4, xs.shape[1], 4).mean(
            axis=(1, 3))
        if clip is not None:
            cover = cover * self._clip_mask(r0, c0, cover.shape, clip)
        self.composite(r0, c0, cover, color)

    def rounded_rect(self, x0: float, y0: float, x1: float, y1: float,
                     radius: float, face: Optional[Color],
                     edge: Optional[Color], edge_width: float) -> None:
        """A rectangle with round corners: its face, then its edge centred
        on the outline."""
        hw = edge_width / 2.0
        g = self._grid(x0, y0, x1, y1, hw + 1)
        if g is None:
            return
        r0, c0, xs, ys = g
        cx, cy = (x0 + x1) / 2.0, (y0 + y1) / 2.0
        qx = np.abs(xs - cx) - ((x1 - x0) / 2.0 - radius)
        qy = np.abs(ys - cy) - ((y1 - y0) / 2.0 - radius)
        sd = (np.hypot(np.maximum(qx, 0), np.maximum(qy, 0))
              + np.minimum(np.maximum(qx, qy), 0) - radius)
        if face is not None:
            self.composite(r0, c0, np.clip(0.5 - sd, 0, 1), face)
        if edge is not None and edge_width > 0:
            self.composite(r0, c0, _overlap(sd - hw, sd + hw), edge)

    # -- bitmaps ----------------------------------------------------------

    def blit(self, alpha: np.ndarray, x: int, y_bottom: int,
             color: Color) -> None:
        """An alpha bitmap whose lower-left corner is at (x, y_bottom): its
        rows fill [y_bottom - h, y_bottom), its columns [x, x + w)."""
        h = alpha.shape[0]
        self.composite(y_bottom - h, x, alpha / 255.0, color)

    def blit_rotated(self, alpha: np.ndarray, x: float, y_bottom: float,
                     angle: float, color: Color) -> None:
        """An alpha bitmap turned `angle` degrees counterclockwise about
        its lower-left corner, which lands at (x, y_bottom); each pixel
        samples the bitmap bilinearly at its centre."""
        h, w = alpha.shape
        a = math.radians(angle)
        ca, sa = math.cos(a), math.sin(a)
        # bitmap (u, v), v down from the top -> canvas, turning about the
        # lower-left corner (0, h)
        corners = np.array([(0, 0), (w, 0), (w, h), (0, h)], np.float64)
        cu, cv = corners[:, 0], corners[:, 1] - h
        X = x + cu * ca + cv * sa
        Y = y_bottom - cu * sa + cv * ca
        g = self._grid(X.min(), Y.min(), X.max(), Y.max(), 1)
        if g is None:
            return
        r0, c0, xs, ys = g
        dx, dy = xs - x, ys - y_bottom
        u = dx * ca - dy * sa
        v = dx * sa + dy * ca + h
        # bilinear between the pixel centres, zero outside the bitmap
        src = np.zeros((h + 2, w + 2))
        src[1:-1, 1:-1] = alpha / 255.0
        fu, fv = u - 0.5 + 1, v - 0.5 + 1
        iu = np.floor(fu).astype(np.int64)
        iv = np.floor(fv).astype(np.int64)
        tu, tv = fu - iu, fv - iv
        ok = (iu >= 0) & (iu < w + 1) & (iv >= 0) & (iv < h + 1)
        iu, iv = np.clip(iu, 0, w), np.clip(iv, 0, h)
        val = (src[iv, iu] * (1 - tu) * (1 - tv) + src[iv, iu + 1] * tu
               * (1 - tv) + src[iv + 1, iu] * (1 - tu) * tv
               + src[iv + 1, iu + 1] * tu * tv)
        self.composite(r0, c0, np.where(ok, val, 0.0), color)

    def image_nearest(self, rgba: np.ndarray, x0: float, y0: float,
                      x1: float, y1: float, clip) -> None:
        """An (m, n, 4) float image stretched over the canvas rectangle
        from (x0, y0) (the image's first row and column) to (x1, y1); each
        pixel inside `clip` takes the cell under its centre."""
        m, n = rgba.shape[:2]
        g = self._grid(clip[0], clip[1], clip[2], clip[3], 0)
        if g is None:
            return
        r0, c0, xs, ys = g
        j = np.floor((xs[0] - x0) / (x1 - x0) * n).astype(np.int64)
        i = np.floor((ys[:, 0] - y0) / (y1 - y0) * m).astype(np.int64)
        inx = (j >= 0) & (j < n) & (xs[0] >= clip[0]) & (xs[0] < clip[2])
        iny = (i >= 0) & (i < m) & (ys[:, 0] >= clip[1]) & \
            (ys[:, 0] < clip[3])
        cells = rgba[np.clip(i, 0, m - 1)][:, np.clip(j, 0, n - 1)]
        alpha = cells[..., 3] * (iny[:, None] & inx[None, :])
        self.composite_colors(r0, c0, alpha, cells[..., :3])
