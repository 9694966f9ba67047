"""The figures the port draws, laid out as matplotlib 3.10 lays them out.

The JAX package draws its figures with matplotlib (Agg, 100 dpi, the
default rcParams); the card's machine has no matplotlib, so the port lays
the same figures out here and draws them with its own rasteriser
(`raster`), text (`glyphs`) and PNG writer (`utils.png`). Only what the
port's five figures use is here, each piece following matplotlib's own
algorithm so that the boxes, limits, ticks and labels come out where
matplotlib puts them:

- a figure of subplots at the default subplot box (left 0.125, right 0.9,
  bottom 0.11, top 0.88), `tight_layout` (pad 1.08) and one vertical
  colorbar beside the axes (fraction 0.15, pad 0.05, aspect 20, placed by
  the gridspec matplotlib's `make_axes_gridspec` builds);
- autoscaling with 0.05 margins and sticky image edges, `axis("equal")`
  (aspect 1, adjustable "datalim") and an image's aspect (adjustable
  "box"), as `Axes.apply_aspect` does;
- `MaxNLocator` ticks (steps 1, 2, 2.5, 5, 10; `nbins="auto"` from the
  axis length) with `ScalarFormatter` labels (offset, order of magnitude,
  the minus sign), or fixed ticks and labels;
- spines, outward ticks (3.5 pt, 0.8 pt wide), the grid (0.8 pt
  `#b0b0b0`), tick labels 3.5 pt beyond the ticks, axis labels 4 pt
  beyond the tick labels, the title 6 pt above the axes;
- lines (1.5 pt by default, projecting ends, round joins), scatter markers
  (`s` in pt^2, edge of the face's colour, 1.5 pt), line collections,
  quiver arrows (matplotlib's default arrow geometry, units "width"),
  nearest-neighbour images through a colormap, text (any of the nine
  alignments, rotated, rotation mode "default" or "anchor");
- `legend(loc="best")`: matplotlib's box layout (handle 2 font sizes long,
  0.8 font sizes to the text, 0.5 between rows, border 0.4, 0.5 from the
  axes) and its choice among the nine places by the count of data
  vertices inside the box and line segments crossing it.

Coordinates are "display" pixels, y up from the figure's bottom, as in
matplotlib; the canvas flips them.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from radargnn_tpu_torch.postprocess import glyphs
from radargnn_tpu_torch.postprocess.raster import Canvas, snap
from radargnn_tpu_torch.utils import png

DPI = 100.0
FONT_SIZE = 10.0          # font.size; ticks, labels, legend
TITLE_SIZE = 12.0         # axes.titlesize "large"
LINE_WIDTH = 1.5          # lines.linewidth
AXES_LINE_WIDTH = 0.8     # axes.linewidth, the spines
TICK_SIZE, TICK_WIDTH, TICK_PAD = 3.5, 0.8, 3.5
LABEL_PAD = 4.0           # axes.labelpad
TITLE_PAD = 6.0           # axes.titlepad
OFFSET_TEXT_PAD = 3.0     # Axis.OFFSETTEXTPAD
GRID_COLOR, GRID_WIDTH = "#b0b0b0", 0.8
MARGIN = 0.05             # axes.xmargin, axes.ymargin
SUBPLOT = (0.125, 0.11, 0.9, 0.88)   # left, bottom, right, top
# the tab10 property cycle
CYCLE = ("#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd", "#8c564b",
         "#e377c2", "#7f7f7f", "#bcbd22", "#17becf")
_NAMED = {"black": "#000000", "k": "#000000", "white": "#ffffff",
          "w": "#ffffff", "red": "#ff0000", "r": "#ff0000",
          "gray": "#808080", "grey": "#808080", "blue": "#0000ff",
          "b": "#0000ff", "none": None}
MINUS = "\N{MINUS SIGN}"


def points(v: float) -> float:
    """Points to pixels at the figures' 100 dpi."""
    return v * DPI / 72.0


def to_rgba(color, alpha: Optional[float] = None) -> Tuple[float, ...]:
    """A colour as an RGBA float tuple: "#rrggbb", a name matplotlib
    knows among those the figures use, a grey level string ("0.8"), or an
    RGB(A) sequence."""
    if isinstance(color, str):
        name = _NAMED.get(color.lower(), color)
        if name is None:
            return (0.0, 0.0, 0.0, 0.0)
        if name.startswith("#") and len(name) in (7, 9):
            vals = [int(name[i:i + 2], 16) / 255.0
                    for i in range(1, len(name), 2)]
            rgba = (*vals, 1.0) if len(vals) == 3 else tuple(vals)
        else:
            g = float(name)
            rgba = (g, g, g, 1.0)
    else:
        c = tuple(float(v) for v in color)
        rgba = c + (1.0,) if len(c) == 3 else c
    if alpha is not None:
        rgba = rgba[:3] + (float(alpha),)
    return tuple(rgba)


# -- boxes ------------------------------------------------------------------

def union(boxes):
    boxes = list(boxes)
    return (min(b[0] for b in boxes), min(b[1] for b in boxes),
            max(b[2] for b in boxes), max(b[3] for b in boxes))


def _sized(b) -> bool:
    return 0 < b[2] - b[0] < np.inf and 0 < b[3] - b[1] < np.inf


def _anchored(size, container, anchor):
    """Bbox.anchored: a box of `size` (w, h) placed in `container`
    (x0, y0, x1, y1) at `anchor` (cx, cy) fractions."""
    w, h = size
    l, b = container[0], container[1]
    cw, ch = container[2] - container[0], container[3] - container[1]
    x0 = l + anchor[0] * (cw - w)
    y0 = b + anchor[1] * (ch - h)
    return (x0, y0, x0 + w, y0 + h)


def _shrunk_to_aspect(box, box_aspect, fig_aspect):
    """Bbox.shrunk_to_aspect of a box with itself as container; the size
    (W, H)."""
    w, h = box[2] - box[0], box[3] - box[1]
    H = w * box_aspect / fig_aspect
    if H <= h:
        return w, H
    return h * fig_aspect / box_aspect, h


# -- text -------------------------------------------------------------------

class Text:
    """One line of text as matplotlib lays it out (`Text._get_layout`):
    its box from the string's width, height and descent (at least those of
    "lp"), turned by `rotation` and aligned on its anchor."""

    def __init__(self, text: str, size: float = FONT_SIZE, color="black",
                 ha: str = "left", va: str = "baseline",
                 rotation: float = 0.0, rotation_mode: str = "default"):
        self.text, self.size = str(text), float(size)
        self.color = to_rgba(color)
        self.ha, self.va = ha, va
        self.rotation, self.rotation_mode = float(rotation), rotation_mode

    def layout(self):
        """(box relative to the anchor as (x0, y0, x1, y1), the baseline's
        start relative to the anchor, the descent)."""
        _, lp_h, lp_d = glyphs.text_extent("lp", self.size)
        if self.text:
            w, h, d = glyphs.text_extent(self.text, self.size)
        else:
            w = h = d = 0.0
        h, d = max(h, lp_h), max(d, lp_d)
        baseline = h - d
        y_line = -(h - d)
        xmin, xmax, ymax, ymin = 0.0, w, 0.0, y_line - d
        a = math.radians(self.rotation)
        ca, sa = math.cos(a), math.sin(a)

        def rot(x, y):
            return x * ca - y * sa, x * sa + y * ca

        corners = [(xmin, ymin), (xmin, ymax), (xmax, ymax), (xmax, ymin)]
        rc = [rot(x, y) for x, y in corners]
        rxmin, rxmax = min(p[0] for p in rc), max(p[0] for p in rc)
        rymin, rymax = min(p[1] for p in rc), max(p[1] for p in rc)
        width, height = rxmax - rxmin, rymax - rymin
        ha, va = self.ha, self.va
        if self.rotation_mode != "anchor":
            ox = {"center": (rxmin + rxmax) / 2, "right": rxmax}.get(ha, rxmin)
            oy = {"center": (rymin + rymax) / 2, "top": rymax,
                  "baseline": rymin + d,
                  "center_baseline": rymin + height - baseline / 2.0
                  }.get(va, rymin)
        else:
            ox = {"center": (xmin + xmax) / 2.0, "right": xmax}.get(ha, xmin)
            oy = {"center": (ymin + ymax) / 2.0, "top": ymax,
                  "baseline": ymax - baseline,
                  "center_baseline": ymax - baseline / 2.0}.get(va, ymin)
            ox, oy = rot(ox, oy)
        bx0, by0 = rxmin - ox, rymin - oy
        lx, ly = rot(0.0, y_line)
        return ((bx0, by0, bx0 + width, by0 + height),
                (lx - ox, ly - oy), d)

    def extent(self, x: float, y: float):
        """The window extent with the anchor at display (x, y); a point
        where the text is empty."""
        if not self.text:
            return (x, y, x, y)
        (x0, y0, x1, y1), _, _ = self.layout()
        return (x0 + x, y0 + y, x1 + x, y1 + y)

    def draw(self, canvas: Canvas, x: float, y: float) -> None:
        """Agg's draw_text: the string's bitmap at the rounded position of
        its ink's lower-left corner, turned about it."""
        if not self.text or not np.isfinite([x, y]).all():
            return
        _, (lx, ly), _ = self.layout()
        px, py = x + lx, canvas.height - (y + ly)
        bitmap, xo = glyphs.string_bitmap(self.text, self.size)
        d = glyphs.text_extent(self.text, self.size)[2]
        a = math.radians(self.rotation)
        xr = round(px + xo + d * math.sin(a))
        yr = round(py + d * math.cos(a))
        if self.rotation == 0.0:
            canvas.blit(bitmap, xr, yr + 1, self.color)
        else:
            canvas.blit_rotated(bitmap, xr, yr + 1, self.rotation,
                                self.color)


# -- ticks ------------------------------------------------------------------

def nonsingular(vmin, vmax, expander=0.001, tiny=1e-15, increasing=True):
    """matplotlib.transforms.nonsingular."""
    if not (np.isfinite(vmin) and np.isfinite(vmax)):
        return -expander, expander
    swapped = False
    if vmax < vmin:
        vmin, vmax, swapped = vmax, vmin, True
    vmin, vmax = float(vmin), float(vmax)
    maxabs = max(abs(vmin), abs(vmax))
    if maxabs < (1e6 / tiny) * np.finfo(float).tiny:
        vmin, vmax = -expander, expander
    elif vmax - vmin <= maxabs * tiny:
        if vmax == 0 and vmin == 0:
            vmin, vmax = -expander, expander
        else:
            vmin -= expander * abs(vmin)
            vmax += expander * abs(vmax)
    if swapped and not increasing:
        vmin, vmax = vmax, vmin
    return vmin, vmax


_STEPS = np.array([1, 2, 2.5, 5, 10], np.float64)
_EXTENDED = np.concatenate([0.1 * _STEPS[:-1], _STEPS, [10 * _STEPS[1]]])


def _edge_close(ms, edge, step, offset):
    if offset > 0:
        digits = np.log10(offset / step)
        tol = min(0.4999, max(1e-10, 10 ** (digits - 12)))
    else:
        tol = 1e-10
    return abs(ms - edge) < tol


def max_n_ticks(vmin: float, vmax: float, nbins: int,
                min_n_ticks: int = 2) -> np.ndarray:
    """MaxNLocator(steps=[1, 2, 2.5, 5, 10]).tick_values, nbins given."""
    vmin, vmax = nonsingular(vmin, vmax, expander=1e-13, tiny=1e-14)
    dv = abs(vmax - vmin)
    meanv = (vmax + vmin) / 2
    if abs(meanv) / dv < 100:
        offset = 0
    else:
        offset = math.copysign(10 ** (math.log10(abs(meanv)) // 1), meanv)
    scale = 10 ** (math.log10(dv / nbins) // 1)
    _vmin, _vmax = vmin - offset, vmax - offset
    steps = _EXTENDED * scale
    raw_step = (_vmax - _vmin) / nbins
    large = steps >= raw_step
    istep = np.nonzero(large)[0][0] if large.any() else len(steps) - 1
    ticks = None
    for step in steps[:istep + 1][::-1]:
        best_vmin = (_vmin // step) * step
        off = abs(offset)
        d, m = divmod(_vmin - best_vmin, step)
        low = d + 1 if _edge_close(m / step, 1, step, off) else d
        d, m = divmod(_vmax - best_vmin, step)
        high = d if _edge_close(m / step, 0, step, off) else d + 1
        ticks = np.arange(low, high + 1) * step + best_vmin
        nticks = ((ticks <= _vmax) & (ticks >= _vmin)).sum()
        if nticks >= min_n_ticks:
            break
    return ticks + offset


def scalar_format(locs: np.ndarray, view: Tuple[float, float]):
    """ScalarFormatter's labels for `locs` (all of them, as format_ticks
    gets them) and its offset text, under the default rcParams (offset on,
    threshold 4, power limits -5 and 6, the Unicode minus)."""
    locs = np.asarray(locs, np.float64)
    if not len(locs):
        return [], ""
    vmin, vmax = sorted(view)
    visible = locs[(vmin <= locs) & (locs <= vmax)]
    offset = 0.0
    if len(visible):
        lmin, lmax = visible.min(), visible.max()
        if not (lmin == lmax or lmin <= 0 <= lmax):
            abs_min, abs_max = sorted([abs(float(lmin)), abs(float(lmax))])
            sign = math.copysign(1, lmin)
            oom_max = np.ceil(math.log10(abs_max))
            oom = 1 + next(o for o in itertools.count(oom_max, -1)
                           if abs_min // 10 ** o != abs_max // 10 ** o)
            if (abs_max - abs_min) / 10 ** oom <= 1e-2:
                oom = 1 + next(o for o in itertools.count(oom_max, -1)
                               if abs_max // 10 ** o - abs_min // 10 ** o > 1)
            offset = (sign * (abs_max // 10 ** oom) * 10 ** oom
                      if abs_max // 10 ** oom >= 10 ** 3 else 0)
    oom_mag = 0
    if len(visible):
        if offset:
            oom = math.floor(math.log10(vmax - vmin))
        else:
            val = np.abs(visible).max()
            oom = 0 if val == 0 else math.floor(math.log10(val))
        oom_mag = oom if (oom <= -5 or oom >= 6) else 0
    # the format: the fewest decimals that show every tick
    _locs = locs if len(locs) >= 2 else np.array([*locs, *view])
    scaled = (np.asarray(_locs) - offset) / 10. ** oom_mag
    loc_range = np.ptp(scaled)
    if loc_range == 0:
        loc_range = np.max(np.abs(scaled))
    if loc_range == 0:
        loc_range = 1
    if len(locs) < 2:
        scaled = scaled[:-2]
    loc_range_oom = int(math.floor(math.log10(loc_range)))
    sigfigs = max(0, 3 - loc_range_oom)
    thresh = 1e-3 * 10 ** loc_range_oom
    while sigfigs >= 0:
        if np.abs(scaled - np.round(scaled, decimals=sigfigs)).max() < thresh:
            sigfigs -= 1
        else:
            break
    fmt = f"%1.{sigfigs + 1}f"
    labels = []
    for x in locs:
        xp = (x - offset) / (10. ** oom_mag)
        if abs(xp) < 1e-8:
            xp = 0
        labels.append((fmt % xp).replace("-", MINUS))
    text = ""
    if oom_mag or offset:
        off_s = sci_s = ""
        if offset:
            e = math.floor(math.log10(abs(offset)))
            s = round(offset / 10 ** e, 10)
            sig = ("%d" if s % 1 == 0 else "%1.10g") % s
            off_s = sig if e == 0 else f"{sig}e{e}"
            if offset > 0:
                off_s = "+" + off_s
        if oom_mag:
            sci_s = "1e%d" % oom_mag
        text = (sci_s + off_s).replace("-", MINUS)
    return labels, text


def _contains_close(interval, val, rtol=1e-10):
    a, b = sorted(interval)
    r = (b - a) * rtol
    return a - r <= val <= b + r


# -- axes -------------------------------------------------------------------

@dataclass
class _Line:
    xy: np.ndarray
    color: tuple
    width: float          # points
    zorder: float = 2.0


@dataclass
class _Scatter:
    xy: np.ndarray
    colors: np.ndarray    # (N, 4)
    s: float              # marker area, points^2
    zorder: float = 1.0
    one_color: bool = False


@dataclass
class _Segments:
    segs: np.ndarray      # (N, 2, 2) data
    color: tuple
    width: float
    zorder: float = 2.0


@dataclass
class _Quiver:
    xy: np.ndarray
    uv: np.ndarray
    scale: float
    color: tuple
    zorder: float = 1.0


@dataclass
class _DataText:
    x: float
    y: float
    text: Text
    zorder: float = 3.0


@dataclass
class _Image:
    data: np.ma.MaskedArray
    cmap: "Colormap"
    vmin: float
    vmax: float
    zorder: float = 0.0


@dataclass
class _AxisState:
    name: str                       # "x" or "y"
    label: Text = None
    fixed_locs: Optional[np.ndarray] = None
    fixed_labels: Optional[List[str]] = None
    tick_text: dict = field(default_factory=dict)
    side: str = ""                  # "bottom"/"left", or "right"
    ticks_on: bool = True


class Axes:
    """One axes: its box, limits, data and decorations."""

    def __init__(self, fig: "Figure", cell: Tuple[float, float, float, float]):
        self.fig = fig
        self.cell = cell              # figure fractions (x0, y0, x1, y1)
        self.anchor = (0.5, 0.5)
        self.aspect = "auto"          # or 1.0
        self.adjustable = "box"
        self.box_aspect = None
        self.artists: list = []
        self.datalim = [np.inf, np.inf, -np.inf, -np.inf]
        self.sticky_x: List[float] = []
        self.sticky_y: List[float] = []
        self.xlim = (0.0, 1.0)
        self.ylim = (0.0, 1.0)
        self.autoscale = [True, True]
        self.y_inverted = False
        self.grid_on = False
        self.title = Text("", TITLE_SIZE, ha="center", va="baseline")
        self.xaxis = _AxisState("x", Text("", ha="center", va="top"),
                                side="bottom")
        self.yaxis = _AxisState("y", Text("", ha="center", va="bottom",
                                          rotation=90.0,
                                          rotation_mode="anchor"),
                                side="left")
        self.legend_: Optional["Legend"] = None
        self.colorbar_outline = False
        self.n_lines = 0
        self.active = None

    # -- user calls -------------------------------------------------------

    def plot(self, x, y, color=None, lw: float = LINE_WIDTH):
        xy = np.column_stack([np.asarray(x, np.float64).reshape(-1),
                              np.asarray(y, np.float64).reshape(-1)])
        if color is None:
            color = CYCLE[self.n_lines % len(CYCLE)]
            self.n_lines += 1
        self.artists.append(_Line(xy, to_rgba(color), float(lw)))
        self._update_datalim(xy)

    def scatter(self, x, y, s: float, c, zorder: float = 1.0):
        xy = np.column_stack([np.asarray(x, np.float64).reshape(-1),
                              np.asarray(y, np.float64).reshape(-1)])
        one = isinstance(c, str)
        if one:
            colors = np.tile(to_rgba(c), (len(xy), 1))
        else:
            colors = np.array([to_rgba(v) for v in c], np.float64)
        self.artists.append(_Scatter(xy, colors.reshape(-1, 4), float(s),
                                     zorder, one))
        self._update_datalim(xy)

    def add_segments(self, segs, color, linewidth: float):
        segs = np.asarray(segs, np.float64)
        self.artists.append(_Segments(segs, to_rgba(color), linewidth))
        if segs.size:
            self._update_datalim(segs.reshape(-1, 2))

    def quiver(self, x, y, u, v, scale: float, color):
        xy = np.column_stack([x, y]).astype(np.float64)
        uv = np.column_stack([u, v]).astype(np.float64)
        self.artists.append(_Quiver(xy, uv, float(scale), to_rgba(color)))
        self._update_datalim(xy)

    def text(self, x, y, s, fontsize=FONT_SIZE, color="black",
             ha="left", va="baseline"):
        self.artists.append(_DataText(float(x), float(y),
                                      Text(s, fontsize, color, ha, va)))

    def imshow(self, data, cmap: "Colormap"):
        a = np.ma.masked_invalid(np.asarray(data, np.float64))
        vmin = float(a.min()) if a.count() else 0.0
        vmax = float(a.max()) if a.count() else 0.0
        img = _Image(a, cmap, vmin, vmax)
        self.artists.append(img)
        m, n = a.shape
        self.aspect, self.adjustable = 1.0, "box"
        self._update_datalim(np.array([[-0.5, n - 0.5], [m - 0.5, -0.5]]))
        self.sticky_x, self.sticky_y = [-0.5, n - 0.5], [-0.5, m - 0.5]
        self.xlim, self.ylim = (-0.5, n - 0.5), (m - 0.5, -0.5)
        self.y_inverted = True
        return img

    def axis_equal(self):
        self.aspect, self.adjustable = 1.0, "datalim"

    def set_title(self, s):
        self.title.text = s

    def set_xlabel(self, s):
        self.xaxis.label.text = s

    def set_ylabel(self, s):
        self.yaxis.label.text = s

    def set_xticks(self, ticks, labels, **text_kw):
        self.xaxis.fixed_locs = np.asarray(ticks, np.float64)
        self.xaxis.fixed_labels = [str(s) for s in labels]
        self.xaxis.tick_text = text_kw

    def set_yticks(self, ticks, labels, **text_kw):
        self.yaxis.fixed_locs = np.asarray(ticks, np.float64)
        self.yaxis.fixed_labels = [str(s) for s in labels]
        self.yaxis.tick_text = text_kw

    def grid(self):
        self.grid_on = True

    def legend(self, labels):
        lines = [a for a in self.artists if isinstance(a, _Line)]
        self.legend_ = Legend(self, list(zip(lines, labels)))

    # -- limits and boxes -------------------------------------------------

    def _update_datalim(self, xy):
        xy = xy[np.isfinite(xy).all(axis=1)]
        if not len(xy):
            return
        lo, hi = xy.min(axis=0), xy.max(axis=0)
        d = self.datalim
        self.datalim = [min(d[0], lo[0]), min(d[1], lo[1]),
                        max(d[2], hi[0]), max(d[3], hi[1])]

    def _autoscale(self):
        """Axes.autoscale_view (not tight): the data's range, 0.05 margins
        not past a sticky edge."""
        for i, (lo_i, hi_i, sticky) in enumerate(
                ((0, 2, self.sticky_x), (1, 3, self.sticky_y))):
            if not self.autoscale[i]:
                continue
            x0, x1 = self.datalim[lo_i], self.datalim[hi_i]
            if not (np.isfinite(x0) and np.isfinite(x1)):
                x0, x1 = -np.inf, np.inf
            x0, x1 = nonsingular(x0, x1, expander=0.05)
            stickies = np.sort(np.asarray(sticky, np.float64))
            tol = 1e-5 * abs(x1 - x0)
            i0 = stickies.searchsorted(x0 + tol) - 1
            x0bound = stickies[i0] if i0 != -1 else None
            i1 = stickies.searchsorted(x1 - tol)
            x1bound = stickies[i1] if i1 != len(stickies) else None
            delta = (x1 - x0) * MARGIN
            if not np.isfinite(delta):
                delta = 0
            x0, x1 = x0 - delta, x1 + delta
            if x0bound is not None:
                x0 = max(x0, x0bound)
            if x1bound is not None:
                x1 = min(x1, x1bound)
            x0, x1 = nonsingular(x0, x1, expander=1e-12, tiny=1e-13)
            if i == 0:
                self.xlim = (x0, x1)
            else:
                self.ylim = (x1, x0) if self.y_inverted else (x0, x1)

    def apply_aspect(self):
        """Axes.apply_aspect: the active box (figure fractions) and, under
        adjustable "datalim", the limits."""
        position = self.cell
        fw, fh = self.fig.size
        fig_aspect = fh / fw
        if self.aspect == "auto" and self.box_aspect is None:
            self.active = position
            return
        if self.adjustable == "box" and self.aspect != "auto":
            xs = max(abs(self.xlim[1] - self.xlim[0]), 1e-30)
            ys = max(abs(self.ylim[1] - self.ylim[0]), 1e-30)
            box_aspect = self.aspect * (ys / xs)
            size = _shrunk_to_aspect(position, box_aspect, fig_aspect)
            self.active = _anchored(size, position, self.anchor)
            return
        if self.box_aspect is not None:
            size = _shrunk_to_aspect(position, self.box_aspect, fig_aspect)
            self.active = _anchored(size, position, self.anchor)
            if self.aspect == "auto":
                return
            position = self.active
        else:
            self.active = position
        xmin, xmax = sorted(self.xlim)
        ymin, ymax = sorted(self.ylim)
        xsize = max(abs(xmax - xmin), 1e-30)
        ysize = max(abs(ymax - ymin), 1e-30)
        box_aspect = fig_aspect * ((position[3] - position[1])
                                   / (position[2] - position[0]))
        data_ratio = box_aspect / self.aspect
        y_expander = data_ratio * xsize / ysize - 1
        if abs(y_expander) < 0.005:
            return
        x0, y0, x1, y1 = self.datalim
        xr, yr = 1.05 * (x1 - x0), 1.05 * (y1 - y0)
        xmarg, ymarg = xsize - xr, ysize - yr
        Ysize = data_ratio * xsize
        Xsize = ysize / data_ratio
        Xmarg, Ymarg = Xsize - xr, Ysize - yr
        if xmarg > 0 and ymarg > 0:
            adjust_y = ((Ymarg > 0 and y_expander < 0)
                        or (Xmarg < 0 and y_expander > 0))
        else:
            adjust_y = y_expander > 0
        if adjust_y:
            yc = 0.5 * (ymin + ymax)
            lo, hi = nonsingular(yc - Ysize / 2.0, yc + Ysize / 2.0,
                                 expander=0.05)
            self.ylim = (hi, lo) if self.y_inverted else (lo, hi)
        else:
            xc = 0.5 * (xmin + xmax)
            self.xlim = nonsingular(xc - Xsize / 2.0, xc + Xsize / 2.0,
                                    expander=0.05)

    def bbox(self):
        """The active box in display pixels."""
        fw, fh = self.fig.size
        x0, y0, x1, y1 = self.active
        return (x0 * fw, y0 * fh, x1 * fw, y1 * fh)

    def to_display(self, xy):
        """transData: data -> display pixels."""
        xy = np.asarray(xy, np.float64)
        bx0, by0, bx1, by1 = self.bbox()
        (vx0, vx1), (vy0, vy1) = self.xlim, self.ylim
        sx = (bx1 - bx0) / (vx1 - vx0)
        sy = (by1 - by0) / (vy1 - vy0)
        out = np.empty_like(xy)
        out[..., 0] = (xy[..., 0] - vx0) * sx + bx0
        out[..., 1] = (xy[..., 1] - vy0) * sy + by0
        return out

    # -- ticks ------------------------------------------------------------

    def _view(self, axis: _AxisState):
        return self.xlim if axis.name == "x" else self.ylim

    def tick_locs(self, axis: _AxisState) -> np.ndarray:
        if axis.fixed_locs is not None:
            return axis.fixed_locs
        bx0, by0, bx1, by1 = self.bbox()
        length = ((bx1 - bx0) if axis.name == "x" else (by1 - by0)) \
            / DPI * 72
        size = FONT_SIZE * (3 if axis.name == "x" else 2)
        nbins = int(np.clip(int(np.floor(length / size)), 1, 9))
        vmin, vmax = self._view(axis)
        return max_n_ticks(vmin, vmax, nbins)

    def ticks(self, axis: _AxisState):
        """The ticks to draw: (loc, label text object) inside the view,
        and the axis' offset text."""
        if not axis.ticks_on:
            return [], ""
        locs = self.tick_locs(axis)
        if axis.fixed_labels is not None:
            labels, offset = list(axis.fixed_labels), ""
            labels += [""] * (len(locs) - len(labels))
        else:
            labels, offset = scalar_format(locs, self._view(axis))
        view = self._view(axis)
        out = []
        for loc, label in zip(locs, labels):
            if _contains_close(view, loc):
                out.append((loc, label))
        return out, offset

    def _tick_label(self, axis: _AxisState, label: str) -> Text:
        kw = dict(axis.tick_text)
        if axis.name == "x":
            t = Text(label, FONT_SIZE, ha=kw.get("ha", "center"), va="top",
                     rotation=kw.get("rotation", 0.0))
        elif axis.side == "left":
            t = Text(label, FONT_SIZE, ha="right", va="center_baseline")
        else:
            t = Text(label, FONT_SIZE, ha="left", va="center_baseline")
        return t

    def tick_label_boxes(self, axis: _AxisState):
        """[(tick location in display, Text, anchor (x, y), box)]."""
        bx0, by0, bx1, by1 = self.bbox()
        pad = points(TICK_SIZE + TICK_PAD)
        ticks, offset = self.ticks(axis)
        out = []
        for loc, label in ticks:
            t = self._tick_label(axis, label)
            if axis.name == "x":
                p = self.to_display(np.array([loc, self.ylim[0]]))[0]
                anchor = (p, by0 - pad)
            else:
                p = self.to_display(np.array([self.xlim[0], loc]))[1]
                anchor = ((bx0 - pad) if axis.side == "left"
                          else (bx1 + pad), p)
            out.append((p, t, anchor, t.extent(*anchor)))
        return out, offset

    def _spine_box(self, axis: _AxisState):
        """The window extent of the spine the axis' ticks sit on, with its
        outward ticks."""
        bx0, by0, bx1, by1 = self.bbox()
        tick = points(TICK_SIZE)
        if axis.name == "x":
            return (bx0, by0 - tick, bx1, by0)
        if axis.side == "left":
            return (bx0 - tick, by0, bx0, by1)
        return (bx1, by0, bx1 + tick, by1)

    def axis_layout(self, axis: _AxisState):
        """The tick labels, the axis label's anchor and the offset text's
        anchor (`_update_label_position`, `_update_offset_text_position`)."""
        bx0, by0, bx1, by1 = self.bbox()
        labels, offset = self.tick_label_boxes(axis)
        boxes = [b for _, _, _, b in labels]
        lpad = points(LABEL_PAD)
        opad = points(OFFSET_TEXT_PAD)
        spine = self._spine_box(axis) if axis.ticks_on else \
            (bx0, by0, bx1, by0)
        if axis.name == "x":
            bb = union(boxes + [spine])
            label_at = ((bx0 + bx1) / 2, bb[1] - lpad)
            bottom = union(boxes)[1] if boxes else by0
            offset_at = (bx1, bottom - opad)
            offset_text = Text(offset, FONT_SIZE, ha="right", va="top")
        else:
            bb = union(boxes + [spine])
            label_at = (bb[0] - lpad, (by0 + by1) / 2)
            offset_at = ((bx0, by1 + opad) if axis.side == "left"
                         else (bx1, by1 + opad))
            offset_text = Text(offset, FONT_SIZE, va="baseline",
                               ha="left" if axis.side == "left" else "right")
        return labels, label_at, offset_text, offset_at

    def tightbbox(self):
        """Axes.get_tightbbox(for_layout_only=True): the tick labels, the
        axis labels (an x label 1 px wide, a y label 1 px tall), the offset
        texts, the axes box and the title."""
        bb = []
        for axis in (self.xaxis, self.yaxis):
            labels, label_at, off, off_at = self.axis_layout(axis)
            boxes = [b for _, _, _, b in labels]
            if off.text:
                boxes.append(off.extent(*off_at))
            if axis.label.text:
                b = list(axis.label.extent(*label_at))
                if axis.name == "x" and b[2] > b[0]:
                    b[0] = (b[0] + b[2]) / 2 - 0.5
                    b[2] = b[0] + 1.0
                if axis.name == "y" and b[3] > b[1]:
                    b[1] = (b[1] + b[3]) / 2 - 0.5
                    b[3] = b[1] + 1.0
                boxes.append(tuple(b))
            boxes = [b for b in boxes if _sized(b)]
            if boxes:
                bb.append(union(boxes))
        bb.append(self.bbox())
        if self.title.text:
            t = list(self.title.extent(*self.title_anchor()))
            t[0] = (t[0] + t[2]) / 2 - 0.5
            t[2] = t[0] + 1.0
            bb.append(tuple(t))
        return union([b for b in bb if b[2] != b[0] or b[3] != b[1]])

    def title_anchor(self):
        bx0, by0, bx1, by1 = self.bbox()
        return ((bx0 + bx1) / 2, by1 + points(TITLE_PAD))

    # -- drawing ----------------------------------------------------------

    def prepare(self):
        """What Axes.draw does before drawing: autoscale, then aspect."""
        self._autoscale()
        self.apply_aspect()

    def clip(self, canvas: Canvas):
        bx0, by0, bx1, by1 = self.bbox()
        return (bx0, canvas.height - by1, bx1, canvas.height - by0)

    def _flip(self, canvas, xy):
        out = np.array(xy, np.float64)
        out[..., 1] = canvas.height - out[..., 1]
        return out

    def draw(self, canvas: Canvas):
        items = [(a.zorder, i, a) for i, a in enumerate(self.artists)]
        items += [(1.5, len(items), "axes"), (2.5, len(items) + 1, "spines"),
                  (3.0, len(items) + 2, "title")]
        if self.legend_ is not None:
            items.append((5.0, len(items), self.legend_))
        for _, _, a in sorted(items, key=lambda t: (t[0], t[1])):
            if a == "axes":
                self._draw_axis(canvas, self.xaxis)
                self._draw_axis(canvas, self.yaxis)
            elif a == "spines":
                self._draw_spines(canvas)
            elif a == "title":
                self.title.draw(canvas, *self.title_anchor())
            elif isinstance(a, Legend):
                a.draw(canvas)
            else:
                self._draw_artist(canvas, a)

    def _draw_artist(self, canvas, a):
        clip = self.clip(canvas)
        if isinstance(a, _Line):
            xy = self._flip(canvas, self.to_display(a.xy))
            w = points(a.width)
            canvas.stroke(snap(xy, w), w, a.color, "projecting", clip)
        elif isinstance(a, _Scatter):
            xy = self._flip(canvas, self.to_display(a.xy))
            if a.one_color:
                # one colour: Agg's draw_markers, at whole pixels
                xy = np.floor(xy + 0.5)
            r = points(math.sqrt(a.s) / 2 + LINE_WIDTH / 2)
            canvas.disks(xy, r, a.colors, clip)
        elif isinstance(a, _Segments):
            segs = self._flip(canvas, self.to_display(a.segs))
            canvas.segments(segs, points(a.width), a.color, clip)
        elif isinstance(a, _Quiver):
            for poly in self._quiver_polygons(canvas, a):
                canvas.fill_polygon(poly, a.color, clip)
        elif isinstance(a, _DataText):
            x, y = self.to_display(np.array([a.x, a.y]))
            a.text.draw(canvas, x, y)
        elif isinstance(a, _Image):
            bx0, by0, bx1, by1 = self.bbox()
            rgba = a.cmap.colors(a.data, a.vmin, a.vmax)
            m, n = a.data.shape
            # the image's corners, from its extent through transData
            (x0, y0), (x1, y1) = self.to_display(
                np.array([[-0.5, -0.5], [n - 0.5, m - 0.5]]))
            canvas.image_nearest(rgba, x0, canvas.height - y0, x1,
                                 canvas.height - y1, clip)

    def _quiver_polygons(self, canvas, q: _Quiver):
        """Quiver's arrows (units "width", angles "uv", pivot "tail",
        headwidth 3, headlength 5, headaxislength 4.5, minshaft 1,
        minlength 1) as canvas polygons."""
        bx0, by0, bx1, by1 = self.bbox()
        dx = bx1 - bx0
        n = len(q.xy)
        width = 0.06 * 1.0 / np.clip(math.sqrt(n), 8, 25)
        uv = q.uv[:, 0] + 1j * q.uv[:, 1]
        a = np.abs(uv)
        length = a * (1.0 / (q.scale * width))
        X, Y = _h_arrows(length)
        theta = np.angle(uv).reshape(-1, 1)
        xy = (X + Y * 1j) * np.exp(1j * theta) * width
        offsets = self.to_display(q.xy)
        polys = []
        for k in range(n):
            p = np.column_stack([xy[k].real * dx + offsets[k, 0],
                                 xy[k].imag * dx + offsets[k, 1]])
            polys.append(self._flip(canvas, p))
        return polys

    def _draw_axis(self, canvas, axis: _AxisState):
        labels, label_at, off, off_at = self.axis_layout(axis)
        bx0, by0, bx1, by1 = self.bbox()
        H = canvas.height
        tw, tl = points(TICK_WIDTH), points(TICK_SIZE)
        for p, text, anchor, _ in labels:
            if self.grid_on:
                if axis.name == "x":
                    line = np.array([[p, H - by0], [p, H - by1]])
                else:
                    line = np.array([[bx0, H - p], [bx1, H - p]])
                gw = points(GRID_WIDTH)
                canvas.stroke(snap(line, gw), gw, to_rgba(GRID_COLOR),
                              "projecting", self.clip(canvas))
            # the tick: a marker at the rounded position, its path snapped
            if axis.name == "x":
                ox, oy = np.floor(p + 0.5), np.floor(H - by0 + 0.5)
                mark = np.array([[0.0, 0.0], [0.0, tl]])
            elif axis.side == "left":
                ox, oy = np.floor(bx0 + 0.5), np.floor(H - p + 0.5)
                mark = np.array([[0.0, 0.0], [-tl, 0.0]])
            else:
                ox, oy = np.floor(bx1 + 0.5), np.floor(H - p + 0.5)
                mark = np.array([[0.0, 0.0], [tl, 0.0]])
            canvas.stroke(snap(mark, tw) + (ox, oy), tw, (0, 0, 0, 1),
                          "butt")
            text.draw(canvas, *anchor)
        axis.label.draw(canvas, *label_at)
        off.draw(canvas, *off_at)

    def _draw_spines(self, canvas):
        bx0, by0, bx1, by1 = self.bbox()
        H = canvas.height
        w = points(AXES_LINE_WIDTH)
        black = (0.0, 0.0, 0.0, 1.0)
        if self.colorbar_outline:
            path = np.array([[bx0, H - by0], [bx0, H - by1], [bx1, H - by1],
                             [bx1, H - by0], [bx0, H - by0]])
            canvas.stroke(snap(path, w), w, black, "butt")
            return
        for seg in ([[bx0, H - by0], [bx0, H - by1]],
                    [[bx1, H - by0], [bx1, H - by1]],
                    [[bx0, H - by0], [bx1, H - by0]],
                    [[bx0, H - by1], [bx1, H - by1]]):
            canvas.stroke(snap(np.array(seg), w), w, black, "butt")


def _h_arrows(length):
    """Quiver._h_arrows at the default head sizes: (N, 8) x and y of each
    arrow in arrow-width units."""
    headwidth, headlength, headaxislength = 3.0, 5.0, 4.5
    minsh = 1.0 * headlength
    N = len(length)
    length = np.clip(length.reshape(N, 1), 0, 2 ** 16)
    x = np.array([0, -headaxislength, -headlength, 0], np.float64)
    x = x + np.array([0, 1, 1, 1]) * length
    y = 0.5 * np.array([1, 1, headwidth, 0], np.float64)
    y = np.repeat(y[np.newaxis, :], N, axis=0)
    x0 = np.array([0, minsh - headaxislength, minsh - headlength, minsh],
                  np.float64)
    y0 = 0.5 * np.array([1, 1, headwidth, 0], np.float64)
    ii = [0, 1, 2, 3, 2, 1, 0, 0]
    X, Y = x[:, ii], y[:, ii]
    Y[:, 3:-1] *= -1
    X0, Y0 = x0[ii], y0[ii]
    Y0[3:-1] *= -1
    shrink = length / minsh
    X0 = shrink * X0[np.newaxis, :]
    Y0 = shrink * Y0[np.newaxis, :]
    short = np.repeat(length < minsh, 8, axis=1)
    np.copyto(X, X0, where=short)
    np.copyto(Y, Y0, where=short)
    tooshort = length < 1.0
    if tooshort.any():
        th = np.arange(0, 8, 1, np.float64) * (np.pi / 3.0)
        x1 = np.cos(th) * 0.5
        y1 = np.sin(th) * 0.5
        X1 = np.repeat(x1[np.newaxis, :], N, axis=0)
        Y1 = np.repeat(y1[np.newaxis, :], N, axis=0)
        tooshort = np.repeat(tooshort, 8, 1)
        np.copyto(X, X1, where=tooshort)
        np.copyto(Y, Y1, where=tooshort)
    return X, Y


# -- legend -----------------------------------------------------------------

class Legend:
    """legend(loc="best") of line handles in one column."""

    CODES = ("NE", "NW", "SW", "SE", "E", "W", "E", "S", "N", "C")
    ANCHORS = {"C": (0.5, 0.5), "SW": (0, 0), "S": (0.5, 0), "SE": (1, 0),
               "E": (1, 0.5), "NE": (1, 1), "N": (0.5, 1), "NW": (0, 1),
               "W": (0, 0.5)}

    def __init__(self, ax: Axes, entries):
        self.ax, self.entries = ax, entries

    def _layout(self):
        """The entries' boxes relative to the legend's origin: the packed
        size (w, h), and for each entry its baseline origin."""
        f = points(FONT_SIZE)
        _, lp_h, lp_d = glyphs.text_extent("lp", FONT_SIZE)
        handle_w, handle_h = 2.0 * f, 0.7 * f
        sep_x, sep_y, pad = 0.8 * f, 0.5 * f, 0.4 * f
        rows = []
        for _, label in self.entries:
            t = Text(label, FONT_SIZE)
            (bx0, by0, bx1, by1), _, yd = t.layout()
            w, h = bx1 - bx0, by1 - by0
            h_d = max(lp_h - lp_d, h - yd)
            d = max(yd, lp_d)
            # the entry: handle box (0, 0, handle_w, handle_h) and the text
            # box (-d .. h_d), aligned on their baselines
            y0, y1 = min(0.0, -d), max(handle_h, h_d)
            rows.append((handle_w + sep_x + w, y0, y1, t))
        width = max(r[0] for r in rows)
        heights = [r[2] - r[1] for r in rows]
        height = sum(heights) + sep_y * (len(rows) - 1)
        origins, top = [], 0.0
        ydescent = height - rows[0][2]
        for (_, y0, y1, _), hgt in zip(rows, heights):
            origins.append(height - (top + y1) - ydescent)
            top += hgt + sep_y
        W, H = width + 2 * pad, height + 2 * pad
        # origin of the packed box relative to the padded box's lower-left
        return (W, H, pad, ydescent + pad, origins,
                [r[3] for r in rows], handle_w, handle_h, sep_x)

    def position(self):
        """The padded box's lower-left corner: the first of matplotlib's
        nine places with the least badness."""
        W, H = self._layout()[:2]
        ax = self.ax
        bb = ax.bbox()
        pad = 0.5 * points(FONT_SIZE)
        container = (bb[0] + pad, bb[1] + pad, bb[2] - pad, bb[3] - pad)
        lines = [ax.to_display(line.xy) for line, _ in self.entries]
        lines += [ax.to_display(a.xy) for a in ax.artists
                  if isinstance(a, _Line)
                  and all(a is not e[0] for e in self.entries)]
        candidates = []
        for idx, code in enumerate(self.CODES, start=1):
            l, b, _, _ = _anchored((W, H), container, self.ANCHORS[code])
            box = (l, b, l + W, b + H)
            bad = 0
            for v in lines:
                bad += int(((v[:, 0] > box[0]) & (v[:, 0] < box[2])
                            & (v[:, 1] > box[1]) & (v[:, 1] < box[3])).sum())
            for v in lines:
                bad += int(_path_intersects_box(v, box))
            candidates.append((bad, idx, (l, b)))
            if bad == 0:
                break
        return min(candidates)[2]

    def frame(self):
        (W, H), (l, b) = self._layout()[:2], self.position()
        return (l, b, l + W, b + H)

    def text_boxes(self):
        """(Text, baseline origin in display) of each entry's label."""
        W, H, px, py, origins, texts, hw, hh, sep = self._layout()
        l, b = self.position()
        return [(t, (l + px + hw + sep, b + py + o))
                for t, o in zip(texts, origins)]

    def draw(self, canvas: Canvas):
        W, H, px, py, origins, texts, hw, hh, sep = self._layout()
        l, b = self.position()
        Hc = canvas.height
        f = points(FONT_SIZE)
        # the frame is snapped (snap=True): its corners onto pixel centres
        x0, y0, x1, y1 = (math.floor(v + 0.5) + 0.5
                          for v in (l, Hc - (b + H), l + W, Hc - b))
        canvas.rounded_rect(x0, y0, x1, y1, 0.2 * f, to_rgba("white", 0.8),
                            to_rgba("0.8", 0.8), points(1.0))
        for (line, _), t, o in zip(self.entries, texts, origins):
            x, y = l + px, b + py + o
            seg = np.array([[x, Hc - (y + hh / 2)], [x + hw, Hc - (y + hh / 2)]])
            w = points(line.width)
            canvas.stroke(snap(seg, w), w, line.color, "projecting")
            t.draw(canvas, x + hw + sep, y)


def _path_intersects_box(v, box) -> bool:
    """Path.intersects_bbox(filled=False) of a polyline."""
    if not len(v):
        return False
    x0, y0, x1, y1 = box
    cx, cy = (x0 + x1) * 0.5, (y0 + y1) * 0.5
    w, h = abs(x0 - x1), abs(y0 - y1)
    if 2.0 * abs(v[0, 0] - cx) <= w and 2.0 * abs(v[0, 1] - cy) <= h:
        return True
    m1, m2 = v[:-1], v[1:]
    with np.errstate(invalid="ignore"):     # NaN vertices hit nothing
        hit = ((np.abs(m1[:, 0] + m2[:, 0] - 2.0 * cx)
                < np.abs(m1[:, 0] - m2[:, 0]) + w)
               & (np.abs(m1[:, 1] + m2[:, 1] - 2.0 * cy)
                  < np.abs(m1[:, 1] - m2[:, 1]) + h)
               & (2.0 * np.abs((m1[:, 0] - cx) * (m1[:, 1] - m2[:, 1])
                               - (m1[:, 1] - cy) * (m1[:, 0] - m2[:, 0]))
                  < w * np.abs(m1[:, 1] - m2[:, 1])
                  + h * np.abs(m1[:, 0] - m2[:, 0])))
    return bool(hit.any())


# -- colormap and colorbar --------------------------------------------------

# ColorBrewer's Blues as matplotlib's _cm holds it
_BLUES = ((0.96862745098039216, 0.98431372549019602, 1.0),
          (0.87058823529411766, 0.92156862745098034, 0.96862745098039216),
          (0.77647058823529413, 0.85882352941176465, 0.93725490196078431),
          (0.61960784313725492, 0.792156862745098, 0.88235294117647056),
          (0.41960784313725491, 0.68235294117647061, 0.83921568627450982),
          (0.25882352941176473, 0.5725490196078431, 0.77647058823529413),
          (0.12941176470588237, 0.44313725490196076, 0.70980392156862748),
          (0.03137254901960784, 0.31764705882352939, 0.61176470588235299),
          (0.03137254901960784, 0.18823529411764706, 0.41960784313725491))


class Colormap:
    """A LinearSegmentedColormap of N entries from evenly spaced colours
    (`from_list`), "bad" transparent, as matplotlib builds it."""

    def __init__(self, name: str, colors, N: int = 256):
        self.name, self.N = name, N
        colors = np.asarray(colors, np.float64)
        x = np.linspace(0, 1, len(colors))
        lut = np.ones((N, 4))
        for ch in range(3):
            lut[:, ch] = _lookup_table(N, x, colors[:, ch])
        self.lut = lut

    def __call__(self, x: np.ndarray, bytes: bool = False) -> np.ndarray:
        """Colormap.__call__ on floats in [0, 1] (NaN gives "bad")."""
        x = np.asarray(x, np.float64)
        xa = x * self.N
        xa[xa == self.N] = self.N - 1
        bad = np.isnan(xa)
        with np.errstate(invalid="ignore"):
            idx = np.clip(xa, -1, self.N).astype(int)
        idx = np.clip(np.where(bad, 0, idx), 0, self.N - 1)
        lut = (self.lut * 255).astype(np.uint8) if bytes else self.lut
        out = lut[idx].copy()
        out[bad] = 0
        return out

    def colors(self, data: np.ma.MaskedArray, vmin: float,
               vmax: float) -> np.ndarray:
        """An image's RGBA floats: Normalize(vmin, vmax), then the table
        in bytes (Agg draws 8-bit colours); masked cells transparent."""
        if vmax == vmin:
            x = np.zeros(data.shape)
        else:
            x = (np.asarray(data.filled(np.nan), np.float64) - vmin) \
                / (vmax - vmin)
        return self(x, bytes=True).astype(np.float64) / 255.0


def _lookup_table(N, x, y):
    """matplotlib.colors._create_lookup_table for one channel whose left
    and right values agree at each node (gamma 1)."""
    xind = (N - 1) * x
    ind = np.searchsorted(xind, np.linspace(0, 1, N) ** 1.0 * (N - 1))[1:-1]
    distance = (np.linspace(0, 1, N)[1:-1] * (N - 1) - xind[ind - 1]) \
        / (xind[ind] - xind[ind - 1])
    lut = np.concatenate([[y[0]], distance * (y[ind] - y[ind - 1])
                          + y[ind - 1], [y[-1]]])
    return np.clip(lut, 0.0, 1.0)


BLUES = Colormap("Blues", _BLUES)


class _ColorbarAxes(Axes):
    """The colorbar's axes: the colormap's 256 bands from vmin to vmax,
    ticks and labels on the right, an outline."""

    def __init__(self, fig, cell, image: _Image):
        super().__init__(fig, cell)
        self.image = image
        self.anchor = (0.0, 0.5)
        self.box_aspect = 20.0
        self.adjustable = "datalim"
        self.colorbar_outline = True
        self.xaxis.ticks_on = False
        self.yaxis.side = "right"
        self.autoscale = [False, False]
        self.xlim = (0.0, 1.0)
        self.ylim = (image.vmin, image.vmax)

    def prepare(self):
        self.apply_aspect()

    def _spine_box(self, axis):
        bx0, by0, bx1, by1 = self.bbox()
        return (bx0, by0, bx1, by1)

    def draw(self, canvas: Canvas):
        bx0, by0, bx1, by1 = self.bbox()
        H = canvas.height
        n = self.image.cmap.N
        colors = self.image.cmap(
            (np.arange(n) + 0.5) / n, bytes=True).astype(np.float64) / 255.0
        # the bands bottom (vmin) to top (vmax), as an image of n rows
        canvas.image_nearest(colors[::-1, None, :], bx0, H - by1, bx1,
                             H - by0, (bx0, H - by1, bx1, H - by0))
        self._draw_axis(canvas, self.yaxis)
        self._draw_spines(canvas)


# -- figure -----------------------------------------------------------------

class Figure:
    """A figure of one axes (and, for the confusion matrix, its colorbar),
    `figsize` inches at 100 dpi, white."""

    def __init__(self, figsize=(6.4, 4.8)):
        self.size = (figsize[0] * DPI, figsize[1] * DPI)
        self.subplot = SUBPLOT
        self.ax = Axes(self, self.subplot)
        self.axes: List[Axes] = [self.ax]
        self.colorbar_of: Optional[_Image] = None

    # the gridspec cells: one subplot, or the subplot split for a colorbar
    def _cells(self):
        left, bottom, right, top = self.subplot
        if self.colorbar_of is None:
            return [(left, bottom, right, top)]
        wspace = 2 * 0.05 / (1 - 0.05)
        ratios = [1 - 0.15 - 0.05, 0.15]
        tot_w = right - left
        cell_w = tot_w / (2 + wspace * 1)
        sep_w = wspace * cell_w
        norm = cell_w * 2 / sum(ratios)
        widths = [r * norm for r in ratios]
        cell_ws = np.cumsum([0, widths[0], sep_w, widths[1]])
        lefts = left + cell_ws[0::2]
        rights = left + cell_ws[1::2]
        tot_h = top - bottom
        # three rows of height ratios (0, 1, 0), no space: full height
        cell_h = tot_h / 3
        norm_h = cell_h * 3 / 1.0
        hs = np.cumsum([0, 0 * norm_h, 0, 1 * norm_h, 0, 0 * norm_h])
        tops, bottoms = top - hs[0::2], top - hs[1::2]
        return [(lefts[0], bottoms.min(), rights[0], tops.max()),
                (lefts[1], bottoms[1], rights[1], tops[1])]

    def _place(self):
        for ax, cell in zip(self.axes, self._cells()):
            ax.cell = cell

    def colorbar(self, image: _Image):
        # the colorbar widens a singular norm, which it shares with the
        # image (Colorbar._process_values)
        image.vmin, image.vmax = nonsingular(image.vmin, image.vmax,
                                             expander=0.1)
        self.colorbar_of = image
        self.ax.anchor = (1.0, 0.5)
        cax = _ColorbarAxes(self, self.subplot, image)
        self.axes.append(cax)
        self._place()
        return cax

    def _prepare(self):
        self._place()
        for ax in self.axes:
            ax.prepare()

    def tight_layout(self, pad: float = 1.08):
        """tight_layout: one pass of `_auto_adjust_subplotpars` over the
        subplot (the axes and its colorbar share one cell), then the
        second pass the default rect (0, 0, 1, 1) asks for."""
        self._prepare()
        fw, fh = self.size
        left, bottom, right, top = self.subplot
        tight = union([ax.tightbbox() for ax in self.axes])
        tight = (tight[0] / fw, tight[1] / fh, tight[2] / fw, tight[3] / fh)
        pad_inch = pad * FONT_SIZE / 72
        ml = max(left - tight[0], 0) + pad_inch / (fw / DPI)
        mr = max(tight[2] - right, 0) + pad_inch / (fw / DPI)
        mt = max(tight[3] - top, 0) + pad_inch / (fh / DPI)
        mb = max(bottom - tight[1], 0) + pad_inch / (fh / DPI)
        if ml + mr >= 1 or mb + mt >= 1:
            print("tight_layout not applied: the margins cannot hold the "
                  "axes' decorations")
            return
        r, t = 1 - mr, 1 - mt
        # the second pass, with rect (0 + left, 0 + bottom, 1 - (1 - right),
        # 1 - (1 - top)): the same numbers, through the same arithmetic
        r2, t2 = 1 - (1 - r), 1 - (1 - t)
        self.subplot = (0 + ml, 0 + mb, 1 - (1 - r2), 1 - (1 - t2))
        self._prepare()

    def describe(self) -> List[dict]:
        """What each axes draws where, as the figure will be drawn: its box,
        limits, the ticks inside the view with their labels, and every
        text with its window extent (role, string, (x0, y0, x1, y1))."""
        self._prepare()
        out = []
        for ax in self.axes:
            d = {"box": ax.bbox(), "xlim": ax.xlim, "ylim": ax.ylim,
                 "texts": []}
            for axis in (ax.xaxis, ax.yaxis):
                ticks, _ = ax.ticks(axis)
                d[f"{axis.name}ticks"] = [loc for loc, _ in ticks]
                d[f"{axis.name}ticklabels"] = [lab for _, lab in ticks]
                labels, label_at, off, off_at = ax.axis_layout(axis)
                d["texts"] += [(f"{axis.name}tick", t.text, box)
                               for _, t, _, box in labels]
                if axis.label.text:
                    d["texts"].append((f"{axis.name}label", axis.label.text,
                                       axis.label.extent(*label_at)))
                if off.text:
                    d["texts"].append((f"{axis.name}offset", off.text,
                                       off.extent(*off_at)))
            if ax.title.text:
                d["texts"].append(("title", ax.title.text,
                                   ax.title.extent(*ax.title_anchor())))
            for a in ax.artists:
                if isinstance(a, _DataText):
                    x, y = ax.to_display(np.array([a.x, a.y]))
                    d["texts"].append(("text", a.text.text,
                                       a.text.extent(x, y)))
            if ax.legend_ is not None:
                d["texts"].append(("legend", "", ax.legend_.frame()))
                d["texts"] += [("legend_text", t.text, t.extent(*o))
                               for t, o in ax.legend_.text_boxes()]
            out.append(d)
        return out

    def render(self) -> np.ndarray:
        """The figure as (H, W, 4) uint8."""
        self._prepare()
        canvas = Canvas(round(self.size[0]), round(self.size[1]))
        for ax in self.axes:
            ax.draw(canvas)
        return canvas.rgba8()

    def savefig(self, path: str) -> None:
        png.write_png(path, self.render())
