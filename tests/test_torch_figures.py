"""The port's figures against the JAX package's, which matplotlib 3.10 draws
(Agg, 100 dpi, the default rcParams).

The same seeded data goes through the JAX package's own plotting
(`radargnn_tpu.postprocess.visualization`, and `Trainer.show_learning_curves`
called unbound on a namespace holding the four loss lists) and through the
port's counterparts, which draw with the port's own rasteriser and PNG
writer: a 20-epoch loss history, a 2,816-point frame with the detections
the port's NMS keeps of jittered candidate boxes, a 6-class confusion
matrix in percent with one all-NaN row, and a 40-node kNN graph with
velocities. Per figure: the PNG's size, the axes box, the view limits, the
ticks and their labels, the colours, the plotted vertices' pixels, every
text's box, and that two renders are the same bits. A whole-image pixel
score is printed, not gated: a copy of matplotlib's own loss-curve PNG
shifted by one pixel still matches most of its pixels.
"""

from types import SimpleNamespace

import numpy as np
import pytest

mpl = pytest.importorskip("matplotlib")

from radargnn_tpu_torch.postprocess import figure as F  # noqa: E402
from radargnn_tpu_torch.postprocess import visualization as TV  # noqa: E402
from radargnn_tpu_torch.postprocess.extraction import (  # noqa: E402
    BoxArray as TBoxArray, BoxSuppressor)
from radargnn_tpu_torch.train.trainer import Trainer as TTrainer  # noqa: E402
from radargnn_tpu_torch.utils import png  # noqa: E402
from radargnn_tpu_torch.utils.properties import Colors  # noqa: E402

NAMES = ["background", "car", "pedestrian", "pedestrian_group",
         "two_wheeler", "large_vehicle"]
FIGURES = ("loss", "confusion", "detections", "graph")
SIZES = {"loss": (480, 640), "confusion": (600, 600),
         "detections": (480, 640), "graph": (480, 640)}
TEXT_ATOL = 2.0
ROTATED_TEXT_ATOL = 3.0
BOX_ATOL = {"loss": 1.0, "detections": 1.0, "graph": 1.0, "confusion": 3.0}
LIMIT_RTOL = 1e-9
CELL_ATOL = 2           # of 255
COLOR_ATOL = 0.1        # a vertex's pixel against its series' colour
# matplotlib's image "shows" a vertex's colour within half that: a pixel
# that antialiasing mixes to just inside the tolerance in one image may
# mix to just outside it in the other
SHOWN_ATOL = 0.05


def _data():
    rng = np.random.default_rng(21)
    e = 20
    train = 2.0 * np.exp(-np.arange(e) / 6) + 0.3 + 0.02 * rng.standard_normal(e)
    valid = train + 0.15 + 0.03 * rng.standard_normal(e)
    losses = dict(train_loss=list(train), valid_loss=list(valid),
                  train_loss_cls=list(0.6 * train),
                  train_loss_bb=list(0.4 * train - 0.05))
    # a 2,816-point frame: twelve objects and clutter
    n, k = 2816, 12
    centers = rng.uniform([-40, 0], [40, 90], (k, 2))
    pos = np.concatenate([
        centers[rng.integers(0, k, n - 400)]
        + rng.normal(0, 1.5, (n - 400, 2)),
        rng.uniform([-50, -5], [50, 95], (400, 2))])
    labels = rng.integers(0, 6, n)
    # three jittered candidate boxes an object; the port's NMS keeps one
    unit = np.array([[-.5, -.5], [.5, -.5], [.5, .5], [-.5, .5]])
    cand, scores, cls = [], [], []
    for c in centers:
        size = rng.uniform([2, 1], [5, 2.5])
        cl = rng.integers(1, 6)
        for _ in range(3):
            a = rng.uniform(0, np.pi)
            rot = np.array([[np.cos(a), np.sin(a)], [-np.sin(a), np.cos(a)]])
            cand.append(c + rng.normal(0, 0.2, 2) + (unit * size) @ rot)
            scores.append(rng.uniform(0.3, 1.0))
            cls.append(cl)
    boxes, box_scores, box_labels = BoxSuppressor.apply_nms(
        TBoxArray(np.array(cand), False), np.array(scores).reshape(-1, 1),
        np.array(cls).reshape(-1, 1), 0.1, device="cpu")
    det = dict(corners=boxes.corners, scores=box_scores[:, 0],
               labels=box_labels[:, 0])
    cm = rng.uniform(0, 1, (6, 6))
    cm = np.round(cm / cm.sum(1, keepdims=True) * 100, 2)
    cm[2] = np.nan
    gpos = rng.uniform(0, 30, (40, 2))
    d = ((gpos[:, None] - gpos[None]) ** 2).sum(-1)
    np.fill_diagonal(d, np.inf)
    senders = np.repeat(np.arange(40), 4)
    receivers = np.argsort(d, axis=1)[:, :4].reshape(-1)
    vel = rng.normal(0, 1, (40, 2))
    return dict(losses=losses, pos=pos, labels=labels, det=det, cm=cm,
                graph=(gpos, senders, receivers, vel))


def _mpl_figures(data):
    from radargnn_tpu.postprocess import visualization as JV
    from radargnn_tpu.postprocess.extraction import BoxArray as JBoxArray
    from radargnn_tpu.train.trainer import Trainer as JTrainer
    out = {}
    out["loss"], _ = JTrainer.show_learning_curves(
        SimpleNamespace(**data["losses"]))
    out["confusion"] = JV.plot_confusion_matrix(data["cm"], NAMES)
    d = data["det"]
    out["detections"], _ = JV.PredictionVisualizer.plot_detections(
        {"boxes": JBoxArray(d["corners"], False), "scores": d["scores"],
         "labels": d["labels"]}, {"pos": data["pos"],
                                  "labels": data["labels"]},
        label_names=NAMES)
    out["graph"], _ = JV.plot_graph(*data["graph"])
    return out


def _port_figures(data):
    out = {}
    trainer = SimpleNamespace(**data["losses"])
    out["loss"], _ = TTrainer.show_learning_curves(trainer)
    out["confusion"] = TV.plot_confusion_matrix(data["cm"], NAMES)
    d = data["det"]
    out["detections"], _ = TV.PredictionVisualizer.plot_detections(
        {"boxes": TBoxArray(d["corners"], False), "scores": d["scores"],
         "labels": d["labels"]}, {"pos": data["pos"],
                                  "labels": data["labels"]},
        label_names=NAMES)
    out["graph"], _ = TV.plot_graph(*data["graph"])
    return out


def _inside(view, locs):
    a, b = sorted(view)
    r = (b - a) * 1e-10
    return [(i, v) for i, v in enumerate(locs) if a - r <= v <= b + r]


def _mpl_describe(fig):
    """The same description as the port's Figure.describe, read off
    matplotlib's drawn figure."""
    out = []
    for ax in fig.axes:
        d = {"box": tuple(ax.get_window_extent().extents),
             "xlim": ax.get_xlim(), "ylim": ax.get_ylim(), "texts": []}
        for name, axis in (("x", ax.xaxis), ("y", ax.yaxis)):
            locs = list(axis.get_majorticklocs())
            labels = axis.get_majorticklabels()
            keep = _inside(axis.get_view_interval(), locs) \
                if len(labels) else []
            d[f"{name}ticks"] = [v for _, v in keep]
            d[f"{name}ticklabels"] = [labels[i].get_text() for i, _ in keep]
            d["texts"] += [(f"{name}tick", labels[i].get_text(),
                            tuple(labels[i].get_window_extent().extents))
                           for i, _ in keep]
            if axis.label.get_text():
                d["texts"].append((f"{name}label", axis.label.get_text(),
                                   tuple(axis.label.get_window_extent()
                                         .extents)))
            if axis.offsetText.get_text():
                d["texts"].append((f"{name}offset", axis.offsetText.get_text(),
                                   tuple(axis.offsetText.get_window_extent()
                                         .extents)))
        if ax.title.get_text():
            d["texts"].append(("title", ax.title.get_text(),
                               tuple(ax.title.get_window_extent().extents)))
        d["texts"] += [("text", t.get_text(),
                        tuple(t.get_window_extent().extents))
                       for t in ax.texts]
        leg = ax.get_legend()
        if leg is not None:
            d["texts"].append(("legend", "",
                               tuple(leg.get_window_extent().extents)))
            d["texts"] += [("legend_text", t.get_text(),
                            tuple(t.get_window_extent().extents))
                           for t in leg.get_texts()]
        out.append(d)
    return out


@pytest.fixture(scope="module")
def figs():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    data = _data()
    ref = _mpl_figures(data)
    port = _port_figures(data)
    out = {}
    for name in FIGURES:
        ref[name].canvas.draw()
        image = np.asarray(ref[name].canvas.buffer_rgba()).copy()
        out[name] = SimpleNamespace(
            mpl=ref[name], mpl_image=image, mpl_desc=_mpl_describe(ref[name]),
            port=port[name], port_desc=port[name].describe(),
            port_image=port[name].render())
    out["data"] = data
    yield out
    plt.close("all")


@pytest.mark.parametrize("name", FIGURES)
def test_png_size_and_reader(figs, name, tmp_path):
    """The port's PNG is matplotlib's size and reads back as the render."""
    f = figs[name]
    path = tmp_path / f"{name}.png"
    f.port.savefig(str(path))
    back = png.read_png(str(path))
    assert back.shape == (*SIZES[name], 4) == f.mpl_image.shape
    np.testing.assert_array_equal(back, f.port_image)
    mpl_path = tmp_path / f"{name}_mpl.png"
    f.mpl.savefig(str(mpl_path))
    import matplotlib.image
    assert matplotlib.image.imread(str(mpl_path)).shape == back.shape


@pytest.mark.parametrize("name", FIGURES)
def test_axes_box(figs, name):
    """The axes box (and the colorbar's) where matplotlib puts it; for the
    confusion matrix also the image's grid."""
    f = figs[name]
    assert len(f.port_desc) == len(f.mpl_desc)
    for p, m in zip(f.port_desc, f.mpl_desc):
        np.testing.assert_allclose(p["box"], m["box"], atol=BOX_ATOL[name],
                                   rtol=0)
    if name == "confusion":
        ax = f.mpl.axes[0]
        m, n = figs["data"]["cm"].shape
        grid = ax.transData.transform([[-0.5, m - 0.5], [n - 0.5, -0.5]])
        np.testing.assert_allclose(f.port_desc[0]["box"],
                                   grid.reshape(-1), atol=3.0, rtol=0)


@pytest.mark.parametrize("name", FIGURES)
def test_view_limits(figs, name):
    """get_xlim / get_ylim to 1e-9 relative, axis("equal") included."""
    f = figs[name]
    for p, m in zip(f.port_desc, f.mpl_desc):
        np.testing.assert_allclose(p["xlim"], m["xlim"], rtol=LIMIT_RTOL)
        np.testing.assert_allclose(p["ylim"], m["ylim"], rtol=LIMIT_RTOL)


@pytest.mark.parametrize("name", FIGURES)
def test_ticks_and_labels(figs, name):
    """The ticks inside the view and their label strings."""
    f = figs[name]
    for p, m in zip(f.port_desc, f.mpl_desc):
        for k in ("xticks", "yticks"):
            np.testing.assert_allclose(p[k], m[k], rtol=1e-12, atol=1e-12)
        for k in ("xticklabels", "yticklabels"):
            assert p[k] == m[k], k


@pytest.mark.parametrize("name", FIGURES)
def test_text_boxes(figs, name):
    """Every text's box within 2 px of matplotlib's window extent (3 px for
    the 45-degree labels): title, axis labels, the legend and its entries,
    tick labels, cell numbers, detection labels, the colorbar's labels."""
    f = figs[name]
    for p, m in zip(f.port_desc, f.mpl_desc):
        assert [t[:2] for t in p["texts"]] == [t[:2] for t in m["texts"]]
        for (role, s, pb), (_, _, mb) in zip(p["texts"], m["texts"]):
            atol = ROTATED_TEXT_ATOL if (name == "confusion"
                                         and role == "xtick") else TEXT_ATOL
            np.testing.assert_allclose(pb, mb, atol=atol, rtol=0,
                                       err_msg=f"{role} {s!r}")
    assert any(t[0] == "text" for t in f.port_desc[0]["texts"]) \
        or name in ("loss", "graph")


def test_series_colors(figs):
    """Each loss curve is the tab10 colour matplotlib gives it (C0-C3);
    each point is its label's colour; the graph's nodes Colors.blue."""
    from matplotlib.colors import to_rgba
    port_ax = figs["loss"].port.ax
    lines = [a for a in port_ax.artists if isinstance(a, F._Line)]
    assert [a.color for a in lines] == [
        to_rgba(line.get_color()) for line in figs["loss"].mpl.axes[0].lines]
    assert [a.color for a in lines] == [to_rgba(f"C{k}") for k in range(4)]
    data = figs["data"]
    sc = [a for a in figs["detections"].port.ax.artists
          if isinstance(a, F._Scatter)][0]
    want = np.array([to_rgba(Colors.label_id_to_color[int(v)])
                     for v in data["labels"]])
    np.testing.assert_array_equal(sc.colors, want)
    np.testing.assert_array_equal(
        sc.colors, figs["detections"].mpl.axes[0].collections[0]
        .get_facecolors())
    nodes = [a for a in figs["graph"].port.ax.artists
             if isinstance(a, F._Scatter)][0]
    assert (nodes.colors == to_rgba(Colors.blue)).all()


def test_blues_table_is_matplotlibs():
    import matplotlib
    want = matplotlib.colormaps["Blues"](np.linspace(0, 1, 256), bytes=True)
    got = F.BLUES(np.linspace(0, 1, 256), bytes=True)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def _pixel(image, xy):
    """The pixel under display point (x, y) (row, col)."""
    h = image.shape[0]
    return int(np.floor(h - xy[1])), int(np.floor(xy[0]))


def test_confusion_cells(figs):
    """Each cell's centre pixel within 2/255 of matplotlib's; the NaN row is
    white in both, away from its text."""
    f = figs["confusion"]
    ax = f.mpl.axes[0]
    cm = figs["data"]["cm"]
    for i in range(cm.shape[0]):
        for j in range(cm.shape[1]):
            r, c = _pixel(f.mpl_image, ax.transData.transform((j, i)))
            diff = np.abs(f.port_image[r, c, :3].astype(int)
                          - f.mpl_image[r, c, :3].astype(int)).max()
            assert diff <= CELL_ATOL, (i, j, f.port_image[r, c],
                                       f.mpl_image[r, c])
            if np.isnan(cm[i, j]):
                r, c = _pixel(f.mpl_image,
                              ax.transData.transform((j, i - 0.35)))
                assert (f.port_image[r, c, :3] == 255).all()
                assert (f.mpl_image[r, c, :3] == 255).all()


def _near_color(image, r, c, rgb, tol=COLOR_ATOL):
    block = image[max(r - 1, 0):r + 2, max(c - 1, 0):c + 2, :3] / 255.0
    return (np.abs(block - np.asarray(rgb)[:3]).max(axis=-1) <= tol).any()


def _at_color(image, r, c, rgb, tol=COLOR_ATOL):
    return np.abs(image[r, c, :3] / 255.0 - np.asarray(rgb)[:3]).max() <= tol


def _unoccluded(xy, gap):
    """The markers no later marker comes within `gap` pixels of."""
    d = np.sqrt(((xy[:, None] - xy[None]) ** 2).sum(-1))
    return ~np.triu(d < gap, 1).any(axis=1)


def _vertices(figs, name):
    """(display xy, colour, visible in matplotlib's image) of every
    plotted vertex: the loss curves' points, the markers' centres (a
    marker that a later one overlaps counts as hidden), the detection
    boxes' corners."""
    from matplotlib.colors import to_rgba
    ax = figs[name].mpl.axes[0]
    image = figs[name].mpl_image
    data = figs["data"]
    out = []

    def add(xy, color, near):
        r, c = _pixel(image, xy)
        seen = (_near_color if near else _at_color)(image, r, c, color,
                                                    SHOWN_ATOL)
        out.append((xy, color, seen))

    if name == "loss":
        for line in ax.lines:
            for p in ax.transData.transform(line.get_xydata()):
                add(p, to_rgba(line.get_color()), True)
    elif name == "detections":
        xy = ax.transData.transform(data["pos"])
        free = _unoccluded(xy, 6.0)
        for p, v, f in zip(xy, data["labels"], free):
            color = to_rgba(Colors.label_id_to_color[int(v)])
            if f:
                add(p, color, False)
            else:
                out.append((p, color, False))
        for corners in data["det"]["corners"]:
            for p in ax.transData.transform(corners):
                add(p, (0, 0, 0, 1), True)
    elif name == "graph":
        for p in ax.transData.transform(data["graph"][0]):
            add(p, to_rgba(Colors.blue), False)
    return out


# the least share of vertices matplotlib's own image shows (a dense
# cluster's markers hide each other)
_MIN_SEEN = {"loss": 0.9, "detections": 0.1, "graph": 0.5}


@pytest.mark.parametrize("name", ("loss", "detections", "graph"))
def test_vertices_have_series_color(figs, name):
    """Each plotted vertex, mapped through matplotlib's transData, has a
    pixel of its series' colour (within COLOR_ATOL) within 1 px in the
    port's image, wherever matplotlib's own image shows that colour there
    (within SHOWN_ATOL): a line's vertex, a box's corner, a marker's
    centre that no later marker overlaps."""
    f = figs[name]
    vertices = _vertices(figs, name)
    seen = [(xy, color) for xy, color, s in vertices if s]
    missed = [(xy, color) for xy, color in seen
              if not _near_color(f.port_image, *_pixel(f.port_image, xy),
                                 color)]
    print(f"{name}: {len(seen)} of {len(vertices)} vertices shown in "
          f"matplotlib's figure, {len(missed)} without their colour in the "
          "port's")
    assert len(seen) >= _MIN_SEEN[name] * len(vertices)
    assert not missed, missed[:5]


@pytest.mark.parametrize("name", FIGURES)
def test_two_renders_are_the_same_bits(figs, name, tmp_path):
    f = figs[name]
    np.testing.assert_array_equal(f.port.render(), f.port_image)
    f.port.savefig(str(tmp_path / "a.png"))
    f.port.savefig(str(tmp_path / "b.png"))
    assert (tmp_path / "a.png").read_bytes() == (tmp_path / "b.png").read_bytes()
    # information only: the share of pixels within 8/255 of matplotlib's
    close = (np.abs(f.port_image.astype(int) - f.mpl_image.astype(int))
             .max(axis=-1) <= 8).mean()
    print(f"{name}: {close:.4f} of the pixels within 8/255 of matplotlib's")
