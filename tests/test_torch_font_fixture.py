"""The committed glyph table the port draws its figures' text with
(`radargnn_tpu_torch/postprocess/fonts/dejavu_sans.npz`): rebuilt here
from matplotlib's own DejaVuSans.ttf through `matplotlib.ft2font.FT2Font`
under Agg's settings (hinting factor 8, `force_autohint`, 100 dpi), it
equals the committed file array for array; and the port's string metrics
from that table equal FT2Font's for every string its figures print.

To write the table anew: `python tests/test_torch_font_fixture.py`.
"""

import os
import sys
import warnings

import numpy as np
import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

from radargnn_tpu_torch.postprocess import glyphs  # noqa: E402

HINTING_FACTOR = 8
DPI = 100
_MISSING = "\U0010fffd"  # a private-use character DejaVu Sans lacks


def _font(size):
    import matplotlib
    from matplotlib.ft2font import FT2Font
    path = os.path.join(matplotlib.get_data_path(), "fonts", "ttf",
                        "DejaVuSans.ttf")
    font = FT2Font(path, hinting_factor=HINTING_FACTOR, _kerning_factor=0)
    font.set_size(size, DPI)
    return font


_PREFIXES = ("", ".", ",", "'", "|", ":", "!", "i", "l", "j")


def _phase_bitmap(font, flags, ch, phase):
    """The glyph of `ch` drawn with its pen `phase` eighths of a pixel past
    a whole pixel: FT2Font draws it after a prefix of spaces (and one
    narrow character where the spaces alone do not reach that phase),
    whose ink is masked. Its inked rows and columns, the column of its
    first inked column relative to the pen's whole pixel, and its top row
    above the baseline (FreeType's bitmap left and top)."""
    for lead in _PREFIXES:
        for k in range(2, 12):
            prefix = lead + " " * k
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                xys = font.set_text(prefix + ch, 0.0, flags=flags)
            pen = int(xys[-1][0])
            if pen % 64 != 8 * phase:
                continue
            _, h = font.get_width_height()
            y_max = h - font.get_descent()
            assert font.get_bitmap_offset()[0] == 0
            font.draw_glyphs_to_bitmap(antialiased=True)
            image = np.array(font.get_image(), np.uint8)
            font.set_text(prefix, 0.0, flags=flags)
            font.draw_glyphs_to_bitmap(antialiased=True)
            lead_ink = np.nonzero(np.asarray(font.get_image()).any(axis=0))[0]
            if len(lead_ink):
                assert lead_ink.max() + 2 < pen // 64, (ch, prefix)
                image[:, :lead_ink.max() + 1] = 0
            rows = np.nonzero(image.any(axis=1))[0]
            cols = np.nonzero(image.any(axis=0))[0]
            if not len(rows):
                return np.zeros((0, 0), np.uint8), 0, 0
            r0, c0 = rows[0], cols[0]
            crop = image[r0:rows[-1] + 1, c0:cols[-1] + 1]
            return crop, c0 - pen // 64, y_max // 64 + 1 - r0
    raise AssertionError(f"no prefix reaches phase {phase} for {ch!r}")


def build_table():
    """The table's arrays as `glyphs` reads them: per size, per character
    (the font's missing-glyph box first, as code 0), its advance and
    control box in 1/64 px, its bitmap at each of the eight pen phases
    FT2Font's hinted pens take (multiples of 1/8 px) with FreeType's left
    and top, and the size's kerning pairs."""
    from matplotlib.ft2font import Kerning, LoadFlags
    flags = LoadFlags.FORCE_AUTOHINT
    codes = np.array(glyphs.CODES, np.int32)
    arrays = {"sizes": np.array(glyphs.SIZES, np.float64), "codes": codes}
    for size in glyphs.SIZES:
        font = _font(size)
        adv, cbox, place, flat = [], [], [], []
        for code in glyphs.CODES:
            ch = chr(code) if code else _MISSING
            with warnings.catch_warnings():
                # a character the font lacks draws its missing-glyph box
                warnings.simplefilter("ignore")
                font.set_text(ch, 0.0, flags=flags)
            adv.append(font.get_width_height()[0])
            glyph = (font.load_char(code, flags=flags) if code
                     else font.load_glyph(0, flags=flags))
            cbox.append(glyph.bbox)
            for phase in range(glyphs.PHASES):
                crop, left, top = _phase_bitmap(font, flags, ch, phase)
                place.append((*crop.shape, left, top))
                flat.append(crop.reshape(-1))
        index = {c: font.get_char_index(c) for c in glyphs.CODES if c}
        kern = [(a, b, font.get_kerning(index[a], index[b], Kerning.DEFAULT))
                for a in glyphs.CODES if a for b in glyphs.CODES if b]
        kern = [k for k in kern if k[2]]
        key = glyphs.size_key(size)
        arrays[f"{key}_advance"] = np.array(adv, np.int32)
        arrays[f"{key}_cbox"] = np.array(cbox, np.int32)
        arrays[f"{key}_place"] = np.array(place, np.int32).reshape(
            len(glyphs.CODES), glyphs.PHASES, 4)
        arrays[f"{key}_alpha"] = np.concatenate(flat)
        arrays[f"{key}_kerning"] = np.array(kern, np.int32).reshape(-1, 3)
    return arrays


def write_table(path=glyphs.TABLE):
    np.savez_compressed(path, **build_table())


def test_committed_table_is_what_ft2font_draws():
    pytest.importorskip("matplotlib")
    built = build_table()
    with np.load(glyphs.TABLE) as committed:
        assert sorted(committed.files) == sorted(built)
        for k, v in built.items():
            np.testing.assert_array_equal(committed[k], v, err_msg=k)
            assert committed[k].dtype == v.dtype, k


# every string the port's figures print, and a few that kern or descend
_STRINGS = ["lp", "Training and validation loss", "Training loss",
            "Validation loss", "Training loss classification",
            "Training loss bounding box", "epoch", "loss", "True label",
            "Predicted label", "background", "car", "pedestrian",
            "pedestrian_group", "two_wheeler", "large_vehicle", "nan",
            "\N{MINUS SIGN}12.5", "0.0", "100.0", "33.33", "1e\N{MINUS SIGN}5",
            "+1.001", "AVAWAY Tj", "car 0.87", "7 0.51", "x_{y}|!~"]


@pytest.mark.parametrize("size", glyphs.SIZES)
def test_string_metrics_equal_ft2font(size):
    """Width, height and descent of each string (what matplotlib's layout
    reads), its bitmap and the bitmap's offset, from the table, equal
    FT2Font's bit for bit."""
    pytest.importorskip("matplotlib")
    from matplotlib.ft2font import LoadFlags
    font = _font(size)
    for s in _STRINGS:
        font.set_text(s, 0.0, flags=LoadFlags.FORCE_AUTOHINT)
        w, h = font.get_width_height()
        want = (w / 64, h / 64, font.get_descent() / 64)
        assert glyphs.text_extent(s, size) == want, s
        bitmap, x0 = glyphs.string_bitmap(s, size)
        font.draw_glyphs_to_bitmap(antialiased=True)
        np.testing.assert_array_equal(bitmap, np.asarray(font.get_image()),
                                      err_msg=s)
        assert x0 == font.get_bitmap_offset()[0] / 64, s


def test_missing_glyph_draws_the_box_and_says_so(capsys):
    """A character outside the table is drawn as the missing-glyph box
    (code 0) and one line names it; nothing raises."""
    glyphs._WARNED.clear()
    w, h, d = glyphs.text_extent("a中b", 10)
    assert w == sum(glyphs.text_extent(c, 10)[0] for c in "a\x00b")
    bitmap, _ = glyphs.string_bitmap("a中b", 10)
    assert bitmap.max() > 0
    glyphs.string_bitmap("中", 10)
    said = capsys.readouterr().out.strip().splitlines()
    assert len(said) == 1 and "中" in said[0] and "U+4E2D" in said[0]


if __name__ == "__main__":
    write_table()
    print(f"wrote {glyphs.TABLE}")
