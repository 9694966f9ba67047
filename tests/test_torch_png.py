"""The port's PNG writer and reader (`radargnn_tpu_torch/utils/png.py`),
against themselves and against matplotlib's own image I/O (CPU only; the
card's machine has no matplotlib and the port never imports it).

The writer's file, read back by the port's reader and by
`matplotlib.image.imread`, is the array it was given, bit for bit; the
reader reads the files matplotlib's Agg backend saves (whose scanlines
use the Sub, Up, Average and Paeth filters) as imread does; it refuses a
file with a bad signature or CRC.
"""

import struct
import zlib

import numpy as np
import pytest

from radargnn_tpu_torch.utils import png


def _image(seed, h=37, w=53):
    rng = np.random.default_rng(seed)
    image = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    image[: h // 3] = 255            # flat rows deflate well
    image[h // 2, :, 3] = 0
    return image


@pytest.mark.parametrize("shape", [(1, 1), (37, 53), (480, 640)])
def test_round_trip(tmp_path, shape):
    image = _image(0, *shape)
    path = str(tmp_path / "a.png")
    png.write_png(path, image)
    back = png.read_png(path)
    assert back.dtype == np.uint8 and back.shape == (*shape, 4)
    np.testing.assert_array_equal(back, image)
    assert png.encode_png(image) == open(path, "rb").read()


def test_matplotlib_reads_the_ports_file_as_its_array(tmp_path):
    """matplotlib.image.imread of the port's file is the port's array bit
    for bit (imread gives floats v / 255 for an 8-bit PNG)."""
    pytest.importorskip("matplotlib")
    import matplotlib.image
    image = _image(1)
    path = str(tmp_path / "a.png")
    png.write_png(path, image)
    got = matplotlib.image.imread(path)
    if got.dtype != np.uint8:
        assert got.dtype == np.float32
        got = np.round(got * 255.0).astype(np.uint8)
    np.testing.assert_array_equal(got, image)


def test_reader_reads_matplotlibs_files(tmp_path):
    """A figure matplotlib's Agg saves (its scanlines filtered) reads as
    imread reads it."""
    pytest.importorskip("matplotlib")
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.image
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots()
    rng = np.random.default_rng(2)
    ax.scatter(*rng.normal(size=(2, 200)), c=rng.uniform(size=200), s=30)
    ax.plot(np.sin(np.linspace(0, 9, 50)))
    path = str(tmp_path / "mpl.png")
    fig.savefig(path)
    plt.close(fig)
    data = open(path, "rb").read()
    kinds = _filter_types(data)
    assert kinds > {0}, kinds
    want = np.round(matplotlib.image.imread(path) * 255.0).astype(np.uint8)
    np.testing.assert_array_equal(png.read_png(path), want)


def _filter_types(data):
    """The scanline filter types a PNG uses."""
    pos, idat, header = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        pos += 12 + n
    w, h, _, ctype = header[:4]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    stride = w * {0: 1, 2: 3, 4: 2, 6: 4}[ctype] + 1
    return set(raw.reshape(h, stride)[:, 0].tolist())


def test_reader_refuses_a_damaged_file(tmp_path):
    data = bytearray(png.encode_png(_image(3)))
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode_png(b"GIF89a" + bytes(data[6:]))
    data[40] ^= 0xFF                  # inside IDAT: its CRC no longer holds
    with pytest.raises(ValueError, match="CRC"):
        png.decode_png(bytes(data))
    with pytest.raises(ValueError, match="uint8"):
        png.encode_png(np.zeros((4, 4, 4), np.float32))
