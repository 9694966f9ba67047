"""The port's zstd codec (`radargnn_tpu_torch/train/zstd.py`) against
`zstandard` (installed here, not on the card's machine) and tensorstore's
own zstd chunks: the decoder's output is byte-identical on every frame,
the encoder's frames read back through `zstandard`, and corrupt input
raises ValueError rather than returning other bytes."""

import os

import numpy as np
import pytest
import zstandard
from hypothesis import given, settings, strategies as st

from radargnn_tpu_torch.train import zstd

LEVELS = (-5, 1, 3, 19)


def _inputs():
    rng = np.random.default_rng(0)
    with open(os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "README.md"), "rb") as f:
        text = f.read()[:60_000]
    return {
        # weight-like float32 over several 128 KiB blocks
        "weights": (rng.standard_normal(80_000) * 0.05).astype(
            np.float32).tobytes(),
        "moments": (rng.standard_normal(3_000) * 1e-3).astype(
            np.float32).tobytes(),
        "random": rng.integers(0, 256, 20_000, dtype=np.uint8).tobytes(),
        "runs": b"a" * 150_000 + b"bc" * 9 + bytes(40_000) + b"x",
        "text": text,
        "grid": (rng.integers(0, 9, 50_000) / 8).astype(
            np.float32).tobytes(),
        "tiny": b"abcabcabc",
        "empty": b"",
    }


INPUTS = _inputs()


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("name", sorted(INPUTS))
def test_decoder_is_zstandards(name, level):
    data = INPUTS[name]
    frame = zstandard.ZstdCompressor(level=level).compress(data)
    assert zstd.decompress(frame) == data


@pytest.mark.parametrize("level", (1, 19))
def test_checksummed_frames_are_checked(level):
    data = INPUTS["weights"][:150_000] + INPUTS["text"][:3_000]
    frame = zstandard.ZstdCompressor(level=level,
                                     write_checksum=True).compress(data)
    assert frame[4] & 4                  # the checksum flag
    assert zstd.decompress(frame) == data
    wrong = frame[:-1] + bytes([frame[-1] ^ 1])
    with pytest.raises(ValueError, match="checksum"):
        zstd.decompress(wrong)


def test_xxh64_is_the_frames_checksum():
    for n in (0, 1, 3, 4, 7, 8, 31, 32, 33, 100, 1000):
        data = INPUTS["random"][:n]
        frame = zstandard.ZstdCompressor(write_checksum=True).compress(data)
        assert zstd.xxh64(data) & 0xFFFFFFFF == int.from_bytes(
            frame[-4:], "little")


def test_concatenated_and_skippable_frames():
    c = zstandard.ZstdCompressor(level=3)
    parts = [INPUTS["text"][:5_000], INPUTS["weights"][:40_000], b"",
             INPUTS["runs"][:1_000]]
    skip = (0x184D2A57).to_bytes(4, "little") + (5).to_bytes(4, "little") \
        + b"12345"
    stream = skip + c.compress(parts[0]) + c.compress(parts[1]) + skip \
        + c.compress(parts[2]) + zstd.compress(parts[3]) + skip
    assert zstd.decompress(stream) == b"".join(parts)
    assert zstd.decompress_many([c.compress(p) for p in parts]) == parts


def test_streamed_frames_without_a_content_size():
    """Frames written by the streaming API (no content size, a window
    descriptor instead)."""
    data = INPUTS["weights"] + INPUTS["text"]
    for level in (1, 19):
        frame = zstandard.ZstdCompressor(
            level=level, write_content_size=False).compressobj()
        out = frame.compress(data) + frame.flush()
        assert not out[4] & 0xC0 and not out[4] & 0x20
        assert zstd.decompress(out) == data


def test_tensorstores_own_chunks(tmp_path):
    """zarr chunks tensorstore compressed (zstd level 1, as orbax asks)."""
    import tensorstore as ts
    rng = np.random.default_rng(1)
    arrays = {"w": (rng.standard_normal((300, 257)) * 0.05).astype(
        np.float32), "i": np.arange(40_000, dtype=np.int32) // 7,
        "z": np.zeros((513,), np.float32)}
    for name, arr in arrays.items():
        path = str(tmp_path / name)
        store = ts.open({"driver": "zarr", "kvstore": {
            "driver": "file", "path": path},
            "metadata": {"shape": list(arr.shape),
                         "chunks": list(arr.shape), "dtype": arr.dtype.str,
                         "compressor": {"id": "zstd", "level": 1}}},
            create=True).result()
        store.write(arr).result()
        chunk = "0" if arr.ndim == 1 else "0.0"
        with open(os.path.join(path, chunk), "rb") as f:
            frame = f.read()
        assert frame[:4] == zstd._MAGIC_BYTES
        assert zstd.decompress(frame) == arr.tobytes()


def test_encoder_frames_read_through_zstandard():
    for name, data in INPUTS.items():
        for checksum in (False, True):
            frame = zstd.compress(data, checksum=checksum)
            got = zstandard.ZstdDecompressor().decompress(
                frame, max_output_size=len(data) + 1)
            assert got == data, name
            assert zstd.decompress(frame) == data
    # a block of one repeated byte is an RLE block
    assert len(zstd.compress(bytes(300_000))) < 40


@settings(max_examples=60, deadline=None)
@given(st.binary(max_size=3_000), st.sampled_from(LEVELS),
       st.integers(1, 4))
def test_round_trip(data, level, repeat):
    data = data * repeat
    assert zstd.decompress(zstd.compress(data)) == data
    frame = zstandard.ZstdCompressor(level=level).compress(data)
    assert zstd.decompress(frame) == data


@pytest.mark.parametrize("level", (1, 19))
def test_truncated_frames_raise(level):
    data = INPUTS["text"][:20_000]
    for frame in (zstandard.ZstdCompressor(level=level).compress(data),
                  zstd.compress(data)):
        for cut in (1, 3, 4, 5, 6, 9, 12, 40, len(frame) // 2,
                    len(frame) - 1):
            with pytest.raises(ValueError):
                zstd.decompress(frame[:cut])


@pytest.mark.parametrize("level", (1, 19))
def test_flipped_bits_raise_or_change_nothing(level):
    """Every single-bit flip of a checksummed frame either raises
    ValueError or decodes to the same bytes (a flip in the window
    descriptor, say): never other bytes, never another exception."""
    data = INPUTS["text"][:700] + INPUTS["grid"][:300]
    frame = zstandard.ZstdCompressor(level=level,
                                     write_checksum=True).compress(data)
    lanes = zstd._Lanes()
    (parsed,) = zstd._parse(frame, lanes)
    assert lanes.lanes and any(kind == zstd._COMPRESSED and payload[1]
                               for kind, payload in parsed.blocks)
    raised = 0
    for bit in range(len(frame) * 8):
        flipped = bytearray(frame)
        flipped[bit >> 3] ^= 1 << (bit & 7)
        try:
            got = zstd.decompress(bytes(flipped))
        except ValueError:
            raised += 1
        else:
            assert got == data, bit
    assert raised > 0.9 * len(frame) * 8


def test_a_dictionary_frame_says_so():
    samples = [INPUTS["text"][i:i + 400] for i in range(0, 40_000, 400)]
    dictionary = zstandard.train_dictionary(2_048, samples)
    frame = zstandard.ZstdCompressor(dict_data=dictionary).compress(
        samples[3])
    with pytest.raises(ValueError, match="dictionary"):
        zstd.decompress(frame)


def test_not_a_frame_raises():
    with pytest.raises(ValueError, match="not a zstd frame"):
        zstd.decompress(b"\x00" * 16)
