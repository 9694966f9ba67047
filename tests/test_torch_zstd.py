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


# -- the encoder's compressed blocks --------------------------------------

def _raw_frame_size(n: int) -> int:
    """The size of a frame of raw blocks of 128 KiB (the encoder's output
    before it compressed)."""
    return 14 + 3 * max(1, -(-n // zstd.BLOCK_MAX)) + n


def _geometric_bytes(depth: int, rng) -> bytes:
    """2^depth bytes where byte k < depth occurs 2^(depth-1-k) times and
    byte `depth` once: each count is at least all smaller ones together,
    so Huffman's own code for them is `depth` bits deep."""
    counts = [1 << (depth - 1 - k) for k in range(depth)] + [1]
    return rng.permutation(np.repeat(np.arange(depth + 1, dtype=np.uint8),
                                     counts)).tobytes()


def _detnet_leaves():
    """The float32 leaves of a seeded DetNet-like state: the narrow flagship
    DetNet's weights, statistics and Adam moments
    (`orbax_fixture_state`)."""
    from radargnn_tpu_torch import smoke_variants as sv
    state = sv.orbax_fixture_state(3)
    trees = {k: state[k] for k in ("params", "batch_stats", "opt_state")}
    return [np.asarray(v).tobytes() for _, v in sv._flat_leaves(trees)
            if np.asarray(v).dtype == np.float32]


def _cases():
    rng = np.random.default_rng(5)
    grid = (rng.integers(0, 9, 24_576) / 8).astype(np.float32).tobytes()
    return {
        "one_symbol": bytes([7]) * 70_000,
        "two_symbols": rng.choice(np.array([0x11, 0xEE], np.uint8), 50_000,
                                  p=[0.7, 0.3]).tobytes(),
        "all_256": rng.permutation(np.concatenate([
            np.arange(256), np.minimum(rng.geometric(0.04, 60_000),
                                       255)]).astype(np.uint8)).tobytes(),
        "past_11_bits": _geometric_bytes(15, rng),
        "one_block": grid[:1_000],
        "several_blocks": (rng.standard_normal(60_000) * 0.05).astype(
            np.float32).tobytes(),
        "last_block_of_1_byte": grid + b"\x05",
        "float64_ones": np.ones(30_000).tobytes(),
        "sparse": (rng.standard_normal(40_000)
                   * (rng.random(40_000) < 0.2)).astype(
            np.float32).tobytes(),
        "incompressible": rng.integers(0, 256, 300_000,
                                       dtype=np.uint8).tobytes(),
    }


CASES = _cases()


def _blocks(frame: bytes):
    lanes = zstd._Lanes()
    (parsed,) = zstd._parse(frame, lanes)
    return parsed.blocks, lanes


@pytest.mark.parametrize("checksum", (False, True))
@pytest.mark.parametrize("name", sorted(INPUTS) + sorted(CASES))
def test_encoder_round_trip(name, checksum):
    """Every frame the encoder writes decodes bit for bit through
    zstandard and through the port's decoder."""
    data = {**INPUTS, **CASES}[name]
    frame = zstd.compress(data, checksum=checksum)
    assert zstandard.ZstdDecompressor().decompress(
        frame, max_output_size=len(data) + 1) == data
    assert zstd.decompress(frame) == data
    assert len(frame) <= _raw_frame_size(len(data)) + 4 * checksum


def test_encoder_float32_leaves_round_trip():
    for data in _detnet_leaves():
        frame = zstd.compress(data)
        assert zstandard.ZstdDecompressor().decompress(frame) == data
    leaves = _detnet_leaves()
    assert zstd.decompress_many([zstd.compress(d) for d in leaves]) == leaves


def test_encoder_size_on_float32_leaves():
    """On the DetNet-like state the encoder's frames take at most 1.04
    times zstandard level 1's, and well under the raw frames."""
    leaves = _detnet_leaves()
    ours = sum(len(zstd.compress(d)) for d in leaves)
    level1 = sum(len(zstandard.ZstdCompressor(level=1).compress(d))
                 for d in leaves)
    assert ours <= 1.04 * level1
    assert ours < 0.8 * sum(_raw_frame_size(len(d)) for d in leaves)


def test_incompressible_input_stays_raw():
    data = CASES["incompressible"]
    frame = zstd.compress(data)
    assert len(frame) == _raw_frame_size(len(data))
    blocks, _ = _blocks(frame)
    assert [kind for kind, _ in blocks] == [zstd._RAW] * 3
    assert [len(b) for _, b in blocks] == [zstd.BLOCK_MAX] * 2 + [
        len(data) - 2 * zstd.BLOCK_MAX]


def test_last_block_of_1_byte():
    data = CASES["last_block_of_1_byte"]
    blocks, _ = _blocks(zstd.compress(data))
    assert [kind for kind, _ in blocks] == [zstd._COMPRESSED] * 3 \
        + [zstd._RAW]
    assert blocks[-1][1] == b"\x05"


def test_one_byte_repeated_is_rle():
    blocks, lanes = _blocks(zstd.compress(CASES["one_symbol"]))
    assert blocks == [(zstd._RLE, (7, 70_000))] and not lanes.lanes


@pytest.mark.parametrize("name,reused", [
    ("weights", True), ("grid", True), ("several_blocks", True),
    ("text", False), ("all_256", False), ("past_11_bits", False),
    ("two_symbols", False)])
def test_frames_hold_huffman_literals(name, reused):
    """Parsed as `test_fixture_holds_compressed_zstd_blocks` parses the
    JAX package's chunks: compressed blocks with Huffman-coded literals;
    the blocks of one distribution share a table (treeless literals)."""
    data = {**INPUTS, **CASES}[name]
    blocks, lanes = _blocks(zstd.compress(data))
    compressed = [p for kind, p in blocks if kind == zstd._COMPRESSED]
    assert compressed and lanes.lanes
    assert all(isinstance(lits, tuple) for lits, _ in compressed)
    if reused:
        assert len(compressed) > 1 and len(lanes.tables_sym) == 1


@pytest.mark.parametrize("name", ["runs", "float64_ones", "sparse"])
def test_long_runs_are_few_sequences(name):
    """Runs of a repeated 4 or 8 bytes become sequences, at most a few a
    block, each at least 32 bytes long."""
    data = {**INPUTS, **CASES}[name]
    blocks, _ = _blocks(zstd.compress(data))
    seqs = [s for kind, (_, block_seqs) in
            ((k, p) for k, p in blocks if k == zstd._COMPRESSED)
            for s in block_seqs]
    assert seqs
    assert all(ml >= zstd._MIN_RUN and value - 3 in (4, 8)
               for _, ml, value in seqs)
    assert len(seqs) <= 64 * len(blocks)


@pytest.mark.parametrize("case", ["past_11_bits", "two", "uniform",
                                  "skewed", "zero_heavy"])
def test_huffman_lengths_are_limited_and_complete(case):
    rng = np.random.default_rng(2)
    data = {
        "past_11_bits": np.frombuffer(CASES["past_11_bits"], np.uint8),
        "two": np.array([3, 200] * 50, np.uint8),
        "uniform": np.arange(256, dtype=np.uint8).repeat(64),
        "skewed": np.minimum(rng.geometric(0.1, 30_000), 255).astype(
            np.uint8),
        "zero_heavy": np.where(rng.random(30_000) < 0.999, 0, rng.integers(
            1, 256, 30_000)).astype(np.uint8),
    }[case]
    counts = np.bincount(data, minlength=256)
    lengths = zstd._huffman_lengths(counts)
    assert ((lengths > 0) == (counts > 0)).all()
    assert lengths.max() <= zstd._HUF_BITS
    assert sum(2.0 ** -int(x) for x in lengths if x) == 1.0
    # 256 bytes of one length have equal weights, which neither form of
    # the description holds (nor would the code save a bit)
    assert (zstd._Huffman.build(counts) is None) == (case == "uniform")
    frame = zstd.compress(data.tobytes())
    assert zstandard.ZstdDecompressor().decompress(frame) == data.tobytes()
    assert zstd.decompress(frame) == data.tobytes()


def test_past_11_bits_needs_the_limit():
    """Without the limit Huffman's code for these bytes would be 15 bits
    deep (each count at least all smaller ones together)."""
    counts = np.bincount(np.frombuffer(CASES["past_11_bits"], np.uint8),
                         minlength=256)
    present = np.sort(counts[counts > 0])
    assert len(present) == 16
    assert all(present[i] >= present[:i].sum() for i in range(1, 16))
    assert zstd._huffman_lengths(counts).max() == zstd._HUF_BITS


@pytest.mark.parametrize("kind", ["ll", "ml", "of", "weights", "random"])
def test_fse_description_round_trip(kind):
    """`_write_ncount` is `_read_ncount`'s inverse, "less than one"
    probabilities and runs of zeros included."""
    if kind in zstd._PREDEFINED:
        log, counts = zstd._PREDEFINED[kind]
    elif kind == "weights":
        log, counts = 6, [0, 20, 0, 0, 0, 0, 10, 30, 0, 0, 0, 0, 4]
    else:
        rng = np.random.default_rng(4)
        log = 9
        counts = [0] * 53
        for s in rng.integers(0, 53, 1 << log):
            counts[s] += 1
        counts[5], counts[6] = -1, counts[6] + counts[5] - 1
    description = zstd._write_ncount(log, counts)
    got_log, got, end = zstd._read_ncount(description + b"\0" * 8, 0,
                                          len(description), 60, 9)
    assert (got_log, end) == (log, len(description))
    assert got == list(counts[:len(got)]) and not any(counts[len(got):])


@settings(max_examples=80, deadline=None)
@given(st.lists(st.integers(0, 11), min_size=2, max_size=255),
       st.integers(0, 11), st.floats(0, 0.98))
def test_fse_weights_round_trip(weights, common, share):
    """Huffman weights FSE-compressed read back through the decoder's
    `_huffman_weights`, a dominant weight (states that read no bits)
    included."""
    rng = np.random.default_rng(len(weights))
    weights = [common if rng.random() < share else w for w in weights]
    fse = zstd._fse_weights(weights)
    if fse is None:
        assert len(set(weights)) == 1
        return
    data = bytes([len(fse)]) + fse
    got, end = zstd._huffman_weights(data, 0, len(data))
    assert got == weights and end == len(data)


@settings(max_examples=60, deadline=None)
@given(st.lists(st.tuples(st.integers(0, 131_071), st.integers(3, 131_074),
                          st.integers(1, 131_072)), min_size=1,
                max_size=40))
def test_sequences_round_trip(seqs):
    """The sequences section under the predefined tables reads back as its
    (literal length, match length, offset + 3) triples."""
    section = zstd._sequences(seqs)
    frame = zstd._Frame(zstd.BLOCK_MAX, None, False)
    got = zstd._parse_sequences(section, 0, len(section), frame)
    assert got == [(ll, ml, off + 3) for ll, ml, off in seqs]


@settings(max_examples=50, deadline=None)
@given(st.lists(st.tuples(st.sampled_from([b"\0", b"\x01", b"ab",
                                           b"\0\0\x80?", b"\xcd\xcc\x8c?",
                                           b"xyz12345"]),
                          st.integers(1, 3_000)), min_size=1, max_size=30),
       st.integers(0, 2 ** 32 - 1))
def test_compressible_round_trip(parts, seed):
    """Runs and low-entropy bytes (repeated patterns, float32 constants,
    bytes drawn from a few values) decode bit for bit through both
    decoders."""
    rng = np.random.default_rng(seed)
    few = rng.choice(np.frombuffer(b"\0\x10\x20\xff", np.uint8),
                     int(rng.integers(0, 20_000))).tobytes()
    data = b"".join(p * n for p, n in parts) + few
    frame = zstd.compress(data)
    assert zstd.decompress(frame) == data
    assert zstandard.ZstdDecompressor().decompress(
        frame, max_output_size=len(data) + 1) == data
