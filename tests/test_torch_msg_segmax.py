"""The port's fused linear and fused message segment-max
(radargnn_tpu_torch.ops.fused_linear, ops.message_segment_max) against the
JAX package.

The same seeded numpy inputs go through the JAX functions in interpret
mode (as tests/test_pallas.py runs them) and through the port, where on the
CPU the wrappers take their plain versions. Both compute in float32, so
they agree to summation order (rtol/atol 1e-4, the tolerance of the JAX
package's own segment-max tests). The CUDA kernels run on the card only
(tests/test_torch_gpu.py)."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radargnn_tpu.ops import pallas_kernels as jpk
from radargnn_tpu_torch import smoke
from radargnn_tpu_torch.benchmarks import kernel_bench
from radargnn_tpu_torch.ops import fused_linear as fl
from radargnn_tpu_torch.ops import message_segment_max as msm
from radargnn_tpu_torch.ops import windowed_tiles as wt

RTOL = ATOL = 1e-4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("relu", [False, True])
def test_fused_linear_matches_jax(relu):
    """tests/test_pallas.py's linear case, with and without ReLU."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1000, 48)).astype(np.float32)
    w = rng.normal(size=(48, 64)).astype(np.float32)
    b = rng.normal(size=(64,)).astype(np.float32)
    want = np.asarray(jpk.fused_linear(jnp.asarray(x), jnp.asarray(w),
                                       jnp.asarray(b), relu=relu, tile=256))
    got = fl.fused_linear(_t(x), _t(w), _t(b), relu=relu, tile=256)
    assert got.dtype == torch.float32 and got.shape == (1000, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    ref = fl.fused_linear_reference(_t(x), _t(w), _t(b), relu=relu)
    np.testing.assert_allclose(ref.numpy(), want, rtol=RTOL, atol=ATOL)
    if relu:
        assert (got >= 0).all()


def _segmax_case(rng, e, n, din, h, mask_frac=0.85, node_block=32,
                 edge_tile=32, total_tiles=None):
    m_in = rng.normal(size=(e, din)).astype(np.float32)
    receivers = rng.integers(0, n, e).astype(np.int32)
    mask = rng.random(e) < mask_frac
    w = rng.normal(size=(din, h)).astype(np.float32) * 0.1
    b = rng.normal(size=(h,)).astype(np.float32)
    return m_in, receivers, mask, w, b


def _both(m_in, receivers, mask, w, b, n, node_block, edge_tile,
          total_tiles=None, variant="scan"):
    """The JAX kernel in interpret mode and the port on the same tiling
    (the port's tiler, asserted identical to the JAX package's)."""
    tiles = wt.prepare_csr_tiles(receivers, mask, n, node_block, edge_tile,
                                 total_tiles)
    for a, j in zip(tiles, jpk.prepare_csr_tiles(
            receivers, mask, n, node_block, edge_tile, total_tiles)):
        np.testing.assert_array_equal(a, j)
    perm, tile_blocks, padded_recv = tiles
    want = np.asarray(jpk.fused_message_segment_max(
        jnp.asarray(m_in[perm]), jnp.asarray(w), jnp.asarray(b),
        jnp.asarray(padded_recv), jnp.asarray(tile_blocks), num_nodes=n,
        node_block=node_block, edge_tile=edge_tile, variant=variant))
    got = msm.fused_message_segment_max(
        _t(m_in[perm]), _t(w), _t(b), _t(padded_recv), _t(tile_blocks),
        num_nodes=n, node_block=node_block, edge_tile=edge_tile,
        variant=variant)
    ref = msm.fused_message_segment_max_reference(
        _t(m_in), _t(w), _t(b), _t(receivers), _t(mask), n)
    return got.numpy(), want, ref.numpy()


@pytest.mark.parametrize("variant", ["scan", "onehot"])
def test_segmax_random_matches_jax(variant):
    """Random receivers under both of the JAX kernel's variants."""
    rng = np.random.default_rng(1)
    case = _segmax_case(rng, e=600, n=100, din=24, h=40)
    got, want, ref = _both(*case, n=100, node_block=32, edge_tile=32,
                           variant=variant)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ref, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("variant", ["scan", "onehot"])
def test_segmax_wide_range_matches_jax(variant):
    """Messages over a wide range of magnitudes with cancelling terms
    (smoke.segmax_wide_range: |m_in| from 1e-3 to 1e3, pairs of terms that
    cancel to at most half of one) under both variants."""
    rng = np.random.default_rng(6)
    m_in, w, b = smoke.segmax_wide_range(rng, 600, 24, 40)
    receivers = rng.integers(0, 100, 600).astype(np.int32)
    mask = rng.random(600) < 0.85
    got, want, ref = _both(m_in, receivers, mask, w, b, 100, 32, 32,
                           variant=variant)
    assert np.abs(want).max() > 100
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ref, want, rtol=RTOL, atol=ATOL)


def test_segmax_empty_blocks_give_zero():
    """Receivers in the first node block only: the three empty blocks get
    a dummy tile each and their nodes 0."""
    rng = np.random.default_rng(2)
    e, n = 120, 128
    m_in = rng.normal(size=(e, 8)).astype(np.float32)
    receivers = rng.integers(0, 30, e).astype(np.int32)
    mask = np.ones(e, bool)
    w = rng.normal(size=(8, 16)).astype(np.float32)
    b = np.zeros(16, np.float32)
    got, want, ref = _both(m_in, receivers, mask, w, b, n, 32, 32)
    assert np.all(got[32:] == 0.0)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ref, want, rtol=RTOL, atol=ATOL)


def test_segmax_static_tile_budget():
    """A static tile budget pads with empty tiles of the last block."""
    rng = np.random.default_rng(3)
    case = _segmax_case(rng, e=300, n=64, din=16, h=24)
    got, want, _ = _both(*case, n=64, node_block=32, edge_tile=32,
                         total_tiles=40)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_segmax_keeps_negative_maxima():
    """All messages -1: receivers 0-3 keep -1, the others (no edge) 0."""
    n, e = 8, 16
    m_in = -np.ones((e, 4), np.float32)
    receivers = np.repeat(np.arange(4), 4).astype(np.int32)
    got, want, _ = _both(m_in, receivers, np.ones(e, bool),
                         np.eye(4, dtype=np.float32),
                         np.zeros(4, np.float32), n, 8, 8)
    np.testing.assert_array_equal(got[:4], -1.0)
    np.testing.assert_array_equal(got[4:], 0.0)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_segmax_rejects_an_unknown_variant():
    with pytest.raises(ValueError, match="variant"):
        msm.fused_message_segment_max(
            torch.zeros(8, 4), torch.zeros(4, 4), torch.zeros(4),
            torch.full((8,), -1, dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32), num_nodes=8, node_block=8,
            edge_tile=8, variant="roll")


def test_prepare_csr_tiles_budget_exceeded():
    """The port's tiler refuses a tile budget that is too small, as the JAX
    package's does."""
    args = (np.zeros(100, np.int32), np.ones(100, bool))
    kw = dict(num_nodes=16, node_block=8, edge_tile=8, total_tiles=2)
    with pytest.raises(ValueError):
        jpk.prepare_csr_tiles(*args, **kw)
    with pytest.raises(ValueError, match="budget"):
        wt.prepare_csr_tiles(*args, **kw)


def test_kernel_bench_rehearses_on_cpu():
    """kernel_bench at a tiny size on the CPU: both JSON lines, the library
    path and the kernel's path agree, and nothing is timed (no card)."""
    lines = []
    res = kernel_bench.run("cpu", edges=2000, nodes=96, din=24, h=40,
                           reps=1, out=lines.append)
    rows = [json.loads(s) for s in lines if s.startswith("{")]
    assert [r["metric"] for r in rows] == ["segmax_library_ms",
                                           "segmax_kernel_ms"]
    assert all(r["value"] is None and r["device"] == "cpu" for r in rows)
    assert res["max_abs_err"] <= 1e-4
    assert res["tiles"] > 0 and res["flops"] == 2.0 * 2000 * 24 * 40
