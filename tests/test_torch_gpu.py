"""The port's CUDA kernels on the card (marker `gpu`). Each test decides
inside itself whether a card is present and skips without one; the kernels
have no CPU mode. This file imports nothing of JAX, so on a machine with a
card and without JAX it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

A kernel and its plain version take the same bf16 inputs and both sum
exact bf16 products in float32; they differ only in summation order, so a
float32 output agrees to 1e-3 relative to its scale. Where an output is
rounded to bf16 (the backward's d_xg and d_e, and d_x, which sums d_xg
rows), a summation-order difference can move it by one bf16 step (2^-8
relative), so those agree to 1e-2. The CSR kernels (B5) keep the edge
features, W_e, d_e and dW_e in float32, as v2's contract on the TPU has
it: their forward, and their d_e and dW_e with a real-valued g, are held
to the smoke's float32 limits."""

import contextlib
import json
from unittest import mock

import numpy as np
import pytest
import torch

from radargnn_tpu_torch import smoke
from radargnn_tpu_torch.benchmarks import kernel_bench, kernel_check
from radargnn_tpu_torch.ops import csr_aggregate as ca
from radargnn_tpu_torch.ops import dense_aggregate as da
from radargnn_tpu_torch.ops import dense_tiles as tdt
from radargnn_tpu_torch.ops import fused_linear as fl
from radargnn_tpu_torch.ops import hoisted_aggregate as ha
from radargnn_tpu_torch.ops import message_segment_max as msm
from radargnn_tpu_torch.ops import segment_sum as ss
from radargnn_tpu_torch.ops import windowed_aggregate as wa
from radargnn_tpu_torch.ops import windowed_tiles as wt

RTOL = 1e-3
RTOL_BF16_OUT = 1e-2


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")


def _case(seed, n, K, r_tile, nb, d, de, h, dtype=torch.bfloat16):
    """A random variable-in-degree graph (spill and window overflow), its
    dense tiling from the port's host tiler, and the aggregation's inputs on
    the card in `dtype`."""
    rng = np.random.default_rng(seed)
    e = n * (K - 2)
    send = rng.integers(0, n, e).astype(np.int32)
    recv = rng.integers(0, n, e).astype(np.int32)
    perm, sloc, t_win, ovf_idx = tdt.prepare_dense_knn_tiles(
        send, recv, np.ones(e, bool), n, K, r_tile, nb, 3, ovf_budget=e)
    ovf = ovf_idx >= 0
    o = np.maximum(ovf_idx, 0)
    e_feat = rng.normal(size=(e, de))

    def t(arr, cast=None):
        out = torch.from_numpy(np.ascontiguousarray(arr)).cuda()
        return out if cast is None else out.to(cast)

    land = ss.sender_landing(sloc, t_win, np.where(ovf, send[o], 0), ovf,
                             slots_per_tile=r_tile * K, node_block=nb,
                             num_nodes=n)
    return dict(
        landing=ss.SenderLanding(t(land[0]), t(land[1])),
        x=t(rng.normal(size=(n, d)), dtype),
        w_s=t(rng.normal(size=(d, h)) * d ** -0.5, dtype),
        e_t=t(e_feat[perm], dtype),
        w_e=t(rng.normal(size=(de, h)) * de ** -0.5, dtype),
        offset=t(rng.normal(size=(n, h)), torch.float32),
        e_ovf=t(np.where(ovf[:, None], e_feat[o], 0.0), dtype),
        tile_win=t(t_win), sloc=t(sloc),
        ovf_s=t(np.where(ovf, send[o], 0).astype(np.int32)),
        ovf_r=t(np.where(ovf, recv[o], -1).astype(np.int32)),
        kw=dict(r_tile=r_tile, k=K, node_block=nb))


def _rel_err(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1.0)


def _fwd_args(c):
    """The gather-max's inputs for case `c` on the kernel path: the
    projection, the overflow maxima from it, the layout, the offset."""
    y_s = da.dense_proj(c["x"], c["w_s"])
    inner_o = da.overflow_maxima(
        da.dense_overflow_operand(y_s, c["e_ovf"], c["w_e"], c["ovf_s"]),
        c["ovf_r"], c["offset"].shape[0])
    return (y_s, c["e_t"], c["w_e"], c["sloc"], c["tile_win"], inner_o,
            c["offset"])


# (n, K, R, node_block, d_in, d_e, H): a small tile with H not a multiple
# of 64, the five layer shapes of the flagship (three alike); random
# senders give a tile more distinct senders than the gather stages at once
_DSHAPES = [
    (128, 7, 16, 32, 24, 8, 40),
    (1024, 24, 64, 256, 224, 16, 464),
    (1024, 24, 64, 256, 128, 16, 272),
    (1024, 24, 64, 256, 64, 16, 144),
    # a 3 x 4096-node window: the gather ranks senders in ranges of 8192
    # window positions
    (12288, 6, 16, 4096, 24, 8, 40),
]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", _DSHAPES)
def test_dense_fwd_kernel_matches_plain(shape):
    """The projection and the gather-max against their plain versions,
    serving and VJP mode; the empty receivers agree exactly and the
    routing bits all but exactly (real-valued inputs)."""
    _need_card()
    c = _case(0, *shape)
    before = (da.dense_proj_cuda.launches, da.dense_fwd_cuda.launches)
    args = _fwd_args(c)
    got = da.dense_fwd(*args, **c["kw"])
    got_vjp, inner, bits = da.dense_fwd(*args, emit_inner=True, **c["kw"])
    torch.cuda.synchronize()
    assert (da.dense_proj_cuda.launches, da.dense_fwd_cuda.launches) == (
        before[0] + 1, before[1] + 2)
    assert _rel_err(args[0], da.dense_proj_plain(c["x"], c["w_s"])) <= RTOL
    want, want_inner, want_bits = da.dense_fwd_plain(*args, emit_inner=True,
                                                     **c["kw"])
    assert torch.isfinite(got).all() and torch.equal(got, got_vjp)
    assert _rel_err(got, want) <= RTOL
    assert torch.equal(got == 0, want == 0)       # the same empty receivers
    has = want_inner > da._NEG / 2
    assert torch.equal(inner > da._NEG / 2, has)
    flips = smoke._popcount(bits ^ want_bits)
    assert flips <= smoke.BITS_FLIP_FRAC * bits.numel() * 32
    assert smoke._popcount(bits) > 0


@pytest.mark.gpu
def test_dense_aggregate_pads_odd_widths():
    """Widths that are not multiples of 8 (d_in 21, d_e 2: raw edge features
    without an embedding) reach the kernels zero-padded, from float32
    inputs, and give the plain path's result."""
    _need_card()
    c = _case(1, 128, 7, 16, 32, 21, 2, 40, dtype=torch.float32)
    args = (c["x"], c["w_s"], c["e_t"], c["w_e"], c["offset"], c["e_ovf"],
            c["tile_win"], c["sloc"], c["ovf_s"], c["ovf_r"])
    got = da.dense_aggregate(*args, **c["kw"])
    with smoke._plain_kernels():
        want = da.dense_aggregate(*args, **c["kw"])
    torch.cuda.synchronize()
    assert _rel_err(got, want) <= RTOL


@pytest.mark.gpu
def test_kernel_refuses_what_it_does_not_take():
    _need_card()
    c = _case(2, 128, 7, 16, 32, 24, 8, 40)
    args = list(_fwd_args(c))
    with pytest.raises(ValueError, match="bf16"):
        da.dense_proj(c["x"].float(), c["w_s"])
    with pytest.raises(ValueError, match="contiguous"):
        da.dense_proj(c["x"].t().contiguous().t(), c["w_s"])
    with pytest.raises(ValueError, match="float32"):
        da.dense_fwd(args[0].bfloat16(), *args[1:], **c["kw"])
    with pytest.raises(ValueError, match="bf16"):
        da.dense_fwd(args[0], args[1].float(), *args[2:], **c["kw"])
    c = _case(3, 128, 7, 8, 32, 24, 8, 40)          # 8 receivers per tile
    with pytest.raises(ValueError, match="r_tile"):
        da.dense_fwd(*_fwd_args(c), **c["kw"])


def _bwd_inputs(c, seed, dyadic=False):
    """The backward kernels' inputs for case `c`: the kernel forward's bits
    (VJP mode), a seeded g zeroed at empty receivers, the overflow rows
    routed on the forward's overflow operands, the landing."""
    if dyadic:
        gen = torch.Generator().manual_seed(seed + 1000)
        for name, scale in (("x", 1.0), ("w_s", 0.25), ("e_t", 1.0),
                            ("w_e", 0.25), ("e_ovf", 1.0)):
            c[name] = (torch.randint(-4, 5, c[name].shape, generator=gen)
                       * scale / 2).to(c[name])
    args = _fwd_args(c)
    _, inner, bits = da.dense_fwd(*args, emit_inner=True, **c["kw"])
    gen = torch.Generator().manual_seed(seed)
    g = torch.randn(inner.shape, generator=gen).cuda()
    if dyadic:
        g = torch.randint(-8, 9, inner.shape, generator=gen).cuda() / 8.0
    has = inner > da._NEG / 2
    g_pass = torch.where(has, g, 0.0)
    inner_z = torch.where(has, inner, 0.0)
    op_o = da.dense_overflow_operand(args[0], c["e_ovf"], c["w_e"],
                                     c["ovf_s"])
    mask = c["ovf_r"] >= 0
    recv = torch.where(mask, c["ovf_r"], 0).long()
    d_op_o = torch.where(mask[:, None] & da._routes(op_o, inner_z[recv]),
                         g_pass[recv], 0.0)
    order, row_ptr = c["landing"]
    return (bits, g_pass, c["e_t"], c["w_e"], d_op_o, order, row_ptr)


def _bkw(c):
    return dict(r_tile=c["kw"]["r_tile"], k=c["kw"]["k"])


@pytest.mark.gpu
@pytest.mark.parametrize("shape", _DSHAPES)
@pytest.mark.parametrize("dyadic", [False, True])
def test_dense_bwd_kernel_matches_plain(shape, dyadic):
    """d_e, dW_e and the sender sums d_ys (slots) and d_yo (overflow rows)
    against the plain version from the same bits; on dyadic inputs, where
    every sum is exact, bitwise."""
    _need_card()
    c = _case(4, *shape)
    args = _bwd_inputs(c, 5, dyadic)
    before = da.dense_bwd_cuda.launches
    got = da.dense_bwd(*args, **_bkw(c))
    torch.cuda.synchronize()
    assert da.dense_bwd_cuda.launches == before + 1
    want = da.dense_bwd_plain(*args, **_bkw(c))
    for name, u, v, tol in zip(("d_e", "dW_e", "d_ys", "d_yo"), got, want,
                               (RTOL_BF16_OUT, RTOL, RTOL, RTOL)):
        assert u.dtype == v.dtype and u.shape == v.shape, name
        assert torch.isfinite(u).all(), name
        assert _rel_err(u.float(), v.float()) <= tol, name
        if dyadic and name != "dW_e":
            assert torch.equal(u, v), name
    assert float(got[2].abs().max()) > 0 and float(got[3].abs().max()) > 0


@pytest.mark.gpu
def test_segment_sum_kernel_matches_plain():
    """Both sources (bf16 rows, then f32 rows), skipped rows and empty
    segments, at the flagship's widest landing."""
    _need_card()
    rng = np.random.default_rng(6)
    n_a, n_b, n_seg, d = 60000, 5000, 4000, 224
    seg = np.where(rng.random(n_a + n_b) < 0.9,
                   rng.integers(0, n_seg - 500, n_a + n_b), -1)
    rows = np.flatnonzero(seg >= 0)
    order = rows[np.argsort(seg[rows], kind="stable")].astype(np.int32)
    row_ptr = np.concatenate(
        [[0], np.cumsum(np.bincount(seg[rows], minlength=n_seg))])
    order = torch.from_numpy(order).cuda()
    row_ptr = torch.from_numpy(row_ptr.astype(np.int32)).cuda()
    a = torch.from_numpy(rng.normal(size=(n_a, d))).float().cuda().bfloat16()
    b = torch.from_numpy(rng.normal(size=(n_b, d))).float().cuda()
    before = ss.segment_sum_csr_cuda.launches
    got = ss.segment_sum_csr(a, order, row_ptr, b)
    torch.cuda.synchronize()
    assert ss.segment_sum_csr_cuda.launches == before + 1
    want = ss.segment_sum_csr_plain(a, order, row_ptr, b)
    assert _rel_err(got, want) <= 1e-5
    assert torch.equal(got[-500:], torch.zeros_like(got[-500:]))


@pytest.mark.gpu
def test_dense_backward_is_bitwise_deterministic():
    """Two runs of the forward (bits) and of the backward kernels on the
    same real-valued inputs give the same bits."""
    _need_card()
    c = _case(8, 1024, 24, 64, 256, 224, 16, 464)
    args = _bwd_inputs(c, 9)
    again = _bwd_inputs(c, 9)
    assert torch.equal(args[0], again[0])
    runs = [da.dense_bwd(*args, **_bkw(c)) for _ in range(2)]
    torch.cuda.synchronize()
    for u, v in zip(*runs):
        assert torch.equal(u, v)


def _grads_kernel_and_plain(aggregate, c, names, *consts):
    """The gradients of (out**2).sum() through `aggregate` on the kernels
    and with every kernel patched to its plain version."""
    grads = []
    for plain in (False, True):
        leaves = [c[nm].clone().requires_grad_(True) for nm in names]
        with smoke._plain_kernels() if plain else contextlib.nullcontext():
            out = aggregate(leaves, *consts)
            grads.append(torch.autograd.grad((out ** 2).sum(), leaves))
    torch.cuda.synchronize()
    return grads


def _dense_agg(c):
    def call(leaves):
        return da.dense_aggregate(*leaves, c["tile_win"], c["sloc"],
                                  c["ovf_s"], c["ovf_r"],
                                  landing=c["landing"], **c["kw"])
    return call


@pytest.mark.gpu
def test_dense_aggregate_gradients_match_plain_path():
    """The autograd Function on the kernels against the same Function with
    the kernels patched to their plain versions, float32 inputs of odd
    widths (zero-padded for the kernels)."""
    _need_card()
    c = _case(10, 128, 7, 16, 32, 21, 2, 40, dtype=torch.float32)
    names = ("x", "w_s", "e_t", "w_e", "offset", "e_ovf")
    for name, u, v in zip(names, *_grads_kernel_and_plain(_dense_agg(c), c,
                                                          names)):
        assert _rel_err(u, v) <= RTOL_BF16_OUT, name


@pytest.mark.gpu
def test_backward_kernels_refuse_what_they_do_not_take():
    _need_card()
    c = _case(11, 128, 7, 16, 32, 24, 8, 40)
    args = list(_bwd_inputs(c, 12))
    with pytest.raises(ValueError, match="int32"):
        da.dense_bwd(args[0].long(), *args[1:], **_bkw(c))
    with pytest.raises(ValueError, match="float32"):
        da.dense_bwd(args[0], args[1].bfloat16(), *args[2:], **_bkw(c))
    with pytest.raises(ValueError, match="bf16"):
        da.dense_bwd(*args[:2], args[2].float(), *args[3:], **_bkw(c))
    with pytest.raises(ValueError, match="do not match"):
        da.dense_bwd(args[0][:, :1].contiguous(), *args[1:], **_bkw(c))
    order, row_ptr = c["landing"]
    rows = torch.zeros((c["e_t"].shape[0], 24), device="cuda")
    with pytest.raises(ValueError, match="int32"):
        ss.segment_sum_csr(rows, order.long(), row_ptr)
    with pytest.raises(ValueError, match="bf16 or float32"):
        ss.segment_sum_csr(rows.half(), order, row_ptr)


def _wcase(seed, n, e, nb, et, d, de, h, run_cap=None,
           dtype=torch.bfloat16):
    """A random graph with hub receivers (a tenth of the edges go to five
    nodes, so their runs span tiles), its windowed tiling from the port's
    host tiler, and the aggregation's inputs on the card in `dtype`."""
    rng = np.random.default_rng(seed)
    send = rng.integers(0, n, e).astype(np.int32)
    recv = np.where(rng.random(e) < 0.1, rng.integers(0, 5, e),
                    rng.integers(0, n, e)).astype(np.int32)
    perm, blocks, precv, sloc, t_win, ovf_idx = \
        wt.prepare_windowed_csr_tiles(send, recv, np.ones(e, bool), n, nb,
                                      et, 3, ovf_budget=e, run_cap=run_cap)
    ovf = ovf_idx >= 0
    o = np.maximum(ovf_idx, 0)
    e_feat = rng.normal(size=(e, de))

    def t(arr, cast=None):
        out = torch.from_numpy(np.ascontiguousarray(arr)).cuda()
        return out if cast is None else out.to(cast)

    ovf_s = np.where(ovf, send[o], 0).astype(np.int32)
    land = ss.sender_landing(sloc, t_win, ovf_s, ovf, slots_per_tile=et,
                             node_block=nb, num_nodes=n)
    return dict(
        landing=ss.SenderLanding(t(land[0]), t(land[1])),
        x=t(rng.normal(size=(n, d)), dtype),
        w_s=t(rng.normal(size=(d, h)) * d ** -0.5, dtype),
        e_t=t(e_feat[perm], dtype),
        w_e=t(rng.normal(size=(de, h)) * de ** -0.5, dtype),
        offset=t(rng.normal(size=(n, h)), torch.float32),
        e_ovf=t(np.where(ovf[:, None], e_feat[o], 0.0), dtype),
        layout=(t(precv), t(sloc), t(t_win), t(blocks)),
        ovf_s=t(ovf_s), ovf_r=t(np.where(ovf, recv[o], -1).astype(np.int32)),
        kw=dict(node_block=nb, edge_tile=et))


_WSHAPES = [
    (200, 3000, 32, 32, 24, 8, 40),       # small tiles (R 32), odd H
    (2048, 40000, 256, 512, 224, 16, 464),    # the flagship layers' widths
    (2048, 40000, 256, 512, 128, 16, 272),
    (2048, 40000, 256, 512, 64, 16, 144),
]


def _w_inner_o(c):
    return da.dense_overflow_inner(c["x"], c["w_s"], c["e_ovf"], c["w_e"],
                                   c["ovf_s"], c["ovf_r"],
                                   c["offset"].shape[0])


@pytest.mark.gpu
@pytest.mark.parametrize("run_cap", [None, 4])
@pytest.mark.parametrize("shape", _WSHAPES)
def test_windowed_fwd_kernel_matches_plain(shape, run_cap):
    """Contiguous and spread runs, hubs spanning tiles, serving and VJP
    mode; the empty receivers agree exactly."""
    _need_card()
    c = _wcase(20, *shape, run_cap=run_cap)
    args = (c["x"], c["w_s"], c["e_t"], c["w_e"], *c["layout"],
            _w_inner_o(c), c["offset"])
    before = wa.windowed_fwd_cuda.launches
    got = wa.windowed_fwd(*args, **c["kw"])
    got_vjp, inner = wa.windowed_fwd(*args, emit_inner=True, **c["kw"])
    torch.cuda.synchronize()
    assert wa.windowed_fwd_cuda.launches == before + 2
    want, want_inner = wa.windowed_fwd_plain(*args, emit_inner=True,
                                             **c["kw"])
    assert torch.isfinite(got).all() and torch.equal(got, got_vjp)
    assert _rel_err(got, want) <= RTOL
    assert torch.equal(got == 0, want == 0)
    has = want_inner > da._NEG / 2
    assert torch.equal(inner > da._NEG / 2, has)
    assert _rel_err(inner[has], want_inner[has]) <= RTOL


def _w_bwd_inputs(c, seed, dyadic=False):
    """The windowed backward's inputs: the kernel forward's maxima and a
    seeded g, zeroed at empty receivers. With `dyadic` every operand is a
    multiple of 1/8 (exact sums in any order)."""
    gen = torch.Generator().manual_seed(seed)
    if dyadic:
        for k in ("x", "w_s", "e_t", "w_e"):
            c[k] = (torch.randint(-4, 5, c[k].shape, generator=gen)
                    * 0.125).to(c[k])
    _, inner = wa.windowed_fwd(c["x"], c["w_s"], c["e_t"], c["w_e"],
                               *c["layout"], _w_inner_o(c), c["offset"],
                               emit_inner=True, **c["kw"])
    g = torch.randn(inner.shape, generator=gen)
    if dyadic:
        g = (g * 8).round() / 8
    has = inner > da._NEG / 2
    return (c["x"], c["w_s"], c["e_t"], c["w_e"], *c["layout"],
            torch.where(has, inner, 0.0), torch.where(has, g.cuda(), 0.0))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", _WSHAPES[:2] + _WSHAPES[3:])
def test_windowed_bwd_kernel_matches_plain(shape):
    """On dyadic inputs the kernels and the plain version form the same
    exact sums: all four outputs agree bitwise."""
    _need_card()
    c = _wcase(21, *shape)
    args = _w_bwd_inputs(c, 22, dyadic=True)
    before = wa.windowed_bwd_cuda.launches
    got = wa.windowed_bwd(*args, **c["kw"])
    torch.cuda.synchronize()
    assert wa.windowed_bwd_cuda.launches == before + 1
    want = wa.windowed_bwd_plain(*args, **c["kw"])
    for name, u, v in zip(("d_xg", "d_e", "dW_s", "dW_e"), got, want):
        assert u.dtype == v.dtype and u.shape == v.shape, name
        assert torch.equal(u, v), name
    assert got[1].abs().max() > 0


@pytest.mark.gpu
def test_windowed_backward_is_bitwise_deterministic():
    """Two runs of the windowed backward kernels and the landing on the
    same real-valued inputs give the same bits."""
    _need_card()
    c = _wcase(23, 2048, 40000, 256, 512, 224, 16, 464, run_cap=4)
    args = _w_bwd_inputs(c, 24)
    order, row_ptr = c["landing"]
    ovf_rows = torch.ones((c["ovf_s"].shape[0], 224), device="cuda")
    runs = []
    for _ in range(2):
        d_xg, d_e, dw_s, dw_e = wa.windowed_bwd(*args, **c["kw"])
        d_x = ss.segment_sum_csr(d_xg, order, row_ptr, ovf_rows)
        runs.append((d_x, d_e, dw_s, dw_e))
    torch.cuda.synchronize()
    for u, v in zip(*runs):
        assert torch.equal(u, v)


@pytest.mark.gpu
def test_windowed_aggregate_gradients_match_plain_path():
    """The autograd Function on the kernels against the same Function with
    the kernels patched to their plain versions, float32 inputs of odd
    widths (zero-padded for the kernels)."""
    _need_card()
    c = _wcase(25, 200, 3000, 32, 32, 21, 2, 40, dtype=torch.float32)
    recv, sloc, t_win, blocks = c["layout"]
    names = ("x", "w_s", "e_t", "w_e", "offset", "e_ovf")
    grads = []
    for plain in (False, True):
        leaves = [c[nm].clone().requires_grad_(True) for nm in names]
        with smoke._plain_kernels() if plain else contextlib.nullcontext():
            # the JAX package's argument order
            out = wa.windowed_aggregate(*leaves, recv, blocks, t_win, sloc,
                                        c["ovf_s"], c["ovf_r"],
                                        landing=c["landing"], **c["kw"])
            grads.append(torch.autograd.grad((out ** 2).sum(), leaves))
    torch.cuda.synchronize()
    for name, u, v in zip(names, *grads):
        assert _rel_err(u, v) <= RTOL_BF16_OUT, name


@pytest.mark.gpu
def test_windowed_kernels_refuse_what_they_do_not_take():
    _need_card()
    c = _wcase(26, 200, 3000, 32, 32, 24, 8, 40)
    args = list(_w_bwd_inputs(c, 27))
    with pytest.raises(ValueError, match="bf16"):
        wa.windowed_fwd(args[0].float(), *args[1:], **c["kw"])
    with pytest.raises(ValueError, match="int32"):
        wa.windowed_bwd(*args[:4], args[4].long(), *args[5:], **c["kw"])
    with pytest.raises(ValueError, match="float32"):
        wa.windowed_bwd(*args[:9], args[9].bfloat16(), **c["kw"])
    with pytest.raises(ValueError, match="slots do not match"):
        wa.windowed_fwd(*args, node_block=32, edge_tile=64)


def _ccase(seed, n, e, nb, et, d, de, h, dtype=torch.bfloat16):
    """A random graph with hub receivers (a tenth of the edges go to five
    nodes, so their runs span tiles), its CSR tiling and sender-sorted
    tiling from the port's host tiler under the static tile budget, the
    landing read off the latter, and the aggregation's inputs on the card:
    x and w_s in `dtype`, e_t and w_e in float32 (v2's contract)."""
    rng = np.random.default_rng(seed)
    send = rng.integers(0, n, e).astype(np.int32)
    recv = np.where(rng.random(e) < 0.1, rng.integers(0, 5, e),
                    rng.integers(0, n, e)).astype(np.int32)
    total = -(-e // et) + -(-n // nb)
    perm, blocks, precv = wt.prepare_csr_tiles(recv, np.ones(e, bool), n, nb,
                                               et, total)
    senders_t = send[perm]
    s_perm, _, s_send = wt.prepare_csr_tiles(senders_t, precv >= 0, n, nb,
                                             et, total)
    land = ss.csr_landing(s_perm, s_send, n)
    e_feat = rng.normal(size=(e, de))

    def t(arr, cast=None):
        out = torch.from_numpy(np.ascontiguousarray(arr)).cuda()
        return out if cast is None else out.to(cast)

    return dict(
        landing=ss.SenderLanding(t(land[0]), t(land[1])),
        x=t(rng.normal(size=(n, d)), dtype),
        w_s=t(rng.normal(size=(d, h)) * d ** -0.5, dtype),
        e_t=t(e_feat[perm], torch.float32),
        w_e=t(rng.normal(size=(de, h)) * de ** -0.5, torch.float32),
        offset=t(rng.normal(size=(n, h)), torch.float32),
        layout=(t(senders_t), t(precv), t(blocks)),
        kw=dict(node_block=nb, edge_tile=et))


_CSHAPES = [
    (200, 3000, 32, 32, 24, 8, 40),       # small tiles (R 32), odd H
    (2048, 40000, 256, 512, 224, 16, 464),    # the flagship layers' widths
    (2048, 40000, 256, 512, 128, 16, 272),
    (2048, 40000, 256, 512, 64, 16, 144),
]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", _CSHAPES)
def test_csr_fwd_kernel_matches_plain(shape):
    """B5's forward, serving and VJP mode, hubs spanning tiles, against its
    plain version to smoke.CSR_FWD_RTOL (1e-5) of the output's scale: e_t
    and W_e stay float32, so only the summation order differs; the empty
    receivers agree exactly."""
    _need_card()
    c = _ccase(30, *shape)
    args = (c["x"], c["w_s"], c["e_t"], c["w_e"], *c["layout"], c["offset"])
    before = ca.csr_fwd_cuda.launches
    got = ca.csr_fwd(*args, **c["kw"])
    got_vjp, inner = ca.csr_fwd(*args, emit_inner=True, **c["kw"])
    torch.cuda.synchronize()
    assert ca.csr_fwd_cuda.launches == before + 2
    want, want_inner = ca.csr_fwd_plain(*args, emit_inner=True, **c["kw"])
    assert torch.isfinite(got).all() and torch.equal(got, got_vjp)
    assert _rel_err(got, want) <= smoke.CSR_FWD_RTOL
    assert torch.equal(got == 0, want == 0)
    has = want_inner > da._NEG / 2
    assert torch.equal(inner > da._NEG / 2, has)
    assert _rel_err(inner[has], want_inner[has]) <= smoke.CSR_FWD_RTOL


def _c_bwd_inputs(c, seed, dyadic=False, real_g=False):
    """B5's backward inputs: the kernel forward's maxima and a seeded g,
    zeroed at empty receivers. With `dyadic` every operand is a multiple of
    1/8 (exact sums in any order), and so is g unless `real_g`."""
    gen = torch.Generator().manual_seed(seed)
    if dyadic:
        for k in ("x", "w_s", "e_t", "w_e"):
            c[k] = (torch.randint(-4, 5, c[k].shape, generator=gen)
                    * 0.125).to(c[k])
    _, inner = ca.csr_fwd(c["x"], c["w_s"], c["e_t"], c["w_e"], *c["layout"],
                          c["offset"], emit_inner=True, **c["kw"])
    g = torch.randn(inner.shape, generator=gen)
    if dyadic and not real_g:
        g = (g * 8).round() / 8
    has = inner > da._NEG / 2
    return (c["x"], c["w_s"], c["e_t"], c["w_e"], *c["layout"],
            torch.where(has, inner, 0.0), torch.where(has, g.cuda(), 0.0))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", _CSHAPES[:2] + _CSHAPES[3:])
def test_csr_bwd_kernel_matches_plain(shape):
    """On dyadic inputs B5's backward and its plain version form the same
    exact sums: all four outputs agree bitwise, d_e and dW_e in float32."""
    _need_card()
    c = _ccase(31, *shape)
    args = _c_bwd_inputs(c, 32, dyadic=True)
    before = ca.csr_bwd_cuda.launches
    got = ca.csr_bwd(*args, **c["kw"])
    torch.cuda.synchronize()
    assert ca.csr_bwd_cuda.launches == before + 1
    want = ca.csr_bwd_plain(*args, **c["kw"])
    for name, u, v in zip(("d_xg", "d_e", "dW_s", "dW_e"), got, want):
        assert u.dtype == v.dtype and u.shape == v.shape, name
        assert torch.equal(u, v), name
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    assert got[1].abs().max() > 0


@pytest.mark.gpu
@pytest.mark.parametrize("shape", _CSHAPES[:2] + _CSHAPES[3:])
def test_csr_bwd_edge_grads_keep_float32_d_op(shape):
    """Dyadic operands (op and routing exact) with a real-valued g, which
    bf16 does not hold: B5's d_e and dW_e come from the float32 d_op, so
    they agree with the plain version to smoke.CSR_EDGE_GRAD_RTOL of their
    own scale, and the plain version with g rounded to bf16 on that side
    (the fault this holds the kernel against) lands far outside it."""
    _need_card()
    c = _ccase(38, *shape)
    args = _c_bwd_inputs(c, 39, dyadic=True, real_g=True)
    got = ca.csr_bwd(*args, **c["kw"])
    torch.cuda.synchronize()
    want = ca.csr_bwd_plain(*args, **c["kw"])
    rounded = ca.csr_bwd_plain(*args[:-1], args[-1].bfloat16().float(),
                               **c["kw"])
    for name, i in (("d_e", 1), ("dW_e", 3)):
        assert smoke._own_scale_err(got[i], want[i]) \
            <= smoke.CSR_EDGE_GRAD_RTOL, name
        assert smoke._own_scale_err(rounded[i], want[i]) \
            > 10 * smoke.CSR_EDGE_GRAD_RTOL, name


@pytest.mark.gpu
def test_csr_backward_is_bitwise_deterministic():
    """Two runs of B5's backward and the landing on the same real-valued
    inputs give the same bits."""
    _need_card()
    c = _ccase(33, *_CSHAPES[1])
    args = _c_bwd_inputs(c, 34)
    order, row_ptr = c["landing"]
    runs = []
    for _ in range(2):
        d_xg, d_e, dw_s, dw_e = ca.csr_bwd(*args, **c["kw"])
        d_x = ss.segment_sum_csr(d_xg, order, row_ptr)
        runs.append((d_x, d_e, dw_s, dw_e))
    torch.cuda.synchronize()
    for u, v in zip(*runs):
        assert torch.equal(u, v)


@pytest.mark.gpu
def test_csr_aggregate_gradients_match_plain_path():
    """CsrAggregateFn on the kernels against the same Function with the
    kernels patched to their plain versions, float32 inputs of odd widths
    (zero-padded for the kernels)."""
    _need_card()
    c = _ccase(35, 200, 3000, 32, 32, 21, 2, 40, dtype=torch.float32)
    names = ("x", "w_s", "e_t", "w_e", "offset")
    grads = []
    for plain in (False, True):
        leaves = [c[nm].clone().requires_grad_(True) for nm in names]
        with smoke._plain_kernels() if plain else contextlib.nullcontext():
            x, w_s, e_t, w_e, offset = leaves
            # the JAX package's argument order
            out = ca.csr_aggregate(x, w_s, e_t, w_e, *c["layout"], offset,
                                   landing=c["landing"], **c["kw"])
            grads.append(torch.autograd.grad((out ** 2).sum(), leaves))
    torch.cuda.synchronize()
    for name, u, v in zip(names, *grads):
        assert _rel_err(u, v) <= RTOL_BF16_OUT, name


@pytest.mark.gpu
def test_csr_kernels_refuse_what_they_do_not_take():
    """A CUDA tensor the kernels do not take raises; nothing falls back to
    the plain versions."""
    _need_card()
    c = _ccase(36, 200, 3000, 32, 32, 24, 8, 40)
    args = list(_c_bwd_inputs(c, 37))
    fwd_args = args[:7] + [c["offset"]]
    before = ca.csr_fwd_cuda.launches
    with pytest.raises(ValueError, match="bf16"):
        ca.csr_fwd(args[0].float(), *fwd_args[1:], **c["kw"])
    with pytest.raises(ValueError, match="float32"):
        ca.csr_fwd(*fwd_args[:2], args[2].bfloat16(), *fwd_args[3:],
                   **c["kw"])
    with pytest.raises(ValueError, match="slots do not match"):
        ca.csr_fwd(*fwd_args, node_block=32, edge_tile=64)
    with pytest.raises(ValueError, match="int32"):
        ca.csr_bwd(*args[:4], args[4].long(), *args[5:], **c["kw"])
    with pytest.raises(ValueError, match="float32"):
        ca.csr_bwd(*args[:8], args[8].bfloat16(), **c["kw"])
    assert ca.csr_fwd_cuda.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["dense", "windowed", "csr"])
def test_backward_at_a_conv_width_of_450(path):
    """H = 450 (2 x 224 + 2, raw relative-position edge features), not a
    multiple of 8: each path's autograd Function trains on the kernels
    (the backward wrappers pad H) and matches the plain path."""
    _need_card()
    if path == "dense":
        c = _case(40, 256, 9, 32, 64, 21, 2, 450, dtype=torch.float32)
        names = ("x", "w_s", "e_t", "w_e", "offset", "e_ovf")
        aggregate = _dense_agg(c)
        launches = (da.dense_bwd_cuda, "launches")
    elif path == "windowed":
        c = _wcase(41, 200, 3000, 32, 32, 21, 2, 450, dtype=torch.float32)
        names = ("x", "w_s", "e_t", "w_e", "offset", "e_ovf")
        recv, sloc, t_win, blocks = c["layout"]

        def aggregate(leaves):
            return wa.windowed_aggregate(*leaves, recv, blocks, t_win, sloc,
                                         c["ovf_s"], c["ovf_r"],
                                         landing=c["landing"], **c["kw"])
        launches = (wa.windowed_bwd_cuda, "launches")
    else:
        c = _ccase(42, 200, 3000, 32, 32, 21, 2, 450, dtype=torch.float32)
        names = ("x", "w_s", "e_t", "w_e", "offset")

        def aggregate(leaves):
            x, w_s, e_t, w_e, offset = leaves
            return ca.csr_aggregate(x, w_s, e_t, w_e, *c["layout"], offset,
                                    landing=c["landing"], **c["kw"])
        launches = (ca.csr_bwd_cuda, "launches")
    before = getattr(*launches)
    grads = _grads_kernel_and_plain(aggregate, c, names)
    assert getattr(*launches) == before + 1
    for name, u, v in zip(names, *grads):
        assert u.shape == c[name].shape and torch.isfinite(u).all(), name
        assert _rel_err(u, v) <= RTOL_BF16_OUT, name


# -- the kernels no model path runs: fused linear, segment-max, v1 pair ----

def _cuda(arr, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(arr)).cuda().to(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [
    (1000, 48, 64, False), (1000, 48, 64, True),
    (14080, 224, 464, False),     # the flagship's nodes, 224 -> 464
    (4096, 256, 512, True),       # kernel_check's shape
    (333, 37, 71, True),          # no dimension a multiple of a tile
])
def test_fused_linear_kernel_matches_plain(shape):
    """B9 against its plain version to smoke.F32_RTOL of the output's
    scale: float32 products and sums on both sides."""
    _need_card()
    m, k, n, relu = shape
    rng = np.random.default_rng(40)
    x = _cuda(rng.normal(size=(m, k)))
    w = _cuda(rng.normal(size=(k, n)) * k ** -0.5)
    b = _cuda(rng.normal(size=(n,)))
    before = fl.fused_linear_cuda.launches
    got = fl.fused_linear(x, w, b, relu=relu)
    torch.cuda.synchronize()
    assert fl.fused_linear_cuda.launches == before + 1
    want = fl.fused_linear_plain(x, w, b, relu=relu)
    assert got.shape == (m, n) and torch.isfinite(got).all()
    assert _rel_err(got, want) <= smoke.F32_RTOL
    if relu:
        assert (got >= 0).all()


def _segmax_inputs(seed, e, n, d_in, h, nb, et, mask_frac=0.9):
    rng = np.random.default_rng(seed)
    recv = rng.integers(0, n, e).astype(np.int32)
    perm, blocks, precv = wt.prepare_csr_tiles(recv, rng.random(e) < mask_frac,
                                               n, nb, et)
    m_in = rng.normal(size=(e, d_in))[perm]
    return (_cuda(m_in), _cuda(rng.normal(size=(d_in, h)) * d_in ** -0.5),
            _cuda(rng.normal(size=(h,))), _cuda(precv, torch.int32),
            _cuda(blocks, torch.int32)), dict(num_nodes=n, node_block=nb,
                                              edge_tile=et)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [
    (6000, 1000, 37, 71, 128, 128),     # odd widths, a partial last block
    (60000, 2816, 464, 464, 128, 256),  # kernel_bench's widths and tiles
    (600, 100, 24, 40, 32, 32),         # tests/test_pallas.py's case
])
@pytest.mark.parametrize("variant", ["scan", "onehot"])
def test_msg_segmax_kernel_matches_plain(shape, variant):
    """B8 under both of the JAX function's variants against its plain
    version to smoke.F32_RTOL of the output's scale; receivers without a
    slot are exactly 0."""
    _need_card()
    args, kw = _segmax_inputs(41, *shape)
    before = msm.msg_segmax_cuda.launches
    got = msm.fused_message_segment_max(*args, variant=variant, **kw)
    torch.cuda.synchronize()
    assert msm.msg_segmax_cuda.launches == before + 1
    want = msm.msg_segmax_plain(*args, **kw)
    assert _rel_err(got, want) <= smoke.F32_RTOL
    assert torch.equal(got == 0, want == 0)


@pytest.mark.gpu
def test_msg_segmax_empty_blocks_and_negative_maxima():
    """The empty-block and all-negative cases of the JAX package's tests,
    as the smoke holds them: empty receivers 0, negative maxima kept."""
    _need_card()
    for case in smoke._segmax_small_cases(torch.device("cuda")):
        got = msm.msg_segmax(*case["args"], **case["kw"])
        want = msm.msg_segmax_plain(*case["args"], **case["kw"])
        torch.cuda.synchronize()
        assert (got[case["zero_rows"]] == 0).all(), case["name"]
        assert _rel_err(got, want) <= smoke.F32_RTOL, case["name"]
        if "exact" in case:
            rows, value = case["exact"]
            assert (got[rows] == value).all()


def _v1_inputs(seed, n, e, de, h, nb=128, et=256, dyadic=False):
    """A random graph under the v1 tiles and the v1 pair's float32 inputs
    on the card; with `dyadic` every operand is a multiple of 1/8."""
    rng = np.random.default_rng(seed)
    send = rng.integers(0, n, e).astype(np.int32)
    recv = rng.integers(0, n, e).astype(np.int32)
    perm, blocks, precv = wt.prepare_csr_tiles(recv, rng.random(e) < 0.9, n,
                                               nb, et)

    def r(*shape):
        a = rng.normal(size=shape)
        return np.round(a * 4) / 8 if dyadic else a

    ops = (_cuda(r(n, h)), _cuda(r(e, de)[perm]), _cuda(r(de, h)),
           _cuda(r(h)))
    layout = (_cuda(send[perm], torch.int32), _cuda(precv, torch.int32),
              _cuda(blocks, torch.int32))
    return ops, layout, _cuda(r(n, h)), dict(node_block=nb, edge_tile=et)


_V1SHAPES = [
    (2816, 56320, 16, 464),     # a flagship frame at the widest layer
    (2816, 56320, 16, 144),
    (300, 4000, 3, 40),         # odd widths, a partial last block
]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", _V1SHAPES)
def test_hoisted_fwd_kernel_matches_plain(shape):
    """B6, serving and VJP mode, against its plain version to
    smoke.F32_RTOL of the output's scale; empty receivers agree exactly."""
    _need_card()
    ops, layout, offset, kw = _v1_inputs(42, *shape)
    before = ha.hoisted_fwd_cuda.launches
    got = ha.hoisted_fwd(*ops, *layout, offset, **kw)
    got_vjp, inner = ha.hoisted_fwd(*ops, *layout, offset, emit_inner=True,
                                    **kw)
    torch.cuda.synchronize()
    assert ha.hoisted_fwd_cuda.launches == before + 2
    want, want_inner = ha.hoisted_fwd_plain(*ops, *layout, offset,
                                            emit_inner=True, **kw)
    assert torch.equal(got, got_vjp)
    assert _rel_err(got, want) <= smoke.F32_RTOL
    has = want_inner > da._NEG / 2
    assert torch.equal(inner > da._NEG / 2, has)
    assert _rel_err(inner[has], want_inner[has]) <= smoke.F32_RTOL


def _v1_bwd_args(ops, layout, kw, seed, real_g=False):
    n, h = ops[0].shape[0], ops[0].shape[1]
    _, inner = ha.hoisted_fwd(*ops, *layout, torch.zeros(
        (n, h), device="cuda"), emit_inner=True, **kw)
    gen = torch.Generator().manual_seed(seed)
    g = torch.randn((n, h), generator=gen)
    if not real_g:
        g = (g * 8).round() / 8
    has = inner > da._NEG / 2
    return ops + layout + (torch.where(has, inner, 0.0),
                           torch.where(has, g.cuda(), 0.0))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", _V1SHAPES)
def test_hoisted_bwd_kernel_is_exact_on_dyadic_inputs(shape):
    """On dyadic inputs B7 and its plain version form the same exact sums
    (ties are frequent; each tied slot takes the full g): d_op, d_e, dW_e
    and d_b agree bitwise, and a second run gives the same bits."""
    _need_card()
    ops, layout, _, kw = _v1_inputs(43, *shape, dyadic=True)
    args = _v1_bwd_args(ops, layout, kw, 44)
    before = ha.hoisted_bwd_cuda.launches
    got = ha.hoisted_bwd(*args, **kw)
    again = ha.hoisted_bwd(*args, **kw)
    torch.cuda.synchronize()
    assert ha.hoisted_bwd_cuda.launches == before + 2
    want = ha.hoisted_bwd_plain(*args, **kw)
    for name, u, v, w in zip(("d_op", "d_e", "dW_e", "d_b"), got, want,
                             again):
        assert u.shape == v.shape and torch.equal(u, v), name
        assert torch.equal(u, w), name
    assert got[0].abs().max() > 0


@pytest.mark.gpu
@pytest.mark.parametrize("shape", _V1SHAPES[:1] + _V1SHAPES[2:])
def test_hoisted_bwd_kernel_with_a_real_valued_g(shape):
    """Dyadic operands (exact routing) with a real-valued g: d_e, dW_e and
    d_b agree with the plain version to smoke.F32_RTOL of their own scale,
    d_op exactly."""
    _need_card()
    ops, layout, _, kw = _v1_inputs(45, *shape, dyadic=True)
    args = _v1_bwd_args(ops, layout, kw, 46, real_g=True)
    got = ha.hoisted_bwd(*args, **kw)
    torch.cuda.synchronize()
    want = ha.hoisted_bwd_plain(*args, **kw)
    assert torch.equal(got[0], want[0])
    for name, i in (("d_e", 1), ("dW_e", 2), ("d_b", 3)):
        assert smoke._own_scale_err(got[i], want[i]) <= smoke.F32_RTOL, name


@pytest.mark.gpu
def test_hoisted_bwd_kernel_gates_padding_slots():
    """A padding slot (receiver -1) whose operand equals receiver 0's
    inner_z takes no gradient: the has_recv gate of the TPU kernel."""
    _need_card()
    ops, layout, _, kw = _v1_inputs(47, 300, 4000, 8, 40, dyadic=True)
    args = list(_v1_bwd_args(ops, layout, kw, 48))
    recv = layout[1]
    pad = int(torch.nonzero(recv < 0)[0])
    op_pad = (args[0][layout[0][pad].long()] + args[1][pad] @ args[2]) \
        + args[3]
    args[7] = args[7].clone()
    args[7][0] = op_pad
    args[8] = args[8].clone()
    args[8][0] = 1.0
    d_op, d_e, _, _ = ha.hoisted_bwd(*args, **kw)
    torch.cuda.synchronize()
    assert (d_op[pad] == 0).all() and (d_e[pad] == 0).all()
    want = ha.hoisted_bwd_plain(*args, **kw)
    assert torch.equal(d_op, want[0])


@pytest.mark.gpu
@pytest.mark.parametrize("factory", [
    "make_fused_hoisted_aggregate", "make_fused_hoisted_aggregate_pallas_bwd"])
def test_hoisted_aggregate_gradients_match_plain_path(factory):
    """Both v1 factories on the kernels against the same factories with
    the kernels patched to their plain versions: the output and the five
    gradients (B3 lands d_y_s for the kernel backward)."""
    _need_card()
    ops, layout, offset, kw = _v1_inputs(49, 2816, 56320, 16, 144)
    fused = getattr(ha, factory)(2816, **kw)
    results = []
    for plain in (False, True):
        patches = contextlib.ExitStack()
        if plain:
            for name in ("hoisted_fwd", "hoisted_bwd"):
                patches.enter_context(mock.patch.object(
                    ha, name, getattr(ha, f"{name}_plain")))
            patches.enter_context(mock.patch.object(
                ss, "segment_sum_csr", ss.segment_sum_csr_plain))
        with patches:
            leaves = [a.clone().requires_grad_(True)
                      for a in ops + (offset,)]
            out = fused(*leaves[:4], *layout, leaves[4])
            results.append((out.detach(),) + torch.autograd.grad(
                (out ** 2).sum(), leaves))
    torch.cuda.synchronize()
    for name, u, v in zip(("out", "y_s", "e_t", "w_e", "b", "offset"),
                          *results):
        assert _rel_err(u, v) <= 1e-4, name


@pytest.mark.gpu
def test_float32_kernels_refuse_what_they_do_not_take():
    """A CUDA tensor the four kernels do not take raises; nothing falls
    back to the plain versions."""
    _need_card()
    x = torch.randn(64, 32, device="cuda")
    w = torch.randn(32, 16, device="cuda")
    b = torch.randn(16, device="cuda")
    counters = (fl.fused_linear_cuda, msm.msg_segmax_cuda,
                ha.hoisted_fwd_cuda, ha.hoisted_bwd_cuda)
    before = [c.launches for c in counters]
    with pytest.raises(ValueError, match="float32"):
        fl.fused_linear(x.bfloat16(), w, b)
    with pytest.raises(ValueError, match="contiguous"):
        fl.fused_linear(x, w.t().contiguous().t(), b)
    with pytest.raises(ValueError, match="do not match"):
        fl.fused_linear(x, w[:16], b)
    args, kw = _segmax_inputs(50, 600, 100, 24, 40, 32, 32)
    with pytest.raises(ValueError, match="float32"):
        msm.msg_segmax(args[0].double(), *args[1:], **kw)
    with pytest.raises(ValueError, match="int32"):
        msm.msg_segmax(*args[:3], args[3].long(), args[4], **kw)
    with pytest.raises(ValueError, match="slots do not match"):
        msm.msg_segmax(*args, num_nodes=100, node_block=32, edge_tile=64)
    ops, layout, offset, vkw = _v1_inputs(51, 300, 4000, 8, 40)
    with pytest.raises(ValueError, match="float32"):
        ha.hoisted_fwd(ops[0].bfloat16(), *ops[1:], *layout, offset, **vkw)
    with pytest.raises(ValueError, match="int32"):
        ha.hoisted_fwd(*ops, layout[0].long(), *layout[1:], offset, **vkw)
    with pytest.raises(ValueError, match="contiguous"):
        ha.hoisted_bwd(*ops, *layout, offset, offset.t().contiguous().t(),
                       **vkw)
    ops, layout, offset, vkw = _v1_inputs(52, 100, 1000, 8, 40, nb=32, et=30)
    fwd_launches = ha.hoisted_fwd_cuda.launches
    args = _v1_bwd_args(ops, layout, vkw, 53)   # the forward takes 30 slots
    with pytest.raises(ValueError, match="multiple of 4"):
        ha.hoisted_bwd(*args, **vkw)
    before[2] += ha.hoisted_fwd_cuda.launches - fwd_launches
    assert [c.launches for c in counters] == before


@pytest.mark.gpu
def test_kernel_entry_points_on_card():
    """kernel_check passes on the card (its last line KERNEL CHECK OK), and
    kernel_bench at a reduced size prints both JSON lines with times."""
    _need_card()
    lines = []
    kernel_check.run("cuda", out=lines.append)
    assert lines[-1] == "KERNEL CHECK OK"
    lines = []
    res = kernel_bench.run("cuda", edges=45_056, nodes=2_253, reps=2,
                           out=lines.append)
    rows = [json.loads(s) for s in lines]
    assert [r["metric"] for r in rows] == ["segmax_library_ms",
                                           "segmax_kernel_ms"]
    assert all(r["value"] > 0 for r in rows)
    assert res["tiles"] > 0


@pytest.mark.gpu
def test_smoke_on_card():
    """The smoke at a small size: the kernels build and match their plain
    versions at the model's layer shapes, every conv layer of each of the
    three requests launches its forward (the dense path its projection
    too), and every conv layer of each of the two train steps launches the
    path's kernels (B3 on the windowed and CSR paths). Two steps keep it
    short; each is held to the plain path at its own parameters, with the
    smoke's limits."""
    _need_card()
    summary = smoke.run("cuda", points=512, graphs=2, batches=3, reps=2,
                        train_steps=2, bench=(45_056, 2_253, 464, 464))
    # the fourth phase's kernels: kernel_check's linear, segment-max (and
    # kernel_bench's check, warm-up and 2 timed calls), the forward through
    # both v1 factories and the kernel backward
    assert [k["launches"] for k in summary["kernels"]] == \
        [5 * 2, 5 * 2, 5 * 2, 2 * 5 * 2, 5 * 2, 5 * 2, 5 * 2, 5 * 2, 1,
         1 + 3 + 1, 2, 1]
    assert summary["serve_launches"] == [5 * 3] + [0] * 10 + [5 * 3]
    assert summary["radius"]["serve_launches"] == [0, 0, 0, 5 * 3] + [0] * 8
    assert summary["csr"]["serve_launches"] == [0] * 5 + [5 * 3] + [0] * 6
    for kernel in summary["kernels"]:
        assert kernel["ms"] > 0 and kernel["plain_ms"] > 0
    assert summary["kernels"][0]["library_ms"] > 0
    assert summary["kernels"][3]["library_ms"] > 0
