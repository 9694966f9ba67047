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
from unittest import mock

import numpy as np
import pytest
import torch

from radargnn_tpu_torch import smoke
from radargnn_tpu_torch.ops import csr_aggregate as ca
from radargnn_tpu_torch.ops import dense_aggregate as da
from radargnn_tpu_torch.ops import dense_tiles as tdt
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


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [
    (128, 7, 16, 32, 24, 8, 40),          # small tile, H not a multiple of 64
    (1024, 24, 64, 256, 224, 16, 464),    # the flagship layers' widths
    (1024, 24, 64, 256, 128, 16, 272),
    (1024, 24, 64, 256, 64, 16, 144),
])
def test_dense_fwd_kernel_matches_plain(shape):
    _need_card()
    c = _case(0, *shape)
    inner_o = da.dense_overflow_inner(c["x"], c["w_s"], c["e_ovf"], c["w_e"],
                                      c["ovf_s"], c["ovf_r"], shape[0])
    args = (c["x"], c["w_s"], c["e_t"], c["w_e"], c["sloc"], c["tile_win"],
            inner_o, c["offset"])
    before = da.dense_fwd_cuda.launches
    got = da.dense_fwd(*args, **c["kw"])
    torch.cuda.synchronize()
    assert da.dense_fwd_cuda.launches == before + 1
    want = da.dense_fwd_plain(*args, **c["kw"])
    assert torch.isfinite(got).all()
    assert _rel_err(got, want) <= RTOL
    assert torch.equal(got == 0, want == 0)       # the same empty receivers


@pytest.mark.gpu
def test_dense_aggregate_pads_odd_widths():
    """Widths that are not multiples of 8 (d_in 21, d_e 2: raw edge features
    without an embedding) reach the kernel zero-padded, from float32
    inputs, and give the plain path's result."""
    _need_card()
    c = _case(1, 128, 7, 16, 32, 21, 2, 40, dtype=torch.float32)
    args = (c["x"], c["w_s"], c["e_t"], c["w_e"], c["offset"], c["e_ovf"],
            c["tile_win"], c["sloc"], c["ovf_s"], c["ovf_r"])
    got = da.dense_aggregate(*args, **c["kw"])
    with mock.patch.object(da, "dense_fwd", da.dense_fwd_plain):
        want = da.dense_aggregate(*args, **c["kw"])
    torch.cuda.synchronize()
    assert _rel_err(got, want) <= RTOL


@pytest.mark.gpu
def test_kernel_refuses_what_it_does_not_take():
    _need_card()
    c = _case(2, 128, 7, 16, 32, 24, 8, 40)
    inner_o = torch.full_like(c["offset"], da._NEG)
    args = [c["x"], c["w_s"], c["e_t"], c["w_e"], c["sloc"], c["tile_win"],
            inner_o, c["offset"]]
    with pytest.raises(ValueError, match="bf16"):
        da.dense_fwd(c["x"].float(), *args[1:], **c["kw"])
    with pytest.raises(ValueError, match="contiguous"):
        da.dense_fwd(c["x"].t().contiguous().t(), *args[1:], **c["kw"])
    c = _case(3, 128, 7, 8, 32, 24, 8, 40)          # 8 receivers per tile
    with pytest.raises(ValueError, match="r_tile"):
        da.dense_fwd(c["x"], c["w_s"], c["e_t"], c["w_e"], c["sloc"],
                     c["tile_win"], torch.full_like(c["offset"], da._NEG),
                     c["offset"], **c["kw"])


def _bwd_inputs(c, seed):
    """The backward kernels' inputs for case `c`: the kernel forward's
    maxima (VJP mode) and a seeded g, zeroed at empty receivers."""
    n = c["offset"].shape[0]
    inner_o = da.dense_overflow_inner(c["x"], c["w_s"], c["e_ovf"], c["w_e"],
                                      c["ovf_s"], c["ovf_r"], n)
    _, inner = da.dense_fwd(c["x"], c["w_s"], c["e_t"], c["w_e"], c["sloc"],
                            c["tile_win"], inner_o, c["offset"],
                            emit_inner=True, **c["kw"])
    gen = torch.Generator().manual_seed(seed)
    g = torch.randn(inner.shape, generator=gen).cuda()
    has = inner > da._NEG / 2
    return (c["x"], c["w_s"], c["e_t"], c["w_e"], c["sloc"], c["tile_win"],
            torch.where(has, inner, 0.0), torch.where(has, g, 0.0))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [
    (128, 7, 16, 32, 24, 8, 40),
    (1024, 24, 64, 256, 224, 16, 464),
    (1024, 24, 64, 256, 64, 16, 144),
])
def test_dense_bwd_kernel_matches_plain(shape):
    _need_card()
    c = _case(4, *shape)
    args = _bwd_inputs(c, 5)
    before = da.dense_bwd_cuda.launches
    got = da.dense_bwd(*args, **c["kw"])
    torch.cuda.synchronize()
    assert da.dense_bwd_cuda.launches == before + 1
    want = da.dense_bwd_plain(*args, **c["kw"])
    for name, u, v, tol in zip(("d_xg", "d_e", "dW_s", "dW_e"), got, want,
                               (RTOL_BF16_OUT, RTOL_BF16_OUT, RTOL, RTOL)):
        assert u.dtype == v.dtype and u.shape == v.shape, name
        assert torch.isfinite(u).all(), name
        assert _rel_err(u.float(), v.float()) <= tol, name


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
    """Two runs of the backward kernels and the landing on the same inputs
    give the same bits."""
    _need_card()
    c = _case(8, 1024, 24, 64, 256, 224, 16, 464)
    args = _bwd_inputs(c, 9)
    order, row_ptr = c["landing"]
    # the landing lists the overflow rows too, after the slots
    ovf_rows = torch.ones((c["ovf_s"].shape[0], 224), device="cuda")
    runs = []
    for _ in range(2):
        d_xg, d_e, dw_s, dw_e = da.dense_bwd(*args, **c["kw"])
        d_x = ss.segment_sum_csr(d_xg, order, row_ptr, ovf_rows)
        runs.append((d_x, d_e, dw_s, dw_e))
    torch.cuda.synchronize()
    for u, v in zip(*runs):
        assert torch.equal(u, v)


@pytest.mark.gpu
def test_dense_aggregate_gradients_match_plain_path():
    """The autograd Function on the kernels against the same Function with
    the three kernels patched to their plain versions, float32 inputs of
    odd widths (zero-padded for the kernels)."""
    _need_card()
    c = _case(10, 128, 7, 16, 32, 21, 2, 40, dtype=torch.float32)
    names = ("x", "w_s", "e_t", "w_e", "offset", "e_ovf")
    grads = []
    for plain in (False, True):
        leaves = [c[nm].clone().requires_grad_(True) for nm in names]
        with smoke._plain_kernels() if plain else contextlib.nullcontext():
            out = da.dense_aggregate(*leaves, c["tile_win"], c["sloc"],
                                     c["ovf_s"], c["ovf_r"],
                                     landing=c["landing"], **c["kw"])
            grads.append(torch.autograd.grad((out ** 2).sum(), leaves))
    torch.cuda.synchronize()
    for name, u, v in zip(names, *grads):
        assert _rel_err(u, v) <= RTOL_BF16_OUT, name


@pytest.mark.gpu
def test_backward_kernels_refuse_what_they_do_not_take():
    _need_card()
    c = _case(11, 128, 7, 16, 32, 24, 8, 40)
    args = list(_bwd_inputs(c, 12))
    with pytest.raises(ValueError, match="bf16"):
        da.dense_bwd(args[0].float(), *args[1:], **c["kw"])
    with pytest.raises(ValueError, match="float32"):
        da.dense_bwd(*args[:7], args[7].bfloat16(), **c["kw"])
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
def test_smoke_on_card():
    """The smoke at a small size: the kernels build and match their plain
    versions at the model's layer shapes, every conv layer of each of the
    three requests launches its forward, and every conv layer of each of
    the two train steps launches the path's three kernels (B3 on all
    three paths). Two steps keep it short; each is held to the plain path
    at its own parameters, with the smoke's limits."""
    _need_card()
    summary = smoke.run("cuda", points=512, graphs=2, batches=3, reps=2,
                        train_steps=2)
    assert [k["launches"] for k in summary["kernels"]] == \
        [5 * 2, 5 * 2, 3 * 5 * 2, 5 * 2, 5 * 2, 5 * 2, 5 * 2]
    assert summary["radius"]["serve_launches"] == [0, 0, 0, 5 * 3, 0, 0, 0]
    assert summary["csr"]["serve_launches"] == [0, 0, 0, 0, 0, 5 * 3, 0]
    for kernel in summary["kernels"]:
        assert kernel["ms"] > 0 and kernel["plain_ms"] > 0
    assert summary["kernels"][2]["library_ms"] > 0
