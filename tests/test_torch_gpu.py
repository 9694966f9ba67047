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
import functools
import hashlib
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
    c = _case(3, 96, 7, 12, 48, 24, 8, 40)        # 12 receivers per tile
    with pytest.raises(ValueError, match="multiple of 8"):
        da.dense_fwd(*_fwd_args(c), **c["kw"])
    b_args = _bwd_inputs(_case(3, 96, 7, 16, 48, 24, 8, 40), 3)
    with pytest.raises(ValueError, match="multiple of 8"):
        da.dense_bwd(*b_args, r_tile=12, k=7)


# (n, K, R, node_block, d_in, d_e, H) at receiver tiles of 8 and 24, where
# the last warp of 16 rows holds 8 past the tile: a small tile with H not a
# multiple of 64, then the flagship's widths
_RSHAPES = [
    (96, 7, 8, 32, 24, 8, 40),
    (96, 7, 24, 32, 24, 8, 40),
    (1024, 24, 8, 256, 224, 16, 464),
    (1536, 24, 24, 256, 224, 16, 464),
    (1536, 24, 24, 256, 64, 16, 144),
]


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
@pytest.mark.parametrize("shape", _RSHAPES)
def test_dense_kernels_at_receiver_tiles_of_8(shape):
    """B1 and B2 where r_tile % 16 == 8: the gather-max against its plain
    version (serving and VJP mode, real-valued inputs, the dense forward's
    limits), then on dyadic inputs the bits and the backward's outputs
    bitwise, and two backward runs equal."""
    _need_card()
    c = _case(6, *shape)
    args = _fwd_args(c)
    got = da.dense_fwd(*args, **c["kw"])
    got_vjp, inner, bits = da.dense_fwd(*args, emit_inner=True, **c["kw"])
    want, want_inner, want_bits = da.dense_fwd_plain(*args, emit_inner=True,
                                                     **c["kw"])
    torch.cuda.synchronize()
    assert torch.isfinite(got).all() and torch.equal(got, got_vjp)
    assert _rel_err(got, want) <= RTOL
    assert torch.equal(got == 0, want == 0)
    assert torch.equal(inner > da._NEG / 2, want_inner > da._NEG / 2)
    assert smoke._popcount(bits ^ want_bits) <= \
        smoke.BITS_FLIP_FRAC * bits.numel() * 32
    b_args = _bwd_inputs(c, 7, dyadic=True)
    _, _, want_bits = da.dense_fwd_plain(*_fwd_args(c), emit_inner=True,
                                         **c["kw"])
    assert torch.equal(b_args[0], want_bits)
    got = da.dense_bwd(*b_args, **_bkw(c))
    again = da.dense_bwd(*b_args, **_bkw(c))
    want = da.dense_bwd_plain(*b_args, **_bkw(c))
    torch.cuda.synchronize()
    for name, u, v, w in zip(("d_e", "dW_e", "d_ys", "d_yo"), got, want,
                             again):
        assert torch.equal(u, w), name
        assert _rel_err(u.float(), v.float()) <= RTOL, name
        if name != "dW_e":
            assert torch.equal(u, v), name
    assert smoke._popcount(b_args[0]) > 0


@pytest.mark.gpu
def test_dense_shared_memory_at_receiver_tiles_of_8():
    """The gather-max's and the backward's shared memory at r_tile 8 and
    24 (the edge-row buffers take 16 rows a warp), and the wrappers'
    refusal where a block's would not fit."""
    _need_card()
    fwd, bwd = da.load_fwd_kernel(), da.load_bwd_kernel()
    for r, de, k in ((8, 16, 24), (24, 16, 24), (24, 8, 7), (16, 16, 24)):
        r16, lde = -(-r // 16) * 16, -(-de // 16) * 16 + 8
        index = 4 * (r * k + 192 + 2 * 128 + 4) + 2 * r * k
        want = -(-index // 16) * 16 + 2 * (64 + 2 * r16) * lde \
            + 4 * 192 * 72
        assert fwd.dense_fwd_v4_smem_bytes(de, r, k) == want, (r, de, k)
        assert bwd.dense_bwd_v4_smem_bytes(512, r) == 2 * r * 520
    # 24 receivers x 1,200 slot rows: the index arrays pass a block's limit
    n, k, de, h = 24, 1200, 16, 64
    dev = torch.device("cuda")
    z = functools.partial(torch.zeros, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        da.dense_fwd(z((n, 64)), z((n * k, de), dtype=torch.bfloat16),
                     z((de, h), dtype=torch.bfloat16),
                     z((n * k,), dtype=torch.int32),
                     z((1,), dtype=torch.int32), z((n, h)), z((n, h)),
                     r_tile=24, k=k, node_block=32)
    # the backward stages the tile's g rows over every column: 4,864 wide
    k, h = 2, 4864
    hp = da.col_pad(h)
    with pytest.raises(ValueError, match="shared memory"):
        da.dense_bwd(z((n * k, hp // 32), dtype=torch.int32), z((n, h)),
                     z((n * k, de), dtype=torch.bfloat16),
                     z((de, h), dtype=torch.bfloat16), z((0, h)),
                     z((0,), dtype=torch.int32),
                     z((n + 1,), dtype=torch.int32), r_tile=24, k=k)


def _landing_case(rng, n_rows, n_seg, empty=0, hub=0, keep=0.9):
    """A sender-sorted landing over `n_rows` rows: each kept row at a
    random segment of the first n_seg - empty, `hub` more rows at segment
    0; the last `empty` segments empty. Returns (order, row_ptr) int32 on
    the card."""
    seg = np.where(rng.random(n_rows) < keep,
                   rng.integers(0, n_seg - empty, n_rows), -1)
    if hub:
        seg[rng.choice(np.flatnonzero(seg >= 0), hub, replace=False)] = 0
    rows = np.flatnonzero(seg >= 0)
    order = rows[np.argsort(seg[rows], kind="stable")].astype(np.int32)
    row_ptr = np.concatenate(
        [[0], np.cumsum(np.bincount(seg[rows], minlength=n_seg))])
    return (torch.from_numpy(order).cuda(),
            torch.from_numpy(row_ptr.astype(np.int32)).cuda())


def _check_listed(a, order, row_ptr, b=None, width=None):
    """The kernel's sums: one launch, bitwise the listed-order float32 sum
    (the columns past the width 0) and bitwise again on a second run."""
    before = ss.segment_sum_csr_cuda.launches
    got = ss.segment_sum_csr(a, order, row_ptr, b, width=width)
    again = ss.segment_sum_csr(a, order, row_ptr, b, width=width)
    torch.cuda.synchronize()
    assert ss.segment_sum_csr_cuda.launches == before + 2
    want = ss.segment_sum_csr_listed(a, order, row_ptr, b, width=width)
    assert got.shape == (row_ptr.numel() - 1, a.shape[1])
    assert torch.equal(got, want) and torch.equal(got, again)
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("d,pitch", [(224, 224), (464, 512), (64, 64)])
def test_segment_sum_kernel_matches_plain(d, pitch):
    """Both sources (bf16 rows, then f32 rows), skipped rows and empty
    segments, at the flagship's widest landings (d_in 224; H 464 of d_op's
    512 columns) and a narrow one; within 1e-5 of the plain version and
    bitwise the listed-order sum."""
    _need_card()
    rng = np.random.default_rng(6)
    n_a, n_b, n_seg = 60000, 5000, 4000
    order, row_ptr = _landing_case(rng, n_a + n_b, n_seg, empty=500)
    a = torch.from_numpy(rng.normal(size=(n_a, pitch))).float().cuda()
    a = a.bfloat16()
    b = torch.from_numpy(rng.normal(size=(n_b, pitch))).float().cuda()
    got = _check_listed(a, order, row_ptr, b, width=d)
    want = ss.segment_sum_csr_plain(a, order, row_ptr, b, width=d)
    assert _rel_err(got, want) <= 1e-5
    assert torch.equal(got[-500:], torch.zeros_like(got[-500:]))
    assert not got[:, d:].any()


# (width, pitch) of every B3 call site at the flagship's shapes: the CSR
# d_op landing (H of hp), the d_x landings (d_in), the v1 backward's d_y_s
# (H rounded up to 8), and the narrowest segment (one lane)
_SITE_WIDTHS = [(8, 8), (64, 64), (128, 128), (144, 192), (224, 224),
                (272, 320), (464, 512), (464, 464)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bf16", "f32", "bf16+f32"])
@pytest.mark.parametrize("d,pitch", _SITE_WIDTHS)
def test_segment_sum_kernel_is_the_listed_sum(d, pitch, dtype):
    """Real-valued rows at each call site's width, width / 8 lanes a
    segment packed across the warps (several segments a warp below 256
    columns, segments straddling warps at 144, 272 and 464) and ragged
    segment lengths (0 to ~40 rows): bitwise the float32 sum in listed
    order."""
    _need_card()
    rng = np.random.default_rng(d + pitch)
    n_a, n_seg = 30000, 1500
    n_b = 3000 if dtype == "bf16+f32" else 0
    order, row_ptr = _landing_case(rng, n_a + n_b, n_seg, empty=100,
                                   keep=0.7)
    a = torch.from_numpy(rng.normal(size=(n_a, pitch))).float().cuda()
    if dtype != "f32":
        a = a.bfloat16()
    b = torch.from_numpy(rng.normal(size=(n_b, pitch))).float().cuda() \
        if n_b else None
    _check_listed(a, order, row_ptr, b, width=d)


@pytest.mark.gpu
@pytest.mark.parametrize("d,pitch", [(64, 64), (224, 224), (464, 512)])
def test_segment_sum_kernel_hub_and_empty_segments(d, pitch):
    """A 1,000-row hub segment among 90 % empty ones (the overflow
    landing's shape, with a longer tail), bf16 rows of `pitch` columns
    summed over `d`: bitwise the listed-order sum; the wrapper refuses a
    width that is not a multiple of 8 or exceeds the pitch."""
    _need_card()
    rng = np.random.default_rng(7)
    n_rows, n_seg = 6000, 14080
    order, row_ptr = _landing_case(rng, n_rows, n_seg,
                                   empty=n_seg * 9 // 10, hub=1000)
    assert int(row_ptr[1] - row_ptr[0]) >= 1000
    a = torch.from_numpy(rng.normal(size=(n_rows, pitch))).float().cuda()
    got = _check_listed(a.bfloat16(), order, row_ptr, width=d)
    assert not got[n_seg // 10:].any()
    for width in (d - 4, pitch + 8):
        with pytest.raises(ValueError, match="multiples of 8"):
            ss.segment_sum_csr(a, order, row_ptr, width=width)


@pytest.mark.gpu
def test_segsum_sites_phase_cuts_build():
    """`benchmarks.segsum_sites --phases` cuts each phase out of a copy of
    the kernel: every copy builds and launches (a cut's sums are not sums),
    and the kernel with no cut gives the listed-order sum through the same
    build."""
    _need_card()
    from radargnn_tpu_torch import build
    from radargnn_tpu_torch.benchmarks import segsum_sites

    with open(build.source_path("csrc", "segment_sum_csr.cu")) as f:
        text = f.read()
    texts = {"whole": text, **segsum_sites.phase_cuts(text)}
    assert list(texts) == ["whole", "no_rows", "no_index", "stores"]
    libs = segsum_sites.build_variants(texts)
    rng = np.random.default_rng(8)
    order, row_ptr = _landing_case(rng, 3000, 400, empty=40)
    a = torch.from_numpy(rng.normal(size=(3000, 144))).float().cuda()
    for name, lib in libs.items():
        with mock.patch.object(ss, "load_kernel", lambda lib=lib: lib):
            got = ss.segment_sum_csr(a.bfloat16(), order, row_ptr)
        torch.cuda.synchronize()
        assert got.shape == (400, 144), name
        if name == "whole":
            assert torch.equal(got, ss.segment_sum_csr_listed(
                a.bfloat16(), order, row_ptr)), name


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


def _w_fwd_args(c):
    """The windowed gather-max's inputs for case `c` on the kernel path:
    the projection, the overflow maxima from it, the layout, the offset."""
    y_s = da.dense_proj(c["x"], c["w_s"])
    inner_o = da.overflow_maxima(
        da.dense_overflow_operand(y_s, c["e_ovf"], c["w_e"], c["ovf_s"]),
        c["ovf_r"], c["offset"].shape[0])
    return (y_s, c["e_t"], c["w_e"], *c["layout"], inner_o, c["offset"])


@pytest.mark.gpu
@pytest.mark.parametrize("run_cap", [None, 4])
@pytest.mark.parametrize("shape", _WSHAPES)
def test_windowed_fwd_kernel_matches_plain(shape, run_cap):
    """Contiguous and spread runs, hubs spanning tiles, serving and VJP
    mode; the empty receivers agree exactly and the routing bits all but
    exactly (real-valued inputs)."""
    _need_card()
    c = _wcase(20, *shape, run_cap=run_cap)
    args = _w_fwd_args(c)
    before = wa.windowed_fwd_cuda.launches
    got = wa.windowed_fwd(*args, **c["kw"])
    got_vjp, inner, bits = wa.windowed_fwd(*args, emit_inner=True,
                                           **c["kw"])
    torch.cuda.synchronize()
    assert wa.windowed_fwd_cuda.launches == before + 2
    want, want_inner, want_bits = wa.windowed_fwd_plain(
        *args, emit_inner=True, **c["kw"])
    assert torch.isfinite(got).all() and torch.equal(got, got_vjp)
    assert _rel_err(got, want) <= RTOL
    assert torch.equal(got == 0, want == 0)
    has = want_inner > da._NEG / 2
    assert torch.equal(inner > da._NEG / 2, has)
    assert _rel_err(inner[has], want_inner[has]) <= RTOL
    flips = smoke._popcount(bits ^ want_bits)
    assert flips <= smoke.BITS_FLIP_FRAC * bits.numel() * 32
    assert smoke._popcount(bits) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("shape", _WSHAPES)
def test_windowed_fwd_landing_matches_plain(shape):
    """B4's gather-max with bf16_max and the bf16 landing against its plain
    version: on real-valued inputs the landing adds at most one bf16 ulp
    of a landed max to the two sums' own difference, on at most
    smoke_variants.BF16_BITS_FLIP_FRAC of the entries, and moves maxima
    off bf16_max alone's; on dyadic
    inputs (the same sums in any order) out, inner and the bits
    bitwise."""
    from radargnn_tpu_torch.smoke_variants import (
        BF16_BITS_FLIP_FRAC, _bf16_ulp,
    )

    _need_card()
    kw = dict(bf16_max=True, bf16_landing=True)
    for dyadic in (False, True):
        c = _wcase(21, *shape)
        if dyadic:
            gen = torch.Generator().manual_seed(22)
            for name, scale in (("x", 1.0), ("w_s", 0.25), ("e_t", 1.0),
                                ("w_e", 0.25), ("e_ovf", 1.0)):
                c[name] = (torch.randint(-4, 5, c[name].shape, generator=gen)
                           * scale / 2).to(c[name])
        args = _w_fwd_args(c)
        before = (wa.windowed_fwd_cuda.launches,
                  wa.windowed_fwd_cuda.landing_launches)
        got = wa.windowed_fwd(*args, **c["kw"], **kw)
        got_vjp, inner, bits = wa.windowed_fwd(*args, emit_inner=True,
                                               **c["kw"], **kw)
        torch.cuda.synchronize()
        assert (wa.windowed_fwd_cuda.launches,
                wa.windowed_fwd_cuda.landing_launches) == (
            before[0] + 2, before[1] + 2)
        want, want_inner, want_bits = wa.windowed_fwd_plain(
            *args, emit_inner=True, **c["kw"], **kw)
        assert torch.isfinite(got).all() and torch.equal(got, got_vjp)
        has = want_inner > da._NEG / 2
        assert torch.equal(inner > da._NEG / 2, has)
        if dyadic:
            assert torch.equal(got, want) and torch.equal(inner, want_inner)
            assert torch.equal(bits, want_bits)
            continue
        _, unlanded, _ = wa.windowed_fwd_plain(
            *args, emit_inner=True, bf16_max=True, **c["kw"])
        _, k_unlanded, _ = wa.windowed_fwd(
            *args, emit_inner=True, bf16_max=True, **c["kw"])
        assert bool((unlanded != want_inner).any())
        d = torch.where(has, (inner - want_inner).abs(), 0.0)
        d_sums = torch.where(has, (k_unlanded - unlanded).abs(), 0.0)
        ulp = _bf16_ulp(torch.where(has, want_inner, 1.0))
        assert bool((d <= ulp + d_sums).all())
        assert int((d > 0).sum()) <= BF16_BITS_FLIP_FRAC * d.numel()
        assert smoke._popcount(bits ^ want_bits) <= \
            BF16_BITS_FLIP_FRAC * bits.numel() * 32


def _w_bwd_inputs(c, seed, dyadic=False):
    """The windowed backward's inputs: the kernel forward's bits and a
    seeded g, zeroed at empty receivers, with the overflow rows routed on
    the forward's operands. With `dyadic` every operand is a multiple of
    1/8 (exact sums in any order): the bits must then equal the plain
    version's."""
    gen = torch.Generator().manual_seed(seed)
    if dyadic:
        for k in ("x", "w_s", "e_t", "w_e", "e_ovf"):
            c[k] = (torch.randint(-4, 5, c[k].shape, generator=gen)
                    * 0.125).to(c[k])
    args = _w_fwd_args(c)
    _, inner, bits = wa.windowed_fwd(*args, emit_inner=True, **c["kw"])
    if dyadic:
        _, want_inner, want_bits = wa.windowed_fwd_plain(
            *args, emit_inner=True, **c["kw"])
        assert torch.equal(inner, want_inner)
        assert torch.equal(bits, want_bits)
    g = torch.randn(inner.shape, generator=gen)
    if dyadic:
        g = (g * 8).round() / 8
    has = inner > da._NEG / 2
    g_pass = torch.where(has, g.cuda(), 0.0)
    op_o = da.dense_overflow_operand(args[0], c["e_ovf"], c["w_e"],
                                     c["ovf_s"])
    mask = c["ovf_r"] >= 0
    recv = torch.where(mask, c["ovf_r"], 0).long()
    d_op_o = torch.where(
        mask[:, None] & da._routes(op_o, torch.where(has, inner, 0.0)[recv]),
        g_pass[recv], 0.0)
    return (bits, g_pass, c["e_t"], c["w_e"], d_op_o, c["layout"][0],
            *c["landing"])


@pytest.mark.gpu
@pytest.mark.parametrize("shape", _WSHAPES[:2] + _WSHAPES[3:])
def test_windowed_bwd_kernel_matches_plain(shape):
    """On dyadic inputs the forward's bits equal the plain version's and
    the backward kernels form the same exact sums: all four outputs agree
    bitwise."""
    _need_card()
    c = _wcase(21, *shape)
    args = _w_bwd_inputs(c, 22, dyadic=True)
    et = dict(edge_tile=c["kw"]["edge_tile"])
    before = wa.windowed_bwd_cuda.launches
    got = wa.windowed_bwd(*args, **et)
    torch.cuda.synchronize()
    assert wa.windowed_bwd_cuda.launches == before + 1
    want = wa.windowed_bwd_plain(*args, **et)
    for name, u, v in zip(("d_e", "dW_e", "d_ys", "d_yo"), got, want):
        assert u.dtype == v.dtype and u.shape == v.shape, name
        assert torch.equal(u, v), name
    assert got[0].abs().max() > 0 and got[2].abs().max() > 0


@pytest.mark.gpu
def test_windowed_backward_is_bitwise_deterministic():
    """Two runs of the windowed backward kernels on the same real-valued
    inputs give the same bits."""
    _need_card()
    c = _wcase(23, 2048, 40000, 256, 512, 224, 16, 464, run_cap=4)
    args = _w_bwd_inputs(c, 24)
    runs = [wa.windowed_bwd(*args, edge_tile=c["kw"]["edge_tile"])
            for _ in range(2)]
    torch.cuda.synchronize()
    for u, v in zip(*runs):
        assert torch.equal(u, v)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["radius", "knn"])
def test_windowed_kernels_on_the_flagship_batches(layout):
    """The smoke's checks of the windowed kernels at the flagship's five
    layer shapes, on the radius batch and on the kNN batch under the
    windowed tiling (run cap 4: spread runs, hubs that span tiles): the
    projection and the gather-max on real-valued inputs (routing bits
    within BITS_FLIP_FRAC), then on dyadic inputs the bits equal and the
    backward exact, and two backward runs bitwise equal."""
    _need_card()
    dev = torch.device("cuda")
    if layout == "radius":
        _, model, loader = smoke.flagship_serving(dev, 2816, 5, 1, 0,
                                                  graph="radius")
        tiling = loader[0].flat_tiling()
    else:
        model = smoke.flagship_serving(dev, 2816, 5, 1, 0)[1]
        tiling = smoke.knn_windowed_tiling(dev, 2816, 5, 0)
    shapes = smoke._layer_shapes(model)
    assert len(shapes) == 5
    with torch.no_grad():
        _, fwd, bwd = smoke.check_routed_kernels(tiling, shapes, 0, 1,
                                                 out=lambda *_: None,
                                                 exact=True)
    assert all(r["bits_flipped"] <= smoke.BITS_FLIP_FRAC * r["bits"]
               for r in fwd)
    assert all(r["max_abs_err"] == 0.0 and r["bitwise_repeat"]
               and r["routed"] > 0 for r in bwd)


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
    fwd = list(_w_fwd_args(c))
    bwd = list(_w_bwd_inputs(c, 27))
    et = dict(edge_tile=c["kw"]["edge_tile"])
    with pytest.raises(ValueError, match="float32"):
        wa.windowed_fwd(fwd[0].bfloat16(), *fwd[1:], **c["kw"])
    with pytest.raises(ValueError, match="bf16"):
        wa.windowed_fwd(fwd[0], fwd[1].float(), *fwd[2:], **c["kw"])
    with pytest.raises(ValueError, match="int32"):
        wa.windowed_bwd(*bwd[:5], bwd[5].long(), *bwd[6:], **et)
    with pytest.raises(ValueError, match="float32"):
        wa.windowed_bwd(bwd[0], bwd[1].bfloat16(), *bwd[2:], **et)
    with pytest.raises(ValueError, match="slots do not match"):
        wa.windowed_fwd(*fwd, node_block=32, edge_tile=64)


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
    """B5's forward (the projection, then the gather-max), serving mode and
    VJP mode given the projection, hubs spanning tiles, against its plain
    version to smoke.CSR_FWD_RTOL (1e-5) of the output's scale: e_t and
    W_e stay float32, so only the summation order differs; the two modes
    give the same out, and the empty receivers agree exactly."""
    _need_card()
    c = _ccase(30, *shape)
    args = (c["x"], c["w_s"], c["e_t"], c["w_e"], *c["layout"], c["offset"])
    before = (ca.csr_fwd_cuda.launches, da.dense_proj_cuda.launches)
    got = ca.csr_fwd(*args, **c["kw"])
    y_s = da.dense_proj(c["x"], c["w_s"])
    got_vjp, inner = ca.csr_fwd(*args, emit_inner=True, y_s=y_s, **c["kw"])
    torch.cuda.synchronize()
    assert (ca.csr_fwd_cuda.launches, da.dense_proj_cuda.launches) == (
        before[0] + 2, before[1] + 2)
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
    got = ca.csr_bwd(*args, landing=c["landing"], **c["kw"])
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
    got = ca.csr_bwd(*args, landing=c["landing"], **c["kw"])
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
        d_xg, d_e, dw_s, dw_e = ca.csr_bwd(*args, landing=c["landing"], **c["kw"])
        d_x = ss.segment_sum_csr(d_xg, order, row_ptr)
        runs.append((d_x, d_e, dw_s, dw_e))
    torch.cuda.synchronize()
    for u, v in zip(*runs):
        assert torch.equal(u, v)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", _CSHAPES)
def test_csr_projection_is_the_forwards_x_part(shape):
    """The backward rebuilds op from the node projection y_s = x @ W_s
    (dense_proj_v4): with a zero edge side the forward's op is its x part
    alone, so the forward kernel's maxima must equal the maxima of
    y_s[sender] over each receiver's slots bit for bit."""
    _need_card()
    c = _ccase(52, *shape)
    senders, recv, blocks = c["layout"]
    e_t, w_e = torch.zeros_like(c["e_t"]), torch.zeros_like(c["w_e"])
    _, inner = ca.csr_fwd(c["x"], c["w_s"], e_t, w_e, *c["layout"],
                          c["offset"], emit_inner=True, **c["kw"])
    n, h = c["offset"].shape
    y_s = da.dense_proj(c["x"], c["w_s"])[:, :h]
    valid = wa.slot_counts(recv, blocks, n, **c["kw"])
    rc = torch.where(valid, recv.long(), 0)
    op = torch.where(valid[:, None], y_s[senders.long().clamp(min=0)],
                     da._NEG)
    want = torch.full((n, h), da._NEG, device="cuda").scatter_reduce_(
        0, rc[:, None].expand_as(op), op, "amax")
    torch.cuda.synchronize()
    assert torch.equal(inner, want)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", _CSHAPES)
def test_csr_bwd_routes_as_the_forward(shape):
    """On real-valued inputs, against the kernel forward's maxima, the
    routing pass marks, on its operand rebuilt from the forward's y_s, the
    slots the plain version's per-slot operand marks, up to flips at the
    tolerance's edge (their operands differ by float32 summation order; at
    most smoke.BITS_FLIP_FRAC of the (slot, column) pairs), and every
    non-empty (receiver, column) routes at least one slot: the forward's
    maximum itself, rebuilt bit for bit."""
    _need_card()
    c = _ccase(53, *shape)
    x, w_s, e_t, w_e = c["x"], c["w_s"], c["e_t"], c["w_e"]
    y_s = da.dense_proj(x, w_s)
    _, inner = ca.csr_fwd(x, w_s, e_t, w_e, *c["layout"], c["offset"],
                          emit_inner=True, y_s=y_s, **c["kw"])
    has = inner > da._NEG / 2
    inner_z = torch.where(has, inner, 0.0)
    d_op = ca._csr_bwd_launch(x, w_s, e_t, w_e, *c["layout"], inner_z,
                              has.float(), c["kw"]["node_block"],
                              c["kw"]["edge_tile"], c["landing"], y_s)[-1]
    n, h = inner.shape
    _, op, rc, valid = ca._slot_operands(x, w_s, e_t, w_e, *c["layout"], n,
                                         **c["kw"])
    want = valid[:, None] & da._routes(op, inner_z[rc])
    torch.cuda.synchronize()
    got = d_op != 0
    assert got.shape == want.shape
    assert int((got != want).sum()) <= smoke.BITS_FLIP_FRAC * got.numel()
    assert not got[~valid].any()
    hits = torch.zeros((n, h), device="cuda").index_add_(0, rc, got.float())
    assert bool((hits[has] >= 1).all())


@pytest.mark.gpu
@pytest.mark.parametrize("shape", _CSHAPES)
def test_csr_bwd_with_the_forwards_projection(shape):
    """The backward given the forward's y_s (as CsrAggregateFn gives it)
    and the backward that projects for itself launch the same kernels on
    the same bits: their four outputs are bitwise equal, and the first
    launches no projection."""
    _need_card()
    c = _ccase(54, *shape)
    args = _c_bwd_inputs(c, 55)
    y_s = da.dense_proj(c["x"], c["w_s"])
    before = da.dense_proj_cuda.launches
    got = ca.csr_bwd(*args, landing=c["landing"], y_s=y_s, **c["kw"])
    assert da.dense_proj_cuda.launches == before
    want = ca.csr_bwd(*args, landing=c["landing"], **c["kw"])
    torch.cuda.synchronize()
    for name, u, v in zip(("d_xg", "d_e", "dW_s", "dW_e"), got, want):
        assert torch.equal(u, v), name


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["knn", "radius"])
def test_csr_kernels_on_the_flagship_batches(layout):
    """The smoke's checks of B5 at the flagship's five layer shapes, on the
    kNN batch and on the radius batch under the CSR tiling (a dense region
    gives a node block several times the mean tiles): the forward in both
    modes to CSR_FWD_RTOL, the backward exact on dyadic inputs and bitwise
    repeatable, d_e and dW_e with a real g to CSR_EDGE_GRAD_RTOL."""
    _need_card()
    dev = torch.device("cuda")
    _, model, loader = smoke.flagship_serving(dev, 2816, 5, 1, 0,
                                              tiling="csr")
    if layout == "knn":
        tiling = loader[0].flat_tiling()
    else:
        tiling = smoke.radius_csr_tiling(dev, 2816, 5, 0).flat_tiling()
    shapes = smoke._layer_shapes(model)
    assert len(shapes) == 5
    quiet = dict(out=lambda *_: None)
    with torch.no_grad():
        fwd = smoke.check_fwd_kernel(tiling, shapes, 0, 1, **quiet)
        bwd, _ = smoke.check_bwd_kernels(tiling, shapes, 0, 1, exact=True,
                                         **quiet)
    assert all(r["max_rel_err"] <= smoke.CSR_FWD_RTOL for r in fwd)
    assert all(r["max_abs_err"] == 0.0 and r["bitwise_repeat"] for r in bwd)


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
    with pytest.raises(ValueError, match="shared memory"):
        ca.csr_fwd(*fwd_args, node_block=1024, edge_tile=32)
    # the wrapper's check holds the kernel's own shared-memory size
    lib = ca.load_fwd_kernel()
    for de, nb in ((8, 32), (16, 256), (24, 885)):
        assert ca.fwd_smem_bytes(de, nb) == lib.csr_fwd_v2_smem_bytes(de, nb)
    y_s = da.dense_proj(args[0], args[1])
    with pytest.raises(ValueError, match="y_s"):
        ca.csr_fwd(*fwd_args, y_s=y_s[:-1], **c["kw"])
    with pytest.raises(ValueError, match="y_s"):
        ca.csr_bwd(*args, landing=c["landing"], y_s=y_s.bfloat16(),
                   **c["kw"])
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
    (14080, 224, 464, True),
    (4096, 256, 512, False),
    (333, 37, 71, False),
    (129, 5, 3, True),            # depth and width under one 8-deep step
    (4097, 224, 130, False),      # one row and two columns past a tile
])
def test_fused_linear_kernel_matches_plain(shape):
    """B9 against its plain version to smoke.F32_RTOL of the output's
    scale: float32 accuracy on both sides (3xTF32 on the tensor cores in
    the kernel, float32 products in cuBLAS)."""
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


@pytest.mark.gpu
@pytest.mark.parametrize("scales", [(1e-30, 1e30), (1e30, 1e-30),
                                    (1e-36, 1e36), (1e18, 1e-18)])
def test_fused_linear_kernel_at_extreme_scales(scales):
    """B9's TF32 split over float32's exponent range: x and W at scales
    whose products are O(1), the rest of a tiny x (1e-36) below the normal
    range, against the plain version to smoke.F32_RTOL of the output's
    scale."""
    _need_card()
    sx, sw = scales
    rng = np.random.default_rng(41)
    x = _cuda(rng.normal(size=(1000, 224)) * sx)
    w = _cuda(rng.normal(size=(224, 464)) * 224 ** -0.5 * sw)
    b = _cuda(rng.normal(size=(464,)))
    got = fl.fused_linear(x, w, b)
    want = fl.fused_linear_plain(x, w, b)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert _rel_err(got, want) <= smoke.F32_RTOL


def _bits(*tensors) -> str:
    """A digest of the tensors' bits."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _csr_fwd_bits() -> str:
    """B5's forward given y_s, in VJP mode (out and inner), on fixed seeded
    inputs at the small-tile shape and the flagship's widest: y_s drawn
    directly (zero past H), so no other kernel feeds it."""
    outs = []
    for seed, shape in ((60, _CSHAPES[0]), (61, _CSHAPES[1])):
        c = _ccase(seed, *shape)
        n, h = c["offset"].shape
        rng = np.random.default_rng(seed + 100)
        y_s = np.zeros((c["x"].shape[0], da.col_pad(h)))
        y_s[:, :h] = rng.normal(size=(c["x"].shape[0], h))
        outs += ca.csr_fwd(c["x"], c["w_s"], c["e_t"], c["w_e"],
                           *c["layout"], c["offset"], emit_inner=True,
                           y_s=_cuda(y_s), **c["kw"])
    torch.cuda.synchronize()
    return _bits(*outs)


def _segmax_bits() -> str:
    """B8's output on fixed seeded inputs: odd widths and the flagship's."""
    outs = []
    for seed, shape in ((62, (6000, 1000, 37, 71, 128, 128)),
                        (63, (40000, 2048, 464, 464, 128, 256))):
        args, kw = _segmax_inputs(seed, *shape)
        outs.append(msm.msg_segmax(*args, **kw))
    torch.cuda.synchronize()
    return _bits(*outs)


# the digests of _csr_fwd_bits and _segmax_bits from the kernels before
# the CSR forward's walk moved into csrc/csr_walk.cuh and the segment-max's
# TF32 products into csrc/tf32x3.cuh (the parent tree's kernels, on an
# NVIDIA H100 80GB HBM3)
CSR_FWD_BITS = "d49732e07da603a7"
SEGMAX_BITS = "b36938123656a277"


@pytest.mark.gpu
def test_csr_fwd_bits_are_the_parents():
    """B5's forward on the shared walk gives the bits the kernel gave
    before the walk was shared, on fixed inputs."""
    _need_card()
    assert _csr_fwd_bits() == CSR_FWD_BITS


@pytest.mark.gpu
def test_segmax_bits_are_the_parents():
    """B8 gives the bits it gave before its TF32 products moved into the
    shared header, on fixed inputs."""
    _need_card()
    assert _segmax_bits() == SEGMAX_BITS


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


@functools.lru_cache(maxsize=1)
def _knn_v1():
    """The smoke's kNN batch (5 x 2816 points, seed 0) under the v1 tiles:
    the layout the message segment-max is held on."""
    _, _, loader = smoke.flagship_serving(torch.device("cuda"), 2816, 5, 1,
                                          0)
    return smoke.v1_tiling(loader[0])


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["random", "wide range"])
def test_msg_segmax_on_the_knn_batch(case):
    """B8 at 464 -> 464 on the kNN batch under the v1 tiles, on seeded
    messages and on wide-range ones (smoke.segmax_wide_range), against its
    plain version to smoke.F32_RTOL of the output's scale; two runs give
    the same bits."""
    _need_card()
    v1 = _knn_v1()
    rng = np.random.default_rng(54)
    e_pad = v1.recv.shape[0]
    if case == "random":
        m_in = rng.normal(size=(e_pad, 464))
        w = rng.normal(size=(464, 464)) * 464 ** -0.5
        b = rng.normal(size=464)
    else:
        m_in, w, b = smoke.segmax_wide_range(rng, e_pad, 464, 464)
    args = (_cuda(m_in), _cuda(w), _cuda(b), v1.recv, v1.blocks)
    kw = dict(num_nodes=v1.num_nodes, node_block=v1.node_block,
              edge_tile=v1.edge_tile)
    got = msm.msg_segmax(*args, **kw)
    again = msm.msg_segmax(*args, **kw)
    want = msm.msg_segmax_plain(*args, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all() and torch.equal(got, again)
    assert _rel_err(got, want) <= smoke.F32_RTOL
    assert torch.equal(got == 0, want == 0)


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


@pytest.mark.gpu
def test_hoisted_fwd_kernel_skips_senders_outside_y_s():
    """A slot whose sender is no row of y_s does not count (v1's slot
    rule, which the plain version and the backward share): with a tenth
    of the valid slots' senders set to -1 or n_y, the kernel still agrees
    with its plain version, empty receivers included."""
    _need_card()
    ops, layout, offset, kw = _v1_inputs(55, 2816, 56320, 16, 144)
    n = ops[0].shape[0]
    senders = layout[0].clone()
    rng = np.random.default_rng(56)
    bad = torch.from_numpy(rng.random(senders.shape[0]) < 0.1).cuda()
    senders[bad] = torch.where(
        torch.from_numpy(rng.random(senders.shape[0]) < 0.5).cuda()[bad],
        -1, n).to(torch.int32)
    layout = (senders,) + layout[1:]
    got, inner = ha.hoisted_fwd(*ops, *layout, offset, emit_inner=True, **kw)
    want, want_inner = ha.hoisted_fwd_plain(*ops, *layout, offset,
                                            emit_inner=True, **kw)
    torch.cuda.synchronize()
    has = want_inner > da._NEG / 2
    assert torch.equal(inner > da._NEG / 2, has)
    assert _rel_err(got, want) <= smoke.F32_RTOL


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
def test_v1_kernels_on_the_flagship_batch():
    """The smoke's checks of the v1 pair at the flagship's five layer
    shapes on the kNN batch under the v1 tiles: B6 to F32_RTOL in both
    modes; B7 exact on dyadic inputs, bitwise repeatable, and within
    F32_RTOL of each output's scale with a real-valued g."""
    _need_card()
    dev = torch.device("cuda")
    _, model, loader = smoke.flagship_serving(dev, 2816, 5, 1, 0)
    shapes = smoke._layer_shapes(model)
    assert len(shapes) == 5
    with torch.no_grad():
        fwd, bwd = smoke.check_v1_kernels(smoke.v1_tiling(loader[0]),
                                          shapes, 0, 1, out=lambda *_: None)
    assert all(r["max_rel_err"] <= smoke.F32_RTOL for r in fwd)
    assert all(r["max_abs_err"] == 0.0 and r["bitwise_repeat"]
               and max(r["real_g_rel_err"].values()) <= smoke.F32_RTOL
               for r in bwd)


# the flagship DetNet's five conv layers: (d_in, d_e, H)
_FLAGSHIP_LAYERS = [(224, 16, 464)] * 3 + [(128, 16, 272), (64, 16, 144)]


@pytest.mark.gpu
@pytest.mark.parametrize("layer", range(5))
def test_v1_pair_on_the_flagship_shapes(layer):
    """At each of the flagship's five layer shapes on the kNN batch under
    the v1 tiles, real-valued inputs: B6 in serving and VJP mode against
    its plain version to smoke.F32_RTOL of the output's scale (the same
    output in both modes, the same empty receivers); then B7 on B6's maxima
    with g = 1 at every non-empty receiver routes at least one slot of
    every non-empty (receiver, column), the forward's maximum rebuilt bit
    for bit, and no slot that does not count."""
    _need_card()
    v1 = _knn_v1()
    d, de, h = _FLAGSHIP_LAYERS[layer]
    rng = np.random.default_rng(70 + layer)
    n, e_pad = v1.num_nodes, v1.recv.shape[0]
    x, w_s = rng.normal(size=(n, d)), rng.normal(size=(d, h)) * d ** -0.5
    ops = (_cuda(x @ w_s), _cuda(rng.normal(size=(e_pad, de))),
           _cuda(rng.normal(size=(de, h)) * de ** -0.5),
           _cuda(rng.normal(size=h)))
    layout = (v1.senders, v1.recv, v1.blocks)
    kw = dict(node_block=v1.node_block, edge_tile=v1.edge_tile)
    offset = _cuda(rng.normal(size=(n, h)))
    got = ha.hoisted_fwd(*ops, *layout, offset, **kw)
    got_vjp, inner = ha.hoisted_fwd(*ops, *layout, offset, emit_inner=True,
                                    **kw)
    want, want_inner = ha.hoisted_fwd_plain(*ops, *layout, offset,
                                            emit_inner=True, **kw)
    has = inner > da._NEG / 2
    d_op = ha.hoisted_bwd(*ops, *layout, torch.where(has, inner, 0.0),
                          has.float(), **kw)[0]
    torch.cuda.synchronize()
    assert torch.equal(got, got_vjp) and torch.isfinite(got).all()
    assert _rel_err(got, want) <= smoke.F32_RTOL
    assert torch.equal(has, want_inner > da._NEG / 2)
    assert _rel_err(inner[has], want_inner[has]) <= smoke.F32_RTOL
    _, rc, valid = ha._slot_operands(*ops, *layout, n, **kw)
    routed = d_op != 0
    assert not routed[~valid].any()
    hits = torch.zeros((n, h), device="cuda").index_add_(
        0, rc, routed.float())
    assert bool((hits[has] >= 1).all())


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
    # the wrapper's check holds the forward's own shared-memory size
    lib = ha.load_fwd_kernel()
    for de, nb in ((4, 32), (16, 128), (16, 256)):
        assert ha.fwd_smem_bytes(de, nb) == \
            lib.hoisted_fwd_v1_smem_bytes(de, nb)
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
    three requests launches its forward (on all three paths the projection
    too), and every conv layer of each of the two train steps launches the
    path's kernels (the projection on all three paths, once a layer: the
    CSR backward reuses the forward's; B3 on the CSR path). Two steps keep it
    short; each is held to the plain path at its own parameters, with the
    smoke's limits. The CLI phases' train and evaluate (under the flagship
    and the nuScenes YAML) launch the dense path's kernels too, and the
    kernels line counts them."""
    _need_card()
    summary = smoke.run("cuda", points=512, graphs=2, batches=3, reps=2,
                        train_steps=2, bench=(45_056, 2_253, 464, 464))
    # the CLI's train (2 epochs of 6 train and 2 validate batches) and
    # evaluate (2 batches) on the dense path, in KERNEL_NAMES' order
    cli = [a + b for a, b in zip(summary["cli"]["train_launches"],
                                 summary["cli"]["evaluate_launches"])]
    assert cli == [5 * 2 * 8 + 5 * 2, 5 * 2 * 6] + [0] * 9 + [5 * 2 * 8
                                                              + 5 * 2, 0, 0,
                                                              0]
    # the nuScenes CLI's train (2 epochs of 2 train and 1 validate batches)
    # and evaluate (2 batches), which the kernels line adds in too
    nus = [a + b for a, b in zip(summary["nuscenes"]["train_launches"],
                                 summary["nuscenes"]["evaluate_launches"])]
    assert nus == [5 * 2 * 3 + 5 * 2, 5 * 2 * 2] + [0] * 9 + [5 * 2 * 3
                                                              + 5 * 2, 0, 0,
                                                              0]
    cli = [a + b for a, b in zip(cli, nus)]
    # B1 and B2 held on the nuScenes train CLI's first batch of 32 frames
    checked = summary["nuscenes"]
    assert len(checked["train_tiling"]["valid_edges"]) == 32
    assert [r["d_in"] for r in checked["per_shape_bwd"]] == [224, 224, 224,
                                                              128, 64]
    assert all(r["ms"] > 0 and r["plain_ms"] > 0
               for r in checked["per_shape"] + checked["per_shape_bwd"])
    # the fourth phase's kernels: kernel_check's linear, segment-max (and
    # kernel_bench's check, warm-up and 2 timed calls), the forward through
    # both v1 factories and the kernel backward
    # the ninth phase: B1's and B4's bf16 test in the fused_bf16_max
    # trainings (two steps), B3 on the overflow rows in the ovf_ssum one,
    # B4's landing in the variant knobs' training, B1 and B2 in the
    # training at r_tile 8 (two steps each)
    assert [k["launches"] for k in summary["kernels"]] == \
        [3 * 5 * 2 + cli[11], 5 * 2 + cli[0], 5 * 2 + cli[1], 2 * 5 * 2,
         5 * 2, 5 * 2, 5 * 2, 5 * 2, 1, 1 + 3 + 1, 2, 1, 5 * 2, 5 * 2,
         5 * 2, 5 * 2, 5 * 2, 5 * 2]
    assert summary["serve_launches"] == [5 * 3] + [0] * 10 + [5 * 3, 0, 0,
                                                              0]
    assert summary["radius"]["serve_launches"] == \
        [0, 0, 0, 5 * 3] + [0] * 7 + [5 * 3, 0, 0, 0]
    assert summary["csr"]["serve_launches"] == \
        [0] * 5 + [5 * 3] + [0] * 5 + [5 * 3, 0, 0, 0]
    for kernel in summary["kernels"]:
        assert kernel["ms"] > 0 and kernel["plain_ms"] > 0
    assert summary["kernels"][0]["library_ms"] > 0
    assert summary["kernels"][3]["library_ms"] > 0


# -- the evaluation stage on the card (postprocess.nms, postprocess.mean_ap)

def _eval_boxes(rng, n, rotated):
    if rotated:
        return np.stack([rng.uniform(-8, 8, n), rng.uniform(-8, 8, n),
                         rng.uniform(0.5, 4, n), rng.uniform(0.5, 3, n),
                         rng.uniform(0, 180, n)], 1).astype(np.float32)
    lo = rng.uniform(-8, 8, (n, 2))
    return np.concatenate([lo, lo + rng.uniform(0.5, 4, (n, 2))],
                          1).astype(np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("rotated", [False, True])
def test_iou_and_nms_on_the_card_match_the_cpu(rotated):
    """The IoU matrix (float32 on both, within smoke.EVAL_IOU_ATOL) and the
    kept indices of `nms_indices` on the card against the CPU, on seeded
    boxes at the oracle load (800 boxes, 640,000 pairs); the kept indices
    are compared where no IoU lies within 1e-4 of the threshold."""
    _need_card()
    from radargnn_tpu_torch.postprocess import nms

    rng = np.random.default_rng(0)
    boxes = _eval_boxes(rng, 800, rotated)
    scores = rng.random(800).astype(np.float32)
    f = nms.rotated_iou_matrix if rotated else nms.aligned_iou_matrix
    t = torch.from_numpy(boxes)
    cpu = f(t, t)
    card = f(t.cuda(), t.cuda()).cpu()
    assert float((card - cpu).abs().max()) <= smoke.EVAL_IOU_ATOL
    for thr in (0.01, 0.3):
        if float((cpu - thr).abs().min()) < 1e-4:
            continue
        got = nms.nms_indices(boxes, scores, thr, rotated, device="cuda")
        want = nms.nms_indices(boxes, scores, thr, rotated, device="cpu")
        assert got.tolist() == want.tolist() and 1 < len(got) < 800


@pytest.mark.gpu
@pytest.mark.parametrize("rotated", [False, True])
def test_mean_ap_on_the_card_matches_the_cpu(rotated):
    """The mAP engine in box-IoU mode, its batched IoU on the card against
    the CPU: the same numbers within smoke.EVAL_METRIC_ATOL."""
    _need_card()
    from radargnn_tpu_torch.postprocess import MeanAveragePrecision

    rng = np.random.default_rng(1)
    preds, target = [], []
    for _ in range(12):
        gt = _eval_boxes(rng, int(rng.integers(1, 30)), rotated)
        det = np.concatenate([gt + rng.normal(scale=0.2, size=gt.shape),
                              _eval_boxes(rng, 10, rotated)])
        if not rotated:
            det[:, 2:] = np.maximum(det[:, 2:], det[:, :2] + 0.1)
        preds.append({"boxes": det, "scores": rng.random(len(det)),
                      "labels": rng.integers(0, 3, len(det))})
        target.append({"boxes": gt, "labels": rng.integers(0, 3, len(gt))})
    res = {}
    for dev in ("cuda", "cpu"):
        m = MeanAveragePrecision([0.3, 0.5, 0.75], device=dev)
        m.update(preds, target, is_aligned=not rotated)
        res[dev] = m.compute()
    assert 0.0 < res["cpu"]["map"] < 1.0
    for key, want in res["cpu"].items():
        np.testing.assert_allclose(np.asarray(res["cuda"][key], float),
                                   np.asarray(want, float), rtol=0,
                                   atol=smoke.EVAL_METRIC_ATOL, err_msg=key)


@pytest.mark.gpu
@pytest.mark.parametrize("tiling", [None, "dense"])
def test_loader_batches_on_the_card_are_the_cpus(tmp_path, tiling):
    """The loader's batches on the card (the default device) hold the same
    arrays as on the CPU, over two shuffled epochs, the padded last batch
    included."""
    _need_card()
    from radargnn_tpu_torch.data import loader
    from radargnn_tpu_torch.data.synthetic import make_samples
    from radargnn_tpu_torch.models.layers import fused_csr_tiling

    arch, graph_cfg, _, _ = smoke.flagship_configs("knn")
    spec = fused_csr_tiling(arch, k=graph_cfg.k) if tiling else None
    for split, n in (("train", 7), ("validate", 3)):
        (tmp_path / split).mkdir()
        for i, sample in enumerate(make_samples(n, 300, seed=len(split))):
            sample.save_npz(str(tmp_path / split / f"graph_{i}.npz"))
    kw = dict(batch_size=3, shuffle=True, seed=5, csr_tiling=spec)
    card, _ = loader.get_data_loaders(["train", "validate"], str(tmp_path),
                                      **kw)
    cpu, _ = loader.get_data_loaders(["train", "validate"], str(tmp_path),
                                     device="cpu", **kw)
    for split in ("train", "validate"):
        for _ in range(2):
            for a, b in zip(card[split], cpu[split], strict=True):
                assert a.device.type == "cuda"
                for name, t in a.tensors().items():
                    # exact, NaN (a background node's box) equal to NaN
                    torch.testing.assert_close(t.cpu(), getattr(b, name),
                                               rtol=0, atol=0,
                                               equal_nan=True, msg=name)
                assert a.tile_geometry == b.tile_geometry


@pytest.mark.gpu
@pytest.mark.parametrize("algorithm", ["knn", "radius"])
def test_online_graph_on_the_card_matches_the_host(algorithm):
    """The device graph builder on the card: per receiver the host
    pipeline's edges, and its edge and node features within float32
    rounding (1e-6), at a flagship-size frame."""
    _need_card()
    from radargnn_tpu_torch.configs import GraphConstructionConfiguration
    from radargnn_tpu_torch.data.synthetic import synthetic_frame
    from radargnn_tpu_torch.graph import online
    from radargnn_tpu_torch.graph.build import build_geometric_graph

    config = GraphConstructionConfiguration(
        algorithm, {"k": 20, "r": 3.0},
        ["rcs", "velocity_vector", "time_index", "degree"],
        ["relative_position", "point_pair_features"], "directed", "X")
    rng = np.random.default_rng(7)
    n, pad = 2816, 2880
    frames = [synthetic_frame(rng, n) for _ in range(2)]

    def stacked(i, width):
        out = np.zeros((2, pad, width), np.float32)
        for g, f in enumerate(frames):
            out[g, :n] = np.asarray(f[i], np.float32).reshape(n, width)
        return torch.from_numpy(out).cuda()

    pos, vel = stacked(0, 2), stacked(1, 2)
    rcs, ts = stacked(2, 1)[..., 0], stacked(3, 1)[..., 0]
    valid = (torch.arange(pad) < n).expand(2, pad).cuda()
    # more than any point's neighbors within 3 m (a synthetic object holds
    # ~70 points), so the radius graph is not cut
    batch = online.build_graph_batch_on_device(config, pos, vel, rcs, ts,
                                               valid, max_degree=256)
    assert batch.node_feat.device.type == "cuda"
    for g in range(2):
        host = build_geometric_graph(
            config, pos[g, :n].double().cpu().numpy(),
            vel[g, :n].double().cpu().numpy(),
            rcs=rcs[g, :n].cpu().numpy(), timestamps=ts[g, :n].cpu().numpy())
        m = batch.edge_mask[g].cpu().numpy()
        if algorithm == "radius":
            assert m.reshape(pad, -1).sum(1).max() < 256
        s = batch.senders[g].cpu().numpy()[m]
        r = batch.receivers[g].cpu().numpy()[m]
        feat = batch.edge_feat[g].cpu().numpy()[m]
        dev = dict(zip(zip(s.tolist(), r.tolist()), feat))
        host_edges = list(map(tuple, host.edges.tolist()))
        assert set(dev) == set(host_edges)
        got = np.stack([dev[e] for e in host_edges])
        np.testing.assert_allclose(got, host.edge_feat, rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(batch.node_feat[g, :n].cpu().numpy(),
                                   host.node_feat, rtol=1e-6, atol=1e-6)


@pytest.mark.gpu
def test_nuscenes_e2e_on_the_card(tmp_path):
    """`benchmarks.nuscenes_e2e` on the card (its default device), in a
    process of its own as a user runs it: training launches B1 (the
    projection and the gather-max) and B2 on every conv layer of every
    batch, evaluation B1, nothing else launches; losses and metrics are
    finite."""
    _need_card()
    import os
    import subprocess
    import sys

    code = (
        "import json, sys\n"
        "from radargnn_tpu_torch import smoke\n"
        "from radargnn_tpu_torch.benchmarks import nuscenes_e2e\n"
        "res = nuscenes_e2e.run(None, sys.argv[1])\n"
        "print(json.dumps({'launches': [c.launches for c in "
        "smoke._counters()], 'loss': res['train_loss'], "
        "'metrics': res['metrics'], 'device': res['device']}))\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                          cwd=repo, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["device"] == "cuda"
    processed = tmp_path / "nuscenes" / "processed"
    n_train = len(os.listdir(processed / "train"))
    n_val = len(os.listdir(processed / "validate"))
    epochs, batch, layers = 4, 2, 2
    steps = epochs * -(-n_train // batch)
    forwards = steps + epochs * -(-n_val // batch) + -(-n_val // batch)
    want = dict.fromkeys(smoke.KERNEL_NAMES, 0)
    want.update(dense_proj_v4=layers * forwards,
                dense_fwd_v4=layers * forwards,
                dense_bwd_v4=layers * steps)
    assert dict(zip(smoke.KERNEL_NAMES, out["launches"])) == want
    assert len(out["loss"]) == epochs and np.isfinite(out["loss"]).all()
    assert 0.0 <= out["metrics"]["mean_ap"] <= 1.0
    assert 0.0 <= out["metrics"]["nd_score"] <= 1.0


# -- the bf16 routing test of B1 and B4, B3 under ovf_ssum (ninth phase) -----

@pytest.mark.gpu
def test_bf16_bits_on_the_flagship_batches():
    """B1's and B4's gather-max with the bf16 test against their plain
    versions at the five flagship shapes, on the kNN batch (dense) and the
    radius batch (windowed): real-valued inputs within the smoke's limits,
    and bits equal on inputs with bf16 ties (`check_bf16_bits` raises
    otherwise)."""
    _need_card()
    from radargnn_tpu_torch import smoke_variants as sv
    _, model, loader = smoke.flagship_serving("cuda", 2816, 5, 1, 0)
    _, _, r_loader = smoke.flagship_serving("cuda", 2816, 5, 1, 0,
                                            graph="radius")
    shapes = smoke._layer_shapes(model)
    with torch.no_grad():
        rows = sv.check_bf16_bits(loader[0].flat_tiling(), shapes, 0, 2,
                                  "kNN, dense")
        rows += sv.check_bf16_bits(r_loader[0].flat_tiling(), shapes, 0, 2,
                                   "radius, windowed")
    assert len(rows) == 10 and all(r["ties_bits_equal"] for r in rows)
    assert all(r["ms"] > 0 and r["strict_ms"] > 0 for r in rows)


@pytest.mark.gpu
def test_ovf_ssum_lands_the_overflow_through_b3_on_the_card():
    """B3 on the kNN batch's overflow landing (exact on dyadic rows), and
    one train step's gradients under ovf_ssum against the default landing's
    (float32 summation order and bf16 rounding of the per-row d_xo apart:
    cosine 0.9999 or more), with B3 launched once a layer."""
    _need_card()
    from radargnn_tpu_torch.models import layers
    from radargnn_tpu_torch import smoke_variants as sv
    with mock.patch.object(layers, "OVF_SSUM", True):
        arch, model, loader = smoke.flagship_serving("cuda", 2816, 5, 1, 0)
        batch = loader[0]
        shapes = smoke._layer_shapes(model)
        with torch.no_grad():
            sv.check_ovf_landing(batch.flat_tiling(), shapes, 0, 2)

        def grads(ssum):
            with mock.patch.object(layers, "OVF_SSUM", ssum):
                m = smoke.DetNet(arch, device="cuda", seed=0)
                cls, bb = m.forward_batch(batch)
                (cls.square().sum() + bb.square().sum()).backward()
                return torch.cat([p.grad.flatten() for p in m.parameters()])

        launches = ss.segment_sum_csr_cuda.launches
        got = grads(True)
        assert ss.segment_sum_csr_cuda.launches == launches + len(shapes)
        base = grads(False)
    cos = torch.nn.functional.cosine_similarity(got.double(), base.double(),
                                                dim=0)
    assert float(cos) >= 0.9999


@pytest.mark.gpu
def test_halo_dense_aggregate_on_two_gloo_ranks_of_one_card():
    """The conv-0-shaped aggregate (224 -> 464 over 16 edge features)
    through halo x dense on 2 gloo ranks that share the card ({"model": 2},
    2 x 1024-point kNN frames): the ranks' rows, back in node order, within
    smoke_parallel.AGG_RTOL of the single card's dense aggregation on the
    same inputs, and each rank launched B1's projection and gather-max
    once."""
    _need_card()
    from radargnn_tpu_torch import smoke_parallel as sp
    report = sp.aggregate_check("cuda", "knn", {"model": 2}, "gloo",
                                ["cuda:0"], 1024, 2, 0)
    assert report["agg_max_abs_err"] <= sp.AGG_RTOL * report["agg_scale"]
    for launches in report["agg_launches"]:
        assert {k: v for k, v in launches.items() if v} == {
            "dense_proj_v4": 1, "dense_fwd_v4": 1}
