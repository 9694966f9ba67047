"""B3, the landing (radargnn_tpu_torch.ops.segment_sum): its plain version
against the float32 sum in listed order and against the JAX package's
`pallas_segment_sum_csr` (interpret mode), the width argument (the columns
summed apart from the rows' pitch), the CSR backward's landings with it,
and `benchmarks.segsum_sites`' CPU side.

On the CPU `index_add_` adds in the order listed, so the plain version
and `segment_sum_csr_listed` (the card's bitwise yardstick) agree bit for
bit. The JAX kernel lands a segment-sorted tile by a one-hot matmul, in
another order: bf16 rows, whose float32 sums here are nearly exact, within
1e-6 of the output's scale; float32 rows within the bound of two
summation orders, 2 (L - 1) 2^-24 sum |row| an element for a segment of
L rows (1e-6 of the scale is exceeded by the order alone: 1.2e-6 on the
~1,000-row segment). The CUDA kernel runs only on the card
(tests/test_torch_gpu.py)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radargnn_tpu.ops import pallas_kernels as jpk
from radargnn_tpu_torch.ops import csr_aggregate as ca
from radargnn_tpu_torch.ops import dense_aggregate as da
from radargnn_tpu_torch.ops import segment_sum as ss
from radargnn_tpu_torch.ops import windowed_tiles as wt

from torch_threads import few_threads  # noqa: F401

PITCH = 512
JAX_RTOL = 1e-6
_CSRC = os.path.join(os.path.dirname(ss.__file__), os.pardir, "csrc")


def _case(seed: int, width: int, two_sources: bool, bf16: bool):
    """Real-valued rows of PITCH columns (bf16 or float32 in `a`, float32
    in `b`), a third of the segments empty, one of ~1,000 rows, the rest
    ragged; the rows past the landing's list are skipped. Returns (a, b,
    order, row_ptr, seg) with seg the segment of every row (-1 skipped)."""
    rng = np.random.default_rng(seed)
    n_a, n_b, n_seg = 2400, 600 if two_sources else 0, 96
    n = n_a + n_b
    seg = rng.integers(0, n_seg, n)
    seg[rng.random(n) < 0.1] = -1
    seg[np.isin(seg, np.arange(0, n_seg, 3))] = 5       # empty and a hub
    seg[rng.choice(np.flatnonzero(seg != 5), 1000 - int((seg == 5).sum()),
                   replace=False)] = 5
    rows = np.flatnonzero(seg >= 0)
    order = rows[np.argsort(seg[rows], kind="stable")].astype(np.int32)
    row_ptr = np.concatenate(
        [[0], np.cumsum(np.bincount(seg[rows], minlength=n_seg))])
    a = torch.from_numpy(rng.normal(size=(n_a, PITCH)).astype(np.float32))
    if bf16:
        a = a.bfloat16()
    b = torch.from_numpy(rng.normal(size=(n_b, PITCH)).astype(np.float32)) \
        if two_sources else None
    return (a, b, torch.from_numpy(order),
            torch.from_numpy(row_ptr.astype(np.int32)), seg)


@pytest.mark.parametrize("bf16,two_sources",
                         [(True, True), (True, False), (False, False)])
@pytest.mark.parametrize("width", [8, 64, 144, 224, 464])
def test_listed_sum_is_the_plain_version_and_jaxs(width, bf16, two_sources):
    """The listed-order float32 sum equals the plain version bitwise and
    the JAX package's `pallas_segment_sum_csr` (interpret mode, the same
    rows pre-permuted into its segment-sorted tiles) within JAX_RTOL of
    its scale, at each call site's width in a 512-wide buffer: empty
    segments 0, the ~1,000-row segment summed, the columns past the width
    0."""
    a, b, order, row_ptr, seg = _case(width, width, two_sources, bf16)
    listed = ss.segment_sum_csr_listed(a, order, row_ptr, b, width=width)
    plain = ss.segment_sum_csr_plain(a, order, row_ptr, b, width=width)
    assert listed.shape == (row_ptr.numel() - 1, PITCH)
    assert torch.equal(listed, plain)
    assert not listed[:, width:].any()
    counts = np.diff(row_ptr.numpy())
    assert counts.max() >= 1000 and (counts == 0).sum() >= 30
    assert not listed[torch.from_numpy(counts == 0)].any()
    rows = a[:, :width].float() if b is None else torch.cat(
        [a[:, :width].float(), b[:, :width]])
    n_seg, node_block, edge_tile = row_ptr.numel() - 1, 32, 128
    perm, tile_blocks, padded_seg = jpk.prepare_csr_tiles(
        seg.astype(np.int32), seg >= 0, n_seg, node_block, edge_tile)
    want = np.asarray(jpk.pallas_segment_sum_csr(
        jnp.asarray(rows.numpy()[perm]), jnp.asarray(padded_seg),
        jnp.asarray(tile_blocks), num_nodes=n_seg, node_block=node_block,
        edge_tile=edge_tile, interpret=True))
    err = np.abs(listed[:, :width].numpy() - want)
    if bf16 and not two_sources:
        assert err.max() <= JAX_RTOL * np.abs(want).max()
    else:
        # float32 rows: within what two summation orders of a segment's L
        # rows may differ by, 2 (L - 1) 2^-24 sum |row| an element
        abs_sum = ss.segment_sum_csr_listed(a.abs(), order, row_ptr,
                                            None if b is None else b.abs(),
                                            width=width)[:, :width]
        steps = torch.from_numpy(np.maximum(counts - 1, 0))[:, None]
        assert (torch.from_numpy(err) <= 2 * steps * 2.0 ** -24
                * abs_sum).all()


@pytest.mark.parametrize("width,pitch", [(8, 64), (144, 192), (464, 512)])
def test_width_sums_exactly_the_first_columns(width, pitch):
    """With `width` the landing sums the rows' first `width` columns
    whatever lies past them (here nonzero), bit for bit the sums of the
    rows cut to `width`, and writes 0 past them, in the plain version
    (the CPU wrapper) and the listed-order sum."""
    rng = np.random.default_rng(pitch)
    a = torch.from_numpy(rng.normal(size=(500, pitch)).astype(np.float32))
    order = torch.from_numpy(rng.permutation(500)[:400].astype(np.int32))
    row_ptr = torch.from_numpy(np.concatenate(
        [[0], np.sort(rng.integers(0, 400, 39)), [400]]).astype(np.int32))
    cut = ss.segment_sum_csr(a[:, :width].contiguous(), order, row_ptr)
    for fn in (ss.segment_sum_csr, ss.segment_sum_csr_listed):
        got = fn(a, order, row_ptr, width=width)
        assert got.shape == (40, pitch)
        assert torch.equal(got[:, :width], cut)
        assert not got[:, width:].any()
    assert torch.equal(ss.segment_sum_csr(a, order, row_ptr, width=pitch),
                       ss.segment_sum_csr(a, order, row_ptr))


def _csr_case(seed: int, h: int):
    """A small CSR case (96 nodes, 500 edges, 10 % masked, 32-node blocks,
    32-slot tiles, d_in 24, d_e 8) and its sender landing, as
    tests/test_torch_csr.py sets it up; returns the padded operands, the
    layout, the landing and the forward's g and maxima."""
    rng = np.random.default_rng(seed)
    n, e, d_in, de, nb, et = 96, 500, 24, 8, 32, 32
    send = rng.integers(0, n, e).astype(np.int32)
    recv = rng.integers(0, n, e).astype(np.int32)
    mask = rng.random(e) < 0.9
    perm, blocks, precv = wt.prepare_csr_tiles(recv, mask, n, nb, et)
    senders = send[perm]
    s_perm, _, s_send = wt.prepare_csr_tiles(senders, precv >= 0, n, nb, et)
    landing = ss.SenderLanding(*map(torch.from_numpy, ss.csr_landing(
        s_perm, s_send, n)))
    t = torch.from_numpy
    ops = ca.csr_operands(
        t(rng.normal(size=(n, d_in)).astype(np.float32)),
        t((rng.normal(size=(d_in, h)) * 0.3).astype(np.float32)),
        t(rng.normal(size=(e, de)).astype(np.float32)[perm]),
        t((rng.normal(size=(de, h)) * 0.3).astype(np.float32)))
    layout = (t(senders), t(precv), t(blocks))
    kw = dict(node_block=nb, edge_tile=et)
    _, inner = ca.csr_fwd_plain(*ops, *layout, torch.zeros((n, h)),
                                emit_inner=True, **kw)
    has = inner > da._NEG / 2
    g_pass = torch.where(has, t(rng.normal(size=(n, h)).astype(np.float32)),
                         0.0)
    return ops, layout, landing, kw, torch.where(has, inner, 0.0), g_pass


@pytest.mark.parametrize("h", [40, 464])
def test_csr_backward_landings_with_the_width(h, few_threads):
    """The CSR backward's two landings as its kernels' wrapper makes them,
    in plain torch on the CPU: the sender sums of d_op (H of its hp =
    col_pad(H) columns, the padding zero) give bitwise the sums of all hp
    columns, so dW_s = x^T sums is bitwise the parent's; d_x lands d_xg at
    d_in. Both against the JAX package's `_fused_bwd_call_v2` (interpret
    mode; d_x its d_xg summed at the senders) at test_torch_csr.py's
    tolerance (1e-4)."""
    ops, layout, landing, kw, inner_z, g_pass = _csr_case(3, h)
    x_c, w_s_c = ops[:2]
    n, hp = x_c.shape[0], da.col_pad(h)
    d_op = ca.routed_d_op(ca.projected_operands(
        *ops, *layout, n, kw["node_block"], kw["edge_tile"]),
        inner_z, g_pass).to(x_c.dtype)
    d_op_hp = torch.nn.functional.pad(d_op, (0, hp - h))
    sums = ss.segment_sum_csr(d_op_hp, *landing, width=h)
    assert sums.shape == (n, hp)
    assert torch.equal(sums, ss.segment_sum_csr(d_op_hp, *landing))
    dw_s = x_c.t() @ sums[:, :h]
    d_xg = ca.csr_bwd_projected_plain(*ops, *layout, inner_z, g_pass,
                                      **kw)[0]
    d_x = ss.segment_sum_csr(d_xg, *landing)
    assert torch.equal(d_x, ss.segment_sum_csr_listed(d_xg, *landing))
    j = jpk._fused_bwd_call_v2(
        *(jnp.asarray(v.numpy()) for v in (
            x_c[layout[0].long()], w_s_c, ops[2], ops[3], layout[1],
            layout[2], inner_z, g_pass)),
        n, kw["node_block"], kw["edge_tile"], True, jnp.float32)
    want_dx = np.zeros((n, x_c.shape[1]), np.float32)
    valid = layout[1].numpy() >= 0
    np.add.at(want_dx, layout[0].numpy()[valid], np.asarray(j[0])[valid])
    np.testing.assert_allclose(d_x.numpy(), want_dx, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dw_s.numpy(), np.asarray(j[2]), rtol=1e-4,
                               atol=1e-4)
    assert np.abs(dw_s.numpy()).max() > 0


def test_segsum_sites_on_the_cpu(few_threads):
    """The tool's sites at a tiny size on the CPU (where the wrapper is the
    plain version): each site's rows at the five layer shapes, the CSR
    d_op rows hp wide and summed over H, the landings' lengths, and the
    wrapper's sums bitwise the listed-order sum."""
    from radargnn_tpu_torch.benchmarks import segsum_sites

    site_rows = segsum_sites.sites(torch.device("cpu"), points=200, graphs=2)
    assert tuple(site_rows) == segsum_sites.SITES
    assert [w for _, _, w in site_rows["csr_dop"][2]] == [464, 464, 464,
                                                          272, 144]
    assert [a.shape[1] for a, _, _ in site_rows["csr_dop"][2]] == [
        512, 512, 512, 320, 192]
    assert [w for _, _, w in site_rows["ovf_ssum"][2]] == [224, 224, 224,
                                                           128, 64]
    assert all(b is not None for _, b, _ in site_rows["windowed"][2])
    lengths = segsum_sites._lengths(site_rows["ovf_ssum"][1])
    assert lengths["empty_share"] > 0.5 and lengths["max"] >= 1
    assert segsum_sites.check(site_rows) == {
        s: [True] * 5 for s in segsum_sites.SITES}
