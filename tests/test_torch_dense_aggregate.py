"""The port's dense max aggregation (radargnn_tpu_torch.ops.dense_aggregate),
its gradients, the d_x landing (ops.segment_sum) and segment max against the
JAX package.

On the CPU the wrappers take the kernels' plain PyTorch versions; the JAX
side runs its Pallas kernels in interpret mode, set up as
tests/test_pallas.py's dense (v4) tests set it up. Both compute in float32
there, so they agree to float32 summation order (rtol/atol 1e-4, the
tolerance of the JAX package's own kernel-vs-XLA test), gradients
included: the port lands d_x by sender in another order than the JAX
package's window parts, which float32 absorbs well inside 1e-4 here. The
CUDA kernels themselves run only on the card (tests/test_torch_gpu.py).

The port's dense backward routes on the forward's bits and lands the
H-wide sender sums (the JAX package's `sender_dx` form); it is held to the
JAX custom VJP with and without `sender_dx`, which compute the same
function."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radargnn_tpu.ops import pallas_kernels as jpk
from radargnn_tpu.ops import segment as jseg
from radargnn_tpu_torch.ops import dense_aggregate as da
from radargnn_tpu_torch.ops import dense_tiles as tdt
from radargnn_tpu_torch.ops import segment as tseg
from radargnn_tpu_torch.ops import segment_sum as ss

_DIFF = ("x", "w_s", "e_t", "w_e", "offset", "e_ovf")

RTOL = ATOL = 1e-4


def _dense_setup(seed=7, K=7, variable_degree=True, h=32, r_tile=8,
                 node_block=16):
    """tests/test_pallas.py's `_dense_setup`: a small graph and its dense
    tiling from the JAX package's host tiler. Variable in-degree exercises
    the over-degree spill and window overflow; `h` is the conv width,
    `r_tile` the receivers of a tile."""
    rng = np.random.default_rng(seed)
    n, d_in, de = 96, 24, 8
    wb = 2
    if variable_degree:
        e = 400
        send = rng.integers(0, 80, e).astype(np.int32)
        recv = rng.integers(0, 80, e).astype(np.int32)
        mask = rng.random(e) < 0.9
    else:
        nv = 80
        recv = np.repeat(np.arange(nv), K).astype(np.int32)
        send = rng.integers(0, nv, nv * K).astype(np.int32)
        e = nv * K
        mask = np.ones(e, bool)
        mask[recv == 3] = ([True, False] * K)[:K]
    x = rng.normal(size=(n, d_in)).astype(np.float32)
    w_s = (rng.normal(size=(d_in, h)) * 0.3).astype(np.float32)
    e_feat = rng.normal(size=(e, de)).astype(np.float32)
    w_e = (rng.normal(size=(de, h)) * 0.3).astype(np.float32)
    offset = rng.normal(size=(n, h)).astype(np.float32)
    te = r_tile * K
    perm, sloc, tile_win, ovf_idx = jpk.prepare_dense_knn_tiles(
        send, recv, mask, n, K, r_tile, node_block, wb,
        ovf_budget=-(-e // te) * te)
    pmask = jpk.window_part_mask(tile_win, -(-n // node_block), wb)
    ovf_valid = ovf_idx >= 0
    ovf_s = np.where(ovf_valid, send[np.maximum(ovf_idx, 0)], 0)
    ovf_r = np.where(ovf_valid, recv[np.maximum(ovf_idx, 0)], -1)
    e_ovf = np.where(ovf_valid[:, None], e_feat[np.maximum(ovf_idx, 0)],
                     0.0).astype(np.float32)
    geo = dict(n=n, K=K, r_tile=r_tile, node_block=node_block, wb=wb)
    arrays = dict(x=x, w_s=w_s, e_feat=e_feat, w_e=w_e, offset=offset,
                  send=send, recv=recv, mask=mask, perm=perm, sloc=sloc,
                  tile_win=tile_win, ovf_idx=ovf_idx, pmask=pmask,
                  ovf_s=ovf_s.astype(np.int32), ovf_r=ovf_r.astype(np.int32),
                  e_t=e_feat[perm], e_ovf=e_ovf)
    return geo, arrays


def _landing(geo, a):
    """The sender landing of the setup's slot layout and overflow list."""
    order, row_ptr = ss.sender_landing(
        a["sloc"], a["tile_win"], a["ovf_s"], a["ovf_r"] >= 0,
        slots_per_tile=geo["r_tile"] * geo["K"],
        node_block=geo["node_block"], num_nodes=geo["n"])
    return ss.SenderLanding(torch.from_numpy(order),
                            torch.from_numpy(row_ptr))


def _cut_widths(a, widths):
    """The setup with d_in, d_e cut to `widths` (not multiples of 8, which
    the entry point zero-pads for the kernels)."""
    if widths is None:
        return a
    d, de = widths
    return dict(a, x=a["x"][:, :d], w_s=a["w_s"][:d], w_e=a["w_e"][:de],
                e_t=a["e_t"][:, :de], e_ovf=a["e_ovf"][:, :de])


def _jax_grads(geo, a, sender_dx=False):
    """jax.grad of (fused(...)**2).sum() in the six differentiable args."""
    fused = jpk.make_fused_dense_aggregate(
        geo["n"], geo["K"], geo["r_tile"], geo["node_block"], geo["wb"],
        sender_dx=sender_dx)
    consts = tuple(map(jnp.asarray, (a["tile_win"], a["sloc"], a["pmask"],
                                     a["ovf_s"], a["ovf_r"])))
    grads = jax.grad(lambda *ar: (fused(*ar, *consts) ** 2).sum(),
                     argnums=tuple(range(6)))(
        *(jnp.asarray(a[nm]) for nm in _DIFF))
    return [np.asarray(gr) for gr in grads]


def _port_grads(geo, a):
    """torch.autograd.grad of the same loss through the port's Function."""
    args = list(_port_args(a))
    for i in range(6):
        args[i] = args[i].clone().requires_grad_(True)
    out = da.dense_aggregate(*args, r_tile=geo["r_tile"], k=geo["K"],
                             node_block=geo["node_block"],
                             landing=_landing(geo, a))
    return [gr.numpy() for gr in
            torch.autograd.grad((out ** 2).sum(), args[:6])]


def _port_args(a):
    t = {k: torch.from_numpy(np.ascontiguousarray(a[k])) for k in
         ("x", "w_s", "e_t", "w_e", "offset", "e_ovf", "tile_win", "sloc",
          "ovf_s", "ovf_r")}
    return (t["x"], t["w_s"], t["e_t"], t["w_e"], t["offset"], t["e_ovf"],
            t["tile_win"], t["sloc"], t["ovf_s"], t["ovf_r"])


@pytest.mark.parametrize("variable_degree", [True, False])
def test_dense_tiler_matches_jax(variable_degree):
    """The port's copy of the host tiler gives the JAX package's plan."""
    geo, a = _dense_setup(variable_degree=variable_degree)
    te = geo["r_tile"] * geo["K"]
    got = tdt.prepare_dense_knn_tiles(
        a["send"], a["recv"], a["mask"], geo["n"], geo["K"], geo["r_tile"],
        geo["node_block"], geo["wb"],
        ovf_budget=-(-a["send"].shape[0] // te) * te)
    for g, w, name in zip(got, (a["perm"], a["sloc"], a["tile_win"],
                                a["ovf_idx"]),
                          ("perm", "sloc", "tile_win", "ovf_idx")):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    np.testing.assert_array_equal(
        tdt.window_part_mask(a["tile_win"], -(-geo["n"] // geo["node_block"]),
                             geo["wb"]), a["pmask"])


@pytest.mark.parametrize("variable_degree", [True, False])
@pytest.mark.parametrize("widths", [None, (21, 5)])
def test_dense_aggregate_matches_jax_interpret(variable_degree, widths):
    """`widths` (d_in, d_e) cut the features to widths that are not
    multiples of 8, which the entry point zero-pads for the kernel."""
    geo, a = _dense_setup(variable_degree=variable_degree)
    assert (a["ovf_idx"] >= 0).sum() > 10, "test should exercise overflow"
    a = _cut_widths(a, widths)
    fused = jpk.make_fused_dense_aggregate(
        geo["n"], geo["K"], geo["r_tile"], geo["node_block"], geo["wb"])
    want = np.asarray(fused(
        *map(jnp.asarray, (a["x"], a["w_s"], a["e_t"], a["w_e"],
                           a["offset"], a["e_ovf"], a["tile_win"],
                           a["sloc"], a["pmask"], a["ovf_s"], a["ovf_r"]))))
    x, w_s, e_t, w_e, offset, e_ovf, t_win, sloc, ovf_s, ovf_r = \
        _port_args(a)
    launches = da.dense_fwd_cuda.launches
    got = da.dense_aggregate(x, w_s, e_t, w_e, offset, e_ovf, t_win, sloc,
                             ovf_s, ovf_r, r_tile=geo["r_tile"], k=geo["K"],
                             node_block=geo["node_block"])
    assert da.dense_fwd_cuda.launches == launches   # CPU: no kernel launch
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # the empty receivers (no valid in-edge) are exactly 0 in both
    np.testing.assert_array_equal(got.numpy() == 0, want == 0)


@pytest.mark.parametrize("variable_degree", [True, False])
def test_dense_overflow_inner_matches_jax(variable_degree):
    """Raw overflow maxima: equal where a receiver has overflow edges; both
    below _NEG/2 (the 'no edge' test the epilogue applies) elsewhere."""
    geo, a = _dense_setup(variable_degree=variable_degree)
    want = np.asarray(jpk.dense_overflow_inner(
        *map(jnp.asarray, (a["x"], a["w_s"], a["e_ovf"], a["w_e"],
                           a["ovf_s"], a["ovf_r"])), geo["n"]))
    t = {k: torch.from_numpy(np.asarray(a[k])) for k in a}
    got = da.dense_overflow_inner(t["x"], t["w_s"], t["e_ovf"], t["w_e"],
                                  t["ovf_s"], t["ovf_r"], geo["n"]).numpy()
    has = want > da._NEG / 2
    assert has.any() and (~has).any()
    np.testing.assert_array_equal(got > da._NEG / 2, has)
    np.testing.assert_allclose(got[has], want[has], rtol=RTOL, atol=ATOL)
    assert np.isfinite(got).all()


def test_dense_fwd_plain_masks_dummy_slots_by_sender():
    """Unused slots point at edge 0 (real features): only senders_local < 0
    may mark them empty. A dummy slot with a huge edge feature must not
    leak into the max."""
    geo, a = _dense_setup(variable_degree=True)
    dummy = np.flatnonzero(a["sloc"] < 0)
    assert dummy.size
    x, w_s, e_t, w_e, offset, e_ovf, t_win, sloc, ovf_s, ovf_r = \
        _port_args(a)
    kw = dict(r_tile=geo["r_tile"], k=geo["K"], node_block=geo["node_block"])
    base = da.dense_aggregate(x, w_s, e_t, w_e, offset, e_ovf, t_win, sloc,
                              ovf_s, ovf_r, **kw)
    e_t = e_t.clone()
    e_t[torch.from_numpy(dummy)] = 1e6
    again = da.dense_aggregate(x, w_s, e_t, w_e, offset, e_ovf, t_win, sloc,
                               ovf_s, ovf_r, **kw)
    torch.testing.assert_close(again, base, rtol=0, atol=0)


@pytest.mark.parametrize("sender_dx", [False, True])
@pytest.mark.parametrize("variable_degree", [True, False])
@pytest.mark.parametrize("widths", [None, (21, 5)])
def test_dense_aggregate_gradients_match_jax(variable_degree, widths,
                                            sender_dx):
    """The six gradients of (out**2).sum() (x, w_s, e_t, w_e, offset,
    e_ovf), through the port's autograd Function and through the JAX
    package's custom VJP (interpret mode), with the overflow path, the JAX
    backward with its per-slot d_x or its sender sums (`sender_dx`)."""
    geo, a = _dense_setup(variable_degree=variable_degree)
    a = _cut_widths(a, widths)
    launches = _launches()
    got = _port_grads(geo, a)
    assert launches == _launches()                       # CPU: none
    for name, u, v in zip(_DIFF, got, _jax_grads(geo, a, sender_dx)):
        assert u.dtype == np.float32 and u.shape == v.shape, name
        np.testing.assert_allclose(u, v, rtol=RTOL, atol=ATOL, err_msg=name)
    assert np.abs(got[5]).max() > 0, "the overflow path should take g"


def _launches():
    return (da.dense_proj_cuda.launches, da.dense_fwd_cuda.launches,
            da.dense_bwd_cuda.launches, ss.segment_sum_csr_cuda.launches)


@pytest.mark.parametrize("sender_dx", [False, True])
def test_dense_aggregate_at_a_conv_width_of_450(sender_dx):
    """H = 450 (2 x 224 + 2: raw relative-position edge features, no edge
    embedding), not a multiple of 8: the forward and the six gradients
    against the JAX package."""
    geo, a = _dense_setup(seed=11, h=450)
    a = _cut_widths(a, (21, 2))
    fused = jpk.make_fused_dense_aggregate(
        geo["n"], geo["K"], geo["r_tile"], geo["node_block"], geo["wb"],
        sender_dx=sender_dx)
    want = np.asarray(fused(
        *map(jnp.asarray, (a["x"], a["w_s"], a["e_t"], a["w_e"],
                           a["offset"], a["e_ovf"], a["tile_win"],
                           a["sloc"], a["pmask"], a["ovf_s"], a["ovf_r"]))))
    got = da.dense_aggregate(*_port_args(a), r_tile=geo["r_tile"],
                             k=geo["K"], node_block=geo["node_block"])
    assert got.shape == want.shape == (geo["n"], 450)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    for name, u, v in zip(_DIFF, _port_grads(geo, a),
                          _jax_grads(geo, a, sender_dx)):
        assert u.shape == v.shape, name
        np.testing.assert_allclose(u, v, rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("sender_dx", [False, True])
def test_dense_aggregate_gives_tied_slots_the_full_g(sender_dx):
    """Two slots of one receiver with the same sender and the same edge
    features tie exactly. Both packages give each of them the full g (the
    TPU kernel's rule), not g/2 (the unfused path's segment max): each tied
    slot's d_e equals what the slot takes when its twin is emptied."""
    geo, a = _dense_setup(variable_degree=False)
    te, r_tile = geo["r_tile"] * geo["K"], geo["r_tile"]
    sloc = a["sloc"]
    slot0 = next(i for i in range(te) if sloc[i] >= 0 and sloc[i + r_tile] >= 0)
    slot1 = slot0 + r_tile                    # the receiver's next slot
    tied = dict(a, sloc=sloc.copy(), e_t=a["e_t"].copy())
    tied["sloc"][slot1] = sloc[slot0]
    tied["e_t"][slot1] = tied["e_t"][slot0] = 3.0 * a["e_t"][slot0]
    alone = dict(tied, sloc=tied["sloc"].copy())
    alone["sloc"][slot1] = -1
    pm = jpk.window_part_mask(a["tile_win"], -(-geo["n"] // geo["node_block"]),
                              geo["wb"])
    tied["pmask"] = alone["pmask"] = pm
    def jax_grads(geo, a):
        return _jax_grads(geo, a, sender_dx)

    for grads in (_port_grads(geo, tied), jax_grads(geo, tied)):
        d_e = grads[2]
        assert np.abs(d_e[slot0]).max() > 0, "the tied pair should win"
        np.testing.assert_array_equal(d_e[slot0], d_e[slot1])
    for fn in (_port_grads, jax_grads):
        np.testing.assert_allclose(fn(geo, tied)[2][slot0],
                                   fn(geo, alone)[2][slot0],
                                   rtol=RTOL, atol=ATOL)


def test_dense_aggregate_needs_the_landing_for_grad():
    geo, a = _dense_setup()
    args = list(_port_args(a))
    args[1] = args[1].requires_grad_(True)
    kw = dict(r_tile=geo["r_tile"], k=geo["K"], node_block=geo["node_block"])
    with pytest.raises(ValueError, match="landing"):
        da.dense_aggregate(*args, **kw)
    with torch.no_grad():       # serving needs no landing
        da.dense_aggregate(*args, **kw)


def _slot_operands(geo, a, overflow=True):
    """The forward's pieces on the setup: y_s, the operand of every slot
    (_NEG at empty slots) and the plain forward's (out, inner, bits), with
    the overflow maxima or without (`overflow` False: the slots alone)."""
    x, w_s, e_t, w_e, offset, e_ovf, t_win, sloc, ovf_s, ovf_r = \
        _port_args(a)
    kw = dict(r_tile=geo["r_tile"], k=geo["K"], node_block=geo["node_block"])
    y_s = da.dense_proj(x, w_s)
    inner_o = da.overflow_maxima(
        da.dense_overflow_operand(y_s, e_ovf, w_e, ovf_s), ovf_r, geo["n"])
    if not overflow:
        inner_o = torch.full_like(offset, da._NEG)
    res = da.dense_fwd(y_s, e_t, w_e, sloc, t_win, inner_o, offset,
                       emit_inner=True, **kw)
    sender = t_win.long().repeat_interleave(geo["r_tile"] * geo["K"]) \
        * geo["node_block"] + sloc.long().clamp(min=0)
    op = (x[sender] @ w_s + e_t @ w_e).double()
    op = torch.where((sloc >= 0)[:, None], op, da._NEG)
    return y_s, op, res


@pytest.mark.parametrize("variable_degree", [True, False])
def test_dense_fwd_bits_are_the_routes_of_the_operand(variable_degree):
    """The forward's saved bits (VJP mode) are `_routes` of the slot's
    operand against its receiver's max, at valid slots, and zero past H:
    the operand recomputed here as x[sender] @ w_s + e @ w_e."""
    geo, a = _dense_setup(variable_degree=variable_degree)
    y_s, op, (out, inner, bits) = _slot_operands(geo, a)
    h = inner.shape[1]
    assert y_s.shape == (geo["n"], da.col_pad(h))
    assert bits.dtype == torch.int32
    assert bits.shape == (op.shape[0], da.col_pad(h) // 32)
    recv = da._slot_receivers(op.shape[0], geo["r_tile"], geo["K"], "cpu")
    valid = torch.from_numpy(a["sloc"] >= 0)
    want = da._routes(op.float(), inner[recv]) & valid[:, None]
    got = da.unpack_bits(bits, da.col_pad(h))
    assert torch.equal(got[:, :h], want)
    assert not got[:, h:].any()
    assert torch.equal(da.pack_bits(want), bits)
    # each receiver's max over its slots is routed where it is the max
    slot_max = op.float().reshape(-1, geo["K"], geo["r_tile"], h).amax(1)
    at_max = (slot_max.reshape(-1, h) == inner) & (inner > da._NEG / 2)
    routed = got[:, :h].reshape(-1, geo["K"], geo["r_tile"], h).any(1)
    assert at_max.any() and routed.reshape(-1, h)[at_max].all()


def test_pack_bits_round_trips():
    sel = torch.from_numpy(np.random.default_rng(4).random((37, 100)) < 0.3)
    bits = da.pack_bits(sel)
    assert bits.shape == (37, 4) and bits.dtype == torch.int32
    assert torch.equal(da.unpack_bits(bits, 100), sel)
    sel[:, 31] = True           # the sign bit of word 0
    assert torch.equal(da.unpack_bits(da.pack_bits(sel), 100), sel)


def test_dense_bwd_plain_matches_the_function_s_slot_part():
    """dense_bwd_plain alone on the slot layout (bits without the overflow
    maxima), the return contract (d_e, dW_e, d_ys, d_yo): d_op is g at the
    slot's receiver where its bit is set; d_e per slot is d_op @ W_e^T and
    vanishes on empty slots; dW_e is e_t^T d_op; d_ys sums d_op at the
    slots' senders, d_yo the overflow rows at theirs."""
    geo, a = _dense_setup()
    _, _, (_, inner, bits) = _slot_operands(geo, a, overflow=False)
    _, _, e_t, w_e, _, _, _, sloc, _, _ = _port_args(a)
    has = inner > da._NEG / 2
    g = torch.from_numpy(np.random.default_rng(1).normal(
        size=inner.shape).astype(np.float32))
    g_pass = torch.where(has, g, 0.0)
    landing = _landing(geo, a)
    ovf_valid = torch.from_numpy(a["ovf_r"] >= 0)
    d_op_o = torch.where(ovf_valid[:, None], torch.from_numpy(
        np.random.default_rng(2).normal(
            size=(ovf_valid.shape[0], inner.shape[1])).astype(np.float32)),
        0.0)
    d_e, dw_e, d_ys, d_yo = da.dense_bwd(bits, g_pass, e_t, w_e, d_op_o,
                                         landing.order, landing.row_ptr,
                                         r_tile=geo["r_tile"], k=geo["K"])
    assert d_e.shape == e_t.shape and dw_e.shape == w_e.shape
    for sums in (d_ys, d_yo):
        assert sums.shape == inner.shape and sums.dtype == torch.float32
    empty = sloc < 0
    assert empty.any() and (d_e[empty] == 0).all()
    recv = da._slot_receivers(e_t.shape[0], geo["r_tile"], geo["K"], "cpu")
    d_op = torch.where(da.unpack_bits(bits, inner.shape[1]), g_pass[recv],
                       0.0)
    torch.testing.assert_close(d_e, d_op @ w_e.t())
    torch.testing.assert_close(dw_e, e_t.t() @ d_op)
    sender = torch.from_numpy(
        np.repeat(a["tile_win"], geo["r_tile"] * geo["K"])
        * geo["node_block"] + a["sloc"]).long()
    want = torch.zeros_like(d_ys).index_add_(
        0, sender[~empty], d_op[~empty])
    torch.testing.assert_close(d_ys, want)
    assert ovf_valid.any()
    want_o = torch.zeros_like(d_yo).index_add_(
        0, torch.from_numpy(a["ovf_s"]).long()[ovf_valid], d_op_o[ovf_valid])
    torch.testing.assert_close(d_yo, want_o)
    # every receiver with a slot routes its g to at least one slot
    routed = (d_e.reshape(-1, geo["K"], geo["r_tile"], d_e.shape[1]) != 0
              ).any(dim=(1, 3)).reshape(-1)
    assert routed[has.any(dim=1)].float().mean() > 0.9


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_segment_sum_csr_plain_matches_jax(dtype):
    """The landing's plain version against `pallas_segment_sum_csr`
    (interpret mode) and its jnp reference, on the same segment-sorted
    rows: padding slots, empty segments."""
    rng = np.random.default_rng(17)
    n, e, d = 96, 700, 24
    node_block, edge_tile = 32, 32
    data = rng.normal(size=(e, d)).astype(np.float32)
    if dtype == "bfloat16":
        data = np.asarray(jnp.asarray(data, jnp.bfloat16).astype(jnp.float32))
    seg = rng.integers(0, n - 6, e).astype(np.int32)       # 6 empty segments
    mask = rng.random(e) < 0.85
    perm, tile_blocks, padded_seg = jpk.prepare_csr_tiles(
        seg, mask, n, node_block, edge_tile)
    jdata = jnp.asarray(data[perm])
    if dtype == "bfloat16":
        jdata = jdata.astype(jnp.bfloat16)
    want = np.asarray(jpk.pallas_segment_sum_csr(
        jdata, jnp.asarray(padded_seg), jnp.asarray(tile_blocks),
        num_nodes=n, node_block=node_block, edge_tile=edge_tile))
    want_ref = np.asarray(jpk.pallas_segment_sum_csr_reference(
        jdata, jnp.asarray(padded_seg), n))
    # the port's landing: the same rows, listed by segment (padding -1
    # rows skipped), one source
    rows = np.flatnonzero(padded_seg >= 0)
    order = rows[np.argsort(padded_seg[rows], kind="stable")]
    row_ptr = np.concatenate([[0], np.cumsum(np.bincount(padded_seg[rows],
                                                         minlength=n))])
    a = torch.from_numpy(data[perm])
    if dtype == "bfloat16":
        a = a.bfloat16()
    got = ss.segment_sum_csr(a, torch.from_numpy(order.astype(np.int32)),
                             torch.from_numpy(row_ptr.astype(np.int32)))
    assert got.dtype == torch.float32 and got.shape == (n, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), want_ref, rtol=RTOL, atol=ATOL)
    assert (got.numpy()[n - 6:] == 0).all()


def test_segment_sum_csr_two_sources_number_rows_in_turn():
    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.normal(size=(5, 8)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(3, 8)).astype(np.float32))
    order = torch.tensor([6, 0, 2, 7, 5], dtype=torch.int32)
    row_ptr = torch.tensor([0, 2, 2, 5], dtype=torch.int32)
    got = ss.segment_sum_csr(a, order, row_ptr, b)
    torch.testing.assert_close(got[0], b[1] + a[0])
    torch.testing.assert_close(got[1], torch.zeros(8))
    torch.testing.assert_close(got[2], a[2] + b[2] + b[0])


@pytest.mark.parametrize("variable_degree", [True, False])
def test_sender_landing_groups_every_valid_row_by_sender(variable_degree):
    geo, a = _dense_setup(variable_degree=variable_degree)
    order, row_ptr = (t.numpy() for t in _landing(geo, a))
    te = geo["r_tile"] * geo["K"]
    slot_send = np.where(a["sloc"] >= 0, np.repeat(
        a["tile_win"] * geo["node_block"], te) + a["sloc"], -1)
    send = np.concatenate([slot_send, np.where(a["ovf_r"] >= 0, a["ovf_s"],
                                               -1)])
    valid = np.flatnonzero(send >= 0)
    assert sorted(order.tolist()) == valid.tolist()
    assert row_ptr[0] == 0 and row_ptr[-1] == len(order)
    for n in range(geo["n"]):
        rows = order[row_ptr[n]:row_ptr[n + 1]]
        assert (send[rows] == n).all() and (np.diff(rows) > 0).all()
    # the landing's slot senders are the edges' senders
    real = a["sloc"] >= 0
    np.testing.assert_array_equal(slot_send[real], a["send"][a["perm"][real]])


def test_dense_fwd_cuda_refuses_cpu_tensors():
    """The kernels' wrappers check their inputs before they build or
    launch: they never fall back to the plain versions."""
    geo, a = _dense_setup()
    x, w_s, e_t, w_e, offset, e_ovf, t_win, sloc, ovf_s, ovf_r = \
        _port_args(a)
    inner_o = torch.full_like(offset, da._NEG)
    with pytest.raises(ValueError, match="CUDA"):
        da.dense_proj_cuda(x.bfloat16(), w_s.bfloat16())
    y_s = da.dense_proj_plain(x, w_s)
    with pytest.raises(ValueError, match="CUDA"):
        da.dense_fwd_cuda(y_s, e_t.bfloat16(), w_e.bfloat16(), sloc, t_win,
                          inner_o, offset, r_tile=geo["r_tile"], k=geo["K"],
                          node_block=geo["node_block"])


def test_backward_wrappers_refuse_cpu_tensors():
    """The backward kernels' and the landing's wrappers too."""
    geo, a = _dense_setup()
    _, _, (_, inner, bits) = _slot_operands(geo, a)
    e_t, w_e = (torch.from_numpy(a[k]).bfloat16() for k in ("e_t", "w_e"))
    order, row_ptr = _landing(geo, a)
    with pytest.raises(ValueError, match="CUDA"):
        da.dense_bwd_cuda(bits, inner, e_t, w_e,
                          torch.zeros((a["ovf_s"].shape[0], inner.shape[1])),
                          order, row_ptr, r_tile=geo["r_tile"], k=geo["K"])
    with pytest.raises(ValueError, match="CUDA"):
        ss.segment_sum_csr_cuda(e_t, order, row_ptr)


def test_gather_dtype_follows_the_device():
    assert da.gather_dtype(torch.device("cpu")) == torch.float32
    assert da.gather_dtype(torch.device("cuda", 0)) == torch.bfloat16


@pytest.mark.parametrize("masked", [True, False])
def test_segment_max_matches_jax(masked):
    rng = np.random.default_rng(3)
    e, n, h = 60, 13, 5
    data = (rng.normal(size=(e, h)) - 3.0).astype(np.float32)  # all < 0
    seg = rng.integers(0, n - 2, e).astype(np.int32)            # empties
    mask = rng.random(e) < 0.7 if masked else None
    offset = rng.normal(size=(n, h)).astype(np.float32)
    tm = None if mask is None else torch.from_numpy(mask)
    jm = None if mask is None else jnp.asarray(mask)
    got = tseg.segment_max(torch.from_numpy(data), torch.from_numpy(seg), n,
                           tm)
    want = jseg.segment_max(jnp.asarray(data), jnp.asarray(seg), n, jm)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = tseg.hoisted_segment_max(torch.from_numpy(data),
                                   torch.from_numpy(seg), n, tm,
                                   torch.from_numpy(offset))
    want = jseg.hoisted_segment_max(jnp.asarray(data), jnp.asarray(seg), n,
                                    jm, False, jnp.asarray(offset))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)



@pytest.mark.parametrize("r_tile", [8, 24])
def test_receiver_tiles_of_8_match_jax(r_tile):
    """Receiver tiles that are multiples of 8 but not of 16 (the card's
    kernels mask the last warp's 8 rows past the tile there): the forward
    and its six gradients against the JAX v4 factory in interpret mode."""
    geo, a = _dense_setup(seed=11, r_tile=r_tile, node_block=48)
    fused = jpk.make_fused_dense_aggregate(
        geo["n"], geo["K"], geo["r_tile"], geo["node_block"], geo["wb"])
    consts = tuple(map(jnp.asarray, (a["tile_win"], a["sloc"], a["pmask"],
                                     a["ovf_s"], a["ovf_r"])))
    want = np.asarray(fused(*(jnp.asarray(a[k]) for k in _DIFF), *consts))
    got = da.dense_aggregate(*_port_args(a), r_tile=r_tile, k=geo["K"],
                             node_block=geo["node_block"])
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    for name, u, v in zip(_DIFF, _port_grads(geo, a), _jax_grads(geo, a)):
        np.testing.assert_allclose(u, v, rtol=RTOL, atol=ATOL, err_msg=name)


def test_dry_run_geometry_is_the_jax_packages():
    """The port's multi-rank dry run tiles its dense batches as the JAX
    package's dry run (`__graft_entry__.py`: its dense x halo step,
    `_dryrun_dense_halo`) does."""
    import ast
    import os

    from radargnn_tpu_torch.parallel import dryrun

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "__graft_entry__.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    entry = next(node for node in ast.walk(tree)
                 if isinstance(node, ast.FunctionDef)
                 and node.name == "_dryrun_dense_halo")
    dense = next(ast.literal_eval(node.value) for node in ast.walk(entry)
                 if isinstance(node, ast.Assign)
                 and getattr(node.targets[0], "id", None) == "dense")
    assert dryrun.DENSE == dense
    assert dryrun.DENSE["r_tile"] == 8
