"""The port's CSR fused path (radargnn_tpu_torch: the CSR branch of
graph.batch, ops.csr_aggregate, and DetNet / Predictor / Trainer under
`fused_tiling: "csr"`) against the JAX package.

The host tiler is numpy in both packages, so the batch arrays must be
identical. On the CPU the kernel wrappers take their plain PyTorch
versions; the JAX side runs `make_fused_hoisted_aggregate_v2` in interpret
mode, set up as tests/test_pallas.py's v2 test sets it up. Both compute in
float32 there (interpret mode gathers in float32, and v2 keeps the edge
side float32 everywhere), so the aggregate and its five gradients agree to
float32 summation order (rtol/atol 1e-4, the tolerance of the JAX
package's own kernel tests); the model and the trainer to the tolerances
of tests/test_torch_detnet.py and tests/test_torch_trainer.py (1e-4 in
float32, 2e-2 with bf16 compute). The CUDA kernels themselves run only on
the card (tests/test_torch_gpu.py), where the bf16 side of v2's contract
shows."""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radargnn_tpu import configs as jcfg
from radargnn_tpu.data.synthetic import DEFAULT_GRAPH_CONFIG as J_GRAPH
from radargnn_tpu.data.synthetic import make_samples as j_make_samples
from radargnn_tpu.graph import batch as jbatch
from radargnn_tpu.models import layers as jlayers
from radargnn_tpu.models.detnet import create_detnet_state
from radargnn_tpu.ops import pallas_kernels as jpk
from radargnn_tpu.postprocess.inference import Predictor as JPredictor
from radargnn_tpu.train.trainer import Trainer as JTrainer
from radargnn_tpu_torch import configs as tcfg
from radargnn_tpu_torch import smoke
from radargnn_tpu_torch import weights
from radargnn_tpu_torch.data.synthetic import DEFAULT_GRAPH_CONFIG as T_GRAPH
from radargnn_tpu_torch.data.synthetic import make_samples as t_make_samples
from radargnn_tpu_torch.graph import batch as tbatch
from radargnn_tpu_torch.models import layers as tlayers
from radargnn_tpu_torch.models.detnet import DetNet
from radargnn_tpu_torch.ops import csr_aggregate as ca
from radargnn_tpu_torch.ops import dense_aggregate as da
from radargnn_tpu_torch.ops import segment_sum as ss
from radargnn_tpu_torch.ops import windowed_tiles as wt
from radargnn_tpu_torch.postprocess.inference import Predictor
from radargnn_tpu_torch.train.trainer import Trainer

_DIFF = ("x", "w_s", "e_t", "w_e", "offset")
RTOL = ATOL = 1e-4
SPEC = (32, 64)          # (node_block, edge_tile) of the model-size tests


def _radius_config(package_graph, r):
    cfg = dataclasses.replace(
        package_graph, graph_construction_algorithm="radius",
        graph_construction_settings={"k": 20, "r": r})
    cfg.__post_init__()
    return cfg


def _samples(kind, num_frames=2, seed=5):
    """The same frames from both packages: kNN graphs (k 20), or radius
    graphs with hub receivers (r = 18 m at 150 points)."""
    if kind == "hub":
        jg, tg = _radius_config(J_GRAPH, 18.0), _radius_config(T_GRAPH, 18.0)
    else:
        jg, tg = J_GRAPH, T_GRAPH
    kw = dict(num_frames=num_frames, num_points=150, seed=seed)
    return j_make_samples(graph_config=jg, **kw), \
        t_make_samples(graph_config=tg, **kw)


def _empty(sample):
    return type(sample)(
        node_feat=sample.node_feat[:0], edge_feat=sample.edge_feat[:0],
        senders=sample.senders[:0], receivers=sample.receivers[:0],
        labels=sample.labels[:0], boxes=sample.boxes[:0],
        pos=sample.pos[:0], vel=sample.vel[:0])


def _edge_bucket(samples):
    return -(-max(s.num_edges for s in samples) // 64) * 64


@pytest.mark.parametrize("kind", ["knn", "hub", "empty_block",
                                  "empty_sample"])
def test_csr_stack_samples_match_jax(kind):
    """pad_sample / stack_samples under the CSR tiling: every batch array
    (the sender-sorted ssum_* included), the geometry, the flat tiling and
    the landing read off the sender-sorted tiling. `empty_block` pads 150
    points to 256 nodes, so the last three node blocks have no edges and
    get a dummy tile each; `empty_sample` adds a sample without nodes, as
    the JAX loader pads short batches."""
    js, ts = _samples("hub" if kind == "hub" else "knn")
    max_nodes = 256 if kind == "empty_block" else 160
    if kind == "empty_sample":
        js, ts = js[:1] + [_empty(js[0])], ts[:1] + [_empty(ts[0])]
    max_edges = _edge_bucket(js)
    jb = jbatch.stack_samples(js, max_nodes=max_nodes, bg_index=5,
                              max_edges=max_edges, csr_tiling=SPEC)
    tb = tbatch.stack_samples(ts, max_nodes=max_nodes, bg_index=5,
                              max_edges=max_edges, csr_tiling=SPEC,
                              device="cpu")
    names = tb.tensors().keys()
    assert {"ssum_perm", "ssum_senders", "ssum_blocks"} <= set(names)
    for name, t in tb.tensors().items():
        j = np.asarray(getattr(jb, name))
        assert t.numpy().dtype == j.dtype, name
        np.testing.assert_array_equal(t.numpy(), j, err_msg=name)
    assert tb.tile_geometry == jb.tile_geometry == SPEC
    jt, tt = jb.flat_tiling(), tb.flat_tiling()
    for name in ("senders", "receivers", "blocks", "edge_feat"):
        np.testing.assert_array_equal(getattr(tt, name).numpy(),
                                      np.asarray(getattr(jt, name)),
                                      err_msg=name)
    assert tt.win is None and jt.win is None and tt.dense is None
    for i, (a, b) in enumerate(zip(tt.ssum, jt.ssum)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=f"ssum[{i}]")
    assert (tt.node_block, tt.edge_tile, tt.roll_passes) == \
        (jt.node_block, jt.edge_tile, jt.roll_passes)
    # the landing lists every valid slot once, grouped by its sender, in
    # the sender-sorted tiling's order (each sender's slots ascending)
    order, row_ptr = (a.numpy() for a in tt.landing)
    recv, send = tt.receivers.numpy(), tt.senders.numpy()
    valid = np.flatnonzero(recv >= 0)
    assert sorted(order.tolist()) == valid.tolist()
    seg = np.repeat(np.arange(len(row_ptr) - 1), np.diff(row_ptr))
    np.testing.assert_array_equal(send[order], seg)
    want = ss.rows_by_sender(np.where(recv >= 0, send, -1),
                             len(row_ptr) - 1)
    np.testing.assert_array_equal(order, want[0])
    np.testing.assert_array_equal(row_ptr, want[1])
    blocks = tt.blocks.numpy()
    if kind == "empty_block":
        # nodes 160-255 of each graph: blocks 5-7 and 13-15 have tiles,
        # all of them empty (a dummy tile; the last block also holds the
        # static budget's no-op tiles)
        per_tile = recv.reshape(len(blocks), SPEC[1])
        for b in (5, 6, 7, 13, 14, 15):
            assert (blocks == b).any() and (per_tile[blocks == b] < 0).all()
    if kind == "hub":
        pairs = np.unique(np.stack([recv[valid], valid // SPEC[1]]), axis=1)
        assert np.bincount(pairs[0]).max() > 1, "a run should span tiles"


def test_csr_tiler_matches_jax():
    """The tiler both passes use (`prepare_csr_tiles`), with and without a
    static tile budget."""
    rng = np.random.default_rng(3)
    n, e = 96, 500
    recv = rng.integers(0, n, e).astype(np.int32)
    mask = rng.random(e) < 0.9
    for total in (None, -(-e // 32) + -(-n // 32) + 2):
        for g, w in zip(wt.prepare_csr_tiles(recv, mask, n, 32, 32, total),
                        jpk.prepare_csr_tiles(recv, mask, n, 32, 32, total)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_fused_csr_tiling_csr_matches_jax():
    """fused_tiling "csr" gives the JAX package's loader tuple, with or
    without a kNN degree."""
    kw = dict(node_feature_dimension=5, edge_feature_dimension=2,
              conv_layer_dimensions=[8],
              classification_head_layer_dimensions=[6],
              regression_head_layer_dimensions=[5], fused_tiling="csr")
    for k in (None, 20):
        got = tlayers.fused_csr_tiling(tcfg.GNNArchitectureConfig(**kw), k=k)
        want = jlayers.fused_csr_tiling(jcfg.GNNArchitectureConfig(**kw), k=k)
        assert got == want == (tlayers.FUSED_NODE_BLOCK,
                               tlayers.FUSED_EDGE_TILE) == (256, 512)
    with pytest.raises(ValueError, match="fused_tiling"):
        tlayers.fused_csr_tiling(tcfg.GNNArchitectureConfig(
            **dict(kw, fused_tiling="sparse")))


def _agg_setup(seed=13, widths=None, hub=False, h=32):
    """tests/test_pallas.py's v2 case (96 nodes, 500 random edges, 10 %
    masked, 32-node blocks, 32-slot tiles), optionally with a tenth of the
    edges on five hub receivers (runs span tiles) and odd widths (d_in,
    d_e), conv width `h`; the receiver tiling and the sender-sorted
    tiling."""
    rng = np.random.default_rng(seed)
    n, e, d_in, de = 96, 500, 24, 8
    nb, et = 32, 32
    send = rng.integers(0, n, e).astype(np.int32)
    recv = rng.integers(0, n, e).astype(np.int32)
    if hub:
        recv = np.where(rng.random(e) < 0.1, rng.integers(0, 5, e),
                        recv).astype(np.int32)
    mask = rng.random(e) < 0.9
    a = dict(x=rng.normal(size=(n, d_in)).astype(np.float32),
             w_s=(rng.normal(size=(d_in, h)) * 0.3).astype(np.float32),
             w_e=(rng.normal(size=(de, h)) * 0.3).astype(np.float32),
             offset=rng.normal(size=(n, h)).astype(np.float32))
    e_feat = rng.normal(size=(e, de)).astype(np.float32)
    perm, blocks, precv = wt.prepare_csr_tiles(recv, mask, n, nb, et)
    senders_t = send[perm]
    s_perm, s_blocks, s_send = wt.prepare_csr_tiles(senders_t, precv >= 0, n,
                                                    nb, et)
    a.update(e_t=e_feat[perm], senders=senders_t, recv=precv, blocks=blocks,
             s_perm=s_perm, s_send=s_send, s_blocks=s_blocks)
    if widths is not None:
        d, dde = widths
        a.update(x=a["x"][:, :d], w_s=a["w_s"][:d], w_e=a["w_e"][:dde],
                 e_t=a["e_t"][:, :dde])
    return dict(n=n, node_block=nb, edge_tile=et), a


def _jax_fused(geo, a, ssum):
    fused = jpk.make_fused_hoisted_aggregate_v2(geo["n"], geo["node_block"],
                                                geo["edge_tile"])
    consts = tuple(map(jnp.asarray, (a["senders"], a["recv"], a["blocks"])))
    s = tuple(map(jnp.asarray, (a["s_perm"], a["s_send"], a["s_blocks"]))) \
        if ssum else (None,) * 3

    def f(x, w_s, e_t, w_e, offset):
        return fused(x, w_s, e_t, w_e, *consts, offset, *s)
    return f


def _landing(geo, a, ssum):
    if ssum:
        order, row_ptr = ss.csr_landing(a["s_perm"], a["s_send"], geo["n"])
    else:
        order, row_ptr = ss.rows_by_sender(
            np.where(a["recv"] >= 0, a["senders"], -1), geo["n"])
    return ss.SenderLanding(torch.from_numpy(order),
                            torch.from_numpy(row_ptr))


def _port_call(geo, a, leaves=None, landing=None):
    t = {k: torch.from_numpy(np.ascontiguousarray(a[k]))
         for k in _DIFF + ("senders", "recv", "blocks")}
    diff = leaves if leaves is not None else [t[k] for k in _DIFF]
    x, w_s, e_t, w_e, offset = diff
    return ca.csr_aggregate(x, w_s, e_t, w_e, t["senders"], t["recv"],
                            t["blocks"], offset,
                            node_block=geo["node_block"],
                            edge_tile=geo["edge_tile"], landing=landing)


def _port_grads(geo, a, ssum=True):
    leaves = [torch.from_numpy(np.ascontiguousarray(a[k])).requires_grad_()
              for k in _DIFF]
    out = _port_call(geo, a, leaves, _landing(geo, a, ssum))
    return [g.numpy() for g in torch.autograd.grad((out ** 2).sum(), leaves)]


def _jax_grads(geo, a, ssum=True):
    f = _jax_fused(geo, a, ssum)
    grads = jax.grad(lambda *ar: (f(*ar) ** 2).sum(),
                     argnums=tuple(range(5)))(
        *(jnp.asarray(a[k]) for k in _DIFF))
    return [np.asarray(g) for g in grads]


@pytest.mark.parametrize("hub", [False, True])
@pytest.mark.parametrize("widths", [None, (21, 5)])
def test_csr_aggregate_matches_jax_interpret(widths, hub):
    """The forward against make_fused_hoisted_aggregate_v2 (interpret mode);
    `widths` not multiples of 8 reach the kernels zero-padded."""
    geo, a = _agg_setup(widths=widths, hub=hub)
    want = np.asarray(_jax_fused(geo, a, True)(
        *(jnp.asarray(a[k]) for k in _DIFF)))
    launches = ca.csr_fwd_cuda.launches
    got = _port_call(geo, a)
    assert ca.csr_fwd_cuda.launches == launches          # CPU: no launch
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got.numpy() == 0, want == 0)


@pytest.mark.parametrize("ssum", [True, False])
@pytest.mark.parametrize("case", ["random", "hub", "odd_widths"])
def test_csr_aggregate_gradients_match_jax(case, ssum):
    """The five gradients of (out**2).sum() through CsrAggregateFn and
    through the JAX package's custom VJP (interpret mode), with the JAX
    backward's d_x from its sender-sorted Pallas segment sum (`ssum`) or
    from XLA's segment sum; the port lands d_x through the landing of the
    sender-sorted tiling or of the slots' senders, which list the same
    rows in the same order."""
    geo, a = _agg_setup(seed=17, hub=case == "hub",
                        widths=(21, 5) if case == "odd_widths" else None)
    launches = (ca.csr_fwd_cuda.launches, ca.csr_bwd_cuda.launches,
                ss.segment_sum_csr_cuda.launches)
    got = _port_grads(geo, a, ssum)
    assert launches == (ca.csr_fwd_cuda.launches, ca.csr_bwd_cuda.launches,
                        ss.segment_sum_csr_cuda.launches)
    for name, u, v in zip(_DIFF, got, _jax_grads(geo, a, ssum)):
        assert u.dtype == np.float32 and u.shape == v.shape, name
        np.testing.assert_allclose(u, v, rtol=RTOL, atol=ATOL, err_msg=name)
    assert np.abs(got[2]).max() > 0


def test_csr_aggregate_at_a_conv_width_of_450():
    """H = 450, not a multiple of 8 (the card's backward pads it): the
    forward and the five gradients against the JAX package."""
    geo, a = _agg_setup(seed=19, widths=(21, 2), h=450)
    want = np.asarray(_jax_fused(geo, a, True)(
        *(jnp.asarray(a[k]) for k in _DIFF)))
    got = _port_call(geo, a)
    assert got.shape == want.shape == (geo["n"], 450)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    for name, u, v in zip(_DIFF, _port_grads(geo, a), _jax_grads(geo, a)):
        assert u.shape == v.shape, name
        np.testing.assert_allclose(u, v, rtol=RTOL, atol=ATOL, err_msg=name)


def _tied_pair(seed=41):
    """Dyadic inputs (multiples of 1/8) where two slots of one receiver
    have the same sender and the same edge features, so they tie exactly:
    the case with the pair (`tied`), the case with its second slot emptied
    (`alone`), and the pair's first slot."""
    geo, a = _agg_setup(seed=seed)
    rng = np.random.default_rng(5)
    for k in _DIFF:
        a[k] = (rng.integers(-4, 5, a[k].shape) * 0.125).astype(np.float32)
    recv, send, et = a["recv"], a["senders"], geo["edge_tile"]
    # the pair ends its tile's occupied slots, so emptying the second keeps
    # the empty slots at the tile's end, as the TPU kernel's layout needs
    s0 = next(i for i in range(len(recv) - 2)
              if recv[i] >= 0 and recv[i] == recv[i + 1]
              and i // et == (i + 1) // et
              and (recv[i + 2] < 0 or (i + 2) // et != i // et))
    tied = dict(a, senders=send.copy(), e_t=a["e_t"].copy())
    tied["senders"][s0 + 1] = send[s0]
    tied["e_t"][s0 + 1] = tied["e_t"][s0] = 0.5 + np.abs(a["e_t"][s0])
    alone = dict(tied, recv=recv.copy())
    alone["recv"][s0 + 1] = -1
    for t in (tied, alone):
        # the sender-sorted tiling of the edited slots
        t["s_perm"], t["s_blocks"], t["s_send"] = wt.prepare_csr_tiles(
            t["senders"], t["recv"] >= 0, geo["n"], geo["node_block"], et)
    return geo, tied, alone, s0


def _assert_tied_pair_takes_the_full_g(grads, geo, tied, alone, s0):
    d_e = grads(geo, tied)[2]
    assert np.abs(d_e[s0]).max() > 0, "the tied pair should win"
    np.testing.assert_array_equal(d_e[s0], d_e[s0 + 1])
    np.testing.assert_allclose(d_e[s0], grads(geo, alone)[2][s0],
                               rtol=RTOL, atol=ATOL)


def test_csr_aggregate_gives_tied_slots_the_full_g():
    """Dyadic inputs (multiples of 1/8): two slots of one receiver with the
    same sender and the same edge features tie exactly, and both packages
    give each the full g: each tied slot's d_e equals what it takes when
    its twin is emptied."""
    case = _tied_pair()
    for fn in (_port_grads, _jax_grads):
        _assert_tied_pair_takes_the_full_g(fn, *case)


# -- the operand the card's backward rebuilds from the node projection ----

def _operands(fn, a, geo, dyadic_seed=None):
    """`fn` (ca._slot_operands or ca.projected_operands) on case `a`, on
    dyadic inputs (multiples of 1/8) when `dyadic_seed` is given, and the
    plain forward's maxima."""
    if dyadic_seed is not None:
        rng = np.random.default_rng(dyadic_seed)
        a = dict(a, **{k: (rng.integers(-4, 5, a[k].shape) * 0.125
                           ).astype(np.float32) for k in _DIFF})
    x, w_s, e_t, w_e = ca.csr_operands(
        *(torch.from_numpy(np.ascontiguousarray(a[k]))
          for k in ("x", "w_s", "e_t", "w_e")))
    lay = [torch.from_numpy(a[k]) for k in ("senders", "recv", "blocks")]
    kw = dict(node_block=geo["node_block"], edge_tile=geo["edge_tile"])
    ops = fn(x, w_s, e_t, w_e, *lay, geo["n"], kw["node_block"],
             kw["edge_tile"])
    _, inner = ca.csr_fwd_plain(x, w_s, e_t, w_e, *lay,
                                torch.zeros((geo["n"], w_s.shape[1])),
                                emit_inner=True, **kw)
    return ops, inner


@pytest.mark.parametrize("case", ["random", "hub", "odd_widths", "h450"])
def test_projected_operand_routes_the_slots_of_the_per_slot_operand(case):
    """On dyadic inputs, where every sum is exact in any order, the operand
    rebuilt from the node projection (y_s[sender] + e_t @ w_e) equals the
    per-slot operand of `_slot_operands` and routes exactly its slots
    against the forward's maxima; the maxima route at least one slot."""
    geo, a = _agg_setup(seed=23, hub=case == "hub",
                        widths=None if case in ("random", "hub") else (21, 5),
                        h=450 if case == "h450" else 32)
    (x_g, op, rc, valid), inner = _operands(ca._slot_operands, a, geo, 29)
    (x_p, op_p, rc_p, valid_p), _ = _operands(ca.projected_operands, a, geo,
                                              29)
    assert torch.equal(valid, valid_p) and torch.equal(rc, rc_p)
    assert torch.equal(x_g, x_p)
    torch.testing.assert_close(op_p, op, rtol=0, atol=0)
    has = inner > da._NEG / 2
    z = torch.where(has, inner, 0.0)
    routed = valid[:, None] & da._routes(op, z[rc])
    routed_p = valid_p[:, None] & da._routes(op_p, z[rc_p])
    assert torch.equal(routed, routed_p)
    hits = torch.zeros_like(inner).index_add_(0, rc, routed.float())
    assert bool((hits[has] >= 1).all())


def _projected_grads(geo, a, ssum=True):
    """_port_grads with the backward on the projected operand."""
    with mock.patch.object(ca, "csr_bwd",
                           smoke.without_landing(ca.csr_bwd_projected_plain)):
        return _port_grads(geo, a, ssum)


@pytest.mark.parametrize("case", ["random", "hub", "odd_widths", "h450"])
def test_projected_backward_gradients_match_jax(case):
    """The five gradients through CsrAggregateFn with the backward taking
    the operand rebuilt from the node projection (the card's design, in
    plain torch) against the JAX package's custom VJP in interpret mode."""
    geo, a = _agg_setup(seed=17, hub=case == "hub",
                        widths=None if case in ("random", "hub") else (21, 5),
                        h=450 if case == "h450" else 32)
    got = _projected_grads(geo, a)
    for name, u, v in zip(_DIFF, got, _jax_grads(geo, a)):
        assert u.shape == v.shape, name
        np.testing.assert_allclose(u, v, rtol=RTOL, atol=ATOL, err_msg=name)
    assert np.abs(got[2]).max() > 0


def test_projected_backward_gives_tied_slots_the_full_g():
    """The tied-slot case of the full-g rule on the projected operand."""
    _assert_tied_pair_takes_the_full_g(_projected_grads, *_tied_pair())


def test_csr_fwd_plain_masks_empty_slots_by_receiver():
    """Empty slots point at edge 0 (real features): only the receiver -1
    marks them. A huge edge feature there must not leak into the max."""
    geo, a = _agg_setup()
    empty = np.flatnonzero(a["recv"] < 0)
    assert empty.size
    base = _port_call(geo, a)
    a = dict(a, e_t=a["e_t"].copy())
    a["e_t"][empty] = 1e6
    torch.testing.assert_close(_port_call(geo, a), base, rtol=0, atol=0)


def test_csr_aggregate_needs_the_landing_for_grad():
    geo, a = _agg_setup()
    leaves = [torch.from_numpy(np.ascontiguousarray(a[k])) for k in _DIFF]
    leaves[2].requires_grad_(True)
    with pytest.raises(ValueError, match="landing"):
        _port_call(geo, a, leaves)
    with torch.no_grad():        # serving needs no landing
        _port_call(geo, a, leaves)


def test_csr_landing_refuses_an_unsorted_tiling():
    with pytest.raises(ValueError, match="sorted"):
        ss.csr_landing(np.arange(4), np.array([0, 2, -1, 1]), 3)


def test_csr_wrappers_refuse_cpu_tensors():
    """The kernels' wrappers check their inputs before they build or
    launch: they never fall back to the plain versions."""
    geo, a = _agg_setup()
    x, w_s, e_t, w_e = ca.csr_operands(
        *(torch.from_numpy(a[k]) for k in ("x", "w_s", "e_t", "w_e")))
    lay = [torch.from_numpy(a[k]) for k in ("senders", "recv", "blocks")]
    node = torch.zeros((geo["n"], a["w_s"].shape[1]))
    kw = dict(node_block=geo["node_block"], edge_tile=geo["edge_tile"])
    with pytest.raises(ValueError, match="CUDA"):
        ca.csr_fwd_cuda(x.bfloat16(), w_s.bfloat16(), e_t, w_e, *lay, node,
                        **kw)
    with pytest.raises(ValueError, match="CUDA"):
        ca.csr_bwd_cuda(x.bfloat16(), w_s.bfloat16(), e_t, w_e, *lay, node,
                        node, **kw)


def test_csr_operands_keep_the_edge_side_float32():
    """v2's contract: x and w_s in the gather dtype (float32 on the CPU, as
    in interpret mode; bf16 on the card), e_t and w_e float32 always."""
    x, w_s, e_t, w_e = ca.csr_operands(
        torch.zeros(4, 5), torch.zeros(5, 3), torch.zeros(6, 3, dtype=
                                                          torch.bfloat16),
        torch.zeros(3, 3))
    assert x.shape == (4, 8) and w_s.shape == (8, 3)
    assert e_t.shape == (6, 8) and w_e.shape == (8, 3)
    assert e_t.dtype == w_e.dtype == x.dtype == torch.float32


def test_csr_fwd_smem_at_the_flagship_geometry():
    """The gather-max's shared memory at the flagship CSR geometry (256-node
    blocks, d_e 16): the [256 x 65] accumulator of ordered keys and the
    float32 W_e slice [16 x 68], one block an SM."""
    assert ca.fwd_smem_bytes(16, 256) == 256 * 65 * 4 + 16 * 68 * 4
    assert ca.fwd_smem_bytes(16, 256) <= da._MAX_SMEM


@pytest.mark.parametrize("node_block,fits", [(256, True), (512, True),
                                             (885, True), (886, False),
                                             (1024, False)])
def test_csr_fwd_refuses_a_node_block_past_shared_memory(node_block, fits):
    """The forward's wrapper refuses, before it builds or launches
    anything, a node block (RADARGNN_FUSED_NODE_BLOCK) whose accumulator
    does not fit a block's shared memory (at d_e 8: 885 nodes fit, 886 do
    not); one that fits goes on to the device checks (a CPU tensor is
    refused there)."""
    geo, a = _agg_setup()
    x, w_s, e_t, w_e = ca.csr_operands(
        *(torch.from_numpy(a[k]) for k in ("x", "w_s", "e_t", "w_e")))
    lay = [torch.from_numpy(a[k]) for k in ("senders", "recv", "blocks")]
    node = torch.zeros((geo["n"], a["w_s"].shape[1]))
    match = "CUDA" if fits else "shared memory"
    assert (ca.fwd_smem_bytes(e_t.shape[1], node_block)
            <= da._MAX_SMEM) == fits
    with pytest.raises(ValueError, match=match):
        ca.csr_fwd_cuda(x.bfloat16(), w_s.bfloat16(), e_t, w_e, *lay, node,
                        node_block=node_block, edge_tile=geo["edge_tile"])


def _case(case, seed):
    return _agg_setup(seed=seed, hub=case == "hub",
                      widths=None if case in ("random", "hub") else (21, 5),
                      h=450 if case == "h450" else 32)


@pytest.mark.parametrize("case", ["random", "hub", "odd_widths", "h450"])
def test_per_slot_and_projected_operands_agree(case):
    """On real-valued inputs the projected operand (y_s[sender] + e_t @
    w_e, which the forward and the backward kernels form) and the TPU
    kernel's per-slot operand (x[sender] @ w_s + e_t @ w_e) are the same
    function: they agree to float32 summation order, 1e-6 of the scale,
    and so do the forwards on them."""
    geo, a = _case(case, 61)
    (x_g, op, rc, valid), inner = _operands(ca._slot_operands, a, geo)
    (x_p, op_p, rc_p, valid_p), inner_p = _operands(ca.projected_operands,
                                                    a, geo)
    assert torch.equal(valid, valid_p) and torch.equal(rc, rc_p)
    assert torch.equal(x_g, x_p)
    scale = float(op.abs().max())
    assert float((op_p - op)[valid].abs().max()) <= 1e-6 * scale
    has = inner > da._NEG / 2
    assert torch.equal(has, inner_p > da._NEG / 2)
    assert float((inner_p - inner)[has].abs().max()) <= 1e-6 * scale


@pytest.mark.parametrize("case", ["random", "hub", "odd_widths", "h450"])
def test_projected_backward_routes_every_nonempty_receiver(case):
    """On real-valued inputs, against the maxima of the plain forward
    (`csr_fwd_plain`, the projected form), the backward's routing on the
    projected operand gives every non-empty (receiver, column) at least
    one slot: no gradient is lost."""
    geo, a = _case(case, 62)
    ops, inner = _operands(ca.projected_operands, a, geo)
    has = inner > da._NEG / 2
    d_op = ca.routed_d_op(ops, torch.where(has, inner, 0.0), has.float())
    _, _, rc, valid = ops
    assert not d_op[~valid].any()
    hits = torch.zeros_like(inner).index_add_(0, rc, (d_op != 0).float())
    assert bool((hits[has] >= 1).all())
    assert not hits[~has].any()


@pytest.mark.parametrize("case", ["random", "hub", "odd_widths", "h450"])
def test_projected_backward_with_the_forwards_projection(case):
    """The projected backward and forward given the forward's node
    projection y_s return, bit for bit, what they return when they project
    for themselves."""
    geo, a = _case(case, 63)
    x, w_s, e_t, w_e = ca.csr_operands(
        *(torch.from_numpy(np.ascontiguousarray(a[k]))
          for k in ("x", "w_s", "e_t", "w_e")))
    lay = [torch.from_numpy(a[k]) for k in ("senders", "recv", "blocks")]
    kw = dict(node_block=geo["node_block"], edge_tile=geo["edge_tile"])
    y_s = da.dense_proj(x, w_s)
    offset = torch.from_numpy(a["offset"])
    out, inner = ca.csr_fwd_plain(x, w_s, e_t, w_e, *lay, offset,
                                  emit_inner=True, **kw)
    out_y, inner_y = ca.csr_fwd_plain(x, w_s, e_t, w_e, *lay, offset,
                                      emit_inner=True, y_s=y_s, **kw)
    assert torch.equal(out, out_y) and torch.equal(inner, inner_y)
    has = inner > da._NEG / 2
    g = torch.from_numpy(np.random.default_rng(64).normal(
        size=inner.shape).astype(np.float32))
    args = (x, w_s, e_t, w_e, *lay, torch.where(has, inner, 0.0),
            torch.where(has, g, 0.0))
    for u, v in zip(ca.csr_bwd_projected_plain(*args, **kw),
                    ca.csr_bwd_projected_plain(*args, y_s=y_s, **kw)):
        assert torch.equal(u, v)


def test_csr_aggregate_hands_its_projection_to_the_backward():
    """CsrAggregateFn projects once: its forward gathers y_s = x @ w_s and
    its backward receives that same tensor (the card's backward launches
    no projection of its own)."""
    geo, a = _agg_setup(seed=65)
    seen = {}
    plain = ca.csr_bwd

    def spy(x_c, w_s_c, *args, y_s=None, **kw):
        seen["y_s"], seen["x"], seen["w_s"] = y_s, x_c, w_s_c
        return plain(x_c, w_s_c, *args, y_s=y_s, **kw)

    with mock.patch.object(ca, "csr_bwd", spy):
        _port_grads(geo, a)
    assert seen["y_s"] is not None
    assert torch.equal(seen["y_s"],
                       da.dense_proj_plain(seen["x"], seen["w_s"]))


def _arch_kw(dtype="float32", bn=False, conv="MPNNConv"):
    return dict(
        node_feature_dimension=5, edge_feature_dimension=2,
        conv_layer_dimensions=[32, 24],
        classification_head_layer_dimensions=[16, 6],
        regression_head_layer_dimensions=[8, 5],
        initial_node_feature_embedding=True,
        initial_edge_feature_embedding=True,
        node_feature_embedding_layer_dimensions=[16, 24],
        edge_feature_embedding_layer_dimensions=[4, 8],
        conv_layer_type=conv, batch_norm_in_mlps=bn, compute_dtype=dtype,
        assume_sorted_edges=True, use_fused_aggregation=True,
        fused_tiling="csr")


def _model_pair(dtype="float32", bn=False, conv="MPNNConv", seed=0):
    """A JAX DetNet and the port's with the same weights, and the same
    kNN batch from both loaders under the CSR tiling at the small
    geometry."""
    kw = _arch_kw(dtype, bn, conv)
    j_arch = jcfg.GNNArchitectureConfig(**kw)
    t_arch = tcfg.GNNArchitectureConfig(**kw)
    assert len(tlayers.fused_csr_tiling(t_arch, k=20)) == 2
    js, ts = _samples("knn")
    max_edges = _edge_bucket(js)
    jb = jbatch.stack_samples(js, max_nodes=160, bg_index=5,
                              max_edges=max_edges, csr_tiling=SPEC)
    tb = tbatch.stack_samples(ts, max_nodes=160, bg_index=5,
                              max_edges=max_edges, csr_tiling=SPEC,
                              device="cpu")
    assert tb.flat_tiling().win is None
    j_model, variables = create_detnet_state(j_arch, jax.random.key(seed),
                                             jb)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    t_model = DetNet(t_arch, device="cpu", seed=1)
    t_model.load_state_dict(weights.from_jax_variables(variables))
    return (j_model, variables, jb), (t_model, tb)


@pytest.mark.parametrize("dtype,conv,tol", [
    ("float32", "MPNNConv", 1e-4),
    ("float32", "RadarPointGNNConv", 1e-4),
    ("bfloat16", "MPNNConv", 2e-2),
])
def test_csr_predictor_matches_jax(dtype, conv, tol):
    """Probabilities and boxes served on kNN graphs under the CSR tiling.
    With bf16 compute a float32 summation difference can flip one bf16
    rounding of a next-layer input (2^-8 relative)."""
    (j_model, variables, jb), (t_model, tb) = _model_pair(dtype, conv=conv)
    want = JPredictor(j_model, variables, [jb], verbose=False).predict()
    launches = ca.csr_fwd_cuda.launches
    got = Predictor(t_model, [tb], verbose=False).predict()
    assert ca.csr_fwd_cuda.launches == launches
    for key in ("class_probability_prediction", "bounding_box_predictions"):
        assert len(got[0][key]) == len(want[0][key]) == 2
        for g, w in zip(got[0][key], want[0][key]):
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=key)


def _train_kw():
    return dict(dataset="radarscenes", learning_rate=1e-3, epochs=2,
                batch_size=2, shuffle=False, bg_index=5, bb_loss_weight=0.5,
                regularization_strength=5e-6, adapt_orientation_angle=True,
                exponential_lr_decay_factor=0.95)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_csr_train_steps_match_jax(dtype):
    """Two Trainer steps under the CSR tiling, from the same weights: the
    losses (float32: rtol 1e-4 / atol 1e-5 after one step, 1e-3 / 1e-4
    after two, as tests/test_torch_trainer.py; bf16: 2e-2), and in float32
    the parameters after step 2 to 2·lr (Adam may step a weight whose
    gradient is within rounding of 0 either way)."""
    (j_model, variables, jb), (t_model, tb) = _model_pair(dtype, bn=True)
    jt = JTrainer(jcfg.TrainingConfig(**_train_kw()), j_model, variables)
    tt = Trainer(tcfg.TrainingConfig(**_train_kw()), t_model)
    step = jax.jit(jt.train_step_fn)
    s1, l1 = step(jt.state, jb)
    s2, l2 = step(s1, jb)
    got = [[float(v) for v in tt.train_step(tb)] for _ in range(2)]
    if dtype == "bfloat16":
        for g, w in zip(got, (l1, l2)):
            np.testing.assert_allclose(g, np.asarray(w), rtol=2e-2)
        return
    np.testing.assert_allclose(got[0], np.asarray(l1), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got[1], np.asarray(l2), rtol=1e-3, atol=1e-4)
    back = weights.to_jax_variables(tt.model.state_dict())["params"]
    flat_g = jax.tree_util.tree_flatten_with_path(back)[0]
    flat_w = jax.tree_util.tree_flatten_with_path(
        jax.device_get(s2.params))[0]
    for (path, u), (_, v) in zip(flat_g, flat_w):
        np.testing.assert_allclose(u, np.asarray(v), rtol=0, atol=2e-3,
                                   err_msg=str(path))
