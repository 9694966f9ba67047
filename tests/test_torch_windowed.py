"""The port's windowed fused path (radargnn_tpu_torch: ops.windowed_tiles,
the windowed branch of graph.batch, ops.windowed_aggregate, and DetNet /
Predictor / Trainer on radius graphs) against the JAX package.

The host tilers are numpy in both packages, so their arrays must be
identical. On the CPU the kernel wrappers take their plain PyTorch
versions; the JAX side runs its Pallas kernels in interpret mode, set up
as tests/test_pallas.py's windowed (v3) tests set it up. Both compute in
float32 there, so the aggregate and its six gradients agree to float32
summation order (rtol/atol 1e-4, the tolerance of the JAX package's own
kernel tests); the model and the trainer to the tolerances of
tests/test_torch_detnet.py and tests/test_torch_trainer.py (1e-4 in
float32, 2e-2 with bf16 compute). The CUDA kernels themselves run only on
the card (tests/test_torch_gpu.py)."""

import dataclasses

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
from radargnn_tpu_torch import weights
from radargnn_tpu_torch.data.synthetic import DEFAULT_GRAPH_CONFIG as T_GRAPH
from radargnn_tpu_torch.data.synthetic import make_samples as t_make_samples
from radargnn_tpu_torch.graph import batch as tbatch
from radargnn_tpu_torch.models import layers as tlayers
from radargnn_tpu_torch.models.detnet import DetNet
from radargnn_tpu_torch.ops import segment_sum as ss
from radargnn_tpu_torch.ops import windowed_aggregate as wa
from radargnn_tpu_torch.ops import windowed_tiles as wt
from radargnn_tpu_torch.postprocess.inference import Predictor
from radargnn_tpu_torch.train.trainer import Trainer

_DIFF = ("x", "w_s", "e_t", "w_e", "offset", "e_ovf")
RTOL = ATOL = 1e-4
RUN_CAPS = [None, 1, 2, 4]


def _random_graph(seed, n=96, e=500):
    """tests/test_pallas.py's windowed case: uniform random edges, 10 %
    masked."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n, e).astype(np.int32),
            rng.integers(0, n, e).astype(np.int32), rng.random(e) < 0.9, n)


def _radius_config(package_graph, r):
    cfg = dataclasses.replace(
        package_graph, graph_construction_algorithm="radius",
        graph_construction_settings={"k": 20, "r": r})
    cfg.__post_init__()
    return cfg


def _radius_graph(seed):
    """A Morton-ordered radius graph with hub receivers (r = 18 m at 150
    points, tests/test_pallas.py's hub case)."""
    s = t_make_samples(num_frames=1, num_points=150, seed=seed,
                       graph_config=_radius_config(T_GRAPH, 18.0))[0]
    s = tbatch.morton_sort_sample(s)
    return s.senders, s.receivers, np.ones(s.num_edges, bool), s.num_nodes


def _graph(kind, seed):
    return _random_graph(seed) if kind == "random" else _radius_graph(seed)


@pytest.mark.parametrize("run_cap", RUN_CAPS)
@pytest.mark.parametrize("kind", ["random", "radius"])
def test_windowed_tilers_match_jax(kind, run_cap):
    """prepare_windowed_csr_tiles (and under it prepare_csr_tiles or the
    spread tiler with its greedy fallback) and tile_roll_passes give the
    JAX package's arrays, dtype for dtype."""
    send, recv, mask, n = _graph(kind, 31 + (run_cap or 0))
    if kind == "radius":
        assert np.bincount(recv, minlength=n).max() > 20, "want hubs"
    node_block, edge_tile, wb = 16, 32, 2
    kw = dict(ovf_budget=-(-len(send) // edge_tile) * edge_tile,
              run_cap=run_cap)
    total = -(-len(send) // edge_tile) + -(-n // node_block) + 2
    for tt in (None, total):
        got = wt.prepare_windowed_csr_tiles(send, recv, mask, n, node_block,
                                            edge_tile, wb, tt, **kw)
        want = jpk.prepare_windowed_csr_tiles(send, recv, mask, n,
                                              node_block, edge_tile, wb, tt,
                                              **kw)
        for name, g, w in zip(("perm", "tile_blocks", "padded_recv",
                               "senders_local", "tile_win", "ovf_idx"),
                              got, want):
            assert g.dtype == w.dtype, name
            np.testing.assert_array_equal(g, w, err_msg=name)
        np.testing.assert_array_equal(
            wt.tile_roll_passes(got[2], edge_tile),
            jpk.tile_roll_passes(want[2], edge_tile))
    if run_cap is not None:
        got = wt.prepare_spread_csr_tiles(recv, mask, n, node_block,
                                          edge_tile, run_cap)
        want = jpk.prepare_spread_csr_tiles(recv, mask, n, node_block,
                                            edge_tile, run_cap)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_spread_tiler_greedy_fallback_matches_jax(monkeypatch):
    """A block whose round-robin layout overfills a tile takes the greedy
    packer (pallas_kernels.py:325-351): receivers of in-degree 4 and 1 in
    turn, run cap 4, so the round robin puts every 4-chunk in one of the
    two 32-slot tiles (48 edges)."""
    deg = np.where(np.arange(24) % 2 == 0, 4, 1)
    recv = np.repeat(np.arange(24), deg).astype(np.int32)
    mask = np.ones(len(recv), bool)
    fell_back = []
    vectorized = wt._spread_place_vectorized

    def spy(*args):
        placed = vectorized(*args)
        fell_back.append(placed is None)
        return placed

    monkeypatch.setattr(wt, "_spread_place_vectorized", spy)
    got = wt.prepare_spread_csr_tiles(recv, mask, 32, 32, 32, 4)
    want = jpk.prepare_spread_csr_tiles(recv, mask, 32, 32, 32, 4)
    assert fell_back == [True]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _samples(kind, num_frames=2, seed=5):
    """The same frames from both packages: radius graphs with hubs, or
    kNN graphs (k 20)."""
    if kind == "radius":
        jg, tg = _radius_config(J_GRAPH, 18.0), _radius_config(T_GRAPH, 18.0)
    else:
        jg, tg = J_GRAPH, T_GRAPH
    kw = dict(num_frames=num_frames, num_points=150, seed=seed)
    return j_make_samples(graph_config=jg, **kw), \
        t_make_samples(graph_config=tg, **kw)


def _bucket(samples):
    return 160, -(-max(s.num_edges for s in samples) // 64) * 64


@pytest.mark.parametrize("run_cap", RUN_CAPS)
@pytest.mark.parametrize("empty", [False, True])
def test_windowed_stack_samples_match_jax(run_cap, empty):
    """pad_sample / stack_samples under the windowed tiling: every batch
    array, the geometry (roll passes included), the flat tiling and the
    sender landing over it; `empty` adds a sample without nodes, as the
    JAX loader pads short batches (tests/test_pallas.py:640)."""
    js, ts = _samples("radius")
    if empty:
        js, ts = js[:1] + [_empty(js[0])], ts[:1] + [_empty(ts[0])]
    max_nodes, max_edges = _bucket(js)
    spec = (32, 64, 2, 0.9) + ((run_cap,) if run_cap else ())
    jb = jbatch.stack_samples(js, max_nodes=max_nodes, bg_index=5,
                              max_edges=max_edges, csr_tiling=spec)
    tb = tbatch.stack_samples(ts, max_nodes=max_nodes, bg_index=5,
                              max_edges=max_edges, csr_tiling=spec,
                              device="cpu")
    for name, t in tb.tensors().items():
        j = np.asarray(getattr(jb, name))
        assert t.numpy().dtype == j.dtype, name
        np.testing.assert_array_equal(t.numpy(), j, err_msg=name)
    assert tb.tile_geometry == jb.tile_geometry
    jt, tt = jb.flat_tiling(), tb.flat_tiling()
    for name in ("senders", "receivers", "blocks", "edge_feat"):
        np.testing.assert_array_equal(getattr(tt, name).numpy(),
                                      np.asarray(getattr(jt, name)),
                                      err_msg=name)
    for i, (a, b) in enumerate(zip(tt.win, jt.win)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=f"win[{i}]")
    assert (tt.node_block, tt.edge_tile, tt.roll_passes, tt.dense) == \
        (jt.node_block, jt.edge_tile, jt.roll_passes, jt.dense)
    # the landing lists every valid slot (by its window sender) and every
    # valid overflow row, grouped by sender
    order, row_ptr = (a.numpy() for a in tt.landing)
    sloc, t_win, _, ovf_s, ovf_r, _ = (np.asarray(a) for a in tt.win)
    slot_send = np.where(sloc >= 0, np.repeat(t_win * 32, 64) + sloc, -1)
    send = np.concatenate([slot_send, np.where(ovf_r >= 0, ovf_s, -1)])
    assert sorted(order.tolist()) == np.flatnonzero(send >= 0).tolist()
    seg = np.repeat(np.arange(len(row_ptr) - 1), np.diff(row_ptr))
    np.testing.assert_array_equal(send[order], seg)
    np.testing.assert_array_equal(
        slot_send[sloc >= 0], np.asarray(jt.senders)[sloc >= 0])


def _empty(sample):
    return type(sample)(
        node_feat=sample.node_feat[:0], edge_feat=sample.edge_feat[:0],
        senders=sample.senders[:0], receivers=sample.receivers[:0],
        labels=sample.labels[:0], boxes=sample.boxes[:0],
        pos=sample.pos[:0], vel=sample.vel[:0])


def test_roll_passes_bound_matches_jax():
    js, ts = _samples("radius")
    for edge_tile in (8, 64, 512):
        assert tbatch.roll_passes_bound(ts, edge_tile) == \
            jbatch.roll_passes_bound(js, edge_tile)


def _agg_setup(seed=31, run_cap=None, widths=None):
    """tests/test_pallas.py's windowed aggregate case (96 nodes, 500 random
    edges, 16-node blocks, 32-slot tiles, 2-block windows), its tiling from
    the port's tiler, optional odd widths (d_in, d_e)."""
    send, recv, mask, n = _random_graph(seed)
    rng = np.random.default_rng(seed + 100)
    d_in, de, h = 24, 8, 32
    nb, et, wb = 16, 32, 2
    a = dict(x=rng.normal(size=(n, d_in)).astype(np.float32),
             w_s=(rng.normal(size=(d_in, h)) * 0.3).astype(np.float32),
             w_e=(rng.normal(size=(de, h)) * 0.3).astype(np.float32),
             offset=rng.normal(size=(n, h)).astype(np.float32))
    e_feat = rng.normal(size=(len(send), de)).astype(np.float32)
    (perm, blocks, precv, sloc, t_win, ovf_idx) = \
        wt.prepare_windowed_csr_tiles(send, recv, mask, n, nb, et, wb,
                                      ovf_budget=-(-len(send) // et) * et,
                                      run_cap=run_cap)
    ovf = ovf_idx >= 0
    o = np.maximum(ovf_idx, 0)
    a.update(e_t=e_feat[perm],
             e_ovf=np.where(ovf[:, None], e_feat[o], 0.0).astype(np.float32),
             recv=precv, blocks=blocks, tile_win=t_win, sloc=sloc,
             pmask=jpk.window_part_mask(t_win, -(-n // nb), wb),
             ovf_s=np.where(ovf, send[o], 0).astype(np.int32),
             ovf_r=np.where(ovf, recv[o], -1).astype(np.int32))
    if widths is not None:
        d, dde = widths
        a.update(x=a["x"][:, :d], w_s=a["w_s"][:d], w_e=a["w_e"][:dde],
                 e_t=a["e_t"][:, :dde], e_ovf=a["e_ovf"][:, :dde])
    geo = dict(n=n, node_block=nb, edge_tile=et, wb=wb,
               roll=None if run_cap is None else (run_cap - 1).bit_length())
    return geo, a


_LAYOUT = ("recv", "blocks", "tile_win", "sloc")


def _jax_fused(geo):
    return jpk.make_fused_hoisted_aggregate_v3(
        geo["n"], geo["node_block"], geo["edge_tile"], geo["wb"],
        roll_passes=geo["roll"])


def _jax_consts(a):
    return tuple(map(jnp.asarray, (a["recv"], a["blocks"], a["tile_win"],
                                   a["sloc"], a["pmask"], a["ovf_s"],
                                   a["ovf_r"])))


def _port_call(geo, a, leaves=None, landing=None):
    t = {k: torch.from_numpy(np.ascontiguousarray(a[k]))
         for k in _DIFF + _LAYOUT + ("ovf_s", "ovf_r")}
    diff = leaves if leaves is not None else [t[k] for k in _DIFF]
    return wa.windowed_aggregate(
        *diff, *(t[k] for k in _LAYOUT), t["ovf_s"], t["ovf_r"],
        node_block=geo["node_block"], edge_tile=geo["edge_tile"],
        landing=landing)


def _landing(geo, a):
    order, row_ptr = ss.sender_landing(
        a["sloc"], a["tile_win"], a["ovf_s"], a["ovf_r"] >= 0,
        slots_per_tile=geo["edge_tile"], node_block=geo["node_block"],
        num_nodes=geo["n"])
    return ss.SenderLanding(torch.from_numpy(order),
                            torch.from_numpy(row_ptr))


def _port_grads(geo, a):
    leaves = [torch.from_numpy(np.ascontiguousarray(a[k])).requires_grad_()
              for k in _DIFF]
    out = _port_call(geo, a, leaves, _landing(geo, a))
    return [g.numpy() for g in torch.autograd.grad((out ** 2).sum(), leaves)]


def _jax_grads(geo, a):
    fused, consts = _jax_fused(geo), _jax_consts(a)
    grads = jax.grad(lambda *ar: (fused(*ar, *consts) ** 2).sum(),
                     argnums=tuple(range(6)))(
        *(jnp.asarray(a[k]) for k in _DIFF))
    return [np.asarray(g) for g in grads]


@pytest.mark.parametrize("run_cap", [None, 4])
@pytest.mark.parametrize("widths", [None, (21, 5)])
def test_windowed_aggregate_matches_jax_interpret(run_cap, widths):
    """The forward against make_fused_hoisted_aggregate_v3 (interpret
    mode), with overflow; `widths` not multiples of 8 reach the kernels
    zero-padded."""
    geo, a = _agg_setup(run_cap=run_cap, widths=widths)
    assert (a["ovf_r"] >= 0).sum() > 20, "the case should overflow"
    want = np.asarray(_jax_fused(geo)(*(jnp.asarray(a[k]) for k in _DIFF),
                                      *_jax_consts(a)))
    launches = wa.windowed_fwd_cuda.launches
    got = _port_call(geo, a)
    assert wa.windowed_fwd_cuda.launches == launches   # CPU: no launch
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got.numpy() == 0, want == 0)


@pytest.mark.parametrize("run_cap", [None, 2])
@pytest.mark.parametrize("widths", [None, (21, 5)])
def test_windowed_aggregate_gradients_match_jax(run_cap, widths):
    """The six gradients of (out**2).sum() through WindowedAggregateFn and
    through the JAX package's custom VJP (interpret mode)."""
    geo, a = _agg_setup(seed=37, run_cap=run_cap, widths=widths)
    launches = (wa.windowed_fwd_cuda.launches, wa.windowed_bwd_cuda.launches,
                ss.segment_sum_csr_cuda.launches)
    got = _port_grads(geo, a)
    assert launches == (wa.windowed_fwd_cuda.launches,
                        wa.windowed_bwd_cuda.launches,
                        ss.segment_sum_csr_cuda.launches)
    for name, u, v in zip(_DIFF, got, _jax_grads(geo, a)):
        assert u.dtype == np.float32 and u.shape == v.shape, name
        np.testing.assert_allclose(u, v, rtol=RTOL, atol=ATOL, err_msg=name)
    assert np.abs(got[5]).max() > 0, "the overflow path should take g"


def test_windowed_aggregate_gives_tied_slots_the_full_g():
    """Dyadic inputs (multiples of 1/4 and 1/8): two slots of one receiver
    with the same sender and the same edge features tie exactly, and both
    packages give each the full g: each tied slot's d_e equals what it
    takes when its twin is emptied."""
    geo, a = _agg_setup(seed=41)
    rng = np.random.default_rng(5)
    for k in _DIFF:
        a[k] = (rng.integers(-4, 5, a[k].shape) * 0.125).astype(np.float32)
    recv, sloc, et = a["recv"], a["sloc"], geo["edge_tile"]
    s0 = next(i for i in range(len(recv) - 1)
              if recv[i] >= 0 and recv[i] == recv[i + 1]
              and i // et == (i + 1) // et)
    tied = dict(a, sloc=sloc.copy(), e_t=a["e_t"].copy())
    tied["sloc"][s0 + 1] = sloc[s0]
    tied["e_t"][s0 + 1] = tied["e_t"][s0] = 0.5 + np.abs(a["e_t"][s0])
    alone = dict(tied, recv=recv.copy(), sloc=tied["sloc"].copy())
    alone["recv"][s0 + 1] = -1
    alone["sloc"][s0 + 1] = -1
    for fn in (_port_grads, _jax_grads):
        d_e = fn(geo, tied)[2]
        assert np.abs(d_e[s0]).max() > 0, "the tied pair should win"
        np.testing.assert_array_equal(d_e[s0], d_e[s0 + 1])
        np.testing.assert_allclose(d_e[s0], fn(geo, alone)[2][s0],
                                   rtol=RTOL, atol=ATOL)


def test_windowed_fwd_plain_masks_empty_slots_by_receiver():
    """Empty slots point at edge 0 (real features): only the receiver -1
    marks them. A huge edge feature there must not leak into the max."""
    geo, a = _agg_setup()
    empty = np.flatnonzero(a["recv"] < 0)
    assert empty.size
    base = _port_call(geo, a)
    a = dict(a, e_t=a["e_t"].copy())
    a["e_t"][empty] = 1e6
    torch.testing.assert_close(_port_call(geo, a), base, rtol=0, atol=0)


def test_windowed_aggregate_needs_the_landing_for_grad():
    geo, a = _agg_setup()
    leaves = [torch.from_numpy(np.ascontiguousarray(a[k])) for k in _DIFF]
    leaves[1].requires_grad_(True)
    with pytest.raises(ValueError, match="landing"):
        _port_call(geo, a, leaves)
    with torch.no_grad():        # serving needs no landing
        _port_call(geo, a, leaves)


def test_windowed_wrappers_refuse_cpu_tensors():
    """The kernels' wrappers check their inputs before they build or
    launch: they never fall back to the plain versions."""
    geo, a = _agg_setup()
    bf = [torch.from_numpy(np.ascontiguousarray(a[k])).bfloat16()
          for k in ("x", "w_s", "e_t", "w_e")]
    lay = [torch.from_numpy(a[k]) for k in ("recv", "sloc", "tile_win",
                                            "blocks")]
    node = torch.zeros((geo["n"], a["w_s"].shape[1]))
    kw = dict(node_block=geo["node_block"], edge_tile=geo["edge_tile"])
    with pytest.raises(ValueError, match="CUDA"):
        wa.windowed_fwd_cuda(*bf, *lay, node, node, **kw)
    with pytest.raises(ValueError, match="CUDA"):
        wa.windowed_bwd_cuda(*bf, *lay, node, node, **kw)


def test_chunk_rows_divides_the_tile():
    assert [wa.chunk_rows(t) for t in (512, 256, 96, 32, 16)] == \
        [64, 64, 32, 32, 16]


@pytest.mark.parametrize("run_cap", [None, 4])
def test_fused_csr_tiling_windowed_matches_jax(run_cap):
    """fused_tiling "windowed", and "auto" without a kNN degree (radius
    graphs), give the JAX package's loader tuple."""
    for mode in ("windowed", "auto"):
        kw = dict(node_feature_dimension=5, edge_feature_dimension=2,
                  conv_layer_dimensions=[8],
                  classification_head_layer_dimensions=[6],
                  regression_head_layer_dimensions=[5],
                  fused_tiling=mode, fused_run_cap=run_cap)
        got = tlayers.fused_csr_tiling(tcfg.GNNArchitectureConfig(**kw))
        want = jlayers.fused_csr_tiling(jcfg.GNNArchitectureConfig(**kw))
        assert got == want
        assert got[:3] == (tlayers.FUSED_NODE_BLOCK, tlayers.FUSED_EDGE_TILE,
                           tlayers.FUSED_WINDOW_BLOCKS) == (256, 512, 3)


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
        fused_tiling="auto", fused_run_cap=None)


def _spec(t_arch):
    """The port's own windowed spec for a radius graph (no kNN k), at the
    small geometry of tests/test_pallas.py's radius test."""
    spec = tlayers.fused_csr_tiling(t_arch, k=None)
    return (32, 64, 2, 0.9) + spec[4:]


def _model_pair(dtype="float32", bn=False, conv="MPNNConv", seed=0):
    kw = _arch_kw(dtype, bn, conv)
    j_arch = jcfg.GNNArchitectureConfig(**kw)
    t_arch = tcfg.GNNArchitectureConfig(**kw)
    js, ts = _samples("radius")
    max_nodes, max_edges = _bucket(js)
    spec = _spec(t_arch)
    jb = jbatch.stack_samples(js, max_nodes=max_nodes, bg_index=5,
                              max_edges=max_edges, csr_tiling=spec)
    tb = tbatch.stack_samples(ts, max_nodes=max_nodes, bg_index=5,
                              max_edges=max_edges, csr_tiling=spec,
                              device="cpu")
    assert tb.flat_tiling().dense is None
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
def test_windowed_predictor_matches_jax(dtype, conv, tol):
    """Probabilities and boxes served on radius graphs under the windowed
    tiling. With bf16 compute a float32 summation difference can flip one
    bf16 rounding of a next-layer input (2^-8 relative)."""
    (j_model, variables, jb), (t_model, tb) = _model_pair(dtype, conv=conv)
    want = JPredictor(j_model, variables, [jb], verbose=False).predict()
    launches = wa.windowed_fwd_cuda.launches
    got = Predictor(t_model, [tb], verbose=False).predict()
    assert wa.windowed_fwd_cuda.launches == launches
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
def test_windowed_train_steps_match_jax(dtype):
    """Two Trainer steps on radius graphs under the windowed tiling, from
    the same weights: the losses (float32: rtol 1e-4 / atol 1e-5 after one
    step, 1e-3 / 1e-4 after two, as tests/test_torch_trainer.py; bf16:
    2e-2), and in float32 the parameters after step 2 to 2·lr (Adam may
    step a weight whose gradient is within rounding of 0 either way)."""
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
