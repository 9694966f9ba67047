"""bf16 max routing (`fused_bf16_max`) and the dense overflow landing through
the segment sum (`ovf_ssum`) in the port, against the JAX package on the
CPU.

The JAX side runs its Pallas kernels in interpret mode (float32), with
`bf16_max=True` in `make_fused_dense_aggregate` and
`make_fused_hoisted_aggregate_v3`; the port takes its kernels' plain
versions, which set the same routing bits. Under bf16 routing a slot takes
its receiver's whole g where bf16(op) == bf16(inner), so an operand one
float32 rounding away from a bf16 rounding boundary could route in one
package and not the other. The gradient cases therefore use dyadic inputs
(multiples of 1/64, at most 18 significant bits in any product sum), whose
operands are exact in float32 in any order: both packages then round the
same operands, and the gradients agree to float32 summation order (rtol /
atol 1e-4, the strict tests' tolerance). Random real-valued inputs hardly
ever tie in bf16 by construction, so the routed-mass cases build operands
that are distinct in float32 and equal in bf16 (tests/test_pallas.py's
bf16 tie case): k such ties take k·g under bf16 routing and 1·g under
strict routing, in both packages, on the slots and the overflow rows."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radargnn_tpu import configs as jcfg
from radargnn_tpu.data.synthetic import make_samples as j_make_samples
from radargnn_tpu.graph.batch import stack_samples as j_stack
from radargnn_tpu.models.detnet import create_detnet_state
from radargnn_tpu.ops import pallas_kernels as jpk
from radargnn_tpu.train.trainer import Trainer as JTrainer
from radargnn_tpu_torch import configs as tcfg
from radargnn_tpu_torch import weights
from radargnn_tpu_torch.data.synthetic import make_samples as t_make_samples
from radargnn_tpu_torch.graph.batch import stack_samples as t_stack
from radargnn_tpu_torch.models import layers as tlayers
from radargnn_tpu_torch.models.detnet import DetNet
from radargnn_tpu_torch.ops import dense_aggregate as da
from radargnn_tpu_torch.ops import segment_sum as ss
from radargnn_tpu_torch.ops import windowed_aggregate as wa
from radargnn_tpu_torch.ops import windowed_tiles as wt
from radargnn_tpu_torch.train.trainer import Trainer

from host_backends import host_pair, native_cache  # noqa: F401
from test_torch_dense_aggregate import _dense_setup, _port_args
from test_torch_windowed import _agg_setup, _jax_consts

RTOL = ATOL = 1e-4
_DIFF = ("x", "w_s", "e_t", "w_e", "offset", "e_ovf")


def _dyadic(a):
    """The setup's operands rounded to multiples of 1/64 (the edge rows of
    e_t and e_ovf stay equal where they were)."""
    return dict(a, **{k: np.round(a[k] * 64.0) / 64.0
                      for k in ("x", "w_s", "w_e", "e_t", "e_ovf")})


def _dense_jax_grads(geo, a, bf16_max, ossum=None):
    fused = jpk.make_fused_dense_aggregate(
        geo["n"], geo["K"], geo["r_tile"], geo["node_block"], geo["wb"],
        bf16_max=bf16_max, ovf_ssum=ossum is not None,
        ovf_edge_tile=ossum[3] if ossum is not None else 256)
    consts = tuple(map(jnp.asarray, (a["tile_win"], a["sloc"], a["pmask"],
                                     a["ovf_s"], a["ovf_r"])))
    if ossum is not None:
        consts += tuple(map(jnp.asarray, ossum[:3]))
    grads = jax.grad(lambda *ar: (fused(*ar, *consts) ** 2).sum(),
                     argnums=tuple(range(6)))(
        *(jnp.asarray(a[nm]) for nm in _DIFF))
    return [np.asarray(g) for g in grads]


def _dense_port_grads(geo, a, bf16_max, ovf_landing=None):
    args = list(_port_args(a))
    for i in range(6):
        args[i] = args[i].clone().requires_grad_(True)
    landing = ss.SenderLanding(*(torch.from_numpy(v) for v in (
        ss.sender_landing(a["sloc"], a["tile_win"], a["ovf_s"],
                          a["ovf_r"] >= 0,
                          slots_per_tile=geo["r_tile"] * geo["K"],
                          node_block=geo["node_block"], num_nodes=geo["n"]))))
    out = da.dense_aggregate(*args, r_tile=geo["r_tile"], k=geo["K"],
                             node_block=geo["node_block"], landing=landing,
                             bf16_max=bf16_max, ovf_landing=ovf_landing)
    return [g.numpy() for g in torch.autograd.grad((out ** 2).sum(),
                                                   args[:6])]


def _windowed_jax_grads(geo, a, bf16_max):
    fused = jpk.make_fused_hoisted_aggregate_v3(
        geo["n"], geo["node_block"], geo["edge_tile"], geo["wb"],
        roll_passes=geo["roll"], bf16_max=bf16_max)
    consts = _jax_consts(a)
    grads = jax.grad(lambda *ar: (fused(*ar, *consts) ** 2).sum(),
                     argnums=tuple(range(6)))(
        *(jnp.asarray(a[k]) for k in _DIFF))
    return [np.asarray(g) for g in grads]


def _windowed_port_grads(geo, a, bf16_max):
    t = {k: torch.from_numpy(np.ascontiguousarray(a[k]))
         for k in _DIFF + ("recv", "blocks", "tile_win", "sloc", "ovf_s",
                           "ovf_r")}
    leaves = [t[k].clone().requires_grad_() for k in _DIFF]
    landing = ss.SenderLanding(*(torch.from_numpy(v) for v in (
        ss.sender_landing(a["sloc"], a["tile_win"], a["ovf_s"],
                          a["ovf_r"] >= 0, slots_per_tile=geo["edge_tile"],
                          node_block=geo["node_block"], num_nodes=geo["n"]))))
    out = wa.windowed_aggregate(
        *leaves, t["recv"], t["blocks"], t["tile_win"], t["sloc"],
        t["ovf_s"], t["ovf_r"], node_block=geo["node_block"],
        edge_tile=geo["edge_tile"], landing=landing, bf16_max=bf16_max)
    return [g.numpy() for g in torch.autograd.grad((out ** 2).sum(),
                                                   leaves)]


_LAYOUTS = {
    "dense": (lambda: _dense_setup(seed=3), _dense_port_grads,
              _dense_jax_grads),
    "windowed": (lambda: _agg_setup(seed=5), _windowed_port_grads,
                 _windowed_jax_grads),
}


@pytest.mark.parametrize("layout", ["dense", "windowed"])
def test_bf16_routing_gradients_match_jax(layout):
    """The six gradients under bf16 routing on dyadic inputs, against the
    JAX function with bf16_max=True; bf16 routing moves them away from
    strict routing's (the case has bf16 ties that are not exact ties)."""
    setup, port_grads, jax_grads = _LAYOUTS[layout]
    geo, a = setup()
    a = _dyadic(a)
    got = port_grads(geo, a, True)
    want = jax_grads(geo, a, True)
    for name, u, v in zip(_DIFF, got, want):
        np.testing.assert_allclose(u, v, rtol=RTOL, atol=ATOL, err_msg=name)
    strict = port_grads(geo, a, False)
    np.testing.assert_allclose(strict[2], jax_grads(geo, a, False)[2],
                               rtol=RTOL, atol=ATOL)
    assert np.abs(got[2] - strict[2]).max() > 1.0


def _tie_graph():
    """Two receivers of a 16-node graph: receiver 0 has three in-edges
    whose operands are 1.001, 1.0 and 1.0005 in float32 and 1.0 in bf16
    (edge 0 is the float32 max), receiver 1 two far apart (5 and 2). With
    operand = e_feat (w_s = 0, w_e = ones), on every column."""
    senders = np.array([0, 1, 4, 2, 3], np.int32)
    receivers = np.array([0, 0, 0, 1, 1], np.int32)
    e_feat = np.zeros((5, 8), np.float32)
    e_feat[:, 0] = [1.001, 1.0, 1.0005, 5.0, 2.0]
    return senders, receivers, e_feat


def _edge_mass(d_e_t, d_e_ovf, perm_valid, ovf_idx, num_edges):
    """Each edge's gradient mass from its slot rows and overflow rows."""
    mass = np.zeros(num_edges)
    for slot, edge in perm_valid:
        mass[edge] += d_e_t[slot, 0]
    for row, edge in enumerate(ovf_idx):
        if edge >= 0:
            mass[edge] += d_e_ovf[row, 0]
    return mass


def _tie_mass(layout, bf16_max, package):
    """The routed mass per edge of out.sum() (g = 1 on each of h = 8
    columns) through one package's layout on the tie graph."""
    senders, receivers, e_feat = _tie_graph()
    n, h = 16, 8
    mask = np.ones(5, bool)
    x = np.zeros((n, 8), np.float32)
    w_s = np.zeros((8, h), np.float32)
    w_e = np.zeros((8, h), np.float32)
    w_e[0] = 1.0
    offset = np.zeros((n, h), np.float32)
    if layout == "dense":
        # 2 slots a receiver: receiver 0's third edge spills to overflow
        k, r_tile, nb, wb = 2, 8, 16, 1
        perm, sloc, tile_win, ovf_idx = jpk.prepare_dense_knn_tiles(
            senders, receivers, mask, n, k, r_tile, nb, wb, ovf_budget=16)
        valid = sloc >= 0
        geo = dict(n=n, K=k, r_tile=r_tile, node_block=nb, wb=wb)
        a = dict(sloc=sloc, tile_win=tile_win)
    else:
        et, nb, wb = 16, 16, 1
        (perm, blocks, precv, sloc, tile_win,
         ovf_idx) = wt.prepare_windowed_csr_tiles(
            senders, receivers, mask, n, nb, et, wb, ovf_budget=16)
        valid = precv >= 0
        geo = dict(n=n, node_block=nb, edge_tile=et, wb=wb, roll=None)
        a = dict(recv=precv, blocks=blocks, sloc=sloc, tile_win=tile_win)
    ovf = ovf_idx >= 0
    o = np.maximum(ovf_idx, 0)
    a.update(x=x, w_s=w_s, w_e=w_e, offset=offset, e_t=e_feat[perm],
             e_ovf=np.where(ovf[:, None], e_feat[o], 0.0).astype(np.float32),
             ovf_s=np.where(ovf, senders[o], 0).astype(np.int32),
             ovf_r=np.where(ovf, receivers[o], -1).astype(np.int32),
             pmask=jpk.window_part_mask(tile_win, -(-n // nb), wb))
    setup, port_grads, jax_grads = _LAYOUTS[layout]
    # d((out**2).sum()) = 2 out g: divide by 2 out (out = the max, 1.001 or
    # 5) per receiver to read g's mass; the slots of one receiver share it
    fn = port_grads if package == "port" else jax_grads
    grads = fn(geo, a, bf16_max)
    mass = _edge_mass(grads[2], grads[5],
                      [(s, e) for s, e in enumerate(perm) if valid[s]],
                      np.where(ovf, ovf_idx, -1), 5)
    return mass / (2.0 * np.array([1.001, 1.001, 1.001, 5.0, 5.0]) * h)


@pytest.mark.parametrize("layout", ["dense", "windowed"])
def test_bf16_ties_take_k_times_g(layout):
    """On three bf16-tied edges (one of them an overflow row on the dense
    layout), strict routing gives the float32 max 1·g and bf16 routing
    gives each tied edge the whole g (3·g in all), in both packages; the
    far-apart pair routes to its max either way."""
    for package in ("port", "jax"):
        np.testing.assert_allclose(_tie_mass(layout, False, package),
                                   [1, 0, 0, 1, 0], atol=1e-6,
                                   err_msg=package)
        np.testing.assert_allclose(_tie_mass(layout, True, package),
                                   [1, 1, 1, 1, 0], atol=1e-6,
                                   err_msg=package)


def test_dense_tie_graph_spills_one_tied_edge_to_overflow():
    senders, receivers, _ = _tie_graph()
    *_, ovf_idx = jpk.prepare_dense_knn_tiles(
        senders, receivers, np.ones(5, bool), 16, 2, 8, 16, 1, ovf_budget=16)
    assert sorted(receivers[ovf_idx[ovf_idx >= 0]]) == [0]


def test_routes_rounds_to_nearest_even():
    """The plain bf16 test rounds as astype(bfloat16): 1 + 2^-8 is the tie
    between 1 and 1 + 2^-7 and goes to 1 (even); 1 + 3·2^-9 goes up."""
    op = torch.tensor([1 + 2 ** -8, 1 + 3 * 2 ** -9, 1 + 2 ** -7])
    inner = torch.ones(3)
    assert da._routes(op, inner, True).tolist() == [True, False, False]
    assert jnp.asarray(op.numpy()).astype(jnp.bfloat16).astype(
        jnp.float32).tolist() == [1.0, 1.0078125, 1.0078125]
    assert da._routes(op, inner).tolist() == [False, False, False]


@pytest.mark.parametrize("variable_degree", [True, False])
def test_ovf_ssum_gradients_match_jax(variable_degree):
    """Under ovf_ssum the overflow part of d_x is each row's d_op_o @
    w_s^T summed at its sender over the sender-sorted overflow tiling (the
    segment sum's plain version here, the kernel on the card): the six
    gradients against the JAX function with ovf_ssum=True and its tiling;
    d_x also against the port's own landing without the flag."""
    geo, a = _dense_setup(seed=11, variable_degree=variable_degree)
    n, nb, te_o = geo["n"], geo["node_block"], 32
    valid = a["ovf_r"] >= 0
    assert valid.sum() > 0
    budget = a["ovf_s"].shape[0]
    s_perm, s_blocks, s_send = jpk.prepare_csr_tiles(
        a["ovf_s"], valid, n, nb, te_o, -(-budget // te_o) + n // nb)
    port_tiles = wt.prepare_csr_tiles(a["ovf_s"], valid, n, nb, te_o,
                                      -(-budget // te_o) + n // nb)
    for u, v in zip(port_tiles, (s_perm, s_blocks, s_send)):
        np.testing.assert_array_equal(u, v)
    landing = ss.SenderLanding(*(torch.from_numpy(v) for v in
                                 ss.csr_landing(s_perm, s_send, n)))
    got = _dense_port_grads(geo, a, False, ovf_landing=landing)
    want = _dense_jax_grads(geo, a, False,
                            ossum=(s_perm, s_send, s_blocks, te_o))
    for name, u, v in zip(_DIFF, got, want):
        np.testing.assert_allclose(u, v, rtol=RTOL, atol=ATOL, err_msg=name)
    plain = _dense_port_grads(geo, a, False)
    np.testing.assert_allclose(got[0], plain[0], rtol=RTOL, atol=ATOL)
    for u, v in zip(got[1:], plain[1:]):
        np.testing.assert_array_equal(u, v)


# ---------------------------------------------------------------------------
# DetNet and Trainer under the flags
# ---------------------------------------------------------------------------

K = 20
LR = 1e-3


def _arch_kw(tiling="dense", **extra):
    return dict(dict(
        node_feature_dimension=5, edge_feature_dimension=2,
        conv_layer_dimensions=[32, 24],
        classification_head_layer_dimensions=[16, 6],
        regression_head_layer_dimensions=[8, 5],
        initial_node_feature_embedding=True,
        initial_edge_feature_embedding=True,
        node_feature_embedding_layer_dimensions=[16, 24],
        edge_feature_embedding_layer_dimensions=[4, 8],
        conv_layer_type="MPNNConv", batch_norm_in_mlps=True,
        compute_dtype="float32", assume_sorted_edges=True,
        use_fused_aggregation=True, fused_tiling=tiling,
        fused_overflow_fraction=0.3, fused_run_cap=None), **extra)


def _train_kw():
    return dict(dataset="radarscenes", learning_rate=LR, epochs=1,
                batch_size=2, shuffle=False, bg_index=5, bb_loss_weight=0.5,
                regularization_strength=5e-6, adapt_orientation_angle=True)


def _spec(t_arch):
    spec = tlayers.fused_csr_tiling(t_arch, k=K)
    if isinstance(spec, dict):
        return dict(spec, node_block=64, r_tile=16)
    return (64, 64) + tuple(spec[2:])


@pytest.mark.parametrize("tiling", ["dense", "windowed"])
@pytest.mark.usefixtures("host_pair")
def test_bf16_max_train_steps_match_jax(tiling):
    """Two Trainer steps of a DetNet with fused_bf16_max on frames that
    fill their 256-node bucket (every receiver has in-edges, as in the
    flagship's frames; the JAX package's dense and windowed trainings are
    not finite on frames that leave receivers of the bucket empty, ROADMAP
    C7): the losses against the JAX Trainer's as tests/test_torch_trainer.py
    holds them, and the first step's gradients away from the strict
    routing's."""
    kw = _arch_kw(tiling, fused_bf16_max=True)
    j_arch, t_arch = jcfg.GNNArchitectureConfig(**kw), \
        tcfg.GNNArchitectureConfig(**kw)
    spec = _spec(t_arch)
    bucket = dict(max_nodes=256, bg_index=5, max_edges=256 * K,
                  csr_tiling=spec)
    frames = dict(num_frames=2, num_points=256, seed=0)
    jb = j_stack(j_make_samples(**frames), **bucket)
    tb = t_stack(t_make_samples(**frames), device="cpu", **bucket)
    assert bool(tb.node_mask.all())
    j_model, variables = create_detnet_state(j_arch, jax.random.key(0), jb)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    jt = JTrainer(jcfg.TrainingConfig(**_train_kw()), j_model, variables)
    step = jax.jit(jt.train_step_fn)
    s1, l1 = step(jt.state, jb)
    _, l2 = step(s1, jb)
    assert np.isfinite(np.asarray(l2)).all()

    def port(bf16_max):
        model = DetNet(tcfg.GNNArchitectureConfig(
            **dict(kw, fused_bf16_max=bf16_max)), device="cpu")
        model.load_state_dict(weights.from_jax_variables(variables))
        tt = Trainer(tcfg.TrainingConfig(**_train_kw()), model)
        g1 = [float(v) for v in tt.train_step(tb)]
        grads = torch.cat([p.grad.flatten() for p in model.parameters()])
        g2 = [float(v) for v in tt.train_step(tb)]
        return g1, g2, grads

    g1, g2, grads = port(True)
    np.testing.assert_allclose(g1, np.asarray(l1), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(g2, np.asarray(l2), rtol=1e-3, atol=1e-4)
    _, _, strict = port(False)
    assert not torch.allclose(grads, strict, rtol=1e-3, atol=1e-6)


def test_csr_under_bf16_max_is_strict_bit_for_bit():
    """The CSR path routes strictly under fused_bf16_max, as the JAX
    package's v2 kernels take no bf16 flag: a Trainer step's losses and
    gradients are bitwise the strict run's."""
    results = []
    for bf16_max in (False, True):
        t_arch = tcfg.GNNArchitectureConfig(
            **_arch_kw("csr", fused_bf16_max=bf16_max))
        batch = t_stack(t_make_samples(num_frames=2, num_points=256, seed=0),
                        max_nodes=256, bg_index=5, max_edges=256 * K,
                        csr_tiling=_spec(t_arch), device="cpu")
        model = DetNet(t_arch, device="cpu", seed=3)
        tt = Trainer(tcfg.TrainingConfig(**_train_kw()), model)
        losses = torch.stack(tt.train_step(batch))
        grads = [p.grad.clone() for p in model.parameters()]
        results.append((losses, grads))
    (l0, g0), (l1, g1) = results
    assert torch.equal(l0, l1)
    assert all(torch.equal(u, v) for u, v in zip(g0, g1))


def test_ovf_ssum_detnet_lands_the_overflow_through_the_segment_sum(
        monkeypatch):
    """With OVF_SSUM on and a batch built under it, each conv layer's dense
    backward lands the overflow part of d_x through the segment sum over
    the batch's overflow landing; the gradients stay those of the default
    landing within float32 summation order."""
    kw = _arch_kw("dense")
    t_arch = tcfg.GNNArchitectureConfig(**kw)
    spec = dict(_spec(t_arch), ovf_ssum=True)
    batch = t_stack(t_make_samples(num_frames=2, num_points=256, seed=0),
                    max_nodes=256, bg_index=5, max_edges=256 * K,
                    csr_tiling=spec, device="cpu")
    assert int((batch.ovf_receivers >= 0).sum()) > 0

    def grads():
        model = DetNet(t_arch, device="cpu", seed=3)
        cls, bb = model.forward_batch(batch)
        (cls.square().sum() + bb.square().sum()).backward()
        return [p.grad.clone() for p in model.parameters()]

    base = grads()
    calls = []
    plain = ss.segment_sum_csr

    def spy(a, order, row_ptr, b=None):
        calls.append((tuple(a.shape), order.data_ptr()))
        return plain(a, order, row_ptr, b)

    monkeypatch.setattr(ss, "segment_sum_csr", spy)
    monkeypatch.setattr(tlayers, "OVF_SSUM", True)
    got = grads()
    landing = batch.flat_tiling().ovf_landing.order.data_ptr()
    # conv_1 (input width 32) runs its backward first, then conv_0 (24)
    assert [c for c in calls if c[1] == landing] == [
        ((batch.ovf_senders.numel(), 32), landing),
        ((batch.ovf_senders.numel(), 24), landing)]
    # float32 summation order, relative to the gradients' scale (a bias
    # whose gradient cancels to ~1e-6 carries the others' rounding)
    scale = max(float(v.abs().max()) for v in base)
    for u, v in zip(got, base):
        assert float((u - v).abs().max()) <= 1e-5 * scale
