"""The port's unfused model path against the JAX package on the CPU: the
segment family (`ops.segment`), `SplitPreMLP`, `MPNNConv` and
`RadarPointGNNConv` with a pre-MLP of several layers and the max, mean
and add aggregations, and a DetNet Trainer on such a configuration.

The JAX package's weights cross over through `weights.from_jax_variables`.
Both compute in float32 here (bf16 where stated) and differ in summation
order only: forward values and gradients agree to rtol / atol 1e-5 for a
layer (tests/test_models.py's own torch-parity tolerance), and a Trainer's
losses as tests/test_torch_trainer.py holds them (1e-4 after one step,
1e-3 after two). The fixed-weight oracles are tests/test_models.py's,
run on the port's layers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radargnn_tpu import configs as jcfg
from radargnn_tpu.data.synthetic import make_samples as j_make_samples
from radargnn_tpu.graph.batch import stack_samples as j_stack
from radargnn_tpu.models import layers as jlayers
from radargnn_tpu.models.detnet import create_detnet_state
from radargnn_tpu.models.split_mlp import SplitPreMLP as JSplitPreMLP
from radargnn_tpu.ops import segment as jseg
from radargnn_tpu.train.trainer import Trainer as JTrainer
from radargnn_tpu_torch import configs as tcfg
from radargnn_tpu_torch import weights
from radargnn_tpu_torch.data.synthetic import make_samples as t_make_samples
from radargnn_tpu_torch.graph.batch import stack_samples as t_stack
from radargnn_tpu_torch.models import layers as tlayers
from radargnn_tpu_torch.models.detnet import DetNet
from radargnn_tpu_torch.models.split_mlp import SplitPreMLP
from radargnn_tpu_torch.ops import segment as tseg
from radargnn_tpu_torch.train.trainer import Trainer

from host_backends import host_pair, native_cache  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)


def _graph(seed=0, n=9, e=30, d=5, de=3):
    """A random graph with a masked tail and a node without in-edges."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    senders = rng.integers(0, n, e).astype(np.int32)
    receivers = rng.integers(0, n - 1, e).astype(np.int32)
    edge_attr = rng.normal(size=(e, de)).astype(np.float32)
    mask = np.arange(e) < e - 4
    return x, senders, receivers, edge_attr, mask


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("reducer", ["max", "sum", "add", "mean"])
def test_segment_reduce_matches_jax(reducer, masked):
    rng = np.random.default_rng(1)
    data = rng.normal(size=(40, 6)).astype(np.float32)
    ids = rng.integers(0, 11, 40).astype(np.int32)     # some segments empty
    mask = rng.random(40) < 0.7 if masked else None
    want = jseg.segment_reduce(reducer, jnp.asarray(data), jnp.asarray(ids),
                               12, None if mask is None else jnp.asarray(mask))
    got = tseg.segment_reduce(reducer, torch.from_numpy(data),
                              torch.from_numpy(ids), 12,
                              None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert got.dtype == torch.float32
    # every empty segment is 0
    count = np.bincount(ids[mask] if masked else ids, minlength=12)
    assert (got.numpy()[count == 0] == 0).all()


def test_segment_reduce_refuses_unknown_reducers_like_jax():
    args = (np.zeros((3, 2), np.float32), np.zeros(3, np.int32), 2)
    with pytest.raises(ValueError) as j_err:
        jseg.segment_reduce("min", *map(jnp.asarray, args[:2]), 2)
    with pytest.raises(ValueError) as t_err:
        tseg.segment_reduce("min", *map(torch.from_numpy, args[:2]), 2)
    assert str(t_err.value) == str(j_err.value)


def test_segment_sum_and_mean_keep_bf16_data_and_match_jax():
    rng = np.random.default_rng(2)
    data = rng.normal(size=(30, 4)).astype(np.float32)
    ids = rng.integers(0, 6, 30).astype(np.int32)
    for name in ("segment_sum", "segment_mean"):
        want = getattr(jseg, name)(jnp.asarray(data), jnp.asarray(ids), 7)
        got = getattr(tseg, name)(torch.from_numpy(data),
                                  torch.from_numpy(ids), 7)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    got = tseg.segment_sum(torch.from_numpy(data).bfloat16(),
                           torch.from_numpy(ids), 7)
    assert got.dtype == torch.bfloat16


def test_gather_with_sorted_backward_matches_jax():
    """values[idx] and its gradient, whose backward sums g at each row in
    the sorted order, against the JAX custom VJP."""
    rng = np.random.default_rng(3)
    values = rng.normal(size=(8, 5)).astype(np.float32)
    idx = rng.integers(0, 8, 25).astype(np.int32)
    g = rng.normal(size=(25, 5)).astype(np.float32)
    order = np.argsort(idx, kind="stable").astype(np.int32)
    idx_sorted = idx[order]

    def j_loss(v):
        return (jseg.gather_with_sorted_backward(
            v, jnp.asarray(idx), jnp.asarray(order),
            jnp.asarray(idx_sorted)) * jnp.asarray(g)).sum()

    want = np.asarray(jax.grad(j_loss)(jnp.asarray(values)))
    v = torch.from_numpy(values).requires_grad_()
    out = tseg.gather_with_sorted_backward(
        v, *(torch.from_numpy(a) for a in (idx, order, idx_sorted)))
    np.testing.assert_array_equal(out.detach().numpy(), values[idx])
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(v.grad.numpy(), want, **TOL)
    # rows no index reaches take no gradient
    assert (v.grad.numpy()[np.setdiff1d(np.arange(8), idx)] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("include_receiver", [True, False])
def test_split_pre_mlp_matches_jax(include_receiver, dtype):
    """Three layers, the first as split projections; weights carried by
    `weights.from_jax_variables`; bf16 products with float32 sums under
    bfloat16 (the same rounding in both packages, so the same tolerance)."""
    x, senders, receivers, edge_attr, _ = _graph()
    sizes = [7, 6, 4]
    jm = JSplitPreMLP(sizes, x.shape[1], include_receiver=include_receiver,
                      dtype=dtype)
    args = tuple(map(jnp.asarray, (x, senders, receivers, edge_attr)))
    variables = jm.init(jax.random.key(0), *args)
    want = np.asarray(jm.apply(variables, *args))
    tm = SplitPreMLP(sizes, x.shape[1], edge_attr.shape[1],
                     include_receiver=include_receiver, dtype=dtype)
    tm.load_state_dict(weights.from_jax_variables(
        jax.tree_util.tree_map(np.asarray, variables)))
    got = tm(*(torch.from_numpy(a) for a in (x, senders, receivers,
                                             edge_attr)))
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


def _convs(conv, aggr, pre_layers, edge_encoder, x, de, dtype="float32"):
    """The JAX conv, its initial params, and the port's conv carrying
    them."""
    if conv == "MPNNConv":
        jc = jlayers.MPNNConv(out_channels=6, aggr=aggr, pre_layers=pre_layers,
                              post_layers=2, use_edge_encoder=edge_encoder,
                              dtype=dtype)
        tc = tlayers.MPNNConv(x.shape[1], de, 6, aggr=aggr,
                              pre_layers=pre_layers, post_layers=2,
                              use_edge_encoder=edge_encoder, dtype=dtype)
    else:
        jc = jlayers.RadarPointGNNConv(aggr=aggr, pre_layers=pre_layers,
                                       post_layers=2, dtype=dtype)
        tc = tlayers.RadarPointGNNConv(x.shape[1], de, aggr=aggr,
                                       pre_layers=pre_layers, post_layers=2,
                                       dtype=dtype)
    return jc, tc


_CONV_CASES = [
    ("MPNNConv", "max", 2, False), ("MPNNConv", "mean", 2, False),
    ("MPNNConv", "add", 2, True), ("MPNNConv", "mean", 1, False),
    ("RadarPointGNNConv", "max", 2, False),
    ("RadarPointGNNConv", "mean", 2, False),
    ("RadarPointGNNConv", "add", 1, False),
]


@pytest.mark.parametrize("conv,aggr,pre_layers,edge_encoder", _CONV_CASES)
def test_conv_matches_jax(conv, aggr, pre_layers, edge_encoder):
    """The conv's output and the gradients of (out**2).sum() in x, the edge
    features and every parameter, masked edges and a receiver without
    in-edges included."""
    x, senders, receivers, edge_attr, mask = _graph(seed=4)
    jc, tc = _convs(conv, aggr, pre_layers, edge_encoder, x,
                    edge_attr.shape[1])
    j_args = tuple(map(jnp.asarray, (senders, receivers)))
    params = jc.init(jax.random.key(2), jnp.asarray(x), *j_args,
                     jnp.asarray(edge_attr), jnp.asarray(mask))["params"]

    def j_loss(p, xx, ee):
        return (jc.apply({"params": p}, xx, *j_args, ee,
                         jnp.asarray(mask)) ** 2).sum()

    want_out = np.asarray(jc.apply({"params": params}, jnp.asarray(x),
                                   *j_args, jnp.asarray(edge_attr),
                                   jnp.asarray(mask)))
    gp, gx, ge = jax.grad(j_loss, argnums=(0, 1, 2))(
        params, jnp.asarray(x), jnp.asarray(edge_attr))
    tc.load_state_dict(weights.from_jax_variables(
        {"params": jax.tree_util.tree_map(np.asarray, params)}))
    tx = torch.from_numpy(x).requires_grad_()
    te = torch.from_numpy(edge_attr).requires_grad_()
    out = tc(tx, torch.from_numpy(senders), torch.from_numpy(receivers), te,
             torch.from_numpy(mask))
    np.testing.assert_allclose(out.detach().numpy(), want_out, **TOL)
    (out ** 2).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), **TOL)
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(ge), **TOL)
    want = weights.from_jax_variables(
        {"params": jax.tree_util.tree_map(np.asarray, gp)})
    for name, p in tc.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   err_msg=name, **TOL)


def _ones(module):
    """tests/test_models.py's oracle weights: kernels 1, biases 0."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            p.fill_(0.0 if name.endswith("bias") else 1.0)


def test_radar_point_gnn_conv_structure_and_residual():
    """tests/test_models.py's oracle on the port: two pre-MLP layers, one
    post-MLP layer, the residual."""
    conv = tlayers.RadarPointGNNConv(2, 1, aggr="max", pre_layers=2,
                                     post_layers=1)
    assert {n.split(".")[1] for n, _ in conv.pre_mlp.named_parameters(
        prefix="pre_mlp")} == {"lin_0", "lin_1"}
    assert {n.split(".")[1] for n, _ in conv.post_mlp.named_parameters(
        prefix="post_mlp")} == {"lin_0"}
    assert tuple(conv.post_mlp.lin_0.weight.shape) == (2, 5)
    _ones(conv)
    out = conv(torch.tensor([[1.0, 1.0], [2.0, 2.0]]), torch.tensor([0, 1]),
               torch.tensor([1, 0]), torch.tensor([[1.0], [1.0]]))
    np.testing.assert_allclose(out[1].detach().numpy(), [33.0, 33.0])


def test_mpnn_conv_torch_semantics_parity():
    """tests/test_models.py's torch re-implementation of the reference's
    propagate / scatter-max semantics, against the port's MPNNConv with a
    pre-MLP of two layers."""
    rng = np.random.default_rng(0)
    n, e, d_in, d_out, de = 7, 20, 5, 6, 3
    x = torch.from_numpy(rng.normal(size=(n, d_in)).astype(np.float32))
    senders = torch.from_numpy(rng.integers(0, n, size=e))
    receivers = torch.from_numpy(rng.integers(0, n, size=e))
    edge_attr = torch.from_numpy(rng.normal(size=(e, de)).astype(np.float32))
    conv = tlayers.MPNNConv(d_in, de, d_out, aggr="max", pre_layers=2,
                            post_layers=2,
                            generator=torch.Generator().manual_seed(1))
    ours = conv(x, senders, receivers, edge_attr).detach()

    def stack(mod, v):
        for i in range(mod.num_linear):
            lin = getattr(mod, f"lin_{i}")
            v = (torch.relu(v) if i else v) @ lin.weight.t() + lin.bias
        return v

    with torch.no_grad():
        m = stack(conv.pre_mlp,
                  torch.cat([x[receivers], x[senders], edge_attr], dim=-1))
        agg = torch.zeros((n, m.shape[1]))
        filled = torch.full((n, m.shape[1]), -torch.inf)
        has = torch.zeros(n, dtype=torch.bool)
        for i, r in enumerate(receivers.tolist()):
            filled[r] = torch.maximum(filled[r], m[i])
            has[r] = True
        agg[has] = filled[has]
        want = stack(conv.post_mlp, torch.cat([x, agg], dim=-1))
    np.testing.assert_allclose(ours.numpy(), want.numpy(), **TOL)


def test_fused_csr_tiling_auto_mode():
    """tests/test_models.py's case on the port: "auto" is dense with the
    kNN degree and windowed without, as in the JAX package."""
    base = dict(node_feature_dimension=4, edge_feature_dimension=2,
                conv_layer_dimensions=[8],
                classification_head_layer_dimensions=[6],
                regression_head_layer_dimensions=[5],
                use_fused_aggregation=True, fused_tiling="auto",
                fused_overflow_fraction=0.05)
    t_auto = tcfg.GNNArchitectureConfig(**base)
    j_auto = jcfg.GNNArchitectureConfig(**base)
    dense = tlayers.fused_csr_tiling(t_auto, k=20)
    assert dense == jlayers.fused_csr_tiling(j_auto, k=20)
    assert dense["mode"] == "dense" and not dense["ovf_ssum"]
    assert dense["k"] == 20 + tlayers.FUSED_DENSE_EXTRA_SLOTS
    windowed = tlayers.fused_csr_tiling(t_auto, k=None)
    assert windowed == jlayers.fused_csr_tiling(j_auto, k=None) == (
        tlayers.FUSED_NODE_BLOCK, tlayers.FUSED_EDGE_TILE,
        tlayers.FUSED_WINDOW_BLOCKS, 0.05, 4)


@pytest.mark.usefixtures("host_pair")
def test_unfused_detnet_train_steps_match_jax():
    """Two Trainer steps of a DetNet with MPNNConv, a pre-MLP of two layers
    and mean aggregation, use_fused_aggregation set and the batch tiled
    (dense): both packages take the unfused path, and the losses agree as
    tests/test_torch_trainer.py holds them."""
    kw = dict(node_feature_dimension=5, edge_feature_dimension=2,
              conv_layer_dimensions=[16, 12],
              classification_head_layer_dimensions=[8, 6],
              regression_head_layer_dimensions=[8, 5],
              initial_node_feature_embedding=True,
              initial_edge_feature_embedding=True,
              node_feature_embedding_layer_dimensions=[8, 12],
              edge_feature_embedding_layer_dimensions=[4, 6],
              conv_layer_type="MPNNConv", conv_pre_mlp_layer_number=2,
              aggregation_function="mean", conv_use_edge_encoder=True,
              batch_norm_in_mlps=True, compute_dtype="float32",
              use_fused_aggregation=True, fused_tiling="dense",
              fused_overflow_fraction=0.3)
    j_arch, t_arch = jcfg.GNNArchitectureConfig(**kw), \
        tcfg.GNNArchitectureConfig(**kw)
    spec = dict(tlayers.fused_csr_tiling(t_arch, k=20), node_block=64,
                r_tile=16)
    bucket = dict(max_nodes=256, bg_index=5, max_edges=256 * 20,
                  csr_tiling=spec)
    frames = dict(num_frames=2, num_points=200, seed=0)
    jb = j_stack(j_make_samples(**frames), **bucket)
    tb = t_stack(t_make_samples(**frames), device="cpu", **bucket)
    j_model, variables = create_detnet_state(j_arch, jax.random.key(0), jb)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    model = DetNet(t_arch, device="cpu")
    assert not model.fused
    model.load_state_dict(weights.from_jax_variables(variables))
    train_kw = dict(dataset="radarscenes", learning_rate=1e-3, epochs=1,
                    batch_size=2, shuffle=False, bg_index=5,
                    bb_loss_weight=0.5, regularization_strength=5e-6,
                    adapt_orientation_angle=True)
    jt = JTrainer(jcfg.TrainingConfig(**train_kw), j_model, variables)
    step = jax.jit(jt.train_step_fn)
    s1, l1 = step(jt.state, jb)
    _, l2 = step(s1, jb)
    tt = Trainer(tcfg.TrainingConfig(**train_kw), model)
    g1 = [float(v) for v in tt.train_step(tb)]
    g2 = [float(v) for v in tt.train_step(tb)]
    np.testing.assert_allclose(g1, np.asarray(l1), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(g2, np.asarray(l2), rtol=1e-3, atol=1e-4)
    assert g2[0] < g1[0]
