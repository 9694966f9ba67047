"""The port's DetNet serving path (radargnn_tpu_torch: DetNet, Predictor, the
weight bridge) against the JAX package's, on the CPU at a small size.

The same synthetic frames go through both packages' loaders, the JAX
package's initial weights cross over through `weights.from_jax_variables`,
and both Predictors serve the batch with batch statistics. The JAX side runs
its dense (v4) Pallas kernel in interpret mode. In float32 the two differ
only in summation order, which BatchNorm over ~400 nodes can amplify a
little: probabilities and boxes agree to atol 1e-4 + rtol 1e-4."""

import jax
import numpy as np
import pytest
import torch

from radargnn_tpu import configs as jcfg
from radargnn_tpu.data.synthetic import make_samples as j_make_samples
from radargnn_tpu.graph.batch import stack_samples as j_stack
from radargnn_tpu.models.detnet import create_detnet_state
from radargnn_tpu.postprocess.inference import Predictor as JPredictor
from radargnn_tpu_torch import configs as tcfg
from radargnn_tpu_torch import weights
from radargnn_tpu_torch.data.synthetic import make_samples as t_make_samples
from radargnn_tpu_torch.graph.batch import stack_samples as t_stack
from radargnn_tpu_torch.models.detnet import DetNet
from radargnn_tpu_torch.models.layers import fused_csr_tiling
from radargnn_tpu_torch.models.mlp import MaskedBatchNorm, running_stats_frozen
from radargnn_tpu_torch.ops import dense_aggregate as da
from radargnn_tpu_torch.postprocess.inference import Predictor

from host_backends import host_pair, native_cache  # noqa: F401

# the host arrays of both packages from one pair of host backends
pytestmark = pytest.mark.usefixtures("host_pair")

K = 20
TOL = dict(rtol=1e-4, atol=1e-4)


def _arch_kw(conv="MPNNConv", fused=True, bn=False, dtype="float32"):
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
        assume_sorted_edges=True, use_fused_aggregation=fused,
        fused_tiling="dense")


def _spec(arch):
    """The port's loader spec at the small geometry of tests/test_pallas.py
    (64-node blocks, 16 receivers per tile), from the port's own rule."""
    spec = fused_csr_tiling(arch, k=K)
    if spec is not None:
        spec = dict(spec, node_block=64, r_tile=16, ovf_frac=0.3)
    return spec


def _jax_and_port(conv="MPNNConv", fused=True, bn=False, dtype="float32",
                  seed=0):
    kw = _arch_kw(conv, fused, bn, dtype)
    j_arch = jcfg.GNNArchitectureConfig(**kw)
    t_arch = tcfg.GNNArchitectureConfig(**kw)
    spec = _spec(t_arch)
    jb = j_stack(j_make_samples(num_frames=2, num_points=200, seed=seed),
                 max_nodes=256, bg_index=5, max_edges=256 * K,
                 csr_tiling=spec)
    tb = t_stack(t_make_samples(num_frames=2, num_points=200, seed=seed),
                 max_nodes=256, bg_index=5, max_edges=256 * K,
                 csr_tiling=spec, device="cpu")
    j_model, variables = create_detnet_state(j_arch, jax.random.key(seed), jb)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    t_model = DetNet(t_arch, device="cpu")
    t_model.load_state_dict(weights.from_jax_variables(variables))
    return (j_model, variables, jb), (t_model, tb)


def _assert_predictions_close(got, want, tol):
    for key in ("class_probability_prediction", "bounding_box_predictions"):
        assert len(got[0][key]) == len(want[0][key])
        for g, w in zip(got[0][key], want[0][key]):
            np.testing.assert_allclose(g, w, err_msg=key, **tol)
    for key in ("class_true", "bounding_box_true"):
        for g, w in zip(got[1][key], want[1][key]):
            np.testing.assert_array_equal(g, w, err_msg=key)
    for g, w in zip(got[2] + got[3], want[2] + want[3]):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("conv,fused,bn", [
    ("MPNNConv", True, False),
    ("MPNNConv", False, False),
    ("MPNNConv", True, True),
    ("RadarPointGNNConv", True, False),
    ("RadarPointGNNConv", False, True),
])
def test_predictor_matches_jax(conv, fused, bn):
    """Softmax probabilities and boxes of the served batch, with the dense
    tiling (fused) and without it (unfused segment max)."""
    (j_model, variables, jb), (t_model, tb) = _jax_and_port(conv, fused, bn)
    want = JPredictor(j_model, variables, [jb], verbose=False).predict()
    got = Predictor(t_model, [tb], verbose=False).predict()
    _assert_predictions_close(got, want, TOL)


def test_predictor_matches_jax_bf16():
    """compute_dtype bfloat16: the linears round their inputs to bf16 in
    both packages; on the CPU both gather in float32. A float32 summation
    difference can flip one bf16 rounding (2^-8 relative) of a next-layer
    input, so the bound here is that of bf16 inputs: atol/rtol 2e-2."""
    (j_model, variables, jb), (t_model, tb) = _jax_and_port(dtype="bfloat16")
    want = JPredictor(j_model, variables, [jb], verbose=False).predict()
    got = Predictor(t_model, [tb], verbose=False).predict()
    _assert_predictions_close(got, want, dict(rtol=2e-2, atol=2e-2))


def test_tiled_and_untiled_port_agree():
    """The port's dense path and its unfused path serve the same outputs
    for the same weights (float32, summation order only)."""
    (_, variables, _), (t_fused, tb) = _jax_and_port(fused=True)
    t_arch = tcfg.GNNArchitectureConfig(**_arch_kw(fused=False))
    t_plain = DetNet(t_arch, device="cpu")
    t_plain.load_state_dict(weights.from_jax_variables(variables))
    p_fused, b_fused = Predictor(t_fused, [tb]).forward(tb)
    p_plain, b_plain = Predictor(t_plain, [tb]).forward(tb)
    mask = tb.node_mask.reshape(-1)
    torch.testing.assert_close(p_fused[mask], p_plain[mask], **TOL)
    torch.testing.assert_close(b_fused[mask], b_plain[mask], **TOL)


def test_predictor_keeps_running_stats_and_launches_nothing_on_cpu():
    (_, _, _), (t_model, tb) = _jax_and_port(bn=True)
    t_model.eval()
    before = {k: v.clone() for k, v in t_model.state_dict().items()}
    launches = da.dense_fwd_cuda.launches
    Predictor(t_model, [tb, tb], verbose=False).predict()
    assert da.dense_fwd_cuda.launches == launches
    assert not t_model.training
    for k, v in t_model.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)


def test_masked_batchnorm_updates_running_stats_only_with_grad():
    """A training forward moves the running estimates as torch's
    BatchNorm1d does (all rows valid), with grad or without it (the
    validation step runs under no_grad and keeps them, the reference's
    quirk); only its flag, which `running_stats_frozen` clears for serving,
    stops them. Frozen, it normalizes the same."""
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(40, 6))).float()
    bn, ref = MaskedBatchNorm(6), torch.nn.BatchNorm1d(6)
    want = ref(x)
    torch.testing.assert_close(bn(x, torch.ones(40, dtype=torch.bool)), want)
    torch.testing.assert_close(bn.running_mean, ref.running_mean)
    torch.testing.assert_close(bn.running_var, ref.running_var)
    with torch.no_grad():
        want = ref(x)
        torch.testing.assert_close(bn(x), want)
    torch.testing.assert_close(bn.running_mean, ref.running_mean)
    torch.testing.assert_close(bn.running_var, ref.running_var)
    mean, var = bn.running_mean.clone(), bn.running_var.clone()
    with running_stats_frozen(bn):
        assert not bn.update_running_stats
        torch.testing.assert_close(bn(x), want)
    assert bn.update_running_stats
    assert torch.equal(bn.running_mean, mean)
    assert torch.equal(bn.running_var, var)


def test_weight_bridge_round_trips():
    (_, variables, _), (t_model, _) = _jax_and_port(bn=True)
    state = weights.from_jax_variables(variables)
    assert state.keys() == t_model.state_dict().keys()
    back = weights.to_jax_variables(state)
    flat_v = jax.tree_util.tree_flatten_with_path(variables)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_v] == [p for p, _ in flat_b]
    for (path, v), (_, b) in zip(flat_v, flat_b):
        np.testing.assert_array_equal(b, v, err_msg=str(path))
    again = weights.from_jax_variables(back)
    for key, v in state.items():
        torch.testing.assert_close(again[key], v, rtol=0, atol=0)
    # the hoisted pre-MLP kernel [2d+de, 2d+de] keeps its w_r | w_s | w_e
    # rows: the port's weight is its transpose
    kern = variables["params"]["conv_0"]["pre_mlp"]["lin_0"]["kernel"]
    np.testing.assert_array_equal(
        state["conv_0.pre_mlp.lin_0.weight"].numpy(), kern.T)


def test_weight_bridge_refuses_unknown_leaves():
    with pytest.raises(KeyError):
        weights.from_jax_variables({"params": {"lin_0": {"gamma": np.ones(2)}}})
    with pytest.raises(KeyError):
        weights.to_jax_variables({"lin_0.gamma": torch.ones(2)})


def test_entry_points_default_to_the_card():
    """With no device given, the model and the loader go to CUDA, and raise
    where there is no card rather than fall back to the CPU."""
    arch = tcfg.GNNArchitectureConfig(**_arch_kw())
    samples = t_make_samples(num_frames=1, num_points=64, seed=0)
    if torch.cuda.is_available():
        assert next(DetNet(arch).parameters()).is_cuda
        assert t_stack(samples, max_nodes=128, bg_index=5).node_feat.is_cuda
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        DetNet(arch)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_stack(samples, max_nodes=128, bg_index=5)


def test_unported_configurations_raise():
    kw = _arch_kw(fused=False)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        DetNet(tcfg.GNNArchitectureConfig(
            **dict(kw, conv_pre_mlp_layer_number=2)), device="cpu")
    # the CSR tiling is ported (tests/test_torch_csr.py)
    assert fused_csr_tiling(tcfg.GNNArchitectureConfig(
        **dict(kw, use_fused_aggregation=True, fused_tiling="csr"))) == \
        (256, 512)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        DetNet(tcfg.GNNArchitectureConfig(**dict(kw, fused_bf16_max=True)),
               device="cpu")
    assert fused_csr_tiling(tcfg.GNNArchitectureConfig(**kw), k=K) is None
    spec = fused_csr_tiling(tcfg.GNNArchitectureConfig(
        **dict(kw, use_fused_aggregation=True, fused_tiling="auto")), k=K)
    assert spec["mode"] == "dense" and spec["k"] == K + 4
