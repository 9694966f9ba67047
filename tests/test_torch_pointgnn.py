"""RadarPointGNNConv on the port's fused paths against the JAX package, on
the CPU at the small geometry of the existing tests.

With a one-layer pre-MLP and max aggregation (the hoisted configuration),
RadarPointGNNConv goes through the same fused aggregations as MPNNConv:
its message is x_s @ W_s + e @ W_e + b, with no receiver term, so the
hoisted offset is the pre-MLP's bias broadcast over the nodes, and its
aggregation width is H = d_in + d_e. The tests hold, on the dense, the
windowed and the CSR tiling:

  * two Trainer steps of a RadarPointGNNConv DetNet from the same weights
    (the JAX package's, carried by `weights.from_jax_variables`): the
    losses, and in float32 the parameters after step 2 (tolerances of
    tests/test_torch_trainer.py);
  * the gradients of one backward pass against `jax.grad` of the same loss,
    parameter by parameter;
  * the aggregation alone, at widths where H = d_in + d_e is a whole
    number of the kernels' 64-column slices and where `col_pad` pads by
    another amount than the MPNN layer shapes' 48, with the offset a
    broadcast bias: the forward and the gradients of x, W_s, W_e and the
    bias.

On the CPU the port's wrappers take their plain versions (which pad y_s
and the routing bits as the kernels do); the JAX side runs its Pallas
kernels in interpret mode. Both compute in float32 there and differ in
summation order only. The kernels themselves run on the card in the
smoke's Radar-PointGNN phase (`smoke_pointgnn`)."""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radargnn_tpu import configs as jcfg
from radargnn_tpu.ops import pallas_kernels as jpk
from radargnn_tpu.train.trainer import Trainer as JTrainer
from radargnn_tpu_torch import configs as tcfg
from radargnn_tpu_torch import weights
from radargnn_tpu_torch.ops import csr_aggregate as ca
from radargnn_tpu_torch.ops import dense_aggregate as da
from radargnn_tpu_torch.ops import segment_sum as ss
from radargnn_tpu_torch.ops import windowed_aggregate as wa
from radargnn_tpu_torch.train.trainer import Trainer

import test_torch_csr as tcsr
import test_torch_dense_aggregate as tda
import test_torch_detnet as tdet
import test_torch_windowed as twin
from host_backends import host_pair, native_cache  # noqa: F401
from torch_threads import few_threads  # noqa: F401

# the host arrays of both packages from one pair of host backends
pytestmark = pytest.mark.usefixtures("host_pair", "few_threads")

CONV = "RadarPointGNNConv"
TILINGS = ("dense", "windowed", "csr")
LR = 1e-3
TRAIN_KW = dict(dataset="radarscenes", learning_rate=LR, epochs=2,
                batch_size=2, shuffle=False, bg_index=5, bb_loss_weight=0.5,
                regularization_strength=5e-6, adapt_orientation_angle=True,
                exponential_lr_decay_factor=0.95)
# the aggregation alone: float32 on both sides, summation order only;
# each output's largest difference over its largest magnitude
AGG_RTOL = 1e-5
# the model's gradients after one backward pass through five layers of
# BatchNorm, the heads and the losses: float32, summation order only
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


@functools.lru_cache(maxsize=None)
def _model_pair(tiling: str, dtype: str):
    """A JAX DetNet of RadarPointGNNConv layers and the port's with its
    weights, and one batch from each package's loader, under `tiling` at
    the small geometry of the tiling's own tests (BatchNorm in the MLPs);
    built once a module, `_trainers` copies the port's model."""
    if tiling == "dense":
        return tdet._jax_and_port(CONV, fused=True, bn=True, dtype=dtype)
    pair = twin._model_pair if tiling == "windowed" else tcsr._model_pair
    return pair(dtype, bn=True, conv=CONV)


def _trainers(tiling: str, dtype: str):
    (j_model, variables, jb), (t_model, tb) = _model_pair(tiling, dtype)
    t_model = copy.deepcopy(t_model)
    assert all(type(m).__name__ == CONV for m in t_model.modules()
               if type(m).__name__.endswith("Conv"))
    assert t_model.fused
    jt = JTrainer(jcfg.TrainingConfig(**TRAIN_KW), j_model, variables)
    tt = Trainer(tcfg.TrainingConfig(**TRAIN_KW), t_model)
    return jt, tt, jb, tb


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _launches():
    return (da.dense_proj_cuda.launches, da.dense_fwd_cuda.launches,
            da.dense_bwd_cuda.launches, wa.windowed_fwd_cuda.launches,
            wa.windowed_bwd_cuda.launches, ca.csr_fwd_cuda.launches,
            ca.csr_bwd_cuda.launches, ss.segment_sum_csr_cuda.launches)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tiling", TILINGS)
def test_pointgnn_train_steps_match_jax(tiling, dtype):
    """Two Trainer steps from the same weights and batch. float32: the
    losses to rtol 1e-4 / atol 1e-5 after step 1 and 1e-3 / 1e-4 after
    step 2, the parameters after step 2 to 2·lr (Adam may step a weight
    whose gradient is within rounding of 0 either way: the pre-MLP biases'
    gradients are such, see test_pointgnn_gradients_match_jax). bf16
    compute: the losses to rtol 2e-2 (a float32 summation difference can
    flip one bf16 rounding of a next-layer input)."""
    jt, tt, jb, tb = _trainers(tiling, dtype)
    step = jax.jit(jt.train_step_fn)
    s1, l1 = step(jt.state, jb)
    s2, l2 = step(s1, jb)
    launches = _launches()
    got = [[float(v) for v in tt.train_step(tb)] for _ in range(2)]
    assert _launches() == launches                       # CPU: none
    assert got[1][0] < got[0][0]
    if dtype == "bfloat16":
        for g, w in zip(got, (l1, l2)):
            np.testing.assert_allclose(g, np.asarray(w), rtol=2e-2)
        return
    np.testing.assert_allclose(got[0], np.asarray(l1), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got[1], np.asarray(l2), rtol=1e-3, atol=1e-4)
    back = _flat(weights.to_jax_variables(tt.model.state_dict())["params"])
    want = _flat(jax.device_get(s2.params))
    assert sorted(back) == sorted(want)
    for path, u in back.items():
        np.testing.assert_allclose(u, want[path], rtol=0, atol=2 * LR,
                                   err_msg=path)


def _role(path: str) -> str:
    """What a parameter is in a RadarPointGNNConv DetNet, for the
    assertion message."""
    if "pre_mlp" in path and "bias" in path:
        return (" (the pre-MLP bias: the column sums of the broadcast "
                "offset's gradient)")
    if "post_mlp" in path:
        return " (the residual update post_mlp([x || aggr]) + x)"
    if "node_emb_mlp" in path:
        return (" (the node embedding, reached through every conv's "
                "residual path)")
    return ""


@pytest.mark.parametrize("tiling", TILINGS)
def test_pointgnn_gradients_match_jax(tiling):
    """The gradients of the detection loss at the shared weights, one
    backward pass through the port's Trainer.losses against jax.grad of the
    JAX trainer's loss on the same batch, parameter by parameter, in
    float32 (rtol/atol 1e-4). The pre-MLP biases' gradients cancel to
    rounding in both packages: the BatchNorm after each conv's residual
    update takes any per-column constant out of the loss."""
    jt, tt, jb, tb = _trainers(tiling, "float32")
    params, stats = jt.state.params, jt.state.batch_stats

    def loss(p):
        (logits, bb), _ = jt._forward(p, stats, jb, train=True)
        return jt._loss_terms(logits, bb, jb, jt._weights)[0]

    want = _flat(jax.jit(jax.grad(loss))(params))
    tt.model.zero_grad(set_to_none=True)
    tt.losses(tb)[0].backward()
    got = _flat(weights.to_jax_variables(
        {n: p.grad for n, p in tt.model.named_parameters()})["params"])
    assert sorted(got) == sorted(want)
    for path, u in got.items():
        np.testing.assert_allclose(u, want[path], err_msg=path + _role(path),
                                   **GRAD_TOL)
    biases = [p for p in got if "pre_mlp" in p and "bias" in p]
    assert len(biases) == 2
    for path in biases:
        # cancelled: far below the size of its weight's gradient
        weight = path.replace("bias", "kernel")
        assert np.linalg.norm(want[path]) < 1e-4 * np.linalg.norm(
            want[weight]), path


# ---------------------------------------------------------------------------
# the aggregation alone, at H = d_in + d_e, with a broadcast bias
# ---------------------------------------------------------------------------

# (d_in, d_e, H): H a whole number of 64-column slices; H padded by 56
WIDTHS = [(56, 8, 64), (64, 8, 72)]


def _aggregations(tiling: str, h: int, seed: int):
    """The tiling's test setup at conv width `h` (d_e 8): the port's
    aggregation and the JAX package's fused function (interpret mode), each
    as f(x, w_s, w_e, bias) with the bias broadcast over the nodes, and
    the setup's arrays (e_t, e_ovf and the layout)."""
    if tiling == "dense":
        geo, a = tda._dense_setup(seed=seed, h=h)
        n = geo["n"]
        landing = tda._landing(geo, a)
        fused = jpk.make_fused_dense_aggregate(
            n, geo["K"], geo["r_tile"], geo["node_block"], geo["wb"])
        consts = tuple(map(jnp.asarray, (a["tile_win"], a["sloc"],
                                         a["pmask"], a["ovf_s"],
                                         a["ovf_r"])))
        t = {k: torch.from_numpy(np.ascontiguousarray(a[k])) for k in
             ("e_t", "e_ovf", "tile_win", "sloc", "ovf_s", "ovf_r")}

        def port(x, w_s, w_e, b):
            return da.dense_aggregate(
                x, w_s, t["e_t"], w_e, b.expand(n, -1), t["e_ovf"],
                t["tile_win"], t["sloc"], t["ovf_s"], t["ovf_r"],
                r_tile=geo["r_tile"], k=geo["K"],
                node_block=geo["node_block"], landing=landing)

        def ref(x, w_s, w_e, b):
            return fused(x, w_s, jnp.asarray(a["e_t"]), w_e,
                         jnp.broadcast_to(b, (n, h)),
                         jnp.asarray(a["e_ovf"]), *consts)
    elif tiling == "windowed":
        geo, a = twin._agg_setup(seed=seed, h=h)
        n = geo["n"]
        landing = twin._landing(geo, a)
        fused, consts = twin._jax_fused(geo), twin._jax_consts(a)
        t = {k: torch.from_numpy(np.ascontiguousarray(a[k])) for k in
             ("e_t", "e_ovf", "recv", "blocks", "tile_win", "sloc", "ovf_s",
              "ovf_r")}

        def port(x, w_s, w_e, b):
            return wa.windowed_aggregate(
                x, w_s, t["e_t"], w_e, b.expand(n, -1), t["e_ovf"],
                t["recv"], t["blocks"], t["tile_win"], t["sloc"],
                t["ovf_s"], t["ovf_r"], node_block=geo["node_block"],
                edge_tile=geo["edge_tile"], landing=landing)

        def ref(x, w_s, w_e, b):
            return fused(x, w_s, jnp.asarray(a["e_t"]), w_e,
                         jnp.broadcast_to(b, (n, h)),
                         jnp.asarray(a["e_ovf"]), *consts)
    else:
        geo, a = tcsr._agg_setup(seed=seed, h=h)
        n = geo["n"]
        landing = tcsr._landing(geo, a, True)
        fused = tcsr._jax_fused(geo, a, True)
        t = {k: torch.from_numpy(np.ascontiguousarray(a[k])) for k in
             ("e_t", "senders", "recv", "blocks")}

        def port(x, w_s, w_e, b):
            return ca.csr_aggregate(
                x, w_s, t["e_t"], w_e, t["senders"], t["recv"], t["blocks"],
                b.expand(n, -1), node_block=geo["node_block"],
                edge_tile=geo["edge_tile"], landing=landing)

        def ref(x, w_s, w_e, b):
            return fused(x, w_s, jnp.asarray(a["e_t"]), w_e,
                         jnp.broadcast_to(b, (n, h)))
    return port, ref, n


@pytest.mark.parametrize("widths", WIDTHS)
@pytest.mark.parametrize("tiling", TILINGS)
def test_hoisted_aggregation_with_a_broadcast_bias(tiling, widths):
    """The aggregation at H = d_in + d_e with the offset a bias broadcast
    over the nodes (a stride-0 view, as RadarPointGNNConv gives it): the
    forward and the gradients of (out**2).sum() in x, W_s, W_e and the
    bias, the port's wrapper (plain versions on the CPU) against the JAX
    package's fused function in interpret mode, within 1e-5 of each
    output's scale in float32.
    The plain projection pads y_s to `col_pad(H)` columns and the bits to
    col_pad(H) / 32 words, as the kernels do."""
    d, de, h = widths
    port, ref, n = _aggregations(tiling, h, seed=len(tiling) + d)
    rng = np.random.default_rng(d + h)
    arrays = [rng.normal(size=(n, d)), rng.normal(size=(d, h)) * 0.2,
              rng.normal(size=(de, h)) * 0.3, rng.normal(size=(h,))]
    arrays = [a.astype(np.float32) for a in arrays]

    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    launches = _launches()
    got = port(*leaves)
    assert _launches() == launches                       # CPU: no launch
    got_grads = torch.autograd.grad((got ** 2).sum(), leaves)
    want = ref(*map(jnp.asarray, arrays))
    want_grads = jax.grad(lambda *ar: (ref(*ar) ** 2).sum(),
                          argnums=(0, 1, 2, 3))(*map(jnp.asarray, arrays))
    assert got.shape == want.shape == (n, h)
    for name, u, v in zip(("out", "x", "W_s", "W_e", "bias"),
                          (got.detach(), *got_grads), (want, *want_grads)):
        u, v = u.numpy(), np.asarray(v)
        assert u.shape == v.shape, name
        err = np.abs(u - v).max() / max(np.abs(v).max(), 1.0)
        assert err <= AGG_RTOL, (name, err)
    # the bias takes every non-empty receiver's g: no cancellation here
    assert np.abs(got_grads[3].numpy()).max() > 1.0

    # the pad to the kernels' 64-column slices, and the bits' words
    hp = da.col_pad(h)
    assert hp - h == (0 if h % 64 == 0 else 64 - h % 64)
    y_s = da.dense_proj(leaves[0].detach(), leaves[1].detach())
    assert y_s.shape == (n, hp)
    assert not y_s[:, h:].any()
    sel = torch.rand(5, h) < 0.5
    bits = da.pack_bits(sel)
    assert bits.shape == (5, hp // 32)
    assert torch.equal(da.unpack_bits(bits, h), sel)
