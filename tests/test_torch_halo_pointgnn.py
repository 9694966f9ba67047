"""RadarPointGNNConv under the halo partition, the port against the JAX
package on the CPU.

With a one-layer pre-MLP and max aggregation RadarPointGNNConv takes the
same halo path as MPNNConv (`halo_hoisted_max_batched`: one exchange of
the boundary senders over the mesh's model axis, then the dense or the
windowed aggregation per rank), at H = d_in + d_e, with the offset its
pre-MLP bias broadcast over the rank's rows: each rank's gradient of the
bias is the row sum of its rows of the offset's gradient, and the trainer
sums the ranks. The tests run on 4 gloo ranks, a {"data": 2, "model": 2}
mesh (one spawn for the module, the workers in `torch_parallel_workers`),
against the JAX package on its CPU mesh (its Pallas kernels in interpret
mode), on both halo families at the sizes of `tests/test_halo_dense.py`
and `tests/test_halo_training.py`:

  * the aggregation with a broadcast bias, forward (1e-5 of its scale) and
    the gradients of x, W_s, W_e and the bias (1e-4 of each one's scale),
    at an H that is a whole number of the kernels' 64-column slices and
    at one that is not;
  * four halo Trainer steps against the JAX halo Trainer (losses within
    rtol 1e-4 / atol 1e-5, weights within 4·lr, identical on every rank),
    with and without `shard_params_over_model`;
  * the gradients of the first step, summed over the ranks, against
    `jax.grad` of the JAX halo trainer's loss, parameter by parameter
    (rtol / atol 1e-4), the pre-MLP biases' also within 1e-4 of their own
    scale (these frames' nodes without in-edges keep them from cancelling
    under the BatchNorm after each residual update);
  * the JAX package's RadarPointGNNConv halo trainer against its own
    single device (rtol / atol 5e-3, its halo tests' limit): the
    reference is sound on this path;
  * the refusal of a non-hoisted conv under a halo bundle, with each
    conv's message, in both packages."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radargnn_tpu.configs import TrainingConfig as JTrainingConfig
from radargnn_tpu.data.loader import GraphDataLoader as JLoader
from radargnn_tpu.graph import batch as jbatch
from radargnn_tpu.models import layers as jlayers
from radargnn_tpu.models.detnet import create_detnet_state
from radargnn_tpu.parallel import halo_windowed as jhw
from radargnn_tpu.parallel.mesh import make_mesh as j_make_mesh
from radargnn_tpu.train.trainer import Trainer as JTrainer
from radargnn_tpu_torch import weights
from radargnn_tpu_torch.models import layers as tlayers
from radargnn_tpu_torch.parallel.comm import run_ranks
from tests.test_halo_training import HALO, _arch, _samples

import test_torch_halo as tth
import torch_parallel_workers as W
from torch_threads import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

CONV = "RadarPointGNNConv"
FAMILIES = sorted(tth.TILINGS)
# (d_in, d_e, H = d_in + d_e): H a whole number of 64-column slices, and
# H padded by 56
WIDTHS = [(56, 8, 64), (64, 8, 72)]
LR = tth.LR
# the aggregation alone: float32, summation order only; each output's
# largest difference over its largest magnitude
AGG_RTOL = 1e-5
GRAD_RTOL = 1e-4
# the model's gradients after one backward pass (tests/test_torch_pointgnn)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
# the JAX package's halo trainer against its single device
# (tests/test_halo_training.py)
SINGLE_TOL = dict(rtol=5e-3, atol=5e-3)
# each conv's halo refusal, as the JAX package words it
REFUSALS = {
    "MPNNConv": "halo partitioning requires the hoisted configuration: "
                "single linear pre-MLP, max aggregation, no conv edge "
                "encoder",
    "RadarPointGNNConv": "halo partitioning requires the hoisted "
                         "configuration: single linear pre-MLP and max "
                         "aggregation",
}


def _pointgnn_arch(node_dim, edge_dim):
    return dataclasses.replace(_arch(node_dim, edge_dim),
                               conv_layer_type=CONV)


def _aggregate_case(family, widths):
    """The family's halo batch, and the aggregation's inputs at `widths`:
    x [G, N, d_in], the raw edge features projected to d_e, W_s, W_e and
    the bias [H]."""
    d, de, h = widths
    samples = _samples()
    jb, _, max_edges, budgets = tth._halo_batches(tth.TILINGS[family],
                                                  samples)
    g, n = jb.node_mask.shape
    rng = np.random.default_rng(d + h + len(family))
    arrays = dict(
        x=rng.normal(size=(g, n, d)),
        proj=rng.normal(size=(jb.edge_feat.shape[-1], de)) * 0.5,
        w_s=rng.normal(size=(d, h)) * d ** -0.5,
        w_e=rng.normal(size=(de, h)) * de ** -0.5,
        bias=rng.normal(size=(h,)))
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    payload = dict(samples=W.sample_dicts(samples), max_nodes=64,
                   max_edges=max_edges, tiling=tth.TILINGS[family],
                   halo=dict(HALO, budgets=budgets), **arrays)
    return jb, payload


def _trainer_case(family, shard_params):
    """The JAX halo loader of 8 frames, a RadarPointGNNConv DetNet's weights
    and the port's trainer payload with them."""
    tiling = tth.TILINGS[family]
    samples = _samples(n_frames=8)
    loader = JLoader(samples, 4, False, 5, csr_tiling=tiling,
                     halo_partition=dict(HALO), pad_align=16)
    example = jbatch.stack_samples(samples[:4], loader.max_nodes, 5,
                                   loader.max_edges)
    arch = _pointgnn_arch(example.node_feat.shape[-1],
                          example.edge_feat.shape[-1])
    model, variables = create_detnet_state(arch, jax.random.key(0), example)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    train = dict(tth.TRAIN_KW, shard_params_over_model=shard_params)
    payload = dict(arch=dataclasses.asdict(arch), train=train,
                   samples=W.sample_dicts(samples), batch_size=4,
                   tiling=tiling, halo=dict(HALO),
                   state={k: v.numpy() for k, v in
                          weights.from_jax_variables(variables).items()},
                   epochs=2, mesh={"data": 2, "model": 2},
                   record_grads=not shard_params)
    return (model, variables, loader, samples, train), payload


AGG_CASES = [(f, w) for f in FAMILIES for w in WIDTHS]
TRAIN_CASES = [(f, tp) for f in FAMILIES for tp in (False, True)]


@pytest.fixture(scope="module")
def port_runs():
    """One spawn of 4 gloo ranks for the module: the aggregations and the
    halo trainers."""
    aggs = {c: _aggregate_case(*c) for c in AGG_CASES}
    trains = {c: _trainer_case(*c) for c in TRAIN_CASES}
    jobs = [("halo_aggregate_worker", aggs[c][1]) for c in AGG_CASES] \
        + [("trainer_worker", trains[c][1]) for c in TRAIN_CASES]
    # a loaded host may slow the ranks several-fold: a generous limit
    res = run_ranks(W.jobs_worker, 4, args=(jobs,), timeout_s=900)
    out = {}
    for i, c in enumerate(AGG_CASES + TRAIN_CASES):
        out[c] = dict(ranks=[r[i] for r in res],
                      case=aggs[c] if c in aggs else trains[c][0])
    return out


def _jax_halo_run(case, shard_params):
    """Four steps of the JAX halo Trainer from the case's weights: the
    losses and the parameters after them."""
    model, variables, loader, _, train = case
    t = JTrainer(JTrainingConfig(**train), model,
                 jax.tree_util.tree_map(jnp.asarray, variables),
                 mesh=j_make_mesh({"data": 2, "model": 2}))
    losses = []
    for _ in range(2):
        for b in loader:
            t.state, out = t._train_step(t.state, b)
            losses.append([float(v) for v in out])
    return losses, jax.device_get(t.state.params)


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("widths", WIDTHS)
@pytest.mark.parametrize("family", FAMILIES)
def test_halo_aggregate_with_a_broadcast_bias_matches_jax(port_runs, family,
                                                          widths):
    """`halo_hoisted_max_batched` with RadarPointGNNConv's offset, the bias
    broadcast over the rows, on 4 gloo ranks against the JAX package's on
    its mesh: the forward in shard-major order, and the gradients of
    sum(out²) in x, W_s, W_e and the bias, the bias's being every rank's
    row sum of the offset's gradient summed over the ranks."""
    jb, payload = port_runs[(family, widths)]["case"]
    ranks = port_runs[(family, widths)]["ranks"]
    g, n = jb.node_mask.shape
    h = widths[2]
    proj = jnp.asarray(payload["proj"])
    bundle = jb.flat_halo(j_make_mesh({"data": 2, "model": 2}))
    bundle = bundle.replace_edge_feat(bundle.e_t @ proj, bundle.e_ovf @ proj)

    def perm(a):
        return jhw.shard_major_nodes(a, g, n, 2, 2)

    def f(x, w_s, w_e, bias):
        return jhw.halo_hoisted_max_batched(
            perm(x), w_s, w_e, jnp.broadcast_to(bias, (g * n, h)), bundle)

    args = tuple(jnp.asarray(payload[k]) for k in ("x", "w_s", "w_e",
                                                   "bias"))
    want = np.asarray(jax.jit(f)(*args))
    grads = jax.jit(jax.grad(lambda *a: (f(*a) ** 2).sum(),
                             argnums=(0, 1, 2, 3)))(*args)
    got = np.concatenate([r["out"] for r in ranks])
    assert got.shape == want.shape == (g * n, h)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= AGG_RTOL, err
    for name, mine, ref in (
            ("x", np.concatenate([r["d_x"] for r in ranks]),
             perm(grads[0])),
            ("w_s", ranks[0]["d_ws"], grads[1]),
            ("w_e", ranks[0]["d_we"], grads[2]),
            ("bias", ranks[0]["d_bias"], grads[3])):
        ref = np.asarray(ref)
        assert mine.shape == ref.shape, name
        err = np.abs(mine - ref).max() / np.abs(ref).max()
        assert err <= GRAD_RTOL, (name, err)
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["d_bias"], ranks[0]["d_bias"])
    # every rank's own part adds to the bias's gradient, and no part alone
    # is it (each rank holds distinct rows)
    parts = np.stack([r["d_bias_rank"] for r in ranks])
    np.testing.assert_allclose(parts.sum(0), ranks[0]["d_bias"], rtol=0,
                               atol=1e-5 * np.abs(ranks[0]["d_bias"]).max())
    assert all(np.abs(p - ranks[0]["d_bias"]).max()
               > 1e-2 * np.abs(ranks[0]["d_bias"]).max() for p in parts)
    assert all(r["launches"] == [0] * 5 for r in ranks)   # CPU: plain


@pytest.fixture(scope="module")
def jax_runs(port_runs):
    return {c: _jax_halo_run(port_runs[c]["case"], c[1])
            for c in TRAIN_CASES}


@pytest.mark.parametrize("shard_params", [False, True])
@pytest.mark.parametrize("family", FAMILIES)
def test_halo_pointgnn_trainer_matches_jax(port_runs, jax_runs, family,
                                           shard_params):
    """Four steps (two epochs of two batches of 4 graphs) of the port's
    Trainer with RadarPointGNNConv on the {"data": 2, "model": 2} mesh of
    gloo ranks against the JAX Trainer on its mesh, the weights replicated
    or column-parallel (`shard_params_over_model`, both packages): the
    same losses on every rank, within rtol 1e-4 / atol 1e-5 of the JAX
    ones, and identical weights on every rank, within 4·lr of the JAX
    ones."""
    want, params = jax_runs[(family, shard_params)]
    ranks = port_runs[(family, shard_params)]["ranks"]
    for r in ranks:
        assert r["losses"] == ranks[0]["losses"]
        for k, v in r["state"].items():
            np.testing.assert_array_equal(v, ranks[0]["state"][k],
                                          err_msg=k)
    tth._assert_losses_close(ranks[0]["losses"], want)
    back = _flat(weights.to_jax_variables(
        {k: torch.from_numpy(v) for k, v in ranks[0]["state"].items()}
    )["params"])
    params = _flat(params)
    assert sorted(back) == sorted(params)
    assert sum("pre_mlp" in p for p in back) == 4   # 2 convs' kernel, bias
    for path, u in back.items():
        np.testing.assert_allclose(u, params[path], rtol=0, atol=4 * LR,
                                   err_msg=path)


@pytest.mark.parametrize("family", FAMILIES)
def test_halo_pointgnn_gradients_match_jax(port_runs, family):
    """The first halo step's gradients as the port's Adam takes them (each
    rank's backward, summed over the ranks) against `jax.grad` of the JAX
    halo trainer's loss at the same weights on the same batch, parameter by
    parameter (rtol / atol 1e-4). The pre-MLP biases' gradients, each the
    sum of every rank's offset rows, also within 1e-4 of their own scale:
    the BatchNorm after each conv's residual update takes a per-column
    constant out of the loss, but the offset reaches only the receivers of
    an edge, and these frames have nodes without one, so the biases keep a
    gradient of their own, small beside their kernels' and no rounding
    residue (where every node receives an edge it cancels:
    tests/test_torch_pointgnn.py)."""
    model, variables, loader, _, train = port_runs[(family, False)]["case"]
    ranks = port_runs[(family, False)]["ranks"]
    t = JTrainer(JTrainingConfig(**train), model,
                 jax.tree_util.tree_map(jnp.asarray, variables),
                 mesh=j_make_mesh({"data": 2, "model": 2}))
    batch = next(iter(loader))
    params, stats = t.state.params, t.state.batch_stats

    def loss(p):
        (logits, bb), _ = t._forward(p, stats, batch, train=True)
        return t._loss_terms(logits, bb, batch, t._weights)[0]

    want = _flat(jax.jit(jax.grad(loss))(params))
    for r in ranks[1:]:
        for k, v in r["grads"].items():
            np.testing.assert_array_equal(v, ranks[0]["grads"][k],
                                          err_msg=k)
    got = _flat(weights.to_jax_variables(
        {k: torch.from_numpy(v) for k, v in ranks[0]["grads"].items()}
    )["params"])
    assert sorted(got) == sorted(want)
    for path, u in got.items():
        np.testing.assert_allclose(u, want[path], err_msg=path, **GRAD_TOL)
    biases = [p for p in got if "pre_mlp" in p and "bias" in p]
    assert len(biases) == 2
    for path in biases:
        # 1-2 nodes a frame receive no edge and take no offset, so the
        # BatchNorm leaves the bias a gradient (0.7 % of its kernel's here)
        # that is no rounding residue: it is held to its own scale
        weight = path.replace("bias", "kernel")
        assert np.linalg.norm(want[path]) > 1e-3 * np.linalg.norm(
            want[weight]), path
        err = np.abs(got[path] - want[path]).max() / np.abs(want[path]).max()
        assert err <= GRAD_RTOL, (path, err)


@pytest.mark.parametrize("family", FAMILIES)
def test_jax_halo_pointgnn_trainer_matches_its_single_device(family):
    """The reference on this path: the JAX package's RadarPointGNNConv
    Trainer on the {"data": 2, "model": 2} mesh through the halo path
    tracks its single-device (unpartitioned) trainer over four steps,
    within its halo tests' rtol / atol 5e-3."""
    from radargnn_tpu.data.loader import GraphDataLoader

    samples = _samples(n_frames=8)
    tcfg = JTrainingConfig(**tth.TRAIN_KW)
    halo_loader = GraphDataLoader(samples, 4, False, 5,
                                  csr_tiling=tth.TILINGS[family],
                                  halo_partition=dict(HALO), pad_align=16)
    plain_loader = GraphDataLoader(samples, 4, False, 5, pad_align=16,
                                   max_nodes=halo_loader.max_nodes,
                                   max_edges=halo_loader.max_edges)
    example = jbatch.stack_samples(samples[:4], halo_loader.max_nodes, 5,
                                   halo_loader.max_edges)
    arch = _pointgnn_arch(example.node_feat.shape[-1],
                          example.edge_feat.shape[-1])
    model, variables = create_detnet_state(arch, jax.random.key(0), example)
    losses = {}
    for name, mesh, loader in (
            ("halo", j_make_mesh({"data": 2, "model": 2}), halo_loader),
            ("single", None, plain_loader)):
        t = JTrainer(tcfg, model, jax.tree_util.tree_map(jnp.copy, variables),
                     mesh=mesh)
        ls = []
        for _ in range(2):
            for b in loader:
                t.state, out = t._train_step(t.state, b)
                ls.append(float(out[0]))
        losses[name] = ls
    assert len(losses["halo"]) == 4
    np.testing.assert_allclose(losses["halo"], losses["single"],
                               **SINGLE_TOL)


# ---------------------------------------------------------------------------
# the refusals
# ---------------------------------------------------------------------------

def _conv(package, conv, **kw):
    if package == "jax":
        cls = getattr(jlayers, conv)
        return cls(**kw) if conv == CONV else cls(out_channels=8, **kw)
    cls = getattr(tlayers, conv)
    return cls(6, 3, **kw) if conv == CONV else cls(6, 3, 8, **kw)


@pytest.mark.parametrize("variant", [{"pre_layers": 2}, {"aggr": "mean"}],
                         ids=["pre_layers_2", "mean"])
@pytest.mark.parametrize("package", ["jax", "torch"])
@pytest.mark.parametrize("conv", sorted(REFUSALS))
def test_halo_refuses_a_non_hoisted_conv(conv, package, variant):
    """Under a halo bundle a conv outside the hoisted configuration (a
    two-layer pre-MLP, or mean aggregation) raises ValueError before it
    reads the bundle, in both packages with the JAX package's message for
    that conv."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(10, 6)).astype(np.float32)
    e = rng.normal(size=(20, 3)).astype(np.float32)
    s = rng.integers(0, 10, 20).astype(np.int32)
    r = rng.integers(0, 10, 20).astype(np.int32)
    bundle = object()            # never read: the refusal comes first
    module = _conv(package, conv, **variant)
    with pytest.raises(ValueError) as info:
        if package == "jax":
            module.init(jax.random.key(0), *map(jnp.asarray, (x, s, r, e)),
                        halo=bundle)
        else:
            module(*map(torch.from_numpy, (x, s, r, e)), halo=bundle)
    assert str(info.value) == REFUSALS[conv]
