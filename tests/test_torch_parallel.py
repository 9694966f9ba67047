"""The port's mesh, collectives, edge-partitioned and halo reductions, and
its data- and tensor-parallel trainers (radargnn_tpu_torch.parallel)
against the JAX package's on the CPU: the cases of tests/test_parallel.py
and tests/test_tensor_parallel.py.

The port's side runs on 4 gloo ranks (`parallel.comm.run_ranks`, the
workers in `torch_parallel_workers`, one spawn for the module); the JAX
package's on its 8-device CPU mesh. The segment reductions are exact: their
data are small integers, so every partial sum is exact in float32 whatever
the shard count. The trainers' losses hold the JAX tests' own tolerances:
data parallelism rtol 1e-5 / atol 1e-6 over two steps (as the JAX package's
mesh against its single device), tensor parallelism rtol 1e-4 / atol 1e-5
over four (column-parallel against replicated weights)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from radargnn_tpu.configs import GNNArchitectureConfig as JArch
from radargnn_tpu.configs import TrainingConfig as JTrainingConfig
from radargnn_tpu.data.loader import GraphDataLoader as JLoader
from radargnn_tpu.data.synthetic import make_samples as j_make_samples
from radargnn_tpu.graph.batch import stack_samples as j_stack
from radargnn_tpu.models.detnet import create_detnet_state
from radargnn_tpu.parallel import tensor as jtensor
from radargnn_tpu.parallel.edge_partition import (
    edge_partitioned_aggregate as j_edge_aggregate,
    partitioned_segment_reduce as j_reduce,
)
from radargnn_tpu.parallel.halo import (
    build_halo_plan as j_halo_plan, halo_segment_reduce as j_halo_reduce,
)
from radargnn_tpu.parallel.mesh import make_mesh as j_make_mesh
from radargnn_tpu.train.trainer import Trainer as JTrainer
from radargnn_tpu_torch import weights
from radargnn_tpu_torch.configs import GNNArchitectureConfig
from radargnn_tpu_torch.models.detnet import DetNet
from radargnn_tpu_torch.parallel import comm
from radargnn_tpu_torch.parallel import tensor as ttensor
from radargnn_tpu_torch.parallel.comm import run_ranks
from radargnn_tpu_torch.parallel.mesh import make_mesh
from tests.test_tensor_parallel import _arch as _tp_arch
from tests.test_tensor_parallel import _samples as _tp_samples

import torch_parallel_workers as W

WORLD = 4
LR = 1e-3


def test_make_mesh_shapes():
    """The JAX package's shapes and error; ranks lie row-major on the mesh
    as its devices do, and a one-rank mesh needs no process group."""
    assert make_mesh(world_size=8, device="cpu").shape == {"data": 8}
    m = make_mesh({"data": -1, "model": 2}, world_size=8,
                  device="cpu")
    assert m.shape == {"data": 4, "model": 2}
    assert m.shape == dict(j_make_mesh({"data": -1, "model": 2}).shape)
    with pytest.raises(ValueError, match="needs 16 devices, have 8"):
        make_mesh({"data": 16}, world_size=8, device="cpu")
    ids = np.vectorize(lambda d: d.id)(
        j_make_mesh({"data": 2, "model": 2}).devices)
    for rank in range(4):
        c = make_mesh({"data": 2, "model": 2}, world_size=4,
                      rank=rank, device="cpu").coords
        assert ids[c["data"], c["model"]] == rank
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()
    one = make_mesh(device="cpu")
    assert one.shape == {"data": 1} and one.group("data") is None
    x = torch.arange(6.0).reshape(3, 2)
    assert comm.all_reduce_sum(x, None) is x
    assert comm.all_to_all(x, None) is x


def _reduction_cases():
    rng = np.random.default_rng(0)
    e, n, d = 512, 64, 16
    data = rng.integers(-8, 9, size=(e, d)).astype(np.float32)
    ids = rng.integers(0, n, e).astype(np.int32)
    mask = rng.random(e) < 0.8
    cases = {f"reduce_{r}": dict(kind="reduce", reducer=r, data=data,
                                 ids=ids, num_segments=n, mask=mask)
             for r in ("max", "sum", "mean")}
    cases["empty"] = dict(kind="reduce", reducer="max",
                          data=np.full((8, 4), -5.0, np.float32),
                          ids=np.zeros(8, np.int32), num_segments=3,
                          mask=np.ones(8, bool))
    rng = np.random.default_rng(1)
    n, e, d, de = 32, 256, 8, 4
    cases["aggregate"] = dict(
        kind="aggregate", x=rng.normal(size=(n, d)).astype(np.float32),
        s=rng.integers(0, n, e).astype(np.int32),
        r=rng.integers(0, n, e).astype(np.int32),
        e=rng.normal(size=(e, de)).astype(np.float32),
        mask=rng.random(e) < 0.9,
        w=rng.normal(size=(2 * d + de, d)).astype(np.float32))
    rng = np.random.default_rng(7)
    n, e = 128, 600
    s, r = rng.integers(0, n, e), rng.integers(0, n, e)
    mask = rng.random(e) < 0.9
    x = rng.normal(size=(n, 12)).astype(np.float32)
    ef = rng.normal(size=(e, 3)).astype(np.float32)
    for red in ("max", "sum"):
        cases[f"halo_{red}"] = dict(kind="halo", reducer=red, x=x, s=s, r=r,
                                    mask=mask, e=ef)
    rng = np.random.default_rng(11)
    n, e, d, h, de = 96, 400, 6, 10, 3
    cases["halo_mpnn"] = dict(
        kind="halo", reducer="max", s=rng.integers(0, n, e),
        r=rng.integers(0, n, e), x=rng.normal(size=(n, d)).astype(np.float32),
        e=rng.normal(size=(e, de)).astype(np.float32),
        w_s=rng.normal(size=(d, h)).astype(np.float32),
        w_e=rng.normal(size=(de, h)).astype(np.float32))
    return cases


def _dp_case():
    """tests/test_parallel.py's data-parallel case: 8 frames of 80 points in
    one batch of 8 graphs, the unfused model, two steps."""
    samples = j_make_samples(num_frames=8, num_points=80, seed=0)
    batch = j_stack(samples, max_nodes=96, bg_index=5, max_edges=96 * 20)
    kw = dict(node_feature_dimension=samples[0].node_feat.shape[1],
              edge_feature_dimension=2, conv_layer_dimensions=[16, 16],
              classification_head_layer_dimensions=[6],
              regression_head_layer_dimensions=[8, 5],
              batch_norm_in_mlps=False)
    train = dict(dataset="radarscenes", learning_rate=LR, epochs=1,
                 batch_size=8, shuffle=False, bg_index=5,
                 adapt_orientation_angle=True)
    model, variables = create_detnet_state(JArch(**kw), jax.random.key(0),
                                           batch)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    payload = dict(arch=dataclasses.asdict(GNNArchitectureConfig(**kw)),
                   train=train, samples=W.sample_dicts(samples),
                   batch_size=8, max_nodes=96, max_edges=96 * 20, epochs=2,
                   state=_state(variables))
    return (model, variables, batch, train), payload


def _state(variables):
    return {k: v.numpy()
            for k, v in weights.from_jax_variables(variables).items()}


def _tp_case():
    """tests/test_tensor_parallel.py's case: 8 frames in batches of 4, the
    unfused model with embeddings, two epochs, a {"data": 2, "model": 2}
    mesh."""
    samples = _tp_samples(n_frames=8)
    loader = JLoader(samples, 4, False, 5, pad_align=16)
    example = j_stack(samples[:4], loader.max_nodes, 5, loader.max_edges)
    arch = _tp_arch(example.node_feat.shape[-1], example.edge_feat.shape[-1])
    model, variables = create_detnet_state(arch, jax.random.key(0), example)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    train = dict(dataset="radarscenes", learning_rate=LR, epochs=1,
                 batch_size=4, shuffle=False, bg_index=5,
                 adapt_orientation_angle=True)
    payload = dict(arch=dataclasses.asdict(arch), train=train,
                   samples=W.sample_dicts(samples), batch_size=4,
                   max_nodes=loader.max_nodes, max_edges=loader.max_edges,
                   epochs=2, state=_state(variables),
                   mesh={"data": 2, "model": 2})
    return (model, variables, loader, train), payload


@pytest.fixture(scope="module")
def port_runs():
    """One spawn of 4 gloo ranks: the reductions, the data-parallel
    trainer ({"data": 4}; and each rank alone), the tensor-parallel
    trainer and the replicated one on {"data": 2, "model": 2}."""
    cases = _reduction_cases()
    dp, tp = _dp_case(), _tp_case()
    tp_train = dict(tp[1]["train"], shard_params_over_model=True)
    jobs = [("reductions_worker", cases),
            ("trainer_worker", dict(dp[1], mesh={"data": WORLD})),
            ("trainer_worker", dict(dp[1], mesh=None)),
            ("trainer_worker", dict(tp[1], train=tp_train)),
            ("trainer_worker", tp[1])]
    # a loaded host may slow the ranks several-fold: a generous limit
    res = run_ranks(W.jobs_worker, WORLD, args=(jobs,), timeout_s=900)
    return dict(cases=cases, dp=dp, tp=tp,
                reductions=[r[0] for r in res],
                dp_mesh=[r[1] for r in res], dp_single=res[0][2],
                tp_sharded=[r[3] for r in res], tp_rep=[r[4] for r in res])


@pytest.mark.parametrize("reducer", ["max", "sum", "mean"])
def test_partitioned_segment_reduce_matches_jax(port_runs, reducer):
    c = port_runs["cases"][f"reduce_{reducer}"]
    mesh = j_make_mesh({"model": 8})
    want = np.asarray(jax.jit(lambda d, i, m: j_reduce(
        reducer, d, i, c["num_segments"], m, mesh))(
            jnp.asarray(c["data"]), jnp.asarray(c["ids"]),
            jnp.asarray(c["mask"])))
    for r in port_runs["reductions"]:
        np.testing.assert_array_equal(r[f"reduce_{reducer}"], want)


def test_partitioned_empty_segments_zero(port_runs):
    got = port_runs["reductions"][0]["empty"]
    np.testing.assert_array_equal(got[0], [-5.0] * 4)
    np.testing.assert_array_equal(got[1:], 0.0)


def test_edge_partitioned_aggregate_matches_jax(port_runs):
    c = port_runs["cases"]["aggregate"]
    w = jnp.asarray(c["w"])

    def message_fn(x_r, x_s, e_):
        return jnp.concatenate([x_r, x_s, e_], axis=-1) @ w

    mesh = j_make_mesh({"model": 8})
    want = np.asarray(jax.jit(lambda *a: j_edge_aggregate(
        message_fn, "max", *a, mesh))(*(jnp.asarray(c[k]) for k in (
            "x", "s", "r", "e", "mask"))))
    for r in port_runs["reductions"]:
        np.testing.assert_allclose(r["aggregate"], want, rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("name", ["halo_max", "halo_sum", "halo_mpnn"])
def test_halo_segment_reduce_matches_jax(port_runs, name):
    """The boundary all_to_all and the local / halo partials on 4 ranks
    (each returns its node shard) against the JAX package's on 8 devices
    (the MPNN case: the hoisted max's affine sender and edge projections,
    tests/test_parallel.py:163)."""
    c = port_runs["cases"][name]
    n = c["x"].shape[0]
    if "w_s" in c:
        w_s, w_e = jnp.asarray(c["w_s"]), jnp.asarray(c["w_e"])

        def message(xs, ee):
            return xs @ w_s + ee @ w_e
    else:
        def message(xs, ee):
            return xs * 1.5 + ee.sum(axis=-1, keepdims=True)
    plan = j_halo_plan(c["s"], c["r"], n, 8, edge_mask=c.get("mask"))
    mesh = j_make_mesh({"model": 8})
    want = np.asarray(jax.jit(lambda x, e: j_halo_reduce(
        c["reducer"], x, message, e, plan, mesh))(jnp.asarray(c["x"]),
                                                  jnp.asarray(c["e"])))
    got = np.concatenate([r[name] for r in port_runs["reductions"]])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_dp_training_matches_jax(port_runs):
    """Two steps on a {"data": 4} mesh of gloo ranks (2 graphs each) against
    the JAX Trainer on one device (tests/test_parallel.py holds its own
    mesh to that, rtol 1e-5); the ranks agree bitwise, and one rank alone
    trains the same."""
    model, variables, batch, train = port_runs["dp"][0]
    t = JTrainer(JTrainingConfig(**train), model,
                 jax.tree_util.tree_map(jnp.asarray, variables))
    want = []
    state = t.state
    for _ in range(2):
        state, out = t._train_step(state, batch)
        want.append(float(out[0]))
    ranks = port_runs["dp_mesh"]
    assert all(r["losses"] == ranks[0]["losses"] for r in ranks)
    got = [step[0] for step in ranks[0]["losses"]]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    single = [step[0] for step in port_runs["dp_single"]["losses"]]
    np.testing.assert_allclose(got, single, rtol=1e-5, atol=1e-6)


def test_detnet_param_shardings_match_jax():
    """The column-parallel plan names the same parameters as the JAX
    package's (P(None, "model") / P("model") against dim 0; the rest
    replicated), mapped through the weight bridge."""
    samples = _tp_samples()
    batch = j_stack(samples, 64, 5)
    arch = _tp_arch(batch.node_feat.shape[-1], batch.edge_feat.shape[-1])
    _, variables = create_detnet_state(arch, jax.random.key(0), batch)
    jplan = jtensor.detnet_param_shardings(
        j_make_mesh({"data": 2, "model": 2}), variables["params"])
    model = DetNet(GNNArchitectureConfig(**dataclasses.asdict(arch)),
                   device="cpu")
    plan = ttensor.detnet_param_shardings(
        make_mesh({"data": 2, "model": 2}, world_size=4, device="cpu"),
        model)
    marks = weights.to_jax_variables({
        name: torch.full(p.shape, 1.0 if plan[name] is not None else 0.0)
        for name, p in model.named_parameters()})["params"]
    got = jax.tree_util.tree_flatten_with_path(marks)[0]
    want = jax.tree_util.tree_flatten_with_path(
        jplan, is_leaf=lambda x: hasattr(x, "spec"))[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    n_sharded = 0
    for (path, mark), (_, sh) in zip(got, want):
        assert (float(mark.flat[0]) == 1.0) == (sh.spec != P()), path
        n_sharded += sh.spec != P()
    assert n_sharded >= 5


def test_pipeline_stage_assignment_matches_jax():
    for dims, stages in (([224, 224, 128, 64, 32], 2), ([64, 32], 4),
                         ([64, 32, 16], 1), ([224, 224, 128, 64, 32], 3),
                         ([16] * 7, 4)):
        assert ttensor.pipeline_stage_assignment(dims, stages) == \
            jtensor.pipeline_stage_assignment(dims, stages)
    with pytest.raises(ValueError):
        ttensor.pipeline_stage_assignment([8], 0)


def test_tp_training_matches_replicated_and_jax(port_runs):
    """Column-parallel weights on {"data": 2, "model": 2} (each rank keeps
    its shards and their Adam moments; the weights all-gathered before use)
    train as replicated weights on the same mesh (rtol 1e-4, the JAX
    test's) and as the JAX package's column-parallel trainer; the shards
    stay shards and the ranks end with identical weights."""
    model, variables, loader, train = port_runs["tp"][0]
    mesh = j_make_mesh({"data": 2, "model": 2})
    t = JTrainer(JTrainingConfig(**train, shard_params_over_model=True),
                 model, jax.tree_util.tree_map(jnp.asarray, variables),
                 mesh=mesh)
    want = []
    for _ in range(2):
        for b in loader:
            t.state, out = t._train_step(t.state, b)
            want.append(float(out[0]))
    sharded, rep = port_runs["tp_sharded"], port_runs["tp_rep"]
    got = [s[0] for s in sharded[0]["losses"]]
    assert all(r["losses"] == sharded[0]["losses"] for r in sharded)
    np.testing.assert_allclose(got, [s[0] for s in rep[0]["losses"]],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    for k, v in sharded[0]["state"].items():
        for r in sharded[1:]:
            np.testing.assert_array_equal(r["state"][k], v, err_msg=k)
    # the checkpoint's Adam moments, all-gathered from the shards, are the
    # replicated run's
    assert sharded[0]["moments"].keys() == rep[0]["moments"].keys()
    for k, v in sharded[0]["moments"].items():
        np.testing.assert_allclose(v, rep[0]["moments"][k], rtol=1e-5,
                                   atol=1e-9, err_msg=k)


def test_run_ranks_reports_a_failed_rank():
    """A rank's exception reaches the caller with its traceback, and the
    other ranks are stopped."""
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"):
        run_ranks(W.raises_on_rank_one, 2, timeout_s=60)
