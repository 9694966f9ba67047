"""The port's halo edge partitioning (radargnn_tpu_torch.parallel.halo,
halo_dense, halo_windowed, the halo batch, loader, trainer and CLI)
against the JAX package's, on the CPU.

The host plans (`build_halo_plan`, `build_halo_dense_plan`,
`build_halo_windowed_plan`), the budgets, the stacked halo batches and the
loader's batches must equal the JAX package's array for array. The
aggregates and the trainer run on 4 gloo ranks, a {"data": 2, "model": 2}
mesh (`parallel.comm.run_ranks`, the workers in `torch_parallel_workers`,
one spawn for the module), against the JAX package on its 8-device CPU
mesh (the Pallas kernels in interpret mode, under jit), at the sizes of
`tests/test_halo_dense.py` and `tests/test_halo_training.py` (48-point
frames, k 4, widths 8-16).

Tolerances. The aggregate's forward is a max of the same float32
operands, in another summation order of x @ w_s: within 1e-5 of the
output's scale; its gradients (x, w_s, w_e, offset of sum(out²)) within
1e-4 of each gradient's scale. The trainers' four steps: losses within
rtol 1e-4 / atol 1e-5 (the JAX package's own halo-vs-plain test allows
5e-3; the port and the JAX halo trainer differ in summation order only),
and the weights after them within 4·lr (Adam moves a weight whose gradient
is within rounding of 0 by ±lr a step: tests/test_torch_trainer.py). The
same check fails when the BatchNorm statistics or the loss denominators
are taken per rank (`test_halo_trainer_faults_fail_the_parity_check`)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radargnn_tpu.configs import GNNArchitectureConfig as JArch
from radargnn_tpu.configs import TrainingConfig as JTrainingConfig
from radargnn_tpu.data.loader import GraphDataLoader as JLoader
from radargnn_tpu.graph import batch as jbatch
from radargnn_tpu.models.detnet import create_detnet_state
from radargnn_tpu.parallel import halo as jhalo
from radargnn_tpu.parallel import halo_dense as jhd
from radargnn_tpu.parallel import halo_windowed as jhw
from radargnn_tpu.parallel.mesh import make_mesh as j_make_mesh
from radargnn_tpu.train.trainer import Trainer as JTrainer
from radargnn_tpu_torch import weights
from radargnn_tpu_torch.cli import train as ttrain
from radargnn_tpu_torch.configs import GNNArchitectureConfig
from radargnn_tpu_torch.data import loader as tloader
from radargnn_tpu_torch.graph import batch as tbatch
from radargnn_tpu_torch.models.layers import fused_csr_tiling
from radargnn_tpu_torch.parallel import halo as thalo
from radargnn_tpu_torch.parallel import halo_dense as thd
from radargnn_tpu_torch.parallel import halo_windowed as thw
from radargnn_tpu_torch.parallel.comm import run_ranks
from radargnn_tpu_torch.parallel.mesh import make_mesh
from tests.test_halo_dense import DENSE
from tests.test_halo_training import CSR, HALO, _arch, _samples

import torch_parallel_workers as W
from torch_threads import THREADS, few_threads  # noqa: F401

TILINGS = {"dense": DENSE, "windowed": CSR}
LR = 1e-3
TRAIN_KW = dict(dataset="radarscenes", learning_rate=LR, epochs=2,
                batch_size=4, shuffle=False, bg_index=5,
                adapt_orientation_angle=True)
FAULTS = ("per_rank_batch_norm", "per_rank_loss")


def _fields(plan):
    return {f.name: getattr(plan, f.name) for f in dataclasses.fields(plan)}


def _assert_plans_equal(got, want):
    g, w = _fields(got), _fields(want)
    assert g.keys() == w.keys()
    for k in g:
        if k == "halo":
            _assert_plans_equal(g[k], w[k])
        elif isinstance(w[k], np.ndarray):
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        else:
            assert g[k] == w[k], k


def _max_edges(samples):
    return -(-max(s.num_edges for s in samples) // 16) * 16


def _halo_batches(tiling, samples):
    """One halo batch of `samples` from each package, shared budgets."""
    max_edges = _max_edges(samples)
    jb = jbatch.halo_dataset_budgets(samples, 64, max_edges, 5, tiling, HALO)
    tb = tbatch.halo_dataset_budgets(W.samples_of(W.sample_dicts(samples)),
                                     64, max_edges, 5, tiling, HALO)
    assert tb == jb
    return (jbatch.stack_samples(samples, 64, 5, max_edges,
                                 csr_tiling=tiling,
                                 halo_partition=dict(HALO, budgets=jb)),
            tbatch.stack_samples(W.samples_of(W.sample_dicts(samples)), 64,
                                 5, max_edges, csr_tiling=tiling,
                                 halo_partition=dict(HALO, budgets=tb),
                                 device="cpu"),
            max_edges, jb)


def _assert_batches_equal(tb, jb):
    assert tb.halo_geometry == jb.halo_geometry
    n = 0
    for name, value in tb.tensors().items():
        want = getattr(jb, name)
        assert want is not None, name
        np.testing.assert_array_equal(value.numpy(), np.asarray(want),
                                      err_msg=name)
        n += 1
    assert n == 20
    assert tb.host_valid_edges == jb.host_valid_edges


# ---------------------------------------------------------------------------
# host plans and batches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("overrides", [{}, {"halo_b": 40, "loc_width": 64,
                                            "halo_width": 120}])
def test_halo_plan_matches_jax(overrides):
    rng = np.random.default_rng(7)
    n, e = 128, 600
    s, r = rng.integers(0, n, e), rng.integers(0, n, e)
    mask = rng.random(e) < 0.9
    for p in (2, 4, 8):
        if overrides and p != 4:
            continue
        _assert_plans_equal(
            thalo.build_halo_plan(s, r, n, p, edge_mask=mask, **overrides),
            jhalo.build_halo_plan(s, r, n, p, edge_mask=mask, **overrides))
    with pytest.raises(ValueError, match="halo_b override 8 < required"):
        thalo.build_halo_plan(s, r, n, 4, halo_b=8)


@pytest.mark.parametrize("run_cap", [None, 2])
def test_halo_windowed_plan_matches_jax(run_cap):
    rng = np.random.default_rng(11)
    n, e = 64, 400
    s = rng.integers(0, n, e).astype(np.int32)
    r = rng.integers(0, n, e).astype(np.int32)
    mask = rng.random(e) < 0.9
    kw = dict(node_block=8, edge_tile=16, window_blocks=2, edge_mask=mask,
              ovf_frac=0.6, run_cap=run_cap)
    got = thw.build_halo_windowed_plan(s, r, n, 4, **kw)
    _assert_plans_equal(got, jhw.build_halo_windowed_plan(s, r, n, 4, **kw))
    assert thw.plan_budgets(got) == jhw.plan_budgets(
        jhw.build_halo_windowed_plan(s, r, n, 4, **kw))


def test_halo_dense_plan_matches_jax():
    samples = _samples()
    s0 = jbatch.pad_sample(samples[0], 64, _max_edges(samples), 5)
    kw = dict(edge_mask=s0["edge_mask"], ovf_frac=0.8)
    got = thd.build_halo_dense_plan(s0["senders"], s0["receivers"], 64, 2,
                                    8, 8, 16, 2, **kw)
    want = jhd.build_halo_dense_plan(s0["senders"], s0["receivers"], 64, 2,
                                     8, 8, 16, 2, **kw)
    _assert_plans_equal(got, want)
    assert thd.plan_budgets_dense(got) == jhd.plan_budgets_dense(want)


def test_halo_dense_overflow_budget_names_the_fraction():
    """A plan whose per-shard overflow exceeds halo_overflow_fraction of the
    local budget raises, naming the knob, as the JAX planner does."""
    s0 = jbatch.pad_sample(_samples()[0], 64, 256, 5)
    args = (s0["senders"], s0["receivers"], 64, 2, 2, 8, 16, 2)
    with pytest.raises(ValueError, match="raise halo_overflow_fraction"):
        thd.build_halo_dense_plan(*args, edge_mask=s0["edge_mask"],
                                  ovf_frac=0.01)
    with pytest.raises(ValueError, match="raise halo_overflow_fraction"):
        jhd.build_halo_dense_plan(*args, edge_mask=s0["edge_mask"],
                                  ovf_frac=0.01)


@pytest.mark.parametrize("family", sorted(TILINGS))
def test_halo_batches_match_jax(family):
    jb, tb, _, _ = _halo_batches(TILINGS[family], _samples())
    _assert_batches_equal(tb, jb)
    assert tb.tiled_senders is None and tb.sender_landing is None


@pytest.mark.parametrize("family", sorted(TILINGS))
def test_halo_loader_batches_match_jax(family):
    """The loaders' halo batches (shared dataset budgets with the
    batch-padding empty graph, bucket aligned to mp) are the JAX loader's,
    one shape and geometry for all."""
    samples = _samples(n_frames=6, n_points=40, seed=9)
    tiling = TILINGS[family]
    jl = JLoader(samples, 4, False, 5, csr_tiling=tiling,
                 halo_partition=dict(HALO), pad_align=16)
    tl = tloader.GraphDataLoader(W.samples_of(W.sample_dicts(samples)), 4,
                                 False, 5, csr_tiling=tiling,
                                 halo_partition=dict(HALO), pad_align=16,
                                 device="cpu")
    assert tl.halo_partition == jl.halo_partition
    pairs = list(zip(tl, jl))
    assert len(pairs) == 2
    for tb, jb in pairs:
        _assert_batches_equal(tb, jb)
        assert tb.halo_geometry == pairs[0][0].halo_geometry
    with pytest.raises(ValueError, match="batch_size must divide"):
        tloader.GraphDataLoader(W.samples_of(W.sample_dicts(samples)), 3,
                                False, 5, csr_tiling=tiling,
                                halo_partition=dict(HALO), device="cpu")


@pytest.mark.parametrize("family", sorted(TILINGS))
def test_loader_under_a_mesh_yields_each_rank_its_shard(family):
    """With `mesh` the loader yields each rank's part of its halo batches
    on the mesh's device: the batch's `rank_shard` for its (d, m), sender
    landing included; with `cache_batches` the same parts every epoch."""
    samples = W.samples_of(W.sample_dicts(_samples(n_frames=6, n_points=40,
                                                   seed=9)))
    kw = dict(csr_tiling=TILINGS[family], halo_partition=dict(HALO),
              pad_align=16)
    plain = list(tloader.GraphDataLoader(samples, 4, False, 5, device="cpu",
                                         **kw))
    for rank in range(4):
        mesh = make_mesh({"data": 2, "model": 2}, world_size=4, rank=rank,
                         device="cpu")
        loader = tloader.GraphDataLoader(samples, 4, False, 5, mesh=mesh,
                                         cache_batches=True, **kw)
        got = list(loader)
        d, m = mesh.coord("data"), mesh.coord("model")
        assert len(got) == len(plain) == 2
        for part, full in zip(got, plain):
            want = full.rank_shard(d, 2, m, 2)
            assert part.mesh_shard == want.mesh_shard == (d, 2, m, 2)
            for name, value in want.tensors().items():
                torch.testing.assert_close(getattr(part, name), value,
                                           rtol=0, atol=0, equal_nan=True,
                                           msg=name)
            for u, v in zip(part.halo_landing, want.halo_landing):
                torch.testing.assert_close(u, v, rtol=0, atol=0)
        assert all(a is b for a, b in zip(loader, got))


def test_rank_shards_are_the_shard_major_blocks():
    """`rank_shard` gives rank (d, m) its graphs' node shard m: together the
    ranks' node rows are `shard_major_nodes` of the batch, and the inverse
    permutation restores it (numpy and torch alike, as the JAX package's)."""
    _, tb, _, _ = _halo_batches(DENSE, _samples())
    g, n = tb.node_mask.shape
    feat = tb.node_feat.numpy()
    flat = thw.shard_major_nodes(feat, g, n, 2, 2)
    np.testing.assert_array_equal(
        flat, np.asarray(jhw.shard_major_nodes(jnp.asarray(feat), g, n, 2,
                                               2)))
    parts = [tb.rank_shard(d, 2, m, 2).node_feat.reshape(-1, feat.shape[-1])
             .numpy() for d in range(2) for m in range(2)]
    np.testing.assert_array_equal(np.concatenate(parts), flat)
    np.testing.assert_array_equal(
        thw.unshard_major_nodes(flat, g, n, 2, 2), feat)
    with pytest.raises(ValueError, match="parallel.mesh.shard_batch"):
        tb.flat_halo(None)


def test_halo_partition_from_configs_matches_jax():
    """The CLI's halo partition: the JAX package's dict for a model axis,
    None without one, SystemExit under the CSR tiling; the dense tiling is
    accepted (test_halo_dense.py's CLI case)."""
    kw = dict(node_feature_dimension=5, edge_feature_dimension=2,
              conv_layer_dimensions=[8],
              classification_head_layer_dimensions=[6],
              regression_head_layer_dimensions=[5],
              use_fused_aggregation=True, fused_tiling="dense",
              halo_overflow_fraction=0.7)
    arch, jarch = GNNArchitectureConfig(**kw), JArch(**kw)
    mesh = make_mesh({"data": 2, "model": 2}, world_size=4, device="cpu")
    tiling = fused_csr_tiling(arch, k=5)
    got = ttrain.halo_partition_from_configs(arch, mesh, tiling)
    assert got == {"dp": 2, "mp": 2, "ovf_frac": 0.7}
    from radargnn_tpu.cli.train import halo_partition_from_configs as jhp
    from radargnn_tpu.models.layers import fused_csr_tiling as jtiling
    assert got == jhp(jarch, j_make_mesh({"data": 2, "model": 2}),
                      jtiling(jarch, k=5))
    windowed = dataclasses.replace(arch, fused_tiling="windowed")
    assert ttrain.halo_partition_from_configs(windowed, mesh) == got
    assert ttrain.halo_partition_from_configs(
        arch, make_mesh({"data": 2}, world_size=2, device="cpu")) is None
    with pytest.raises(SystemExit, match="windowed or dense tiling"):
        ttrain.halo_partition_from_configs(
            dataclasses.replace(arch, fused_tiling="csr"), mesh)


# ---------------------------------------------------------------------------
# four gloo ranks: the aggregates and the trainers
# ---------------------------------------------------------------------------

def _aggregate_case(tiling):
    samples = _samples()
    jb, _, max_edges, budgets = _halo_batches(tiling, samples)
    g, n = jb.node_mask.shape
    d, de, h = jb.node_feat.shape[-1], jb.edge_feat.shape[-1], 16
    rng = np.random.default_rng(0)
    w_s = rng.normal(size=(d, h)).astype(np.float32) * 0.4
    w_e = rng.normal(size=(de, h)).astype(np.float32) * 0.4
    offset = rng.normal(size=(g, n, h)).astype(np.float32)
    payload = dict(samples=W.sample_dicts(samples), max_nodes=64,
                   max_edges=max_edges, tiling=tiling,
                   halo=dict(HALO, budgets=budgets), offset=offset,
                   w_s=w_s, w_e=w_e)
    return jb, payload


def _trainer_case(tiling):
    samples = _samples(n_frames=8)
    loader = JLoader(samples, 4, False, 5, csr_tiling=tiling,
                     halo_partition=dict(HALO), pad_align=16)
    example = jbatch.stack_samples(samples[:4], loader.max_nodes, 5,
                                   loader.max_edges)
    arch = _arch(example.node_feat.shape[-1], example.edge_feat.shape[-1])
    model, variables = create_detnet_state(arch, jax.random.key(0), example)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    payload = dict(arch=dataclasses.asdict(arch), train=TRAIN_KW,
                   samples=W.sample_dicts(samples), batch_size=4,
                   tiling=tiling, halo=dict(HALO),
                   state={k: v.numpy() for k, v in
                          weights.from_jax_variables(variables).items()},
                   epochs=2, mesh={"data": 2, "model": 2})
    return (model, variables, loader), payload


@pytest.fixture(scope="module")
def port_runs():
    """One spawn of 4 gloo ranks for the module: both aggregates, both halo
    trainers, and the dense trainer under each fault."""
    cases = {f: (_aggregate_case(t), _trainer_case(t))
             for f, t in TILINGS.items()}
    jobs = []
    for f in sorted(TILINGS):
        jobs += [("halo_aggregate_worker", cases[f][0][1]),
                 ("trainer_worker", cases[f][1][1])]
    jobs += [("trainer_worker", dict(cases["dense"][1][1], fault=fault))
             for fault in FAULTS]
    # a loaded host may slow the ranks several-fold: a generous limit
    res = run_ranks(W.jobs_worker, 4, args=(jobs,), timeout_s=900)
    out = {}
    for i, f in enumerate(sorted(TILINGS)):
        out[f] = dict(aggregate=[r[2 * i] for r in res],
                      trainer=[r[2 * i + 1] for r in res],
                      cases=cases[f])
    for i, fault in enumerate(FAULTS):
        out[fault] = [r[4 + i] for r in res]
    return out


def _jax_halo_losses(jax_side):
    model, variables, loader = jax_side
    t = JTrainer(JTrainingConfig(**TRAIN_KW), model,
                 jax.tree_util.tree_map(jnp.asarray, variables),
                 mesh=j_make_mesh({"data": 2, "model": 2}))
    losses = []
    for _ in range(2):
        for b in loader:
            t.state, out = t._train_step(t.state, b)
            losses.append([float(v) for v in out])
    return losses, jax.device_get(t.state.params)


@pytest.fixture(scope="module")
def jax_trainers(port_runs):
    return {f: _jax_halo_losses(port_runs[f]["cases"][1][0])
            for f in sorted(TILINGS)}


@pytest.mark.parametrize("family", sorted(TILINGS))
def test_halo_aggregate_matches_jax(port_runs, family):
    """`halo_hoisted_max_batched` on 4 gloo ranks against the JAX package's
    on a {"data": 2, "model": 2} mesh: the forward (the ranks' rows in
    shard-major order) and the gradients of x, w_s, w_e and offset."""
    jb, payload = port_runs[family]["cases"][0]
    g, n = jb.node_mask.shape
    bundle = jb.flat_halo(j_make_mesh({"data": 2, "model": 2}))
    assert bundle.geometry[9:10] == (("dense",) if family == "dense" else ())

    def perm(a):
        return jhw.shard_major_nodes(a, g, n, 2, 2)

    def f(x, w_s, w_e, off):
        return jhw.halo_hoisted_max_batched(perm(x), w_s, w_e, perm(off),
                                            bundle)

    args = (jb.node_feat, jnp.asarray(payload["w_s"]),
            jnp.asarray(payload["w_e"]), jnp.asarray(payload["offset"]))
    want = np.asarray(jax.jit(f)(*args))
    grads = jax.jit(jax.grad(lambda *a: (f(*a) ** 2).sum(),
                             argnums=(0, 1, 2, 3)))(*args)
    ranks = port_runs[family]["aggregate"]
    got = np.concatenate([r["out"] for r in ranks])
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    for name, mine, ref in (
            ("x", np.concatenate([r["d_x"] for r in ranks]),
             perm(grads[0])),
            ("offset", np.concatenate([r["d_off"] for r in ranks]),
             perm(grads[3])),
            ("w_s", ranks[0]["d_ws"], grads[1]),
            ("w_e", ranks[0]["d_we"], grads[2])):
        ref = np.asarray(ref)
        np.testing.assert_allclose(mine, ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max(),
                                   err_msg=name)
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["d_ws"], ranks[0]["d_ws"])
    assert all(r["launches"] == [0] * 5 for r in ranks)   # CPU: plain


def _assert_losses_close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("family", sorted(TILINGS))
def test_halo_trainer_matches_jax(port_runs, jax_trainers, family):
    """Four steps (two epochs of two batches of 4 graphs) of the port's
    Trainer on the {"data": 2, "model": 2} mesh of gloo ranks against the
    JAX Trainer on its mesh: every rank reports the batch's losses, the
    same on every rank, and the ranks end with identical weights."""
    want, params = jax_trainers[family]
    ranks = port_runs[family]["trainer"]
    for r in ranks:
        assert r["losses"] == ranks[0]["losses"]
        for k, v in r["state"].items():
            np.testing.assert_array_equal(v, ranks[0]["state"][k],
                                          err_msg=k)
    _assert_losses_close(ranks[0]["losses"], want)
    back = weights.to_jax_variables(
        {k: torch.from_numpy(v) for k, v in ranks[0]["state"].items()}
    )["params"]
    got_flat = jax.tree_util.tree_flatten_with_path(back)[0]
    want_flat = jax.tree_util.tree_flatten_with_path(params)[0]
    assert [p for p, _ in got_flat] == [p for p, _ in want_flat]
    for (path, u), (_, v) in zip(got_flat, want_flat):
        np.testing.assert_allclose(u, np.asarray(v), rtol=0, atol=4 * LR,
                                   err_msg=str(path))


@pytest.mark.parametrize("fault", FAULTS)
def test_halo_trainer_faults_fail_the_parity_check(port_runs, jax_trainers,
                                                   fault):
    """The parity check catches the collectives that are easy to leave out:
    with per-rank BatchNorm statistics, or each rank's loss over its own
    rows, the sharded training still runs but leaves the JAX losses."""
    got = port_runs[fault][0]["losses"]
    assert np.isfinite(got).all()
    with pytest.raises(AssertionError):
        _assert_losses_close(got, jax_trainers["dense"][0])


# ---------------------------------------------------------------------------
# the train CLI on two gloo ranks
# ---------------------------------------------------------------------------

def test_cli_trains_under_mesh_axes_on_two_gloo_ranks(tmp_path):
    """`cli.train.main` under mesh_axes {"model": 2} on 2 gloo ranks (the
    flagship YAML at narrow widths, dense tiling, one epoch): halo
    partitioning from the configuration, rank 0 writes the model folder,
    the other waits. One process cannot fill that mesh and refuses."""
    _cli_trains_under_mesh_axes(tmp_path, {})


def test_cli_trains_radar_pointgnn_under_mesh_axes_on_two_gloo_ranks(
        tmp_path):
    """The same with conv_layer_type "RadarPointGNNConv" replaced in the
    YAML: its one-layer pre-MLP and max aggregation take the halo path,
    the offset its pre-MLP bias broadcast over each rank's rows."""
    _cli_trains_under_mesh_axes(tmp_path,
                                {"conv_layer_type": "RadarPointGNNConv"})


def _cli_trains_under_mesh_axes(tmp_path, replaced):
    from radargnn_tpu_torch import smoke

    root = str(tmp_path / "data")
    smoke.write_processed(root, train=4, validate=2, points=64)
    config = smoke.cli_config(str(tmp_path), replaced=dict({
        "epochs": 1, "batch_size": 2, "checkpoint_every_epochs": 1,
        "mesh_axes": {"model": 2}, "conv_layer_dimensions": [16, 8]},
        **replaced))
    results = tmp_path / "results"
    results.mkdir()
    data = str(tmp_path / "data" / "processed")
    files = run_ranks(W.cli_train_worker, 2,
                      args=(data, str(results), config), timeout_s=900)
    assert files[0] == files[1]
    assert {"trained_model.msgpack", "loss_train.npy",
            "gnn_configs.json"} <= set(files[0])
    losses = np.load(results / "model_01" / "loss_train.npy")
    assert losses.shape == (1, 1) and np.isfinite(losses).all()
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        ttrain.main(data, str(results), config, device="cpu")


@pytest.fixture(scope="module")
def mpnn_phase():
    """The smoke's tenth phase's MPNNConv runs at 2 x 512 points (the size
    of the RadarPointGNNConv rehearsal, tests/test_torch_smoke_parallel_
    pointgnn.py, whose readings set the bias check's limits: at 2 x 96 one
    conv's offset magnitudes read 1.03e-2 from the single card's, a bf16
    rounding of a next-layer input flipped among 192 rows), with the inputs
    each run's bias check took (on `few_threads`' thread count: a module's
    fixture comes before a test's)."""
    from radargnn_tpu_torch import smoke_parallel as sp

    checked = []
    real = sp.bias_check

    def spy(*args):
        checked.append(args)
        return real(*args)

    lines = []
    was = torch.get_num_threads()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sp, "bias_check", spy)
        mp.setenv("OMP_NUM_THREADS", str(THREADS))
        torch.set_num_threads(THREADS)
        try:
            res = sp.parallel_phase("cpu", points=512, graphs=2,
                                    run_children=False, convs=("MPNNConv",),
                                    out=lines.append)
        finally:
            torch.set_num_threads(was)
    return res, lines, checked, real


@pytest.mark.usefixtures("few_threads")
def test_parallel_phase_rehearses_on_cpu(mpnn_phase):
    """The smoke's tenth phase (`smoke_parallel.parallel_phase`) at a small
    size with gloo ranks on the CPU, where the wrappers take their plain
    versions and launch nothing: halo x dense and halo x windowed on a
    {"model": 2} mesh, each rank's aggregate equal to the single device's,
    two steps within the training limits, the request within the serving
    limit, each conv's offset bias (MPNNConv's `x @ W_r + bias`) at each
    step within the bias check's limits and printed. Its child processes
    (the scaling tool, the dry run, the train CLI under torchrun) run on
    the card only."""
    from radargnn_tpu_torch import smoke_parallel as sp
    from radargnn_tpu_torch.smoke_pointgnn import BIAS_GRAD_RTOL

    res, lines, checked, _ = mpnn_phase
    assert [(r["graph"], r["backend"]) for r in res["runs"]] == [
        ("knn", "gloo"), ("radius", "gloo")]
    for r in res["runs"]:
        assert r["agg_bitwise"] and len(r["step_agreement"]) == 2
        assert r["launches"] == {"agg": {}, "train": {}, "request": {}}
        assert [(b["step"], b["param"]) for b in r["bias"]] == [
            (i, f"conv_{k}.pre_mlp.lin_0.bias")
            for i in range(2) for k in range(5)]
        for b in r["bias"]:
            assert b["rel_diff"] <= BIAS_GRAD_RTOL
            assert b["scale_rel"] <= sp.BIAS_SCALE_RTOL
            # the trainer's sum over the ranks is the ranks' parts summed
            assert b["parts_vs_sum"] <= 1e-6
    assert len(checked) == 2
    assert sum("pre-MLP biases" in line for line in lines) == 2
    assert r["geometry"][5:7] == (1, 2) and lines[-1].startswith(
        "parallel phase on cpu: 2 runs")


@pytest.mark.usefixtures("few_threads")
@pytest.mark.parametrize("key", ["grads", "rows"])
def test_mpnn_bias_check_fails_without_the_sum_over_ranks(mpnn_phase, key):
    """The MPNNConv runs' bias check on each run's own inputs, with the sum
    over the ranks dropped from the bias gradient (rank 0's own part) or
    from the offset gradient's magnitudes (rank 0's rows alone): it raises
    on both runs, where the sound inputs passed."""
    from test_torch_smoke_parallel_pointgnn import _without_rank_sum

    _, _, checked, bias_check = mpnn_phase
    for dev, arch, batch, job, res in checked:
        assert job["conv"] == "MPNNConv"
        with pytest.raises(AssertionError, match="pre-MLP biases"):
            bias_check(dev, arch, batch, job, _without_rank_sum(res, key))


@pytest.mark.parametrize("tiling", [{"mode": "dense", "node_block": 16,
                                     "r_tile": 16, "k": 8,
                                     "window_blocks": 2, "ovf_frac": 0.6,
                                     "ovf_ssum": True},
                                    (16, 32, 2, 0.6), (16, 32)])
def test_rank_shard_of_a_tiled_batch_is_its_graphs_batch(tiling):
    """Under data parallelism a rank's shard of a tiled batch is the batch
    its graphs alone would stack to: every array and the sender (and,
    under ovf_ssum, overflow) landing, rebuilt for the rank's graphs."""
    samples = W.samples_of(W.sample_dicts(_samples(n_frames=4)))
    full = tbatch.stack_samples(samples, 64, 5, 256, csr_tiling=tiling,
                                device="cpu")
    for d in range(2):
        got = full.rank_shard(d, 2)
        want = tbatch.stack_samples(samples[2 * d:2 * d + 2], 64, 5, 256,
                                    csr_tiling=tiling, device="cpu")
        assert got.mesh_shard == (d, 2, 0, 1)
        for name, value in want.tensors().items():
            torch.testing.assert_close(getattr(got, name), value, rtol=0,
                                       atol=0, equal_nan=True, msg=name)
        for name in ("sender_landing", "ovf_landing"):
            a, b = getattr(got, name), getattr(want, name)
            assert (a is None) == (b is None), name
            for u, v in zip(a or (), b or ()):
                torch.testing.assert_close(u, v, rtol=0, atol=0, msg=name)
