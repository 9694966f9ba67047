"""The orbax checkpoint backend in the port (`train.orbax_format`,
`train.checkpoint`, `Trainer._checkpoint` / `Trainer.resume`), against the
JAX package's (`radargnn_tpu/train/checkpoint.py`, orbax-checkpoint) on
the CPU: checkpoints cross both ways bit for bit, sharded ones included,
and two gloo ranks of a {"model": 2} mesh each write their own column
slices. The port reads and writes orbax's layout with its own code
(`train.ocdbt`, `train.zstd`) and never imports orbax, tensorstore or JAX;
the tests import them to compare. Each test has a variant where the port
runs with tensorstore and zstandard blocked (as on the card's machine)."""

import contextlib
import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import serialization
from jax.sharding import NamedSharding, PartitionSpec as P

from radargnn_tpu.configs import TrainingConfig as JTrainingConfig
from radargnn_tpu.data.loader import GraphDataLoader as JLoader
from radargnn_tpu.graph.batch import stack_samples as j_stack
from radargnn_tpu.models.detnet import create_detnet_state
from radargnn_tpu.parallel.mesh import make_mesh as j_make_mesh
from radargnn_tpu.train import checkpoint as jckpt
from radargnn_tpu.train.trainer import Trainer as JTrainer
from radargnn_tpu_torch import configs as tcfg
from radargnn_tpu_torch import weights
from radargnn_tpu_torch.data.loader import GraphDataLoader
from radargnn_tpu_torch import smoke_variants as sv
from radargnn_tpu_torch.models.detnet import DetNet
from radargnn_tpu_torch.parallel.comm import run_ranks
from radargnn_tpu_torch.train import checkpoint as tckpt
from radargnn_tpu_torch.train import ocdbt, zstd
from radargnn_tpu_torch.train.trainer import Trainer
from tests.test_tensor_parallel import _arch as _tp_arch
from tests.test_tensor_parallel import _samples as _tp_samples

import torch_parallel_workers as W

LR = 1e-3
_ABSENT = object()


@contextlib.contextmanager
def _without_tensorstore(blocked=True):
    """tensorstore and zstandard cannot be imported inside (the JAX
    package's orbax, outside, still can)."""
    names = ("tensorstore", "zstandard") if blocked else ()
    saved = {n: sys.modules.get(n, _ABSENT) for n in names}
    sys.modules.update({n: None for n in names})
    try:
        yield
    finally:
        for n, m in saved.items():
            if m is _ABSENT:
                sys.modules.pop(n, None)
            else:
                sys.modules[n] = m


def _leaves(tree, prefix=()):
    if isinstance(tree, dict) and tree:
        for k, v in tree.items():
            yield from _leaves(v, prefix + (str(k),))
    else:
        yield prefix, tree


def _assert_trees_equal(got, want):
    """The same key paths, and leaves equal bit for bit with one dtype."""
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, dict):
            assert got[k] == v, k
            continue
        u, v = np.asarray(got[k]), np.asarray(v)
        assert u.dtype == v.dtype and u.shape == v.shape, k
        assert np.array_equal(u, v), k


def test_port_reads_a_sharded_jax_checkpoint(tmp_path):
    """The JAX package writes jax.Arrays sharded over {"data": 8} with
    backend="orbax" (tests/test_parallel.py's case); the port reads the
    full arrays and the meta, and a leaf's slice alone where asked."""
    _port_reads_a_sharded_jax_checkpoint(tmp_path, blocked=False)


def test_port_reads_a_sharded_jax_checkpoint_without_tensorstore(tmp_path):
    """As above, the port's reads with tensorstore and zstandard blocked."""
    _port_reads_a_sharded_jax_checkpoint(tmp_path, blocked=True)


def _port_reads_a_sharded_jax_checkpoint(tmp_path, blocked):
    mesh = j_make_mesh({"data": 8})
    sh = NamedSharding(mesh, P("data"))
    params = {"w": jax.device_put(jnp.arange(64.0).reshape(8, 8), sh),
              "b": jax.device_put(jnp.ones((8,)), sh)}
    opt_state = {"m": jax.device_put(jnp.arange(64.0).reshape(8, 8) * 2, sh),
                 "count": jnp.int32(7)}
    folder = str(tmp_path / "ck")
    jckpt.save_train_state(folder, params=params, batch_stats={},
                           opt_state=opt_state, epoch=3,
                           losses={"train": [1.0, 0.5]}, scheduler_lr=1e-3,
                           backend="orbax")
    with _without_tensorstore(blocked):
        model, opt_sd, meta = tckpt.load_train_state(folder)
    _assert_trees_equal(model, {"params": jax.device_get(params),
                                "batch_stats": {}})
    _assert_trees_equal(opt_sd, jax.device_get(opt_state))
    assert meta == {"epoch": 3, "scheduler_lr": 1e-3,
                    "losses": {"train": [1.0, 0.5]}}
    with _without_tensorstore(blocked):
        model, _, _ = tckpt.load_train_state(
            folder, lambda path, shape: (slice(None), slice(2, 4))
            if path == ("params", "w") else None)
    np.testing.assert_array_equal(model["params"]["w"],
                                  np.arange(64.0).reshape(8, 8)[:, 2:4])


def _tp_case(n_frames=4):
    """tests/test_tensor_parallel.py's model and frames, batches of 2, the
    JAX trainer's state (its optimizer state is the restore target)."""
    samples = _tp_samples(n_frames=n_frames)
    loader = JLoader(samples, 2, False, 5, pad_align=16)
    example = j_stack(samples[:2], loader.max_nodes, 5, loader.max_edges)
    arch = _tp_arch(example.node_feat.shape[-1], example.edge_feat.shape[-1])
    model, variables = create_detnet_state(arch, jax.random.key(0), example)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    train = dict(dataset="radarscenes", learning_rate=LR, epochs=1,
                 batch_size=2, shuffle=False, bg_index=5,
                 adapt_orientation_angle=True)
    jt = JTrainer(JTrainingConfig(**train), model, variables)
    state = {k: v.numpy()
             for k, v in weights.from_jax_variables(variables).items()}
    payload = dict(arch=dataclasses.asdict(arch), train=train,
                   samples=W.sample_dicts(samples), batch_size=2,
                   max_nodes=loader.max_nodes, max_edges=loader.max_edges,
                   state=state)
    return jt, payload


def _port_trainer(payload, steps=1):
    arch = tcfg.GNNArchitectureConfig(**payload["arch"])
    model = DetNet(arch, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in payload["state"].items()})
    trainer = Trainer(tcfg.TrainingConfig(**payload["train"]), model)
    loader = GraphDataLoader(
        W.samples_of(payload["samples"]), 2, False, 5, pad_align=16,
        max_nodes=payload["max_nodes"], max_edges=payload["max_edges"],
        device="cpu")
    batches = list(loader)
    for batch in batches[:steps]:
        trainer.train_step(batch)
    return trainer, batches


def test_jax_restores_the_ports_checkpoint(tmp_path, monkeypatch):
    """The port's trainer after a step writes through the orbax backend
    (RADARGNN_CKPT_BACKEND=orbax), its chunks zstd frames with compressed
    blocks; the JAX package's load_train_state, with its trainer's
    optimizer state as the target, restores the weights, statistics and
    optax state bit for bit."""
    _jax_restores_the_ports_checkpoint(tmp_path, monkeypatch, blocked=False)


def test_jax_restores_the_ports_checkpoint_without_tensorstore(
        tmp_path, monkeypatch):
    """As above, the port's trainer and save with tensorstore and
    zstandard blocked."""
    _jax_restores_the_ports_checkpoint(tmp_path, monkeypatch, blocked=True)


def _jax_restores_the_ports_checkpoint(tmp_path, monkeypatch, blocked):
    jt, payload = _tp_case()
    monkeypatch.setenv("RADARGNN_CKPT_BACKEND", "orbax")
    folder = str(tmp_path / "ck")
    with _without_tensorstore(blocked):
        trainer, _ = _port_trainer(payload)
        trainer._checkpoint(folder, 1, 1e-3)
    assert sorted(os.listdir(folder)) == ["meta.json", "orbax"]
    assert {"_METADATA", "_CHECKPOINT_METADATA", "_sharding", "d",
            "manifest.ocdbt", "array_metadatas", "ocdbt.process_0"} <= set(
        os.listdir(os.path.join(folder, "orbax")))
    # the chunks hold compressed blocks, their literals Huffman-coded
    store = ocdbt.Store(os.path.join(folder, "orbax"))
    lanes = zstd._Lanes()
    blocks = [b for k in store.list() if not k.endswith(b".zarray")
              for frame in zstd._parse(store.read(k), lanes)
              for b in frame.blocks]
    assert any(kind == zstd._COMPRESSED for kind, _ in blocks)
    assert lanes.lanes
    model, opt_state, meta = jckpt.load_train_state(folder,
                                                    jt.state.opt_state)
    _assert_trees_equal(jax.device_get(model), trainer._variables())
    _assert_trees_equal(
        jax.device_get(serialization.to_state_dict(opt_state)),
        weights.optimizer_state_to_jax(trainer.optimizer, trainer.model))
    assert meta["epoch"] == 1


def _resume_here(payload, folder):
    trainer, batches = _port_trainer(payload, steps=0)
    meta = trainer.resume(folder)
    losses = [float(v) for v in trainer.train_step(batches[0])]
    return losses, meta["epoch"], {k: v.numpy() for k, v in
                                   trainer.model.state_dict().items()}


def test_two_ranks_write_their_slices(tmp_path):
    """Two gloo ranks of a {"model": 2} mesh with column-parallel weights
    train a step and checkpoint with both backends: under orbax each rank
    writes its own column slices (its store holds them), and the JAX
    package reads full arrays equal to the msgpack checkpoint (gathered to
    full width) of the same run. Resuming from the orbax checkpoint, on the
    two ranks and on one alone, gives the next step a msgpack resume gives,
    bit for bit."""
    _two_ranks_write_their_slices(tmp_path, blocked=False)


def test_two_ranks_write_their_slices_without_tensorstore(tmp_path):
    """As above, with tensorstore and zstandard blocked on both ranks and
    in the single-rank resumes."""
    _two_ranks_write_their_slices(tmp_path, blocked=True)


def _two_ranks_write_their_slices(tmp_path, blocked):
    _, payload = _tp_case()
    payload["train"] = dict(payload["train"], shard_params_over_model=True)
    payload["without_tensorstore"] = blocked
    folders = {b: str(tmp_path / b) for b in ("orbax", "msgpack")}
    mesh = {"model": 2}
    jobs = [("orbax_worker", dict(payload, mesh=mesh, mode="save", steps=1,
                                  folders=folders))]
    jobs += [("orbax_worker", dict(payload, mesh=mesh, mode="resume",
                                   folder=folders[b])) for b in folders]
    res = run_ranks(W.jobs_worker, 2, args=(jobs,), timeout_s=600)
    saved = res[0][0]
    # the JAX package reads the orbax checkpoint as the msgpack one
    model_o, opt_o, meta_o = jckpt.load_train_state(folders["orbax"])
    model_m, opt_m, meta_m = jckpt.load_train_state(folders["msgpack"])
    _assert_trees_equal(jax.device_get(model_o), jax.device_get(model_m))
    _assert_trees_equal(jax.device_get(opt_o), jax.device_get(opt_m))
    assert meta_o == meta_m
    # every rank wrote its own store; rank 1's holds only column slices:
    # half of a leaf along its last (kernel) or only (bias) dimension
    ck = os.path.join(folders["orbax"], "orbax")
    assert {"ocdbt.process_0", "ocdbt.process_1"} <= set(os.listdir(ck))
    with open(os.path.join(ck, "array_metadatas", "process_1")) as f:
        written = json.load(f)["array_metadatas"]
    full = dict(_leaves({"params": jax.device_get(model_m)["params"],
                         "opt_state": jax.device_get(opt_m)}))
    kinds = set()
    for entry in written:
        meta = entry["array_metadata"]
        shape = np.shape(full[tuple(meta["param_name"].split("."))])
        want = list(shape)
        want[-1] //= 2
        assert meta["write_shape"] == want, meta
        kinds.add(meta["param_name"].split(".")[-1])
    assert kinds == {"kernel", "bias"}
    # the moments the ranks held, at full width
    mu = weights.from_jax_variables(
        {"params": jax.device_get(opt_o)["inner_state"]["1"]["mu"]})
    for name, m in saved["moments"].items():
        np.testing.assert_array_equal(mu[name].numpy(), m, err_msg=name)
    # resuming: two ranks, then one alone, orbax against msgpack
    for rank in range(2):
        o, m = res[rank][1], res[rank][2]
        assert o["losses"] == m["losses"] and o["epoch"] == m["epoch"] == 1
        for k in o["state"]:
            np.testing.assert_array_equal(o["state"][k], m["state"][k],
                                          err_msg=k)
    single = dict(payload, train=dict(payload["train"],
                                      shard_params_over_model=False))
    with _without_tensorstore(blocked):
        lo, eo, so = _resume_here(single, folders["orbax"])
        lm, em, sm = _resume_here(single, folders["msgpack"])
    assert lo == lm and eo == em == 1
    for k in so:
        np.testing.assert_array_equal(so[k], sm[k], err_msg=k)


def test_resume_from_a_jax_orbax_checkpoint_is_the_msgpack_resume(
        tmp_path, monkeypatch):
    """The JAX trainer checkpoints its state with both backends (its own
    `_checkpoint` under RADARGNN_CKPT_BACKEND); the port's Trainer.resume
    from the orbax folder, with tensorstore and zstandard blocked, takes
    the next step to the losses and weights of its resume from the
    msgpack folder, bit for bit."""
    jt, payload = _tp_case()
    folders = {b: str(tmp_path / b) for b in ("orbax", "msgpack")}
    for backend, folder in folders.items():
        monkeypatch.setenv("RADARGNN_CKPT_BACKEND", backend)
        jt._checkpoint(folder, 2, LR)
    assert os.path.isdir(os.path.join(folders["orbax"], "orbax"))
    with _without_tensorstore():
        lo, eo, so = _resume_here(payload, folders["orbax"])
        lm, em, sm = _resume_here(payload, folders["msgpack"])
    assert lo == lm and eo == em == 2 and np.isfinite(lo).all()
    for k in so:
        np.testing.assert_array_equal(so[k], sm[k], err_msg=k)


def test_read_time_script_at_a_small_size():
    """tests/orbax_read_time.py (the flagship-size host-CPU read time in
    PERF.md) at the fixture's narrow DetNet: the JAX package's checkpoint
    read back as its state, the port's save and read timed, and the
    port's store beside the JAX package's."""
    from orbax_read_time import measure
    res = measure(sv.orbax_fixture_arch(), repeats=1)
    assert res["leaves"] > 40 and res["array_bytes"] > 30_000
    assert res["read_s"] > 0 and res["port_read_s"] > 0
    assert res["port_save_s"] > 0
    assert res["port_to_jax_bytes"] == (res["port_files_bytes"]
                                        / res["jax_files_bytes"])
