"""Rank workers for the port's multi-rank tests (`test_torch_parallel.py`,
`test_torch_halo.py`). Each runs in a process that
`radargnn_tpu_torch.parallel.comm.run_ranks` spawns, so this module imports
torch, numpy and the port only: never JAX nor a test module. Inputs and
results are numpy arrays and plain Python values."""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from radargnn_tpu_torch import configs as tcfg
from radargnn_tpu_torch.data.loader import GraphDataLoader
from radargnn_tpu_torch.graph.batch import GraphSample, stack_samples
from radargnn_tpu_torch.models.detnet import DetNet
from radargnn_tpu_torch.parallel import comm
from radargnn_tpu_torch.parallel.mesh import make_mesh, shard_batch
from radargnn_tpu_torch.train import trainer as trainer_mod


def samples_of(dicts: List[Dict[str, np.ndarray]]) -> List[GraphSample]:
    return [GraphSample(**d) for d in dicts]


def sample_dicts(samples) -> List[Dict[str, np.ndarray]]:
    """Picklable copies of GraphSamples (either package's)."""
    return [{f.name: np.asarray(getattr(s, f.name))
             for f in dataclasses.fields(GraphSample)} for s in samples]


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------

def reductions_worker(rank, world, device, cases):
    """`partitioned_segment_reduce`, `edge_partitioned_aggregate` and
    `halo_segment_reduce` over a {"model": world} mesh; each case's edge
    arrays are split into `world` contiguous shards as P("model") does."""
    from radargnn_tpu_torch.parallel.edge_partition import (
        edge_partitioned_aggregate, partitioned_segment_reduce,
    )
    from radargnn_tpu_torch.parallel.halo import (
        build_halo_plan, halo_segment_reduce,
    )
    mesh = make_mesh({"model": world}, device=device)
    out = {}
    for name, case in cases.items():
        kind = case["kind"]
        if kind == "reduce":
            e = len(case["ids"])
            part = slice(rank * e // world, (rank + 1) * e // world)
            out[name] = partitioned_segment_reduce(
                case["reducer"], torch.from_numpy(case["data"][part]),
                torch.from_numpy(case["ids"][part]), case["num_segments"],
                torch.from_numpy(case["mask"][part]), mesh).numpy()
        elif kind == "aggregate":
            e = len(case["s"])
            part = slice(rank * e // world, (rank + 1) * e // world)
            w = torch.from_numpy(case["w"])

            def message_fn(x_r, x_s, e_):
                return torch.cat([x_r, x_s, e_], dim=-1) @ w

            out[name] = edge_partitioned_aggregate(
                message_fn, "max", torch.from_numpy(case["x"]),
                torch.from_numpy(case["s"][part]),
                torch.from_numpy(case["r"][part]),
                torch.from_numpy(case["e"][part]),
                torch.from_numpy(case["mask"][part]), mesh).numpy()
        elif kind == "halo":
            n = case["x"].shape[0]
            plan = build_halo_plan(case["s"], case["r"], n, world,
                                   edge_mask=case.get("mask"))
            ns = plan.nodes_per_shard
            x_own = torch.from_numpy(case["x"][rank * ns:(rank + 1) * ns])
            w_s = None if case.get("w_s") is None \
                else torch.from_numpy(case["w_s"])
            w_e = None if case.get("w_e") is None \
                else torch.from_numpy(case["w_e"])

            def message(xs, ee):
                if w_s is None:
                    return xs * 1.5 + ee.sum(dim=-1, keepdim=True)
                return xs @ w_s + ee @ w_e

            out[name] = halo_segment_reduce(
                case["reducer"], x_own, message, torch.from_numpy(case["e"]),
                plan, mesh).numpy()
        else:
            raise ValueError(kind)
    return out


# ---------------------------------------------------------------------------
# the halo aggregates, forward and gradients
# ---------------------------------------------------------------------------

def halo_aggregate_worker(rank, world, device, payload):
    """The rank's part of `halo_hoisted_max_batched` on the halo batch of
    `payload["samples"]` (tiling, halo partition and shared budgets as the
    payload gives them) over a {"data": dp, "model": mp} mesh: its output
    rows, the gradients of sum(out²) (summed over the ranks) with respect
    to its rows of x and offset, and the weights' gradients summed over
    every rank. Also the launches of the path's kernels (0 on the CPU).

    Optional: `x` [G, N, D] replaces the batch's node features, `proj`
    [De, De'] projects the bundle's edge features, and `bias` [H] makes
    the offset RadarPointGNNConv's, the bias broadcast over the rank's
    rows (a stride-0 view): then `d_bias` is the bias's gradient, every
    rank's row sum of the offset's gradient summed over the ranks, and
    `d_bias_rank` this rank's own part."""
    from radargnn_tpu_torch.ops import dense_aggregate as da
    from radargnn_tpu_torch.ops import windowed_aggregate as wa
    from radargnn_tpu_torch.parallel.halo_windowed import (
        halo_hoisted_max_batched, shard_major_nodes,
    )
    halo = payload["halo"]
    mesh = make_mesh({"data": halo["dp"], "model": halo["mp"]},
                     device=device)
    batch = stack_samples(samples_of(payload["samples"]),
                          payload["max_nodes"], 5, payload["max_edges"],
                          csr_tiling=payload["tiling"], halo_partition=halo,
                          device="cpu")
    g, n = batch.node_mask.shape
    dp, mp = halo["dp"], halo["mp"]
    rows = slice(rank * (g * n) // world, (rank + 1) * (g * n) // world)

    def mine(a):
        return torch.from_numpy(np.ascontiguousarray(shard_major_nodes(
            a, g, n, dp, mp)[rows])).to(device).requires_grad_(True)

    x = mine(payload["x"] if "x" in payload else batch.node_feat.numpy())
    bias = None
    if "bias" in payload:
        bias = torch.from_numpy(payload["bias"]).to(device) \
            .requires_grad_(True)
        off = bias.expand(x.shape[0], -1)
    else:
        off = mine(payload["offset"])
    w_s = torch.from_numpy(payload["w_s"]).to(device).requires_grad_(True)
    w_e = torch.from_numpy(payload["w_e"]).to(device).requires_grad_(True)
    local = shard_batch(batch, mesh)
    bundle = local.flat_halo(mesh)
    if "proj" in payload:
        proj = torch.from_numpy(payload["proj"]).to(device)
        bundle = bundle.replace_edge_feat(bundle.e_t @ proj,
                                          bundle.e_ovf @ proj)
    kernels = (da.dense_proj_cuda, da.dense_fwd_cuda, da.dense_bwd_cuda,
               wa.windowed_fwd_cuda, wa.windowed_bwd_cuda)
    before = [k.launches for k in kernels]
    out = halo_hoisted_max_batched(x, w_s, w_e, off, bundle)
    (out.double() ** 2).sum().float().backward()
    comm.all_reduce_(w_s.grad, mesh.world_group)
    comm.all_reduce_(w_e.grad, mesh.world_group)
    res = dict(out=out.detach().cpu().numpy(), d_x=x.grad.cpu().numpy(),
               d_ws=w_s.grad.cpu().numpy(), d_we=w_e.grad.cpu().numpy(),
               launches=[k.launches - b for k, b in zip(kernels, before)])
    if bias is None:
        res["d_off"] = off.grad.cpu().numpy()
    else:
        res["d_bias_rank"] = bias.grad.cpu().numpy().copy()
        comm.all_reduce_(bias.grad, mesh.world_group)
        res["d_bias"] = bias.grad.cpu().numpy()
    return res


# ---------------------------------------------------------------------------
# trainers
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _fault(name: Optional[str], world: int):
    """A deliberately wrong variant of the sharded step, for the tests that
    show the parity checks catch it: BatchNorm statistics of this rank's
    rows alone, or each rank's loss normalised by its own rows (the mean
    of the per-rank losses)."""
    saved = trainer_mod.batch_stats_over, trainer_mod.detection_loss
    if name == "per_rank_batch_norm":
        trainer_mod.batch_stats_over = lambda group: contextlib.nullcontext()
    elif name == "per_rank_loss":
        def per_rank(*args, group=None):
            return tuple(v / comm.group_size(group) for v in saved[1](*args))
        trainer_mod.detection_loss = per_rank
    elif name is not None:
        raise ValueError(name)
    try:
        yield
    finally:
        trainer_mod.batch_stats_over, trainer_mod.detection_loss = saved


def trainer_worker(rank, world, device, payload):
    """Train steps of the port's Trainer over `payload["mesh"]` (None: one
    rank alone) from the payload's weights, on its loader's batches
    (`epochs` passes); returns every step's (total, cls, bb), the weights
    after the steps (a state_dict of numpy arrays) and the kernels'
    launches. With `payload["record_grads"]` also `grads`: the first
    step's gradients as Adam takes them (summed over the ranks), by
    parameter name."""
    from radargnn_tpu_torch.ops import dense_aggregate as da
    from radargnn_tpu_torch.ops import windowed_aggregate as wa

    mesh = make_mesh(payload["mesh"], device=device) \
        if payload.get("mesh") else None
    arch = tcfg.GNNArchitectureConfig(**payload["arch"])
    train_cfg = tcfg.TrainingConfig(**payload["train"])
    loader = GraphDataLoader(
        samples_of(payload["samples"]), payload["batch_size"], False, 5,
        csr_tiling=payload.get("tiling"),
        halo_partition=payload.get("halo"), pad_align=16,
        max_nodes=payload.get("max_nodes"),
        max_edges=payload.get("max_edges"), device="cpu")
    model = DetNet(arch, device=device)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in payload["state"].items()})
    trainer = trainer_mod.Trainer(train_cfg, model, mesh=mesh)
    kernels = (da.dense_proj_cuda, da.dense_fwd_cuda, da.dense_bwd_cuda,
               wa.windowed_fwd_cuda, wa.windowed_bwd_cuda)
    before = [k.launches for k in kernels]
    grads: Dict[str, np.ndarray] = {}
    if payload.get("record_grads"):
        step = trainer.optimizer.step

        def recording_step(*args, **kwargs):
            if not grads:
                grads.update({n: p.grad.detach().cpu().numpy().copy()
                              for n, p in model.named_parameters()})
            return step(*args, **kwargs)

        trainer.optimizer.step = recording_step
    losses = []
    with _fault(payload.get("fault"), world):
        for _ in range(payload.get("epochs", 1)):
            for batch in loader:
                if mesh is None:
                    batch = batch.to(device)
                losses.append([float(v) for v in trainer.train_step(batch)])
    # Adam's first moments at full width (all-gathered under column
    # parallelism), as the checkpoint writes them
    full = trainer._full_optimizer()
    moments = {name: full.state[p]["exp_avg"].detach().cpu().numpy()
               for name, p in model.named_parameters() if p in full.state}
    return dict(losses=losses,
                state={k: v.detach().cpu().numpy()
                       for k, v in model.state_dict().items()},
                moments=moments, grads=grads,
                launches=[k.launches - b for k, b in zip(kernels, before)])


def cli_train_worker(rank, world, device, data, results, config):
    """The train CLI's main on this rank (the process group is the
    launcher's); returns the files rank 0 wrote."""
    import os

    from radargnn_tpu_torch.cli import train as ctrain
    ctrain.main(data, results, config, device="cpu")
    return sorted(os.listdir(os.path.join(results, "model_01")))


def jobs_worker(rank, world, device, jobs):
    """Several of the workers above in one set of ranks (one spawn):
    [(worker name, payload), ...] -> their results in order."""
    return [globals()[name](rank, world, device, payload)
            for name, payload in jobs]


def raises_on_rank_one(rank, world, device):
    """A worker whose rank 1 fails (the launcher must report it)."""
    if rank == 1:
        raise RuntimeError("rank one gives up")
    torch.distributed.barrier()
    return rank


def orbax_worker(rank, world, device, payload):
    """The orbax backend over `payload["mesh"]` (None: one rank alone).
    "save": train steps from the payload's weights, then write the
    checkpoint with both backends (`folders`: {"orbax": ..., "msgpack":
    ...}); returns the weights and the full-width Adam moments. "resume":
    resume from `folder` and take one more step; returns its losses and
    the weights after it. `payload["without_tensorstore"]`: tensorstore and
    zstandard cannot be imported on the rank (as on the card's
    machine)."""
    import os
    import sys
    from unittest import mock

    if payload.get("without_tensorstore"):
        sys.modules.update(tensorstore=None, zstandard=None)

    mesh = make_mesh(payload["mesh"], device=device) \
        if payload.get("mesh") else None
    arch = tcfg.GNNArchitectureConfig(**payload["arch"])
    train_cfg = tcfg.TrainingConfig(**payload["train"])
    loader = GraphDataLoader(
        samples_of(payload["samples"]), payload["batch_size"], False, 5,
        pad_align=16, max_nodes=payload.get("max_nodes"),
        max_edges=payload.get("max_edges"), device="cpu")
    model = DetNet(arch, device=device)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in payload["state"].items()})
    trainer = trainer_mod.Trainer(train_cfg, model, mesh=mesh)
    batches = list(loader)
    if payload["mode"] == "save":
        for batch in batches[:payload["steps"]]:
            trainer.train_step(batch)
        trainer.train_loss = [1.5]
        for backend, folder in payload["folders"].items():
            with mock.patch.dict(os.environ,
                                 RADARGNN_CKPT_BACKEND=backend):
                trainer._checkpoint(folder, 1, 1e-3)
        full = trainer._full_optimizer()
        return dict(
            state={k: v.detach().cpu().numpy()
                   for k, v in model.state_dict().items()},
            moments={name: full.state[p]["exp_avg"].detach().cpu().numpy()
                     for name, p in model.named_parameters()
                     if p in full.state})
    meta = trainer.resume(payload["folder"])
    losses = [float(v) for v in trainer.train_step(batches[0])]
    return dict(losses=losses, epoch=meta["epoch"],
                state={k: v.detach().cpu().numpy()
                       for k, v in model.state_dict().items()})
