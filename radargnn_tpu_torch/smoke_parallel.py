"""The smoke's tenth phase: training across ranks (`parallel`) on the card.

Two gloo ranks share the one card (NCCL refuses two ranks on a device;
gloo takes the CUDA tensors, `parallel.comm`) and run the flagship
configuration at full width on a {"model": 2} mesh:

  * halo × dense on the kNN batch (5 × 2816-point frames, k 20, seed 0,
    the configuration's halo_overflow_fraction 0.5): B1's projection and
    gather-max and B2 per rank, over each rank's augmented rows;
  * halo × windowed on the radius batch (r = 3.0 m, the smoke's radius
    path's first request): B1's projection, B4's gather-max and backward.

Then, in a spawn of their own, the same two runs with the flagship
configuration's conv_layer_type replaced by "RadarPointGNNConv"
(`smoke.flagship_configs(conv=)`): five residual convs aggregating at
(d_in, d_e, H) = (224, 16, 240), whose hoisted offset is the pre-MLP bias
broadcast over each rank's rows.

For each, every rank first computes a conv-0-shaped aggregate (224 -> 464
over 16 edge features with MPNNConv's per-node offset; 224 -> 240 with
RadarPointGNNConv's broadcast bias) through the halo path without grad;
the ranks' rows, concatenated and put back in node order, are held to the
single-card aggregation (`ops.dense_aggregate` / `ops.windowed_aggregate`)
on the same inputs within AGG_RTOL of its scale, and whether they are
bitwise equal is reported; each rank must have launched the forward's
kernels (B1's projection and its or B4's gather-max) once for it. Then the
sharded Trainer takes `steps` steps and serves one
request (train-mode BatchNorm with frozen running statistics, as
`Predictor`), the kernel counters set to 0 just before and read just after
on each rank: each of the path's kernels must launch once a layer a step
(and a request, for the forward's two). Each step's losses and gradients
(summed over the ranks) are held to the single-card port's step from the
same parameters on the same frames, within the training limits of the
smoke (`smoke.TRAIN_LOSS_RTOL`, `TRAIN_GRAD_COS`, `TRAIN_PARAM_COS`), and
the request's class probabilities to the single card's within
`smoke.MODEL_ATOL_PROB`. Every halo run also holds each conv's pre-MLP
bias gradient (`bias_check`), the bias of the hoisted offset
(RadarPointGNNConv's broadcast bias, MPNNConv's `x @ W_r + bias`): the
step's cosine floor passes over it, since the BatchNorm after each conv
cancels it to rounding (`smoke_pointgnn`). Each rank records, through a
hook on the layers' `halo_hoisted_max_batched`, the sums over its rows of
its offset gradient (its part of the bias gradient) and of their
magnitudes; the
bias gradient Adam took (summed over the ranks by the trainer) must be
within `smoke_pointgnn.BIAS_GRAD_RTOL` of the single card's plain path's
at the same parameters, over the magnitudes summed over the ranks, and
those magnitudes within BIAS_SCALE_RTOL of the single card's own.

Where the machine has two cards the same runs over NCCL, one card a rank;
with four, the halo × dense run on {"data": 2, "model": 2} with 6 frames
and data parallelism ({"data": 4}, 4 frames, the single-card dense path
per rank) against the single card (MPNNConv only). Then, as child
processes: the scaling tool at world 1 (and 2 / 4 where the cards are),
the dry run on two ranks, and `torchrun --nproc-per-node 2 -m
radargnn_tpu_torch.cli.train` under mesh_axes {"model": 2} on processed
splits like the seventh phase's (gloo on one card, NCCL on two). A failed rank, child or check fails the phase.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from radargnn_tpu_torch import smoke
from radargnn_tpu_torch.configs import UserConfigurationReader
from radargnn_tpu_torch.data.synthetic import make_samples
from radargnn_tpu_torch.graph.batch import halo_dataset_budgets, stack_samples
from radargnn_tpu_torch.models.detnet import DetNet
from radargnn_tpu_torch.models.layers import fused_csr_tiling
from radargnn_tpu_torch.models.mlp import batch_stats_over, \
    running_stats_frozen
from radargnn_tpu_torch.ops.dense_aggregate import dense_aggregate
from radargnn_tpu_torch.ops.windowed_aggregate import windowed_aggregate
from radargnn_tpu_torch.parallel.comm import run_ranks
from radargnn_tpu_torch.parallel.halo_windowed import (
    halo_hoisted_max_batched, shard_major_nodes, unshard_major_nodes,
)
from radargnn_tpu_torch.parallel.mesh import make_mesh, shard_batch
from radargnn_tpu_torch.smoke_pointgnn import (
    BIAS_GRAD_RTOL, _offset_grads, bias_names,
)
from radargnn_tpu_torch.train.trainer import Trainer, set_seeds

# the halo aggregate against the single card on the same inputs: the same
# bf16 operands and kernels, the overflow rows' edge products in float32
# GEMMs of other sizes (cuBLAS may sum their 16 terms in another order)
AGG_RTOL = 1e-5
# the conv-0 shape the aggregate is held at, by conv: d_in, d_e, H
AGG_SHAPE = (224, 16, 464)
AGG_SHAPES = {"MPNNConv": AGG_SHAPE, "RadarPointGNNConv": (224, 16, 240)}
CONVS = tuple(AGG_SHAPES)
# a halo run's offset gradient magnitudes, summed over the ranks, against
# the single card's plain path's (each conv's column sums, the norm of
# their difference over the norm of the single card's): the same rows'
# gradients in another summation order (1.3e-3 at most on the CPU at 2 x
# 512 points with RadarPointGNNConv); a rank's rows left out of the sum
# read 0.63 to 0.69 there, and the bias reading over the smaller sum still
# passes
BIAS_SCALE_RTOL = 1e-2
# the path's kernels, by graph, and which run in a request (the forward)
PATH_KERNELS = {"knn": ("dense_proj_v4", "dense_fwd_v4", "dense_bwd_v4"),
                "radius": ("dense_proj_v4", "windowed_fwd_v3",
                           "windowed_bwd_v3")}
FORWARD_KERNELS = ("dense_proj_v4", "dense_fwd_v4", "windowed_fwd_v3")


def _samples(graph: str, points: int, graphs: int, seed: int,
             conv: str = "MPNNConv"):
    """The phase's frames and their bucket: the smoke's first request of
    `graph` (`smoke.flagship_serving`), the flagship configuration with
    `conv` as its conv_layer_type."""
    arch, graph_cfg, bg_index, replaced = smoke.flagship_configs(
        graph, points, conv=conv)
    spec = fused_csr_tiling(arch, k=graph_cfg.k if graph == "knn" else None)
    samples = make_samples(num_frames=graphs, num_points=points, seed=seed,
                           graph_config=graph_cfg, bg_index=bg_index)
    if graph == "knn":
        align = int(np.lcm(spec["node_block"], spec["r_tile"]))
        max_nodes = smoke._round_up(points, align)
        max_edges = max_nodes * graph_cfg.k
    else:
        max_nodes = smoke._round_up(points, spec[0])
        max_edges = smoke._round_up(max(s.num_edges for s in samples), 64)
    return arch, spec, samples, max_nodes, max_edges, bg_index, replaced


def _agg_inputs(g: int, n: int, seed: int,
                conv: str = "MPNNConv") -> Dict[str, np.ndarray]:
    """Conv-0-shaped aggregate inputs of `conv` (AGG_SHAPES): x [G·N,
    224], w_s, w_e, the offset (MPNNConv: `offset`, a row a node;
    RadarPointGNNConv: `bias`, broadcast over the rows), and a projection
    of the raw 2-wide edge features to 16 whose every entry is one feature
    times a power of two (exact in any layout)."""
    d, de, h = AGG_SHAPES[conv]
    rng = np.random.default_rng(seed)
    proj = np.zeros((2, de), np.float32)
    for j in range(de):
        proj[j * 2 // de, j] = 2.0 ** -(j % 4)
    out = dict(x=rng.normal(size=(g * n, d)).astype(np.float32),
               w_s=(rng.normal(size=(d, h)) * d ** -0.5).astype(np.float32),
               w_e=(rng.normal(size=(de, h)) * de ** -0.5
                    ).astype(np.float32), proj=proj)
    if conv == "MPNNConv":
        out["offset"] = rng.normal(size=(g * n, h)).astype(np.float32)
    else:
        out["bias"] = rng.normal(size=(h,)).astype(np.float32)
    return out


def _offset(a: Dict[str, np.ndarray], rows: Callable, count: int,
            device) -> torch.Tensor:
    """The aggregate's offset on `device`: `rows(offset)` of a per-node
    offset, or the bias broadcast over `count` rows (a stride-0 view, as
    RadarPointGNNConv gives it)."""
    if "bias" in a:
        return torch.from_numpy(a["bias"]).to(device).expand(count, -1)
    return rows(a["offset"])


def _rank_parts(g: torch.Tensor) -> tuple:
    """A rank's halo offset gradient reduced over its rows: its part of the
    bias gradient, and the sums of the gradient's magnitudes."""
    g = g.float()
    return g.sum(0).cpu().numpy(), g.abs().sum(0).cpu().numpy()


def _train_config():
    cfg = UserConfigurationReader.read_config_file(smoke.FLAGSHIP_CONFIG)
    return UserConfigurationReader.get_config_object("TRAINING", cfg)


def rank_job(rank: int, world: int, device: torch.device, job: Dict) -> Dict:
    """One rank of a run (`job`: graph, points, graphs, seed, steps, axes,
    halo or not, the aggregate's inputs): the aggregate's rows, the steps'
    losses and seconds, rank 0's parameters before each step and after the
    last and its gradients (summed over the ranks) at each step, the
    request's outputs, and the launches of the training and the request."""
    train_cfg = _train_config()
    set_seeds(train_cfg.seed, train_cfg.deterministic)
    arch, spec, samples, max_nodes, max_edges, bg, _ = _samples(
        job["graph"], job["points"], job["graphs"], job["seed"], job["conv"])
    axes = job["axes"]
    mesh = make_mesh(axes, device=device)
    halo = None
    if job["halo"]:
        halo = {"dp": axes.get("data", 1), "mp": axes["model"],
                "ovf_frac": arch.halo_overflow_fraction}
        halo["budgets"] = halo_dataset_budgets(samples, max_nodes, max_edges,
                                               bg, spec, halo)
    batch = stack_samples(samples, max_nodes, bg, max_edges,
                          csr_tiling=spec, halo_partition=halo, device="cpu")
    local = shard_batch(batch, mesh)
    out: Dict = {"geometry": batch.halo_geometry}
    on_card = device.type == "cuda"

    if job["halo"]:
        a = job["agg"]
        g, n = batch.node_mask.shape
        rows = slice(rank * g * n // world, (rank + 1) * g * n // world)

        def mine(arr):
            return torch.from_numpy(np.ascontiguousarray(shard_major_nodes(
                arr.reshape(g, n, -1), g, n, halo["dp"], halo["mp"])
                [rows])).to(device)

        proj = torch.from_numpy(a["proj"]).to(device)
        bundle = local.flat_halo(mesh)
        bundle = bundle.replace_edge_feat(
            (bundle.e_t @ proj).to(torch.bfloat16 if on_card
                                   else torch.float32),
            (bundle.e_ovf @ proj).to(torch.bfloat16 if on_card
                                     else torch.float32))
        counters = smoke._counters()
        before = [c.launches for c in counters]
        with torch.no_grad():
            agg = halo_hoisted_max_batched(
                mine(a["x"]), torch.from_numpy(a["w_s"]).to(device),
                torch.from_numpy(a["w_e"]).to(device),
                _offset(a, mine, rows.stop - rows.start, device), bundle)
        out["agg"] = agg.cpu().numpy()
        out["agg_launches"] = [c.launches - b
                               for c, b in zip(counters, before)]
    if not job["steps"]:
        return out

    trainer = Trainer(train_cfg, DetNet(arch, device=device,
                                        seed=job["seed"]), mesh=mesh)
    model = trainer.model
    states, grads = [], []

    def snapshot():
        # copies: on the CPU .numpy() would share the parameters' memory
        return {k: v.detach().cpu().numpy().copy()
                for k, v in model.state_dict().items()}

    step = trainer.optimizer.step

    def recording_step(*args, **kwargs):
        if rank == 0:
            grads.append({k: p.grad.detach().cpu().numpy().copy()
                          for k, p in model.named_parameters()})
        return step(*args, **kwargs)

    trainer.optimizer.step = recording_step
    counters = smoke._counters()
    for c in counters:
        c.launches = 0
    losses, seconds, offset_grads = [], [], []
    hooked = job["halo"]
    for _ in range(job["steps"]):
        if rank == 0:
            states.append(snapshot())
        parts: List = []
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _offset_grads(parts, "halo_hoisted_max_batched", _rank_parts) \
                if hooked else contextlib.nullcontext():
            losses.append([float(v) for v in trainer.train_step(local)])
        seconds.append(time.perf_counter() - t0)
        if hooked:
            offset_grads.append({"rank": [p[0] for p in parts[::-1]],
                                 "rows": [p[1] for p in parts[::-1]]})
    train_launches = [c.launches for c in counters]
    with torch.no_grad(), running_stats_frozen(model), \
            batch_stats_over(trainer.rows_group(local)):
        model.train()
        logits, bb = model.forward_batch(local, mesh)
    out.update(
        losses=losses, seconds=seconds, train_launches=train_launches,
        request_launches=[c.launches - t for c, t in zip(counters,
                                                         train_launches)],
        logits=logits.cpu().numpy(), boxes=bb.cpu().numpy(),
        states=states, grads=grads, offset_grads=offset_grads,
        final=snapshot() if rank == 0 else None)
    return out


def _single_card(dev, job: Dict, res: List[Dict]) -> Dict:
    """The run's checks against the single card (module docstring)."""
    arch, spec, samples, max_nodes, max_edges, bg, _ = _samples(
        job["graph"], job["points"], job["graphs"], job["seed"], job["conv"])
    batch = stack_samples(samples, max_nodes, bg, max_edges,
                          csr_tiling=spec, device=dev)
    g, n = batch.node_mask.shape
    axes = job["axes"]
    dp, mp = axes.get("data", 1), axes.get("model", 1)
    report: Dict = {"axes": axes, "backend": job["backend"],
                    "conv": job["conv"], "geometry": res[0]["geometry"]}
    on_card = torch.device(dev).type == "cuda"
    if job["halo"]:
        a = job["agg"]
        tiling = batch.flat_tiling()
        sloc, t_win, _, ovf_s, ovf_r, ovf_e = tiling.win
        proj = torch.from_numpy(a["proj"]).to(dev)
        cd = torch.bfloat16 if on_card else torch.float32
        args = [torch.from_numpy(a[k]).to(dev) for k in ("x", "w_s", "w_e")]
        args.append(_offset(a, lambda arr: torch.from_numpy(arr).to(dev),
                            g * n, dev))
        with torch.no_grad():
            if tiling.dense is not None:
                ref = dense_aggregate(
                    args[0], args[1], (tiling.edge_feat @ proj).to(cd),
                    args[2], args[3], (ovf_e @ proj).to(cd), t_win, sloc,
                    ovf_s, ovf_r, r_tile=tiling.dense[0], k=tiling.dense[1],
                    node_block=tiling.node_block)
            else:
                ref = windowed_aggregate(
                    args[0], args[1], (tiling.edge_feat @ proj).to(cd),
                    args[2], args[3], (ovf_e @ proj).to(cd),
                    tiling.receivers, tiling.blocks, t_win, sloc, ovf_s,
                    ovf_r, node_block=tiling.node_block,
                    edge_tile=tiling.edge_tile)
        got = unshard_major_nodes(np.concatenate([r["agg"] for r in res]),
                                  g, n, dp, mp).reshape(g * n, -1)
        ref = ref.cpu().numpy()
        err = float(np.abs(got - ref).max())
        scale = float(np.abs(ref).max())
        report.update(agg_max_abs_err=err, agg_scale=scale,
                      agg_bitwise=bool(np.array_equal(got, ref)))
        if not err <= AGG_RTOL * scale:
            raise AssertionError(f"halo aggregate {err} from the single card "
                                 f"(limit {AGG_RTOL} of {scale})")

    if not job["steps"]:
        return report
    train_cfg = _train_config()
    agreement = []
    for i, state in enumerate(res[0]["states"]):
        model = DetNet(arch, device=dev, seed=job["seed"])
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in state.items()})
        trainer = Trainer(train_cfg, model)
        total, l_cls, l_bb = trainer.losses(batch)
        total.backward()
        ref_grads = {k: p.grad.detach() for k, p in
                     model.named_parameters()}
        got = {k: torch.from_numpy(v).to(dev)
               for k, v in res[0]["grads"][i].items()}
        agreement.append(smoke._step_agreement(
            res[0]["losses"][i], got,
            [float(v.detach()) for v in (total, l_cls, l_bb)], ref_grads))
    for a in agreement:
        if a["loss_rel"] > smoke.TRAIN_LOSS_RTOL \
                or a["cosine"] < smoke.TRAIN_GRAD_COS \
                or a["min_param_cosine"] < smoke.TRAIN_PARAM_COS:
            raise AssertionError(f"sharded step against the single card: "
                                 f"{agreement}")
    model = DetNet(arch, device=dev, seed=job["seed"])
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in res[0]["final"].items()})
    with torch.no_grad(), running_stats_frozen(model):
        model.train()
        logits, _ = model.forward_batch(batch)
    if dp * mp > 1 and job["halo"]:
        got_logits = unshard_major_nodes(
            np.concatenate([r["logits"] for r in res]), g, n, dp, mp
        ).reshape(g * n, -1)
    else:
        # each data coordinate's graphs, once (the model axis replicates)
        got_logits = np.concatenate([r["logits"] for r in res[::mp]]
                                    ).reshape(g * n, -1)
    prob = torch.softmax(torch.from_numpy(got_logits), -1).numpy()
    want = torch.softmax(logits.float(), -1).cpu().numpy()
    mask = batch.node_mask.reshape(-1).cpu().numpy()
    prob_err = float(np.abs(prob - want)[mask].max())
    if not prob_err <= smoke.MODEL_ATOL_PROB:
        raise AssertionError(f"request probabilities {prob_err} from the "
                             f"single card (limit {smoke.MODEL_ATOL_PROB})")
    report.update(step_agreement=agreement, request_prob_err=prob_err,
                  losses=res[0]["losses"], step_s=res[0]["seconds"])
    if job["halo"]:
        report["bias"] = bias_check(dev, arch, batch, job, res)
    return report


def bias_check(dev, arch, batch, job: Dict, res: List[Dict]) -> List[Dict]:
    """A halo run's pre-MLP biases at each step (module docstring): the
    gradient Adam took, summed over the ranks by the trainer (rank 0's
    record), against the single card's plain path at the step's parameters
    on the same frames, over the offset gradient's magnitudes summed over
    the ranks (BIAS_GRAD_RTOL); those magnitudes against the single card's
    (BIAS_SCALE_RTOL). Also reported: the sum of the ranks' own parts
    against the trainer's sum, over the same magnitudes. Raises when a
    limit is passed; returns a row a conv and step."""
    train_cfg = _train_config()
    rows = []
    for i, state in enumerate(res[0]["states"]):
        model = DetNet(arch, device=dev, seed=job["seed"])
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in state.items()})
        names = bias_names(model)
        trainer = Trainer(train_cfg, model)
        single: List[torch.Tensor] = []
        with _offset_grads(single), smoke._plain_kernels():
            trainer.losses(batch)[0].backward()
        single = [s.double().cpu() for s in single[::-1]]
        if len(single) != len(names) or any(
                len(r["offset_grads"][i]["rows"]) != len(names)
                for r in res):
            raise AssertionError(f"step {i}: {len(single)} of the "
                                 f"{len(names)} convs' offsets reached")
        for k, name in enumerate(names):
            plain = model.get_parameter(name).grad.double().cpu()
            got = torch.from_numpy(res[0]["grads"][i][name]).double()
            scale = torch.from_numpy(sum(
                r["offset_grads"][i]["rows"][k] for r in res)).double()
            parts = torch.from_numpy(sum(
                r["offset_grads"][i]["rank"][k] for r in res)).double()
            norm = float(scale.norm())
            rows.append({
                "step": i, "param": name,
                "rel_diff": float((got - plain).norm()) / norm,
                "cancelled_to": float(plain.norm()) / norm,
                "scale_rel": float((scale - single[k]).norm())
                / float(single[k].norm()),
                "parts_vs_sum": float((parts - got).norm()) / norm})
    bad = [r for r in rows if not (r["rel_diff"] <= BIAS_GRAD_RTOL
                                   and r["scale_rel"] <= BIAS_SCALE_RTOL)]
    if bad:
        raise AssertionError(
            f"{job['conv']} on {job['graph']}: the pre-MLP biases' "
            f"gradients leave the single card's plain path's (limits "
            f"{BIAS_GRAD_RTOL} of the rows' magnitudes, {BIAS_SCALE_RTOL} "
            f"of the single card's magnitudes): {bad}")
    return rows


def _check_launches(res: List[Dict], graph: str, steps: int, layers: int,
                    on_card: bool) -> Dict:
    """Every rank launched each of the path's kernels once in the halo
    aggregate (where the run has one), once a layer a step and once a layer
    in the request, and no other kernel; off the card none. On the card a
    rank whose kernels did not launch fails the check."""
    names = PATH_KERNELS[graph]
    forward = [k for k in names if k in FORWARD_KERNELS]
    want = {"agg": {k: 1 for k in forward},
            "train": {k: layers * steps for k in names},
            "request": {k: layers for k in forward}}
    parts = [part for part in want if f"{part}_launches" in res[0]]
    for r in res:
        for part in parts:
            got = dict(zip(smoke.KERNEL_NAMES, r[f"{part}_launches"]))
            exp = {k: (want[part].get(k, 0) if on_card else 0)
                   for k in smoke.KERNEL_NAMES}
            if got != exp:
                raise AssertionError(f"{part} launches {got}, expected {exp}")
    return {part: {k: v for k, v in zip(smoke.KERNEL_NAMES,
                                        res[0][f"{part}_launches"]) if v}
            for part in parts}


def aggregate_check(dev, graph: str, axes: Dict, backend: str,
                    devices: List[str], points: int, graphs: int,
                    seed: int, conv: str = "MPNNConv") -> Dict:
    """The conv-0-shaped halo aggregate of `conv` (AGG_SHAPES; its offset
    as the conv gives it) alone on the ranks, against the single card (no
    training): the report, with each rank's launches."""
    job = dict(_job(graph, axes, points, graphs, seed, 0, True, conv),
               backend=backend)
    world = int(np.prod(list(axes.values())))
    res = run_ranks(rank_job, world, backend, args=(job,), devices=devices,
                    timeout_s=600)
    report = _single_card(dev, job, res)
    _check_launches(res, graph, 0, 0, torch.device(dev).type == "cuda")
    report["agg_launches"] = [dict(zip(smoke.KERNEL_NAMES,
                                       r["agg_launches"])) for r in res]
    return report


def rank_jobs(rank: int, world: int, device: torch.device,
              jobs: List[Dict]) -> List[Dict]:
    """Several runs' `rank_job` on one set of ranks (one spawn)."""
    return [rank_job(rank, world, device, job) for job in jobs]


def _job(graph: str, axes: Dict, points: int, graphs: int, seed: int,
         steps: int, halo: bool, conv: str = "MPNNConv") -> Dict:
    """One run's description (module docstring); the aggregate's inputs
    for a halo run."""
    _, _, _, max_nodes, _, _, _ = _samples(graph, points, graphs, seed,
                                           conv)
    return dict(graph=graph, points=points, graphs=graphs, seed=seed,
                steps=steps, axes=axes, halo=halo, conv=conv,
                agg=_agg_inputs(graphs, max_nodes, seed, conv) if halo
                else None)


def _runs(dev, backend: str, devices: List[str], jobs: List[Dict],
          out: Callable) -> List[Dict]:
    """The jobs (of one mesh size) on one spawn of ranks, each checked
    against the single card and reported."""
    world = int(np.prod(list(jobs[0]["axes"].values())))
    jobs = [dict(job, backend=backend) for job in jobs]
    t0 = time.perf_counter()
    res = run_ranks(rank_jobs, world, backend, args=(jobs,),
                    devices=devices, timeout_s=600)
    wall = time.perf_counter() - t0
    reports = []
    for i, job in enumerate(jobs):
        ranks = [r[i] for r in res]
        graph, halo, axes = job["graph"], job["halo"], job["axes"]
        layers = len(smoke.flagship_configs(graph, job["points"])[0]
                     .conv_layer_dimensions)
        report = _single_card(dev, job, ranks)
        report.update(launches=_check_launches(
                          ranks, graph, job["steps"], layers,
                          torch.device(dev).type == "cuda"),
                      ranks_s=wall, graph=graph, halo=halo,
                      # the training's and the request's, over the ranks
                      path_launches=np.sum(
                          [np.add(r["train_launches"], r["request_launches"])
                           for r in ranks], axis=0).tolist())
        name = job["conv"] + (" halo x " if halo else " ") \
            + ("dense" if graph == "knn" else "windowed")
        agree = report["step_agreement"]
        out(f"parallel phase: {name} on {axes} ({backend}, {world} ranks on "
            f"{sorted(set(devices))}): "
            + (f"aggregate max abs err {report['agg_max_abs_err']:.3g} of "
               f"{report['agg_scale']:.3g} (bitwise "
               f"{report['agg_bitwise']}); " if halo else "")
            + f"steps {[round(a['loss_rel'], 7) for a in agree]} loss rel, "
            f"cosine {[round(a['cosine'], 5) for a in agree]}, min param "
            f"cosine {[round(a['min_param_cosine'], 4) for a in agree]}; "
            f"request prob err {report['request_prob_err']:.3g}; step s "
            f"{[round(t, 4) for t in report['step_s']]}; launches per rank "
            f"{json.dumps(report['launches'])}; the spawn's wall {wall:.2f} s")
        if "bias" in report:
            out(f"parallel phase: {name} pre-MLP biases (summed over the "
                "ranks) vs the single card's plain path over the rows' "
                "magnitudes (summed over the ranks): " + ", ".join(
                    f"step {r['step']} {r['param']} {r['rel_diff']:.2e} "
                    f"(itself {r['cancelled_to']:.2e}; magnitudes "
                    f"{r['scale_rel']:.2e} from the single card's; ranks' "
                    f"parts {r['parts_vs_sum']:.1e} from the sum)"
                    for r in report["bias"])
                + f" (limits {BIAS_GRAD_RTOL}, {BIAS_SCALE_RTOL})")
        reports.append(report)
    return reports


def _child(cmd: List[str], timeout: float, env=None) -> Dict:
    t0 = time.perf_counter()
    code, stdout, stderr = smoke._finish(subprocess.Popen(
        cmd, cwd=smoke._REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env), timeout)
    seconds = time.perf_counter() - t0
    if code != 0:
        raise AssertionError(f"{' '.join(cmd)} exited {code}:\n"
                             f"{stdout[-3000:]}\n{stderr[-3000:]}")
    return {"seconds": seconds, "stdout": stdout}


def children(dev, cards: int, points: int, out: Callable) -> Dict:
    """The scaling tool, the dry run and the train CLI under torchrun, as
    child processes (module docstring)."""
    on_card = torch.device(dev).type == "cuda"
    res: Dict = {}
    cpu = [] if on_card else ["--device", "cpu"]
    worlds = ",".join(str(w) for w in (1, 2, 4) if w <= max(cards, 1)) \
        if on_card else "1"
    scaling = _child([sys.executable, "-m",
                      "radargnn_tpu_torch.benchmarks.scaling", "--worlds",
                      worlds, "--points", str(points), "--steps", "4"]
                     + cpu, 900)
    res["scaling"] = [json.loads(line) for line in
                      scaling["stdout"].splitlines() if line.startswith("{")]
    res["scaling_s"] = scaling["seconds"]
    dry = _child([sys.executable, "-m", "radargnn_tpu_torch.parallel.dryrun",
                  "--world", "2"] + cpu, 600)
    res["dryrun"] = [line for line in dry["stdout"].splitlines()
                     if line.startswith("dryrun(")]
    res["dryrun_s"] = dry["seconds"]
    if len(res["dryrun"]) != 2 or not all(line.endswith(" ok")
                                          for line in res["dryrun"]):
        raise AssertionError(f"dry run: {dry['stdout'][-2000:]}")
    backend = "nccl" if on_card and cards >= 2 else "gloo"
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "radarscenes")
        results = os.path.join(tmp, "results")
        os.makedirs(results)
        # the seventh phase's processed splits (its frame counts on the
        # card), one epoch under a {"model": 2} mesh
        frames = 10 if on_card else 2
        smoke.write_processed(root, 3 * frames, frames, points)
        replaced = dict(smoke.CLI_REPLACED, epochs=1,
                        mesh_axes={"model": 2})
        config = smoke.cli_config(tmp, replaced=replaced)
        cli = _child([sys.executable, "-m", "torch.distributed.run",
                      "--standalone", "--nproc-per-node", "2", "-m",
                      "radargnn_tpu_torch.cli.train", "--data",
                      os.path.join(root, "processed"), "--results", results,
                      "--config", config, "--backend", backend] + cpu, 900)
        files = sorted(os.listdir(os.path.join(results, "model_01")))
        losses = np.load(os.path.join(results, "model_01",
                                      "loss_train.npy"))
        if "trained_model.msgpack" not in files \
                or not np.isfinite(losses).all():
            raise AssertionError(f"torchrun train CLI wrote {files}, losses "
                                 f"{losses}")
        res.update(cli_s=cli["seconds"], cli_files=files,
                   cli_losses=losses.tolist(), cli_backend=backend,
                   cli_replaced=replaced,
                   cli_epochs=[line for line in cli["stdout"].splitlines()
                               if line.startswith(">>> Epoch")])
    out(f"parallel phase children: scaling {json.dumps(res['scaling'])} "
        f"({res['scaling_s']:.2f} s); dry run {res['dryrun']} "
        f"({res['dryrun_s']:.2f} s); torchrun train CLI ({backend}, 2 "
        f"ranks, {json.dumps(replaced)} replaced) {res['cli_epochs']} "
        f"({res['cli_s']:.2f} s)")
    return res


def parallel_phase(dev, points: int = 2816, graphs: int = 5, seed: int = 0,
                   steps: int = 2, run_children: bool = True,
                   convs: Sequence[str] = CONVS,
                   out: Callable = print) -> Dict:
    """The tenth phase (module docstring) for the convs in `convs`; returns
    its report (`pointgnn_s`: the RadarPointGNNConv runs' wall). Off the
    card it rehearses the same runs with gloo ranks on the CPU."""
    dev = torch.device(dev)
    on_card = dev.type == "cuda"
    cards = torch.cuda.device_count() if on_card else 0
    start = time.perf_counter()
    res: Dict = {"card": smoke.card_description() if on_card else None,
                 "cards": cards, "runs": []}
    shared = ["cuda:0"] if on_card else ["cpu"]
    if "MPNNConv" in convs:
        both = [_job(graph, {"model": 2}, points, graphs, seed, steps, True)
                for graph in ("knn", "radius")]
        res["runs"] = _runs(dev, "gloo", shared, both, out)
        if cards >= 2:
            res["runs"] += _runs(dev, "nccl", ["cuda:0", "cuda:1"], both,
                                 out)
        if cards >= 4:
            res["runs"] += _runs(
                dev, "nccl", [f"cuda:{i}" for i in range(4)], [
                    _job("knn", {"data": 2, "model": 2}, points, 6, seed,
                         steps, True),
                    _job("knn", {"data": 4}, points, 4, seed, steps,
                         False)], out)
    if "RadarPointGNNConv" in convs:
        t0 = time.perf_counter()
        res["runs"] += _runs(dev, "gloo", shared, [
            _job(graph, {"model": 2}, points, graphs, seed, steps, True,
                 "RadarPointGNNConv") for graph in ("knn", "radius")], out)
        res["pointgnn_s"] = time.perf_counter() - t0
        out(f"parallel phase: the RadarPointGNNConv halo runs (two gloo "
            f"ranks on {shared[0]}, with their single-card checks) "
            f"{res['pointgnn_s']:.2f} s wall; card {res['card']}")
    if run_children:
        res["children"] = children(dev, cards, points, out)
    res["phase_s"] = time.perf_counter() - start
    out(f"parallel phase on {dev}: {len(res['runs'])} runs, the phase "
        f"{res['phase_s']:.2f} s; card {res['card']}")
    return res
