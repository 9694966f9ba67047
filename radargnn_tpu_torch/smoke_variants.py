"""The smoke's ninth phase: the settings that reach kernel variants or no
kernel at all (`smoke.run` calls `variants_phase` on the card, after the
eighth).

  (a) B1's and B4's gather-max (`dense_fwd_v4`, `windowed_fwd_v3`) with
      their bits set by the bf16 test (`fused_bf16_max`), against their
      plain versions at the model's layer shapes, on the kNN batch (dense)
      and on the radius batch (windowed): on real-valued inputs (the
      outputs within KERNEL_RTOL, the bits within BF16_BITS_FLIP_FRAC) and
      on inputs whose operands are exact in float32 in any order and tie in
      bf16 without tying in float32 (the bits equal exactly); timed in VJP
      mode beside the strict test;
  (b) B3 (`segment_sum_csr`) over the dense overflow rows as `ovf_ssum`
      lands them, against its plain version on dyadic rows (exact);
  (c) the flagship DetNet's training under `fused_bf16_max` on the dense
      and the windowed path, each against the plain path at every step and
      again bitwise (`smoke._train_phase`); on the CSR path, whose kernels
      route strictly, bitwise the strict run; and a dense run under
      `ovf_ssum`, whose backward lands the overflow d_x through B3;
  (d) the flagship widths with a pre-MLP of two layers, MPNNConv with mean
      and RadarPointGNNConv with add aggregation (the unfused path, no
      kernel): train steps on the device against the same steps' losses
      and gradients on the CPU, and a second run bitwise equal;
  (e) `benchmarks.convergence` and `benchmarks.preprocessing_bench` as
      child processes, each checked for the lines the JAX tools print;
  (f) B4's gather-max with its maxima landed in bf16
      (RADARGNN_FUSED_BF16_LANDING) against its plain version with the
      landing at the model's layer shapes on the radius batch, in serving
      and in VJP mode: bitwise on dyadic inputs; on real-valued ones a
      landed max may round the other way where the two sums straddle a
      bf16 rounding boundary, so the landing may add one bf16 ulp of the
      max to the two sums' own difference (which float32 cancellation
      makes larger than that ulp for maxima near zero), on at most
      BF16_BITS_FLIP_FRAC of the entries; then the
      radius configuration under fused_bf16_max with the three variant
      knobs set (2 steps, 1 request) against the plain path with the
      landing;
  (g) B1 and B2 (`dense_fwd_v4`, `dense_bwd_v4`) at dense receiver tiles
      of 8 and 24 (`r_tile` a multiple of 8) on the kNN batch at the
      model's layer shapes, under the limits of their main-path checks
      (`smoke.check_routed_kernels`), and 2 train steps at 8;
  (h) the orbax checkpoint backend on the port's own OCDBT, zarr and zstd
      code: the kNN trainer's state saved and restored bit for bit, its
      store at most ORBAX_TRAINED_RATIO of its arrays' bytes, a fresh
      trainer resumed from it stepping to the uninterrupted trainer's
      losses bit for bit; the flagship state of `orbax_fixture_state`
      saved and restored bit for bit, its store at most ORBAX_STATE_RATIO
      of its arrays' bytes; and the JAX package's committed orbax
      checkpoint read bit for bit against its seed's state.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from typing import Callable, Dict, List, Tuple
from unittest import mock

import numpy as np
import torch

from radargnn_tpu_torch import smoke as sm
from radargnn_tpu_torch.benchmarks.kernel_bench import time_ms as _time_ms
from radargnn_tpu_torch import weights
from radargnn_tpu_torch.configs import UserConfigurationReader
from radargnn_tpu_torch.data.synthetic import make_samples
from radargnn_tpu_torch.graph.batch import stack_samples
from radargnn_tpu_torch.models import layers
from radargnn_tpu_torch.models.detnet import DetNet
from radargnn_tpu_torch.ops import dense_aggregate as da
from radargnn_tpu_torch.train import checkpoint as ckpt
from radargnn_tpu_torch.train.trainer import Trainer, make_optimizer, \
    set_seeds

# the bf16 routing bits on real-valued inputs, kernel against plain
# version: their operands differ by float32 summation order (about 1e-7
# relative), so an operand, or a receiver's max, that lies within that of a
# bf16 rounding boundary (2^-9 relative apart) may round the other way:
# about 1e-5 of the values, and a flip changes a bit only where the slot's
# bf16 value neighbours its max's; the limit keeps a factor of ten over
# that estimate (on the tie inputs the bits must agree exactly)
BF16_BITS_FLIP_FRAC = 1e-4
# (d): the unfused configurations, (conv type, pre-MLP layers, aggregation)
UNFUSED_CASES = (("MPNNConv", 2, "mean"), ("RadarPointGNNConv", 2, "add"))
# (e): the convergence child's size on the card (the JAX tool's defaults
# are 60 frames of 800 points over 15 epochs; PERF.md has that run)
CONVERGENCE_ARGS = ("--frames", "20", "--points", "800", "--epochs", "2",
                    "--batch-size", "8", "--fused", "--dense")
PREPROCESSING_ARGS = ("--frames", "4")


def _fine_dyadic(gen: torch.Generator, dev, cd):
    """Seeded multiples of 1/64 in [-lim, lim], exact in bf16 (at most 8
    significant bits): products are multiples of 2^-12 and their sums over
    the layer widths stay below 2^20 of them, so every operand is exact in
    float32 in any order, and its bf16 rounding (8 bits) ties many that
    differ."""
    def dyadic(*shape, lim=2.0):
        k = int(lim * 64)
        return (torch.randint(-k, k + 1, shape, generator=gen)
                / 64.0).to(dev).to(cd)
    return dyadic


def check_bf16_bits(tiling, layer_shapes: List[tuple], seed: int, reps: int,
                    label: str, out: Callable = print) -> List[Dict]:
    """(a) on one layout (module docstring). Returns a row per shape: the
    errors, flips and routed bits (bf16 and strict) of both input kinds,
    the VJP-mode bound and, on the card, the VJP-mode times of the kernel
    with the bf16 test (`ms`), with the strict one (`strict_ms`) and of the
    plain version with the bf16 test (`plain_ms`)."""
    kern = sm._routed_of(tiling)
    sloc = tiling.win[0]
    ovf_s, ovf_r = tiling.win[3:5]
    dev = sloc.device
    cd = da.gather_dtype(dev)
    e_pad, t = sloc.shape[0], tiling.win[1].shape[0]
    n = tiling.landing.row_ptr.shape[0] - 1
    n_ovf = ovf_s.shape[0]
    on_card = dev.type == "cuda"
    gen = torch.Generator().manual_seed(seed)
    fine = _fine_dyadic(gen, dev, cd)

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    def operands(x, w_s, e_ovf, w_e):
        y_s = da.dense_proj(x, w_s)
        inner_o = da.overflow_maxima(
            da.dense_overflow_operand(y_s, e_ovf, w_e, ovf_s), ovf_r, n)
        return y_s, inner_o

    rows = []
    for d, de, h in layer_shapes:
        # -- real-valued inputs ---------------------------------------------
        x, w_s = rand(n, d).to(cd), rand(d, h, scale=d ** -0.5).to(cd)
        e_t, w_e = rand(e_pad, de).to(cd), rand(de, h, scale=de ** -0.5).to(cd)
        e_ovf, offset = rand(n_ovf, de).to(cd), rand(n, h)
        y_s, inner_o = operands(x, w_s, e_ovf, w_e)
        args = (y_s, e_t, w_e, inner_o, offset)
        got, inner, bits = kern.fwd(*args, emit_inner=True, bf16_max=True)
        ref, ref_inner, ref_bits = kern.fwd_plain(*args, emit_inner=True,
                                                  bf16_max=True)
        _, _, strict = kern.fwd(*args, emit_inner=True)
        has = ref_inner > da._NEG / 2
        err = max(float((got - ref).abs().max()),
                  float((inner[has] - ref_inner[has]).abs().max()))
        flips = sm._popcount(bits ^ ref_bits)
        row = {"layout": label, "d_in": d, "d_e": de, "h": h,
               "max_abs_err": err,
               "max_rel_err": err / max(float(ref.abs().max()), 1.0),
               "bits_flipped": flips, "bits": e_pad * h,
               "routed": sm._popcount(bits),
               "routed_strict": sm._popcount(strict),
               **sm._gather_bound(de, h, n, e_pad, t, sm._valid_slots(tiling),
                                  vjp=True, index_arrays=kern.index_arrays)}
        if on_card:
            row["ms"] = _time_ms(lambda: kern.fwd(*args, emit_inner=True,
                                                  bf16_max=True), reps)
            row["strict_ms"] = _time_ms(
                lambda: kern.fwd(*args, emit_inner=True), reps)
            row["plain_ms"] = _time_ms(lambda: kern.fwd_plain(
                *args, emit_inner=True, bf16_max=True), reps)
        else:
            row["ms"] = row["strict_ms"] = row["plain_ms"] = None
        row["library_ms"] = None

        # -- bf16 ties that are not float32 ties ----------------------------
        x, w_s = fine(n, d), fine(d, h, lim=0.5)
        e_t, w_e = fine(e_pad, de), fine(de, h, lim=0.5)
        e_ovf = fine(n_ovf, de)
        y_s, inner_o = operands(x, w_s, e_ovf, w_e)
        args = (y_s, e_t, w_e, inner_o, torch.zeros((n, h), device=dev))
        _, inner, bits = kern.fwd(*args, emit_inner=True, bf16_max=True)
        _, ref_inner, ref_bits = kern.fwd_plain(*args, emit_inner=True,
                                                bf16_max=True)
        _, _, strict = kern.fwd(*args, emit_inner=True)
        if on_card:
            torch.cuda.synchronize()
        row["ties_bits_equal"] = bool(torch.equal(bits, ref_bits)
                                      and torch.equal(inner, ref_inner))
        row["ties_routed"] = sm._popcount(bits)
        row["ties_routed_strict"] = sm._popcount(strict)
        out(f"kernel {kern.fwd_name} bf16_max ({label}) d_in={d} H={h}: "
            f"real inputs max_abs_err={err:.3e}, bits flipped {flips} of "
            f"{row['bits']} (limit {BF16_BITS_FLIP_FRAC}), routed "
            f"{row['routed']} (strict {row['routed_strict']}); bf16 ties: "
            f"bits equal {row['ties_bits_equal']}, routed "
            f"{row['ties_routed']} (strict {row['ties_routed_strict']}); VJP "
            f"mode ms={row['ms']} (strict {row['strict_ms']}) plain_ms="
            f"{row['plain_ms']} bound_ms={row['bound_ms']:.4f} "
            f"({row['bound_by']})")
        if row["max_rel_err"] > sm.KERNEL_RTOL \
                or flips > BF16_BITS_FLIP_FRAC * row["bits"] \
                or not row["ties_bits_equal"] \
                or row["ties_routed"] <= row["ties_routed_strict"]:
            raise AssertionError(f"{kern.fwd_name} with the bf16 test "
                                 f"disagrees with its plain version: {row}")
        rows.append(row)
    return rows


def _bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """One bf16 unit in the last place at each value's magnitude."""
    _, exp = torch.frexp(v.abs())
    return torch.ldexp(torch.ones_like(v), exp - 8)


def check_landing(tiling, layer_shapes: List[tuple], seed: int, reps: int,
                  out: Callable = print) -> List[Dict]:
    """(f), the kernel check, on a windowed layout: B4's gather-max with
    bf16_max and the landing against its plain version with both. Returns
    a row per shape: the ulps and entries that differ on real-valued
    inputs, the flipped bits, and on the card the VJP-mode times of the
    kernel with the landing (`ms`), with the bf16 test alone (`bf16_ms`)
    and strict (`strict_ms`), and of the plain version (`plain_ms`), the
    serving time with the landing (`serving_ms`)."""
    kern = sm._routed_of(tiling)
    sloc = tiling.win[0]
    ovf_s, ovf_r = tiling.win[3:5]
    dev = sloc.device
    cd = da.gather_dtype(dev)
    e_pad, t = sloc.shape[0], tiling.win[1].shape[0]
    n = tiling.landing.row_ptr.shape[0] - 1
    n_ovf = ovf_s.shape[0]
    on_card = dev.type == "cuda"
    gen = torch.Generator().manual_seed(seed)
    fine = _fine_dyadic(gen, dev, cd)
    land = dict(bf16_max=True, bf16_landing=True)

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    def operands(x, w_s, e_ovf, w_e):
        y_s = da.dense_proj(x, w_s)
        return y_s, da.overflow_maxima(
            da.dense_overflow_operand(y_s, e_ovf, w_e, ovf_s), ovf_r, n)

    rows = []
    for d, de, h in layer_shapes:
        # -- real-valued inputs ---------------------------------------------
        x, w_s = rand(n, d).to(cd), rand(d, h, scale=d ** -0.5).to(cd)
        e_t, w_e = rand(e_pad, de).to(cd), rand(de, h, scale=de ** -0.5).to(cd)
        e_ovf, offset = rand(n_ovf, de).to(cd), rand(n, h)
        y_s, inner_o = operands(x, w_s, e_ovf, w_e)
        args = (y_s, e_t, w_e, inner_o, offset)
        got = kern.fwd(*args, **land)
        got_vjp, inner, bits = kern.fwd(*args, emit_inner=True, **land)
        ref = kern.fwd_plain(*args, **land)
        ref_vjp, ref_inner, ref_bits = kern.fwd_plain(*args, emit_inner=True,
                                                      **land)
        # the maxima before the landing: their own difference is the sums'
        _, unlanded, _ = kern.fwd(*args, emit_inner=True, bf16_max=True)
        _, ref_unlanded, _ = kern.fwd_plain(*args, emit_inner=True,
                                            bf16_max=True)
        if on_card:
            torch.cuda.synchronize()
        has = ref_inner > da._NEG / 2
        ulp = _bf16_ulp(torch.where(has, ref_inner, 1.0))
        d_inner = torch.where(has, (inner - ref_inner).abs(), 0.0)
        d_sums = torch.where(has, (unlanded - ref_unlanded).abs(), 0.0)
        # out = offset + inner, rounded once more in float32
        d_out = (got - ref).abs() - d_sums - 2.0 ** -23 * 2 * ref.abs()
        differ = int((d_inner > 0).sum())
        row = {"layout": "radius, windowed", "d_in": d, "d_e": de, "h": h,
               "max_abs_err": float((got - ref).abs().max()),
               # the landing's share of a difference, in bf16 ulps
               "max_ulps": float(((d_inner - d_sums) / ulp).max()),
               "max_sum_ulps": float((d_sums / ulp).max()),
               "entries_differ": differ, "entries": n * h,
               "serving_equals_vjp": bool(torch.equal(got, got_vjp)),
               "out_within_ulp": bool((d_out <= ulp).all()),
               "bits_flipped": sm._popcount(bits ^ ref_bits),
               "bits": e_pad * h,
               **sm._gather_bound(de, h, n, e_pad, t, sm._valid_slots(tiling),
                                  vjp=True, index_arrays=kern.index_arrays)}
        if on_card:
            row["ms"] = _time_ms(
                lambda: kern.fwd(*args, emit_inner=True, **land), reps)
            row["bf16_ms"] = _time_ms(
                lambda: kern.fwd(*args, emit_inner=True, bf16_max=True), reps)
            row["strict_ms"] = _time_ms(
                lambda: kern.fwd(*args, emit_inner=True), reps)
            row["plain_ms"] = _time_ms(lambda: kern.fwd_plain(
                *args, emit_inner=True, **land), reps)
            row["serving_ms"] = _time_ms(lambda: kern.fwd(*args, **land),
                                         reps)
        else:
            row["ms"] = row["bf16_ms"] = row["strict_ms"] = None
            row["plain_ms"] = row["serving_ms"] = None
        row["library_ms"] = None

        # -- dyadic inputs: the same operands, so the same landing ----------
        x, w_s = fine(n, d), fine(d, h, lim=0.5)
        e_t, w_e = fine(e_pad, de), fine(de, h, lim=0.5)
        y_s, inner_o = operands(x, w_s, fine(n_ovf, de), w_e)
        args = (y_s, e_t, w_e, inner_o, torch.zeros((n, h), device=dev))
        got = kern.fwd(*args, **land)
        got_vjp, inner, bits = kern.fwd(*args, emit_inner=True, **land)
        ref_vjp, ref_inner, ref_bits = kern.fwd_plain(*args, emit_inner=True,
                                                      **land)
        _, unlanded, _ = kern.fwd_plain(*args, emit_inner=True,
                                        bf16_max=True)
        if on_card:
            torch.cuda.synchronize()
        row["dyadic_equal"] = bool(
            torch.equal(got, ref_vjp) and torch.equal(got_vjp, ref_vjp)
            and torch.equal(inner, ref_inner) and torch.equal(bits, ref_bits))
        row["dyadic_landed"] = int((unlanded != ref_inner).sum())
        out(f"kernel {kern.fwd_name} bf16_landing d_in={d} H={h}: real "
            f"inputs {differ} of {row['entries']} maxima differ, the landing "
            f"adding at most {row['max_ulps']:.3g} bf16 ulp to the sums' own "
            f"{row['max_sum_ulps']:.3g} (outputs within one: "
            f"{row['out_within_ulp']}), bits flipped {row['bits_flipped']} "
            f"of {row['bits']}; dyadic inputs bitwise {row['dyadic_equal']} "
            f"({row['dyadic_landed']} maxima moved by the landing); VJP mode "
            f"ms={row['ms']} (bf16 test alone {row['bf16_ms']}, strict "
            f"{row['strict_ms']}) plain_ms={row['plain_ms']} serving ms="
            f"{row['serving_ms']} bound_ms={row['bound_ms']:.4f} "
            f"({row['bound_by']})")
        if row["max_ulps"] > 1.0 or not row["out_within_ulp"] \
                or differ > BF16_BITS_FLIP_FRAC * row["entries"] \
                or row["bits_flipped"] > BF16_BITS_FLIP_FRAC * row["bits"] \
                or not row["serving_equals_vjp"] or not row["dyadic_equal"] \
                or row["dyadic_landed"] == 0:
            raise AssertionError(f"{kern.fwd_name} with the bf16 landing "
                                 f"disagrees with its plain version: {row}")
        rows.append(row)
    return rows


def knob_training(dev, r_arch, r_batch, points: int, graphs: int, seed: int,
                  steps: int, n_layers: int, out: Callable = print) -> Dict:
    """(f), the model: the radius configuration under fused_bf16_max with
    RADARGNN_FUSED_{BF16_LANDING,PRECOMP_LAND,STREAM_M} set (the layers
    module's constants patched as the env sets them), `steps` train steps
    and one request, each against the plain path with the landing
    (`smoke._train_phase`, `smoke._serve_phase`), launches counted."""
    on_card = torch.device(dev).type == "cuda"
    arch = dataclasses.replace(r_arch, fused_bf16_max=True)
    names = ("dense_proj_v4", "windowed_fwd_v3", "windowed_fwd_v3_bf16_max",
             "windowed_fwd_v3_bf16_landing")
    with mock.patch.multiple(layers, BF16_LANDING=True, PRECOMP_LAND=True,
                             STREAM_M=True):
        res = sm._train_phase(
            dev, arch, r_batch, seed, steps,
            sm._expect({k: n_layers * steps
                        for k in names + ("windowed_bwd_v3",)}, on_card),
            "windowed, the variant knobs", out)
        res.update(sm._serve_phase(
            dev, arch, DetNet(arch, device=dev, seed=seed), [r_batch],
            graphs, points, sm._expect(dict.fromkeys(names, n_layers),
                                       on_card),
            "windowed, the variant knobs", out))
    return res


def knn_dense_tiling(dev, points: int, graphs: int, seed: int,
                     r_tile: int):
    """The flagship kNN batch under the dense tiling with `r_tile`
    receivers a tile (the node bucket aligned to the node block and to
    `r_tile`)."""
    arch, graph_cfg, bg_index, _ = sm.flagship_configs("knn")
    spec = dict(layers.fused_csr_tiling(arch, k=graph_cfg.k), r_tile=r_tile)
    samples = make_samples(num_frames=graphs, num_points=points, seed=seed,
                           graph_config=graph_cfg, bg_index=bg_index)
    max_nodes = sm._round_up(points, int(np.lcm(spec["node_block"], r_tile)))
    return arch, stack_samples(samples, max_nodes=max_nodes,
                               bg_index=bg_index,
                               max_edges=max_nodes * graph_cfg.k,
                               csr_tiling=spec, device=dev)


def check_r_tiles(dev, shapes: List[tuple], points: int, graphs: int,
                  seed: int, reps: int, n_layers: int,
                  out: Callable = print) -> Dict:
    """(g): B1's projection and gather-max and B2 at receiver tiles of 8
    and 24 (`smoke.check_routed_kernels`, its limits), and two train steps
    of the flagship at 8 against the plain path, launches counted."""
    on_card = torch.device(dev).type == "cuda"
    res: Dict = {}
    for r_tile in (8, 24):
        arch, batch = knn_dense_tiling(dev, points, graphs, seed, r_tile)
        tiling = batch.flat_tiling()
        if tiling.dense != (r_tile, tiling.dense[1]):
            raise AssertionError(f"the batch is not tiled at r_tile "
                                 f"{r_tile}: {tiling.dense}")
        out(f"kNN batch under the dense tiling at r_tile {r_tile}: "
            f"{batch.max_nodes} nodes a graph")
        with torch.no_grad():
            proj, fwd, bwd = sm.check_routed_kernels(tiling, shapes, seed,
                                                     reps, out)
        res[f"r_tile_{r_tile}"] = {"proj": proj, "fwd": fwd, "bwd": bwd}
        if r_tile == 8:
            steps = 2
            res["r_tile_8_train"] = sm._train_phase(
                dev, arch, batch, seed, steps,
                sm._expect({k: n_layers * steps for k in (
                    "dense_proj_v4", "dense_fwd_v4", "dense_bwd_v4")},
                    on_card), "kNN at r_tile 8", out)
    return res


def _flat_leaves(tree, prefix=()):
    """(key path, leaf) of a tree of dicts; an empty dict is a leaf."""
    if isinstance(tree, dict) and tree:
        for k, v in tree.items():
            yield from _flat_leaves(v, prefix + (k,))
    else:
        yield prefix, tree


# the committed orbax checkpoint the JAX package's save_train_state(backend=
# "orbax") wrote (tests/test_torch_orbax_fixture.py rebuilds it): a narrow
# flagship DetNet whose state is drawn from numpy's generator at this seed
ORBAX_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "testdata", "orbax_detnet")
ORBAX_FIXTURE_SEED = 20
# the most a store written with the port's zstd encoder may take of its
# arrays' bytes: the trainer's state after a step (weights drawn at
# initialisation and one step's moments, float32 that zstandard level 1
# takes to 0.914 of its bytes), and the flagship state of
# `orbax_fixture_state` (its biases and second moments on a grid, which
# the JAX package's store takes to 0.70); raw blocks take 1.02 of both
ORBAX_TRAINED_RATIO = 0.95
ORBAX_STATE_RATIO = 0.75


def orbax_fixture_arch():
    """The fixture's DetNet: the flagship's architecture at narrow widths."""
    arch, _, _, _ = sm.flagship_configs("knn")
    return dataclasses.replace(
        arch, conv_layer_dimensions=[16],
        node_feature_embedding_layer_dimensions=[16],
        edge_feature_embedding_layer_dimensions=[4],
        regression_head_layer_dimensions=[16, 5])


def orbax_fixture_state(seed: int = ORBAX_FIXTURE_SEED, arch=None) -> Dict:
    """`save_train_state`'s keyword arguments for the fixture: the DetNet's
    (`arch`, default the fixture's) flax variables and an optax Adam state
    of its shapes, drawn from numpy's generator at `seed` in sorted key
    order: kernels, means and first moments normal, biases and second
    moments on a coarse grid (so zstd finds repeats in them), variances in
    [0.5, 2], float32; the step count an int32; and the epoch, losses and
    lr."""
    rng = np.random.default_rng(seed)
    model = DetNet(arch or orbax_fixture_arch(), device="cpu")
    variables = weights.to_jax_variables(model.state_dict())
    opt = weights.optimizer_state_to_jax(
        make_optimizer(model.parameters(), 1e-3, 1e-4), model)

    def draw(tree, path=()):
        if isinstance(tree, dict):
            return {k: draw(tree[k], path + (k,)) for k in sorted(tree)}
        shape, name = np.shape(tree), path[-1]
        if name == "count":
            return np.asarray(7, np.int32)
        if name == "bias" or "nu" in path:
            grid = 1 << 20 if "nu" in path else 8
            value = rng.integers(0, 9, shape) / grid
        elif name == "var":
            value = rng.uniform(0.5, 2.0, shape)
        elif name in ("learning_rate", "weight_decay"):
            value = np.asarray(tree)
        else:
            value = rng.standard_normal(shape) * (1e-3 if "mu" in path
                                                   else 0.1)
        return np.asarray(value, np.float32)

    variables, opt = draw(variables), draw(opt)
    return {"params": variables["params"],
            "batch_stats": variables["batch_stats"], "opt_state": opt,
            "epoch": 3, "losses": {"train": [1.5, 1.25, 1.0],
                                   "validate": [1.75, 1.5, 1.25]},
            "scheduler_lr": 1e-3}


def _trees_equal(got, want) -> bool:
    """The same key paths, leaves equal bit for bit with one dtype."""
    got, want = dict(_flat_leaves(got)), dict(_flat_leaves(want))
    return sorted(got) == sorted(want) and all(
        np.asarray(got[k]).dtype == np.asarray(v).dtype
        and np.asarray(got[k]).shape == np.asarray(v).shape
        and np.array_equal(np.asarray(got[k]), np.asarray(v))
        for k, v in want.items())


def _folder_files(folder: str) -> Tuple[List[str], int]:
    files, size = [], 0
    for root, _, names in os.walk(folder):
        for name in names:
            files.append(os.path.relpath(os.path.join(root, name), folder))
            size += os.path.getsize(os.path.join(root, name))
    return sorted(files), size


def orbax_check(dev, arch, batch, seed: int, out: Callable = print) -> Dict:
    """(h): the orbax checkpoint backend, on the port's own OCDBT, zarr and
    zstd code. The kNN trainer's state after one step is saved and
    restored bit for bit (weights, statistics, moments, step count,
    hyper-parameters); a fresh trainer of the same architecture and seed
    resumes from it, and its next step on the batch gives the losses of
    the trainer that never stopped, bit for bit (deterministic algorithms;
    on the card the step launches B1 and B2); the committed checkpoint the
    JAX package wrote (`ORBAX_FIXTURE`, the one place tensorstore's
    compressed zstd blocks are read here) is read bit for bit against its
    state regenerated from its seed, and resumed into a trainer."""
    import tempfile

    def run(train_cfg):
        trainer = Trainer(train_cfg, DetNet(arch, device=dev, seed=seed))
        trainer.train_step(batch)
        with tempfile.TemporaryDirectory() as folder:
            with mock.patch.dict(os.environ, RADARGNN_CKPT_BACKEND="orbax"):
                t0 = time.perf_counter()
                trainer._checkpoint(folder, 1, 1e-3)
                save_s = time.perf_counter() - t0
            files, nbytes = _folder_files(os.path.join(folder, "orbax"))
            t0 = time.perf_counter()
            model, opt_sd, meta = ckpt.load_train_state(folder)
            load_s = time.perf_counter() - t0
            resumed = Trainer(train_cfg, DetNet(arch, device=dev, seed=seed))
            resumed.resume(folder)
        want = {"m": trainer._variables(), "o": weights.optimizer_state_to_jax(
            trainer.optimizer, trainer.model)}
        equal = _trees_equal({"m": model, "o": opt_sd}, want)
        kept = torch.stack(trainer.train_step(batch)).cpu().numpy()
        again = torch.stack(resumed.train_step(batch)).cpu().numpy()
        return {"leaves": len(dict(_flat_leaves(want))), "files": files,
                "bytes": nbytes, "array_bytes": _array_bytes(want),
                "save_s": save_s, "load_s": load_s,
                "bitwise": equal and meta["epoch"] == 1,
                "losses": kept.tolist(), "resumed_losses": again.tolist(),
                "resume_bitwise": kept.tobytes() == again.tobytes()}

    res = _deterministic_runs(run)
    res["ratio"] = res["bytes"] / res["array_bytes"]
    card = sm.card_description() if torch.device(dev).type == "cuda" \
        else "the CPU"
    out(f"orbax backend on {card}: the kNN trainer's state after one step "
        f"({res['leaves']} leaves, {res['bytes']} bytes in "
        f"{len(res['files'])} files: {', '.join(res['files'])}) saved in "
        f"save_s {res['save_s']:.3f} s, restored in load_s "
        f"{res['load_s']:.3f} s, bit for bit: {res['bitwise']}")
    out(f"orbax backend on {card}: the trainer's store of "
        f"{res['bytes']} bytes for {res['array_bytes']} bytes of arrays: "
        f"ratio {res['ratio']:.4f} (at most {ORBAX_TRAINED_RATIO})")
    out(f"orbax backend on {card}: a fresh trainer resumed from it takes "
        f"the next step with losses {res['resumed_losses']}, the "
        f"uninterrupted trainer's {res['losses']}: bitwise "
        f"{res['resume_bitwise']}")
    if not res["bitwise"]:
        raise AssertionError("the orbax checkpoint did not restore the "
                             "trainer's state bit for bit")
    if not res["resume_bitwise"]:
        raise AssertionError("the trainer resumed from the orbax checkpoint"
                             " stepped to other losses than the trainer "
                             "that never stopped")
    if res["ratio"] > ORBAX_TRAINED_RATIO:
        raise AssertionError(f"the trainer's orbax store takes {res['ratio']}"
                             f" of its arrays' bytes (at most "
                             f"{ORBAX_TRAINED_RATIO})")
    res["state"] = orbax_state_check(arch, seed, card, out)
    res["fixture"] = orbax_fixture_check(dev, out)
    return res


def _array_bytes(tree) -> int:
    return int(sum(np.asarray(v).nbytes for _, v in _flat_leaves(tree)
                   if not isinstance(v, dict)))


def orbax_state_check(arch, seed: int, card: str,
                      out: Callable = print) -> Dict:
    """(h), the store's size: `orbax_fixture_state(seed, arch)` (the state
    tests/orbax_read_time.py times) saved through the orbax backend and
    read back bit for bit; its checkpoint folder's bytes against its
    arrays' bytes, at most ORBAX_STATE_RATIO."""
    import tempfile

    state = orbax_fixture_state(seed, arch)
    trees = {k: state[k] for k in ("params", "batch_stats", "opt_state")}
    with tempfile.TemporaryDirectory() as folder:
        t0 = time.perf_counter()
        ckpt.save_train_state(folder, epoch=state["epoch"],
                              losses=state["losses"],
                              scheduler_lr=state["scheduler_lr"],
                              backend="orbax", **trees)
        save_s = time.perf_counter() - t0
        nbytes = _folder_files(folder)[1]
        t0 = time.perf_counter()
        model, opt_sd, _ = ckpt.load_train_state(folder)
        load_s = time.perf_counter() - t0
    res = {"bytes": nbytes, "array_bytes": _array_bytes(trees),
           "save_s": save_s, "load_s": load_s,
           "bitwise": _trees_equal(dict(model, opt_state=opt_sd), trees)}
    res["ratio"] = res["bytes"] / res["array_bytes"]
    out(f"orbax backend on {card}: the flagship state of seed {seed} "
        f"(orbax_fixture_state) in {res['bytes']} bytes for "
        f"{res['array_bytes']} bytes of arrays: ratio {res['ratio']:.4f} "
        f"(at most {ORBAX_STATE_RATIO}), saved in save_s "
        f"{res['save_s']:.3f} s, restored in load_s {res['load_s']:.3f} s,"
        f" bit for bit: {res['bitwise']}")
    if not res["bitwise"]:
        raise AssertionError("the flagship state did not restore from its "
                             "orbax checkpoint bit for bit")
    if res["ratio"] > ORBAX_STATE_RATIO:
        raise AssertionError(f"the flagship state's orbax store takes "
                             f"{res['ratio']} of its arrays' bytes (at "
                             f"most {ORBAX_STATE_RATIO})")
    return res


def orbax_fixture_check(dev, out: Callable = print) -> Dict:
    """(h), the JAX package's checkpoint: `ORBAX_FIXTURE` read against its
    state regenerated from its seed, then resumed into a trainer of its
    architecture on `dev` whose weights and moments must be that state."""
    want = orbax_fixture_state()
    t0 = time.perf_counter()
    model, opt_sd, meta = ckpt.load_train_state(ORBAX_FIXTURE)
    load_s = time.perf_counter() - t0
    equal = _trees_equal(
        {"params": model["params"], "batch_stats": model["batch_stats"],
         "opt_state": opt_sd},
        {k: want[k] for k in ("params", "batch_stats", "opt_state")})
    meta_equal = meta == {k: want[k] for k in ("epoch", "losses",
                                               "scheduler_lr")}
    cfg = UserConfigurationReader.read_config_file(sm.FLAGSHIP_CONFIG)
    train_cfg = UserConfigurationReader.get_config_object("TRAINING", cfg)
    trainer = Trainer(train_cfg, DetNet(orbax_fixture_arch(), device=dev))
    trainer.resume(ORBAX_FIXTURE)
    resumed = _trees_equal(
        {"m": trainer._variables(), "o": weights.optimizer_state_to_jax(
            trainer.optimizer, trainer.model)},
        {"m": {"params": want["params"],
               "batch_stats": want["batch_stats"]},
         "o": want["opt_state"]})
    files, nbytes = _folder_files(ORBAX_FIXTURE)
    out(f"orbax backend: the JAX package's checkpoint testdata/"
        f"{os.path.basename(ORBAX_FIXTURE)} ({nbytes} bytes, {len(files)} "
        f"files) read in {load_s:.3f} s: bit for bit the state of seed "
        f"{ORBAX_FIXTURE_SEED}: {equal}, its meta: {meta_equal}; resumed "
        f"into a trainer on {dev}: {resumed}")
    if not (equal and meta_equal and resumed):
        raise AssertionError("the JAX package's orbax checkpoint did not "
                             "read back as the state of its seed")
    return {"bitwise": equal, "meta": meta_equal, "resumed": resumed,
            "bytes": nbytes, "files": len(files), "load_s": load_s}


def check_ovf_landing(tiling, layer_shapes: List[tuple], seed: int,
                      reps: int, out: Callable = print) -> List[Dict]:
    """(b): B3 over the batch's overflow landing (`ovf_ssum`) on seeded
    dyadic bf16 rows of each layer's width d_in (a per-row d_xo, as the
    dense backward forms it under the flag), exact in any order, so the
    kernel and its plain version must agree exactly and two runs
    bitwise, and on real-valued bf16 and float32 rows bitwise the
    listed-order sum; timed against `index_add_` on the card."""
    order, row_ptr = tiling.ovf_landing
    dev = order.device
    cd = da.gather_dtype(dev)
    n = row_ptr.shape[0] - 1
    n_ovf = tiling.win[3].shape[0]
    dyadic = sm._dyadic(torch.Generator().manual_seed(seed), dev)
    rows = []
    for d, _, _ in layer_shapes:
        row, _ = sm._landing_row(dyadic(n_ovf, d).to(cd), None, order,
                                 row_ptr, n, reps, dev.type == "cuda")
        out(sm._landing_line(f" (ovf_ssum, {n_ovf} overflow rows)", row))
        sm._held_landing(row, 0.0, f"the overflow landing, d={d}")
        rows.append(row)
    return rows


def _deterministic_runs(fn: Callable):
    """Runs fn() under the flagship TRAINING section's deterministic
    setting, restoring torch's own after."""
    cfg = UserConfigurationReader.read_config_file(sm.FLAGSHIP_CONFIG)
    train_cfg = UserConfigurationReader.get_config_object("TRAINING", cfg)
    was = torch.are_deterministic_algorithms_enabled()
    try:
        set_seeds(train_cfg.seed, train_cfg.deterministic)
        return fn(train_cfg)
    finally:
        torch.use_deterministic_algorithms(was)


def csr_bf16_is_strict(dev, arch, batch, seed: int, steps: int,
                       layers_n: int, out: Callable = print) -> Dict:
    """(c), the CSR path: training under fused_bf16_max gives the strict
    run's losses and first-step gradients bit for bit, with the CSR
    kernels' launches and no bf16 ones."""
    on_card = torch.device(dev).type == "cuda"

    def runs(_):
        return (sm.flagship_training(
            dev, dataclasses.replace(arch, fused_bf16_max=True), batch, seed,
            steps), sm.flagship_training(dev, arch, batch, seed, steps))

    bf16, strict = _deterministic_runs(runs)
    expected = sm._expect(dict({n: layers_n * steps for n in (
        "dense_proj_v4", "csr_fwd_v2", "csr_bwd_v2")},
        segment_sum_csr=2 * layers_n * steps), on_card)
    same = bf16["losses"] == strict["losses"] and all(
        torch.equal(bf16["grads"][k], v) for k, v in strict["grads"].items())
    out(f"CSR training under fused_bf16_max: losses {bf16['losses']}; "
        f"bitwise the strict run's (losses and first-step gradients): "
        f"{same}; launches {bf16['launches']} (expected {expected})")
    if not same or bf16["launches"] != expected \
            or not np.isfinite(bf16["losses"]).all():
        raise AssertionError("the CSR path under fused_bf16_max is not the "
                             "strict run")
    return {"losses": bf16["losses"], "launches": bf16["launches"]}


def _cpu_reference(trainer: Trainer, arch, batch_cpu) -> tuple:
    """The losses and gradients of `trainer`'s model at its current
    parameters and buffers, computed on the CPU (a copy; the trainer's
    model is untouched)."""
    model = DetNet(arch, device="cpu")
    model.load_state_dict({k: v.detach().cpu()
                           for k, v in trainer.model.state_dict().items()})
    ref = Trainer(trainer.config, model)
    total, l_cls, l_bb = ref.losses(batch_cpu)
    total.backward()
    return ([float(v.detach()) for v in (total, l_cls, l_bb)],
            {n: p.grad.detach().clone()
             for n, p in model.named_parameters()})


def unfused_training(dev, arch, batch, seed: int, steps: int,
                     out: Callable = print) -> List[Dict]:
    """(d) (module docstring): for each case of UNFUSED_CASES, `steps`
    train steps on `dev` from seeded weights, each held to the CPU's
    losses and gradients at the same parameters (sm._step_agreement, the
    training limits), then the same run again, bitwise; no kernel
    launches."""
    on_card = torch.device(dev).type == "cuda"
    batch_cpu = batch.to("cpu")
    results = []
    for conv, pre, aggr in UNFUSED_CASES:
        a = dataclasses.replace(arch, conv_layer_type=conv,
                                conv_pre_mlp_layer_number=pre,
                                aggregation_function=aggr)

        def run(train_cfg, reference):
            trainer = Trainer(train_cfg, DetNet(a, device=dev, seed=seed))
            losses, agreement, seconds = [], [], []
            for c in sm._counters():
                c.launches = 0
            for _ in range(steps):
                ref = _cpu_reference(trainer, a, batch_cpu) \
                    if reference else None
                if on_card:
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses.append([float(v) for v in trainer.train_step(batch)])
                seconds.append(time.perf_counter() - t0)
                if ref is not None:
                    grads = {n: p.grad.detach().cpu() for n, p in
                             trainer.model.named_parameters()}
                    agreement.append(sm._step_agreement(losses[-1], grads,
                                                        *ref))
            return {"losses": losses, "agreement": agreement,
                    "seconds": seconds,
                    "launches": [c.launches for c in sm._counters()]}

        first, again = _deterministic_runs(
            lambda cfg: (run(cfg, True), run(cfg, False)))
        label = f"{conv}, pre-MLP {pre} layers, {aggr}"
        res = {"case": label, "losses": first["losses"],
               "agreement": first["agreement"],
               "step_ms": [s * 1e3 for s in first["seconds"]],
               "bitwise_repeat": again["losses"] == first["losses"],
               "launches": first["launches"]}
        out(f"unfused training ({label}): losses {res['losses']}; second run "
            f"bitwise equal {res['bitwise_repeat']}; against the CPU at each "
            "step's parameters: " + "; ".join(
                f"loss {g['loss_rel']:.2e}, cosine {g['cosine']:.6f}, min "
                f"parameter cosine {g['min_param_cosine']:.6f} "
                f"({g['min_param']})" for g in res["agreement"])
            + f"; ms per step {res['step_ms']}; launches {res['launches']}")
        if not res["bitwise_repeat"] or any(res["launches"]) \
                or not np.isfinite(res["losses"]).all():
            raise AssertionError(f"unfused training ({label}): {res}")
        for i, g in enumerate(res["agreement"]):
            if g["loss_rel"] > sm.TRAIN_LOSS_RTOL \
                    or g["cosine"] < sm.TRAIN_GRAD_COS \
                    or g["min_param_cosine"] < sm.TRAIN_PARAM_COS:
                raise AssertionError(f"unfused training ({label}) on {dev} "
                                     f"disagrees with the CPU at step {i}: "
                                     f"{g}")
        results.append(res)
    return results


def tools_phase(dev, out: Callable = print) -> Dict:
    """(e): the convergence tool (at the size CONVERGENCE_ARGS gives, on
    the card; off it at a tiny size on the CPU) and the preprocessing bench
    as child processes started together; each must exit 0 with the JAX
    tools' lines."""
    on_card = torch.device(dev).type == "cuda"
    conv_args = list(CONVERGENCE_ARGS)
    pre_args = list(PREPROCESSING_ARGS)
    if not on_card:
        conv_args = ["--device", "cpu", "--frames", "10", "--points", "200",
                     "--epochs", "2", "--batch-size", "4", "--fused",
                     "--dense"]
        pre_args += ["--points", "200", "--workers", "2"]
    env = dict(os.environ, OMP_NUM_THREADS=os.environ.get(
        "OMP_NUM_THREADS", "4"))

    def start(module, args):
        return subprocess.Popen(
            [sys.executable, "-m", f"radargnn_tpu_torch.benchmarks.{module}",
             *args], cwd=sm._REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)

    t0 = time.perf_counter()
    children = {"convergence": start("convergence", conv_args),
                "preprocessing_bench": start("preprocessing_bench",
                                             pre_args)}
    try:
        results = {k: sm._finish(p, 600) for k, p in children.items()}
    finally:
        for proc in children.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    seconds = time.perf_counter() - t0
    for name, (code, _, stderr) in results.items():
        if code != 0:
            raise AssertionError(f"{name} exited {code}:\n{stderr[-3000:]}")
    lines = [json.loads(s) for s in
             results["convergence"][1].strip().splitlines()]
    epochs, metrics = lines[:-2], lines[-2:]
    if [e.get("epoch") for e in epochs] != list(range(1, len(epochs) + 1)) \
            or not epochs or not all(math.isfinite(e["loss_train"])
                                     and math.isfinite(e["loss_valid"])
                                     for e in epochs) \
            or [m["metric"] for m in metrics] != ["synthetic_map",
                                                  "synthetic_f1_macro"]:
        raise AssertionError(f"convergence printed {lines}")
    pre = results["preprocessing_bench"][1].strip().splitlines()
    if len(pre) != 2 or not pre[0].startswith("single-process: ") \
            or "-process pool: " not in pre[1] \
            or not all("points/s" in s and "edges/s" in s for s in pre):
        raise AssertionError(f"preprocessing_bench printed {pre}")
    out(f"convergence {' '.join(conv_args)}: " + " | ".join(
        json.dumps(x) for x in lines))
    out(f"preprocessing_bench {' '.join(pre_args)}: " + " | ".join(pre))
    return {"convergence_args": conv_args, "convergence": lines,
            "preprocessing_args": pre_args, "preprocessing": pre,
            "seconds": seconds}


def variants_phase(dev, arch, batch, r_arch, r_batch, c_arch, c_batch,
                   shapes: List[tuple], points: int, graphs: int, seed: int,
                   reps: int, steps: int, strict_losses: Dict,
                   out: Callable = print) -> Dict:
    """The ninth phase (module docstring) on the kNN batch (`batch`, dense
    tiling), the radius batch (`r_batch`, windowed) and the kNN batch under
    the CSR tiling (`c_batch`), with the paths' configurations: (a)-(c)
    (`routing_phase`), then (d)-(h) (`settings_phase`). Returns their rows
    and results."""
    res = routing_phase(dev, arch, batch, r_arch, r_batch, c_arch, c_batch,
                        shapes, points, graphs, seed, reps, steps,
                        strict_losses, out)
    res.update(settings_phase(dev, arch, batch, r_arch, r_batch, shapes,
                              points, graphs, seed, reps, steps, out))
    return res


def routing_phase(dev, arch, batch, r_arch, r_batch, c_arch, c_batch,
                  shapes: List[tuple], points: int, graphs: int, seed: int,
                  reps: int, steps: int, strict_losses: Dict,
                  out: Callable = print) -> Dict:
    """(a)-(c): bf16 routing and ovf_ssum. `strict_losses` are the dense
    and windowed strict training runs' per-step losses, whose first step
    the bf16 runs must give bit for bit (the forward is the same)."""
    on_card = torch.device(dev).type == "cuda"
    n_layers = len(shapes)
    res: Dict = {}
    with torch.no_grad():
        res["dense_bits"] = check_bf16_bits(batch.flat_tiling(), shapes,
                                            seed, reps, "kNN, dense", out)
        res["windowed_bits"] = check_bf16_bits(
            r_batch.flat_tiling(), shapes, seed, reps, "radius, windowed",
            out)
    paths = (("dense", arch, batch, ("dense_fwd_v4", "dense_bwd_v4")),
             ("windowed", r_arch, r_batch,
              ("windowed_fwd_v3", "windowed_bwd_v3")))
    for name, a, b, kernels in paths:
        names = ("dense_proj_v4",) + kernels + (f"{kernels[0]}_bf16_max",)
        run = sm._train_phase(
            dev, dataclasses.replace(a, fused_bf16_max=True), b, seed, steps,
            sm._expect({k: n_layers * steps for k in names}, on_card),
            f"{name} fused_bf16_max", out)
        first = run["train_losses"][0] == strict_losses[name][0]
        out(f"{name} fused_bf16_max: first step's losses bitwise the strict "
            f"run's {first}; later steps {run['train_losses'][1:]} against "
            f"strict {strict_losses[name][1:]}")
        if not first:
            raise AssertionError(f"{name}: bf16 routing changed the forward")
        res[f"{name}_train"] = run
    res["csr_train"] = csr_bf16_is_strict(dev, c_arch, c_batch, seed, steps,
                                          n_layers, out)

    with mock.patch.object(layers, "OVF_SSUM", True):
        o_arch, _, o_loader = sm.flagship_serving(dev, points, graphs, 1,
                                                  seed)
        o_batch = o_loader[0]
        if o_batch.ovf_landing is None:
            raise AssertionError("the ovf_ssum batch carries no overflow "
                                 "landing")
        with torch.no_grad():
            res["ovf_landing"] = check_ovf_landing(o_batch.flat_tiling(),
                                                   shapes, seed, reps, out)
        o_steps = 2
        res["ovf_ssum_train"] = sm._train_phase(
            dev, o_arch, o_batch, seed, o_steps,
            sm._expect(dict({k: n_layers * o_steps for k in (
                "dense_proj_v4", "dense_fwd_v4", "dense_bwd_v4")},
                segment_sum_csr=n_layers * o_steps), on_card),
            "kNN ovf_ssum", out)
    return res


def settings_phase(dev, arch, batch, r_arch, r_batch, shapes: List[tuple],
                   points: int, graphs: int, seed: int, reps: int,
                   steps: int, out: Callable = print) -> Dict:
    """(d)-(h): the unfused configurations, the tools, B4's bf16 landing
    and the variant knobs, dense receiver tiles of 8 and 24, orbax."""
    n_layers = len(shapes)
    res: Dict = {}
    res["unfused"] = unfused_training(dev, arch, batch, seed, 2, out)
    res["tools"] = tools_phase(dev, out)

    with torch.no_grad():
        res["windowed_landing"] = check_landing(r_batch.flat_tiling(),
                                                shapes, seed, reps, out)
    res["knob_train"] = knob_training(dev, r_arch, r_batch, points, graphs,
                                      seed, min(steps, 2), n_layers, out)
    res.update(check_r_tiles(dev, shapes, points, graphs, seed, reps,
                             n_layers, out))
    res["orbax"] = orbax_check(dev, arch, batch, seed, out)
    return res


def variants_kernels(variants: Dict, on_card: bool) -> List[Dict]:
    """The ninth phase's entries of the kernels line (`routing_kernels`,
    then `settings_kernels`)."""
    return routing_kernels(variants, on_card) + settings_kernels(variants,
                                                                 on_card)


def routing_kernels(variants: Dict, on_card: bool) -> List[Dict]:
    """(a)-(c)'s entries: B1's and B4's gather-max with the bf16 test (VJP
    mode, the mode of their training launches; they replace the bf16_cmp
    branch of the TPU backward kernels), launched by the fused_bf16_max
    training runs; B3 on the dense overflow rows (`ovf_ssum`), launched by
    that training run, against index_add_."""
    def entry(*args):
        return sm.kernel_entry(*args, on_card=on_card)

    b1, b4 = variants["dense_bits"], variants["windowed_bits"]
    return [
        entry("dense_fwd_v4_bf16_max", "dense_fwd_v4.cu", 2340,
              variants["dense_train"]["train_launches"][12], b1, b1, False),
        entry("windowed_fwd_v3_bf16_max", "windowed_fwd_v3.cu", 1387,
              variants["windowed_train"]["train_launches"][13], b4, b4,
              False),
        entry("segment_sum_csr_ovf_ssum", "segment_sum_csr.cu", 854,
              variants["ovf_ssum_train"]["train_launches"][2],
              variants["ovf_landing"], variants["ovf_landing"], True),
    ]


def settings_kernels(variants: Dict, on_card: bool) -> List[Dict]:
    """(f)-(g)'s entries: B4's gather-max with the bf16 landing (VJP mode;
    the bf16_landing branch of the TPU forward kernel), launched by the
    variant knobs' run; B1's gather-max and B2 at receiver tiles of 8,
    launched by that training run (the errors at 8 and 24)."""
    def entry(*args):
        return sm.kernel_entry(*args, on_card=on_card)

    landing = variants["windowed_landing"]
    r8 = variants["r_tile_8"]
    r_checked = {k: r8[k] + variants["r_tile_24"][k] for k in ("fwd", "bwd")}
    r8_l = variants["r_tile_8_train"]["train_launches"]
    return [
        entry("windowed_fwd_v3_bf16_landing", "windowed_fwd_v3.cu", 1364,
              variants["knob_train"]["train_launches"][14], landing,
              landing, False),
        entry("dense_fwd_v4_r_tile_8", "dense_fwd_v4.cu", 2279, r8_l[0],
              r8["fwd"], r_checked["fwd"], False),
        entry("dense_bwd_v4_r_tile_8", "dense_bwd_v4.cu", 2340, r8_l[1],
              r8["bwd"], r_checked["bwd"], False),
    ]
