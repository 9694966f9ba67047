"""The smoke's ninth phase: the settings that reach kernel variants or no
kernel at all (`smoke.run` calls `variants_phase` last).

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
      child processes, each checked for the lines the JAX tools print.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from typing import Callable, Dict, List
from unittest import mock

import numpy as np
import torch

from radargnn_tpu_torch import smoke as sm
from radargnn_tpu_torch.benchmarks.kernel_bench import time_ms as _time_ms
from radargnn_tpu_torch.configs import UserConfigurationReader
from radargnn_tpu_torch.models import layers
from radargnn_tpu_torch.models.detnet import DetNet
from radargnn_tpu_torch.ops import dense_aggregate as da
from radargnn_tpu_torch.train.trainer import Trainer, set_seeds

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


def check_ovf_landing(tiling, layer_shapes: List[tuple], seed: int,
                      reps: int, out: Callable = print) -> List[Dict]:
    """(b): B3 over the batch's overflow landing (`ovf_ssum`) on seeded
    dyadic bf16 rows of each layer's width d_in (a per-row d_xo, as the
    dense backward forms it under the flag), exact in any order, so the
    kernel and its plain version must agree exactly and two runs
    bitwise; timed against `index_add_` on the card."""
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
        out(f"kernel segment_sum_csr (ovf_ssum) d={d} rows={row['rows']} of "
            f"{n_ovf}: max_abs_err={row['max_abs_err']:.3e} bitwise repeat "
            f"{row['bitwise_repeat']} ms={row['ms']} plain_ms="
            f"{row['plain_ms']} index_add_ ms={row['library_ms']} bound_ms="
            f"{row['bound_ms']:.4f} ({row['bound_by']})")
        if row["max_abs_err"] > 0.0 or not row["bitwise_repeat"]:
            raise AssertionError(f"B3 on the overflow landing disagrees "
                                 f"with its plain version at d={d}: {row}")
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
    the CSR tiling (`c_batch`), with the paths' configurations; `strict_losses`
    are the dense and windowed strict training runs' per-step losses, whose
    first step the bf16 runs must give bit for bit (the forward is the
    same). Returns its rows and results."""
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
    res["unfused"] = unfused_training(dev, arch, batch, seed, 2, out)
    res["tools"] = tools_phase(dev, out)
    return res
