"""End-to-end check of the port on one device: the kernels against their
plain versions, the flagship DetNet serving path through `Predictor`, and
the flagship training path through `Trainer`.

`run(device)` is what `chip_smoke.py` calls on the card; the CPU tests call
it at a tiny size, where the wrappers take their plain versions, nothing is
built and no time is measured. Every phase raises on failure; nothing is
caught and continued.
"""

from __future__ import annotations

import json
import os
import subprocess
import time
from contextlib import ExitStack
from typing import Callable, Dict, List, Tuple
from unittest import mock

import numpy as np
import torch

from radargnn_tpu_torch.build import nvcc_all
from radargnn_tpu_torch.configs import UserConfigurationReader
from radargnn_tpu_torch.data.synthetic import make_samples
from radargnn_tpu_torch.device import DeviceLike, resolve_device
from radargnn_tpu_torch.graph.batch import stack_samples
from radargnn_tpu_torch.models.detnet import DetNet
from radargnn_tpu_torch.models.layers import fused_csr_tiling
from radargnn_tpu_torch.ops import dense_aggregate as da
from radargnn_tpu_torch.ops import segment_sum as ss
from radargnn_tpu_torch.postprocess.inference import Predictor
from radargnn_tpu_torch.train.trainer import Trainer, set_seeds

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP_CONFIG = os.path.join(_REPO, "configurations",
                               "configuration_radarscenes.yml")
KERNEL_SOURCES = ("dense_fwd_v4.cu", "dense_bwd_v4.cu", "segment_sum_csr.cu")

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12          # outside the tensor cores
PEAK_HBM_BYTES = 3.35e12

# forward kernel vs plain version on the same bf16 inputs: both sum exact
# bf16 products in float32 and differ only in summation order
KERNEL_RTOL = 1e-3
# backward kernels and landing vs plain versions, on dyadic inputs
# (multiples of 1/8, check_bwd_kernels) where every product and sum is
# exact in float32 in any order: they must agree up to the bf16 rounding
# of equal values, so any error is a fault; the limit is the float32 one
BWD_RTOL = 1e-3
# whole model, kernel path vs plain path on the card: a different f32
# summation order can move an activation across a bf16 rounding boundary
# (one bf16 ulp, 2^-8 relative) in the next layer's matmul inputs, and five
# layers with BatchNorm carry that on; the outputs must still agree to
MODEL_ATOL_PROB = 2e-2
MODEL_RTOL_BOX = 2e-2
# training, kernel path vs plain path, per-step losses: the forwards differ
# by the bf16 rounding flips above; the backward rounds d_op and d_xg to
# bf16 (the TPU kernel's grad dtype), so the two paths' gradients differ
# by bf16 noise that grows back through the layers (cosine 0.99925 over
# all parameters after one step at the flagship size, PERF.md), and Adam
# steps carry it into the losses
TRAIN_LOSS_RTOL = 2e-2


def card_description() -> str:
    """The card's name and power limit, as nvidia-smi reports them (a card
    set below 700 W runs slower under load)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def _time_ms(fn: Callable, reps: int) -> float:
    """Mean device time of fn() in ms, by CUDA events over `reps` calls
    after one warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _kernel_bound(d: int, de: int, h: int, n: int, e_pad: int, t: int,
                  valid_slots: int) -> Dict:
    """Least time the card could take for one dense forward at these
    shapes: the larger of the bf16 products the function needs over the
    tensor-core peak, and the bytes (each input read once, the output
    written once) over the HBM rate. The function needs x @ W_s once per
    node, since x[s] @ W_s = (x @ W_s)[s], and e @ W_e once per valid slot.
    `slot_flops` is the work of the current kernel, which runs both
    products per valid slot as the TPU kernel does; it is not the bound."""
    flops = 2.0 * (n * d * h + valid_slots * de * h)
    nbytes = (n * d * 2 + d * h * 2 + e_pad * de * 2 + de * h * 2
              + e_pad * 4 + t * 4 + 3 * n * h * 4)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return {"flops": flops, "bytes": nbytes,
            "slot_flops": 2.0 * valid_slots * (d + de) * h,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def check_fwd_kernel(tiling, layer_shapes: List[tuple], seed: int, reps: int,
                     out: Callable = print) -> List[Dict]:
    """Holds the dense forward kernel against `dense_fwd_plain` at each
    (d_in, d_e, H) of the model, on the batch's real slot layout and seeded
    bf16 inputs, in serving and in VJP mode (`inner`); times both on the
    card. Raises beyond KERNEL_RTOL."""
    r_tile, k = tiling.dense
    sloc, t_win, _, ovf_s, ovf_r, _ = tiling.win
    dev = sloc.device
    cd = da.gather_dtype(dev)
    e_pad = sloc.shape[0]
    t = t_win.shape[0]
    n = t * r_tile
    valid_slots = int((sloc >= 0).sum())
    on_card = dev.type == "cuda"
    gen = torch.Generator().manual_seed(seed)
    results = []
    for d, de, h in layer_shapes:
        def rand(*shape, scale=1.0):
            return (torch.randn(shape, generator=gen) * scale).to(dev)

        x = rand(n, d).to(cd)
        w_s = rand(d, h, scale=d ** -0.5).to(cd)
        e_t = rand(e_pad, de).to(cd)
        w_e = rand(de, h, scale=de ** -0.5).to(cd)
        inner_o = da.dense_overflow_inner(
            x, w_s, rand(ovf_s.shape[0], de).to(cd), w_e, ovf_s, ovf_r, n)
        offset = rand(n, h)
        args = (x, w_s, e_t, w_e, sloc, t_win, inner_o, offset)
        kw = dict(r_tile=r_tile, k=k, node_block=tiling.node_block)
        got = da.dense_fwd(*args, **kw)
        ref = da.dense_fwd_plain(*args, **kw)
        got_vjp, inner = da.dense_fwd(*args, emit_inner=True, **kw)
        _, ref_inner = da.dense_fwd_plain(*args, emit_inner=True, **kw)
        if on_card:
            torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise AssertionError(f"kernel output not finite at d={d}, h={h}")
        if not torch.equal(got_vjp, got):
            raise AssertionError("the VJP mode changed the forward's output")
        has = ref_inner > da._NEG / 2
        if not torch.equal(inner > da._NEG / 2, has):
            raise AssertionError("VJP mode: empty receivers differ")
        err = max(float((got - ref).abs().max()),
                  float((inner[has] - ref_inner[has]).abs().max()))
        scale = max(float(ref.abs().max()), 1.0)
        row = {"d_in": d, "d_e": de, "h": h, "max_abs_err": err,
               "max_rel_err": err / scale}
        row.update(_kernel_bound(d, de, h, n, e_pad, t, valid_slots))
        if on_card:
            row["ms"] = _time_ms(lambda: da.dense_fwd(*args, **kw), reps)
            row["plain_ms"] = _time_ms(
                lambda: da.dense_fwd_plain(*args, **kw), reps)
        else:
            row["ms"] = row["plain_ms"] = None
        out(f"kernel dense_fwd_v4 d_in={d} H={h}: max_abs_err={err:.3e} "
            f"max_rel_err={row['max_rel_err']:.3e} ms={row['ms']} "
            f"plain_ms={row['plain_ms']} bound_ms={row['bound_ms']:.4f} "
            f"({row['bound_by']}; {row['flops'] / 1e9:.2f} GFLOP needed, "
            f"{row['slot_flops'] / 1e9:.2f} GFLOP as the kernel does it)")
        if row["max_rel_err"] > KERNEL_RTOL:
            raise AssertionError(
                f"dense_fwd_v4 disagrees with dense_fwd_plain at d_in={d}, "
                f"H={h}: max_rel_err {row['max_rel_err']:.3e} > {KERNEL_RTOL}")
        results.append(row)
    return results


def _bwd_bound(d: int, de: int, h: int, n: int, e_pad: int, t: int,
               valid_slots: int) -> Dict:
    """Least time the card could take for one dense backward (the TPU
    kernel's function, d_x landed): d_x = (the sum of d_op over a sender's
    slots) @ W_s^T and dW_s = x^T @ (the same sums) once per node, d_e and
    dW_e once per valid slot; the bytes of x, e_t, sloc, tile_win, inner,
    g, the weights (in) and d_x, d_e, dW_s, dW_e (out)."""
    flops = 4.0 * (n * d * h + valid_slots * de * h)
    nbytes = (n * d * 2 + e_pad * de * 2 + e_pad * 4 + t * 4 + 2 * n * h * 4
              + (d + de) * h * 2 + n * d * 4 + e_pad * de * 2
              + (d + de) * h * 4)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return {"flops": flops, "bytes": nbytes,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def _segsum_bound(d: int, rows_bf16: int, rows_f32: int, n: int) -> Dict:
    """Least time for one landing: each listed row read once (bf16 slot
    rows, f32 overflow rows), its index, the row offsets, the f32 output
    written once; one f32 add per element read."""
    rows = rows_bf16 + rows_f32
    flops = float(rows * d)
    nbytes = (rows_bf16 * d * 2 + rows_f32 * d * 4 + rows * 4 + (n + 1) * 4
              + n * d * 4)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES
    return {"flops": flops, "bytes": nbytes,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> Tuple[float, float]:
    err = float((got.float() - want.float()).abs().max())
    return err, err / max(float(want.float().abs().max()), 1.0)


def check_bwd_kernels(tiling, layer_shapes: List[tuple], seed: int,
                      reps: int, out: Callable = print
                      ) -> Tuple[List[Dict], List[Dict]]:
    """Holds the dense backward kernels (B2) and the landing (B3) against
    their plain versions at each (d_in, d_e, H) of the model, on the
    batch's real slot layout and landing; checks that two runs give the
    same bits; times kernels, plain versions and, for the landing,
    `index_add_` (the library call) on the card.

    The inputs are seeded dyadic bf16 values (x, e, g in multiples of 1/2
    or 1/8, the weights in multiples of 1/4), so every product and every
    sum the kernels and the plain versions form is exact in float32 in any
    order. Routing then compares equal operands in both, exact ties are
    frequent (every tied slot takes the full g), and the two must agree up
    to bf16 rounding of equal values (BWD_RTOL). With real-valued inputs a
    slot at the routing tolerance's edge may route in one version only;
    the training comparison covers those inputs end to end."""
    r_tile, k = tiling.dense
    sloc, t_win, _, ovf_s, ovf_r, _ = tiling.win
    order, row_ptr = tiling.landing
    dev = sloc.device
    cd = da.gather_dtype(dev)
    e_pad, t = sloc.shape[0], t_win.shape[0]
    n = t * r_tile
    valid_slots = int((sloc >= 0).sum())
    valid_ovf = int((ovf_r >= 0).sum())
    on_card = dev.type == "cuda"
    gen = torch.Generator().manual_seed(seed)
    kw = dict(r_tile=r_tile, k=k, node_block=tiling.node_block)
    # sender of every landed row, and a dummy segment n for the rest, for
    # the library call
    rows_total = e_pad + ovf_s.shape[0]
    seg = torch.full((rows_total,), n, dtype=torch.long, device=dev)
    seg[order.long()] = ss.segment_ids(row_ptr)

    def dyadic(*shape, lo=-2, hi=2, step=0.5):
        return (torch.randint(lo, hi + 1, shape, generator=gen)
                * step).to(dev)

    b2_rows, b3_rows = [], []
    for d, de, h in layer_shapes:
        x = dyadic(n, d).to(cd)
        w_s = dyadic(d, h, step=0.25).to(cd)
        e_t = dyadic(e_pad, de).to(cd)
        w_e = dyadic(de, h, step=0.25).to(cd)
        inner_o = da.dense_overflow_inner(
            x, w_s, dyadic(ovf_s.shape[0], de).to(cd), w_e, ovf_s, ovf_r, n)
        _, inner = da.dense_fwd(x, w_s, e_t, w_e, sloc, t_win, inner_o,
                                torch.zeros_like(inner_o), emit_inner=True,
                                **kw)
        has = inner > da._NEG / 2
        args = (x, w_s, e_t, w_e, sloc, t_win, torch.where(has, inner, 0.0),
                torch.where(has, dyadic(n, h, lo=-8, hi=8, step=0.125), 0.0))
        got = da.dense_bwd(*args, **kw)
        ref = da.dense_bwd_plain(*args, **kw)
        again = da.dense_bwd(*args, **kw)
        # the landing: slot rows (d_xg, the gather dtype) then overflow rows
        d_xo = dyadic(ovf_s.shape[0], d, lo=-8, hi=8, step=0.125)
        land = (got[0], order, row_ptr, d_xo)
        d_x = ss.segment_sum_csr(*land)
        d_x_ref = ss.segment_sum_csr_plain(*land)
        d_x_again = ss.segment_sum_csr(again[0], order, row_ptr, d_xo)
        if on_card:
            torch.cuda.synchronize()
        names = ("d_xg", "d_e", "dW_s", "dW_e")
        for name, u, v in zip(names, got, ref):
            if u.shape != v.shape or u.dtype != v.dtype \
                    or not torch.isfinite(u).all():
                raise AssertionError(f"dense_bwd_v4 {name} at d_in={d}: "
                                     "shape, dtype or not finite")
        errs = [_rel_err(u, v) for u, v in zip(got, ref)]
        seg_err = _rel_err(d_x, d_x_ref)
        same = all(torch.equal(u, v) for u, v in
                   zip((d_x, *got[1:]), (d_x_again, *again[1:])))
        b2 = {"d_in": d, "d_e": de, "h": h,
              "max_abs_err": max(e[0] for e in errs),
              "max_rel_err": max(e[1] for e in errs), "bitwise_repeat": same,
              **_bwd_bound(d, de, h, n, e_pad, t, valid_slots)}
        b3 = {"d": d, "rows": valid_slots + valid_ovf,
              "max_abs_err": seg_err[0], "max_rel_err": seg_err[1],
              **_segsum_bound(d, valid_slots, valid_ovf, n)}
        if on_card:
            b2["ms"] = _time_ms(lambda: da.dense_bwd(*args, **kw), reps)
            b2["plain_ms"] = _time_ms(
                lambda: da.dense_bwd_plain(*args, **kw), reps)
            b3["ms"] = _time_ms(lambda: ss.segment_sum_csr(*land), reps)
            b3["plain_ms"] = _time_ms(
                lambda: ss.segment_sum_csr_plain(*land), reps)
            src = torch.cat([got[0].float(), d_xo])
            acc = torch.zeros((n + 1, d), dtype=torch.float32, device=dev)
            b3["library_ms"] = _time_ms(
                lambda: acc.index_add_(0, seg, src), reps)
        else:
            b2["ms"] = b2["plain_ms"] = None
            b3["ms"] = b3["plain_ms"] = b3["library_ms"] = None
        out(f"kernel dense_bwd_v4 d_in={d} H={h}: errors (abs, rel) "
            + ", ".join(f"{nm} {e[0]:.3e} {e[1]:.3e}"
                        for nm, e in zip(names, errs))
            + f"; bitwise repeat {same}; ms={b2['ms']} plain_ms="
            f"{b2['plain_ms']} bound_ms={b2['bound_ms']:.4f} "
            f"({b2['bound_by']}; {b2['flops'] / 1e9:.2f} GFLOP, "
            f"{b2['bytes'] / 1e6:.1f} MB)")
        out(f"kernel segment_sum_csr d={d} rows={b3['rows']}: max_abs_err="
            f"{seg_err[0]:.3e} ms={b3['ms']} plain_ms={b3['plain_ms']} "
            f"index_add_ ms={b3['library_ms']} bound_ms="
            f"{b3['bound_ms']:.4f} ({b3['bound_by']})")
        if b2["max_rel_err"] > BWD_RTOL or seg_err[1] > BWD_RTOL:
            raise AssertionError(
                f"backward kernels disagree with their plain versions at "
                f"d_in={d}, H={h}: {errs}, landing {seg_err}")
        if not same:
            raise AssertionError(f"two backward runs differ at d_in={d}")
        b2_rows.append(b2)
        b3_rows.append(b3)
    return b2_rows, b3_rows


def _layer_shapes(model: DetNet) -> List[tuple]:
    """(d_in, d_e, H) of each conv layer's dense aggregation."""
    shapes = []
    for i in range(model.num_conv):
        conv = getattr(model, f"conv_{i}")
        shapes.append((conv.in_channels, conv.edge_feat_dim,
                       conv.pre_mlp.lin_0.weight.shape[0]))
    return shapes


def flagship_serving(dev: DeviceLike, points: int, graphs: int,
                     batches: int, seed: int
                     ) -> Tuple[object, DetNet, List]:
    """The serving path's set-up: the configuration's DetNet with seeded
    weights on `dev`, and `batches` requests of `graphs` synthetic frames of
    `points` points each, stacked under the dense kNN tiling the
    configuration selects. Returns (arch config, model, loader)."""
    cfg = UserConfigurationReader.read_config_file(FLAGSHIP_CONFIG)
    arch = UserConfigurationReader.get_config_object("MODEL_ARCHITECTURE", cfg)
    graph_cfg = UserConfigurationReader.get_config_object(
        "GRAPH_CONSTRUCTION", cfg)
    bg_index = UserConfigurationReader.get_config_object(
        "POSTPROCESSING", cfg).bg_index
    k = graph_cfg.k
    tiling_spec = fused_csr_tiling(arch, k=k)
    if tiling_spec is None:
        raise AssertionError("the configuration does not select the fused "
                             "dense path")
    align = int(np.lcm(tiling_spec["node_block"], tiling_spec["r_tile"]))
    max_nodes = -(-points // align) * align
    samples = make_samples(num_frames=graphs * batches, num_points=points,
                           seed=seed, graph_config=graph_cfg,
                           bg_index=bg_index)
    loader = [stack_samples(samples[i * graphs:(i + 1) * graphs],
                            max_nodes=max_nodes, bg_index=bg_index,
                            max_edges=max_nodes * k, csr_tiling=tiling_spec,
                            device=dev)
              for i in range(batches)]
    return arch, DetNet(arch, device=dev, seed=seed), loader


def _counters():
    """The launch counters of the kernels on the main path."""
    return (da.dense_fwd_cuda, da.dense_bwd_cuda, ss.segment_sum_csr_cuda)


def _plain_kernels() -> ExitStack:
    """Patches every kernel wrapper to its plain version (the plain path
    on the same device)."""
    stack = ExitStack()
    stack.enter_context(mock.patch.object(da, "dense_fwd",
                                          da.dense_fwd_plain))
    stack.enter_context(mock.patch.object(da, "dense_bwd",
                                          da.dense_bwd_plain))
    stack.enter_context(mock.patch.object(ss, "segment_sum_csr",
                                          ss.segment_sum_csr_plain))
    return stack


def flagship_training(dev: DeviceLike, arch, batch, seed: int, steps: int,
                      plain: bool = False) -> Dict:
    """The training path: a `Trainer` from the flagship configuration's
    TRAINING section on a DetNet with weights from `seed`, `steps` train
    steps on `batch`. Returns the per-step (total, cls, bb) losses, the
    per-step wall seconds (each step ends when its losses reach the host),
    the first step's gradients by parameter name, and the kernel launches
    of the run (the counters are set to 0 just before it and read just
    after)."""
    cfg = UserConfigurationReader.read_config_file(FLAGSHIP_CONFIG)
    train_cfg = UserConfigurationReader.get_config_object("TRAINING", cfg)
    trainer = Trainer(train_cfg, DetNet(arch, device=dev, seed=seed))
    on_card = torch.device(dev).type == "cuda"
    losses, seconds, grads = [], [], {}
    with _plain_kernels() if plain else ExitStack():
        for c in _counters():
            c.launches = 0
        for step in range(steps):
            if on_card:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append([float(v) for v in trainer.train_step(batch)])
            seconds.append(time.perf_counter() - t0)
            if step == 0:
                grads = {n: p.grad.detach().clone()
                         for n, p in trainer.model.named_parameters()}
        launches = [c.launches for c in _counters()]
    return {"losses": losses, "seconds": seconds, "grads": grads,
            "launches": launches}


def _grad_agreement(got: Dict[str, torch.Tensor],
                    ref: Dict[str, torch.Tensor]) -> Dict:
    """Cosine and norm ratio of two gradients over all parameters, and the
    relative difference |got - ref| / |ref| of each conv's pre-MLP weight
    and of the heads' first weights (input side first)."""
    a = torch.cat([g.flatten() for g in got.values()]).double()
    b = torch.cat([g.flatten() for g in ref.values()]).double()
    cos = float(torch.nn.functional.cosine_similarity(a, b, dim=0))
    by_layer = {n.split(".")[0]: float((got[n] - ref[n]).norm()
                                       / ref[n].norm())
                for n in ref if n.endswith("pre_mlp.lin_0.weight")
                or n.endswith("head.lin_0.weight")}
    return {"cosine": cos, "norm_ratio": float(a.norm() / b.norm()),
            "rel_diff": by_layer}


def run(device: DeviceLike = None, points: int = 2816, graphs: int = 5,
        batches: int = 3, seed: int = 0, reps: int = 20,
        train_steps: int = 4, out: Callable = print) -> Dict:
    """Runs every phase; returns the summary (also printed as JSON lines).

    `points`/`graphs` size the synthetic frames (the serving and training
    batch is 5 graphs of 2816 points); `batches` is the number of requests
    served, `train_steps` the train steps of each training run (the first
    is a warm-up, the rest are timed)."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    summary: Dict = {"device": str(dev)}

    # -- card and build ----------------------------------------------------
    if on_card:
        summary["card"] = card_description()
        out(f"card: {summary['card']}")
        t0 = time.perf_counter()
        built = nvcc_all(KERNEL_SOURCES)
        da.load_fwd_kernel()
        da.load_bwd_kernel()
        ss.load_kernel()
        summary["build_s"] = time.perf_counter() - t0
        out(f"build: {summary['build_s']:.2f} s, {len(built)} sources "
            "compiled in parallel")
        for src, (path, log) in built.items():
            out(f"{src} -> {path}")
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    out(f"  {line.strip()}")

    # -- model and requests ------------------------------------------------
    t0 = time.perf_counter()
    arch, model, loader = flagship_serving(dev, points, graphs, batches, seed)
    summary["host_batch_s"] = time.perf_counter() - t0
    shapes = _layer_shapes(model)
    out(f"model: {arch.conv_layer_type} conv {arch.conv_layer_dimensions}, "
        f"compute {arch.compute_dtype}; requests: {batches} batches x "
        f"{graphs} graphs x {points} points (bucket "
        f"{loader[0].max_nodes}); host set-up "
        f"{summary['host_batch_s']:.2f} s")

    # -- kernels against their plain versions --------------------------------
    tiling = loader[0].flat_tiling()
    with torch.no_grad():
        fwd_rows = check_fwd_kernel(tiling, shapes, seed, reps, out)
        bwd_rows, seg_rows = check_bwd_kernels(tiling, shapes, seed, reps,
                                               out)

    # -- the serving path: Predictor over the requests -----------------------
    predictor = Predictor(model, loader, verbose=False)
    for c in _counters():
        c.launches = 0
    predictions, _, _, _ = predictor.predict()
    serve_launches = [c.launches for c in _counters()]
    expected = [len(shapes) * batches if on_card else 0, 0, 0]
    out(f"launches on the serving path: dense_fwd_v4, dense_bwd_v4, "
        f"segment_sum_csr {serve_launches} (expected {expected})")
    if serve_launches != expected:
        raise AssertionError(f"serving launched {serve_launches}, expected "
                             f"{expected}")
    probs = predictions["class_probability_prediction"]
    boxes = predictions["bounding_box_predictions"]
    n_cls = arch.classification_head_layer_dimensions[-1]
    n_box = arch.regression_head_layer_dimensions[-1]
    if len(probs) != graphs * batches:
        raise AssertionError(f"{len(probs)} graphs served, expected "
                             f"{graphs * batches}")
    for p, b in zip(probs, boxes):
        if p.shape != (points, n_cls) or b.shape != (points, n_box) \
                or not (np.isfinite(p).all() and np.isfinite(b).all()):
            raise AssertionError("served outputs have the wrong shape or are "
                                 "not finite")
        if not np.allclose(p.sum(axis=1), 1.0, atol=1e-4):
            raise AssertionError("class probabilities do not sum to 1")

    # -- the same model on the plain path, same device -----------------------
    worst_p = worst_b = 0.0
    for i, batch in enumerate(loader):
        with _plain_kernels():
            ref_p, ref_b = predictor.forward(batch)
        mask = batch.node_mask.reshape(-1)
        got_p = torch.from_numpy(np.concatenate(probs[i * graphs:(i + 1) * graphs]))
        got_b = torch.from_numpy(np.concatenate(boxes[i * graphs:(i + 1) * graphs]))
        ref_p = ref_p[mask].double().cpu()
        ref_b = ref_b[mask].double().cpu()
        worst_p = max(worst_p, float((got_p - ref_p).abs().max()))
        worst_b = max(worst_b, float(((got_b - ref_b).abs()
                                      / (1.0 + ref_b.abs())).max()))
    out(f"model vs plain path: max |dprob| {worst_p:.3e} (atol "
        f"{MODEL_ATOL_PROB}), max |dbox|/(1+|box|) {worst_b:.3e} (rtol "
        f"{MODEL_RTOL_BOX})")
    if worst_p > MODEL_ATOL_PROB or worst_b > MODEL_RTOL_BOX:
        raise AssertionError("the kernel path disagrees with the plain path")
    summary["model_max_dprob"], summary["model_max_dbox_rel"] = worst_p, worst_b

    # -- serving time --------------------------------------------------------
    edges = [b.host_valid_edges for b in loader]
    if on_card:
        per_batch = []
        for batch in loader:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            predictor.forward(batch)
            torch.cuda.synchronize()
            per_batch.append(time.perf_counter() - t0)
        per_batch_ms = [s * 1e3 for s in per_batch]
        summary["batch_ms"] = per_batch_ms
        summary["edges_per_s"] = sum(edges) / sum(per_batch)
        out(f"serving: per-batch forward+softmax ms {per_batch_ms}; "
            f"{summary['edges_per_s']} edges/s ({edges[0]} valid edges per "
            f"batch) on {summary['card']}")

    # -- the training path: Trainer, kernels then plain, same device ---------
    train = _train_phase(dev, arch, loader[0], seed, train_steps, len(shapes),
                         out)
    summary.update(train)
    if on_card:
        out(f"training: ms per step {train['train_step_ms']} (first: "
            f"warm-up); {train['train_edges_per_s']} train edges/s "
            f"({edges[0]} valid edges per step); plain path ms per step "
            f"{train['train_plain_step_ms']}; peak device memory "
            f"{train['peak_mem_gb']:.2f} GB on {summary['card']}")

    def entry(name, source, replaces, launches, rows, library):
        return {
            "name": name, "route": "cuda",
            "source": f"radargnn_tpu_torch/csrc/{source}",
            "replaces": f"radargnn_tpu/ops/pallas_kernels.py:{replaces}",
            "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            # times and bound: one step's launches, one per layer shape
            "ms": sum(r["ms"] for r in rows) if on_card else None,
            "plain_ms": sum(r["plain_ms"] for r in rows) if on_card else None,
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": ("operations" if sum(r["flops"] for r in rows)
                         / PEAK_BF16_FLOPS >= sum(r["bytes"] for r in rows)
                         / PEAK_HBM_BYTES else "bytes"),
            "library_ms": (sum(r["library_ms"] for r in rows)
                           if library and on_card else None),
        }

    fwd_l, bwd_l, seg_l = train["train_launches"]
    # no single PyTorch call computes gather + GEMM + segmented max, nor
    # the routed backward; the landing's is index_add_
    summary["kernels"] = [
        entry("dense_fwd_v4", "dense_fwd_v4.cu", 2279, fwd_l, fwd_rows,
              False),
        entry("dense_bwd_v4", "dense_bwd_v4.cu", 2340, bwd_l, bwd_rows,
              False),
        entry("segment_sum_csr", "segment_sum_csr.cu", 854, seg_l, seg_rows,
              True),
    ]
    summary["per_shape"] = fwd_rows
    summary["per_shape_bwd"] = bwd_rows
    summary["per_shape_segsum"] = seg_rows
    out(json.dumps({"card": summary.get("card"), "per_shape": fwd_rows,
                    "per_shape_bwd": bwd_rows,
                    "per_shape_segsum": seg_rows}))
    return summary


def _train_phase(dev, arch, batch, seed: int, steps: int, layers: int,
                 out: Callable) -> Dict:
    """Three training runs of `steps` steps from the same seeded weights on
    `batch`, with the configuration's deterministic setting: the kernel
    path (launches counted, steps timed), the kernel path again (the same
    bits), and the plain path (losses within TRAIN_LOSS_RTOL)."""
    on_card = torch.device(dev).type == "cuda"
    cfg = UserConfigurationReader.read_config_file(FLAGSHIP_CONFIG)
    train_cfg = UserConfigurationReader.get_config_object("TRAINING", cfg)
    was_deterministic = torch.are_deterministic_algorithms_enabled()
    try:
        set_seeds(train_cfg.seed, train_cfg.deterministic)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        kern = flagship_training(dev, arch, batch, seed, steps)
        peak = torch.cuda.max_memory_allocated() / 1e9 if on_card else 0.0
        again = flagship_training(dev, arch, batch, seed, steps)
        plain = flagship_training(dev, arch, batch, seed, steps, plain=True)
    finally:
        torch.use_deterministic_algorithms(was_deterministic)
    expected = [layers * steps if on_card else 0] * 3
    out(f"launches on the training path ({steps} steps): dense_fwd_v4, "
        f"dense_bwd_v4, segment_sum_csr {kern['launches']} (expected "
        f"{expected}); deterministic algorithms {train_cfg.deterministic}")
    if kern["launches"] != expected:
        raise AssertionError(f"training launched {kern['launches']}, "
                             f"expected {expected}")
    losses = np.asarray(kern["losses"])
    if not np.isfinite(losses).all():
        raise AssertionError(f"training losses not finite: {losses}")
    ref = np.asarray(plain["losses"])
    worst = float((np.abs(losses - ref)
                   / np.maximum(np.abs(ref), 1e-12)).max())
    out(f"training losses (total, cls, bb) per step: kernels "
        f"{kern['losses']}; plain {plain['losses']}; max relative "
        f"difference {worst:.3e} (rtol {TRAIN_LOSS_RTOL}); second kernel "
        f"run bitwise equal: {again['losses'] == kern['losses']}")
    if worst > TRAIN_LOSS_RTOL:
        raise AssertionError("the training kernel path disagrees with the "
                             "plain path")
    if again["losses"] != kern["losses"]:
        raise AssertionError("two training runs from the same seed differ")
    grads = _grad_agreement(kern["grads"], plain["grads"])
    out(f"first step's gradients, kernel vs plain path: cosine "
        f"{grads['cosine']:.6f}, norm ratio {grads['norm_ratio']:.6f}, "
        "relative difference by layer " + ", ".join(
            f"{n} {v:.2e}" for n, v in grads["rel_diff"].items()))
    timed = kern["seconds"][1:]
    return {
        "train_launches": kern["launches"], "train_losses": kern["losses"],
        "train_plain_losses": plain["losses"],
        "train_max_rel_loss_diff": worst, "train_grad_agreement": grads,
        "train_step_ms": [t * 1e3 for t in kern["seconds"]],
        "train_plain_step_ms": [t * 1e3 for t in plain["seconds"]],
        "train_edges_per_s": (batch.host_valid_edges * len(timed)
                              / sum(timed)) if timed else None,
        "peak_mem_gb": peak,
    }
