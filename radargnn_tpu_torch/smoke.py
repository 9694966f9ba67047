"""End-to-end check of the port on one device: the kernels against their
plain versions, and the flagship DetNet's serving path (`Predictor`) and
training path (`Trainer`) on three paths: the kNN graph under the dense
tiling, the radius graph under the windowed tiling, and the kNN graph
under the CSR tiling (`fused_tiling: "csr"`).

`run(device)` is what `chip_smoke.py` calls on the card; the CPU tests call
it at a tiny size, where the wrappers take their plain versions, nothing is
built and no time is measured. Every phase raises on failure; nothing is
caught and continued.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import time
from contextlib import ExitStack
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple
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
from radargnn_tpu_torch.ops import csr_aggregate as ca
from radargnn_tpu_torch.ops import dense_aggregate as da
from radargnn_tpu_torch.ops import segment_sum as ss
from radargnn_tpu_torch.ops import windowed_aggregate as wa
from radargnn_tpu_torch.postprocess.inference import Predictor
from radargnn_tpu_torch.train.trainer import Trainer, set_seeds

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP_CONFIG = os.path.join(_REPO, "configurations",
                               "configuration_radarscenes.yml")
KERNEL_SOURCES = ("dense_fwd_v4.cu", "dense_bwd_v4.cu", "segment_sum_csr.cu",
                  "windowed_fwd_v3.cu", "windowed_bwd_v3.cu", "csr_fwd_v2.cu",
                  "csr_bwd_v2.cu")
# the kernels' names, in the order of `_counters()`
KERNEL_NAMES = ("dense_fwd_v4", "dense_bwd_v4", "segment_sum_csr",
                "windowed_fwd_v3", "windowed_bwd_v3", "csr_fwd_v2",
                "csr_bwd_v2")

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12          # outside the tensor cores
PEAK_HBM_BYTES = 3.35e12

# the radius graph's cut-off at 2816 points per frame: mean in-degree
# 20.0-22.8 on the synthetic frames, the flagship kNN graph's k = 20; at
# other point counts it scales as 1/sqrt(points), which keeps the degree
RADIUS_R = 3.0
RADIUS_POINTS = 2816

# forward kernel vs plain version on the same bf16 inputs: both sum exact
# bf16 products in float32 and differ only in summation order
KERNEL_RTOL = 1e-3
# the CSR forward (e_t, W_e float32, v2's contract): read 1.5e-7 to 2.8e-7
# on both layouts (H100, PERF.md); e_t or W_e rounded to bf16 would move it
# by about 1e-3, so the limit sits far below that
CSR_FWD_RTOL = 1e-5
# backward kernels and landing vs plain versions, on dyadic inputs
# (multiples of 1/8, check_bwd_kernels) where every product and sum is
# exact in float32 in any order: they must agree up to the bf16 rounding
# of equal values, so any error is a fault; the limit is the float32 one
# (the windowed and CSR backward are held to exact agreement)
BWD_RTOL = 1e-3
# the CSR backward's edge-side outputs d_e and dW_e with a real-valued
# float32 g (dyadic operands, so op and routing stay exact): only the
# float32 summation order differs, relative to each output's own scale; a
# d_op rounded to bf16 on that side would move them by about 2e-3
CSR_EDGE_GRAD_RTOL = 1e-5
# whole model, kernel path vs plain path on the card: a different f32
# summation order can move an activation across a bf16 rounding boundary
# (one bf16 ulp, 2^-8 relative) in the next layer's matmul inputs, and five
# layers with BatchNorm carry that on; the outputs must still agree to
MODEL_ATOL_PROB = 2e-2
MODEL_RTOL_BOX = 2e-2
# training, kernel path vs plain path, compared at every step on the
# kernel run's own parameters (the plain path on the same weights and
# batch): the losses differ by the bf16 rounding flips above, at most
# 4.4e-5 (kNN), 1.7e-4 (radius), 6.7e-5 (CSR) over the flagship's four
# steps (H100, PERF.md), so the limit is TRAIN_LOSS_RTOL; the
# backward rounds d_op and d_xg to bf16 (the TPU kernel's grad dtype), so
# the gradients differ by bf16 noise that grows back through the layers:
# cosine 0.99885 or more over all parameters at the flagship size (three
# paths, four steps), 0.9954 on the card test's 2 x 512 points, where the
# noise is larger; per parameter holding at least 1e-3 of the gradient's
# norm 0.9969 or more at the flagship size, 0.973 at 2 x 512 points (a
# bias whose gradient is a sum with heavy cancellation). The limits keep
# about twice the small size's distance from 1; a missing or garbage
# gradient sits near 0. A free-running plain run drifts from the kernel
# run by chaos, not by the kernels: Adam's early steps are nearly sign
# steps, so re-associating the CSR products moves the 4-step losses by up
# to 2.2e-2 on the plain path alone (`trace_train --drift`, PERF.md); the
# gap is reported, not held to a limit.
TRAIN_LOSS_RTOL = 1e-3
TRAIN_GRAD_COS = 0.99
TRAIN_PARAM_COS = 0.95
TRAIN_PARAM_FLOOR = 1e-3


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


def _bound(flops: float, nbytes: float, peak_flops: float,
           f32_flops: float = 0.0) -> Dict:
    """The larger of the operations' time (`flops` at `peak_flops`, plus
    `f32_flops` at the float32 peak outside the tensor cores) and the
    bytes' time at the HBM rate."""
    t_ops = flops / peak_flops + f32_flops / PEAK_F32_FLOPS
    t_bytes = nbytes / PEAK_HBM_BYTES
    return {"flops": flops + f32_flops, "bytes": nbytes,
            "ops_ms": t_ops * 1e3, "bytes_ms": t_bytes * 1e3,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def _kernel_bound(d: int, de: int, h: int, n: int, e_pad: int, t: int,
                  valid_slots: int, index_arrays: int = 1,
                  edge_f32: bool = False) -> Dict:
    """Least time the card could take for one fused forward at these
    shapes: the larger of the products the function needs over the peak
    rate of their type, and the bytes (each input read once, the output
    written once) over the HBM rate. The function needs x @ W_s once per
    node, since x[s] @ W_s = (x @ W_s)[s], and e @ W_e once per valid slot,
    in bf16, or in float32 with `edge_f32` (the CSR kernels: e_t and W_e
    float32). `index_arrays` int32 arrays per slot and per tile describe
    the layout (dense: senders_local, tile_win; windowed: also receivers
    and tile_blocks; CSR: senders and receivers, tile_blocks). `slot_flops`
    is the work of the current kernels, which run both products per valid
    slot as the TPU kernels do; it is not the bound."""
    eb = 4 if edge_f32 else 2
    nbytes = (n * d * 2 + d * h * 2 + e_pad * de * eb + de * h * eb
              + index_arrays * (e_pad + t) * 4 + 3 * n * h * 4)
    edge = 2.0 * valid_slots * de * h
    row = _bound(2.0 * n * d * h + (0.0 if edge_f32 else edge), nbytes,
                 PEAK_BF16_FLOPS, edge if edge_f32 else 0.0)
    row["slot_flops"] = 2.0 * valid_slots * (d + de) * h
    return row


def _bwd_bound(d: int, de: int, h: int, n: int, e_pad: int, t: int,
               valid_slots: int, index_arrays: int = 1,
               edge_f32: bool = False) -> Dict:
    """Least time the card could take for one fused backward (the TPU
    kernel's function, d_x landed): d_x = (the sum of d_op over a sender's
    slots) @ W_s^T and dW_s = x^T @ (the same sums) once per node, d_e and
    dW_e once per valid slot (in float32 with `edge_f32`); the bytes of x,
    e_t, the layout's index arrays, inner, g, the weights (in) and d_x,
    d_e, dW_s, dW_e (out)."""
    eb = 4 if edge_f32 else 2
    nbytes = (n * d * 2 + e_pad * de * eb + index_arrays * (e_pad + t) * 4
              + 2 * n * h * 4 + d * h * 2 + de * h * eb + n * d * 4
              + e_pad * de * eb + (d + de) * h * 4)
    edge = 4.0 * valid_slots * de * h
    return _bound(4.0 * n * d * h + (0.0 if edge_f32 else edge), nbytes,
                  PEAK_BF16_FLOPS, edge if edge_f32 else 0.0)


def _segsum_bound(d: int, rows_bf16: int, rows_f32: int, n: int) -> Dict:
    """Least time for one landing: each listed row read once (bf16 slot
    rows, f32 overflow rows), its index, the row offsets, the f32 output
    written once; one f32 add per element read."""
    rows = rows_bf16 + rows_f32
    nbytes = (rows_bf16 * d * 2 + rows_f32 * d * 4 + rows * 4 + (n + 1) * 4
              + n * d * 4)
    return _bound(float(rows * d), nbytes, PEAK_F32_FLOPS)


class _Kernels(NamedTuple):
    """How a batch's fused layout calls its forward and backward kernels
    and their plain versions, on the operands alone."""

    fwd_name: str
    bwd_name: str
    fwd: Callable           # (x, w_s, e_t, w_e, inner_o, offset, emit_inner)
    fwd_plain: Callable
    bwd: Callable           # (x, w_s, e_t, w_e, inner_z, g_pass)
    bwd_plain: Callable
    index_arrays: int
    edge_f32: bool          # e_t and w_e float32 (the CSR kernels)


def _kernels_of(tiling) -> _Kernels:
    """The layout's kernels: dense, windowed, or CSR (no window, no
    overflow: its forward takes no inner_o, which the callers pass as
    None)."""
    if tiling.win is None:
        kw = dict(node_block=tiling.node_block, edge_tile=tiling.edge_tile)
        layout = (tiling.senders, tiling.receivers, tiling.blocks)
        names, mod, fns = ("csr_fwd_v2", "csr_bwd_v2"), ca, (
            "csr_fwd", "csr_fwd_plain", "csr_bwd", "csr_bwd_plain")
    elif tiling.dense is not None:
        r_tile, k = tiling.dense
        kw = dict(r_tile=r_tile, k=k, node_block=tiling.node_block)
        layout = tiling.win[:2]
        names, mod, fns = ("dense_fwd_v4", "dense_bwd_v4"), da, (
            "dense_fwd", "dense_fwd_plain", "dense_bwd", "dense_bwd_plain")
    else:
        sloc, t_win = tiling.win[:2]
        kw = dict(node_block=tiling.node_block, edge_tile=tiling.edge_tile)
        layout = (tiling.receivers, sloc, t_win, tiling.blocks)
        names, mod, fns = ("windowed_fwd_v3", "windowed_bwd_v3"), wa, (
            "windowed_fwd", "windowed_fwd_plain", "windowed_bwd",
            "windowed_bwd_plain")

    def fwd(name):
        fn = getattr(mod, name)

        def call(x, w_s, e_t, w_e, inner_o, offset, emit_inner=False):
            node = (offset,) if inner_o is None else (inner_o, offset)
            return fn(x, w_s, e_t, w_e, *layout, *node,
                      emit_inner=emit_inner, **kw)
        return call

    def bwd(name):
        fn = getattr(mod, name)
        return lambda x, w_s, e_t, w_e, inner_z, g_pass: \
            fn(x, w_s, e_t, w_e, *layout, inner_z, g_pass, **kw)

    csr = tiling.win is None
    return _Kernels(*names, fwd(fns[0]), fwd(fns[1]), bwd(fns[2]),
                    bwd(fns[3]), 2 if csr else len(layout) // 2, csr)


def _valid_slots(tiling) -> int:
    """Slots holding an edge: a sender (dense, windowed) or a receiver
    (CSR)."""
    flags = tiling.receivers if tiling.win is None else tiling.win[0]
    return int((flags >= 0).sum())


def check_fwd_kernel(tiling, layer_shapes: List[tuple], seed: int, reps: int,
                     out: Callable = print) -> List[Dict]:
    """Holds the batch's forward kernel (dense, windowed or CSR) against its
    plain version at each (d_in, d_e, H) of the model, on the batch's real
    layout and seeded inputs (bf16; e_t and W_e float32 for the CSR
    kernel), in serving and in VJP mode (`inner`); times both on the card.
    Raises beyond KERNEL_RTOL (CSR: CSR_FWD_RTOL)."""
    kern = _kernels_of(tiling)
    dev = tiling.receivers.device
    cd = da.gather_dtype(dev)
    ed = torch.float32 if kern.edge_f32 else cd
    e_pad, t = tiling.receivers.shape[0], tiling.blocks.shape[0]
    n = tiling.landing.row_ptr.shape[0] - 1
    valid_slots = _valid_slots(tiling)
    on_card = dev.type == "cuda"
    gen = torch.Generator().manual_seed(seed)
    results = []
    for d, de, h in layer_shapes:
        def rand(*shape, scale=1.0):
            return (torch.randn(shape, generator=gen) * scale).to(dev)

        x = rand(n, d).to(cd)
        w_s = rand(d, h, scale=d ** -0.5).to(cd)
        e_t = rand(e_pad, de).to(ed)
        w_e = rand(de, h, scale=de ** -0.5).to(ed)
        inner_o = None
        if tiling.win is not None:
            ovf_s, ovf_r = tiling.win[3:5]
            inner_o = da.dense_overflow_inner(
                x, w_s, rand(ovf_s.shape[0], de).to(cd), w_e, ovf_s, ovf_r,
                n)
        offset = rand(n, h)
        args = (x, w_s, e_t, w_e, inner_o, offset)
        got = kern.fwd(*args)
        ref = kern.fwd_plain(*args)
        got_vjp, inner = kern.fwd(*args, emit_inner=True)
        _, ref_inner = kern.fwd_plain(*args, emit_inner=True)
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
        row.update(_kernel_bound(d, de, h, n, e_pad, t, valid_slots,
                                 kern.index_arrays, kern.edge_f32))
        if on_card:
            row["ms"] = _time_ms(lambda: kern.fwd(*args), reps)
            row["plain_ms"] = _time_ms(lambda: kern.fwd_plain(*args), reps)
        else:
            row["ms"] = row["plain_ms"] = None
        out(f"kernel {kern.fwd_name} d_in={d} H={h}: max_abs_err={err:.3e} "
            f"max_rel_err={row['max_rel_err']:.3e} ms={row['ms']} "
            f"plain_ms={row['plain_ms']} bound_ms={row['bound_ms']:.4f} "
            f"({row['bound_by']}; {row['flops'] / 1e9:.2f} GFLOP needed, "
            f"{row['slot_flops'] / 1e9:.2f} GFLOP as the kernel does it)")
        limit = CSR_FWD_RTOL if kern.edge_f32 else KERNEL_RTOL
        if row["max_rel_err"] > limit:
            raise AssertionError(
                f"{kern.fwd_name} disagrees with its plain version at "
                f"d_in={d}, H={h}: max_rel_err {row['max_rel_err']:.3e} > "
                f"{limit}")
        results.append(row)
    return results


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> Tuple[float, float]:
    err = float((got.float() - want.float()).abs().max())
    return err, err / max(float(want.float().abs().max()), 1.0)


def _own_scale_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| over the largest |want| (not floored at 1)."""
    err = float((got.float() - want.float()).abs().max())
    return err / max(float(want.float().abs().max()), 1e-30)


def check_bwd_kernels(tiling, layer_shapes: List[tuple], seed: int,
                      reps: int, out: Callable = print, exact: bool = False
                      ) -> Tuple[List[Dict], List[Dict]]:
    """Holds the batch's backward kernels (dense B2, windowed B4 or CSR B5)
    and the landing (B3) against their plain versions at each (d_in, d_e, H) of
    the model, on the batch's real layout and landing; checks that two
    runs give the same bits; times kernels, plain versions and, for the
    landing, `index_add_` (the library call) on the card.

    The inputs are seeded dyadic bf16 values (x, e, g in multiples of 1/2
    or 1/8, the weights in multiples of 1/4), so every product and every
    sum the kernels and the plain versions form is exact in float32 in any
    order. Routing then compares equal operands in both, exact ties are
    frequent (every tied slot takes the full g), and the two must agree up
    to bf16 rounding of equal values (BWD_RTOL; with `exact`, bitwise).
    With real-valued inputs a slot at the routing tolerance's edge may
    route in one version only; the training comparison covers those
    inputs end to end. Dyadic g is exact in bf16, so it cannot tell a
    float32 d_op from a rounded one: the CSR kernels, whose edge side
    stays float32, also run the same operands with a real-valued g, and
    d_e and dW_e must then agree to CSR_EDGE_GRAD_RTOL of their scale."""
    kern = _kernels_of(tiling)
    order, row_ptr = tiling.landing
    dev = tiling.receivers.device
    cd = da.gather_dtype(dev)
    ed = torch.float32 if kern.edge_f32 else cd
    e_pad, t = tiling.receivers.shape[0], tiling.blocks.shape[0]
    n = row_ptr.shape[0] - 1
    valid_slots = _valid_slots(tiling)
    ovf = tiling.win is not None      # the CSR layout has no overflow
    ovf_s, ovf_r = tiling.win[3:5] if ovf else (None, None)
    valid_ovf = int((ovf_r >= 0).sum()) if ovf else 0
    on_card = dev.type == "cuda"
    gen = torch.Generator().manual_seed(seed)
    # sender of every landed row, and a dummy segment n for the rest, for
    # the library call
    rows_total = e_pad + (ovf_s.shape[0] if ovf else 0)
    seg = torch.full((rows_total,), n, dtype=torch.long, device=dev)
    seg[order.long()] = ss.segment_ids(row_ptr)

    def dyadic(*shape, lo=-2, hi=2, step=0.5):
        return (torch.randint(lo, hi + 1, shape, generator=gen)
                * step).to(dev)

    bwd_rows, seg_rows = [], []
    for d, de, h in layer_shapes:
        x = dyadic(n, d).to(cd)
        w_s = dyadic(d, h, step=0.25).to(cd)
        e_t = dyadic(e_pad, de).to(ed)
        w_e = dyadic(de, h, step=0.25).to(ed)
        inner_o = da.dense_overflow_inner(
            x, w_s, dyadic(ovf_s.shape[0], de).to(cd), w_e, ovf_s, ovf_r,
            n) if ovf else None
        _, inner = kern.fwd(x, w_s, e_t, w_e, inner_o,
                            torch.zeros((n, h), device=dev), emit_inner=True)
        has = inner > da._NEG / 2
        args = (x, w_s, e_t, w_e, torch.where(has, inner, 0.0),
                torch.where(has, dyadic(n, h, lo=-8, hi=8, step=0.125), 0.0))
        got = kern.bwd(*args)
        ref = kern.bwd_plain(*args)
        again = kern.bwd(*args)
        if kern.edge_f32:
            # the same exact op and routing with a real-valued g: the
            # edge side's d_op stays float32 (CSR_EDGE_GRAD_RTOL)
            args_g = args[:5] + (torch.where(
                has, torch.randn((n, h), generator=gen).to(dev), 0.0),)
            real_g = [_own_scale_err(u, v) for u, v in
                      zip(kern.bwd(*args_g), kern.bwd_plain(*args_g))]
        # the landing: slot rows (d_xg, the gather dtype) then overflow rows
        d_xo = dyadic(ovf_s.shape[0], d, lo=-8, hi=8, step=0.125) \
            if ovf else None
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
                raise AssertionError(f"{kern.bwd_name} {name} at d_in={d}: "
                                     "shape, dtype or not finite")
        errs = [_rel_err(u, v) for u, v in zip(got, ref)]
        seg_err = _rel_err(d_x, d_x_ref)
        same = all(torch.equal(u, v) for u, v in
                   zip((d_x, *got[1:]), (d_x_again, *again[1:])))
        b2 = {"d_in": d, "d_e": de, "h": h,
              "max_abs_err": max(e[0] for e in errs),
              "max_rel_err": max(e[1] for e in errs), "bitwise_repeat": same,
              **_bwd_bound(d, de, h, n, e_pad, t, valid_slots,
                           kern.index_arrays, kern.edge_f32)}
        if kern.edge_f32:
            b2["real_g_rel_err"] = dict(zip(names, real_g))
        b3 = {"d": d, "rows": valid_slots + valid_ovf,
              "max_abs_err": seg_err[0], "max_rel_err": seg_err[1],
              **_segsum_bound(d, valid_slots, valid_ovf, n)}
        if on_card:
            b2["ms"] = _time_ms(lambda: kern.bwd(*args), reps)
            b2["plain_ms"] = _time_ms(lambda: kern.bwd_plain(*args), reps)
            b3["ms"] = _time_ms(lambda: ss.segment_sum_csr(*land), reps)
            b3["plain_ms"] = _time_ms(
                lambda: ss.segment_sum_csr_plain(*land), reps)
            src = got[0].float() if d_xo is None \
                else torch.cat([got[0].float(), d_xo])
            acc = torch.zeros((n + 1, d), dtype=torch.float32, device=dev)
            b3["library_ms"] = _time_ms(
                lambda: acc.index_add_(0, seg, src), reps)
        else:
            b2["ms"] = b2["plain_ms"] = None
            b3["ms"] = b3["plain_ms"] = b3["library_ms"] = None
        out(f"kernel {kern.bwd_name} d_in={d} H={h}: errors (abs, rel) "
            + ", ".join(f"{nm} {e[0]:.3e} {e[1]:.3e}"
                        for nm, e in zip(names, errs))
            + f"; bitwise repeat {same}; ms={b2['ms']} plain_ms="
            f"{b2['plain_ms']} bound_ms={b2['bound_ms']:.4f} "
            f"({b2['bound_by']}; {b2['flops'] / 1e9:.2f} GFLOP, "
            f"{b2['bytes'] / 1e6:.1f} MB)")
        if kern.edge_f32:
            out(f"kernel {kern.bwd_name} d_in={d} H={h}, real-valued g: "
                "errors relative to each output's scale " + ", ".join(
                    f"{nm} {e:.3e}" for nm, e in zip(names, real_g))
                + f" (d_e, dW_e held to {CSR_EDGE_GRAD_RTOL})")
        out(f"kernel segment_sum_csr d={d} rows={b3['rows']}: max_abs_err="
            f"{seg_err[0]:.3e} ms={b3['ms']} plain_ms={b3['plain_ms']} "
            f"index_add_ ms={b3['library_ms']} bound_ms="
            f"{b3['bound_ms']:.4f} ({b3['bound_by']})")
        limit = 0.0 if exact else BWD_RTOL
        if b2["max_rel_err"] > limit or seg_err[1] > BWD_RTOL:
            raise AssertionError(
                f"backward kernels disagree with their plain versions at "
                f"d_in={d}, H={h}: {errs}, landing {seg_err}")
        if kern.edge_f32 and max(real_g[1], real_g[3]) > CSR_EDGE_GRAD_RTOL:
            raise AssertionError(
                f"{kern.bwd_name}'s d_e or dW_e disagrees with its plain "
                f"version at d_in={d}, H={h} with a real-valued g: {real_g}")
        if not same:
            raise AssertionError(f"two backward runs differ at d_in={d}")
        bwd_rows.append(b2)
        seg_rows.append(b3)
    return bwd_rows, seg_rows


def _layer_shapes(model: DetNet) -> List[tuple]:
    """(d_in, d_e, H) of each conv layer's fused aggregation."""
    shapes = []
    for i in range(model.num_conv):
        conv = getattr(model, f"conv_{i}")
        shapes.append((conv.in_channels, conv.edge_feat_dim,
                       conv.pre_mlp.lin_0.weight.shape[0]))
    return shapes


def flagship_configs(graph: str = "knn", points: int = RADIUS_POINTS,
                     tiling: Optional[str] = None):
    """The flagship configuration's MODEL_ARCHITECTURE and GRAPH_CONSTRUCTION
    sections, its background index, and the fields replaced in code:
    `graph` "knn" reads the YAML verbatim (the dense tiling); "radius"
    replaces exactly three fields, graph_construction_algorithm "radius",
    graph_construction_settings {"k": 20, "r": RADIUS_R·sqrt(2816/points)}
    and fused_run_cap None (the windowed tiling with contiguous runs: under
    the YAML's run cap 4 the spread tiler sends 9-11 % of the radius
    graph's edges to overflow, past the 5 % budget). `tiling` "csr" also
    replaces fused_tiling with "csr" (the CSR path)."""
    cfg = UserConfigurationReader.read_config_file(FLAGSHIP_CONFIG)
    arch = UserConfigurationReader.get_config_object("MODEL_ARCHITECTURE", cfg)
    graph_cfg = UserConfigurationReader.get_config_object(
        "GRAPH_CONSTRUCTION", cfg)
    bg_index = UserConfigurationReader.get_config_object(
        "POSTPROCESSING", cfg).bg_index
    replaced: Dict = {}
    if graph == "radius":
        replaced = {"graph_construction_algorithm": "radius",
                    "graph_construction_settings": {
                        "k": 20,
                        "r": RADIUS_R * math.sqrt(RADIUS_POINTS / points)},
                    "fused_run_cap": None}
        graph_cfg = dataclasses.replace(graph_cfg, **{
            k: replaced[k] for k in ("graph_construction_algorithm",
                                     "graph_construction_settings")})
        arch = dataclasses.replace(arch, fused_run_cap=None)
    elif graph != "knn":
        raise ValueError(f"unknown graph {graph!r}: 'knn' or 'radius'")
    if tiling == "csr":
        replaced["fused_tiling"] = "csr"
        arch = dataclasses.replace(arch, fused_tiling="csr")
    elif tiling is not None:
        raise ValueError(f"unknown tiling {tiling!r}: None or 'csr'")
    return arch, graph_cfg, bg_index, replaced


def _round_up(v: int, align: int) -> int:
    return -(-v // align) * align


def flagship_serving(dev: DeviceLike, points: int, graphs: int,
                     batches: int, seed: int, graph: str = "knn",
                     tiling: Optional[str] = None
                     ) -> Tuple[object, DetNet, List]:
    """The serving path's set-up: the configuration's DetNet with seeded
    weights on `dev`, and `batches` requests of `graphs` synthetic frames of
    `points` points each, built as `graph` ("knn" or "radius",
    `flagship_configs`) and stacked under the tiling the configuration
    selects for it (dense for kNN, windowed for radius; CSR for either with
    `tiling` "csr"). Returns (arch config, model, loader).

    kNN requests take consecutive frames of `seed`; radius request i takes
    the frames of seed + i, so that request 0 is the radius batch the
    configuration was sized on (304,352 edges at 5 x 2816 points, seed 0).
    Consecutive frames of seed 0 would not do: the tenth has 6,005 window
    overflow edges, past the 3,584 that the 5 % budget allows (the JAX
    package's tiler refuses it as well)."""
    arch, graph_cfg, bg_index, _ = flagship_configs(graph, points, tiling)
    tiling_spec = fused_csr_tiling(arch, k=graph_cfg.k)
    if tiling_spec is None:
        raise AssertionError("the configuration does not select the fused "
                             "path")
    kw = dict(num_points=points, graph_config=graph_cfg, bg_index=bg_index)
    if graph == "knn":
        samples = make_samples(num_frames=graphs * batches, seed=seed, **kw)
        # the dense tiling aligns nodes to its receiver tiles too
        align = int(np.lcm(tiling_spec["node_block"], tiling_spec["r_tile"])) \
            if isinstance(tiling_spec, dict) else tiling_spec[0]
        max_nodes = _round_up(points, align)
        max_edges = max_nodes * graph_cfg.k
    else:
        samples = [s for i in range(batches) for s in make_samples(
            num_frames=graphs, seed=seed + i, **kw)]
        # the JAX loader's bucket: nodes aligned to the node block, edges
        # to 64
        max_nodes = _round_up(points, tiling_spec[0])
        max_edges = _round_up(max(s.num_edges for s in samples), 64)
    loader = [stack_samples(samples[i * graphs:(i + 1) * graphs],
                            max_nodes=max_nodes, bg_index=bg_index,
                            max_edges=max_edges, csr_tiling=tiling_spec,
                            device=dev)
              for i in range(batches)]
    return arch, DetNet(arch, device=dev, seed=seed), loader


def knn_windowed_tiling(dev: DeviceLike, points: int, graphs: int,
                        seed: int):
    """The flagship kNN batch under the windowed tiling with the YAML's
    run cap 4 (spread runs): the second layout the windowed kernels are
    held to."""
    arch, graph_cfg, bg_index, _ = flagship_configs("knn")
    spec = fused_csr_tiling(dataclasses.replace(arch,
                                                fused_tiling="windowed"))
    samples = make_samples(num_frames=graphs, num_points=points, seed=seed,
                           graph_config=graph_cfg, bg_index=bg_index)
    max_nodes = _round_up(points, spec[0])
    return stack_samples(samples, max_nodes=max_nodes, bg_index=bg_index,
                         max_edges=max_nodes * graph_cfg.k, csr_tiling=spec,
                         device=dev).flat_tiling()


def radius_csr_tiling(dev: DeviceLike, points: int, graphs: int,
                      seed: int):
    """The flagship radius batch (`flagship_serving`'s first radius
    request) under the CSR tiling: the second layout the CSR kernels are
    held to, with hub receivers whose runs span tiles."""
    _, _, loader = flagship_serving(dev, points, graphs, 1, seed,
                                    graph="radius", tiling="csr")
    return loader[0]


def _counters():
    """The launch counters of the kernels, in the order of KERNEL_NAMES."""
    return (da.dense_fwd_cuda, da.dense_bwd_cuda, ss.segment_sum_csr_cuda,
            wa.windowed_fwd_cuda, wa.windowed_bwd_cuda, ca.csr_fwd_cuda,
            ca.csr_bwd_cuda)


def _plain_kernels() -> ExitStack:
    """Patches every kernel wrapper to its plain version (the plain path
    on the same device)."""
    stack = ExitStack()
    for mod, name in ((da, "dense_fwd"), (da, "dense_bwd"),
                      (ss, "segment_sum_csr"), (wa, "windowed_fwd"),
                      (wa, "windowed_bwd"), (ca, "csr_fwd"),
                      (ca, "csr_bwd")):
        stack.enter_context(mock.patch.object(mod, name,
                                              getattr(mod, f"{name}_plain")))
    return stack


def _plain_reference(trainer, batch) -> Tuple[List[float], Dict]:
    """The plain path's losses and gradients at the trainer's current
    parameters, on `batch`, without a step: the model's buffers (running
    statistics) are put back and the optimizer is not touched, so the
    trainer's next step runs as it would have."""
    model = trainer.model
    buffers = [b.clone() for b in model.buffers()]
    model.zero_grad(set_to_none=True)
    with _plain_kernels():
        total, l_cls, l_bb = trainer.losses(batch)
        total.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    with torch.no_grad():
        for b, saved in zip(model.buffers(), buffers):
            b.copy_(saved)
    return [float(v.detach()) for v in (total, l_cls, l_bb)], grads


def _step_agreement(losses: List[float], grads: Dict[str, torch.Tensor],
                    ref_losses: List[float],
                    ref_grads: Dict[str, torch.Tensor]) -> Dict:
    """One step's kernel-path losses and gradients against the plain path's
    at the same parameters: the largest relative loss difference, the
    cosine over all parameters, and the smallest cosine of a parameter
    holding at least TRAIN_PARAM_FLOOR of the gradient's norm."""
    loss_rel = max(abs(a - b) / max(abs(b), 1e-12)
                   for a, b in zip(losses, ref_losses))
    a = torch.cat([grads[n].flatten() for n in ref_grads]).double()
    b = torch.cat([g.flatten() for g in ref_grads.values()]).double()
    total = float(b.norm())
    worst, worst_name = 1.0, ""
    for n, g in ref_grads.items():
        if float(g.norm()) >= TRAIN_PARAM_FLOOR * total:
            cos = float(torch.nn.functional.cosine_similarity(
                grads[n].double().flatten(), g.double().flatten(), dim=0))
            if cos < worst:
                worst, worst_name = cos, n
    return {"loss_rel": loss_rel,
            "cosine": float(torch.nn.functional.cosine_similarity(
                a, b, dim=0)),
            "min_param_cosine": worst, "min_param": worst_name}


def flagship_training(dev: DeviceLike, arch, batch, seed: int, steps: int,
                      plain: bool = False, reference: bool = False) -> Dict:
    """The training path: a `Trainer` from the flagship configuration's
    TRAINING section on a DetNet of `arch` with weights from `seed`,
    `steps` train steps on `batch`. Returns the per-step (total, cls, bb)
    losses, the per-step wall seconds (each step ends when its losses reach
    the host), the first step's gradients by parameter name, and the kernel
    launches of the run (the counters are set to 0 just before it and read
    just after). With `reference`, before each step the plain path's losses
    and gradients at that step's parameters (`_plain_reference`, untimed)
    are held against the step's own, in `agreement`."""
    cfg = UserConfigurationReader.read_config_file(FLAGSHIP_CONFIG)
    train_cfg = UserConfigurationReader.get_config_object("TRAINING", cfg)
    trainer = Trainer(train_cfg, DetNet(arch, device=dev, seed=seed))
    on_card = torch.device(dev).type == "cuda"
    losses, seconds, grads, agreement = [], [], {}, []
    with _plain_kernels() if plain else ExitStack():
        for c in _counters():
            c.launches = 0
        for step in range(steps):
            ref = _plain_reference(trainer, batch) if reference else None
            if on_card:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append([float(v) for v in trainer.train_step(batch)])
            seconds.append(time.perf_counter() - t0)
            step_grads = {n: p.grad.detach().clone()
                          for n, p in trainer.model.named_parameters()}
            if step == 0:
                grads = step_grads
            if ref is not None:
                agreement.append(_step_agreement(losses[-1], step_grads,
                                                 *ref))
        launches = [c.launches for c in _counters()]
    return {"losses": losses, "seconds": seconds, "grads": grads,
            "launches": launches, "agreement": agreement}


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


def _expect(launches: Dict[str, int], on_card: bool) -> List[int]:
    """The launch counts a run must show, in the order of KERNEL_NAMES
    (all 0 off the card, where the wrappers take their plain versions)."""
    return [launches.get(name, 0) if on_card else 0 for name in KERNEL_NAMES]


def _build(out: Callable) -> float:
    """Builds every kernel (one nvcc each, all started together) and loads
    them; returns the seconds it took."""
    t0 = time.perf_counter()
    built = nvcc_all(KERNEL_SOURCES)
    for load in (da.load_fwd_kernel, da.load_bwd_kernel, ss.load_kernel,
                 wa.load_fwd_kernel, wa.load_bwd_kernel, ca.load_fwd_kernel,
                 ca.load_bwd_kernel):
        load()
    seconds = time.perf_counter() - t0
    out(f"build: {seconds:.2f} s, {len(built)} sources compiled in parallel")
    for src, (path, log) in built.items():
        out(f"{src} -> {path}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                out(f"  {line.strip()}")
    return seconds


def _serve_phase(dev, arch, model, loader, graphs: int, points: int,
                 expected: List[int], label: str, out: Callable) -> Dict:
    """Serves every request of `loader` through `Predictor` (launches
    counted: the counters are set to 0 just before and read just after),
    checks the outputs, compares them with the same model on the plain
    path, and times the requests on the card."""
    on_card = dev.type == "cuda"
    predictor = Predictor(model, loader, verbose=False)
    for c in _counters():
        c.launches = 0
    predictions, _, _, _ = predictor.predict()
    launches = [c.launches for c in _counters()]
    out(f"launches on the {label} serving path ({', '.join(KERNEL_NAMES)}): "
        f"{launches} (expected {expected})")
    if launches != expected:
        raise AssertionError(f"{label} serving launched {launches}, "
                             f"expected {expected}")
    probs = predictions["class_probability_prediction"]
    boxes = predictions["bounding_box_predictions"]
    n_cls = arch.classification_head_layer_dimensions[-1]
    n_box = arch.regression_head_layer_dimensions[-1]
    if len(probs) != graphs * len(loader):
        raise AssertionError(f"{len(probs)} graphs served, expected "
                             f"{graphs * len(loader)}")
    for p, b in zip(probs, boxes):
        if p.shape != (points, n_cls) or b.shape != (points, n_box) \
                or not (np.isfinite(p).all() and np.isfinite(b).all()):
            raise AssertionError("served outputs have the wrong shape or are "
                                 "not finite")
        if not np.allclose(p.sum(axis=1), 1.0, atol=1e-4):
            raise AssertionError("class probabilities do not sum to 1")

    # the same model on the plain path, same device
    worst_p = worst_b = 0.0
    for i, batch in enumerate(loader):
        with _plain_kernels():
            ref_p, ref_b = predictor.forward(batch)
        mask = batch.node_mask.reshape(-1)
        got_p = torch.from_numpy(np.concatenate(
            probs[i * graphs:(i + 1) * graphs]))
        got_b = torch.from_numpy(np.concatenate(
            boxes[i * graphs:(i + 1) * graphs]))
        ref_p = ref_p[mask].double().cpu()
        ref_b = ref_b[mask].double().cpu()
        worst_p = max(worst_p, float((got_p - ref_p).abs().max()))
        worst_b = max(worst_b, float(((got_b - ref_b).abs()
                                      / (1.0 + ref_b.abs())).max()))
    out(f"{label} model vs plain path: max |dprob| {worst_p:.3e} (atol "
        f"{MODEL_ATOL_PROB}), max |dbox|/(1+|box|) {worst_b:.3e} (rtol "
        f"{MODEL_RTOL_BOX})")
    if worst_p > MODEL_ATOL_PROB or worst_b > MODEL_RTOL_BOX:
        raise AssertionError(f"the {label} kernel path disagrees with the "
                             "plain path")
    res = {"serve_launches": launches, "model_max_dprob": worst_p,
           "model_max_dbox_rel": worst_b}
    edges = [b.host_valid_edges for b in loader]
    if on_card:
        per_batch = []
        for batch in loader:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            predictor.forward(batch)
            torch.cuda.synchronize()
            per_batch.append(time.perf_counter() - t0)
        res["batch_ms"] = [s * 1e3 for s in per_batch]
        res["edges_per_s"] = sum(edges) / sum(per_batch)
        out(f"{label} serving: per-batch forward+softmax ms "
            f"{res['batch_ms']}; {res['edges_per_s']} edges/s "
            f"({edges} valid edges per batch)")
    return res


def _train_phase(dev, arch, batch, seed: int, steps: int,
                 expected: List[int], label: str, out: Callable) -> Dict:
    """Three training runs of `steps` steps from the same seeded weights on
    `batch`, with the configuration's deterministic setting: the kernel
    path (launches counted, steps timed); the kernel path again (the same
    bits), with the plain path's losses and gradients at each step's
    parameters (losses within TRAIN_LOSS_RTOL, gradient cosines at least
    TRAIN_GRAD_COS overall and TRAIN_PARAM_COS per parameter); and the
    plain path on its own (its step time, and its drift from the kernel
    run, reported)."""
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
        again = flagship_training(dev, arch, batch, seed, steps,
                                  reference=True)
        plain = flagship_training(dev, arch, batch, seed, steps, plain=True)
    finally:
        torch.use_deterministic_algorithms(was_deterministic)
    out(f"launches on the {label} training path ({steps} steps; "
        f"{', '.join(KERNEL_NAMES)}): {kern['launches']} (expected "
        f"{expected}); deterministic algorithms {train_cfg.deterministic}")
    if kern["launches"] != expected:
        raise AssertionError(f"{label} training launched {kern['launches']}, "
                             f"expected {expected}")
    losses = np.asarray(kern["losses"])
    if not np.isfinite(losses).all():
        raise AssertionError(f"training losses not finite: {losses}")
    ref = np.asarray(plain["losses"])
    drift = float((np.abs(losses - ref)
                   / np.maximum(np.abs(ref), 1e-12)).max())
    steps_agree = again["agreement"]
    worst = max(a["loss_rel"] for a in steps_agree)
    out(f"{label} training losses (total, cls, bb) per step: kernels "
        f"{kern['losses']}; second kernel run bitwise equal: "
        f"{again['losses'] == kern['losses']}; against the plain path at "
        "each step's parameters: " + "; ".join(
            f"step {i}: loss {a['loss_rel']:.2e}, cosine {a['cosine']:.6f}, "
            f"min parameter cosine {a['min_param_cosine']:.6f} "
            f"({a['min_param']})" for i, a in enumerate(steps_agree))
        + f" (limits: loss {TRAIN_LOSS_RTOL}, cosine {TRAIN_GRAD_COS}, "
        f"parameter {TRAIN_PARAM_COS}); the plain path on its own "
        f"{plain['losses']}, drift {drift:.3e} (reported)")
    grads = _grad_agreement(kern["grads"], plain["grads"])
    out(f"{label} first step's gradients, kernel vs plain path: cosine "
        f"{grads['cosine']:.6f}, norm ratio {grads['norm_ratio']:.6f}, "
        "relative difference by layer " + ", ".join(
            f"{n} {v:.2e}" for n, v in grads["rel_diff"].items()))
    if again["losses"] != kern["losses"]:
        raise AssertionError("two training runs from the same seed differ")
    for i, a in enumerate(steps_agree):
        if a["loss_rel"] > TRAIN_LOSS_RTOL or a["cosine"] < TRAIN_GRAD_COS \
                or a["min_param_cosine"] < TRAIN_PARAM_COS:
            raise AssertionError(
                f"the {label} training kernel path disagrees with the plain "
                f"path at step {i}: {a}")
    timed = kern["seconds"][1:]
    res = {
        "train_launches": kern["launches"], "train_losses": kern["losses"],
        "train_plain_losses": plain["losses"],
        "train_max_rel_loss_diff": worst, "train_step_agreement": steps_agree,
        "train_free_running_drift": drift, "train_grad_agreement": grads,
        "train_step_ms": [t * 1e3 for t in kern["seconds"]],
        "train_plain_step_ms": [t * 1e3 for t in plain["seconds"]],
        "train_edges_per_s": (batch.host_valid_edges * len(timed)
                              / sum(timed)) if timed else None,
        "peak_mem_gb": peak,
    }
    if on_card:
        out(f"{label} training: ms per step {res['train_step_ms']} (first: "
            f"warm-up); {res['train_edges_per_s']} train edges/s "
            f"({batch.host_valid_edges} valid edges per step); plain path "
            f"ms per step {res['train_plain_step_ms']}; peak device memory "
            f"{peak:.2f} GB")
    return res


def _tiling_report(batch) -> Dict:
    """Per frame of a tiled batch: valid edges and the largest in-degree,
    the tiles per graph, and where the tiling has an overflow list (the
    windowed one) the overflow edges against the budget."""
    recv = batch.receivers.cpu().numpy()
    mask = batch.edge_mask.cpu().numpy()
    deg = [int(np.bincount(r[m], minlength=1).max()) if m.any() else 0
           for r, m in zip(recv, mask)]
    report = {"valid_edges": mask.sum(axis=1).tolist(), "max_in_degree": deg,
              "tiles_per_graph": batch.tile_blocks.shape[1]}
    if batch.ovf_receivers is not None:
        report.update(
            overflow_edges=(batch.ovf_receivers >= 0).sum(dim=1).tolist(),
            overflow_budget=batch.ovf_receivers.shape[1])
    return report


def run(device: DeviceLike = None, points: int = 2816, graphs: int = 5,
        batches: int = 3, seed: int = 0, reps: int = 20,
        train_steps: int = 4, out: Callable = print) -> Dict:
    """Runs every phase; returns the summary (also printed as JSON lines).

    `points`/`graphs` size the synthetic frames (the serving and training
    batch is 5 graphs of 2816 points); `batches` is the number of requests
    served, `train_steps` the train steps of each training run (the first
    is a warm-up, the rest are timed). The kNN path (dense tiling) runs
    first, then the radius path (windowed tiling), then the kNN graph
    under the CSR tiling."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    summary: Dict = {"device": str(dev)}
    if on_card:
        summary["card"] = card_description()
        out(f"card: {summary['card']}")
        summary["build_s"] = _build(out)

    # -- the kNN graph, dense tiling ----------------------------------------
    t0 = time.perf_counter()
    arch, model, loader = flagship_serving(dev, points, graphs, batches, seed)
    summary["host_batch_s"] = time.perf_counter() - t0
    shapes = _layer_shapes(model)
    layers = len(shapes)
    out(f"model: {arch.conv_layer_type} conv {arch.conv_layer_dimensions}, "
        f"compute {arch.compute_dtype}; kNN requests: {batches} batches x "
        f"{graphs} graphs x {points} points (bucket "
        f"{loader[0].max_nodes}); host set-up "
        f"{summary['host_batch_s']:.2f} s")
    tiling = loader[0].flat_tiling()
    with torch.no_grad():
        fwd_rows = check_fwd_kernel(tiling, shapes, seed, reps, out)
        bwd_rows, seg_rows = check_bwd_kernels(tiling, shapes, seed, reps,
                                               out)
    summary.update(_serve_phase(
        dev, arch, model, loader, graphs, points,
        _expect({"dense_fwd_v4": layers * batches}, on_card), "kNN", out))
    summary.update(_train_phase(
        dev, arch, loader[0], seed, train_steps,
        _expect({n: layers * train_steps for n in KERNEL_NAMES[:3]},
                on_card), "kNN", out))

    # -- the radius graph, windowed tiling ----------------------------------
    t0 = time.perf_counter()
    r_arch, _, _, replaced = flagship_configs("radius", points)
    _, r_model, r_loader = flagship_serving(dev, points, graphs, batches,
                                            seed, graph="radius")
    radius: Dict = {"replaced": replaced,
                    "host_batch_s": time.perf_counter() - t0,
                    "tiling": _tiling_report(r_loader[0])}
    out(f"radius path: the flagship configuration with {json.dumps(replaced)}"
        f" replaced; windowed tiling {fused_csr_tiling(r_arch)}; requests: "
        f"{batches} batches x {graphs} graphs x {points} points (bucket "
        f"{r_loader[0].max_nodes} nodes, {r_loader[0].max_edges} edges); "
        f"first batch {json.dumps(radius['tiling'])}; host set-up "
        f"{radius['host_batch_s']:.2f} s")
    r_tiling = r_loader[0].flat_tiling()
    knn_tiling = knn_windowed_tiling(dev, points, graphs, seed)
    out(f"kNN batch under the windowed tiling (run cap 4): "
        f"{int((knn_tiling.win[4] >= 0).sum())} overflow edges")
    with torch.no_grad():
        radius["per_shape_fwd"] = check_fwd_kernel(r_tiling, shapes, seed,
                                                   reps, out)
        radius["per_shape_bwd"], radius["per_shape_segsum"] = \
            check_bwd_kernels(r_tiling, shapes, seed, reps, out, exact=True)
        radius["knn_per_shape_fwd"] = check_fwd_kernel(knn_tiling, shapes,
                                                       seed, reps, out)
        radius["knn_per_shape_bwd"], radius["knn_per_shape_segsum"] = \
            check_bwd_kernels(knn_tiling, shapes, seed, reps, out,
                              exact=True)
    radius.update(_serve_phase(
        dev, r_arch, r_model, r_loader, graphs, points,
        _expect({"windowed_fwd_v3": layers * batches}, on_card), "radius",
        out))
    radius.update(_train_phase(
        dev, r_arch, r_loader[0], seed, train_steps,
        _expect({n: layers * train_steps for n in KERNEL_NAMES[2:5]},
                on_card), "radius", out))
    summary["radius"] = radius

    # -- the kNN graph, CSR tiling ------------------------------------------
    t0 = time.perf_counter()
    c_arch, _, _, c_replaced = flagship_configs("knn", points, tiling="csr")
    _, c_model, c_loader = flagship_serving(dev, points, graphs, batches,
                                            seed, tiling="csr")
    csr: Dict = {"replaced": c_replaced,
                 "host_batch_s": time.perf_counter() - t0,
                 "tiling": _tiling_report(c_loader[0])}
    rc_batch = radius_csr_tiling(dev, points, graphs, seed)
    csr["radius_tiling"] = _tiling_report(rc_batch)
    out(f"CSR path: the flagship configuration with {json.dumps(c_replaced)}"
        f" replaced; CSR tiling {fused_csr_tiling(c_arch)}; requests: "
        f"{batches} batches x {graphs} graphs x {points} points (bucket "
        f"{c_loader[0].max_nodes} nodes, {c_loader[0].max_edges} edges); "
        f"first batch {json.dumps(csr['tiling'])}; the radius batch under "
        f"the CSR tiling {json.dumps(csr['radius_tiling'])}; host set-up "
        f"{csr['host_batch_s']:.2f} s")
    c_tiling = c_loader[0].flat_tiling()
    rc_tiling = rc_batch.flat_tiling()
    with torch.no_grad():
        csr["per_shape_fwd"] = check_fwd_kernel(c_tiling, shapes, seed, reps,
                                                out)
        csr["per_shape_bwd"], csr["per_shape_segsum"] = check_bwd_kernels(
            c_tiling, shapes, seed, reps, out, exact=True)
        csr["radius_per_shape_fwd"] = check_fwd_kernel(rc_tiling, shapes,
                                                       seed, reps, out)
        csr["radius_per_shape_bwd"], csr["radius_per_shape_segsum"] = \
            check_bwd_kernels(rc_tiling, shapes, seed, reps, out, exact=True)
    csr.update(_serve_phase(
        dev, c_arch, c_model, c_loader, graphs, points,
        _expect({"csr_fwd_v2": layers * batches}, on_card), "CSR", out))
    csr.update(_train_phase(
        dev, c_arch, c_loader[0], seed, train_steps,
        _expect({n: layers * train_steps for n in ("segment_sum_csr",
                                                   "csr_fwd_v2",
                                                   "csr_bwd_v2")},
                on_card), "CSR", out))
    summary["csr"] = csr

    def entry(name, source, replaces, launches, rows, checked, library):
        return {
            "name": name, "route": "cuda",
            "source": f"radargnn_tpu_torch/csrc/{source}",
            "replaces": f"radargnn_tpu/ops/pallas_kernels.py:{replaces}",
            "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in checked),
            # times and bound: one step's launches, one per layer shape
            "ms": sum(r["ms"] for r in rows) if on_card else None,
            "plain_ms": sum(r["plain_ms"] for r in rows) if on_card else None,
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": ("operations" if sum(r["ops_ms"] for r in rows)
                         >= sum(r["bytes_ms"] for r in rows) else "bytes"),
            "library_ms": (sum(r["library_ms"] for r in rows)
                           if library and on_card else None),
        }

    dense_l, radius_l = summary["train_launches"], radius["train_launches"]
    csr_l = csr["train_launches"]
    r_fwd, r_bwd = radius["per_shape_fwd"], radius["per_shape_bwd"]
    c_fwd, c_bwd = csr["per_shape_fwd"], csr["per_shape_bwd"]
    segs = seg_rows + radius["per_shape_segsum"] \
        + radius["knn_per_shape_segsum"] + csr["per_shape_segsum"] \
        + csr["radius_per_shape_segsum"]
    # launches: the training runs of each path (B3 lands d_x on all three);
    # no single PyTorch call computes gather + GEMM + segmented max, nor the
    # routed backward; the landing's is index_add_
    summary["kernels"] = [
        entry("dense_fwd_v4", "dense_fwd_v4.cu", 2279, dense_l[0], fwd_rows,
              fwd_rows, False),
        entry("dense_bwd_v4", "dense_bwd_v4.cu", 2340, dense_l[1], bwd_rows,
              bwd_rows, False),
        entry("segment_sum_csr", "segment_sum_csr.cu", 854,
              dense_l[2] + radius_l[2] + csr_l[2], seg_rows, segs, True),
        entry("windowed_fwd_v3", "windowed_fwd_v3.cu", 1275, radius_l[3],
              r_fwd, r_fwd + radius["knn_per_shape_fwd"], False),
        entry("windowed_bwd_v3", "windowed_bwd_v3.cu", 1387, radius_l[4],
              r_bwd, r_bwd + radius["knn_per_shape_bwd"], False),
        entry("csr_fwd_v2", "csr_fwd_v2.cu", 943, csr_l[5], c_fwd,
              c_fwd + csr["radius_per_shape_fwd"], False),
        entry("csr_bwd_v2", "csr_bwd_v2.cu", 1030, csr_l[6], c_bwd,
              c_bwd + csr["radius_per_shape_bwd"], False),
    ]
    summary["per_shape"] = fwd_rows
    summary["per_shape_bwd"] = bwd_rows
    summary["per_shape_segsum"] = seg_rows
    out(json.dumps({"card": summary.get("card"), "per_shape": fwd_rows,
                    "per_shape_bwd": bwd_rows,
                    "per_shape_segsum": seg_rows,
                    "radius": {k: v for k, v in radius.items()
                               if k.startswith(("per_shape", "knn_per",
                                                "tiling"))},
                    "csr": {k: v for k, v in csr.items()
                            if k.startswith(("per_shape", "radius_per",
                                             "tiling", "radius_tiling"))}}))
    return summary
