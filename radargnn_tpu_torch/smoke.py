"""End-to-end check of the port on one device: the kernels against their
plain versions, and the flagship DetNet's serving path (`Predictor`) and
training path (`Trainer`) on three paths: the kNN graph under the dense
tiling, the radius graph under the windowed tiling, and the kNN graph
under the CSR tiling (`fused_tiling: "csr"`). A fourth phase holds the
four kernels that no model path runs (fused linear, message segment-max,
the v1 hoisted forward and backward) against their plain versions at the
flagship's widths and drives their entry points, `benchmarks.kernel_check`
and `benchmarks.kernel_bench`. A fifth runs the evaluation stage
(`postprocess`: NMS, the mAP engine, the evaluator) on the served kNN
requests and on oracle predictions, against the same chain on the CPU; a
sixth runs the port's bench (`benchmarks.bench`) in child processes; a
seventh runs the command-line pipeline (`cli.main`: create_dataset from
raw RadarScenes sequences it writes and reads with the port's own HDF5
code, `data.hdf5`, train, evaluate) under the flagship
YAML, with each stage's launches counted, then the evaluate CLI as a
child process, and the model folder evaluated on the CPU against the
card. An eighth runs the same pipeline under the nuScenes YAML, on
nuScenes-format tables and multisweep radar sweeps it writes, the same
way, then the nuScenes e2e (`benchmarks.nuscenes_e2e`) as a child process,
and oracle predictions through the card's and the CPU's NMS and
NuscenesEvaluator. A ninth (`smoke_variants.variants_phase`) holds B1's and
B4's bf16 routing test, B4's bf16 landing, B1 and B2 at dense receiver
tiles of 8 and 24 and B3 on the dense overflow rows (`ovf_ssum`) to their
plain versions, trains the flagship under `fused_bf16_max` (dense,
windowed, CSR; windowed also with the three variant knobs) and
`ovf_ssum`, trains it with a pre-MLP of two layers and the mean and add
aggregations against the CPU, runs the convergence and preprocessing tools
as child processes, and saves and restores a training state through the
orbax backend (the port's own OCDBT, zarr and zstd code), resumes a fresh
trainer from it to the uninterrupted trainer's next losses bit for bit,
and reads the JAX package's committed orbax checkpoint. A tenth (`smoke_parallel.parallel_phase`) trains across ranks:
two gloo ranks on the card run halo x dense and halo x windowed on a
{"model": 2} mesh against the single card, then the scaling tool, the
multi-rank dry run and the train CLI under torchrun as child processes.

`run(device)` is what `chip_smoke.py` calls on the card; the CPU tests call
it at a tiny size, where the wrappers take their plain versions, nothing is
built and no time is measured, and rehearse the seventh to tenth phases
each in a test of its own. Every phase raises on failure; nothing is
caught and continued.
"""

from __future__ import annotations

import dataclasses
import functools
import glob
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from contextlib import ExitStack
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple
from unittest import mock

import numpy as np
import torch

from radargnn_tpu_torch import witness as reassociated
from radargnn_tpu_torch.benchmarks import kernel_bench, kernel_check, \
    linear_bench
from radargnn_tpu_torch.benchmarks.kernel_bench import time_ms as _time_ms
from radargnn_tpu_torch.build import nvcc_all
from radargnn_tpu_torch.configs import (
    RadarScenesSplitConfiguration, UserConfigurationReader,
)
from radargnn_tpu_torch.data import hdf5
from radargnn_tpu_torch.data.radarscenes.dataset_creation import (
    RadarScenesGraphDataset,
)
from radargnn_tpu_torch.data.radarscenes.reader import SENSOR_MOUNTING
from radargnn_tpu_torch.data.synthetic import make_samples
from radargnn_tpu_torch.device import DeviceLike, resolve_device
from radargnn_tpu_torch.graph.batch import stack_samples
from radargnn_tpu_torch.models.detnet import DetNet
from radargnn_tpu_torch.models.layers import fused_csr_tiling
from radargnn_tpu_torch.models.mlp import matmul_f32
from radargnn_tpu_torch.ops import csr_aggregate as ca
from radargnn_tpu_torch.ops import dense_aggregate as da
from radargnn_tpu_torch.ops import fused_linear as fl
from radargnn_tpu_torch.ops import hoisted_aggregate as ha
from radargnn_tpu_torch.ops import message_segment_max as msm
from radargnn_tpu_torch.ops import segment_sum as ss
from radargnn_tpu_torch.ops import windowed_aggregate as wa
from radargnn_tpu_torch.ops.windowed_tiles import prepare_csr_tiles
from radargnn_tpu_torch.postprocess import (
    ObjectDetectionMetrics, Postprocessor, PredictionExtractor,
    RadarscenesEvaluator,
)
from radargnn_tpu_torch.postprocess.inference import Predictor
from radargnn_tpu_torch.postprocess.mean_ap import MeanAveragePrecision
from radargnn_tpu_torch.postprocess.nms import nms_indices, rotated_iou_matrix
from radargnn_tpu_torch.train.losses import adapt_bb_orientation_angle
from radargnn_tpu_torch.train.trainer import Trainer, set_seeds

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP_CONFIG = os.path.join(_REPO, "configurations",
                               "configuration_radarscenes.yml")
KERNEL_SOURCES = ("dense_fwd_v4.cu", "dense_bwd_v4.cu", "segment_sum_csr.cu",
                  "windowed_fwd_v3.cu", "windowed_bwd_v3.cu", "csr_fwd_v2.cu",
                  "csr_bwd_v2.cu", "fused_linear.cu", "msg_segmax.cu",
                  "hoisted_fwd_v1.cu", "hoisted_bwd_v1.cu")
# the kernels' names, in the order of `_counters()`; dense_proj_v4 (the
# node projection, csrc/dense_fwd_v4.cu) is B1's first launch; the last
# three count the gather-max launches of B1 and B4 that set their bits by
# the bf16 test (`fused_bf16_max`) and those of B4 that land its maxima in
# bf16 (RADARGNN_FUSED_BF16_LANDING), which their own counts include
KERNEL_NAMES = ("dense_fwd_v4", "dense_bwd_v4", "segment_sum_csr",
                "windowed_fwd_v3", "windowed_bwd_v3", "csr_fwd_v2",
                "csr_bwd_v2", "fused_linear", "msg_segmax", "hoisted_fwd_v1",
                "hoisted_bwd_v1", "dense_proj_v4", "dense_fwd_v4_bf16_max",
                "windowed_fwd_v3_bf16_max", "windowed_fwd_v3_bf16_landing")

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12          # outside the tensor cores
PEAK_TF32_FLOPS = 495e12
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
# the dense forward's routing bits on real-valued inputs, kernel against
# plain version: their operands differ by float32 summation order, so a
# slot whose gap to its receiver's max lies within a rounding of the 1e-5
# tolerance may flip (of order 1e-7 of the bits for operands of unit
# scale); on dyadic inputs they must agree exactly
BITS_FLIP_FRAC = 1e-6
# the CSR backward's edge-side outputs d_e and dW_e with a real-valued
# float32 g (dyadic operands, so op and routing stay exact): only the
# float32 summation order differs, relative to each output's own scale; a
# d_op rounded to bf16 on that side would move them by about 2e-3
CSR_EDGE_GRAD_RTOL = 1e-5
# the float32 kernels of the fourth phase (fused linear, message
# segment-max, the v1 forward; the v1 backward's d_e, dW_e and d_b with a
# real-valued g) against their plain versions, relative to the output's
# scale: float32 accuracy on both sides (float32 products, or three TF32
# products on the tensor cores, 3xTF32), in other orders (an fma chain
# against a matmul), about 1e-6; a bf16 or TF32 product would be about
# 1e-3
F32_RTOL = 1e-5
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
# steps, so the witness (the plain path with its float32 sums
# re-associated, `radargnn_tpu_torch.witness`) drifts from the plain path
# as far as the kernel path does. Over 24 weight seeds and four steps the
# median gaps are 8.6e-3 / 4.0e-2 / 7.1e-3 for the witness against 9.1e-3
# / 4.2e-2 / 8.6e-3 for the kernels, kNN / radius / CSR (H100,
# `trace_train --drift 24`, PERF.md); both gaps are reported, not held to
# a limit.
TRAIN_LOSS_RTOL = 1e-3
TRAIN_GRAD_COS = 0.99
TRAIN_PARAM_COS = 0.95
TRAIN_PARAM_FLOOR = 1e-3
# the evaluation phase, card against CPU on the same inputs: the rotated
# IoU is float32 on both, its sin/cos and clip products in other orders
# (about 1e-7 apart); mAP and F1 are host numbers downstream of the same
# kept boxes and the same IoUs up to that noise
EVAL_IOU_ATOL = 1e-5
EVAL_METRIC_ATOL = 1e-6
# the bench phase: the port's bench as child processes, a short run of
# each (tiling, mode) cell a later benchmark can take
BENCH_CASES = (("dense", "train"), ("dense", "infer"), ("csr", "train"),
               ("windowed", "train"))
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "card"}


def card_description() -> str:
    """The card's name and power limit, as nvidia-smi reports them (a card
    set below 700 W runs slower under load)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


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
    is the work of a kernel that runs both products per valid slot, as the
    TPU kernels do; it is not the bound."""
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


class _CsrKernels(NamedTuple):
    """How the CSR layout calls its forward and backward kernels (B5) and
    their plain versions, on the operands alone."""

    fwd: Callable           # (x, w_s, e_t, w_e, offset, emit_inner, y_s)
    fwd_plain: Callable
    bwd: Callable           # (x, w_s, e_t, w_e, inner_z, g_pass)
    bwd_plain: Callable


def _csr_kernels(tiling) -> _CsrKernels:
    """The CSR layout's kernels (no window, no overflow)."""
    kw = dict(node_block=tiling.node_block, edge_tile=tiling.edge_tile)
    layout = (tiling.senders, tiling.receivers, tiling.blocks)

    def fwd(fn):
        return lambda x, w_s, e_t, w_e, offset, emit_inner=False, y_s=None: \
            fn(x, w_s, e_t, w_e, *layout, offset, emit_inner=emit_inner,
               y_s=y_s, **kw)

    def bwd(fn):
        return lambda x, w_s, e_t, w_e, inner_z, g_pass: fn(
            x, w_s, e_t, w_e, *layout, inner_z, g_pass, **kw)

    # the kernels' sender sums (dW_s) walk the batch's landing
    return _CsrKernels(fwd(ca.csr_fwd), fwd(ca.csr_fwd_plain),
                       bwd(functools.partial(ca.csr_bwd,
                                             landing=tiling.landing)),
                       bwd(ca.csr_bwd_plain))


def _valid_slots(tiling) -> int:
    """Slots holding an edge: a sender (dense, windowed) or a receiver
    (CSR)."""
    flags = tiling.receivers if tiling.win is None else tiling.win[0]
    return int((flags >= 0).sum())


def _csr_gather_bound(de: int, h: int, n: int, e_pad: int, t: int,
                      valid_slots: int, vjp: bool = False) -> Dict:
    """Least time for the CSR gather-max given y_s: e @ W_e once per valid
    slot in float32 and a max per element; y_s, e_t and W_e (float32),
    the senders, receivers and tile_blocks, and offset read once, out
    written once (in VJP mode also inner)."""
    nbytes = (n * h * 4 + e_pad * de * 4 + de * h * 4 + 2 * (e_pad + t) * 4
              + 2 * n * h * 4 + (n * h * 4 if vjp else 0))
    return _bound(0.0, nbytes, PEAK_BF16_FLOPS,
                  2.0 * valid_slots * de * h + valid_slots * h)


def check_fwd_kernel(tiling, layer_shapes: List[tuple], seed: int, reps: int,
                     out: Callable = print) -> List[Dict]:
    """Holds the CSR forward (B5: the node projection `dense_proj_v4`, then
    the gather-max of `csr_fwd_v2`) against its plain version at each
    (d_in, d_e, H) of the model, on the batch's real layout and seeded
    inputs (x, W_s bf16; e_t and W_e float32, v2's contract), in serving
    mode and, given the projection (as the training path gives it), in VJP
    mode (`inner`). Times on the card the whole forward (`ms`, the
    function's bound `bound_ms`), the gather-max alone given y_s in
    serving and VJP mode (`gather`, beside its own bound) and the plain
    version. Raises beyond CSR_FWD_RTOL."""
    kern = _csr_kernels(tiling)
    dev = tiling.receivers.device
    cd = da.gather_dtype(dev)
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
        e_t = rand(e_pad, de)
        w_e = rand(de, h, scale=de ** -0.5)
        offset = rand(n, h)
        args = (x, w_s, e_t, w_e, offset)
        y_s = da.dense_proj(x, w_s)
        got = kern.fwd(*args)
        ref = kern.fwd_plain(*args)
        got_vjp, inner = kern.fwd(*args, emit_inner=True, y_s=y_s)
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
        gather = dict(de=de, h=h, n=n, e_pad=e_pad, t=t,
                      valid_slots=valid_slots)
        row = {"d_in": d, "d_e": de, "h": h, "max_abs_err": err,
               "max_rel_err": err / scale,
               "gather": _csr_gather_bound(**gather),
               "gather_vjp": _csr_gather_bound(vjp=True, **gather)}
        row.update(_kernel_bound(d, de, h, n, e_pad, t, valid_slots, 2,
                                 True))
        _timed(row, on_card, reps, ms=lambda: kern.fwd(*args),
               plain_ms=lambda: kern.fwd_plain(*args))
        _timed(row["gather"], on_card, reps,
               ms=lambda: kern.fwd(*args, y_s=y_s))
        _timed(row["gather_vjp"], on_card, reps,
               ms=lambda: kern.fwd(*args, emit_inner=True, y_s=y_s))
        gb, gv = row["gather"], row["gather_vjp"]
        out(f"kernel csr_fwd_v2 d_in={d} H={h}: max_abs_err={err:.3e} "
            f"max_rel_err={row['max_rel_err']:.3e} ms={row['ms']} (the "
            f"projection and the gather-max) plain_ms={row['plain_ms']} "
            f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}; "
            f"{row['flops'] / 1e9:.2f} GFLOP); the gather-max given y_s "
            f"ms={gb['ms']} bound_ms={gb['bound_ms']:.4f} ({gb['bound_by']}),"
            f" VJP mode ms={gv['ms']} bound_ms={gv['bound_ms']:.4f}")
        if row["max_rel_err"] > CSR_FWD_RTOL:
            raise AssertionError(
                f"csr_fwd_v2 disagrees with its plain version at d_in={d}, "
                f"H={h}: max_rel_err {row['max_rel_err']:.3e} > "
                f"{CSR_FWD_RTOL}")
        results.append(row)
    return results


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> Tuple[float, float]:
    err = float((got.float() - want.float()).abs().max())
    return err, err / max(float(want.float().abs().max()), 1.0)


def _own_scale_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| over the largest |want| (not floored at 1)."""
    err = float((got.float() - want.float()).abs().max())
    return err / max(float(want.float().abs().max()), 1e-30)


def _dyadic(gen: torch.Generator, dev):
    """Seeded multiples of `step` in [lo * step, hi * step] on `dev`."""
    def dyadic(*shape, lo=-2, hi=2, step=0.5):
        return (torch.randint(lo, hi + 1, shape, generator=gen)
                * step).to(dev)
    return dyadic


def _landing_row(rows, d_xo, order, row_ptr, n: int, reps: int,
                 on_card: bool, width: Optional[int] = None
                 ) -> Tuple[Dict, torch.Tensor]:
    """The landing (B3) of `rows` (slot rows, bf16 or float32) and `d_xo`
    (overflow rows, float32, or None), their first `width` columns (all by
    default), against its plain version: errors, a bitwise repeat, times
    of the kernel, the plain version and `index_add_` (the library call)
    on the card. Then the same landing of seeded real-valued rows of the
    same shapes, in bf16 and in float32 (`d_xo` float32): bitwise the
    float32 sum in listed order (`segment_sum_csr_listed`). Returns (row,
    d_x)."""
    dev = rows.device
    pitch = rows.shape[1]
    d = pitch if width is None else width
    n_rows = rows.shape[0] + (0 if d_xo is None else d_xo.shape[0])
    # sender of every landed row, and a dummy segment n for the rest, for
    # the library call
    seg = torch.full((n_rows,), n, dtype=torch.long, device=dev)
    seg[order.long()] = ss.segment_ids(row_ptr)
    land = (rows, order, row_ptr, d_xo)
    d_x = ss.segment_sum_csr(*land, width=width)
    d_x_ref = ss.segment_sum_csr_plain(*land, width=width)
    same = torch.equal(d_x, ss.segment_sum_csr(*land, width=width))
    err = _rel_err(d_x, d_x_ref)
    gen = torch.Generator(device=dev).manual_seed(n_rows)
    listed = []
    for dtype in (torch.bfloat16, torch.float32):
        real = (torch.randn(rows.shape, generator=gen, device=dev).to(dtype),
                order, row_ptr, None if d_xo is None else torch.randn(
                    d_xo.shape, generator=gen, device=dev))
        listed.append(torch.equal(
            ss.segment_sum_csr(*real, width=width),
            ss.segment_sum_csr_listed(*real, width=width)))
    n_ovf = int((order >= rows.shape[0]).sum())
    row = {"d": d, "pitch": pitch, "rows": int(order.shape[0]),
           "max_abs_err": err[0], "max_rel_err": err[1],
           "bitwise_repeat": same, "bitwise_listed": all(listed),
           **_segsum_bound(d, int(order.shape[0]) - n_ovf, n_ovf, n)}
    if on_card:
        row["ms"] = _time_ms(lambda: ss.segment_sum_csr(*land, width=width),
                             reps)
        row["plain_ms"] = _time_ms(
            lambda: ss.segment_sum_csr_plain(*land, width=width), reps)
        src = rows[:, :d].float() if d_xo is None else torch.cat(
            [rows[:, :d].float(), d_xo[:, :d]])
        acc = torch.zeros((n + 1, d), dtype=torch.float32, device=dev)
        row["library_ms"] = _time_ms(lambda: acc.index_add_(0, seg, src),
                                     reps)
    else:
        row["ms"] = row["plain_ms"] = row["library_ms"] = None
    return row, d_x


def _landing_line(name: str, row: Dict) -> str:
    """One landing row as the smoke prints it."""
    width = "" if row["pitch"] == row["d"] else f" of {row['pitch']}"
    return (f"kernel segment_sum_csr{name} d={row['d']}{width} rows="
            f"{row['rows']}: max_abs_err={row['max_abs_err']:.3e} bitwise "
            f"repeat {row['bitwise_repeat']}, real-valued rows bitwise the "
            f"listed-order sum {row['bitwise_listed']}; ms={row['ms']} "
            f"plain_ms={row['plain_ms']} index_add_ ms={row['library_ms']} "
            f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']})")


def _held_landing(row: Dict, limit: float, where: str) -> None:
    """Raises unless the landing row agrees with its plain version within
    `limit` of its scale, repeats bitwise and gives the listed-order sum
    bit for bit on real-valued rows."""
    if row["max_rel_err"] > limit or not row["bitwise_repeat"] \
            or not row["bitwise_listed"]:
        raise AssertionError(f"the landing (B3) at {where}: {row}")


def check_landing(tiling, layer_shapes: List[tuple], seed: int, reps: int,
                  out: Callable = print) -> List[Dict]:
    """Holds the landing (B3, `segment_sum_csr`) against its plain version
    on a windowed layout's landing: seeded dyadic bf16 slot rows of each
    layer's width d_in (a per-slot d_xg, as the TPU kernel's backward
    forms it) and float32 overflow rows, exact in any order, so the two
    must agree exactly and two runs bitwise, and on real-valued rows
    bitwise the listed-order sum; times it against `index_add_` on the
    card. (The windowed backward sums by sender itself since the
    bits-routed design; the CSR backward lands with B3.)"""
    order, row_ptr = tiling.landing
    dev = order.device
    cd = da.gather_dtype(dev)
    e_pad, n_ovf = tiling.win[0].shape[0], tiling.win[3].shape[0]
    n = row_ptr.shape[0] - 1
    on_card = dev.type == "cuda"
    dyadic = _dyadic(torch.Generator().manual_seed(seed), dev)
    rows = []
    for d, _, _ in layer_shapes:
        row, _ = _landing_row(dyadic(e_pad, d).to(cd),
                              dyadic(n_ovf, d, lo=-8, hi=8, step=0.125),
                              order, row_ptr, n, reps, on_card)
        out(_landing_line("", row))
        _held_landing(row, 0.0, f"the windowed layout, d={d}")
        rows.append(row)
    return rows


def check_bwd_kernels(tiling, layer_shapes: List[tuple], seed: int,
                      reps: int, out: Callable = print, exact: bool = False
                      ) -> Tuple[List[Dict], List[Dict]]:
    """Holds the CSR backward kernels (B5) and the landing (B3) against
    their plain versions at each (d_in, d_e, H) of the model, on the
    batch's real layout and landing; checks that two runs give the same
    bits; times kernels, plain versions and, for the landing,
    `index_add_` (the library call) on the card. The landing runs at both
    of the backward's call sites: d_x (d_xg at d_in) and the sender sums
    of bf16(d_op) at H of its hp columns (dW_s); returns (the backward's
    rows, the landing's: the d_x rows, then the d_op rows).

    The inputs are seeded dyadic values (x, e, g in multiples of 1/2 or
    1/8, the weights in multiples of 1/4), so every product and every sum
    the kernels and the plain versions form is exact in float32 in any
    order. Routing then compares equal operands in both, exact ties are
    frequent (every tied slot takes the full g), and the two must agree up
    to bf16 rounding of equal values (BWD_RTOL; with `exact`, bitwise).
    With real-valued inputs a slot at the routing tolerance's edge may
    route in one version only; the training comparison covers those
    inputs end to end. Dyadic g is exact in bf16, so it cannot tell a
    float32 d_op from a rounded one: the kernels, whose edge side stays
    float32, also run the same operands with a real-valued g, and d_e and
    dW_e must then agree to CSR_EDGE_GRAD_RTOL of their scale."""
    kern = _csr_kernels(tiling)
    order, row_ptr = tiling.landing
    dev = tiling.receivers.device
    cd = da.gather_dtype(dev)
    e_pad, t = tiling.receivers.shape[0], tiling.blocks.shape[0]
    n = row_ptr.shape[0] - 1
    valid_slots = _valid_slots(tiling)
    on_card = dev.type == "cuda"
    gen = torch.Generator().manual_seed(seed)
    dyadic = _dyadic(gen, dev)

    bwd_rows, seg_rows, op_rows = [], [], []
    for d, de, h in layer_shapes:
        x = dyadic(n, d).to(cd)
        w_s = dyadic(d, h, step=0.25).to(cd)
        e_t = dyadic(e_pad, de)
        w_e = dyadic(de, h, step=0.25)
        _, inner = kern.fwd(x, w_s, e_t, w_e,
                            torch.zeros((n, h), device=dev), emit_inner=True)
        has = inner > da._NEG / 2
        args = (x, w_s, e_t, w_e, torch.where(has, inner, 0.0),
                torch.where(has, dyadic(n, h, lo=-8, hi=8, step=0.125), 0.0))
        got = kern.bwd(*args)
        ref = kern.bwd_plain(*args)
        again = kern.bwd(*args)
        # the same exact op and routing with a real-valued g: the edge
        # side's d_op stays float32 (CSR_EDGE_GRAD_RTOL)
        args_g = args[:5] + (torch.where(
            has, torch.randn((n, h), generator=gen).to(dev), 0.0),)
        real_g = [_own_scale_err(u, v) for u, v in
                  zip(kern.bwd(*args_g), kern.bwd_plain(*args_g))]
        # the backward's two landings: the kernel's slot rows (d_xg, the
        # gather dtype) at d_in, and the sender sums of bf16(d_op) (dW_s)
        # at H of its hp columns, on the routed d_op (plain torch: on
        # dyadic inputs the kernel's own, bit for bit)
        b3, d_x = _landing_row(got[0], None, order, row_ptr, n, reps,
                               on_card)
        d_op = ca.routed_d_op(ca.projected_operands(
            x, w_s, e_t, w_e, tiling.senders, tiling.receivers,
            tiling.blocks, n, tiling.node_block, tiling.edge_tile),
            args[4], args[5]).to(cd)
        b3_op, _ = _landing_row(
            torch.nn.functional.pad(d_op, (0, da.col_pad(h) - h)), None,
            order, row_ptr, n, reps, on_card, width=h)
        b3["site"], b3_op["site"] = "d_xg", "d_op"
        d_x_again = ss.segment_sum_csr(again[0], order, row_ptr)
        if on_card:
            torch.cuda.synchronize()
        names = ("d_xg", "d_e", "dW_s", "dW_e")
        for name, u, v in zip(names, got, ref):
            if u.shape != v.shape or u.dtype != v.dtype \
                    or not torch.isfinite(u).all():
                raise AssertionError(f"csr_bwd_v2 {name} at d_in={d}: "
                                     "shape, dtype or not finite")
        errs = [_rel_err(u, v) for u, v in zip(got, ref)]
        same = all(torch.equal(u, v) for u, v in
                   zip((d_x, *got[1:]), (d_x_again, *again[1:])))
        b2 = {"d_in": d, "d_e": de, "h": h,
              "max_abs_err": max(e[0] for e in errs),
              "max_rel_err": max(e[1] for e in errs), "bitwise_repeat": same,
              "real_g_rel_err": dict(zip(names, real_g)),
              **_bwd_bound(d, de, h, n, e_pad, t, valid_slots, 2, True)}
        if on_card:
            b2["ms"] = _time_ms(lambda: kern.bwd(*args), reps)
            b2["plain_ms"] = _time_ms(lambda: kern.bwd_plain(*args), reps)
        else:
            b2["ms"] = b2["plain_ms"] = None
        out(f"kernel csr_bwd_v2 d_in={d} H={h}: errors (abs, rel) "
            + ", ".join(f"{nm} {e[0]:.3e} {e[1]:.3e}"
                        for nm, e in zip(names, errs))
            + f"; bitwise repeat {same}; ms={b2['ms']} plain_ms="
            f"{b2['plain_ms']} bound_ms={b2['bound_ms']:.4f} "
            f"({b2['bound_by']}; {b2['flops'] / 1e9:.2f} GFLOP, "
            f"{b2['bytes'] / 1e6:.1f} MB)")
        out(f"kernel csr_bwd_v2 d_in={d} H={h}, real-valued g: errors "
            "relative to each output's scale " + ", ".join(
                f"{nm} {e:.3e}" for nm, e in zip(names, real_g))
            + f" (d_e, dW_e held to {CSR_EDGE_GRAD_RTOL})")
        out(_landing_line(" (d_x)", b3))
        out(_landing_line(" (d_op sums)", b3_op))
        limit = 0.0 if exact else BWD_RTOL
        if b2["max_rel_err"] > limit:
            raise AssertionError(
                f"backward kernels disagree with their plain versions at "
                f"d_in={d}, H={h}: {errs}")
        for row in (b3, b3_op):
            _held_landing(row, BWD_RTOL, f"the CSR backward's {row['site']}"
                          f" landing, d_in={d}, H={h}")
        if max(real_g[1], real_g[3]) > CSR_EDGE_GRAD_RTOL:
            raise AssertionError(
                f"csr_bwd_v2's d_e or dW_e disagrees with its plain "
                f"version at d_in={d}, H={h} with a real-valued g: {real_g}")
        if not same:
            raise AssertionError(f"two backward runs differ at d_in={d}")
        bwd_rows.append(b2)
        seg_rows.append(b3)
        op_rows.append(b3_op)
    return bwd_rows, seg_rows + op_rows


def _proj_bound(d: int, h: int, n: int) -> Dict:
    """Least time for the node projection: x @ W_s once per node in bf16,
    x and W_s read once, y_s [n, H] float32 written once."""
    return _bound(2.0 * n * d * h, n * d * 2 + d * h * 2 + n * h * 4,
                  PEAK_BF16_FLOPS)


def _bits_bytes(e_pad: int, h: int) -> int:
    """The routing bits the function needs: one per (slot, column), in
    32-bit words."""
    return e_pad * -(-h // 32) * 4


def _gather_bound(de: int, h: int, n: int, e_pad: int, t: int,
                  valid_slots: int, vjp: bool = False,
                  index_arrays: int = 1) -> Dict:
    """Least time for the gather-max given y_s: e @ W_e once per valid
    slot in bf16 and a max per element; y_s, e_t, W_e, the index arrays
    (`index_arrays` int32 per slot and per tile: dense 1, windowed 2),
    inner_o and offset read once, out written once (in VJP mode also
    inner and the routing bits)."""
    nbytes = (n * h * 4 + e_pad * de * 2 + de * h * 2
              + index_arrays * (e_pad + t) * 4 + 3 * n * h * 4)
    if vjp:
        nbytes += n * h * 4 + _bits_bytes(e_pad, h)
    return _bound(2.0 * valid_slots * de * h, nbytes, PEAK_BF16_FLOPS,
                  float(valid_slots * h))


def _routed_bwd_bound(de: int, h: int, n: int, e_pad: int, rows: int,
                      n_ovf: int, routed: int, slot_arrays: int = 0) -> Dict:
    """Least time for the bits-routed backward kernels (dense and
    windowed): d_e and dW_e once per routed d_op element in bf16 (4 de
    flops each; every other product has a zero factor), and the sender
    sums' adds (`routed` set bits, plus the overflow rows' elements, in
    float32); the bits, g, e_t, W_e, the overflow rows, `slot_arrays` int32
    arrays per slot (the windowed receivers) and the landing (`rows` listed
    rows, N + 1 offsets) read once, d_e, dW_e and the two sender sums
    written once. The work depends on the data: `routed` is this run's
    count of set bits."""
    nbytes = (_bits_bytes(e_pad, h) + n * h * 4 + e_pad * de * 2
              + de * h * 2 + n_ovf * h * 4 + slot_arrays * e_pad * 4
              + rows * 4 + (n + 1) * 4 + e_pad * de * 2 + de * h * 4
              + 2 * n * h * 4)
    return _bound(4.0 * routed * de, nbytes, PEAK_BF16_FLOPS,
                  float(routed + n_ovf * h))


def _library_mm(x: torch.Tensor, w: torch.Tensor) -> Tuple[str, Callable]:
    """One PyTorch call computing the projection's function (bf16 operands,
    float32 products and sums), and its name: torch.mm with out_dtype where
    this torch has it, else torch.mm of the operands upcast (exact
    products)."""
    try:
        torch.mm(x[:1], w, out_dtype=torch.float32)
        return ("torch.mm(out_dtype=float32)",
                lambda: torch.mm(x, w, out_dtype=torch.float32))
    except (TypeError, RuntimeError):
        return ("torch.mm(x.float(), w.float())",
                lambda: torch.mm(x.float(), w.float()))


class _Routed(NamedTuple):
    """How a bits-routed layout (dense or windowed) calls its gather-max
    and backward kernels and their plain versions, on the operands
    alone."""

    fwd_name: str
    bwd_name: str
    # (y_s, e_t, w_e, inner_o, offset, emit_inner, bf16_max, the windowed
    # forward's bf16_landing)
    fwd: Callable
    fwd_plain: Callable
    bwd: Callable           # (bits, g_pass, e_t, w_e, d_op_o)
    bwd_plain: Callable
    index_arrays: int       # int32 arrays per slot and per tile
    slot_arrays: int        # int32 arrays per slot the backward reads


def _routed_of(tiling) -> _Routed:
    """The layout's kernels: dense (`tiling.dense` set) or windowed."""
    sloc, t_win = tiling.win[:2]
    order, row_ptr = tiling.landing
    if tiling.dense is not None:
        r_tile, k = tiling.dense
        names, mod = ("dense_fwd_v4", "dense_bwd_v4"), da
        layout, arrays = (sloc, t_win), 1
        fwd_kw = dict(r_tile=r_tile, k=k, node_block=tiling.node_block)
        bwd_layout, bwd_kw = (), dict(r_tile=r_tile, k=k)
    else:
        names, mod = ("windowed_fwd_v3", "windowed_bwd_v3"), wa
        layout, arrays = (tiling.receivers, sloc, t_win, tiling.blocks), 2
        fwd_kw = dict(node_block=tiling.node_block,
                      edge_tile=tiling.edge_tile)
        bwd_layout = (tiling.receivers,)
        bwd_kw = dict(edge_tile=tiling.edge_tile)
    stem = names[0][:names[0].index("_")]

    def fwd(fn):
        return lambda y_s, e_t, w_e, inner_o, offset, emit_inner=False, \
            bf16_max=False, **kw: fn(y_s, e_t, w_e, *layout, inner_o,
                                     offset, emit_inner=emit_inner,
                                     bf16_max=bf16_max, **fwd_kw, **kw)

    def bwd(fn):
        return lambda bits, g_pass, e_t, w_e, d_op_o: fn(
            bits, g_pass, e_t, w_e, d_op_o, *bwd_layout, order, row_ptr,
            **bwd_kw)

    return _Routed(*names, fwd(getattr(mod, f"{stem}_fwd")),
                   fwd(getattr(mod, f"{stem}_fwd_plain")),
                   bwd(getattr(mod, f"{stem}_bwd")),
                   bwd(getattr(mod, f"{stem}_bwd_plain")), arrays,
                   len(bwd_layout))


def check_routed_kernels(tiling, layer_shapes: List[tuple], seed: int,
                         reps: int, out: Callable = print,
                         exact: bool = False
                         ) -> Tuple[List[Dict], List[Dict], List[Dict]]:
    """Holds a bits-routed layout's kernels (dense: B1, B2; windowed: B4)
    against their plain versions at each (d_in, d_e, H) of the model, on
    the batch's real layout and landing: the projection (`dense_proj_v4`)
    and the gather-max on seeded real-valued bf16 inputs (KERNEL_RTOL; the
    routing bits of the VJP mode may differ only where an operand's gap to
    its max lies within a float32 rounding of the 1e-5 tolerance: at most
    BITS_FLIP_FRAC of the bits), then the forward again and the backward on
    dyadic inputs, where every product and sum is exact in float32 in any
    order: the bits must agree exactly, and the backward's outputs up to
    the bf16 rounding of equal values (BWD_RTOL; with `exact`, bitwise);
    two backward runs must give the same bits. Times kernels, plain
    versions and, for the projection, one torch.mm on the card; the
    gather-max in serving and in
    VJP mode (the row's `vjp`). Each row also holds the bound of the whole
    function as the TPU kernel forms it (`function_bound_ms`, per slot).
    Returns the rows of (projection, gather-max, backward)."""
    kern = _routed_of(tiling)
    sloc = tiling.win[0]
    ovf_s, ovf_r = tiling.win[3:5]
    order, row_ptr = tiling.landing
    dev = sloc.device
    cd = da.gather_dtype(dev)
    e_pad, t = sloc.shape[0], tiling.win[1].shape[0]
    n = row_ptr.shape[0] - 1
    valid_slots = _valid_slots(tiling)
    n_ovf = ovf_s.shape[0]
    on_card = dev.type == "cuda"
    gen = torch.Generator().manual_seed(seed)

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    def dyadic(*shape, lo=-2, hi=2, step=0.5):
        return (torch.randint(lo, hi + 1, shape, generator=gen)
                * step).to(dev)

    def forward(fwd, proj, x, w_s, e_t, w_e, e_ovf, offset):
        y_s = proj(x, w_s)
        inner_o = da.overflow_maxima(
            da.dense_overflow_operand(y_s, e_ovf, w_e, ovf_s), ovf_r, n)
        return y_s, inner_o, fwd(y_s, e_t, w_e, inner_o, offset,
                                 emit_inner=True)

    proj_rows, fwd_rows, bwd_rows = [], [], []
    for d, de, h in layer_shapes:
        # -- the forward on real-valued inputs ------------------------------
        x, w_s = rand(n, d).to(cd), rand(d, h, scale=d ** -0.5).to(cd)
        e_t = rand(e_pad, de).to(cd)
        w_e = rand(de, h, scale=de ** -0.5).to(cd)
        e_ovf, offset = rand(n_ovf, de).to(cd), rand(n, h)
        y_s = da.dense_proj(x, w_s)
        y_ref = da.dense_proj_plain(x, w_s)
        inner_o = da.overflow_maxima(
            da.dense_overflow_operand(y_s, e_ovf, w_e, ovf_s), ovf_r, n)
        args = (y_s, e_t, w_e, inner_o, offset)
        got = kern.fwd(*args)
        ref = kern.fwd_plain(*args)
        got_vjp, inner, bits = kern.fwd(*args, emit_inner=True)
        _, ref_inner, ref_bits = kern.fwd_plain(*args, emit_inner=True)
        if on_card:
            torch.cuda.synchronize()
        if not (torch.isfinite(got).all() and torch.isfinite(y_s).all()):
            raise AssertionError(f"{kern.fwd_name} not finite at d={d}, "
                                 f"h={h}")
        if not torch.equal(got_vjp, got):
            raise AssertionError("the VJP mode changed the forward's output")
        has = ref_inner > da._NEG / 2
        if not torch.equal(inner > da._NEG / 2, has):
            raise AssertionError("VJP mode: empty receivers differ")
        proj_err = _rel_err(y_s, y_ref)
        err = max(float((got - ref).abs().max()),
                  float((inner[has] - ref_inner[has]).abs().max()))
        flips = _popcount(bits ^ ref_bits)
        n_bits = e_pad * h
        gather = dict(de=de, h=h, n=n, e_pad=e_pad, t=t,
                      valid_slots=valid_slots,
                      index_arrays=kern.index_arrays)
        p_row = {"d_in": d, "h": h, "max_abs_err": proj_err[0],
                 "max_rel_err": proj_err[1], **_proj_bound(d, h, n)}
        row = {"d_in": d, "d_e": de, "h": h, "max_abs_err": err,
               "max_rel_err": err / max(float(ref.abs().max()), 1.0),
               "bits_flipped": flips, "bits": n_bits,
               "function_bound_ms": _kernel_bound(
                   d, de, h, n, e_pad, t, valid_slots,
                   kern.index_arrays)["bound_ms"],
               "vjp": _gather_bound(vjp=True, **gather),
               **_gather_bound(**gather)}
        if on_card:
            p_row["ms"] = _time_ms(lambda: da.dense_proj(x, w_s), reps)
            p_row["plain_ms"] = _time_ms(lambda: da.dense_proj_plain(x, w_s),
                                         reps)
            p_row["library"], library = _library_mm(x, w_s)
            p_row["library_ms"] = _time_ms(library, reps)
            row["ms"] = _time_ms(lambda: kern.fwd(*args), reps)
            row["plain_ms"] = _time_ms(lambda: kern.fwd_plain(*args), reps)
            row["vjp"]["ms"] = _time_ms(
                lambda: kern.fwd(*args, emit_inner=True), reps)
            row["vjp"]["plain_ms"] = _time_ms(
                lambda: kern.fwd_plain(*args, emit_inner=True), reps)
        else:
            p_row["ms"] = p_row["plain_ms"] = p_row["library_ms"] = None
            row["ms"] = row["plain_ms"] = None
            row["vjp"]["ms"] = row["vjp"]["plain_ms"] = None
        out(f"kernel dense_proj_v4 d_in={d} H={h}: max_abs_err="
            f"{proj_err[0]:.3e} ms={p_row['ms']} plain_ms={p_row['plain_ms']}"
            f" {p_row.get('library', 'torch.mm')} ms={p_row['library_ms']} "
            f"bound_ms="
            f"{p_row['bound_ms']:.4f} ({p_row['bound_by']})")
        out(f"kernel {kern.fwd_name} d_in={d} H={h}: max_abs_err={err:.3e} "
            f"max_rel_err={row['max_rel_err']:.3e} bits flipped {flips} of "
            f"{n_bits} ms={row['ms']} plain_ms={row['plain_ms']} bound_ms="
            f"{row['bound_ms']:.4f} ({row['bound_by']}); VJP mode ms="
            f"{row['vjp']['ms']} plain_ms={row['vjp']['plain_ms']} bound_ms="
            f"{row['vjp']['bound_ms']:.4f} ({row['vjp']['bound_by']}); the "
            f"whole forward's bound {row['function_bound_ms']:.4f}")
        if proj_err[1] > KERNEL_RTOL or row["max_rel_err"] > KERNEL_RTOL \
                or flips > BITS_FLIP_FRAC * n_bits:
            raise AssertionError(
                f"{kern.fwd_name} and the projection disagree with their "
                f"plain versions at d_in={d}, H={h}: projection {proj_err}, "
                f"gather-max {row['max_rel_err']:.3e}, {flips} bits flipped")

        # -- the forward and the backward on dyadic inputs ------------------
        x, w_s = dyadic(n, d).to(cd), dyadic(d, h, step=0.25).to(cd)
        e_t, w_e = dyadic(e_pad, de).to(cd), dyadic(de, h, step=0.25).to(cd)
        e_ovf = dyadic(n_ovf, de).to(cd)
        offset = torch.zeros((n, h), device=dev)
        y_s, _, (_, inner, bits) = forward(kern.fwd, da.dense_proj, x, w_s,
                                           e_t, w_e, e_ovf, offset)
        _, _, (_, ref_inner, ref_bits) = forward(
            kern.fwd_plain, da.dense_proj_plain, x, w_s, e_t, w_e, e_ovf,
            offset)
        if on_card:
            torch.cuda.synchronize()
        if not (torch.equal(bits, ref_bits) and torch.equal(inner,
                                                            ref_inner)):
            raise AssertionError(f"dyadic inputs at d_in={d}, H={h}: "
                                 f"{kern.fwd_name}'s inner or routing bits "
                                 "differ")
        has = inner > da._NEG / 2
        g_pass = torch.where(has, dyadic(n, h, lo=-8, hi=8, step=0.125), 0.0)
        inner_z = torch.where(has, inner, 0.0)
        op_o = da.dense_overflow_operand(y_s, e_ovf, w_e, ovf_s)
        mask = ovf_r >= 0
        recv = torch.where(mask, ovf_r, 0).long()
        d_op_o = torch.where(mask[:, None] & da._routes(op_o, inner_z[recv]),
                             g_pass[recv], 0.0)
        b_args = (bits, g_pass, e_t, w_e, d_op_o)
        got = kern.bwd(*b_args)
        ref = kern.bwd_plain(*b_args)
        again = kern.bwd(*b_args)
        if on_card:
            torch.cuda.synchronize()
        names = ("d_e", "dW_e", "d_ys", "d_yo")
        for name, u, v in zip(names, got, ref):
            if u.shape != v.shape or u.dtype != v.dtype \
                    or not torch.isfinite(u).all():
                raise AssertionError(f"{kern.bwd_name} {name} at d_in={d}: "
                                     "shape, dtype or not finite")
        errs = [_rel_err(u, v) for u, v in zip(got, ref)]
        same = all(torch.equal(u, v) for u, v in zip(got, again))
        routed = _popcount(bits)
        b2 = {"d_in": d, "d_e": de, "h": h,
              "max_abs_err": max(e[0] for e in errs),
              "max_rel_err": max(e[1] for e in errs), "bitwise_repeat": same,
              "routed": routed,
              "function_bound_ms": _bwd_bound(
                  d, de, h, n, e_pad, t, valid_slots,
                  kern.index_arrays)["bound_ms"],
              **_routed_bwd_bound(de, h, n, e_pad, int(order.shape[0]),
                                  n_ovf, routed, kern.slot_arrays)}
        if on_card:
            b2["ms"] = _time_ms(lambda: kern.bwd(*b_args), reps)
            b2["plain_ms"] = _time_ms(lambda: kern.bwd_plain(*b_args), reps)
        else:
            b2["ms"] = b2["plain_ms"] = None
        out(f"kernel {kern.bwd_name} d_in={d} H={h}: errors (abs, rel) "
            + ", ".join(f"{nm} {e[0]:.3e} {e[1]:.3e}"
                        for nm, e in zip(names, errs))
            + f"; dyadic bits equal; {routed} routed; bitwise repeat {same}; "
            f"ms={b2['ms']} plain_ms={b2['plain_ms']} bound_ms="
            f"{b2['bound_ms']:.4f} ({b2['bound_by']}; "
            f"{b2['bytes'] / 1e6:.1f} MB); the whole backward's bound "
            f"{b2['function_bound_ms']:.4f}")
        if b2["max_rel_err"] > (0.0 if exact else BWD_RTOL):
            raise AssertionError(
                f"{kern.bwd_name} disagrees with its plain version at "
                f"d_in={d}, H={h}: {errs}")
        if not same:
            raise AssertionError(f"two backward runs differ at d_in={d}")
        proj_rows.append(p_row)
        fwd_rows.append(row)
        bwd_rows.append(b2)
    return proj_rows, fwd_rows, bwd_rows


def _popcount(bits: torch.Tensor) -> int:
    """Set bits of an int32 tensor."""
    b = bits.contiguous().view(torch.uint8).cpu().numpy()
    return int(np.unpackbits(b).sum())


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


class _VariantLaunches:
    """A wrapper's count of its launches of one variant (`attr`: the
    bf16-routing ones, `bf16_launches`, by default), read and set as
    `launches`, as the other counters are."""

    def __init__(self, wrapper: Callable, attr: str = "bf16_launches"):
        self.wrapper = wrapper
        self.attr = attr

    @property
    def launches(self) -> int:
        return getattr(self.wrapper, self.attr)

    @launches.setter
    def launches(self, value: int) -> None:
        setattr(self.wrapper, self.attr, value)


def _counters():
    """The launch counters of the kernels, in the order of KERNEL_NAMES."""
    return (da.dense_fwd_cuda, da.dense_bwd_cuda, ss.segment_sum_csr_cuda,
            wa.windowed_fwd_cuda, wa.windowed_bwd_cuda, ca.csr_fwd_cuda,
            ca.csr_bwd_cuda, fl.fused_linear_cuda, msm.msg_segmax_cuda,
            ha.hoisted_fwd_cuda, ha.hoisted_bwd_cuda, da.dense_proj_cuda,
            _VariantLaunches(da.dense_fwd_cuda),
            _VariantLaunches(wa.windowed_fwd_cuda),
            _VariantLaunches(wa.windowed_fwd_cuda, "landing_launches"))


# the kernel wrappers of the model paths, which the plain path and the
# witness replace (and `csr_bwd`, whose replacements drop the landing)
KERNEL_WRAPPERS = ((da, "dense_proj"), (da, "dense_fwd"), (da, "dense_bwd"),
                   (ss, "segment_sum_csr"), (wa, "windowed_fwd"),
                   (wa, "windowed_bwd"), (ca, "csr_fwd"))


def _replace_kernels(version: Callable) -> ExitStack:
    """Patches every kernel wrapper of the model paths to `version(module,
    name)`, its replacement."""
    stack = ExitStack()
    for mod, name in KERNEL_WRAPPERS:
        stack.enter_context(mock.patch.object(mod, name, version(mod, name)))
    stack.enter_context(mock.patch.object(
        ca, "csr_bwd", without_landing(version(ca, "csr_bwd"))))
    return stack


def _plain_kernels() -> ExitStack:
    """Patches every kernel wrapper to its plain version (the plain path
    on the same device)."""
    return _replace_kernels(lambda mod, name: getattr(mod, f"{name}_plain"))


def _witness_kernels() -> ExitStack:
    """Patches every kernel wrapper to its plain version with its float32
    sums re-associated (`radargnn_tpu_torch.witness`): the plain path with
    its sums added in other orders, the drift witness."""
    return _replace_kernels(lambda mod, name: getattr(reassociated, name))


def without_landing(plain: Callable) -> Callable:
    """A plain CSR backward in `csr_bwd`'s place: it sums dW_s over the
    slots and projects for itself, so it drops the sender `landing` and
    the forward's `y_s` the kernels take."""
    return lambda *args, landing=None, y_s=None, **kw: plain(*args, **kw)


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
                      plain: bool = False, reference: bool = False,
                      witness: bool = False) -> Dict:
    """The training path: a `Trainer` from the flagship configuration's
    TRAINING section on a DetNet of `arch` with weights from `seed`,
    `steps` train steps on `batch` (on the plain path with `plain`, on the
    witness, the plain path re-associated, with `witness`). Returns the
    per-step (total, cls, bb) losses, the per-step wall seconds (each step
    ends when its losses reach the host), the first step's gradients by
    parameter name, and the kernel launches of the run (the counters are
    set to 0 just before it and read just after). With `reference`, before
    each step the plain path's losses and gradients at that step's
    parameters (`_plain_reference`, untimed) are held against the step's
    own, in `agreement`."""
    cfg = UserConfigurationReader.read_config_file(FLAGSHIP_CONFIG)
    train_cfg = UserConfigurationReader.get_config_object("TRAINING", cfg)
    trainer = Trainer(train_cfg, DetNet(arch, device=dev, seed=seed))
    on_card = torch.device(dev).type == "cuda"
    losses, seconds, grads, agreement = [], [], {}, []
    with _witness_kernels() if witness else _plain_kernels() if plain \
            else ExitStack():
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
                 ca.load_bwd_kernel, fl.load_kernel, msm.load_kernel,
                 ha.load_fwd_kernel, ha.load_bwd_kernel):
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


def loss_drift(losses, ref) -> float:
    """The largest relative difference of two runs' per-step losses."""
    u, v = np.asarray(losses), np.asarray(ref)
    return float((np.abs(u - v) / np.maximum(np.abs(v), 1e-12)).max())


def _train_phase(dev, arch, batch, seed: int, steps: int,
                 expected: List[int], label: str, out: Callable,
                 witness: bool = False) -> Dict:
    """Three training runs of `steps` steps from the same seeded weights on
    `batch`, with the configuration's deterministic setting: the kernel
    path (launches counted, steps timed); the kernel path again (the same
    bits), with the plain path's losses and gradients at each step's
    parameters (losses within TRAIN_LOSS_RTOL, gradient cosines at least
    TRAIN_GRAD_COS overall and TRAIN_PARAM_COS per parameter); and the
    plain path on its own (its step time, and its drift from the kernel
    run, reported). With `witness`, a fourth: the plain path re-associated
    (`_witness_kernels`), whose drift from the plain path, reported beside
    the kernel run's, is what re-association alone produces."""
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
        wit = flagship_training(dev, arch, batch, seed, steps,
                                witness=True) if witness else None
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
    drift = loss_drift(losses, plain["losses"])
    wit_drift = None if wit is None else loss_drift(wit["losses"],
                                                     plain["losses"])
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
        f"{plain['losses']}, drift {drift:.3e} (reported)"
        + ("" if wit is None else
           f"; the witness (the plain path re-associated) {wit['losses']}, "
           f"drift from the plain path {wit_drift:.3e} (reported)"))
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
        "train_free_running_drift": drift,
        "train_witness_drift": wit_drift, "train_grad_agreement": grads,
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


# ---------------------------------------------------------------------------
# the fourth phase: the kernels no model path runs
# ---------------------------------------------------------------------------

class V1Tiling(NamedTuple):
    """A batch's edges (global node ids, all graphs) under the receiver-CSR
    tiles of `prepare_csr_tiles` at the v1 factories' defaults (128-node
    blocks, 256-slot tiles): the layout the v1 pair and the message
    segment-max are held on."""

    senders: torch.Tensor     # [E_pad] int32, the permuted senders
    recv: torch.Tensor        # [E_pad] int32, -1 on an empty slot
    blocks: torch.Tensor      # [T] int32
    num_nodes: int
    node_block: int
    edge_tile: int
    valid_slots: int


def v1_tiling(batch, node_block: int = 128, edge_tile: int = 256
              ) -> V1Tiling:
    """The batch's valid edges under the v1 factories' CSR tiles."""
    n = batch.num_graphs * batch.max_nodes
    send = batch.flat_senders().cpu().numpy()
    recv = batch.flat_receivers().cpu().numpy()
    mask = batch.edge_mask.reshape(-1).cpu().numpy()
    perm, blocks, padded = prepare_csr_tiles(recv, mask, n, node_block,
                                             edge_tile)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(batch.device)

    return V1Tiling(t(send[perm]), t(padded), t(blocks), n, node_block,
                    edge_tile, int((padded >= 0).sum()))


def _f32_bound(flops: float, nbytes: float) -> Dict:
    """The bound of a float32 kernel: its operations at the float32 peak
    outside the tensor cores, its bytes at the HBM rate."""
    return _bound(flops, nbytes, PEAK_F32_FLOPS)


def _timed(row: Dict, on_card: bool, reps: int, **fns: Callable) -> None:
    """row[name] = the device time of each fn on the card, None off it."""
    for name, fn in fns.items():
        row[name] = _time_ms(fn, reps) if on_card else None


def _linear_bench(cases: List[tuple], seed: int, reps: int) -> List[Dict]:
    """`benchmarks.linear_bench` on `cases` in a process of its own with
    cuBLAS's default workspace (this process limits it for the
    deterministic training phases, which slows torch.addmm: PERF.md)."""
    env = {k: v for k, v in os.environ.items()
           if k != "CUBLAS_WORKSPACE_CONFIG"}
    proc = subprocess.run(
        [sys.executable, "-m", "radargnn_tpu_torch.benchmarks.linear_bench",
         "--cases", json.dumps(cases), "--seed", str(seed), "--reps",
         str(reps)], env=env, cwd=_REPO,
        capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"linear_bench failed:\n{proc.stderr[-3000:]}")
    lines = proc.stdout.splitlines()[-len(cases):]
    return [json.loads(line) for line in lines]


def check_linear_kernel(dev, cases: List[tuple], seed: int, reps: int,
                        out: Callable = print) -> List[Dict]:
    """Holds the fused linear kernel against its plain version on seeded
    float32 inputs, for each (rows, d_in, d_out, relu, weight scale), to
    F32_RTOL of the output's scale, beside its bound (3xTF32, the float32
    floor beside it); times on the card the plain version and, by
    `benchmarks.linear_bench` in a process with cuBLAS's default workspace
    on the same inputs, the kernel, torch.addmm + ReLU and torch.addmm
    alone in rounds that alternate which runs first (the library call for
    the case's function is the one with ReLU where the case has one). Each
    is read back to back (`ms`, the timer of every other kernel's row: the
    host's launch time included where it exceeds the device time) and
    queued behind a sleep kernel (`device_ms`, the device alone; `host_ms`,
    the host's time to issue a call); the rows keep each time's median and
    its rounds."""
    gen = torch.Generator().manual_seed(seed)
    on_card = dev.type == "cuda"
    rows = []
    for m, k, n, relu, scale in cases:
        x, w, b = linear_bench.linear_inputs(gen, m, k, n, scale, dev)
        got = fl.fused_linear(x, w, b, relu=relu)
        ref = fl.fused_linear_plain(x, w, b, relu=relu)
        if on_card:
            torch.cuda.synchronize()
        err, rel = _rel_err(got, ref)
        if got.shape != (m, n) or not torch.isfinite(got).all() \
                or rel > F32_RTOL:
            raise AssertionError(f"fused_linear disagrees with its plain "
                                 f"version at {m} x {k} -> {n}: {rel:.3e}")
        row = {"rows": m, "d_in": k, "d_out": n, "relu": relu,
               "max_abs_err": err, "max_rel_err": rel,
               **_tf32x3_bound(2.0 * m * k * n,
                               4.0 * (m * k + k * n + n + m * n))}
        _timed(row, on_card, reps,
               plain_ms=lambda: fl.fused_linear_plain(x, w, b, relu=relu))
        rows.append(row)
    bench = _linear_bench(cases, seed, reps) if on_card else [{}] * len(rows)
    for row, timed in zip(rows, bench):
        for prefix in ("", "addmm_relu_", "addmm_"):
            for timer in ("ms", "device_ms", "host_ms"):
                name = prefix + timer
                row[name] = timed.get(name)
                row[f"{name}_rounds"] = timed.get(f"{name}_rounds")
        row["cublas_workspace_config"] = timed.get("cublas_workspace_config")
        lib = "addmm_relu_" if row["relu"] else "addmm_"
        row["library_ms"] = row[f"{lib}ms"]
        row["library_device_ms"] = row[f"{lib}device_ms"]
        out(f"kernel fused_linear {row['rows']} x {row['d_in']} -> "
            f"{row['d_out']} (relu {row['relu']}): max_abs_err="
            f"{row['max_abs_err']:.3e} max_rel_err={row['max_rel_err']:.3e} "
            f"plain_ms={row['plain_ms']}; medians of {linear_bench.ROUNDS} "
            f"alternating rounds (cuBLAS's default workspace), back to back "
            f"/ device alone / host per call: kernel {row['ms']} / "
            f"{row['device_ms']} / {row['host_ms']} ms, addmm + ReLU "
            f"{row['addmm_relu_ms']} / {row['addmm_relu_device_ms']} / "
            f"{row['addmm_relu_host_ms']}, addmm {row['addmm_ms']} / "
            f"{row['addmm_device_ms']} / {row['addmm_host_ms']}; bound_ms="
            f"{row['bound_ms']:.4f} ({row['bound_by']}, 3xTF32; float32 "
            f"floor {row['f32_bound_ms']:.4f})")
    return rows


def _segmax_small_cases(dev) -> List[Dict]:
    """The empty-block and all-negative cases of the JAX package's tests:
    (m_in, w, b, padded receivers, tile blocks, geometry) on `dev`, with the
    values the output must hold."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    rng = np.random.default_rng(2)
    m_in = rng.normal(size=(120, 8)).astype(np.float32)
    recv = rng.integers(0, 30, 120).astype(np.int32)   # first block only
    perm, tb, padded = prepare_csr_tiles(recv, np.ones(120, bool), 128, 32,
                                         32)
    empty = dict(name="empty blocks", args=(
        t(m_in[perm]), t(rng.normal(size=(8, 16)).astype(np.float32)),
        t(np.zeros(16, np.float32)), t(padded), t(tb)),
        kw=dict(num_nodes=128, node_block=32, edge_tile=32),
        zero_rows=slice(32, None))
    recv = np.repeat(np.arange(4), 4).astype(np.int32)
    perm, tb, padded = prepare_csr_tiles(recv, np.ones(16, bool), 8, 8, 8)
    negative = dict(name="all-negative", args=(
        t(-np.ones((16, 4), np.float32)), t(np.eye(4, dtype=np.float32)),
        t(np.zeros(4, np.float32)), t(padded), t(tb)),
        kw=dict(num_nodes=8, node_block=8, edge_tile=8),
        zero_rows=slice(4, None), exact=(slice(0, 4), -1.0))
    return [empty, negative]


def segmax_wide_range(rng: np.random.Generator, e: int, d_in: int,
                      h: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Float32 (m_in [e, d_in], W [d_in, h], b [h]) whose messages span a
    wide range with cancelling terms: |m_in| log-uniform in [1e-3, 1e3]
    with random signs, and the second half of the columns repeating the
    first, each scaled by a factor in [0.5, 1.5), against the negated rows
    of W, so that each pair of terms cancels to at most half of one."""
    m_in = rng.choice([-1.0, 1.0], size=(e, d_in)) \
        * 10.0 ** rng.uniform(-3.0, 3.0, size=(e, d_in))
    w = rng.normal(size=(d_in, h)) * d_in ** -0.5
    half = d_in // 2
    m_in[:, half:2 * half] = m_in[:, :half] \
        * rng.uniform(0.5, 1.5, size=(e, half))
    w[half:2 * half] = -w[:half]
    b = rng.normal(size=(h,))
    return (m_in.astype(np.float32), w.astype(np.float32),
            b.astype(np.float32))


def _tf32x3_bound(flops: float, nbytes: float) -> Dict:
    """The bound of a float32 kernel that forms each product as three TF32
    products on the tensor cores (3xTF32, float32 accuracy: B8, B9): the
    lesser of that floor and the float32 floor outside the tensor cores;
    both floors stand beside it (`tf32x3_bound_ms`, `f32_bound_ms`)."""
    f32 = _f32_bound(flops, nbytes)
    tf32x3 = _bound(3 * flops, nbytes, PEAK_TF32_FLOPS)
    return {**min(f32, tf32x3, key=lambda b: b["bound_ms"]),
            "product_flops": flops, "f32_bound_ms": f32["bound_ms"],
            "tf32x3_bound_ms": tf32x3["bound_ms"]}


def _segmax_bound(valid_slots: int, e_pad: int, d_in: int, h: int, t: int,
                  n: int) -> Dict:
    """B8's bound (`_tf32x3_bound`): 2 E d_in H product operations over the
    valid slots, and m_in, W, b, the receivers, the tiles' blocks and the
    output each moved once."""
    return _tf32x3_bound(
        2.0 * valid_slots * d_in * h,
        4.0 * (e_pad * d_in + d_in * h + h + e_pad + t + n * h))


def check_segmax_kernel(v1: V1Tiling, d_in: int, h: int, seed: int,
                        reps: int, out: Callable = print) -> List[Dict]:
    """Holds the message segment-max kernel against its plain version on
    the batch's receivers under the v1 tiles, with seeded float32 messages
    of width d_in -> h and with wide-range ones (`segmax_wide_range`), to
    F32_RTOL of the output's scale, two runs bitwise equal, and on the
    empty-block and all-negative cases (empty receivers exactly 0, negative
    maxima kept); times the kernel, the plain version and the library path
    (torch.addmm, then scatter_reduce_ "amax") on the card."""
    dev = v1.recv.device
    on_card = dev.type == "cuda"
    gen = torch.Generator().manual_seed(seed)
    e_pad, t = v1.recv.shape[0], v1.blocks.shape[0]
    n = v1.num_nodes
    m_in = torch.randn((e_pad, d_in), generator=gen).to(dev)
    w = (torch.randn((d_in, h), generator=gen) * d_in ** -0.5).to(dev)
    b = torch.randn((h,), generator=gen).to(dev)
    kw = dict(num_nodes=n, node_block=v1.node_block, edge_tile=v1.edge_tile)
    args = (m_in, w, b, v1.recv, v1.blocks)
    got = msm.msg_segmax(*args, **kw)
    ref = msm.msg_segmax_plain(*args, **kw)
    # the library path on the same slots: empty slots land on a spare row
    counts = wa.slot_counts(v1.recv, v1.blocks, n, v1.node_block,
                            v1.edge_tile)
    index = torch.where(counts, v1.recv.long(), n)[:, None].expand(e_pad, h)

    def library():
        m = torch.addmm(b, m_in, w)
        return torch.zeros((n + 1, h), dtype=torch.float32, device=dev
                           ).scatter_reduce_(0, index, m, "amax",
                                             include_self=False)[:n]

    again = msm.msg_segmax(*args, **kw)
    wide_m, wide_w, wide_b = (torch.from_numpy(a).to(dev) for a in
                              segmax_wide_range(np.random.default_rng(seed),
                                                e_pad, d_in, h))
    wide = dict(name="wide range", args=(wide_m, wide_w, wide_b, v1.recv,
                                         v1.blocks), kw=kw)
    rows = []
    for case in [None, wide] + _segmax_small_cases(dev):
        if case is not None:
            got = msm.msg_segmax(*case["args"], **case["kw"])
            ref = msm.msg_segmax_plain(*case["args"], **case["kw"])
            again = msm.msg_segmax(*case["args"], **case["kw"])
        if on_card:
            torch.cuda.synchronize()
        err, rel = _rel_err(got, ref)
        name = "kNN batch" if case is None else case["name"]
        ok = torch.isfinite(got).all() and rel <= F32_RTOL \
            and torch.equal(got, again)
        if "zero_rows" in (case or {}):
            ok = ok and bool((got[case["zero_rows"]] == 0).all())
            if "exact" in case:
                rows_, value = case["exact"]
                ok = ok and bool((got[rows_] == value).all())
        if not ok:
            raise AssertionError(f"msg_segmax disagrees with its plain "
                                 f"version or with itself ({name}): "
                                 f"{rel:.3e}")
        row = {"case": name, "max_abs_err": err, "max_rel_err": rel}
        if case is None:
            row.update(e_pad=e_pad, valid_slots=v1.valid_slots, d_in=d_in,
                       h=h, **_segmax_bound(v1.valid_slots, e_pad, d_in, h,
                                            t, n))
            _timed(row, on_card, reps,
                   ms=lambda: msm.msg_segmax(*args, **kw),
                   plain_ms=lambda: msm.msg_segmax_plain(*args, **kw),
                   library_ms=library)
            if on_card:
                lib_err = float((library() - ref).abs().max())
                row["library_max_abs_err"] = lib_err
            out(f"kernel msg_segmax {d_in} -> {h} on {e_pad} slots "
                f"({v1.valid_slots} valid, {t} tiles of {v1.edge_tile}): "
                f"max_abs_err={err:.3e} max_rel_err={rel:.3e} "
                f"ms={row['ms']} plain_ms={row['plain_ms']} addmm + "
                f"scatter_reduce_ ms={row['library_ms']} bound_ms="
                f"{row['bound_ms']:.4f} ({row['bound_by']}; "
                f"{row['product_flops'] / 1e9:.1f} GFLOP as 3xTF32; "
                f"float32 floor {row['f32_bound_ms']:.4f})")
        else:
            out(f"kernel msg_segmax, {name}: max_abs_err={err:.3e} "
                f"max_rel_err={rel:.3e}")
        rows.append(row)
    return rows


def _v1_bounds(v1: V1Tiling, de: int, h: int) -> Tuple[Dict, Dict]:
    """The v1 forward's and backward's bounds: the edge products per valid
    slot in float32 (the forward 1, the backward 3: the recomputed
    operand, d_e, dW_e), and the bytes of their inputs and outputs."""
    e_pad, t, n = v1.recv.shape[0], v1.blocks.shape[0], v1.num_nodes
    edge = 2.0 * v1.valid_slots * de * h
    index = 4.0 * (2 * e_pad + t)
    weights = 4.0 * (de * h + h)
    fwd = _f32_bound(edge, 4.0 * (3 * n * h + e_pad * de) + weights + index)
    bwd = _f32_bound(3 * edge, 4.0 * (3 * n * h + 2 * e_pad * de + e_pad * h)
                     + 2 * weights + index)
    return fwd, bwd


# shapes at which the v1 forward's wrapper pads its operands: d_e 3 (e_t and
# W_e padded to 4 features), with H 464 and 450 (y_s's row stride padded to
# 452)
V1_PADDED_SHAPES = ((3, 464), (3, 450))


def check_v1_padding(v1: V1Tiling, layer_shapes: List[tuple], seed: int,
                     reps: int, out: Callable = print) -> List[Dict]:
    """What the v1 forward's operand padding (`walk_operands`) costs. At
    the model's layer shapes it pads nothing: the operands come back as
    they were given. At V1_PADDED_SHAPES the forward, which pads, is held
    to its plain version (F32_RTOL of the output's scale) and timed on the
    card beside `walk_operands` alone (the copies)."""
    dev = v1.recv.device
    on_card = dev.type == "cuda"
    gen = torch.Generator().manual_seed(seed)
    n, e_pad = v1.num_nodes, v1.recv.shape[0]
    kw = dict(node_block=v1.node_block, edge_tile=v1.edge_tile)

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    for _, de, h in layer_shapes:
        given = (torch.empty((n, h), device=dev),
                 torch.empty((e_pad, de), device=dev),
                 torch.empty((de, h), device=dev), v1.senders, v1.recv)
        got = ha.walk_operands(*given, v1.edge_tile)
        if any(a is not b for a, b in zip(got, given)) \
                or got[-1] != v1.edge_tile:
            raise AssertionError(f"walk_operands pads at d_e={de}, H={h}, "
                                 f"edge_tile={v1.edge_tile}")
    rows = []
    for de, h in V1_PADDED_SHAPES:
        y_s, e_t, w_e = rand(n, h), rand(e_pad, de), rand(de, h)
        args = (y_s, e_t, w_e, rand(h), v1.senders, v1.recv, v1.blocks,
                rand(n, h))
        err, rel = _rel_err(ha.hoisted_fwd(*args, **kw),
                            ha.hoisted_fwd_plain(*args, **kw))
        if rel > F32_RTOL:
            raise AssertionError(f"hoisted_fwd_v1 disagrees with its plain "
                                 f"version at d_e={de}, H={h}: {rel:.3e}")
        row = {"d_e": de, "h": h, "max_abs_err": err, "max_rel_err": rel}
        _timed(row, on_card, reps,
               ms=lambda: ha.hoisted_fwd(*args, **kw),
               pad_ms=lambda: ha.walk_operands(y_s, e_t, w_e, v1.senders,
                                               v1.recv, v1.edge_tile))
        out(f"kernel hoisted_fwd_v1 padded operands, d_e={de} H={h}: "
            f"max_rel_err={rel:.3e} ms={row['ms']} of which walk_operands "
            f"ms={row['pad_ms']}; the model's {len(layer_shapes)} layer "
            "shapes pad nothing")
        rows.append(row)
    return rows


def check_v1_kernels(v1: V1Tiling, layer_shapes: List[tuple], seed: int,
                     reps: int, out: Callable = print
                     ) -> Tuple[List[Dict], List[Dict]]:
    """Holds the v1 pair against their plain versions at each (d_in, d_e,
    H) of the model, on the batch under the v1 tiles, with y_s the
    node-level projection x @ W_s.

    The forward runs on seeded real-valued inputs, in serving and in VJP
    mode (both timed), to F32_RTOL of the output's scale. The backward runs
    on dyadic operands (x, e in multiples of 1/2, the weights of 1/4, b and
    g of 1/8): every sum is exact in float32 in any order, the routing
    compares equal operands, ties are frequent, and its four outputs must
    agree bitwise; then on the same operands with a real-valued g, which only the
    summation order of d_e, dW_e and d_b can tell apart (F32_RTOL of each
    output's scale); two runs must give the same bits."""
    dev = v1.recv.device
    on_card = dev.type == "cuda"
    gen = torch.Generator().manual_seed(seed)
    n, e_pad = v1.num_nodes, v1.recv.shape[0]
    layout = (v1.senders, v1.recv, v1.blocks)
    kw = dict(node_block=v1.node_block, edge_tile=v1.edge_tile)

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    def dyadic(*shape, lo=-2, hi=2, step=0.5):
        return (torch.randint(lo, hi + 1, shape, generator=gen)
                * step).float().to(dev)

    names = ("d_op", "d_e", "dW_e", "d_b")
    fwd_rows, bwd_rows = [], []
    for d, de, h in layer_shapes:
        fwd_bound, bwd_bound = _v1_bounds(v1, de, h)
        y_s = matmul_f32(rand(n, d), rand(d, h, scale=d ** -0.5))
        args = (y_s, rand(e_pad, de), rand(de, h, scale=de ** -0.5),
                rand(h), *layout, rand(n, h))
        got = ha.hoisted_fwd(*args, **kw)
        ref = ha.hoisted_fwd_plain(*args, **kw)
        got_vjp, inner = ha.hoisted_fwd(*args, **kw, emit_inner=True)
        _, ref_inner = ha.hoisted_fwd_plain(*args, **kw, emit_inner=True)
        if on_card:
            torch.cuda.synchronize()
        has = ref_inner > da._NEG / 2
        if not torch.isfinite(got).all() or not torch.equal(got_vjp, got) \
                or not torch.equal(inner > da._NEG / 2, has):
            raise AssertionError(f"hoisted_fwd_v1 at H={h}: output not "
                                 "finite, or VJP mode differs")
        err = max(float((got - ref).abs().max()),
                  float((inner[has] - ref_inner[has]).abs().max()))
        f_row = {"d_in": d, "d_e": de, "h": h, "max_abs_err": err,
                 "max_rel_err": err / max(float(ref.abs().max()), 1.0),
                 **fwd_bound}
        _timed(f_row, on_card, reps,
               ms=lambda: ha.hoisted_fwd(*args, **kw),
               vjp_ms=lambda: ha.hoisted_fwd(*args, **kw, emit_inner=True),
               plain_ms=lambda: ha.hoisted_fwd_plain(*args, **kw))

        # the backward on dyadic operands
        y_s = matmul_f32(dyadic(n, d), dyadic(d, h, step=0.25))
        ops = (y_s, dyadic(e_pad, de), dyadic(de, h, step=0.25),
               dyadic(h, lo=-8, hi=8, step=0.125))
        _, inner = ha.hoisted_fwd(*ops, *layout,
                                  torch.zeros((n, h), device=dev), **kw,
                                  emit_inner=True)
        has = inner > da._NEG / 2
        bargs = ops + layout + (torch.where(has, inner, 0.0), torch.where(
            has, dyadic(n, h, lo=-8, hi=8, step=0.125), 0.0))
        got = ha.hoisted_bwd(*bargs, **kw)
        ref = ha.hoisted_bwd_plain(*bargs, **kw)
        again = ha.hoisted_bwd(*bargs, **kw)
        bargs_g = bargs[:-1] + (torch.where(has, rand(n, h), 0.0),)
        real_g = [_own_scale_err(u, v) for u, v in
                  zip(ha.hoisted_bwd(*bargs_g, **kw),
                      ha.hoisted_bwd_plain(*bargs_g, **kw))]
        if on_card:
            torch.cuda.synchronize()
        errs = [_rel_err(u, v) for u, v in zip(got, ref)]
        same = all(torch.equal(u, v) for u, v in zip(got, again))
        b_row = {"d_in": d, "d_e": de, "h": h,
                 "max_abs_err": max(e[0] for e in errs),
                 "max_rel_err": max(e[1] for e in errs),
                 "bitwise_repeat": same,
                 "real_g_rel_err": dict(zip(names, real_g)), **bwd_bound}
        _timed(b_row, on_card, reps,
               ms=lambda: ha.hoisted_bwd(*bargs, **kw),
               plain_ms=lambda: ha.hoisted_bwd_plain(*bargs, **kw))
        out(f"kernel hoisted_fwd_v1 d_in={d} H={h}: max_abs_err={err:.3e} "
            f"max_rel_err={f_row['max_rel_err']:.3e} ms={f_row['ms']} "
            f"(VJP mode {f_row['vjp_ms']}) plain_ms={f_row['plain_ms']} "
            f"bound_ms={f_row['bound_ms']:.4f} ({f_row['bound_by']})")
        out(f"kernel hoisted_bwd_v1 d_in={d} H={h}: dyadic errors (abs) "
            + ", ".join(f"{nm} {e[0]:.3e}" for nm, e in zip(names, errs))
            + "; real-valued g, relative to each output's scale "
            + ", ".join(f"{nm} {e:.3e}" for nm, e in zip(names, real_g))
            + f"; bitwise repeat {same}; ms={b_row['ms']} plain_ms="
            f"{b_row['plain_ms']} bound_ms={b_row['bound_ms']:.4f} "
            f"({b_row['bound_by']})")
        if f_row["max_rel_err"] > F32_RTOL:
            raise AssertionError(f"hoisted_fwd_v1 disagrees with its plain "
                                 f"version at H={h}: {f_row['max_rel_err']}")
        if b_row["max_abs_err"] > 0.0 or max(real_g) > F32_RTOL or not same:
            raise AssertionError(f"hoisted_bwd_v1 disagrees with its plain "
                                 f"version at H={h}: dyadic {errs}, real g "
                                 f"{real_g}, bitwise repeat {same}")
        fwd_rows.append(f_row)
        bwd_rows.append(b_row)
    return fwd_rows, bwd_rows


def kernel_entry_points(dev, bench: Tuple[int, int, int, int], reps: int,
                        out: Callable = print) -> Dict:
    """The fourth phase's main path: `kernel_check` and `kernel_bench` (at
    `bench` = (edges, nodes, d_in, H)), with the launch counters set to 0
    just before and read just after. The four kernels no model path runs
    must launch as often as the two entry points call them (none off the
    card); the other kernels' launches (kernel_check's dense and windowed
    checks) are reported."""
    on_card = dev.type == "cuda"
    for c in _counters():
        c.launches = 0
    check = kernel_check.run(dev, out)
    bench_res = kernel_bench.run(dev, *bench, reps=reps, out=out)
    launches = dict(zip(KERNEL_NAMES, (c.launches for c in _counters())))
    # kernel_check: one linear, one segment-max, the forward through both
    # v1 factories, the kernel backward once; kernel_bench: its check, a
    # warm-up and `reps` timed calls of each path
    expected = _expect({"fused_linear": 1, "msg_segmax": 3 + reps,
                        "hoisted_fwd_v1": 2, "hoisted_bwd_v1": 1}, on_card)
    got = [launches[name] for name in KERNEL_NAMES]
    out(f"launches of kernel_check + kernel_bench ({', '.join(KERNEL_NAMES)})"
        f": {got} (the four from fused_linear on expected {expected[7:11]})")
    if got[7:11] != expected[7:11]:
        raise AssertionError(f"the kernel entry points launched {got[7:11]}, "
                             f"expected {expected[7:11]}")
    return {"entry_launches": launches, "kernel_check": check,
            "kernel_bench": bench_res}


def oracle_predictions(ground_truth: Dict, adapt: bool,
                       num_classes: int) -> Dict:
    """Perfect predictions from served frames' ground truth, as
    tests/test_postprocess.py builds them: probability 0.9 on the true
    class (0.01 on the others), and every object point regressing its
    object's box (the orientation sin-encoded where the configuration
    adapts it, the background rows 0)."""
    boxes, probs = [], []
    for bb, labels in zip(ground_truth["bounding_box_true"],
                          ground_truth["class_true"]):
        if adapt and bb.shape[1] == 5:
            bb = adapt_bb_orientation_angle(torch.from_numpy(bb)).numpy()
        boxes.append(np.nan_to_num(bb, nan=0.0))
        p = np.full((len(labels), num_classes), 0.01)
        p[np.arange(len(labels)), labels.astype(int)] = 0.9
        probs.append(p)
    return {"bounding_box_predictions": boxes,
            "class_probability_prediction": probs}


def _nms_matrix(boxes) -> np.ndarray:
    return boxes.to_xylwt() if boxes.is_rotated else boxes.to_two_point()


def eval_chain(dev: torch.device, config, predictions: Dict,
               ground_truth: Dict, pos: List, vel: List) -> Dict:
    """The evaluation stage on `dev`: each frame's boxes before NMS and
    the indices NMS keeps (timed), `Postprocessor.process`, the mAP engine
    under the configuration (timed) and in box-IoU mode on the same boxes
    (timed), and `RadarscenesEvaluator.evaluate`."""
    pre = [PredictionExtractor.get_absolute_object_bounding_box_predictions(
        c, b, p, config) for p, b, c in zip(
            pos, predictions["bounding_box_predictions"],
            predictions["class_probability_prediction"])]

    def timed(fn):
        # each timed call ends with its results on the host
        t0 = time.perf_counter()
        res = fn()
        return res, time.perf_counter() - t0

    kept, nms_s = timed(lambda: [
        nms_indices(_nms_matrix(boxes), scores[:, 0], config.iou_for_nms,
                    boxes.is_rotated, dev) if len(boxes)
        else np.zeros((0,), np.int64) for boxes, scores, _ in pre])
    bb_pred, bb_gt, cls_pred, cls_gt = Postprocessor(dev).process(
        config, pos, vel, predictions, ground_truth)
    res, map_s = timed(lambda: ObjectDetectionMetrics.get_map(
        config, bb_pred, bb_gt, cls_pred, dev))

    def box_iou_map():
        metric = MeanAveragePrecision([config.iou_for_mAP], device=dev)
        metric.update(ObjectDetectionMetrics._prediction_dicts(bb_pred),
                      ObjectDetectionMetrics._ground_truth_dicts(bb_gt),
                      is_aligned=not any(len(b["boxes"]) and b["boxes"]
                                         .is_rotated for b in bb_pred))
        return metric.compute()["map"]

    box_map, box_map_s = timed(box_iou_map)
    ev = RadarscenesEvaluator(config, device=dev)
    ev.evaluate(bb_pred, bb_gt, cls_pred,
                PredictionExtractor().extract(predictions), cls_gt)
    return {"pre": pre, "kept": kept, "bb_pred": bb_pred, "evaluator": ev,
            "map": float(res["map"]), "box_iou_map": float(box_map),
            "boxes_before_nms": [len(b) for b, _, _ in pre],
            "boxes_after_nms": [len(k) for k in kept],
            "nms_s": nms_s, "map_s": map_s, "box_iou_map_s": box_map_s}


def _chains_agree(card: Dict, cpu: Dict, label: str) -> Dict:
    """Holds the card's chain to the CPU's: the same kept indices and
    boxes, mAP (both modes) and F1 within EVAL_METRIC_ATOL, the same
    confusion matrix."""
    same_kept = all(np.array_equal(a, b)
                    for a, b in zip(card["kept"], cpu["kept"]))
    same_boxes = all(np.array_equal(a["boxes"].corners, b["boxes"].corners)
                     for a, b in zip(card["bb_pred"], cpu["bb_pred"]))
    ev_a, ev_b = card["evaluator"], cpu["evaluator"]
    d_map = max(abs(card["map"] - cpu["map"]),
                abs(card["box_iou_map"] - cpu["box_iou_map"]),
                abs(ev_a.mAP - ev_b.mAP))
    d_f1 = float(np.max(np.abs(np.asarray(ev_a.f1_segmentation)
                               - np.asarray(ev_b.f1_segmentation))))
    same_confusion = np.array_equal(ev_a.confusion_absolute,
                                    ev_b.confusion_absolute)
    if not (same_kept and same_boxes and same_confusion) \
            or not d_map <= EVAL_METRIC_ATOL or not d_f1 <= EVAL_METRIC_ATOL:
        raise AssertionError(
            f"the {label} evaluation on the card differs from the CPU's: "
            f"kept indices equal {same_kept}, boxes equal {same_boxes}, "
            f"max |dmAP| {d_map}, max |dF1| {d_f1}, confusion equal "
            f"{same_confusion}")
    return {"max_abs_dmap": d_map, "max_abs_df1": d_f1}


def evaluation_phase(dev: torch.device, model: DetNet, loader: List,
                     out: Callable = print) -> Dict:
    """The fifth phase: the kNN requests through `Predictor.predict`, then
    the evaluation stage under the flagship YAML's POSTPROCESSING (rotated
    boxes, NMS at IoU 0.01, point-IoU mAP at 0.3, translation invariance,
    the adapted orientation angle) on the real predictions and on oracle
    predictions built from the same frames' ground truth (mAP 1.0), each on
    `dev` and on the CPU (they must agree), with the evaluator's artifacts
    saved into a temporary folder; the rotated IoU of an oracle frame's
    jittered boxes on `dev` against the CPU's."""
    cfg = UserConfigurationReader.read_config_file(FLAGSHIP_CONFIG)
    config = UserConfigurationReader.get_config_object("POSTPROCESSING", cfg)
    num_classes = len(config.min_object_score) + 1
    predictions, ground_truth, pos, vel = Predictor(
        model, loader, verbose=False).predict()
    oracle = oracle_predictions(ground_truth, config.adapt_orientation_angle,
                                num_classes)
    cpu = torch.device("cpu")
    # the card's kernels load at their first call: a small NMS first
    nms_indices(np.asarray([[0, 0, 1, 1, 0.0]]), np.ones(1), 0.5, True, dev)
    res: Dict = {"card": card_description() if dev.type == "cuda" else None}
    with tempfile.TemporaryDirectory() as folder:
        for label, preds in (("real", predictions), ("oracle", oracle)):
            got = eval_chain(dev, config, preds, ground_truth, pos, vel)
            ref = eval_chain(cpu, config, preds, ground_truth, pos, vel)
            agree = _chains_agree(got, ref, label)
            saved = got["evaluator"].save_results(folder)
            files = sorted(os.listdir(saved))
            row = {k: got[k] for k in (
                "map", "box_iou_map", "boxes_before_nms", "boxes_after_nms",
                "nms_s", "map_s", "box_iou_map_s")}
            row.update(agree, artifacts=files,
                       f1=np.asarray(got["evaluator"].f1_segmentation)
                       .tolist())
            res[label] = row
            pre = got["pre"]
            out(f"evaluation ({label} predictions, {config.bb_invariance} "
                f"boxes, NMS at IoU {config.iou_for_nms}, point-IoU mAP at "
                f"{config.iou_for_mAP}) on {dev}: boxes before NMS "
                f"{row['boxes_before_nms']}, after {row['boxes_after_nms']}; "
                f"mAP {row['map']}, box-IoU mAP {row['box_iou_map']}; F1 "
                f"{row['f1']}; host s: NMS {row['nms_s']:.4f}, mAP engine "
                f"{row['map_s']:.4f}, box-IoU mAP engine "
                f"{row['box_iou_map_s']:.4f}; card vs CPU: kept indices and "
                f"confusion equal, max |dmAP| {agree['max_abs_dmap']:.2e}, "
                f"max |dF1| {agree['max_abs_df1']:.2e}; artifacts {files}; "
                f"card {res['card']}")
            for name in ("eval_configs.json", "eval_results.json",
                         "confusion_abs.npy", "confusion_rel.npy"):
                if name not in files:
                    raise AssertionError(f"save_results wrote no {name}")
    if res["oracle"]["map"] != 1.0:
        raise AssertionError(f"the oracle predictions give mAP "
                             f"{res['oracle']['map']}, not 1.0")
    # the oracle's boxes before NMS (at most 256), and the same jittered
    xylwt = np.concatenate([b.to_xylwt() for b, _, _ in pre if len(b)])[:256]
    jitter = np.random.default_rng(0).normal(
        scale=[0.5, 0.5, 0.2, 0.2, 20.0], size=xylwt.shape)
    boxes = np.concatenate([xylwt, xylwt + jitter]).astype(np.float32)
    boxes[:, 2:4] = np.abs(boxes[:, 2:4])
    t = torch.from_numpy(boxes)
    iou_card = rotated_iou_matrix(t.to(dev), t.to(dev)).cpu()
    iou_cpu = rotated_iou_matrix(t, t)
    d_iou = float((iou_card - iou_cpu).abs().max())
    res["rotated_iou"] = {"boxes": len(boxes), "max_abs_diff": d_iou,
                          "overlapping_pairs": int((iou_cpu > 0).sum())}
    out(f"rotated IoU of {len(boxes)} boxes (an oracle frame's, and the "
        f"same jittered) on {dev} vs the CPU: max |d| {d_iou:.2e} (limit "
        f"{EVAL_IOU_ATOL}), {res['rotated_iou']['overlapping_pairs']} "
        "overlapping pairs")
    if not d_iou <= EVAL_IOU_ATOL:
        raise AssertionError(f"the rotated IoU on {dev} differs from the "
                             f"CPU's by {d_iou}")
    return res


def _finish(proc: subprocess.Popen, timeout: float) -> Tuple[int, str, str]:
    """Waits for a child (killed past `timeout`); its code and output."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError(f"{proc.args} ran past {timeout} s")
    return proc.returncode, out, err


def bench_phase(dev: torch.device, points: int, graphs: int,
                out: Callable = print) -> List[Dict]:
    """The sixth phase: `python -m radargnn_tpu_torch.benchmarks.bench` as
    a child process for each (tiling, mode) of BENCH_CASES, 4 steps and one
    pair, one child at a time on the card. Off it (the rehearsal, which
    times nothing) the children run at once, one thread each, on
    `points` x `graphs` frames, one step, the windowed tiling's overflow
    budget raised to 0.5 (the spread tiler overflows ~40 % of a tiny
    frame's edges). Each child must exit 0 with a last line of the bench's
    keys and a finite value > 0."""
    on_card = dev.type == "cuda"

    def start(tiling: str, mode: str) -> subprocess.Popen:
        env = dict(os.environ, BENCH_TILING=tiling, BENCH_MODE=mode,
                   BENCH_STEPS="4", BENCH_PAIRS="1")
        if not on_card:
            env.update(BENCH_DEVICE="cpu", BENCH_POINTS=str(points),
                       BENCH_GRAPHS=str(graphs), BENCH_STEPS="1",
                       OMP_NUM_THREADS="1")
            if tiling == "windowed":
                env["BENCH_OVF_FRAC"] = "0.5"
        return subprocess.Popen(
            [sys.executable, "-m", "radargnn_tpu_torch.benchmarks.bench"],
            env=env, cwd=_REPO, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)

    groups = [[c] for c in BENCH_CASES] if on_card else [list(BENCH_CASES)]
    lines = []
    for group in groups:
        children = [(case, start(*case)) for case in group]
        try:
            results = [(case, _finish(proc, 900)) for case, proc in children]
        finally:
            for _, proc in children:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
        for (tiling, mode), (code, stdout, stderr) in results:
            if code != 0:
                raise AssertionError(f"the bench ({tiling}, {mode}) exited "
                                     f"{code}:\n{stderr[-3000:]}")
            stdout = stdout.strip().splitlines()
            last = json.loads(stdout[-1])
            if set(last) != BENCH_KEYS or not math.isfinite(last["value"]) \
                    or not last["value"] > 0:
                raise AssertionError(f"the bench ({tiling}, {mode}) ended "
                                     f"with {stdout[-1]!r}")
            out(f"bench ({tiling}, {mode}): " + " | ".join(stdout[-4:]))
            lines.append(dict(last, tiling=tiling, mode=mode,
                              runs=[json.loads(x) for x in stdout[-4:-2]]))
    return lines


# -- the seventh phase: the command-line pipeline ----------------------------

# RadarScenes' on-disk tables (the layout `tests/test_radarscenes_pipeline.py`
# writes): one row per detection, one per odometry pose
RADAR_DTYPE = np.dtype([
    ("timestamp", np.int64), ("sensor_id", np.uint8),
    ("range_sc", np.float32), ("azimuth_sc", np.float32),
    ("rcs", np.float32), ("vr", np.float32), ("vr_compensated", np.float32),
    ("x_cc", np.float32), ("y_cc", np.float32),
    ("x_seq", np.float32), ("y_seq", np.float32),
    ("uuid", "S32"), ("track_id", "S32"), ("label_id", np.uint8),
])
ODO_DTYPE = np.dtype([
    ("timestamp", np.int64), ("x_seq", np.float64), ("y_seq", np.float64),
    ("yaw_seq", np.float64), ("vx", np.float64), ("yaw_rate", np.float64),
])
# the moving objects of a raw sequence, one class each of the five:
# (raw label, name, length m, width m, speed m/s, points a scan, rcs dBsm)
RAW_OBJECTS = ((0, "car", 4.5, 1.8, 8.0, 6, 10.0),
               (7, "pedestrian", 0.6, 0.6, 1.4, 2, -8.0),
               (8, "pedestrian_group", 2.0, 1.5, 1.2, 4, -3.0),
               (5, "bicycle", 1.8, 0.6, 4.0, 3, 0.0),
               (2, "truck", 9.0, 2.5, 6.0, 10, 15.0))
SCAN_US = 70_000            # 70 ms between scans, over the 4 sensors
EGO_SPEED = 5.0             # m/s along x
# the CLI phase's raw data: three train sequences (indices 0-2, none of
# them in RADARSCENES_TEST_SPLIT_INDICES) and one validation sequence
CLI_SEQUENCES = (("sequence_1", "train"), ("sequence_2", "train"),
                 ("sequence_3", "train"), ("sequence_val_1", "validation"))
# the flagship YAML's fields the CLI phase replaces (a short run that
# checkpoints)
CLI_REPLACED = {"epochs": 2, "checkpoint_every_epochs": 1}
# the CLI phase's reader timing: a table of the order of a long RadarScenes
# sequence's radar_data (110 bytes a row, ~55 MB)
READER_ROWS = 500_000


def _raw_scan(rng, i: int, ts: int, objects: list, static: int,
              name: str) -> np.ndarray:
    """One scan of sensor i % 4 + 1: static clutter drawn in the car frame
    (a few points past the crop), each object's points inside its moving
    box, and one animal and one other point (dropped by the reduced
    labels). Radial velocities are along the sensor's line of sight."""
    t = i * SCAN_US * 1e-6
    ego = EGO_SPEED * t
    sensor = i % 4 + 1
    mount = SENSOR_MOUNTING[sensor]
    parts = []                                     # (x, y, v, label, track)
    xy = np.stack([rng.uniform(-2, 102, static),
                   rng.uniform(-51, 51, static)], axis=1)
    parts.append((xy, np.zeros((static, 2)), np.full(static, 11), b"",
                  rng.normal(-5, 5, static)))
    for k, (label, cls, length, width, speed, pts, rcs) in enumerate(
            RAW_OBJECTS):
        for j, (start, heading) in enumerate(objects[k]):
            d = np.array([np.cos(heading), np.sin(heading)])
            o = np.array([-d[1], d[0]])
            center = start + speed * t * d - [ego, 0.0]
            local = (rng.uniform(-0.5, 0.5, (pts, 1)) * length * d
                     + rng.uniform(-0.5, 0.5, (pts, 1)) * width * o)
            parts.append((center + local, np.tile(speed * d, (pts, 1)),
                          np.full(pts, label), f"{cls}_{j}".encode(),
                          rng.normal(rcs, 3, pts)))
    parts.append((np.array([[20.0, 5.0], [30.0, -5.0]]), np.zeros((2, 2)),
                  np.array([9, 10]), b"", rng.normal(0, 1, 2)))
    rows = np.zeros(sum(len(p[0]) for p in parts), RADAR_DTYPE)
    at = 0
    for xy, v, label, track, rcs in parts:
        sl = slice(at, at + len(xy))
        rel = xy - [mount["x"], mount["y"]]
        direction = np.arctan2(rel[:, 1], rel[:, 0])
        los = np.stack([np.cos(direction), np.sin(direction)], axis=1)
        vr_comp = (v * los).sum(1) + rng.normal(0, 0.05, len(xy))
        rows["x_cc"][sl], rows["y_cc"][sl] = xy[:, 0], xy[:, 1]
        rows["x_seq"][sl], rows["y_seq"][sl] = xy[:, 0] + ego, xy[:, 1]
        rows["range_sc"][sl] = np.hypot(rel[:, 0], rel[:, 1])
        rows["azimuth_sc"][sl] = direction - mount["yaw"]
        rows["vr_compensated"][sl] = vr_comp
        rows["vr"][sl] = vr_comp - EGO_SPEED * los[:, 0]
        rows["rcs"][sl] = rcs
        rows["label_id"][sl] = label
        rows["track_id"][sl] = track
        at += len(xy)
    rows["timestamp"] = ts
    rows["sensor_id"] = sensor
    rows["uuid"] = [f"{name}_{i}_{n}".encode() for n in range(len(rows))]
    return rows


def write_radarscenes(root: str, scans: int, points_per_scan: int,
                      seed: int = 0) -> None:
    """A RadarScenes-format dataset under `root`/raw/data: sequences.json,
    and a scenes.json and radar_data.h5 for each of CLI_SEQUENCES, with
    `scans` scans of about `points_per_scan` detections each. Every
    sequence has moving objects of all five classes (two of each at 300 or
    more points a scan, else one), each object with its own track id. The
    tables are written by the port's HDF5 writer (`data.hdf5`), in the
    layout h5py writes by default."""
    data = os.path.join(root, "raw", "data")
    per_class = 2 if points_per_scan >= 300 else 1
    object_points = per_class * sum(o[5] for o in RAW_OBJECTS)
    static = max(points_per_scan - object_points - 2, 0)
    sequences = {}
    for s, (name, category) in enumerate(CLI_SEQUENCES):
        rng = np.random.default_rng(seed + s)
        objects = [[(np.array([rng.uniform(15, 85), rng.uniform(-35, 35)]),
                     rng.uniform(0, 2 * np.pi)) for _ in range(per_class)]
                   for _ in RAW_OBJECTS]
        timestamps = 1_000_000 + np.arange(scans) * SCAN_US
        scenes, tables = {}, []
        odometry = np.zeros(scans, ODO_DTYPE)
        at = 0
        for i, ts in enumerate(timestamps):
            odometry[i] = (ts, EGO_SPEED * i * SCAN_US * 1e-6, 0.0, 0.0,
                           EGO_SPEED, 0.0)
            rows = _raw_scan(rng, i, int(ts), objects, static, name)
            scenes[str(int(ts))] = {"sensor_id": int(rows["sensor_id"][0]),
                                    "radar_indices": [at, at + len(rows)],
                                    "odometry_index": i}
            tables.append(rows)
            at += len(rows)
        folder = os.path.join(data, name)
        os.makedirs(folder)
        hdf5.write_datasets(os.path.join(folder, "radar_data.h5"),
                            {"radar_data": np.concatenate(tables),
                             "odometry": odometry})
        with open(os.path.join(folder, "scenes.json"), "w") as f:
            json.dump({"sequence_name": name, "category": category,
                       "scenes": scenes}, f)
        sequences[name] = {"category": category}
    with open(os.path.join(data, "sequences.json"), "w") as f:
        json.dump({"sequences": sequences}, f)


def write_processed(root: str, train: int, validate: int, points: int,
                    seed: int = 0) -> None:
    """The processed splits without raw data:
    `data.synthetic.make_samples` frames of `points` points under the
    flagship's graph construction, saved as `graph_<i>.npz` into
    `root`/processed/{train,validate}, with the dataset creation's
    config.json."""
    cfg = UserConfigurationReader.read_config_file(FLAGSHIP_CONFIG)
    graph_cfg = UserConfigurationReader.get_config_object(
        "GRAPH_CONSTRUCTION", cfg)
    dataset_cfg = UserConfigurationReader.get_config_object(
        "DATASET_PROCESSING", cfg)
    dataset = RadarScenesGraphDataset(root, graph_cfg, dataset_cfg,
                                      process=False)
    for i, (split, frames) in enumerate((("train", train),
                                         ("validate", validate))):
        folder = os.path.join(dataset.processed_dir, split)
        os.makedirs(folder)
        for j, sample in enumerate(make_samples(
                frames, points, seed=seed + i, graph_config=graph_cfg)):
            sample.save_npz(os.path.join(folder, f"graph_{j}.npz"))
    dataset.write_description(RadarScenesSplitConfiguration(
        standard_split=False,
        train_sequences=[n for n, c in CLI_SEQUENCES if c == "train"],
        validate_sequences=[n for n, c in CLI_SEQUENCES
                            if c == "validation"]))


def cli_config(folder: str, source: str = FLAGSHIP_CONFIG,
               replaced: Optional[Dict] = None,
               name: str = "config.yml") -> str:
    """The YAML `source` (the flagship's) with the fields of `replaced`
    (CLI_REPLACED) replaced, each field's whole value, written to
    `folder`/`name`."""
    with open(source) as f:
        text = f.read()
    for key, value in (CLI_REPLACED if replaced is None else replaced).items():
        # the value (as JSON, which YAML reads) replaces the rest of the line
        text, n = re.subn(rf"^(\s+{key}:) .*$",
                          lambda m: f"{m.group(1)} {json.dumps(value)}", text,
                          flags=re.MULTILINE)
        if n != 1:
            raise AssertionError(f"{source} has {n} {key} fields")
    path = os.path.join(folder, name)
    with open(path, "w") as f:
        f.write(text)
    return path


def _count_stages(stack: ExitStack, cli_main, names: Tuple[str, ...],
                  stages: Dict, epoch_s: List[float]) -> None:
    """Patches the stages `names` of `cli_main` so that each run of one
    leaves its seconds, its launches (the counters set to 0 just before it
    and read just after) and its result in `stages`[name], and
    `Trainer._train_epoch` so that each epoch's seconds land in
    `epoch_s`."""
    def counted(name: str, fn: Callable) -> Callable:
        def stage(*args, **kw):
            for c in _counters():
                c.launches = 0
            t0 = time.perf_counter()
            result = fn(*args, **kw)
            stages[name] = {"seconds": time.perf_counter() - t0,
                            "launches": [c.launches for c in _counters()],
                            "result": result}
            return result
        return stage

    train_epoch = Trainer._train_epoch

    def timed_epoch(self, *args, **kw):
        t0 = time.perf_counter()
        result = train_epoch(self, *args, **kw)
        epoch_s.append(time.perf_counter() - t0)
        return result

    for name in names:
        stack.enter_context(mock.patch.object(
            cli_main, name, counted(name, getattr(cli_main, name))))
    stack.enter_context(mock.patch.object(Trainer, "_train_epoch",
                                          timed_epoch))


def time_hdf5_reader(folder: str, rows: int = READER_ROWS) -> Dict:
    """The port's HDF5 reader (`data.hdf5.read_dataset`) timed on one
    contiguous table of `rows` rows of RADAR_DTYPE that its writer wrote
    into `folder` (the file cache warm: the file was just written), five
    reads; each must give the table back byte for byte."""
    rng = np.random.default_rng(0)
    table = np.zeros(rows, RADAR_DTYPE)
    for name in ("range_sc", "azimuth_sc", "rcs", "vr", "x_cc", "y_cc"):
        table[name] = rng.normal(0, 20, rows)
    table["timestamp"] = 1_000_000 + np.arange(rows) // 800 * SCAN_US
    table["label_id"] = rng.integers(0, 12, rows)
    table["uuid"] = [f"{i:032x}".encode() for i in range(rows)]
    path = os.path.join(folder, "reader_table.h5")
    hdf5.write_datasets(path, {"radar_data": table})
    seconds = []
    for _ in range(5):
        t0 = time.perf_counter()
        got = hdf5.read_dataset(path, "radar_data")
        seconds.append(time.perf_counter() - t0)
        if got.dtype != table.dtype or got.tobytes() != table.tobytes():
            raise AssertionError("the HDF5 reader did not give back the "
                                 "table its writer wrote")
    median = float(np.median(seconds))
    return {"rows": rows, "bytes": table.nbytes, "read_s": seconds,
            "median_s": median, "mb_per_s": table.nbytes / 1e6 / median}


def _tree_bytes(folder: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(folder) for f in files)


def cli_phase(dev: torch.device, points: int = RADIUS_POINTS,
              scans: Optional[int] = None, out: Callable = print) -> Dict:
    """The seventh phase: the command-line pipeline under the flagship YAML
    (CLI_REPLACED). It writes raw RadarScenes sequences through the port's
    HDF5 writer (`scans` scans each, 80 on the card, sized so a 0.5 s
    frame holds about `points` points), then runs `cli.main.main` in this
    process: create_dataset with the YAML's spawned workers, which read
    the sequences through the port's HDF5 reader and must launch no
    kernel, then train and evaluate. The kernel launches of each stage are
    counted apart (the counters set to 0 just before each and read just
    after); train's and evaluate's must be exactly the dense path's. Then
    `python -m radargnn_tpu_torch.cli.evaluate` runs as a child process
    (evaluation_02), and the model folder is evaluated on the CPU: its
    class probabilities and boxes must match the card's within the serving
    phase's tolerances. Last, the HDF5 reader is timed on one table of
    READER_ROWS rows (`time_hdf5_reader`)."""
    from radargnn_tpu_torch.cli import main as cli_main

    on_card = dev.type == "cuda"
    scans = scans or (80 if on_card else 24)
    # a frame takes 9 scans (the 0.5 s window and the scan past it); the
    # crop keeps ~94 % of the clutter
    per_scan = max(points * 10 // 85, 40)
    res: Dict = {"replaced": CLI_REPLACED,
                 "card": card_description() if on_card else None}
    stages: Dict = {}
    epoch_s: List[float] = []
    drawn: Dict = {}
    start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "radarscenes")
        results = os.path.join(tmp, "results")
        os.makedirs(results)
        config = cli_config(tmp)
        out(f"CLI phase: the flagship configuration with "
            f"{json.dumps(CLI_REPLACED)} replaced")
        t0 = time.perf_counter()
        write_radarscenes(root, scans, per_scan)
        res["raw_s"] = time.perf_counter() - t0
        res["raw_bytes"] = _tree_bytes(os.path.join(root, "raw"))
        with ExitStack() as stack:
            _count_stages(stack, cli_main,
                          ("create_dataset", "train", "evaluate"), stages,
                          epoch_s)
            _time_figures(stack, drawn)
            cli_main.main(root, results, config, device=dev)
        if stages["create_dataset"]["launches"] != [0] * len(KERNEL_NAMES):
            raise AssertionError(f"create_dataset launched "
                                 f"{stages['create_dataset']['launches']}")
        res["create_dataset_s"] = stages["create_dataset"]["seconds"]
        res.update(_check_cli_run(dev, root, results, config, stages,
                                  epoch_s, drawn, RADARSCENES_OUTPUTS, out))
        res["reader"] = time_hdf5_reader(tmp)
    res["phase_s"] = time.perf_counter() - start
    reader = res["reader"]
    out(f"CLI phase on {dev}: frames train {res['frames']['train']}, "
        f"validate {res['frames']['validate']}; points per frame "
        f"{res['points'][0]}-{res['points'][1]}; valid edges per train "
        f"batch {res['train_batch_edges']}; create_dataset "
        f"{res['create_dataset_s']:.2f} s on {res['raw_bytes']} raw bytes "
        f"(raw sequences written in {res['raw_s']:.2f} s); train s per "
        f"epoch {[round(t, 3) for t in res['train_epoch_s']]} (train stage "
        f"{res['train_s']:.2f} s); evaluate {res['evaluate_s']:.2f} s "
        f"(child process {res['child_evaluate_s']:.2f} s); the phase "
        f"{res['phase_s']:.2f} s; mAP {res['map']}, F1 {res['f1']}; card "
        f"{res['card']}")
    out(f"CLI phase: the HDF5 reader on {reader['rows']} rows of "
        f"RADAR_DTYPE ({reader['bytes']} bytes, contiguous, written by "
        f"data.hdf5.write_datasets, file cache warm): median "
        f"{reader['median_s'] * 1e3:.2f} ms of {len(reader['read_s'])} "
        f"reads ({reader['mb_per_s']:.0f} MB/s); create_dataset "
        f"{res['create_dataset_s']:.2f} s, {res['raw_bytes']} raw bytes "
        f"read; card {res['card']}")
    return res


CLI_MODEL_FILES = ("gnn_configs.json", "dataset_configs.json",
                   "trained_model.msgpack", "loss_train.npy",
                   "loss_validation.npy", "loss_train_cls.npy",
                   "loss_train_bb.npy", "loss_curves.png")
CLI_EVAL_BATCH = 8          # the evaluate CLI's default batch size
# the figures the CLI runs draw with the port's own figure code: their
# sizes as (height, width), the prediction plots the evaluate child and
# the CPU evaluation draw (`--plot`), and the least share of non-white
# pixels a figure must have
FIGURE_SIZES = {"loss_curves.png": (480, 640), "confusion.png": (600, 600),
                "prediction": (480, 640)}
CLI_PLOTS = 2
FIGURE_MIN_INK = 0.01


class EvalOutputs(NamedTuple):
    """What a dataset's evaluator adds to the CLI checks both phases share:
    the files it writes beside eval_results.json and the confusion
    matrices, a check of those files (given the evaluation folder), and
    its scores beside F1 (given the evaluator)."""

    files: Tuple[str, ...]
    check: Callable[[str], None]
    scores: Callable[[object], Dict]


RADARSCENES_OUTPUTS = EvalOutputs((), lambda folder: None,
                                  lambda ev: {"map": ev.mAP})


def _time_figures(stack: ExitStack, drawn: Dict) -> None:
    """Patches `Figure.savefig` so that each figure written leaves its
    seconds (layout, rasterising and the PNG) in `drawn`[path]."""
    from radargnn_tpu_torch.postprocess.figure import Figure
    savefig = Figure.savefig

    def timed(fig, path):
        t0 = time.perf_counter()
        savefig(fig, path)
        drawn[os.path.realpath(path)] = time.perf_counter() - t0

    stack.enter_context(mock.patch.object(Figure, "savefig", timed))


def check_figure(path: str) -> Dict:
    """A figure the CLI wrote, read back with the port's PNG reader: its
    size must be FIGURE_SIZES' for its name and its share of non-white
    pixels above FIGURE_MIN_INK. Its bytes, size and ink share."""
    from radargnn_tpu_torch.utils import png
    name = os.path.basename(path)
    want = FIGURE_SIZES["prediction" if name.startswith("prediction_")
                        else name]
    image = png.read_png(path)
    ink = float((image[..., :3] < 255).any(axis=-1).mean())
    if image.shape != (*want, 4) or not ink > FIGURE_MIN_INK:
        raise AssertionError(f"{path}: a {image.shape} image with "
                             f"{ink:.4f} of its pixels inked, want "
                             f"{(*want, 4)} and more than {FIGURE_MIN_INK}")
    return {"bytes": os.path.getsize(path), "shape": list(image.shape),
            "ink": ink}


def _check_cli_run(dev: torch.device, root: str, results: str, config: str,
                   stages: Dict, epoch_s: List[float], drawn: Dict,
                   outputs: EvalOutputs, out: Callable) -> Dict:
    """The CLI phase's checks after cli.main: each stage's launches, the
    model folder's files and losses, the checkpoint, the evaluation
    folder's files (`outputs`); then the evaluate CLI as a child process
    with `--plot CLI_PLOTS`, and the model folder evaluated on the CPU
    (its prediction plots drawn too) against the card's predictions.
    Every figure is read back (`check_figure`); those drawn in this
    process have their seconds in `drawn` (`_time_figures`)."""
    from radargnn_tpu_torch.cli import evaluate as cli_evaluate
    from radargnn_tpu_torch.data.loader import load_split_samples

    on_card = dev.type == "cuda"
    cfg = UserConfigurationReader.read_config_file(config)
    arch = UserConfigurationReader.get_config_object("MODEL_ARCHITECTURE", cfg)
    train_cfg = UserConfigurationReader.get_config_object("TRAINING", cfg)
    layers = len(arch.conv_layer_dimensions)
    samples = {s: load_split_samples(os.path.join(root, "processed"), s)
               for s in ("train", "validate")}
    n_train, n_val = len(samples["train"]), len(samples["validate"])
    nodes = [s.num_nodes for ss in samples.values() for s in ss]
    if not n_train or not n_val:
        raise AssertionError(f"the CLI phase made {n_train} train and "
                             f"{n_val} validate frames")
    steps = train_cfg.epochs * -(-n_train // train_cfg.batch_size)
    forwards = steps + train_cfg.epochs * -(-n_val // train_cfg.batch_size)
    served = -(-n_val // CLI_EVAL_BATCH)
    expected = {
        "train": _expect({"dense_proj_v4": layers * forwards,
                          "dense_fwd_v4": layers * forwards,
                          "dense_bwd_v4": layers * steps}, on_card),
        "evaluate": _expect({"dense_proj_v4": layers * served,
                             "dense_fwd_v4": layers * served}, on_card)}
    res: Dict = {}
    for name, want in expected.items():
        got = stages[name]["launches"]
        res[f"{name}_launches"] = got
        out(f"launches in the CLI's {name} ({', '.join(KERNEL_NAMES)}): "
            f"{got} (expected {want})")
        if got != want:
            raise AssertionError(f"the CLI's {name} launched {got}, "
                                 f"expected {want}")

    model = os.path.join(results, "model_01")
    files = set(os.listdir(model))
    want_files = set(CLI_MODEL_FILES)
    low_val = [f for f in files if f.startswith("trained_model_low_val_ep")]
    if not want_files <= files or len(low_val) != 1:
        raise AssertionError(f"the model folder holds {sorted(files)}")
    losses = {name: np.load(os.path.join(model, f"{name}.npy"))
              for name in ("loss_train", "loss_validation")}
    for name, value in losses.items():
        if value.shape != (1, train_cfg.epochs) or \
                not np.isfinite(value).all():
            raise AssertionError(f"{name}: {value}")
    if train_cfg.checkpoint_every_epochs:
        with open(os.path.join(results, "_checkpoint", "meta.json")) as f:
            meta = json.load(f)
        if meta["epoch"] != train_cfg.epochs:
            raise AssertionError(f"the checkpoint is of epoch "
                                 f"{meta['epoch']}")
    _check_eval_folder(os.path.join(model, "evaluation_01"), outputs)

    # the evaluate CLI as a user runs it, in a child process
    cmd = [sys.executable, "-m", "radargnn_tpu_torch.cli.evaluate",
           "--data", root, "--model", model, "--config", config,
           "--plot", str(CLI_PLOTS)]
    t0 = time.perf_counter()
    code, _, stderr = _finish(subprocess.Popen(
        cmd + ([] if on_card else ["--device", "cpu"]), cwd=_REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), 600)
    child_s = time.perf_counter() - t0
    if code != 0 or not os.path.isfile(os.path.join(
            model, "evaluation_02", "eval_results.json")):
        raise AssertionError(f"{' '.join(cmd)} exited {code} and wrote "
                             f"{sorted(os.listdir(model))}:\n{stderr[-3000:]}")
    _check_eval_folder(os.path.join(model, "evaluation_02"), outputs,
                       CLI_PLOTS)

    # the same model folder on the CPU, its prediction plots timed here
    card = stages["evaluate"]["result"]
    with ExitStack() as stack:
        _time_figures(stack, drawn)
        cpu = cli_evaluate.main(root, model, config,
                                plot_predictions=CLI_PLOTS, device="cpu")
    _check_eval_folder(cpu["eval_folder"], outputs, CLI_PLOTS)
    figures = {}
    for path in [os.path.join(model, "loss_curves.png"),
                 *sorted(glob.glob(os.path.join(model, "evaluation_*",
                                                "*.png")))]:
        figures[os.path.relpath(path, model)] = dict(
            check_figure(path), draw_s=drawn.get(os.path.realpath(path)))
    out(f"figures of the CLI run, drawn and written on the host by the "
        f"port's figure code (frames of {min(nodes)}-{max(nodes)} points; "
        f"card {card_description() if on_card else None}): "
        + "; ".join(f"{k} {v['bytes']} bytes, ink {v['ink']:.4f}, "
                    + (f"{v['draw_s']:.4f} s" if v["draw_s"] is not None
                       else "drawn in the child")
                    for k, v in figures.items()))
    worst_p = worst_b = 0.0
    pred, ref = card["predictions"], cpu["predictions"]
    for p, q, b, c in zip(pred["class_probability_prediction"],
                          ref["class_probability_prediction"],
                          pred["bounding_box_predictions"],
                          ref["bounding_box_predictions"]):
        worst_p = max(worst_p, float(np.abs(p - q).max()))
        worst_b = max(worst_b, float((np.abs(b - c) / (1 + np.abs(c))).max()))
    scores = [dict(outputs.scores(r["evaluator"]), f1=np.asarray(
        r["evaluator"].f1_segmentation).tolist()) for r in (card, cpu)]
    out(f"CLI evaluation on {dev} vs the CPU over {n_val} validate frames: "
        f"max |dprob| {worst_p:.3e} (atol {MODEL_ATOL_PROB}), max "
        f"|dbox|/(1+|box|) {worst_b:.3e} (rtol {MODEL_RTOL_BOX}); "
        + "; ".join(f"{k} {scores[0][k]} / {scores[1][k]}"
                    for k in scores[0]))
    if len(pred["class_probability_prediction"]) != n_val \
            or worst_p > MODEL_ATOL_PROB or worst_b > MODEL_RTOL_BOX:
        raise AssertionError("the card's evaluation of the model folder "
                             "disagrees with the CPU's")

    size = train_cfg.batch_size
    edges = [sum(s.num_edges for s in samples["train"][i:i + size])
             for i in range(0, n_train, size)]
    res.update(frames={"train": n_train, "validate": n_val},
               points=(min(nodes), max(nodes)), train_batch_edges=edges,
               train_epoch_s=epoch_s,
               train_s=stages["train"]["seconds"],
               evaluate_s=stages["evaluate"]["seconds"],
               child_evaluate_s=child_s, figures=figures, **scores[0],
               **{f"cpu_{k}": v for k, v in scores[1].items()},
               max_abs_dprob=worst_p,
               max_rel_dbox=worst_b, losses={k: v[0].tolist()
                                             for k, v in losses.items()})
    return res


def _check_eval_folder(folder: str, outputs: EvalOutputs,
                       plots: int = 0) -> None:
    """An evaluation folder holds the evaluator's files with finite
    numbers: eval_results.json (mAP where the configuration asks for it,
    F1), confusion.png, the dataset's own files (`outputs`), which its
    check reads, and `plots` prediction plots."""
    want = {"eval_configs.json", "eval_results.json", "confusion_abs.npy",
            "confusion_rel.npy", "confusion.png", *outputs.files,
            *(f"prediction_{i:03d}.png" for i in range(plots))}
    files = set(os.listdir(folder))
    if not want <= files:
        raise AssertionError(f"{folder} holds {sorted(files)}, not "
                             f"{sorted(want)}")
    with open(os.path.join(folder, "eval_results.json")) as f:
        metrics = json.load(f)
    det = metrics["OBJECT_DETECTION_METRICS"]
    f1 = metrics["SEMANTIC_SEGMENTATION_METRICS"]["f1"]
    if not (np.isfinite(det.get("mAP", 0.0)) and np.isfinite(f1).all()):
        raise AssertionError(f"eval_results.json: {metrics}")
    outputs.check(folder)


# -- the eighth phase: the nuScenes pipeline ---------------------------------

NUSCENES_CONFIG = os.path.join(_REPO, "configurations",
                               "configuration_nuscenes.yml")
# the nuScenes YAML's field the phase replaces (a short run)
NUSCENES_REPLACED = {"epochs": 2}
# the phase's scenes: (split, index in it, samples); two train scenes of
# 32 samples (two train batches of the YAML's 32) and one val scene of 16
NUSCENES_SCENES = (("train_detect", 0, 32), ("train_detect", 1, 32),
                   ("val", 0, 16))
NUSCENES_SWEEP_POINTS = 64  # returns a radar sweep; 5 radars x 6 sweeps
# the oracle's chains on the card and on the CPU: the same kept boxes, and
# metrics within this
NUSCENES_METRIC_ATOL = 1e-6
NUSCENES_ORACLE_MIN_AP = 0.9


def _check_nuscenes_metrics(folder: str) -> None:
    """nuscenes_metrics.json holds mean_ap and nd_score in [0, 1]."""
    with open(os.path.join(folder, "nuscenes_metrics.json")) as f:
        nusc = json.load(f)
    if not all(0.0 <= nusc[k] <= 1.0 for k in ("mean_ap", "nd_score")):
        raise AssertionError(f"nuscenes_metrics.json: {nusc}")


NUSCENES_OUTPUTS = EvalOutputs(
    ("submission.json", "nuscenes_metrics.json"), _check_nuscenes_metrics,
    lambda ev: {"map": ev.metrics_summary["mean_ap"],
                "nds": ev.metrics_summary["nd_score"]})


def nuscenes_scenes(scale: float = 1.0) -> List[Tuple[str, str, int]]:
    """NUSCENES_SCENES as write_nuscenes_tables takes them: the scene
    tokens from the split tables the dataset creation reads (the vendored
    tokens on an install without the devkit), so that the YAML's
    v1.0-trainval splits find them; `scale` cuts the samples."""
    from radargnn_tpu_torch.data.nuscenes import splits
    return [(getattr(splits, split)[i], f"scene-{9001 + n}",
             max(int(samples * scale), 2))
            for n, (split, i, samples) in enumerate(NUSCENES_SCENES)]


def _nuscenes_oracle(dev: torch.device, root: str, config_path: str,
                     folder: str, out: Callable) -> Dict:
    """Predictions built from the validate frames' stored ground truth
    (probability 0.9 on the true class, each object point regressing its
    box), through the Postprocessor (NMS) and the NuscenesEvaluator on
    `dev` and on the CPU: the same kept boxes, and label_aps, mean_ap,
    nd_score and tp_errors within NUSCENES_METRIC_ATOL; every class in the
    validate split scores AP > NUSCENES_ORACLE_MIN_AP."""
    from radargnn_tpu_torch.data.nuscenes.evaluation import NuscenesEvaluator
    from radargnn_tpu_torch.data.nuscenes.submission import DETECTION_NAMES
    from radargnn_tpu_torch.graph.batch import GraphSample

    cfg = UserConfigurationReader.read_config_file(config_path)
    config = UserConfigurationReader.get_config_object("POSTPROCESSING", cfg)
    version = cfg["CREATE_DATASET"]["DATASET_PROCESSING"]["version"]
    names = sorted(glob.glob(os.path.join(root, "processed", config.split,
                                          "*.npz")))
    samples = [GraphSample.load_npz(n) for n in names]
    ground_truth = {"bounding_box_true": [s.boxes.astype(np.float64)
                                          for s in samples],
                    "class_true": [s.labels.astype(np.float64)
                                   for s in samples]}
    pos = [s.pos.astype(np.float64) for s in samples]
    vel = [s.vel.astype(np.float64) for s in samples]
    preds = oracle_predictions(ground_truth, config.adapt_orientation_angle,
                               len(config.min_object_score) + 1)
    runs = []
    for i, d in enumerate((dev, torch.device("cpu"))):
        bb_pred, bb_gt, cls_pred, cls_gt = Postprocessor(d).process(
            config, pos, vel, preds, ground_truth)
        model = os.path.join(folder, f"oracle_{i}")
        os.makedirs(model)
        ev = NuscenesEvaluator(config=config, version=version,
                               dataset_path=os.path.join(root, "raw"),
                               model_path=model, device=d)
        ev.evaluate(bb_pred, bb_gt, cls_pred,
                    PredictionExtractor().extract(preds), cls_gt, vel,
                    graph_names=names)
        runs.append((bb_pred, ev.metrics_summary))
    (card_boxes, got), (cpu_boxes, want) = runs
    same_boxes = all(np.array_equal(a["boxes"].corners, b["boxes"].corners)
                     for a, b in zip(card_boxes, cpu_boxes))
    diffs = [abs(got[k] - want[k]) for k in ("mean_ap", "nd_score")]
    for k in ("label_aps", "tp_errors"):
        diffs += [abs(got[k][c] - want[k][c]) for c in want[k]
                  if not (np.isnan(got[k][c]) and np.isnan(want[k][c]))]
    present = sorted({DETECTION_NAMES[int(c)] for s in samples
                      for c in np.unique(s.labels) if c > 0})
    aps = {c: got["label_aps"][c] for c in present}
    res = {"kept_boxes": [len(b["boxes"]) for b in card_boxes],
           "max_abs_dmetric": max(diffs), "label_aps": aps,
           "mean_ap": got["mean_ap"], "nd_score": got["nd_score"]}
    out(f"nuScenes oracle on {dev} vs the CPU over {len(samples)} validate "
        f"frames: kept boxes {res['kept_boxes']} (equal {same_boxes}); "
        f"max |dmetric| {res['max_abs_dmetric']:.2e} (atol "
        f"{NUSCENES_METRIC_ATOL}); AP of the classes present {aps}; mAP "
        f"{got['mean_ap']}, NDS {got['nd_score']}")
    if not same_boxes or not res["max_abs_dmetric"] <= NUSCENES_METRIC_ATOL:
        raise AssertionError("the nuScenes oracle on the card differs from "
                             "the CPU's")
    low = {c: ap for c, ap in aps.items() if not ap > NUSCENES_ORACLE_MIN_AP}
    if len(present) < 5 or low:
        raise AssertionError(f"the nuScenes oracle: classes {present}, AP "
                             f"at or below {NUSCENES_ORACLE_MIN_AP}: {low}")
    return res


def nuscenes_phase(dev: torch.device, scale: float = 1.0,
                   points_per_sweep: int = NUSCENES_SWEEP_POINTS,
                   replaced: Optional[Dict] = None, seed: int = 0,
                   reps: int = 20, out: Callable = print) -> Dict:
    """The eighth phase: the nuScenes pipeline under the nuScenes YAML with
    the fields of `replaced` (NUSCENES_REPLACED) replaced. It writes
    nuScenes-format tables and multisweep radar sweeps
    (`benchmarks.nuscenes_e2e.write_nuscenes_tables`: NUSCENES_SCENES,
    their samples cut by `scale` off the card), then runs `cli.main.main`
    in this process: create_dataset, train, evaluate, each stage's
    launches counted apart, train's and evaluate's exactly the dense
    path's and create_dataset's none. Then the evaluate CLI runs as a
    child process, the model folder is evaluated on the CPU against the
    card, and oracle predictions go through the card's and the CPU's NMS
    and NuscenesEvaluator (`_nuscenes_oracle`). B1 and B2 are then held
    against their plain versions at the model's layer shapes on the
    train CLI's first batch (`check_routed_kernels`: the YAML's batch of
    multisweep frames, its dense tiling and overflow list). Last,
    `python -m radargnn_tpu_torch.benchmarks.nuscenes_e2e` runs as a
    child process, alone, and must exit 0 with its final line."""
    from radargnn_tpu_torch.benchmarks.nuscenes_e2e import (
        write_nuscenes_tables,
    )
    from radargnn_tpu_torch.cli import main as cli_main
    from radargnn_tpu_torch.cli.evaluate import load_model
    from radargnn_tpu_torch.cli.train import resolve_tiling
    from radargnn_tpu_torch.data.loader import get_data_loaders

    on_card = dev.type == "cuda"
    replaced = NUSCENES_REPLACED if replaced is None else replaced
    res: Dict = {"replaced": replaced,
                 "card": card_description() if on_card else None}
    stages: Dict = {}
    epoch_s: List[float] = []
    drawn: Dict = {}
    start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "nuscenes")
        results = os.path.join(tmp, "results")
        os.makedirs(results)
        config = cli_config(tmp, NUSCENES_CONFIG, replaced, "nuscenes.yml")
        cfg = UserConfigurationReader.read_config_file(config)
        dataset_cfg = UserConfigurationReader.get_config_object(
            "DATASET_PROCESSING", cfg)
        train_cfg = UserConfigurationReader.get_config_object("TRAINING", cfg)
        out(f"nuScenes phase: the nuScenes configuration with "
            f"{json.dumps(replaced)} replaced")
        t0 = time.perf_counter()
        write_nuscenes_tables(root, nuscenes_scenes(scale),
                              version=dataset_cfg.version,
                              sweeps=dataset_cfg.nsweeps,
                              points_per_sweep=points_per_sweep)
        res["raw_s"] = time.perf_counter() - t0
        with ExitStack() as stack:
            _count_stages(stack, cli_main,
                          ("create_dataset", "train", "evaluate"), stages,
                          epoch_s)
            _time_figures(stack, drawn)
            cli_main.main(root, results, config, device=dev)
        if stages["create_dataset"]["launches"] != [0] * len(KERNEL_NAMES):
            raise AssertionError(f"create_dataset launched "
                                 f"{stages['create_dataset']['launches']}")
        res["create_dataset_s"] = stages["create_dataset"]["seconds"]
        res.update(_check_cli_run(dev, root, results, config, stages,
                                  epoch_s, drawn, NUSCENES_OUTPUTS, out))
        res["oracle"] = _nuscenes_oracle(dev, root, config, tmp, out)

        # B1 and B2 on the train CLI's first batch, as its loader makes it
        loaders, _ = get_data_loaders(
            ["train", "validate"], os.path.join(root, "processed"),
            train_cfg.batch_size, train_cfg.shuffle,
            bg_index=train_cfg.bg_index, seed=train_cfg.seed,
            csr_tiling=resolve_tiling(
                UserConfigurationReader.get_config_object(
                    "MODEL_ARCHITECTURE", cfg), cfg), device=dev)
        batch = next(iter(loaders["train"]))
        res["train_tiling"] = _tiling_report(batch)
        res["validate_tiling"] = _tiling_report(next(iter(
            loaders["validate"])))
        tiling = batch.flat_tiling()
        out(f"nuScenes phase: B1 and B2 on the first train batch "
            f"({len(res['train_tiling']['valid_edges'])} frames, "
            f"{tiling.landing[1].shape[0] - 1} nodes, "
            f"{sum(res['train_tiling']['valid_edges'])} valid edges, "
            f"overflow edges per frame max "
            f"{max(res['train_tiling']['overflow_edges'])} of "
            f"{res['train_tiling']['overflow_budget']})")
        shapes = _layer_shapes(load_model(os.path.join(results, "model_01"),
                                          dev))
        with torch.no_grad():
            (res["per_shape_proj"], res["per_shape"],
             res["per_shape_bwd"]) = check_routed_kernels(
                tiling, shapes, seed, reps, out)

    # the e2e as a user runs it, alone on the card and the host
    cmd = [sys.executable, "-m", "radargnn_tpu_torch.benchmarks.nuscenes_e2e"]
    env = dict(os.environ)
    if not on_card:
        cmd += ["--device", "cpu"]
        env["OMP_NUM_THREADS"] = "1"
    t0 = time.perf_counter()
    code, stdout, stderr = _finish(subprocess.Popen(
        cmd, cwd=_REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True), 600)
    res["e2e_s"] = time.perf_counter() - t0
    last = stdout.strip().splitlines()[-1:] or [""]
    if code != 0 or not last[0].startswith("NUSC-TORCH ok:"):
        raise AssertionError(f"{' '.join(cmd)} exited {code}:\n"
                             f"{stdout[-2000:]}\n{stderr[-3000:]}")
    res["e2e"] = last[0]
    res["phase_s"] = time.perf_counter() - start
    ovf = res["validate_tiling"].get("overflow_edges")
    out(f"nuScenes phase on {dev}: samples train {res['frames']['train']}, "
        f"validate {res['frames']['validate']}; points per sample "
        f"{res['points'][0]}-{res['points'][1]}; valid edges per train "
        f"batch {res['train_batch_edges']}; dense tiling overflow edges per "
        f"validate frame max {max(ovf) if ovf else None} of "
        f"{res['validate_tiling'].get('overflow_budget')}; create_dataset "
        f"{res['create_dataset_s']:.2f} s (tables and sweeps written in "
        f"{res['raw_s']:.2f} s); train s per epoch "
        f"{[round(t, 3) for t in res['train_epoch_s']]} (train stage "
        f"{res['train_s']:.2f} s); evaluate {res['evaluate_s']:.2f} s "
        f"(child process {res['child_evaluate_s']:.2f} s); e2e child "
        f"{res['e2e_s']:.2f} s; the phase {res['phase_s']:.2f} s; mAP "
        f"{res['map']}, NDS {res['nds']}, F1 {res['f1']}; e2e child: "
        f"{res['e2e']}; card {res['card']}")
    return res


BENCH_SIZE = (450_560, 22_528, 464, 464)   # kernel_bench's defaults


# the ninth phase's per-shape rows the smoke's JSON line carries
VARIANT_ROWS = ("dense_bits", "windowed_bits", "ovf_landing",
                "windowed_landing", "r_tile_8", "r_tile_24")


def kernel_entry(name, source, replaces, launches, rows, checked, library,
                 on_card: bool) -> Dict:
    """One kernel's entry of the kernels line: `rows` one step's launches
    (one per layer shape) whose times and bounds it sums, `checked` every
    row whose error it reports, `library` whether the rows time a library
    call."""
    return {
        "name": name, "route": "cuda",
        "source": f"radargnn_tpu_torch/csrc/{source}",
        "replaces": f"radargnn_tpu/ops/pallas_kernels.py:{replaces}",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in checked),
        "ms": sum(r["ms"] for r in rows) if on_card else None,
        "plain_ms": sum(r["plain_ms"] for r in rows) if on_card else None,
        "bound_ms": sum(r["bound_ms"] for r in rows),
        "bound_by": ("operations" if sum(r["ops_ms"] for r in rows)
                     >= sum(r["bytes_ms"] for r in rows) else "bytes"),
        "library_ms": (sum(r["library_ms"] for r in rows)
                       if library and on_card else None),
    }


def run(device: DeviceLike = None, points: int = 2816, graphs: int = 5,
        batches: int = 3, seed: int = 0, reps: int = 20,
        train_steps: int = 4, bench: Tuple[int, int, int, int] = BENCH_SIZE,
        out: Callable = print) -> Dict:
    """Runs every phase; returns the summary (also printed as JSON lines).

    `points`/`graphs` size the synthetic frames (the serving and training
    batch is 5 graphs of 2816 points); `batches` is the number of requests
    served, `train_steps` the train steps of each training run (the first
    is a warm-up, the rest are timed). The kNN path (dense tiling) runs
    first, then the radius path (windowed tiling), then the kNN graph
    under the CSR tiling, then the fourth phase: the four kernels no model
    path runs, held against their plain versions at the flagship's widths
    on the kNN batch, then their entry points `kernel_check` and
    `kernel_bench` (at `bench` = (edges, nodes, d_in, H)); then the
    evaluation stage and the bench; then, on the card, the CLI pipeline
    (frames of about `points` points), the nuScenes pipeline
    (`nuscenes_phase`), the ninth phase (`smoke_variants.variants_phase`)
    and the tenth (`smoke_parallel.parallel_phase`), each rehearsed off the
    card by a test of its own."""
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
        proj_rows, fwd_rows, bwd_rows = check_routed_kernels(
            tiling, shapes, seed, reps, out)
    dense = ("dense_proj_v4", "dense_fwd_v4")
    summary.update(_serve_phase(
        dev, arch, model, loader, graphs, points,
        _expect({n: layers * batches for n in dense}, on_card), "kNN", out))
    summary.update(_train_phase(
        dev, arch, loader[0], seed, train_steps,
        _expect({n: layers * train_steps for n in dense + ("dense_bwd_v4",)},
                on_card), "kNN", out, witness=True))

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
        (radius["per_shape_proj"], radius["per_shape_fwd"],
         radius["per_shape_bwd"]) = check_routed_kernels(
            r_tiling, shapes, seed, reps, out, exact=True)
        (_, radius["knn_per_shape_fwd"],
         radius["knn_per_shape_bwd"]) = check_routed_kernels(
            knn_tiling, shapes, seed, reps, out, exact=True)
        # B3 left the windowed path; its layout check and timing stay here
        radius["knn_per_shape_segsum"] = check_landing(knn_tiling, shapes,
                                                       seed, reps, out)
    windowed = ("dense_proj_v4", "windowed_fwd_v3")
    radius.update(_serve_phase(
        dev, r_arch, r_model, r_loader, graphs, points,
        _expect({n: layers * batches for n in windowed}, on_card), "radius",
        out))
    radius.update(_train_phase(
        dev, r_arch, r_loader[0], seed, train_steps,
        _expect({n: layers * train_steps
                 for n in windowed + ("windowed_bwd_v3",)}, on_card),
        "radius", out, witness=True))
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
    csr_fwd = ("dense_proj_v4", "csr_fwd_v2")
    csr.update(_serve_phase(
        dev, c_arch, c_model, c_loader, graphs, points,
        _expect({n: layers * batches for n in csr_fwd}, on_card), "CSR",
        out))
    csr.update(_train_phase(
        dev, c_arch, c_loader[0], seed, train_steps,
        # the forward's node projection, which the backward reuses; dW_s
        # from the sender sums of d_op (a second landing a layer)
        _expect(dict({n: layers * train_steps
                      for n in csr_fwd + ("csr_bwd_v2",)},
                     segment_sum_csr=2 * layers * train_steps), on_card),
        "CSR", out, witness=True))
    summary["csr"] = csr

    # -- the kernels no model path runs: fused linear, segment-max, v1 ------
    v1 = v1_tiling(loader[0])
    wide = max(shapes, key=lambda s: s[2])
    nodes = v1.num_nodes
    out(f"fourth phase: the kNN batch under the v1 tiles ({v1.node_block} "
        f"nodes x {v1.edge_tile} slots): {v1.recv.shape[0]} slots, "
        f"{v1.valid_slots} valid, {v1.blocks.shape[0]} tiles")
    last: Dict = {}
    with torch.no_grad():
        last["linear"] = check_linear_kernel(
            dev, [(4096, 256, 512, True, 0.05),
                  (nodes, shapes[0][0], shapes[0][2], False,
                   shapes[0][0] ** -0.5)], seed, reps, out)
        last["segmax"] = check_segmax_kernel(v1, wide[2], wide[2], seed,
                                             reps, out)
    last["v1_fwd"], last["v1_bwd"] = check_v1_kernels(v1, shapes, seed, reps,
                                                      out)
    with torch.no_grad():
        last["v1_padding"] = check_v1_padding(v1, shapes, seed, reps, out)
    last.update(kernel_entry_points(dev, bench, reps, out))
    summary["last_four"] = last

    # -- the evaluation stage on the kNN requests, the bench ----------------
    summary["evaluation"] = evaluation_phase(dev, model, loader, out)
    summary["bench"] = bench_phase(dev, points, graphs, out)

    # -- the seventh to tenth phases: the CLI, the nuScenes pipeline, the
    # settings that reach kernel variants (bf16 routing and landing,
    # ovf_ssum, dense receiver tiles of 8 and 24, the unfused model, the
    # tools, orbax) and training across ranks; each is rehearsed off the
    # card by a test of its own (tests/test_torch_smoke_cli.py,
    # test_torch_nuscenes_smoke.py, test_torch_smoke_variants.py and
    # test_torch_smoke_settings.py, test_torch_halo.py)
    if on_card:
        summary["cli"] = cli_phase(dev, points, out=out)
        summary["nuscenes"] = nuscenes_phase(dev, seed=seed, reps=reps,
                                             out=out)
        from radargnn_tpu_torch.smoke_variants import variants_phase
        summary["variants"] = variants_phase(
            dev, arch, loader[0], r_arch, r_loader[0], c_arch, c_loader[0],
            shapes, points, graphs, seed, reps, train_steps,
            {"dense": summary["train_losses"],
             "windowed": radius["train_losses"]}, out)
        from radargnn_tpu_torch.smoke_parallel import parallel_phase
        summary["parallel"] = parallel_phase(dev, points, graphs, seed,
                                             out=out)

    def entry(*args):
        return kernel_entry(*args, on_card=on_card)

    dense_l, radius_l = summary["train_launches"], radius["train_launches"]
    csr_l = csr["train_launches"]
    cli_l = [sum(x) for x in zip(
        [0] * len(KERNEL_NAMES),
        *(summary[p][f"{stage}_launches"] for p in ("cli", "nuscenes")
          if p in summary for stage in ("train", "evaluate")))]
    r_fwd, r_bwd = radius["per_shape_fwd"], radius["per_shape_bwd"]
    c_fwd, c_bwd = csr["per_shape_fwd"], csr["per_shape_bwd"]
    # B3: one CSR training step's ten landings (d_x at d_in, the d_op sums
    # at H, each layer); its errors also on the windowed layout and the
    # radius batch under CSR
    seg_rows = csr["per_shape_segsum"]
    segs = (radius["knn_per_shape_segsum"] + seg_rows
            + csr["radius_per_shape_segsum"])
    # launches: the training runs of each path (the projection runs in
    # every path's forward; B3 lands on the CSR path), and the train and
    # evaluate stages of the RadarScenes and the nuScenes CLI runs on the
    # dense path; the dense errors also cover the nuScenes train batch; no
    # single PyTorch call computes gather + GEMM + segmented max, nor the
    # routed backward; the projection's is torch.mm, the landing's
    # index_add_. The windowed gather-max is held
    # in VJP mode, the mode of its training launches (with the bits); the
    # dense one in serving mode; the CSR forward as its wrapper runs it in
    # serving mode (the projection and the gather-max), against the whole
    # function's bound.
    nus = summary.get("nuscenes", {})
    summary["kernels"] = [
        entry("dense_proj_v4", "dense_fwd_v4.cu", 2279,
              dense_l[11] + radius_l[11] + csr_l[11] + cli_l[11], proj_rows,
              proj_rows + nus.get("per_shape_proj", []), True),
        entry("dense_fwd_v4", "dense_fwd_v4.cu", 2279, dense_l[0] + cli_l[0],
              fwd_rows, fwd_rows + nus.get("per_shape", []), False),
        entry("dense_bwd_v4", "dense_bwd_v4.cu", 2340, dense_l[1] + cli_l[1],
              bwd_rows, bwd_rows + nus.get("per_shape_bwd", []), False),
        entry("segment_sum_csr", "segment_sum_csr.cu", 854,
              dense_l[2] + radius_l[2] + csr_l[2], seg_rows, segs, True),
        entry("windowed_fwd_v3", "windowed_fwd_v3.cu", 1275, radius_l[3],
              [r["vjp"] for r in r_fwd], r_fwd + radius["knn_per_shape_fwd"],
              False),
        entry("windowed_bwd_v3", "windowed_bwd_v3.cu", 1387, radius_l[4],
              r_bwd, r_bwd + radius["knn_per_shape_bwd"], False),
        entry("csr_fwd_v2", "csr_fwd_v2.cu", 943, csr_l[5], c_fwd,
              c_fwd + csr["radius_per_shape_fwd"], False),
        entry("csr_bwd_v2", "csr_bwd_v2.cu", 1030, csr_l[6], c_bwd,
              c_bwd + csr["radius_per_shape_bwd"], False),
    ]
    # the fourth phase: launches from its entry points; times and bounds of
    # the fused linear at the flagship's node shape (224 -> 464 over the
    # batch's nodes), of the segment-max on the kNN batch, and of the v1
    # pair summed over the five layer shapes
    entry_l = last["entry_launches"]
    lin, seg = last["linear"], last["segmax"]
    summary["kernels"] += [
        entry("fused_linear", "fused_linear.cu", 94, entry_l["fused_linear"],
              lin[1:], lin, True),
        entry("msg_segmax", "msg_segmax.cu", 558, entry_l["msg_segmax"],
              seg[:1], seg, True),
        entry("hoisted_fwd_v1", "hoisted_fwd_v1.cu", 707,
              entry_l["hoisted_fwd_v1"], last["v1_fwd"], last["v1_fwd"],
              False),
        entry("hoisted_bwd_v1", "hoisted_bwd_v1.cu", 2015,
              entry_l["hoisted_bwd_v1"], last["v1_bwd"], last["v1_bwd"],
              False),
    ]
    if "variants" in summary:
        from radargnn_tpu_torch.smoke_variants import variants_kernels
        summary["kernels"] += variants_kernels(summary["variants"], on_card)
    summary["per_shape_proj"] = proj_rows
    summary["per_shape"] = fwd_rows
    summary["per_shape_bwd"] = bwd_rows
    out(json.dumps({"card": summary.get("card"),
                    "per_shape_proj": proj_rows, "per_shape": fwd_rows,
                    "per_shape_bwd": bwd_rows,
                    "radius": {k: v for k, v in radius.items()
                               if k.startswith(("per_shape", "knn_per",
                                                "tiling"))},
                    "csr": {k: v for k, v in csr.items()
                            if k.startswith(("per_shape", "radius_per",
                                             "tiling", "radius_tiling"))},
                    "last_four": {k: last[k] for k in (
                        "linear", "segmax", "v1_fwd", "v1_bwd",
                        "v1_padding", "kernel_bench")},
                    "nuscenes": {k: v for k, v in nus.items()
                                 if k.startswith(("per_shape", "train_tiling"))
                                 },
                    "variants": {k: v for k, v in summary.get(
                        "variants", {}).items() if k in VARIANT_ROWS}}))
    return summary
