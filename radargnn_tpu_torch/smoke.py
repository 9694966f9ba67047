"""End-to-end check of the port on one device: kernels against their plain
versions, then the flagship DetNet serving path through `Predictor`.

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
from typing import Callable, Dict, List, Tuple
from unittest import mock

import numpy as np
import torch

from radargnn_tpu_torch.build import nvcc_shared
from radargnn_tpu_torch.configs import UserConfigurationReader
from radargnn_tpu_torch.data.synthetic import make_samples
from radargnn_tpu_torch.device import DeviceLike, resolve_device
from radargnn_tpu_torch.graph.batch import stack_samples
from radargnn_tpu_torch.models.detnet import DetNet
from radargnn_tpu_torch.models.layers import fused_csr_tiling
from radargnn_tpu_torch.ops import dense_aggregate as da
from radargnn_tpu_torch.postprocess.inference import Predictor

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP_CONFIG = os.path.join(_REPO, "configurations",
                               "configuration_radarscenes.yml")

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

# kernel vs plain version on the same bf16 inputs: both sum exact bf16
# products in float32 and differ only in summation order
KERNEL_RTOL = 1e-3
# whole model, kernel path vs plain path on the card: a different f32
# summation order can move an activation across a bf16 rounding boundary
# (one bf16 ulp, 2^-8 relative) in the next layer's matmul inputs, and five
# layers with BatchNorm carry that on; the outputs must still agree to
MODEL_ATOL_PROB = 2e-2
MODEL_RTOL_BOX = 2e-2


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


def check_kernel(tiling, layer_shapes: List[tuple], seed: int, reps: int,
                 out: Callable = print) -> List[Dict]:
    """Holds the dense forward kernel against `dense_fwd_plain` at each
    (d_in, d_e, H) of the model, on the batch's real slot layout and seeded
    bf16 inputs; times both on the card. Raises beyond KERNEL_RTOL."""
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
        if on_card:
            torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise AssertionError(f"kernel output not finite at d={d}, h={h}")
        err = float((got - ref).abs().max())
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


def run(device: DeviceLike = None, points: int = 2816, graphs: int = 5,
        batches: int = 3, seed: int = 0, reps: int = 20,
        out: Callable = print) -> Dict:
    """Runs every phase; returns the summary (also printed as JSON lines).

    `points`/`graphs` size the synthetic frames (the serving shape is 5
    graphs of 2816 points); `batches` is the number of requests served."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    summary: Dict = {"device": str(dev)}

    # -- card and build ----------------------------------------------------
    if on_card:
        summary["card"] = card_description()
        out(f"card: {summary['card']}")
        t0 = time.perf_counter()
        path, log = nvcc_shared("dense_fwd_v4.cu")
        da.load_kernel()
        summary["build_s"] = time.perf_counter() - t0
        out(f"build: {summary['build_s']:.2f} s -> {path}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                out(line.strip())

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
        rows = check_kernel(tiling, shapes, seed, reps, out)

    # -- the main path: Predictor over the requests --------------------------
    predictor = Predictor(model, loader, verbose=False)
    da.dense_fwd_cuda.launches = 0
    predictions, _, _, _ = predictor.predict()
    launches = da.dense_fwd_cuda.launches
    expected = len(shapes) * batches if on_card else 0
    out(f"launches on the main path: dense_fwd_v4 {launches} "
        f"(expected {expected})")
    if launches != expected:
        raise AssertionError(f"dense_fwd_v4 launched {launches} times on the "
                             f"main path, expected {expected}")
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
        with mock.patch.object(da, "dense_fwd", da.dense_fwd_plain):
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

    summary["kernels"] = [{
        "name": "dense_fwd_v4", "route": "cuda",
        "source": "radargnn_tpu_torch/csrc/dense_fwd_v4.cu",
        "replaces": "radargnn_tpu/ops/pallas_kernels.py:2279",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        # times and bound: one forward's launches, one per layer shape
        "ms": sum(r["ms"] for r in rows) if on_card else None,
        "plain_ms": sum(r["plain_ms"] for r in rows) if on_card else None,
        "bound_ms": sum(r["bound_ms"] for r in rows),
        "bound_by": ("operations" if sum(r["flops"] for r in rows)
                     / PEAK_BF16_FLOPS >= sum(r["bytes"] for r in rows)
                     / PEAK_HBM_BYTES else "bytes"),
        # no single PyTorch call computes gather + GEMM + segmented max
        "library_ms": None,
    }]
    summary["per_shape"] = rows
    out(json.dumps({"card": summary.get("card"), "library_call": "none",
                    "per_shape": rows}))
    return summary
