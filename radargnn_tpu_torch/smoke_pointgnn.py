"""The smoke's Radar-PointGNN phase (`smoke.run` calls `pointgnn_phase` on
the card, after the CSR path and before the fourth phase).

The model is the flagship configuration with one field replaced,
conv_layer_type "RadarPointGNNConv" (`smoke.flagship_configs`); the YAML's
one-layer pre-MLP, max aggregation and bf16 compute keep it on the fused
path. Its five residual convs keep the node embedding's 224 columns: each
aggregates at (d_in, d_e, H) = (224, 16, 240), H = 224 + 16, with the
message x_s @ W_s + e @ W_e + b and no receiver term, so the hoisted
offset is the pre-MLP's bias broadcast over the nodes. H 240 pads 16
columns to the kernels' 256 (8 routing-bit words a slot), a tail no MPNN
layer shape has (those pad 48). The phase runs three paths on the smoke's
batch of synthetic frames:

  kNN, dense tiling: B1's projection and gather-max, B2;
  radius, windowed tiling (the radius path's three fields replaced too):
      B1's projection, B4's forward and backward;
  kNN, CSR tiling (fused_tiling "csr" too): B1's projection, B5's forward
      and backward, B3 twice a layer in training;

and on each:

  (a) the path's kernels against their plain versions at the one distinct
      layer shape, under the limits of the MPNN paths' checks
      (`smoke.check_routed_kernels`, `check_fwd_kernel`,
      `check_bwd_kernels`), each timed beside its bound (the offset there
      is a seeded row per node; the broadcast bias reaches the kernels in
      (b) and (c), which the wrappers make contiguous before the launch);
  (b) the requests through `Predictor` (`smoke._serve_phase`): each forward
      kernel of the path launched once a layer and request, nothing else,
      and the outputs within the model limits of the plain path;
  (c) the training steps through `Trainer` (`smoke._train_phase`, the
      witness on): launches exact, at every step the losses and gradients
      within the training limits of the plain path at the same parameters,
      a second run bitwise equal; every conv's `pre_mlp.lin_0.bias`, where
      autograd sums the broadcast offset's gradient, against the plain
      path's (BIAS_GRAD_RTOL); and C3's rule (PERF.md
      §6, PR 18): over DRIFT_SEEDS weight seeds, the median free-running
      loss gap of the kernel path to the plain path at most C3_RATIO times
      the witness's (the plain path re-associated).

A kernel that fails here is repaired, not routed around: nothing is caught.
"""

from __future__ import annotations

import json
import time
from contextlib import ExitStack, contextmanager
from typing import Callable, Dict, List, Optional
from unittest import mock

import numpy as np
import torch

from radargnn_tpu_torch import smoke as sm
from radargnn_tpu_torch import trace_train
from radargnn_tpu_torch.configs import UserConfigurationReader
from radargnn_tpu_torch.device import resolve_device
from radargnn_tpu_torch.models import layers
from radargnn_tpu_torch.models.detnet import DetNet
from radargnn_tpu_torch.models.layers import fused_csr_tiling
from radargnn_tpu_torch.train.trainer import Trainer

CONV = "RadarPointGNNConv"
# (label, graph, tiling, the forward's kernels, the training's other
# kernels with their launches a layer and step)
PATHS = (
    ("kNN", "knn", None, ("dense_proj_v4", "dense_fwd_v4"),
     {"dense_bwd_v4": 1}),
    ("radius", "radius", None, ("dense_proj_v4", "windowed_fwd_v3"),
     {"windowed_bwd_v3": 1}),
    ("CSR", "knn", "csr", ("dense_proj_v4", "csr_fwd_v2"),
     {"csr_bwd_v2": 1, "segment_sum_csr": 2}),
)
# C3's rule on each path: free-running runs drift apart by Adam's chaos,
# seed by seed (one seed's ratio read 0.46 to 2.46 on the MPNN paths in
# the smoke), so the rule holds the medians over weight seeds, as
# `trace_train --drift` reads them (24 seeds: ratios 1.05 to 1.21 on the
# MPNN paths, 0.92 to 1.15 on these, PERF.md)
DRIFT_SEEDS = 8
C3_RATIO = 2.0
# a conv's pre-MLP bias takes the column sums of its hoisted offset's
# gradient (RadarPointGNNConv's broadcast bias; MPNNConv's x @ W_r + bias
# alike), and the BatchNorm after the conv removes any per-column
# constant from the loss: the sums cancel to rounding (3e-8 of
# the sums of the rows' magnitudes in float32, 1.3e-4 to 1.7e-4 with bf16
# compute, on the CPU at the flagship's widths), so the bias's gradient
# cosine to the plain path's is a cosine of noise (-0.038 to 0.33 on the
# card). The bias is held instead to the plain path's within BIAS_GRAD_RTOL
# of those magnitudes. On the card (H100) the kernel path read 4e-5 to
# 7e-5 of them at the smoke's size and 1.3e-4 to 1.7e-4 at 2 x 512 points;
# a forward that loses the VJP-mode maxima of 64 of the smoke's 14,080
# receivers read 2.5e-3 to 3.1e-3, of 704 of them 1.9e-2 to 3.7e-2
# (tests/test_torch_gpu.py), of 64 of 400 on the CPU 5e-2 to 9e-2
# (tests/test_torch_smoke_pointgnn.py). MPNNConv's bias at the smoke's
# size read 3.8e-5 to 4.9e-5 on the card, its gradient itself 2.8e-5 to
# 3.6e-5 of the magnitudes
BIAS_GRAD_RTOL = 5e-4


def bias_names(model) -> List[str]:
    """Each conv's pre-MLP bias, the hoisted offset's parameter (the
    offset itself broadcast over the nodes for RadarPointGNNConv, added to
    `x @ W_r` for MPNNConv)."""
    return [f"conv_{i}.pre_mlp.lin_0.bias" for i in range(model.num_conv)]


def expected_launches(fwd_names, train_extra: Dict[str, int], layers: int,
                      batches: int, steps: int, on_card: bool):
    """The launches a path's serving and training runs must show, in the
    order of KERNEL_NAMES (`smoke._expect`: all 0 off the card): each
    forward kernel once a layer and request, then once a layer and step
    with the training's other kernels as often as `train_extra` says."""
    serve = sm._expect({n: layers * batches for n in fwd_names}, on_card)
    train = dict({n: layers * steps for n in fwd_names},
                 **{n: k * layers * steps for n, k in train_extra.items()})
    return serve, sm._expect(train, on_card)


def c3_check(dev, points: int, graphs: int, graph: str,
             tiling: Optional[str], steps: int, seeds: int, label: str,
             out: Callable) -> Dict:
    """C3's rule on one path (module docstring), by `trace_train.drift`
    over weight seeds 0..seeds-1 on the path's first batch. Raises when the
    ratio of the medians exceeds C3_RATIO."""
    got = trace_train.drift(seeds, steps, points, graphs, graph, tiling,
                            device=dev, conv=CONV)
    ratio = got["median_ratio"]
    out(f"{label} C3: free-running loss gaps to the plain path over "
        f"{seeds} weight seeds, kernel path "
        f"{[round(r['kernel_vs_plain'], 6) for r in got['runs']]}, witness "
        f"{[round(r['witness_vs_plain'], 6) for r in got['runs']]}; medians "
        f"{got['kernel_vs_plain']['median']:.3e} / "
        f"{got['witness_vs_plain']['median']:.3e}, ratio {ratio} (at most "
        f"{C3_RATIO})")
    if ratio is None or ratio > C3_RATIO:
        raise AssertionError(f"{label}: the kernel path drifts from the plain "
                             f"path more than {C3_RATIO}x re-association "
                             f"does: {got}")
    return got


@contextmanager
def _offset_grads(rows: List, target: str = "_fused_hoisted_max",
                  record: Optional[Callable] = None):
    """Each conv's hoisted offset, passed to the layers' `target`
    (`_fused_hoisted_max`, or `halo_hoisted_max_batched` under a halo
    bundle), appends `record` of its gradient to `rows` when autograd
    reaches it (backward order: the last conv first). By default the
    column sums of the gradient's magnitudes: the scale, before any
    cancellation, of the sum autograd lands in the bias."""
    aggregate = getattr(layers, target)
    record = record or (lambda g: g.abs().sum(0))

    def hooked(x, w_s, w_e, offset, *rest):
        if offset.requires_grad:
            offset.register_hook(lambda g: rows.append(record(g)))
        return aggregate(x, w_s, w_e, offset, *rest)

    with mock.patch.object(layers, target, hooked):
        yield


def check_offset_grads(dev, arch, batch, seed: int, label: str,
                       out: Callable) -> List[Dict]:
    """Each conv's pre-MLP bias gradient at the seeded weights, the kernel
    path against the plain path: their difference over its scale before
    cancellation (BIAS_GRAD_RTOL), beside the bias gradient's own size
    over that scale and the two gradients' cosine (reported). Either conv
    type: the bias takes the column sums of the hoisted offset's gradient
    (RadarPointGNNConv's broadcast bias, MPNNConv's `x @ W_r + bias`), and
    the BatchNorm after each conv cancels them alike."""
    cfg = UserConfigurationReader.read_config_file(sm.FLAGSHIP_CONFIG)
    train_cfg = UserConfigurationReader.get_config_object("TRAINING", cfg)
    trainer = Trainer(train_cfg, DetNet(arch, device=dev, seed=seed))
    model = trainer.model
    names = bias_names(model)

    def grads(plain: bool):
        rows: List[torch.Tensor] = []
        model.zero_grad(set_to_none=True)
        with _offset_grads(rows), sm._plain_kernels() if plain \
                else ExitStack():
            trainer.losses(batch)[0].backward()
        return [model.get_parameter(n).grad.double() for n in names], \
            [r.double() for r in rows[::-1]]

    kern, _ = grads(False)
    plain, scales = grads(True)
    if len(scales) != model.num_conv:
        raise AssertionError(f"{label}: {len(scales)} of the "
                             f"{model.num_conv} convs' offsets reached")
    res = []
    for name, u, v, scale in zip(names, kern, plain, scales):
        norm = float(scale.norm())
        res.append({"param": name, "rel_diff": float((u - v).norm()) / norm,
                    "cancelled_to": float(v.norm()) / norm,
                    "cosine": float(torch.nn.functional.cosine_similarity(
                        u, v, dim=0))})
    out(f"{label} pre-MLP biases (the column sums of the hoisted offset's "
        "gradient), kernel vs plain path over the sums of the rows' "
        "magnitudes: " + ", ".join(
            f"{r['param']} {r['rel_diff']:.2e} (the bias gradient itself "
            f"{r['cancelled_to']:.2e}, cosine {r['cosine']:.3f})"
            for r in res) + f" (limit {BIAS_GRAD_RTOL})")
    bad = [r for r in res if not r["rel_diff"] <= BIAS_GRAD_RTOL]
    if bad:
        raise AssertionError(f"{label}: the pre-MLP biases' gradients leave "
                             f"the plain path's: {bad}")
    return res


def check_kernels(tiling, shapes: List[tuple], seed: int, reps: int,
                  out: Callable) -> Dict[str, List[Dict]]:
    """(a) on one path's batch: its kernels' rows by kernels-line name."""
    with torch.no_grad():
        if tiling.win is None:
            fwd = sm.check_fwd_kernel(tiling, shapes, seed, reps, out)
            bwd, seg = sm.check_bwd_kernels(tiling, shapes, seed, reps, out,
                                            exact=True)
            return {"csr_fwd_v2": fwd, "csr_bwd_v2": bwd,
                    "segment_sum_csr": seg}
        dense = tiling.dense is not None
        proj, fwd, bwd = sm.check_routed_kernels(
            tiling, shapes, seed, reps, out, exact=not dense)
    stem = "dense" if dense else "windowed"
    ver = "v4" if dense else "v3"
    return {"dense_proj_v4": proj, f"{stem}_fwd_{ver}": fwd,
            f"{stem}_bwd_{ver}": bwd}


def _time_row(row: Dict, **extra) -> Dict:
    """A kernel row's times and bound as the phase's kernels line gives
    them."""
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    return dict({k: row[k] for k in keys if k in row}, **extra)


def kernel_times(checked: Dict[str, List[Dict]]) -> Dict[str, Dict]:
    """Each kernel's time and bound at the phase's layer shape, in the
    modes the kernels line reads: B1's gather-max in serving mode (VJP
    mode beside it), B4's in VJP mode, B5's forward whole (projection and
    gather-max), B3's two landings of a CSR layer summed (d_x and the d_op
    sums). The projection is the kNN path's, `torch.mm` beside it."""
    dense, win = checked["dense_fwd_v4"][0], checked["windowed_fwd_v3"][0]
    times = {
        "dense_proj_v4": _time_row(checked["dense_proj_v4"][0],
                                   library=checked["dense_proj_v4"][0].get(
                                       "library")),
        "dense_fwd_v4": _time_row(dense, vjp_ms=dense["vjp"]["ms"],
                                  vjp_bound_ms=dense["vjp"]["bound_ms"]),
        "dense_bwd_v4": _time_row(checked["dense_bwd_v4"][0]),
        "windowed_fwd_v3": _time_row(win["vjp"], serving_ms=win["ms"]),
        "windowed_bwd_v3": _time_row(checked["windowed_bwd_v3"][0]),
        "csr_fwd_v2": _time_row(checked["csr_fwd_v2"][0]),
        "csr_bwd_v2": _time_row(checked["csr_bwd_v2"][0]),
    }
    seg = checked["segment_sum_csr"]
    times["segment_sum_csr"] = {
        k: (None if any(r[k] is None for r in seg) else sum(r[k] for r in seg))
        for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    return times


def pointgnn_phase(dev, points: int, graphs: int, batches: int, seed: int,
                   reps: int, train_steps: int,
                   drift_seeds: int = DRIFT_SEEDS,
                   out: Callable = print) -> Dict:
    """The phase (module docstring). Returns each path's results by label,
    `checked` (each kernel's rows, for the kernels line's errors),
    `train_launches` (the training runs' launches over the three paths, in
    the order of KERNEL_NAMES), `kernels` (each kernel's time and bound at
    the layer shape) and the phase's wall seconds."""
    t0 = time.perf_counter()
    dev = resolve_device(dev)
    on_card = dev.type == "cuda"
    _, _, _, replaced = sm.flagship_configs(conv=CONV)
    res: Dict = {"replaced": replaced, "paths": {}, "checked": {}}
    launches = np.zeros(len(sm.KERNEL_NAMES), dtype=np.int64)
    for label, graph, tiling, fwd_names, train_extra in PATHS:
        arch, graph_cfg, _, path_replaced = sm.flagship_configs(
            graph, points, tiling, CONV)
        t1 = time.perf_counter()
        _, model, loader = sm.flagship_serving(
            dev, points, graphs, batches, seed, graph=graph, tiling=tiling,
            conv=CONV)
        shapes = sm._layer_shapes(model)
        distinct = list(dict.fromkeys(shapes))
        layers = len(shapes)
        name = f"Radar-PointGNN {label}"
        out(f"{name} path: the flagship configuration with "
            f"{json.dumps(path_replaced)} replaced; "
            f"{arch.conv_pre_mlp_layer_number}-layer pre-MLP, "
            f"{arch.aggregation_function} aggregation, compute "
            f"{arch.compute_dtype}, fused tiling "
            f"{fused_csr_tiling(arch, k=graph_cfg.k)}; "
            f"layer shapes (d_in, d_e, H) {shapes}, checked at {distinct}; "
            f"{batches} requests of {graphs} x {points} points; host set-up "
            f"{time.perf_counter() - t1:.2f} s")
        path: Dict = {"replaced": path_replaced, "shapes": shapes,
                      "checked": check_kernels(loader[0].flat_tiling(),
                                               distinct, seed, reps, out)}
        for kernel, rows in path["checked"].items():
            res["checked"].setdefault(kernel, []).extend(rows)
        serve, train = expected_launches(fwd_names, train_extra, layers,
                                         batches, train_steps, on_card)
        path.update(sm._serve_phase(dev, arch, model, loader, graphs, points,
                                    serve, name, out))
        path.update(sm._train_phase(dev, arch, loader[0], seed, train_steps,
                                    train, name, out, witness=True))
        path["bias_grads"] = check_offset_grads(dev, arch, loader[0], seed,
                                                name, out)
        path["c3"] = c3_check(dev, points, graphs, graph, tiling,
                              train_steps, drift_seeds, name, out)
        launches += np.asarray(path["train_launches"])
        res["paths"][label] = path
    res["train_launches"] = launches.tolist()
    res["kernels"] = kernel_times(res["checked"])
    res["wall_s"] = time.perf_counter() - t0
    out("pointgnn kernels: " + json.dumps(
        {"card": sm.card_description() if on_card else None,
         "shape": list(distinct), **res["kernels"]}))
    out(f"Radar-PointGNN phase: {res['wall_s']:.1f} s wall, training "
        f"launches {res['train_launches']} ({', '.join(sm.KERNEL_NAMES)})")
    return res

