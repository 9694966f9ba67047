"""Where a training step's time goes on the card.

Runs the flagship training path (the configuration_radarscenes.yml DetNet
and TRAINING section with seeded weights, deterministic algorithms as the
configuration sets them, a batch of 5 x 2816-point synthetic frames,
`Trainer.train_step`) under torch.profiler after one warm-up step, and
prints, as one JSON line: the card, the per-step wall time (unprofiled,
and profiled beside it), train edges/s, the device-busy time (the union of
the card's kernel intervals), the idle share against the unprofiled wall,
launches per step, and the device time by kernel kind and by kernel name.
Run from the root of a checkout on a machine with a CUDA card:

    python -m radargnn_tpu_torch.trace_train [--steps N]
        [--graph knn|radius] [--tiling csr] [--trace FILE] [--drift SEEDS]

`--graph knn` (the default) trains on kNN graphs under the dense tiling;
`--graph radius` on radius graphs under the windowed tiling (the
configuration with three fields replaced, `smoke.flagship_configs`);
`--tiling csr` trains on either under the CSR tiling (fused_tiling "csr").
`--trace` also writes the Chrome trace of the profiled window to FILE.

`--drift SEEDS` profiles nothing: it measures how far free-running
training runs drift apart (`drift`): the kernel path and the witness (the
plain path with its float32 sums re-associated, `witness`) each from the
plain path, over SEEDS weight seeds, on the path `--graph` and `--tiling`
select. The drift is why the on-card smoke holds each step to the plain
path at the same parameters instead.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch

from radargnn_tpu_torch.configs import UserConfigurationReader
from radargnn_tpu_torch.device import DeviceLike, resolve_device
from radargnn_tpu_torch.models.detnet import DetNet
from radargnn_tpu_torch.smoke import (
    FLAGSHIP_CONFIG, _grad_agreement, card_description, flagship_serving,
    flagship_training, loss_drift,
)
from radargnn_tpu_torch.trace_serving import by_name, device_profile
from radargnn_tpu_torch.train.trainer import Trainer, set_seeds

# kernel kinds, first match wins (lower-case substrings of the kernel name);
# the dense and windowed backward run the same passes (csrc/routed_bwd.cuh),
# told apart by their receivers' type in the kernel's name
_KINDS = (
    ("dense_proj_v4 (projection: B1, B4, B5)", ("dense_proj",)),
    ("dense_fwd_v4 (B1 gather-max)", ("dense_fwd_v4",)),
    ("windowed_bwd_v3 dW_e pass (B4)", ("dwe_pass_kernel<radargnn::window",)),
    ("windowed_bwd_v3 d_e pass (B4)", ("de_pass_kernel<radargnn::window",)),
    ("windowed_bwd_v3 sender sums (B4)",
     ("send_pass_kernel<radargnn::window",)),
    ("dense_bwd_v4 dW_e pass (B2)", ("dwe_pass",)),
    ("dense_bwd_v4 d_e pass (B2)", ("de_pass",)),
    ("dense_bwd_v4 sender sums (B2)", ("send_pass",)),
    ("dW_e reduce (B2, B4)", ("reduce_pass",)),
    ("windowed_fwd_v3 (B4 gather-max)", ("windowed_fwd_v3",)),
    ("csr_fwd_v2 (B5)", ("csr_fwd_v2",)),
    ("csr_bwd_v2 route + edge side (B5)", ("csr_route",)),
    ("csr_bwd_v2 dW_s partials (B5)", ("csr_dws",)),
    ("csr_bwd_v2 dW_e, dW_s reduce (B5)", ("csr_reduce",)),
    ("csr_bwd_v2 slot products (B5)", ("slot_products",)),
    ("segment_sum_csr (B3)", ("segment_sum_csr",)),
    ("GEMMs (cuBLAS)", ("gemm", "xmma", "cutlass", "ampere", "sm80_",
                        "sm90_", "splitk")),
    ("optimizer (Adam, foreach)", ("multi_tensor", "foreach", "adam")),
    ("scatter / index / gather", ("scatter", "index", "gather")),
    ("fills (memset, NaN fill of new tensors)", ("fill", "memset")),
    ("reductions", ("reduce",)),
    ("copies and casts", ("copy", "cast", "cat")),
    ("elementwise", ("elementwise", "unrolled", "vectorized")),
)


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, keys in _KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


def trace(steps: int = 3, points: int = 2816, graphs: int = 5,
          seed: int = 0, top: int = 30, trace_file: Optional[str] = None,
          graph: str = "knn", tiling: Optional[str] = None,
          conv: Optional[str] = None) -> Dict:
    """Profiles `steps` train steps on `graph` (under `tiling`, or the one
    the configuration selects; the conv layers of type `conv`, None: the
    YAML's) after one warm-up step."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    dev = resolve_device("cuda")
    cfg = UserConfigurationReader.read_config_file(FLAGSHIP_CONFIG)
    train_cfg = UserConfigurationReader.get_config_object("TRAINING", cfg)
    set_seeds(train_cfg.seed, train_cfg.deterministic)
    arch, _, loader = flagship_serving(dev, points, graphs, 1, seed,
                                       graph=graph, tiling=tiling, conv=conv)
    batch = loader[0]
    trainer = Trainer(train_cfg, DetNet(arch, device=dev, seed=seed))

    def train() -> List[float]:
        wall = []
        for _ in range(steps):
            t0 = time.perf_counter()
            trainer.train_step(batch)
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e6)
        return wall

    losses = trainer.train_step(batch)                 # warm-up (and build)
    if not all(bool(torch.isfinite(v)) for v in losses):
        raise RuntimeError("the warm-up step's losses are not finite")
    plain_wall = train()
    wall: List[float] = []
    kernels, busy = device_profile(lambda: wall.extend(train()), trace_file)
    kinds: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        kinds[kind_of(e.name)][0] += e.time_range.elapsed_us()
        kinds[kind_of(e.name)][1] += 1
    return {
        "card": card_description(), "graph": graph, "tiling": tiling,
        "steps": steps, "graphs": graphs, "points": points,
        "deterministic": train_cfg.deterministic,
        "wall_us_per_step": plain_wall,
        "profiled_wall_us_per_step": wall,
        "train_edges_per_s": (batch.host_valid_edges * steps
                              / (sum(plain_wall) * 1e-6)),
        "device_busy_us_per_step": busy / steps if kernels else None,
        "idle_share": 1.0 - busy / sum(plain_wall) if kernels else None,
        "kernel_launches_per_step": len(kernels) / steps,
        "device_us_per_step_by_kind": [
            {"kind": k, "us": t / steps, "share_of_busy": t / busy,
             "launches": n / steps}
            for k, (t, n) in sorted(kinds.items(), key=lambda kv: -kv[1][0])],
        "device_us_per_step_by_kernel": by_name(kernels, steps, top),
    }


_GAPS = ("kernel_vs_plain", "witness_vs_plain")


def _spread(gaps: List[float]) -> Dict:
    return {"median": float(np.median(gaps)),
            "p90": float(np.percentile(gaps, 90)), "max": float(max(gaps))}


def drift(seeds: int, steps: int = 4, points: int = 2816, graphs: int = 5,
          graph: str = "knn", tiling: Optional[str] = None,
          device: DeviceLike = None, conv: Optional[str] = None) -> Dict:
    """For weight seeds 0..seeds-1, `steps` free-running train steps on
    the first batch of seed 0 (the conv layers of type `conv`, None: the
    YAML's) on three paths (`smoke.flagship_training`):
    the kernel path, the plain path, and the witness, the plain path with
    its float32 sums re-associated (`smoke._witness_kernels`, `witness`),
    a change of summation order only, the one way in which the kernels
    differ from their plain versions. Per seed, the largest relative loss
    difference of the kernel path and of the witness from the plain path;
    over the seeds, the median, 90th percentile and largest of each, the
    ratio of the medians, and by layer the median relative difference of
    the first step's gradients from the plain path's (`smoke.
    _grad_agreement`), where a fault in one layer's kernels would show."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    dev = resolve_device(device)
    cfg = UserConfigurationReader.read_config_file(FLAGSHIP_CONFIG)
    train_cfg = UserConfigurationReader.get_config_object("TRAINING", cfg)
    was_deterministic = torch.are_deterministic_algorithms_enabled()
    try:
        set_seeds(train_cfg.seed, train_cfg.deterministic)
        arch, _, loader = flagship_serving(dev, points, graphs, 1, 0,
                                           graph=graph, tiling=tiling,
                                           conv=conv)
        rows, layers = [], defaultdict(list)
        for seed in range(seeds):
            def train(**path):
                return flagship_training(dev, arch, loader[0], seed, steps,
                                         **path)
            plain = train(plain=True)
            row = {"seed": seed}
            for gap, run in (("kernel_vs_plain", train()),
                             ("witness_vs_plain", train(witness=True))):
                row[gap] = loss_drift(run["losses"], plain["losses"])
                for layer, rel in _grad_agreement(
                        run["grads"], plain["grads"])["rel_diff"].items():
                    layers[layer, gap].append(rel)
            rows.append(row)
    finally:
        torch.use_deterministic_algorithms(was_deterministic)
    spread = {gap: _spread([r[gap] for r in rows]) for gap in _GAPS}
    witness_median = spread["witness_vs_plain"]["median"]
    return {"card": card_description() if dev.type == "cuda" else None,
            "graph": graph, "tiling": tiling, "steps": steps,
            "points": points, "graphs": graphs,
            "valid_edges": loader[0].host_valid_edges, **spread,
            "median_ratio": (spread["kernel_vs_plain"]["median"]
                             / witness_median if witness_median else None),
            "step0_grad_rel_diff_median": {
                layer: {gap: float(np.median(layers[layer, gap]))
                        for gap in _GAPS}
                for layer in dict.fromkeys(k for k, _ in layers)},
            "runs": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--graph", choices=("knn", "radius"), default="knn")
    ap.add_argument("--tiling", choices=("csr",), default=None,
                    help="the CSR tiling instead of the configuration's")
    ap.add_argument("--conv", choices=("MPNNConv", "RadarPointGNNConv"),
                    default=None, help="the conv layers' type instead of "
                    "the configuration's")
    ap.add_argument("--trace", default=None,
                    help="also write the Chrome trace to this file")
    ap.add_argument("--drift", type=int, default=None, metavar="SEEDS",
                    help="measure the free-running drift over this many "
                    "weight seeds instead of profiling")
    args = ap.parse_args(argv)
    if args.drift is not None:
        print(json.dumps(drift(args.drift, graph=args.graph,
                               tiling=args.tiling, conv=args.conv)))
        return 0
    print(json.dumps(trace(args.steps, trace_file=args.trace,
                           graph=args.graph, tiling=args.tiling,
                           conv=args.conv)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
