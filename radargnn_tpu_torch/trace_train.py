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
        [--graph knn|radius] [--trace FILE]

`--graph knn` (the default) trains on kNN graphs under the dense tiling;
`--graph radius` on radius graphs under the windowed tiling (the
configuration with three fields replaced, `smoke.flagship_configs`).
`--trace` also writes the Chrome trace of the profiled window to FILE.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch

from radargnn_tpu_torch.configs import UserConfigurationReader
from radargnn_tpu_torch.device import resolve_device
from radargnn_tpu_torch.models.detnet import DetNet
from radargnn_tpu_torch.smoke import (
    FLAGSHIP_CONFIG, card_description, flagship_serving,
)
from radargnn_tpu_torch.trace_serving import by_name, device_profile
from radargnn_tpu_torch.train.trainer import Trainer, set_seeds

# kernel kinds, first match wins (lower-case substrings of the kernel name);
# the slot-gradient passes are one code in both backward kernels
_KINDS = (
    ("dense_fwd_v4 (B1)", ("dense_fwd_v4",)),
    ("windowed_fwd_v3 (B4)", ("windowed_fwd_v3",)),
    ("windowed_bwd_v3 route (B4)", ("windowed_route",)),
    ("dense_bwd_v4 route (B2)", ("route_kernel",)),
    ("slot products (B2 / B4)", ("slot_products",)),
    ("weight partials + reduce (B2 / B4)",
     ("weight_partials", "reduce_partials")),
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
          graph: str = "knn") -> Dict:
    """Profiles `steps` train steps on `graph` after one warm-up step."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    dev = resolve_device("cuda")
    cfg = UserConfigurationReader.read_config_file(FLAGSHIP_CONFIG)
    train_cfg = UserConfigurationReader.get_config_object("TRAINING", cfg)
    set_seeds(train_cfg.seed, train_cfg.deterministic)
    arch, _, loader = flagship_serving(dev, points, graphs, 1, seed,
                                       graph=graph)
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
        "card": card_description(), "graph": graph,
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--graph", choices=("knn", "radius"), default="knn")
    ap.add_argument("--trace", default=None,
                    help="also write the Chrome trace to this file")
    args = ap.parse_args(argv)
    print(json.dumps(trace(args.steps, trace_file=args.trace,
                           graph=args.graph)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
