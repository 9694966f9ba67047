"""Benchmark: edges/s through the flagship RadarScenes train step (or
request) on one card, the fused path against the unfused one in pairs.

Port of the workload and timing of the JAX package's `bench.py:121-258`:
the translation-invariant RadarScenes DetNet of `bench.py:150-160` (node /
edge feature dims 5 / 2, node embedding [32, 64, 128, 224], edge embedding
[4, 8, 16], MPNNConv [224, 224, 128, 64, 32], heads [6] and [16, 5], no
BatchNorm in the MLPs, bf16), its TrainingConfig (lr 1e-3, L2 5e-6,
bb_loss_weight 0.5, adapt_orientation_angle), `make_samples(GRAPHS,
POINTS, seed=0)` as kNN graphs with k = 20 stacked under the tiling that
BENCH_TILING names, and 32 steps, each adding 0.01·N(0, 1) noise (seed 1)
to the node features. BENCH_MODE=infer runs the request path instead: the
forward + softmax with batch statistics of `Predictor.forward`. Train and
infer share the batch and the noise.

    python -m radargnn_tpu_torch.benchmarks.bench [--device cpu]

Knobs (environment, as bench.py's): BENCH_POINTS (2816), BENCH_GRAPHS (5),
BENCH_STEPS (32), BENCH_DTYPE (bfloat16), BENCH_FUSED (1: the value is
the fused path's; 0: the unfused path's, `use_fused_aggregation: False`,
torch gathers and a segment max, as bench.py's XLA path), BENCH_TILING
(dense: the dense tiling with BENCH_OVF_FRAC 0.06; windowed: run cap
BENCH_RUN_CAP 4 (0: contiguous runs) and 0.04, or 0.03 without the cap;
csr), BENCH_MODE (train or infer), BENCH_PAIRS (3) and BENCH_DEVICE (the
card; `cpu` only for the tests' rehearsal) and BENCH_BF16_MAX (1: the
fused path's backward routes by bf16 equality, `fused_bf16_max: True`;
bench.py's opt-in, off by default as there).

Timing: one warm-up run of the whole loop per path first (the kernels are
built there), then BENCH_PAIRS alternating runs of the fused and the
unfused path on the same batch; each run is timed by CUDA events around
the loop, then a synchronize once its last losses (or checks) are on the
host, with the host wall beside it. The run is under the flagship YAML's
determinism (`set_seeds(..., deterministic)`, CUBLAS_WORKSPACE_CONFIG
:4096:8 set before torch is imported). Each run prints one JSON line; then
one line of the medians and the min–max spread of each path; the last line
is bench.py's, `{"metric", "value", "unit", "vs_baseline"}`, with the
card's name and power limit.

Baseline: A100_PYG_EDGES_PER_S is bench.py's derived estimate, not a
measured card figure. The reference trains this stack with PyG /
torch-scatter on a GPU; no measured baseline exists in the repo, so
bench.py derives one: the flagship stack costs about 3.3 MFLOP per edge
for a train step (the per-edge pre-MLPs dominate), and an A100 running
PyG typically sustains ~15 % of its 156 TFLOP/s TF32 on gather/scatter-
bound edge MLPs, about 23 TFLOP/s / 3.3 MFLOP ≈ 7e6 edges/s.
`vs_baseline` is edges/s over that.

bench.py's supervisor (`_probe_backend`, `_supervise`), which retries a TPU
backend that hangs, is not ported: the card has no such failure.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys
import time
from typing import Dict, List, Optional

if __name__ == "__main__":
    # cuBLAS reads its workspace setting when it creates its first handle;
    # deterministic mode needs it
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from radargnn_tpu_torch.configs import (  # noqa: E402
    GNNArchitectureConfig, TrainingConfig, UserConfigurationReader,
)
from radargnn_tpu_torch.data.synthetic import make_samples  # noqa: E402
from radargnn_tpu_torch.device import resolve_device  # noqa: E402
from radargnn_tpu_torch.graph.batch import GraphBatch, stack_samples  # noqa
from radargnn_tpu_torch.models import layers  # noqa: E402
from radargnn_tpu_torch.models.detnet import DetNet  # noqa: E402
from radargnn_tpu_torch.postprocess.inference import Predictor  # noqa: E402
from radargnn_tpu_torch.smoke import (  # noqa: E402
    FLAGSHIP_CONFIG, card_description,
)
from radargnn_tpu_torch.train.trainer import Trainer, set_seeds  # noqa

A100_PYG_EDGES_PER_S = 7e6  # derived estimate, see the module docstring
K = 20


@dataclasses.dataclass(frozen=True)
class BenchConfig:
    points: int = 2816
    graphs: int = 5
    steps: int = 32
    dtype: str = "bfloat16"
    fused: bool = True
    tiling: str = "dense"
    ovf_frac: float = 0.06
    run_cap: int = 4
    mode: str = "train"
    pairs: int = 3
    device: Optional[str] = None
    bf16_max: bool = False


def config_from_env(env=os.environ, device: Optional[str] = None
                    ) -> BenchConfig:
    """The bench's configuration from bench.py's env knobs (`device`, or
    BENCH_DEVICE, names the device: None is the card)."""
    tiling = env.get("BENCH_TILING", "dense")
    if tiling not in ("dense", "windowed", "csr"):
        raise ValueError(f"BENCH_TILING={tiling!r}: dense, windowed or csr")
    run_cap = int(env.get("BENCH_RUN_CAP", "4"))
    ovf = "0.06" if tiling == "dense" else "0.04" if run_cap else "0.03"
    mode = env.get("BENCH_MODE", "train")
    if mode not in ("train", "infer"):
        raise ValueError(f"BENCH_MODE={mode!r}: train or infer")
    return BenchConfig(
        points=int(env.get("BENCH_POINTS", 2816)),
        graphs=int(env.get("BENCH_GRAPHS", 5)),
        steps=int(env.get("BENCH_STEPS", 32)),
        dtype=env.get("BENCH_DTYPE", "bfloat16"),
        fused=env.get("BENCH_FUSED", "1") == "1",
        tiling=tiling, ovf_frac=float(env.get("BENCH_OVF_FRAC", ovf)),
        run_cap=run_cap, mode=mode, pairs=int(env.get("BENCH_PAIRS", 3)),
        device=device or env.get("BENCH_DEVICE") or None,
        bf16_max=env.get("BENCH_BF16_MAX", "0") == "1")


def architecture(dtype: str, fused: bool,
                 bf16_max: bool = False) -> GNNArchitectureConfig:
    """The architecture of `bench.py:150-161`."""
    return GNNArchitectureConfig(
        node_feature_dimension=5, edge_feature_dimension=2,
        conv_layer_dimensions=[224, 224, 128, 64, 32],
        classification_head_layer_dimensions=[6],
        regression_head_layer_dimensions=[16, 5],
        initial_node_feature_embedding=True,
        initial_edge_feature_embedding=True,
        node_feature_embedding_layer_dimensions=[32, 64, 128, 224],
        edge_feature_embedding_layer_dimensions=[4, 8, 16],
        conv_layer_type="MPNNConv", batch_norm_in_mlps=False,
        compute_dtype=dtype, assume_sorted_edges=True,
        use_fused_aggregation=fused, fused_bf16_max=bf16_max)


def training_config(graphs: int) -> TrainingConfig:
    """The TrainingConfig of `bench.py:162-165`."""
    return TrainingConfig(
        dataset="radarscenes", learning_rate=1e-3, epochs=1,
        batch_size=graphs, shuffle=False, bg_index=5, bb_loss_weight=0.5,
        regularization_strength=5e-6, adapt_orientation_angle=True)


def tiling_spec(cfg: BenchConfig):
    """The `stack_samples` tiling of `bench.py:171-189`, with the port's
    geometry constants (the JAX package's env knobs)."""
    if cfg.tiling == "dense":
        return {"mode": "dense", "node_block": layers.FUSED_NODE_BLOCK,
                "r_tile": layers.FUSED_DENSE_R_TILE,
                "k": K + layers.FUSED_DENSE_EXTRA_SLOTS,
                "window_blocks": layers.FUSED_WINDOW_BLOCKS,
                "ovf_ssum": False, "ovf_frac": cfg.ovf_frac}
    spec = (layers.FUSED_NODE_BLOCK, layers.FUSED_EDGE_TILE)
    if cfg.tiling == "windowed":
        spec += (layers.FUSED_WINDOW_BLOCKS, cfg.ovf_frac)
        if cfg.run_cap:
            spec += (cfg.run_cap,)
    return spec


def make_batch(cfg: BenchConfig, dev: torch.device) -> GraphBatch:
    """`make_samples(GRAPHS, POINTS, seed=0)` (kNN, k = 20) stacked under
    the tiling; nodes padded up to the tiling's alignment (none at 2816)."""
    spec = tiling_spec(cfg)
    align = int(np.lcm(spec["node_block"], spec["r_tile"])) \
        if isinstance(spec, dict) else spec[0]
    max_nodes = -(-cfg.points // align) * align
    samples = make_samples(num_frames=cfg.graphs, num_points=cfg.points,
                           seed=0)
    return stack_samples(samples, max_nodes=max_nodes, bg_index=5,
                         max_edges=max_nodes * K, csr_tiling=spec,
                         device=dev)


class BenchPath:
    """One path's model (fused or unfused, from seed 0) with its Trainer or
    its Predictor, and the loop that runs it over the noise."""

    def __init__(self, cfg: BenchConfig, fused: bool, dev: torch.device):
        self.name = "fused" if fused else "unfused"
        self.mode = cfg.mode
        model = DetNet(architecture(cfg.dtype, fused, cfg.bf16_max),
                       device=dev, seed=0)
        if cfg.mode == "train":
            self.trainer = Trainer(training_config(cfg.graphs), model)
        else:
            self.predictor = Predictor(model, [], verbose=False)

    def loop(self, batch: GraphBatch, noise: torch.Tensor) -> torch.Tensor:
        """Runs every step; returns the losses (train) or the checks
        (infer: the softmax's and the boxes' sums) on the device."""
        out = []
        for eps in noise:
            b = dataclasses.replace(batch, node_feat=batch.node_feat + eps)
            if self.mode == "train":
                out.append(self.trainer.train_step(b)[0])
            else:
                cls, bb = self.predictor.forward(b)
                out.append(torch.stack([cls.sum(), bb.float().sum()]))
        return torch.stack(out)


def timed_run(path: BenchPath, batch: GraphBatch, noise: torch.Tensor,
              on_card: bool) -> Dict:
    """One run of the loop: CUDA events around it, then a synchronize once
    its last values are on the host (the host wall beside it)."""
    if on_card:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    if on_card:
        start.record()
    values = path.loop(batch, noise)
    if on_card:
        stop.record()
    host = values.cpu().numpy()
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not np.isfinite(host).all():
        raise AssertionError(f"{path.name} {path.mode} values not finite: "
                             f"{host}")
    ms = start.elapsed_time(stop) if on_card else None
    return {"ms": ms, "wall_s": wall, "last": host[-1].tolist()}


def _spread(values: List[float]) -> Dict:
    return {"median": statistics.median(values), "min": min(values),
            "max": max(values)}


def run(cfg: BenchConfig, out=print) -> Dict:
    """Warms up both paths, runs `cfg.pairs` alternating pairs, prints one
    line a run, the medians and spreads, and the last line; returns the
    last line's object."""
    dev = resolve_device(cfg.device)
    on_card = dev.type == "cuda"
    flagship = UserConfigurationReader.get_config_object(
        "TRAINING", UserConfigurationReader.read_config_file(FLAGSHIP_CONFIG))
    was_deterministic = torch.are_deterministic_algorithms_enabled()
    set_seeds(flagship.seed, flagship.deterministic)
    try:
        card = card_description() if on_card else "not measured (cpu)"
        out(f"bench: {json.dumps(dataclasses.asdict(cfg))}; card {card}; "
            f"deterministic {flagship.deterministic}, "
            "CUBLAS_WORKSPACE_CONFIG="
            f"{os.environ.get('CUBLAS_WORKSPACE_CONFIG')}")
        batch = make_batch(cfg, dev)
        edges = cfg.graphs * cfg.points * K      # as bench.py:214 counts
        noise = torch.from_numpy(np.random.default_rng(1).normal(
            size=(cfg.steps, 1, 1, batch.node_feat.shape[-1]))
            .astype(np.float32) * 0.01).to(dev)
        paths = [BenchPath(cfg, True, dev), BenchPath(cfg, False, dev)]
        for path in paths:                       # warm-up: builds, caches
            timed_run(path, batch, noise, on_card)
        rates: Dict[str, List[float]] = {p.name: [] for p in paths}
        for pair in range(cfg.pairs):
            for path in paths:
                res = timed_run(path, batch, noise, on_card)
                line = {"pair": pair, "path": path.name,
                        "tiling": cfg.tiling, "mode": cfg.mode,
                        "ms_per_step": (res["ms"] / cfg.steps
                                        if on_card else None),
                        "wall_ms_per_step": res["wall_s"] * 1e3 / cfg.steps,
                        "edges_per_s": (edges * cfg.steps / res["ms"] * 1e3
                                        if on_card else None),
                        "last": res["last"]}
                out(json.dumps(line))
                # off the card the host wall stands in, for the rehearsal
                rates[path.name].append(
                    line["edges_per_s"] if on_card
                    else edges * cfg.steps / res["wall_s"])
        summary = {p: _spread(v) for p, v in rates.items()}
        out(json.dumps({"tiling": cfg.tiling, "mode": cfg.mode,
                        "pairs": cfg.pairs, "steps": cfg.steps,
                        "edges_per_step": edges, "edges_per_s": summary,
                        "card": card}))
        value = summary["fused" if cfg.fused else "unfused"]["median"]
        return {"metric": f"{cfg.mode}_edges_per_s", "value": round(value, 1),
                "unit": "edges/s/chip",
                "vs_baseline": round(value / A100_PYG_EDGES_PER_S, 3),
                "card": card}
    finally:
        torch.use_deterministic_algorithms(was_deterministic)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="the card by default; cpu for the rehearsal")
    args = parser.parse_args(argv)
    last = run(config_from_env(device=args.device))
    print(json.dumps(last))
    return 0


if __name__ == "__main__":
    sys.exit(main())
