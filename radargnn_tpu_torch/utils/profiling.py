"""Step timing with edges/s (the throughput unit of training), a trace hook
and a metrics line writer.

Port of `radargnn_tpu/utils/profiling.py`: `StepStats` and `StepTimer`
keep per-step times and edge counts; `trace` wraps a block in
`torch.profiler` (CPU and, on the card, CUDA activities) and writes a
Chrome trace, where the JAX package's wraps `jax.profiler`;
`write_metrics_jsonl` appends the same JSON line as the JAX package's.
The JAX package's trainer records its epochs through `StepStats` alone,
and so does the port's; `StepTimer` and `trace` are for callers that time
or trace a step themselves.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Iterator, List, Optional

import torch


@dataclass
class StepStats:
    step_times_s: List[float] = field(default_factory=list)
    edges_per_step: List[int] = field(default_factory=list)

    def record(self, dt: float, num_edges: int) -> None:
        self.step_times_s.append(dt)
        self.edges_per_step.append(num_edges)

    @property
    def total_edges(self) -> int:
        return sum(self.edges_per_step)

    @property
    def total_time(self) -> float:
        return sum(self.step_times_s)

    def edges_per_s(self, skip_first: int = 1) -> float:
        """Throughput excluding warm-up steps."""
        times = self.step_times_s[skip_first:]
        edges = self.edges_per_step[skip_first:]
        return sum(edges) / sum(times) if times and sum(times) > 0 else 0.0

    def mean_step_ms(self, skip_first: int = 1) -> float:
        times = self.step_times_s[skip_first:]
        return 1000.0 * sum(times) / len(times) if times else 0.0

    def summary(self) -> dict:
        return {
            "steps": len(self.step_times_s),
            "mean_step_ms": round(self.mean_step_ms(), 3),
            "edges_per_s": round(self.edges_per_s(), 1),
            "total_edges": self.total_edges,
        }


class StepTimer:
    """Times steps on `device`: on the card it waits for the device's work
    before it reads the clock, on entry and on exit, so a step's time is
    its device time plus its host time (CUDA calls return before the work
    is done); on the CPU there is nothing to wait for."""

    def __init__(self, stats: Optional[StepStats] = None,
                 device: Optional[torch.device] = None):
        self.stats = stats or StepStats()
        self.device = torch.device(device) if device is not None else None

    def _sync(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def step(self, num_edges: int) -> Iterator[None]:
        self._sync()
        t0 = time.perf_counter()
        yield
        self._sync()
        self.stats.record(time.perf_counter() - t0, num_edges)


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """torch.profiler around a block, with CPU activities and, where a card
    is present, CUDA ones; writes `trace.json` (Chrome trace format) into
    `log_dir` at the end: `with trace('tb'): step()`."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def write_metrics_jsonl(path: str, metric: str, value: float, unit: str,
                        **extra) -> None:
    """Appends one JSON line of metrics (driver/bench compatible format)."""
    record = {"metric": metric, "value": value, "unit": unit, **extra}
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")
