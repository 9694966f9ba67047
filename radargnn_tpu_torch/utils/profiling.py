"""Step timing with edges/s, the throughput unit of training.

Port of `StepStats` from `radargnn_tpu/utils/profiling.py`; the trace hooks
there wait for the port's profiling item (ROADMAP A8).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List


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
