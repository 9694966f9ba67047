"""Where the serving time goes on the card.

Runs the flagship serving path (the configuration_radarscenes.yml DetNet with
seeded weights, requests of 5 x 2816-point synthetic frames, `Predictor.
forward`) under torch.profiler and prints, as one JSON line: the card, the
per-request wall time (unprofiled, and profiled beside it), serving
edges/s, the device-busy time (the union of the card's kernel intervals),
the idle share against the unprofiled wall, and the device time by kernel
name. Run from the root of a checkout on a machine with a CUDA card:

    python -m radargnn_tpu_torch.trace_serving [--requests N]
        [--graph knn|radius] [--tiling csr] [--trace FILE]

`--graph knn` (the default) serves kNN graphs under the dense tiling;
`--graph radius` serves radius graphs under the windowed tiling (the
configuration with three fields replaced, `smoke.flagship_configs`);
`--tiling csr` serves either under the CSR tiling (fused_tiling "csr").
`--trace` also writes the Chrome trace of the profiled window to FILE.
"""

from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

import torch

from radargnn_tpu_torch.device import resolve_device
from radargnn_tpu_torch.postprocess.inference import Predictor
from radargnn_tpu_torch.smoke import card_description, flagship_serving


def _busy_us(intervals: List[tuple]) -> float:
    """Length of the union of [start, end) intervals, in µs."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        busy += e - max(s, end)
        end = e
    return busy


def device_profile(fn: Callable[[], None], trace_file: Optional[str] = None
                   ) -> Tuple[list, float]:
    """Runs `fn` under torch.profiler; returns the card's kernel events and
    their busy time (the union of their intervals, µs). `trace_file` also
    gets the Chrome trace."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
    # the card's kernels; not the spans user annotations (such as
    # Optimizer.step) leave on the device timeline
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    if trace_file:
        prof.export_chrome_trace(trace_file)
    return kernels, _busy_us([(e.time_range.start, e.time_range.end)
                              for e in kernels])


def by_name(kernels: list, per: int, top: int) -> List[Dict]:
    """Device µs and calls by kernel name, per `per` (request or step),
    largest first."""
    acc: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        acc[e.name][0] += e.time_range.elapsed_us()
        acc[e.name][1] += 1
    ranked = sorted(acc.items(), key=lambda kv: -kv[1][0])
    return [{"name": name[:120], "us": t / per, "calls": n / per}
            for name, (t, n) in ranked[:top]]


def trace(requests: int = 5, points: int = 2816, graphs: int = 5,
          seed: int = 0, top: int = 25, trace_file: Optional[str] = None,
          graph: str = "knn", tiling: Optional[str] = None) -> Dict:
    """Profiles `requests` served batches of `graph` (under `tiling`, or
    the one the configuration selects) after one warm-up request."""
    dev = resolve_device("cuda")
    _, model, loader = flagship_serving(dev, points, graphs, requests + 1,
                                        seed, graph=graph, tiling=tiling)
    predictor = Predictor(model, loader, verbose=False)
    predictor.forward(loader[0])                      # warm-up (and build)
    torch.cuda.synchronize()

    def serve() -> List[float]:
        wall = []
        for batch in loader[1:]:
            t0 = time.perf_counter()
            predictor.forward(batch)
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e6)
        return wall

    # the profiler slows the host side down, so the idle share is taken
    # against the same requests served without it
    plain_wall = serve()
    wall: List[float] = []
    kernels, busy = device_profile(lambda: wall.extend(serve()), trace_file)
    return {
        "card": card_description(), "graph": graph, "tiling": tiling,
        "requests": requests, "graphs": graphs, "points": points,
        "wall_us_per_request": plain_wall,
        "profiled_wall_us_per_request": wall,
        "device_busy_us_per_request": busy / requests if kernels else None,
        "idle_share": 1.0 - busy / sum(plain_wall) if kernels else None,
        "edges_per_s": (sum(b.host_valid_edges for b in loader[1:])
                        / (sum(plain_wall) * 1e-6)),
        "kernel_launches_per_request": len(kernels) / requests,
        "device_us_per_request_by_kernel": by_name(kernels, requests, top),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=5)
    ap.add_argument("--graph", choices=("knn", "radius"), default="knn")
    ap.add_argument("--tiling", choices=("csr",), default=None,
                    help="the CSR tiling instead of the configuration's")
    ap.add_argument("--trace", default=None,
                    help="also write the Chrome trace to this file")
    args = ap.parse_args(argv)
    print(json.dumps(trace(args.requests, trace_file=args.trace,
                           graph=args.graph, tiling=args.tiling)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
