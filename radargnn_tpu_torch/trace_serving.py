"""Where the serving time goes on the card.

Runs the flagship serving path (the configuration_radarscenes.yml DetNet with
seeded weights, requests of 5 x 2816-point synthetic frames, the dense kNN
tiling, `Predictor.forward`) under torch.profiler and prints, as one JSON
line: the card, the per-request wall time (unprofiled, and profiled
beside it), serving edges/s, the device-busy time (the union of the card's
kernel intervals), the idle share against the unprofiled wall, and the
device time by kernel name. Run from the root of a checkout on a machine with a CUDA card:

    python -m radargnn_tpu_torch.trace_serving [--requests N] [--trace FILE]

`--trace` also writes the Chrome trace of the profiled window to FILE.
"""

from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict
from typing import Dict, List, Optional

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


def trace(requests: int = 5, points: int = 2816, graphs: int = 5,
          seed: int = 0, top: int = 25,
          trace_file: Optional[str] = None) -> Dict:
    """Profiles `requests` served batches after one warm-up request."""
    dev = resolve_device("cuda")
    _, model, loader = flagship_serving(dev, points, graphs, requests + 1,
                                        seed)
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
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        wall = serve()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += e.time_range.elapsed_us()
        by_name[e.name][1] += 1
    busy = _busy_us([(e.time_range.start, e.time_range.end)
                     for e in kernels])
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    result = {
        "card": card_description(),
        "requests": requests, "graphs": graphs, "points": points,
        "wall_us_per_request": plain_wall,
        "profiled_wall_us_per_request": wall,
        "device_busy_us_per_request": busy / requests if kernels else None,
        "idle_share": 1.0 - busy / sum(plain_wall) if kernels else None,
        "edges_per_s": (sum(b.host_valid_edges for b in loader[1:])
                        / (sum(plain_wall) * 1e-6)),
        "kernel_launches_per_request": len(kernels) / requests,
        "device_us_per_request_by_kernel": [
            {"name": name[:120], "us": t / requests, "calls": n / requests}
            for name, (t, n) in ranked[:top]],
    }
    if trace_file:
        prof.export_chrome_trace(trace_file)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=5)
    ap.add_argument("--trace", default=None,
                    help="also write the Chrome trace to this file")
    args = ap.parse_args(argv)
    print(json.dumps(trace(args.requests, trace_file=args.trace)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
