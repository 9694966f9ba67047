"""The fused linear (csrc/fused_linear.cu, B9) against torch.addmm, with and
without ReLU, on one card, in rounds that alternate which runs first.

cuBLAS chooses its float32 GEMM by the workspace it may use, and the port's
deterministic training (`set_seeds(..., True)`) limits that workspace
(`CUBLAS_WORKSPACE_CONFIG=:4096:8`, which `chip_smoke.py` sets before torch
starts): `addmm` at 14,080 x 224 -> 464 then reads 0.12-0.17 ms against
~0.09 with cuBLAS's default workspace (PERF.md). This bench runs in a
process of its own, so the library call is timed under whatever the caller
leaves in the environment (`smoke.check_linear_kernel` removes the setting:
the library at its fastest); the JSON says which.

For each case (rows, d_in, d_out, relu, weight scale), seeded inputs as
`smoke.check_linear_kernel` makes them: the kernel's output against its
plain version (smoke.F32_RTOL of the output's scale), then `rounds` rounds
of the kernel, `addmm` + ReLU and `addmm`, the order reversed every other
round. Each call is read by two timers, each the mean of `reps` calls by
CUDA events:

  ms         the calls issued back to back (`kernel_bench.time_ms`, the
             timer of every other kernel's row): what a caller sees, the
             host's launch time included where it exceeds the device time
  device_ms  the calls queued behind a sleep kernel: the device time alone
  host_ms    the host's time to issue one call (wall clock over the queued
             calls)

Prints one JSON line per case (medians and rounds) with the card's name
and power limit.

    python -m radargnn_tpu_torch.benchmarks.linear_bench [--cases JSON]
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, Dict, List

import numpy as np
import torch

from radargnn_tpu_torch.benchmarks.kernel_bench import time_ms
from radargnn_tpu_torch.ops import fused_linear as fl

# (rows, d_in, d_out, relu, weight scale): kernel_check's shape and the
# flagship's node embedding width into its first conv layer over the kNN
# batch's 14,080 nodes
CASES = [(4096, 256, 512, True, 0.05),
         (14080, 224, 464, False, 224 ** -0.5)]
ROUNDS = 6


def linear_inputs(gen: torch.Generator, m: int, k: int, n: int,
                  scale: float, dev) -> tuple:
    """x [m, k], w [k, n] (times `scale`), b [n], float32 on `dev`."""
    x = torch.randn((m, k), generator=gen).to(dev)
    w = (torch.randn((k, n), generator=gen) * scale).to(dev)
    b = torch.randn((n,), generator=gen).to(dev)
    return x, w, b


# cycles of the sleep kernel the timed calls queue behind (~10 ms)
SLEEP_CYCLES = 20_000_000


def queued_ms(fn: Callable, reps: int) -> tuple:
    """(device ms, host ms) of one fn() call: the mean device time by CUDA
    events over `reps` calls after one warm-up call, the calls enqueued
    behind a sleep kernel, so that the card does not wait for the host
    between them; and the host's mean wall time to issue one of them."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / reps
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps, host


def alternating(fns: Dict[str, Callable], rounds: int, reps: int
                ) -> Dict[str, List[float]]:
    """The times of each fn in `rounds` rounds that reverse the order every
    other round, under the keys `<prefix>ms` (back to back, `time_ms`),
    `<prefix>device_ms` and `<prefix>host_ms` (`queued_ms`), each fn's
    prefix its key in `fns`."""
    times = {f"{p}{t}": [] for p in fns
             for t in ("ms", "device_ms", "host_ms")}
    for r in range(rounds):
        for p in (fns if r % 2 == 0 else reversed(list(fns))):
            times[f"{p}ms"].append(time_ms(fns[p], reps))
            dev_ms, host_ms = queued_ms(fns[p], reps)
            times[f"{p}device_ms"].append(dev_ms)
            times[f"{p}host_ms"].append(host_ms)
    return times


def run(cases=CASES, seed: int = 0, rounds: int = ROUNDS, reps: int = 20,
        out: Callable = print) -> List[Dict]:
    from radargnn_tpu_torch.smoke import F32_RTOL, card_description

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(seed)
    card = card_description()
    rows = []
    for m, k, n, relu, scale in cases:
        x, w, b = linear_inputs(gen, m, k, n, scale, dev)
        got = fl.fused_linear(x, w, b, relu=relu)
        want = fl.fused_linear_plain(x, w, b, relu=relu)
        torch.cuda.synchronize()
        rel = float((got - want).abs().max()) / max(
            float(want.abs().max()), 1.0)
        if rel > F32_RTOL:
            raise AssertionError(f"fused_linear disagrees with its plain "
                                 f"version at {m} x {k} -> {n}: {rel:.3e}")
        times = alternating(
            {"": lambda: fl.fused_linear(x, w, b, relu=relu),
             "addmm_relu_": lambda: torch.addmm(b, x, w).relu_(),
             "addmm_": lambda: torch.addmm(b, x, w)}, rounds, reps)
        row = {"rows": m, "d_in": k, "d_out": n, "relu": relu,
               "max_rel_err": rel, "card": card,
               "cublas_workspace_config":
                   os.environ.get("CUBLAS_WORKSPACE_CONFIG"),
               **{name: float(np.median(ts)) for name, ts in times.items()},
               **{f"{name}_rounds": ts for name, ts in times.items()}}
        out(json.dumps(row))
        rows.append(row)
    return rows


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cases", type=json.loads, default=CASES,
                   help="JSON list of [rows, d_in, d_out, relu, scale]")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--rounds", type=int, default=ROUNDS)
    p.add_argument("--reps", type=int, default=20)
    a = p.parse_args()
    run(a.cases, a.seed, a.rounds, a.reps)


if __name__ == "__main__":
    main()
