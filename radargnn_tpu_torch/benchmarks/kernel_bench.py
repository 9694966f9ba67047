"""Fused message matmul + segment max against the library path, at flagship
scale, on one card.

Port of the JAX package's benchmarks/pallas_bench.py, at its defaults
(450,560 edges, 22,528 nodes, d_in = H = 464, seed 0, receivers sorted,
receiver-CSR tiles of 128 nodes x 256 slots). It times

  library: torch.addmm(b, m_in, W), then scatter_reduce_ "amax" into zeros
           (the counterpart of the JAX bench's XLA variant A: the [E, H]
           messages go through device memory)
  kernel:  ops.message_segment_max.fused_message_segment_max (csrc/
           msg_segmax.cu: the messages never leave the chip)

with CUDA events over `reps` calls after a warm-up, checks that the two
agree, and prints one JSON line per variant, `segmax_library_ms` and
`segmax_kernel_ms`, with the card's name. The JAX bench ran each variant in
a scan over noisy inputs to defeat XLA's caching; eager PyTorch caches
nothing, so the port times the calls on the same inputs.

    python -m radargnn_tpu_torch.benchmarks.kernel_bench [--edges N ...]

On the CPU (`--device cpu`, the tests' rehearsal) it runs both paths and
checks them, and reports no time: a CPU time is not the card's.
"""

from __future__ import annotations

import argparse
import json
from typing import Callable, Dict

import numpy as np
import torch

from radargnn_tpu_torch.device import DeviceLike, resolve_device
from radargnn_tpu_torch.ops.message_segment_max import \
    fused_message_segment_max
from radargnn_tpu_torch.ops.windowed_tiles import prepare_csr_tiles

NODE_BLOCK, EDGE_TILE = 128, 256
# the kernel against the library path: both sum d_in float32 products, in
# different orders (cuBLAS's and the kernel's fma chain), about 1e-6 of the
# output's scale; a bf16 or TF32 product would be about 1e-3
AGREE_RTOL = 1e-5


def time_ms(fn: Callable, reps: int) -> float:
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


def run(device: DeviceLike = None, edges: int = 450_560, nodes: int = 22_528,
        din: int = 464, h: int = 464, seed: int = 0, reps: int = 16,
        out: Callable = print) -> Dict:
    """Builds the inputs from `seed`, runs and (on the card) times both
    paths; returns the times, their agreement and the work's size."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    rng = np.random.default_rng(seed)
    m_in = rng.normal(size=(edges, din)).astype(np.float32) * 0.05
    receivers = np.sort(rng.integers(0, nodes, edges)).astype(np.int32)
    w = rng.normal(size=(din, h)).astype(np.float32) * 0.05
    b = rng.normal(size=(h,)).astype(np.float32)
    perm, tile_blocks, padded_recv = prepare_csr_tiles(
        receivers, np.ones(edges, bool), nodes, NODE_BLOCK, EDGE_TILE)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    m_in_d, w_d, b_d = t(m_in), t(w), t(b)
    m_in_p = t(m_in[perm])
    recv_p, blocks = t(padded_recv), t(tile_blocks)
    index = t(receivers).long()[:, None].expand(edges, h)

    def library():
        m = torch.addmm(b_d, m_in_d, w_d)
        return torch.zeros((nodes, h), dtype=torch.float32,
                           device=dev).scatter_reduce_(0, index, m, "amax",
                                                       include_self=False)

    def kernel():
        return fused_message_segment_max(
            m_in_p, w_d, b_d, recv_p, blocks, num_nodes=nodes,
            node_block=NODE_BLOCK, edge_tile=EDGE_TILE)

    want, got = library(), kernel()
    err = float((got - want).abs().max())
    scale = max(float(want.abs().max()), 1.0)
    if not torch.isfinite(got).all() or err > AGREE_RTOL * scale:
        raise AssertionError(f"kernel_bench: the kernel disagrees with the "
                             f"library path: max |diff| {err:.3e} (scale "
                             f"{scale:.3e}, limit {AGREE_RTOL} of it)")
    del want, got
    res = {"device": torch.cuda.get_device_name(dev) if on_card else "cpu",
           "edges": edges, "nodes": nodes, "din": din, "h": h,
           "tiles": int(tile_blocks.shape[0]), "max_abs_err": err,
           "flops": 2.0 * edges * din * h,
           "library_ms": time_ms(library, reps) if on_card else None,
           "kernel_ms": time_ms(kernel, reps) if on_card else None}
    for name in ("library", "kernel"):
        out(json.dumps({"metric": f"segmax_{name}_ms",
                        "value": res[f"{name}_ms"], "unit": "ms/call",
                        "device": res["device"]}))
    return res


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    parser.add_argument("--edges", type=int, default=450_560)
    parser.add_argument("--nodes", type=int, default=22_528)
    parser.add_argument("--din", type=int, default=464)
    parser.add_argument("--h", type=int, default=464)
    parser.add_argument("--reps", type=int, default=16)
    args = parser.parse_args(argv)
    run(args.device, args.edges, args.nodes, args.din, args.h,
        reps=args.reps)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
