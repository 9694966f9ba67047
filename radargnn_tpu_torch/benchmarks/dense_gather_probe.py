"""What the dense gather-max (csrc/dense_fwd_v4.cu) pays for its reads of
the node projection y_s, on the flagship kNN batch, on one card.

At the flagship's wide layer shape (d_in 224, d_e 16, H 464), on the batch
of `smoke.flagship_serving` (5 x 2816 points, dense tiling), it times the
gather-max in serving mode and in VJP mode (inner and the routing bits)
with CUDA events over `reps` calls after a warm-up, on the batch's senders
and on the same slots with other senders: all at the window's first node
(the least y_s traffic the layout allows), and drawn at random within the
window (no locality). It also counts how many distinct senders each tile
reads, the reuse that staging a tile's distinct rows exploits. Prints one
JSON line with the card's name and power limit.

    python -m radargnn_tpu_torch.benchmarks.dense_gather_probe [--reps N]
"""

from __future__ import annotations

import argparse
import json
from typing import Dict

import numpy as np
import torch

from radargnn_tpu_torch.benchmarks.kernel_bench import time_ms
from radargnn_tpu_torch.ops import dense_aggregate as da
from radargnn_tpu_torch.smoke import card_description, flagship_serving


def run(reps: int = 20, seed: int = 0) -> Dict:
    dev = torch.device("cuda")
    _, _, loader = flagship_serving(dev, 2816, 5, 1, seed)
    tiling = loader[0].flat_tiling()
    r_tile, k = tiling.dense
    sloc, t_win, _, ovf_s, ovf_r, _ = tiling.win
    n = tiling.landing.row_ptr.shape[0] - 1
    gen = torch.Generator().manual_seed(seed)
    d, de, h = 224, 16, 464

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    bf16 = torch.bfloat16
    x, w_s = rand(n, d).to(bf16), rand(d, h, scale=d ** -0.5).to(bf16)
    e_t = rand(sloc.shape[0], de).to(bf16)
    w_e = rand(de, h, scale=de ** -0.5).to(bf16)
    y_s = da.dense_proj(x, w_s)
    inner_o = da.overflow_maxima(da.dense_overflow_operand(
        y_s, rand(ovf_s.shape[0], de).to(bf16), w_e, ovf_s), ovf_r, n)
    offset = rand(n, h)
    kw = dict(r_tile=r_tile, k=k, node_block=tiling.node_block)
    gen_p = torch.Generator().manual_seed(seed + 1)
    valid = sloc >= 0
    shuffled = torch.randint(0, tiling.node_block * 3, sloc.shape,
                             generator=gen_p).to(dev)
    probes = {}
    for name, senders in (("real", sloc),
                          ("one_row", torch.where(valid, 0, -1)),
                          ("shuffled", torch.where(valid, shuffled, -1))):
        args = (y_s, e_t, w_e, senders.to(torch.int32).contiguous(), t_win,
                inner_o, offset)
        probes[name] = {
            "serving_ms": time_ms(lambda: da.dense_fwd(*args, **kw), reps),
            "vjp_ms": time_ms(lambda: da.dense_fwd(*args, emit_inner=True,
                                                   **kw), reps)}
    per_tile = sloc.reshape(-1, r_tile * k).cpu().numpy()
    distinct = np.array([np.unique(t[t >= 0]).size for t in per_tile])
    slots = (per_tile >= 0).sum(axis=1)
    reuse = {"distinct_senders_per_tile": np.percentile(
                 distinct, [0, 50, 90, 100]).tolist(),
             "valid_slots_per_tile_median": float(np.median(slots))}
    return {"card": card_description(), "shape": [d, de, h],
            "sender_probes": probes, "reuse": reuse}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args()
    print(json.dumps(run(args.reps)))


if __name__ == "__main__":
    main()
