"""Where the time of the CSR gather-max walk goes (csrc/csr_walk.cuh), phase
by phase, for both kernels on it: the v1 hoisted forward (B6,
hoisted_fwd_v1.cu) on the kNN batch under the v1 tiles, and the CSR forward
given y_s (B5, csr_fwd_v2.cu) on the kNN batch under the CSR tiling, on one
card.

It builds each kernel four times from the sources in the checkout, into the
git-ignored build directory: as it is, and with one phase cut out of a copy
of the walk (the shipped sources are not touched):

  no_landing  the ops folded into one register per lane instead of landed
              in shared memory (a sentinel store keeps them live)
  no_chain    no edge chain: the edge rows are not read, op = y_s (+ b)
  no_gather   no y_s gather: op = the edge chain (+ b)

and times each at the flagship's five layer shapes (summed, serving mode)
with CUDA events over `reps` calls, in `rounds` rounds that alternate the
order of the variants; prints one JSON line per kernel with the medians
and the card's name and power limit.

A tool for developers: no check and no other script reads its output. Its
cuts match the walk's text, so when the walk next changes, remove it
together with its test (`test_walk_phase_cuts_find_their_code`) rather
than keep the two in step; PERF.md keeps its readings.

    python -m radargnn_tpu_torch.benchmarks.walk_phases [--reps N]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List
from unittest import mock

import numpy as np
import torch

from radargnn_tpu_torch import build, smoke
from radargnn_tpu_torch.benchmarks.kernel_bench import time_ms
from radargnn_tpu_torch.models.mlp import matmul_f32
from radargnn_tpu_torch.ops import csr_aggregate as ca
from radargnn_tpu_torch.ops import dense_aggregate as da
from radargnn_tpu_torch.ops import hoisted_aggregate as ha

_LAND = ("        land_walk_runs(keys, ep, counted, base, node_block, "
         "num_nodes, g,\n                       tq);")
# each cut: (text of csr_walk.cuh, its replacement)
CUTS: Dict[str, List[tuple]] = {
    "whole": [],
    "no_landing": [
        ("    GroupSlots next{};",
         "    GroupSlots next{};\n    float sink = 0.0f;"),
        (_LAND, """#pragma unroll
        for (int j = 0; j < kWalkQuads; ++j)
#pragma unroll
            for (int q = 0; q < 8; ++q) sink = fmaxf(sink, ep[j][q]);"""),
        ("    __syncthreads();\n\n    // epilogue",
         "    if (sink == 1.5e-38f) out[0] = sink;\n    __syncthreads();\n\n"
         "    // epilogue"),
    ],
    "no_chain": [("for (int k0 = 0; k0 < de; k0 += 4) {",
                  "for (int k0 = 0; k0 < 0; k0 += 4) {")],
    "no_gather": [("const bool in = s >= 0 &&", "const bool in = false &&")],
}
KERNELS = {"hoisted_fwd_v1": ("hoisted_fwd_v1.cu", ha),
           "csr_fwd_v2": ("csr_fwd_v2.cu", ca)}


def _variant_source(src: str, cut: str) -> str:
    """A copy of the csrc headers with `cut` applied to csr_walk.cuh, and of
    `src`, in its own build directory; returns the copied source's path."""
    d = os.path.join(build.build_dir(), "walk_phases", cut)
    os.makedirs(d, exist_ok=True)
    for path in glob.glob(build.source_path("csrc", "*.cuh")) + [
            build.source_path("csrc", src)]:
        shutil.copy(path, d)
    walk = os.path.join(d, "csr_walk.cuh")
    with open(walk) as f:
        text = f.read()
    for old, new in CUTS[cut]:
        if text.count(old) != 1:
            raise RuntimeError(f"walk_phases: cut {cut} does not find its "
                               f"code in csr_walk.cuh: {old!r}")
        text = text.replace(old, new)
    with open(walk, "w") as f:
        f.write(text)
    return os.path.join(d, src)


def build_variants() -> Dict[tuple, object]:
    """Builds every (kernel, cut) with nvcc, all at once; returns the loaded
    libraries, bound as the shipped ones."""
    import ctypes

    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else "nvcc"
    jobs = [(k, c) for k in KERNELS for c in CUTS]

    # the copies first, one after another (a cut's two kernels share its
    # directory), then one nvcc each, all started together
    sources = [_variant_source(KERNELS[k][0], c) for k, c in jobs]

    def one(job, src):
        kernel, cut = job
        path, _ = build.compile_shared(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-shared", "-Xcompiler", "-fPIC"], src,
            os.path.join("walk_phases", cut, f"lib{kernel}.so"),
            deps=glob.glob(os.path.join(os.path.dirname(src), "*.cuh")))
        return path

    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        paths = list(pool.map(one, jobs, sources))
    libs = {}
    for (kernel, cut), path in zip(jobs, paths):
        lib = ctypes.CDLL(path)
        KERNELS[kernel][1]._bind_fwd(lib)
        libs[kernel, cut] = lib
    return libs


def _calls(kernel: str, seed: int) -> List[Callable]:
    """One call per flagship layer shape of `kernel`'s wrapper (serving
    mode, y_s given), on the smoke's kNN batch."""
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(seed)

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    _, model, loader = smoke.flagship_serving(dev, 2816, 5, 1, seed)
    shapes = smoke._layer_shapes(model)
    calls = []
    if kernel == "hoisted_fwd_v1":
        v1 = smoke.v1_tiling(loader[0])
        n, e_pad = v1.num_nodes, v1.recv.shape[0]
        kw = dict(node_block=v1.node_block, edge_tile=v1.edge_tile)
        for d, de, h in shapes:
            args = (matmul_f32(rand(n, d), rand(d, h, scale=d ** -0.5)),
                    rand(e_pad, de), rand(de, h, scale=de ** -0.5), rand(h),
                    v1.senders, v1.recv, v1.blocks, rand(n, h))
            calls.append(lambda a=args: ha.hoisted_fwd_cuda(*a, **kw))
        return calls
    _, _, c_loader = smoke.flagship_serving(dev, 2816, 5, 1, seed,
                                            tiling="csr")
    tiling = c_loader[0].flat_tiling()
    n = tiling.landing.row_ptr.shape[0] - 1
    e_pad = tiling.receivers.shape[0]
    layout = (tiling.senders, tiling.receivers, tiling.blocks)
    kw = dict(node_block=tiling.node_block, edge_tile=tiling.edge_tile)
    cd = da.gather_dtype(dev)
    for d, de, h in shapes:
        x, w_s = rand(n, d).to(cd), rand(d, h, scale=d ** -0.5).to(cd)
        ops = ca.csr_operands(x, w_s, rand(e_pad, de),
                              rand(de, h, scale=de ** -0.5))
        y_s, offset = da.dense_proj(*ops[:2]), rand(n, h)
        calls.append(lambda o=ops, y=y_s, off=offset: ca.csr_fwd_cuda(
            *o, *layout, off, y_s=y, **kw))
    return calls


def run(reps: int = 20, rounds: int = 4, seed: int = 0,
        out: Callable = print) -> Dict:
    libs = build_variants()
    results = {}
    for kernel, (_, mod) in KERNELS.items():
        calls = _calls(kernel, seed)
        times = {cut: [] for cut in CUTS}
        for r in range(rounds):
            order = list(CUTS) if r % 2 == 0 else list(reversed(CUTS))
            for cut in order:
                with mock.patch.object(mod, "load_fwd_kernel",
                                       lambda lib=libs[kernel, cut]: lib):
                    times[cut].append(sum(time_ms(c, reps) for c in calls))
        row = {"kernel": kernel, "card": smoke.card_description(),
               "ms": {cut: float(np.median(ts)) for cut, ts in times.items()},
               "rounds": times, "reps": reps}
        out(json.dumps(row))
        results[kernel] = row
    return results


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--rounds", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args()
    run(a.reps, a.rounds, a.seed)


if __name__ == "__main__":
    main()
