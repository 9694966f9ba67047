"""B3 (`segment_sum_csr`, csrc/segment_sum_csr.cu) at the places the model
paths call it, on the flagship batches (5 x 2816 kNN points, k = 20, seed
0), at the flagship's five layer shapes, on one card:

  csr_dop   the CSR backward's sender sums of bf16(d_op) [E_pad, hp] (hp =
            H rounded up to 64, the columns past H zero): H columns, or all
            hp where the wrapper takes no width;
  csr_dxg   the CSR backward's d_x: bf16 d_xg [E_pad, d_in] at the senders;
  ovf_ssum  the dense backward's overflow rows d_xo [E_ovf, d_in] (bf16)
            under ovf_ssum;
  windowed  the kNN batch under the windowed tiling (run cap 4): bf16 slot
            rows and float32 overflow rows. No model path lands here since
            the windowed backward sums by sender itself; a layout check.

For each site it prints the segment lengths (the largest, the 99th
percentile, the share of empty segments) and, per layer shape, the
kernel's time (CUDA events over `reps` calls after a warm-up), the bytes
bound of the columns summed, `index_add_`'s time on the same rows cast to
float32 beforehand, and whether the kernel's sums on real-valued rows are
bitwise the float32 sum in listed order (`segment_sum_csr_listed`). With
`--phases` it also builds copies of the kernel with one phase cut out (the
shipped source is not touched) and times them:

  no_rows   the indices read and added as a value; no row is read
  no_index  the rows read in the order they lie (row e for entry e); no
            index is read
  stores    row_ptr read and the output written; no index or row is read

A cut whose code is not in the kernel once raises. One JSON line per
round and one of medians, with the card's name and power limit. Each time
is read three ways (`ms` back to back, `device_ms` queued behind a sleep
kernel, `host_ms` to issue a call: `linear_bench`'s timers). With
`--train N` it also prints the flagship CSR training's losses over N steps
as hex digits. To compare two trees, run it in both in one call, in turns
(parent, change, change, parent).

    python -m radargnn_tpu_torch.benchmarks.segsum_sites \
        [--reps 20] [--rounds 3] [--phases] [--train 4]
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import re
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List
from unittest import mock

import numpy as np
import torch

from radargnn_tpu_torch import build, smoke
from radargnn_tpu_torch.benchmarks.kernel_bench import time_ms
from radargnn_tpu_torch.benchmarks.linear_bench import queued_ms
from radargnn_tpu_torch.configs import UserConfigurationReader
from radargnn_tpu_torch.models import layers
from radargnn_tpu_torch.ops import dense_aggregate as da
from radargnn_tpu_torch.ops import segment_sum as ss
from radargnn_tpu_torch.train.trainer import set_seeds

SITES = ("csr_dop", "csr_dxg", "ovf_ssum", "windowed")

# the phase cuts: {cut: [(code, its replacement)]}
_NEXT = "nxt[u] = e + kRows + u < end ? order[e + kRows + u] : 0;"
_FIRST = "nxt[u] = begin + u < end ? order[begin + u] : 0;"
_LOOP = "for (int e = begin; e < end; e += kRows) {"
_LOAD = "load_row<kBf16, kHasB>(a, n_a, b, idx[u], pitch, c, raw[u]);"
CUTS: Dict[str, List[tuple]] = {
    "no_rows": [(_LOAD, "raw[u].lo.x = idx[u];")],
    "no_index": [(_NEXT, "nxt[u] = e + kRows + u;"),
                 (_FIRST, "nxt[u] = begin + u;")],
    "stores": [(_LOOP, "for (int e = begin; e < begin; e += kRows) {")],
}


def phase_cuts(text: str) -> Dict[str, str]:
    """{cut: the kernel's text with that phase cut out}."""
    cuts = {}
    for name, pairs in CUTS.items():
        cut = text
        for old, new in pairs:
            if cut.count(old) != 1:
                raise RuntimeError(f"segsum_sites: the cut {name} does not "
                                   f"find its code in the kernel: {old}")
            cut = cut.replace(old, new)
        cuts[name] = cut
    return cuts


def build_variants(texts: Dict[str, str]) -> Dict[str, ctypes.CDLL]:
    """Builds each {name: kernel text} with nvcc (the shipped source is not
    touched), all at once, into the git-ignored build directory; returns
    the libraries, bound as the shipped one, and prints each one's
    registers and spills."""
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else "nvcc"
    sources = []
    for name, text in texts.items():
        d = os.path.join(build.build_dir(), "segsum_sites", name)
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, "segment_sum_csr.cu")
        with open(path, "w") as f:
            f.write(text)
        sources.append(path)

    def one(name, path):
        return build.compile_shared(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"], path,
            os.path.join("segsum_sites", name, "libsegment_sum_csr.so"))

    with ThreadPoolExecutor(max_workers=len(texts)) as pool:
        built = list(pool.map(one, texts, sources))
    libs = {}
    for name, (path, log) in zip(texts, built):
        print(json.dumps({"variant": name, "registers": re.findall(
            r"Used (\d+) registers", log), "spill_stores": re.findall(
            r"(\d+) bytes spill stores", log)}))
        lib = ctypes.CDLL(path)
        ss._bind(lib)
        libs[name] = lib
    return libs


def _lengths(row_ptr: torch.Tensor) -> Dict:
    counts = np.diff(row_ptr.cpu().numpy().astype(np.int64))
    nonempty = counts[counts > 0]
    return {"segments": int(counts.size), "rows": int(counts.sum()),
            "empty_share": float((counts == 0).mean()),
            "max": int(counts.max()), "p99": float(np.percentile(counts, 99)),
            "p99_nonempty": float(np.percentile(nonempty, 99)),
            "mean_nonempty": float(nonempty.mean())}


def sites(dev, points: int = 2816, graphs: int = 5, seed: int = 0) -> Dict:
    """Each site's landing, its layer shapes' rows (real-valued, seeded)
    and the columns summed: {site: (order, row_ptr, [(a, b, width)])}."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    bf16 = torch.bfloat16

    def rows(n, d, dtype=bf16):
        return torch.randn((n, d), generator=gen, device=dev).to(dtype)

    _, model, c_loader = smoke.flagship_serving(dev, points, graphs, 1, seed,
                                                tiling="csr")
    shapes = smoke._layer_shapes(model)
    c_t = c_loader[0].flat_tiling()
    with mock.patch.object(layers, "OVF_SSUM", True):
        _, _, o_loader = smoke.flagship_serving(dev, points, graphs, 1, seed)
    o_t = o_loader[0].flat_tiling()
    w_t = smoke.knn_windowed_tiling(dev, points, graphs, seed)
    e_pad = c_t.receivers.shape[0]
    out = {"csr_dop": (*c_t.landing, []), "csr_dxg": (*c_t.landing, []),
           "ovf_ssum": (*o_t.ovf_landing, []),
           "windowed": (*w_t.landing, [])}
    for d, _, h in shapes:
        hp = da.col_pad(h)
        d_op = rows(e_pad, hp)
        d_op[:, h:] = 0
        out["csr_dop"][2].append((d_op, None, h))
        out["csr_dxg"][2].append((rows(e_pad, d + -d % 8), None, d))
        out["ovf_ssum"][2].append((rows(o_t.win[3].shape[0], d), None, d))
        out["windowed"][2].append((rows(w_t.win[0].shape[0], d),
                                   rows(w_t.win[3].shape[0], d,
                                        torch.float32), d))
    return out


def _call(a, order, row_ptr, b, width) -> Callable:
    return lambda: ss.segment_sum_csr(a, order, row_ptr, b, width=width)


def _library(a, order, row_ptr, b, width) -> Callable:
    """index_add_ of the same rows (cast to float32 beforehand) at their
    segments; unlisted rows go to a spare segment."""
    n = row_ptr.numel() - 1
    src = a[:, :width].float()
    if b is not None:
        src = torch.cat([src, b[:, :width]])
    seg = torch.full((src.shape[0],), n, dtype=torch.long, device=a.device)
    seg[order.long()] = ss.segment_ids(row_ptr)
    acc = torch.zeros((n + 1, width), dtype=torch.float32, device=a.device)
    return lambda: acc.index_add_(0, seg, src)


def check(site_rows: Dict) -> Dict:
    """Whether the kernel's sums are bitwise the listed-order float32 sum
    (columns past the width zero), per site and shape."""
    res = {}
    for site, (order, row_ptr, shapes) in site_rows.items():
        res[site] = []
        for a, b, width in shapes:
            got = _call(a, order, row_ptr, b, width)()
            want = ss.segment_sum_csr_listed(a, order, row_ptr, b, width)
            res[site].append(torch.equal(got, want))
    return res


def time_sites(site_rows: Dict, reps: int) -> Dict:
    """Per site, summed over the shapes (and per shape): `ms`, the calls
    back to back (the host's launch time included where it exceeds the
    kernel's); `device_ms`, the calls queued behind a sleep kernel (the
    kernel alone); `host_ms`, the host's time to issue one call."""
    res = {}
    for site, (order, row_ptr, shapes) in site_rows.items():
        calls = [_call(a, order, row_ptr, b, w) for a, b, w in shapes]
        ms = [time_ms(c, reps) for c in calls]
        queued = [queued_ms(c, reps) for c in calls]
        res[site] = {"ms": sum(ms), "device_ms": sum(q[0] for q in queued),
                     "host_ms": sum(q[1] for q in queued), "per_shape": ms,
                     "device_per_shape": [q[0] for q in queued]}
    return res


def csr_losses(steps: int, seed: int = 0) -> List[List[str]]:
    """The flagship CSR training's per-step losses (float.hex) over `steps`
    steps on the kNN batch under the configuration's deterministic
    setting: two trees whose kernels add in the same order give the same
    hex digits."""
    dev = torch.device("cuda")
    arch, _, loader = smoke.flagship_serving(dev, 2816, 5, 1, seed,
                                             tiling="csr")
    cfg = UserConfigurationReader.read_config_file(smoke.FLAGSHIP_CONFIG)
    train_cfg = UserConfigurationReader.get_config_object("TRAINING", cfg)
    was = torch.are_deterministic_algorithms_enabled()
    try:
        set_seeds(train_cfg.seed, train_cfg.deterministic)
        run = smoke.flagship_training(dev, arch, loader[0], seed, steps)
    finally:
        torch.use_deterministic_algorithms(was)
    return [[float(v).hex() for v in step] for step in run["losses"]]


def describe(site_rows: Dict, reps: int) -> Dict:
    """Per site: lengths, bounds and index_add_'s times per shape."""
    res = {}
    for site, (order, row_ptr, shapes) in site_rows.items():
        n = row_ptr.numel() - 1
        m = int(order.numel())
        bounds, lib = [], []
        for a, b, width in shapes:
            n_b = 0 if b is None else int((order >= a.shape[0]).sum())
            bounds.append(smoke._segsum_bound(width, m - n_b, n_b, n))
            lib.append(time_ms(_library(a, order, row_ptr, b, width), reps))
        res[site] = {"lengths": _lengths(row_ptr),
                     "widths": [w for _, _, w in shapes],
                     "pitches": [a.shape[1] for a, _, _ in shapes],
                     "bound_ms": sum(r["bound_ms"] for r in bounds),
                     "bound_per_shape": [r["bound_ms"] for r in bounds],
                     "bytes_per_shape": [r["bytes"] for r in bounds],
                     "index_add_ms": sum(lib), "index_add_per_shape": lib}
    return res


def run(reps: int = 20, rounds: int = 3, phases: bool = False,
        train: int = 0, seed: int = 0, out: Callable = print) -> Dict:
    site_rows = sites(torch.device("cuda"), seed=seed)
    card = smoke.card_description()
    head = {"card": card, "reps": reps,
            "bitwise_listed": check(site_rows),
            "sites": describe(site_rows, reps)}
    if train:
        head["csr_losses"] = csr_losses(train, seed)
    out(json.dumps(head))
    variants = {"whole": None}
    if phases:
        with open(build.source_path("csrc", "segment_sum_csr.cu")) as f:
            variants.update(build_variants(phase_cuts(f.read())))
    for v, lib in variants.items():
        if lib is not None:
            with mock.patch.object(ss, "load_kernel", lambda lib=lib: lib):
                head["bitwise_listed_" + v] = check(site_rows)
    keys = ("ms", "device_ms", "host_ms")
    times: Dict[str, Dict[str, Dict[str, List[float]]]] = {
        v: {s: {k: [] for k in keys} for s in SITES} for v in variants}
    for r in range(rounds):
        order = list(variants) if r % 2 == 0 else list(reversed(variants))
        for v in order:
            patch = mock.patch.object(ss, "load_kernel",
                                      lambda lib=variants[v]: lib) \
                if variants[v] is not None else contextlib.nullcontext()
            with patch:
                got = time_sites(site_rows, reps)
            for s in SITES:
                for k in keys:
                    times[v][s][k].append(got[s][k])
            out(json.dumps({"round": r, "variant": v, "card": card,
                            **{s: got[s] for s in SITES}}))
    medians = {v: {s: {k: float(np.median(ts)) for k, ts in t.items()}
                   for s, t in per.items()} for v, per in times.items()}
    summary = {"card": card, "median_ms": medians, "rounds": rounds,
               "bound_ms": {s: head["sites"][s]["bound_ms"] for s in SITES},
               "index_add_ms": {s: head["sites"][s]["index_add_ms"]
                                for s in SITES}}
    out(json.dumps(summary))
    return {"head": head, "times": times, "summary": summary}


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--phases", action="store_true")
    p.add_argument("--train", type=int, default=0,
                   help="also the CSR training's losses over N steps")
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("segsum_sites needs a CUDA card")
    run(a.reps, a.rounds, a.phases, a.train, a.seed)


if __name__ == "__main__":
    main()
