"""The port's bench (`python -m radargnn_tpu_torch.benchmarks.bench`) as a
child process on the CPU at a tiny size: its four cells (dense train and
infer, CSR train, windowed train) end with bench.py's last line, and so
does the dense train cell under BENCH_BF16_MAX=1 (bf16 routing). No time
is measured here; the CPU value is the host wall's rate.

The children start together, one thread each (a module fixture), so the
file takes about as long as one child."""

import json
import math
import os
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {"BENCH_DEVICE": "cpu", "BENCH_POINTS": "64", "BENCH_GRAPHS": "2",
        "BENCH_STEPS": "2", "BENCH_PAIRS": "1", "OMP_NUM_THREADS": "1"}
CELLS = [("dense", "train"), ("dense", "infer"), ("csr", "train"),
         ("windowed", "train")]


def _start(**env):
    env = dict(os.environ, PYTHONPATH=_REPO, **TINY, **env)
    return subprocess.Popen(
        [sys.executable, "-m", "radargnn_tpu_torch.benchmarks.bench"],
        cwd=_REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


@pytest.fixture(scope="module")
def children():
    procs = {}
    for tiling, mode in CELLS:
        # the spread tiler (run cap 4) sends ~40 % of a 64-point kNN
        # frame's edges to overflow; the flagship frames need 4 %
        extra = {"BENCH_OVF_FRAC": "0.5"} if tiling == "windowed" else {}
        procs[tiling, mode] = _start(BENCH_TILING=tiling, BENCH_MODE=mode,
                                     **extra)
    procs["bf16_max"] = _start(BENCH_BF16_MAX="1")
    yield procs
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def _result(proc):
    out, err = proc.communicate(timeout=600)
    return proc.returncode, out, err


@pytest.mark.parametrize("tiling,mode", CELLS)
def test_bench_cells_end_with_the_metric_line(children, tiling, mode):
    code, out, err = _result(children[tiling, mode])
    assert code == 0, err[-3000:]
    lines = out.strip().splitlines()
    last = json.loads(lines[-1])
    assert set(last) == {"metric", "value", "unit", "vs_baseline", "card"}
    assert last["metric"] == f"{mode}_edges_per_s"
    assert last["unit"] == "edges/s/chip"
    assert math.isfinite(last["value"]) and last["value"] > 0
    assert last["vs_baseline"] == round(last["value"] / 7e6, 3)
    assert last["card"] == "not measured (cpu)"
    runs = [json.loads(s) for s in lines[-4:-2]]
    assert [(r["path"], r["tiling"], r["mode"]) for r in runs] == [
        ("fused", tiling, mode), ("unfused", tiling, mode)]
    assert all(r["ms_per_step"] is None for r in runs)
    summary = json.loads(lines[-2])
    assert set(summary["edges_per_s"]) == {"fused", "unfused"}
    assert summary["edges_per_step"] == 2 * 64 * 20
    assert round(summary["edges_per_s"]["fused"]["median"], 1) == \
        last["value"]


def test_bench_refuses_bf16_max(children):
    """BENCH_BF16_MAX=1, once refused, runs the dense train cell with the
    fused path's backward routing by bf16 equality, to the same last
    line."""
    code, out, err = _result(children["bf16_max"])
    assert code == 0, err[-3000:]
    lines = out.strip().splitlines()
    assert '"bf16_max": true' in lines[0], lines[0]
    last = json.loads(lines[-1])
    assert last["metric"] == "train_edges_per_s"
    assert math.isfinite(last["value"]) and last["value"] > 0
