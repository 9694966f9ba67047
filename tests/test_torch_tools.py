"""The port's training tools on the CPU: `utils.profiling` (StepTimer,
trace, write_metrics_jsonl) against the JAX package's, and tiny-size
rehearsals of `python -m radargnn_tpu_torch.benchmarks.convergence` and
`... .preprocessing_bench` as child processes, started together (a module
fixture), each checked for the lines the JAX tools print. No time is
measured here."""

import json
import math
import os
import subprocess
import sys

import pytest
import torch

from radargnn_tpu.utils import profiling as jprof
from radargnn_tpu_torch.utils import profiling as tprof

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CONVERGENCE = ["--device", "cpu", "--frames", "10", "--points", "200",
               "--epochs", "2", "--batch-size", "4", "--fused", "--dense"]
PREPROCESSING = ["--frames", "4", "--points", "300", "--workers", "2"]


def _start(module, args, **env):
    env = dict(os.environ, PYTHONPATH=_REPO, OMP_NUM_THREADS="1", **env)
    return subprocess.Popen(
        [sys.executable, "-m", f"radargnn_tpu_torch.benchmarks.{module}",
         *args], cwd=_REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def children():
    procs = {
        "convergence": _start("convergence", CONVERGENCE),
        "convergence_bf16_max": _start(
            "convergence", CONVERGENCE + ["--no-eval"],
            RADARGNN_FUSED_BF16_MAX="1"),
        "preprocessing": _start("preprocessing_bench", PREPROCESSING),
    }
    yield procs
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def _lines(proc):
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    return out.strip().splitlines()


def test_convergence_prints_the_jax_tools_lines(children):
    lines = [json.loads(s) for s in _lines(children["convergence"])]
    epochs, (m_ap, f1) = lines[:-2], lines[-2:]
    assert [e["epoch"] for e in epochs] == [1, 2]
    for e in epochs:
        assert set(e) == {"epoch", "loss_train", "loss_valid"}
        assert math.isfinite(e["loss_train"]) and math.isfinite(
            e["loss_valid"])
    assert epochs[1]["loss_train"] < epochs[0]["loss_train"]
    assert m_ap["metric"] == "synthetic_map" and 0 <= m_ap["value"] <= 1
    assert f1["metric"] == "synthetic_f1_macro" and 0 <= f1["value"] <= 1


def test_convergence_under_bf16_max_without_eval(children):
    lines = [json.loads(s) for s in _lines(children["convergence_bf16_max"])]
    assert [e["epoch"] for e in lines] == [1, 2]
    assert all(math.isfinite(e["loss_train"]) for e in lines)


def test_preprocessing_bench_prints_both_rates(children):
    lines = _lines(children["preprocessing"])
    assert len(lines) == 2
    assert lines[0].startswith("single-process: ") and "native=" in lines[0]
    assert lines[1].startswith("2-process pool: ")
    for line in lines:
        assert "points/s" in line and "edges/s" in line


def test_preprocessing_frame_counts_edges():
    """One frame's work: k edges a point, boxes for the tracked points."""
    from radargnn_tpu_torch.benchmarks import preprocessing_bench as pb
    frame = pb.make_frames(1, 120, seed=0)[0]
    edges, finite = pb.process_frame((frame, 20))
    assert edges == 120 * 20 and finite > 0


def test_step_timer_records_steps_and_waits_for_the_card(monkeypatch):
    """On a CUDA device the timer synchronises on entry and on exit; on the
    CPU it never does."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: calls.append(device))
    timer = tprof.StepTimer(device="cpu")
    for edges in (10, 20, 30):
        with timer.step(edges):
            pass
    assert calls == []
    assert timer.stats.edges_per_step == [10, 20, 30]
    assert len(timer.stats.step_times_s) == 3
    assert timer.stats.summary()["steps"] == 3
    card = tprof.StepTimer(device="cuda:0")
    with card.step(5):
        assert calls == [torch.device("cuda:0")]
    assert calls == [torch.device("cuda:0")] * 2
    assert card.stats.edges_per_step == [5]


def test_step_stats_match_jax():
    j, t = jprof.StepStats(), tprof.StepStats()
    for dt, e in ((0.5, 100), (0.25, 300), (0.125, 300)):
        j.record(dt, e)
        t.record(dt, e)
    assert t.summary() == j.summary()
    assert t.edges_per_s(0) == j.edges_per_s(0)


def test_write_metrics_jsonl_matches_jax(tmp_path):
    for mod, name in ((jprof, "jax.jsonl"), (tprof, "port.jsonl")):
        mod.write_metrics_jsonl(str(tmp_path / name), "train_edges_per_s",
                                1.5e6, "edges/s", card="H100", steps=3)
        mod.write_metrics_jsonl(str(tmp_path / name), "loss", 0.25, "1")
    assert (tmp_path / "port.jsonl").read_text() == \
        (tmp_path / "jax.jsonl").read_text()


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(str(tmp_path / "tb")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "tb" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
