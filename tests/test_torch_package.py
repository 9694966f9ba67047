"""The PyTorch port as a package: it stands alone (no JAX, nothing of the JAX
package), its on-card smoke rehearses on the CPU, and `chip_smoke.py` refuses
to report a result without a card."""

import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import radargnn_tpu_torch
from radargnn_tpu_torch import smoke

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PKG = os.path.dirname(os.path.abspath(radargnn_tpu_torch.__file__))

# an import of JAX, flax, or the JAX package itself (`radargnn_tpu.x` or
# `from radargnn_tpu import x`) — but not of `radargnn_tpu_torch`
_FORBIDDEN = re.compile(
    r"^\s*(?:from|import)\s+(?:jax|jaxlib|flax)\b"
    r"|^\s*(?:from|import)\s+radargnn_tpu(?:\.|\s)"
    r"|import_module\(\s*['\"](?:jax|flax|radargnn_tpu(?:\.|['\"]))",
    re.MULTILINE)


def _port_sources():
    paths = [os.path.join(_REPO, "chip_smoke.py"),
             os.path.join(_REPO, "tests", "test_torch_gpu.py")]
    for root, _, files in os.walk(_PKG):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return paths


def test_forbidden_import_pattern():
    assert _FORBIDDEN.search("import jax.numpy as jnp")
    assert _FORBIDDEN.search("from radargnn_tpu.ops import knn")
    assert _FORBIDDEN.search("    from radargnn_tpu import configs")
    assert not _FORBIDDEN.search("from radargnn_tpu_torch.ops import knn")
    assert not _FORBIDDEN.search("import radargnn_tpu_torch")


def test_port_sources_import_nothing_of_jax():
    offenders = []
    for path in _port_sources():
        with open(path) as f:
            for m in _FORBIDDEN.finditer(f.read()):
                offenders.append(f"{os.path.relpath(path, _REPO)}: "
                                 f"{m.group(0).strip()}")
    assert not offenders, offenders


def test_every_submodule_imports_without_jax():
    """A fresh interpreter imports the package, every submodule and
    chip_smoke.py; neither jax nor the JAX package is loaded after."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import radargnn_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'radargnn_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'radargnn_tpu')]\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=_REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 39   # every module of three slices


def test_smoke_rehearses_on_cpu():
    """The on-card smoke, at a tiny size on the CPU: the flagship config on
    the kNN graph (dense tiling) and on the radius graph (windowed tiling,
    r scaled as 3.0·sqrt(2816/points) so the mean degree stays near 20),
    the five kernels' checks against their plain versions at the model's
    layer shapes (the windowed ones on both layouts), three requests, four
    train steps on the kernel path, again and on the plain path (here all
    plain), and the kernels line with every key the chip run reports, each
    entry pointing at the TPU kernel it replaces. Nothing is timed and
    nothing launches here."""
    lines = []
    before = torch.are_deterministic_algorithms_enabled()
    summary = smoke.run("cpu", points=200, graphs=2, batches=3, reps=1,
                        out=lines.append)
    assert torch.are_deterministic_algorithms_enabled() == before
    kernels = summary["kernels"]
    assert [k["name"] for k in kernels] == [
        "dense_fwd_v4", "dense_bwd_v4", "segment_sum_csr", "windowed_fwd_v3",
        "windowed_bwd_v3"]
    replaced = {"dense_fwd_v4": "def _fused_fwd_kernel_v4",
                "dense_bwd_v4": "def _fused_bwd_kernel_v4",
                "segment_sum_csr": "def _segsum_kernel",
                "windowed_fwd_v3": "def _fused_fwd_kernel_v3",
                "windowed_bwd_v3": "def _fused_bwd_kernel_v3"}
    for kernel in kernels:
        assert set(kernel) == {"name", "route", "source", "replaces",
                               "launches", "max_abs_err", "ms", "plain_ms",
                               "bound_ms", "bound_by", "library_ms"}
        assert kernel["route"] == "cuda"
        assert kernel["launches"] == 0 and kernel["ms"] is None
        assert kernel["max_abs_err"] == 0.0
        assert kernel["bound_ms"] > 0 and kernel["bound_by"] in (
            "bytes", "operations")
        assert os.path.exists(os.path.join(_REPO, kernel["source"]))
        path, line = kernel["replaces"].split(":")
        with open(os.path.join(_REPO, path)) as f:
            assert f.readlines()[int(line) - 1].startswith(
                replaced[kernel["name"]])
    assert [r["d_in"] for r in summary["per_shape"]] == [224, 224, 224, 128,
                                                          64]
    assert [r["d"] for r in summary["per_shape_segsum"]] == [224, 224, 224,
                                                             128, 64]
    assert all(r["bitwise_repeat"] for r in summary["per_shape_bwd"])
    assert summary["model_max_dprob"] == 0.0
    losses = np.asarray(summary["train_losses"])
    assert losses.shape == (4, 3) and np.isfinite(losses).all()
    assert summary["train_max_rel_loss_diff"] == 0.0
    assert losses[-1, 0] < losses[0, 0]
    last = json.loads(lines[-1])
    assert last["per_shape"] == summary["per_shape"]
    radius = summary["radius"]
    assert radius["replaced"] == {
        "graph_construction_algorithm": "radius",
        "graph_construction_settings": {"k": 20, "r": pytest.approx(
            3.0 * np.sqrt(2816 / 200))},
        "fused_run_cap": None}
    assert last["radius"]["per_shape_fwd"] == radius["per_shape_fwd"]
    for key in ("per_shape_bwd", "knn_per_shape_bwd"):
        assert all(r["bitwise_repeat"] and r["max_abs_err"] == 0.0
                   for r in radius[key])
    assert [r["d_in"] for r in radius["knn_per_shape_fwd"]] == [
        224, 224, 224, 128, 64]
    # ~12 at 200 points: the frame's edges cut more of each r-disk there
    mean_degree = np.mean(radius["tiling"]["valid_edges"]) / 200
    assert 10 < mean_degree < 30
    assert radius["model_max_dprob"] == 0.0
    assert radius["train_max_rel_loss_diff"] == 0.0
    r_losses = np.asarray(radius["train_losses"])
    assert r_losses.shape == (4, 3) and r_losses[-1, 0] < r_losses[0, 0]


def test_radius_configuration_replaces_three_fields():
    """The radius path reads the flagship YAML and replaces exactly the
    graph algorithm, its settings and the run cap; its tiling spec is the
    windowed tuple with contiguous runs."""
    k_arch, k_graph, _, none = smoke.flagship_configs("knn")
    arch, graph, _, replaced = smoke.flagship_configs("radius")
    assert none == {} and set(replaced) == {
        "graph_construction_algorithm", "graph_construction_settings",
        "fused_run_cap"}
    assert (graph.graph_construction_algorithm, graph.r, graph.k) == \
        ("radius", 3.0, None)
    assert arch.fused_run_cap is None and k_arch.fused_run_cap == 4
    assert dataclasses.replace(arch, fused_run_cap=4) == k_arch
    assert dataclasses.replace(
        graph, graph_construction_algorithm="knn",
        graph_construction_settings=k_graph.graph_construction_settings) \
        == k_graph
    assert smoke.fused_csr_tiling(arch, k=graph.k) == (256, 512, 3, 0.05)


def test_backward_bound_counts_the_sender_sums_once_per_node():
    """B2's bound: d_x and dW_s from the per-sender sums of d_op (N rows),
    d_e and dW_e per valid slot. At the flagship's wide layer that is 13.8
    GFLOP (14 µs at the bf16 peak) against ~95 MB (~28 µs at 3.35 TB/s):
    bound by bytes. B3's landing there reads ~281,600 rows."""
    n, e_pad, t, valid = 14080, 337920, 220, 267178
    b = smoke._bwd_bound(224, 16, 464, n, e_pad, t, valid)
    assert b["flops"] == 4.0 * (n * 224 * 464 + valid * 16 * 464)
    assert 13.7e9 < b["flops"] < 13.9e9
    assert b["bound_by"] == "bytes"
    assert 0.027 < b["bound_ms"] < 0.030
    s = smoke._segsum_bound(224, valid, 14422, n)
    assert s["bound_by"] == "bytes"
    assert s["bytes"] == (valid * 224 * 2 + 14422 * 224 * 4
                          + (valid + 14422) * 4 + (n + 1) * 4 + n * 224 * 4)


def test_kernel_bound_counts_the_projection_once_per_node():
    """The bound counts x @ W_s once per node and e @ W_e once per valid
    slot; at the flagship's wide layer (N 14,080, 337,920 slots of which
    267,178 valid, 220 tiles) that is 6.89 GFLOP, so the bytes bound it
    (~29 µs at 3.35 TB/s)."""
    n, e_pad, t, valid = 14080, 337920, 220, 267178
    b = smoke._kernel_bound(224, 16, 464, n, e_pad, t, valid)
    assert b["flops"] == 2.0 * (n * 224 * 464 + valid * 16 * 464)
    assert b["slot_flops"] == 2.0 * valid * (224 + 16) * 464
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(b["bytes"] / smoke.PEAK_HBM_BYTES
                                          * 1e3)
    assert 0.028 < b["bound_ms"] < 0.030


def test_chip_smoke_fails_without_a_card(tmp_path):
    """Without CUDA, chip_smoke.py exits non-zero and prints no result; so
    does a copy that stands alone in a directory without the package."""
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine without a card")
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(_REPO, "chip_smoke.py"), alone)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for cwd, script in ((_REPO, "chip_smoke.py"), (tmp_path, str(alone))):
        proc = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


def test_trace_train_sorts_kernels_into_kinds():
    from radargnn_tpu_torch.trace_train import kind_of
    assert kind_of("route_kernel") == "dense_bwd_v4 route (B2)"
    assert kind_of("windowed_route_kernel") == "windowed_bwd_v3 route (B4)"
    assert kind_of("windowed_fwd_v3_kernel") == "windowed_fwd_v3 (B4)"
    assert kind_of("slot_products_kernel") == "slot products (B2 / B4)"
    assert kind_of("segment_sum_csr_kernel") == "segment_sum_csr (B3)"
    assert kind_of("sm90_xmma_gemm_f32f32_f32f32") == "GEMMs (cuBLAS)"
    assert kind_of("vectorized_elementwise_kernel<FillFunctor<float>>") \
        .startswith("fills")
    assert kind_of("something new") == "other"


def test_trace_busy_time_is_the_union_of_kernel_intervals():
    from radargnn_tpu_torch.trace_serving import _busy_us
    assert _busy_us([]) == 0.0
    assert _busy_us([(0, 10), (5, 12), (20, 25), (21, 22)]) == 17.0
    assert _busy_us([(3, 4), (0, 10)]) == 10.0
