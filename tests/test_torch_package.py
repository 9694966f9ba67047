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
        "assert 'radargnn_tpu_torch.ops.csr_aggregate' in names\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=_REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 40   # every module of four slices
    assert os.path.join(_PKG, "ops", "csr_aggregate.py") in _port_sources()


def test_smoke_rehearses_on_cpu():
    """The on-card smoke, at a tiny size on the CPU: the flagship config on
    the kNN graph (dense tiling), on the radius graph (windowed tiling, r
    scaled as 3.0·sqrt(2816/points) so the mean degree stays near 20) and
    on the kNN graph under the CSR tiling, the seven kernels' checks
    against their plain versions at the model's layer shapes (the windowed
    and the CSR ones on two layouts each), three requests, four train steps
    on the kernel path, again and on the plain path (here all plain), and
    the kernels line with every key the chip run reports, each entry
    pointing at the TPU kernel it replaces. Nothing is timed and nothing
    launches here."""
    lines = []
    before = torch.are_deterministic_algorithms_enabled()
    summary = smoke.run("cpu", points=200, graphs=2, batches=3, reps=1,
                        out=lines.append)
    assert torch.are_deterministic_algorithms_enabled() == before
    kernels = summary["kernels"]
    assert [k["name"] for k in kernels] == [
        "dense_fwd_v4", "dense_bwd_v4", "segment_sum_csr", "windowed_fwd_v3",
        "windowed_bwd_v3", "csr_fwd_v2", "csr_bwd_v2"]
    replaced = {"dense_fwd_v4": "def _fused_fwd_kernel_v4",
                "dense_bwd_v4": "def _fused_bwd_kernel_v4",
                "segment_sum_csr": "def _segsum_kernel",
                "windowed_fwd_v3": "def _fused_fwd_kernel_v3",
                "windowed_bwd_v3": "def _fused_bwd_kernel_v3",
                "csr_fwd_v2": "def _fused_fwd_kernel_v2",
                "csr_bwd_v2": "def _fused_bwd_kernel_v2"}
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
    csr = summary["csr"]
    assert csr["replaced"] == {"fused_tiling": "csr"}
    assert last["csr"]["per_shape_fwd"] == csr["per_shape_fwd"]
    for key in ("per_shape_bwd", "radius_per_shape_bwd"):
        assert [r["d_in"] for r in csr[key]] == [224, 224, 224, 128, 64]
        assert all(r["bitwise_repeat"] and r["max_abs_err"] == 0.0
                   for r in csr[key])
    # the float32 edge products bound the CSR kernels at the wide layers
    assert csr["per_shape_fwd"][0]["bound_by"] == "operations"
    assert csr["model_max_dprob"] == 0.0
    assert csr["train_max_rel_loss_diff"] == 0.0
    c_losses = np.asarray(csr["train_losses"])
    assert c_losses.shape == (4, 3) and c_losses[-1, 0] < c_losses[0, 0]
    # the radius batch under the CSR tiling: 256-node blocks of 512 slots
    assert all(v > 0 for v in csr["radius_tiling"]["valid_edges"])
    assert csr["radius_tiling"]["tiles_per_graph"] > 1


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


def test_csr_configuration_replaces_one_field():
    """The CSR path reads the flagship YAML and replaces fused_tiling alone;
    its tiling spec is the CSR pair, and on the radius graph it replaces
    that field beside the radius path's three."""
    k_arch, k_graph, _, _ = smoke.flagship_configs("knn")
    arch, graph, _, replaced = smoke.flagship_configs("knn", tiling="csr")
    assert replaced == {"fused_tiling": "csr"} and graph == k_graph
    assert dataclasses.replace(arch, fused_tiling="auto") == k_arch
    assert smoke.fused_csr_tiling(arch, k=graph.k) == (256, 512)
    _, _, _, r_replaced = smoke.flagship_configs("radius", tiling="csr")
    assert set(r_replaced) == {
        "graph_construction_algorithm", "graph_construction_settings",
        "fused_run_cap", "fused_tiling"}
    with pytest.raises(ValueError, match="tiling"):
        smoke.flagship_configs("knn", tiling="windowed")


def test_csr_bounds_count_the_edge_products_in_float32():
    """B5 keeps e @ W_e and the edge gradients in float32: at the flagship's
    wide layer (14,080 nodes, 309,760 slots of which 281,600 valid, 605
    tiles) 4.18 GFLOP at 67 TFLOP/s outside the tensor cores (62 µs) beside
    2.93 GFLOP of bf16 products and ~107 MB: bound by operations, 0.065 ms;
    the backward twice the products, 0.131 ms."""
    n, e_pad, t, valid = 14080, 309760, 605, 281600
    f = smoke._kernel_bound(224, 16, 464, n, e_pad, t, valid, 2, True)
    assert f["flops"] == 2.0 * (n * 224 * 464 + valid * 16 * 464)
    assert f["bound_by"] == "operations"
    assert 0.064 < f["bound_ms"] < 0.066
    assert f["bytes"] == (n * 224 * 2 + 224 * 464 * 2 + e_pad * 16 * 4
                          + 16 * 464 * 4 + 2 * (e_pad + t) * 4
                          + 3 * n * 464 * 4)
    b = smoke._bwd_bound(224, 16, 464, n, e_pad, t, valid, 2, True)
    assert b["bound_by"] == "operations"
    assert 0.130 < b["bound_ms"] < 0.132


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
    assert kind_of("slot_products_kernel") == "slot products (B2 / B4 / B5)"
    assert kind_of("csr_fwd_v2_kernel") == "csr_fwd_v2 (B5)"
    assert kind_of("csr_route_kernel") == \
        "csr_bwd_v2 route + edge partials (B5)"
    assert kind_of("csr_edge_reduce_kernel") == "csr_bwd_v2 edge reduce (B5)"
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


def test_drift_witness_reassociates_the_csr_plain_path():
    """trace_train's drift mode at a tiny size on the CPU, where the kernel
    path is the plain path: their gap is 0, and the witness (the CSR plain
    path with the depth of its products reversed) moves the losses by
    rounding only."""
    from radargnn_tpu_torch import trace_train
    from radargnn_tpu_torch.ops import csr_aggregate as ca
    before = torch.are_deterministic_algorithms_enabled()
    got = trace_train.drift(1, steps=2, points=200, graphs=2, tiling="csr",
                            device="cpu")
    assert torch.are_deterministic_algorithms_enabled() == before
    assert ca.csr_fwd_plain is trace_train._csr_fwd_plain
    assert ca.csr_bwd_plain is trace_train._csr_bwd_plain
    (run,) = got["runs"]
    assert run["kernel_vs_plain"] == 0.0
    assert 0.0 < run["witness_vs_plain"] < 1e-2


def test_drift_witness_is_the_same_function():
    """The witness's forward and backward reverse the depth of the CSR
    products and undo it on the outputs: the same values as the plain
    versions to float32 rounding."""
    from radargnn_tpu_torch import trace_train
    from radargnn_tpu_torch.ops import csr_aggregate as ca
    gen = torch.Generator().manual_seed(0)
    n, d, de, h, nb, et = 64, 24, 16, 40, 32, 32
    x = torch.randn(n, d, generator=gen)
    w_s = torch.randn(d, h, generator=gen)
    e_t = torch.randn(128, de, generator=gen)
    w_e = torch.randn(de, h, generator=gen)
    senders = torch.randint(0, n, (128,), generator=gen, dtype=torch.int32)
    recv = torch.sort(torch.randint(0, n, (128,), generator=gen,
                                    dtype=torch.int32)).values
    blocks = recv.view(-1, et)[:, 0] // nb
    layout, kw = (senders, recv, blocks), dict(node_block=nb, edge_tile=et)
    offset = torch.randn(n, h, generator=gen)
    out, inner = ca.csr_fwd_plain(x, w_s, e_t, w_e, *layout, offset,
                                  emit_inner=True, **kw)
    w_out, w_inner = trace_train.reassociated_fwd(
        x, w_s, e_t, w_e, *layout, offset, emit_inner=True, **kw)
    torch.testing.assert_close(w_out, out, rtol=1e-5, atol=1e-5)
    has = inner > -1e38
    g = torch.where(has, torch.randn(n, h, generator=gen), 0.0)
    bwd_args = (x, w_s, e_t, w_e, *layout, torch.where(has, inner, 0.0), g)
    for got, want in zip(trace_train.reassociated_bwd(*bwd_args, **kw),
                         ca.csr_bwd_plain(*bwd_args, **kw)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_bf16_model_hands_the_csr_backward_a_bf16_exact_g():
    """In the bf16 flagship model the layer after each CSR aggregation
    takes its output in bf16, so the g that reaches the CSR backward holds
    bf16 values: on this path v2's float32 edge-side d_op equals the
    rounded one, and only the kernel checks with a real-valued g tell the
    two apart (PERF.md)."""
    from unittest import mock
    from radargnn_tpu_torch.ops import csr_aggregate as ca
    seen = []

    def spy(*args, **kw):
        g = args[-1]
        seen.append(bool(g.abs().max() > 0)
                    and torch.equal(g, g.bfloat16().float()))
        return ca.csr_bwd_plain(*args, **kw)

    arch, _, loader = smoke.flagship_serving("cpu", 200, 2, 1, 0,
                                             tiling="csr")
    assert arch.compute_dtype == "bfloat16"
    with mock.patch.object(ca, "csr_bwd", spy):
        smoke.flagship_training("cpu", arch, loader[0], 0, 1)
    assert seen == [True] * len(arch.conv_layer_dimensions)
