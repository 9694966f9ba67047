"""The PyTorch port as a package: it stands alone (no JAX, nothing of the JAX
package), its on-card smoke rehearses on the CPU, and `chip_smoke.py` refuses
to report a result without a card."""

import json
import os
import re
import shutil
import subprocess
import sys

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
    paths = [os.path.join(_REPO, "chip_smoke.py")]
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
    assert int(proc.stdout.strip()) >= 20   # every module of the slice


def test_smoke_rehearses_on_cpu():
    """The on-card smoke, at a tiny size on the CPU: the flagship config,
    three requests, the kernel-vs-plain check at the model's layer shapes,
    and the kernels line with every key the chip run reports. Nothing is
    timed and nothing launches here."""
    lines = []
    summary = smoke.run("cpu", points=200, graphs=2, batches=3, reps=1,
                        out=lines.append)
    (kernel,) = summary["kernels"]
    assert set(kernel) == {"name", "route", "source", "replaces", "launches",
                           "max_abs_err", "ms", "plain_ms", "bound_ms",
                           "bound_by", "library_ms"}
    assert kernel["launches"] == 0 and kernel["ms"] is None
    assert kernel["bound_ms"] > 0 and kernel["bound_by"] in ("bytes",
                                                             "operations")
    assert os.path.exists(os.path.join(_REPO, kernel["source"]))
    path, line = kernel["replaces"].split(":")
    with open(os.path.join(_REPO, path)) as f:
        assert "def _fused_fwd_kernel_v4" in f.readlines()[int(line) - 1]
    assert [r["d_in"] for r in summary["per_shape"]] == [224, 224, 224, 128,
                                                          64]
    assert summary["model_max_dprob"] == 0.0
    assert json.loads(lines[-1])["per_shape"] == summary["per_shape"]


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


def test_trace_busy_time_is_the_union_of_kernel_intervals():
    from radargnn_tpu_torch.trace_serving import _busy_us
    assert _busy_us([]) == 0.0
    assert _busy_us([(0, 10), (5, 12), (20, 25), (21, 22)]) == 17.0
    assert _busy_us([(3, 4), (0, 10)]) == 10.0
