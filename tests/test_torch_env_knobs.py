"""The JAX package's env knobs in the port (radargnn_tpu_torch.models.layers,
train.checkpoint).

Both packages read the knobs when their layers module is imported, so
each case runs in a subprocess with the knob set: the geometry knobs give
the same `fused_csr_tiling` in both packages and the same stacked, tiled
batch; a knob whose kernel variant is not ported raises
NotImplementedError naming itself; a knob that only chooses how the TPU
streams its gathers changes nothing."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from radargnn_tpu_torch.data import synthetic as tsyn
from radargnn_tpu_torch.graph import batch as tbatch
from radargnn_tpu_torch.models import layers as tlayers
from radargnn_tpu_torch.train import checkpoint as tckpt

from host_backends import native_cache  # noqa: F401

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Both packages' layers modules are reloaded after each knob is set (one
# subprocess for every case); for each geometry knob, one small frame pair
# is stacked in both packages under each fused tiling the knob reaches.
# Both packages run one host backend (tests/host_backends.py), the JAX
# package's helper built in this worker's own directory. Prints one JSON
# object: per knob, per mode, the two tilings and whether every array
# agrees.
_COMPARE = r"""
import importlib, json, math, os, sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from radargnn_tpu import configs as jcfg
from radargnn_tpu.data import synthetic as jsyn
from radargnn_tpu.graph import batch as jbatch
from radargnn_tpu.models import layers as jlayers
from radargnn_tpu_torch import configs as tcfg
from radargnn_tpu_torch.data import synthetic as tsyn
from radargnn_tpu_torch.graph import batch as tbatch
from radargnn_tpu_torch.models import layers as tlayers
sys.path.insert(0, "tests")
import host_backends
host_backends.pin(setattr)      # both packages on one host backend

base = dict(node_feature_dimension=5, edge_feature_dimension=2,
            conv_layer_dimensions=[8],
            classification_head_layer_dimensions=[6],
            regression_head_layer_dimensions=[5],
            use_fused_aggregation=True, fused_overflow_fraction=0.3)
report = {}
for knob, value in json.loads(sys.argv[1]):
    os.environ[knob] = value
    importlib.reload(jlayers)
    importlib.reload(tlayers)
    report[knob] = {}
    for mode in ("dense", "windowed", "csr"):
        j = jlayers.fused_csr_tiling(
            jcfg.GNNArchitectureConfig(**base, fused_tiling=mode), k=20)
        t = tlayers.fused_csr_tiling(
            tcfg.GNNArchitectureConfig(**base, fused_tiling=mode), k=20)
        nb = j["node_block"] if isinstance(j, dict) else j[0]
        align = math.lcm(nb, j["r_tile"]) if isinstance(j, dict) else nb
        max_nodes = -(-200 // align) * align
        kw = dict(max_nodes=max_nodes, bg_index=5,
                  max_edges=max_nodes * 20)
        frames = dict(num_frames=2, num_points=200, seed=0)
        jb = jbatch.stack_samples(jsyn.make_samples(**frames),
                                  csr_tiling=j, **kw)
        tb = tbatch.stack_samples(tsyn.make_samples(**frames),
                                  csr_tiling=t, device="cpu", **kw)
        same = True
        for k, v in tb.tensors().items():
            try:
                np.testing.assert_array_equal(v.numpy(),
                                              np.asarray(getattr(jb, k)))
            except AssertionError:
                same = False
        report[knob][mode] = {
            "jax": repr(j), "port": repr(t), "arrays_equal": same,
            "geometry_equal": tb.tile_geometry == jb.tile_geometry}
    del os.environ[knob]
print(json.dumps(report))
"""

_GEOMETRY = [
    ("RADARGNN_FUSED_NODE_BLOCK", "128"),
    ("RADARGNN_FUSED_EDGE_TILE", "256"),
    ("RADARGNN_FUSED_WINDOW_BLOCKS", "2"),
    ("RADARGNN_FUSED_DENSE_R_TILE", "32"),
    ("RADARGNN_FUSED_DENSE_EXTRA_SLOTS", "6"),
    ("RADARGNN_FUSED_RUN_CAP", "2"),
]


def _subprocess(code: str, *args: str, env=None) -> str:
    """Runs `code` in a fresh interpreter (the knobs unset unless `env`
    sets them); returns its last line of output."""
    full = {k: v for k, v in os.environ.items()
            if not k.startswith(("RADARGNN_FUSED_", "RADARGNN_CKPT_"))}
    full.update(JAX_PLATFORMS="cpu", **(env or {}))
    proc = subprocess.run([sys.executable, "-c", code, *args], cwd=_REPO,
                          env=full, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout.strip().splitlines()[-1]


@pytest.fixture(scope="module")
def geometry_reports(native_cache):
    return json.loads(_subprocess(
        _COMPARE, json.dumps(_GEOMETRY),
        env=dict(RADARGNN_NATIVE_CACHE=str(native_cache))))


@pytest.mark.parametrize("knob,value", _GEOMETRY)
def test_geometry_knob_tiles_alike_in_both_packages(geometry_reports, knob,
                                                    value):
    report = geometry_reports[knob]
    for mode, r in report.items():
        assert r["jax"] == r["port"], (mode, r)
        assert r["arrays_equal"] and r["geometry_equal"], (mode, r)
    # the knob took effect
    if knob.endswith("EXTRA_SLOTS"):
        assert "'k': 26" in report["dense"]["port"]
    else:
        assert value in report["dense"]["port"] + report["windowed"]["port"]


# each case: set the knob, reload the port's layers module, ask for the
# tiling; prints one JSON list of "ACCEPTED" / "RAISED <message>"
_RAISES = r"""
import importlib, json, os, sys
from radargnn_tpu_torch import configs as tcfg
from radargnn_tpu_torch.models import layers as tlayers
results = []
for knob, value, mode in json.loads(sys.argv[1]):
    os.environ[knob] = value
    importlib.reload(tlayers)
    arch = tcfg.GNNArchitectureConfig(
        node_feature_dimension=5, edge_feature_dimension=2,
        conv_layer_dimensions=[8], classification_head_layer_dimensions=[6],
        regression_head_layer_dimensions=[5], use_fused_aggregation=True,
        fused_tiling=mode)
    try:
        tlayers.fused_csr_tiling(arch, k=20)
    except NotImplementedError as err:
        results.append(f"RAISED {err}")
    else:
        results.append("ACCEPTED")
    del os.environ[knob]
print(json.dumps(results))
"""

_VARIANTS = [
    ("RADARGNN_FUSED_BF16_MAX", "1", "dense", True),
    ("RADARGNN_FUSED_BF16_MAX", "0", "dense", False),
    ("RADARGNN_FUSED_OVF_SSUM", "1", "dense", True),
    ("RADARGNN_FUSED_STREAM_M", "1", "windowed", True),
    ("RADARGNN_FUSED_BF16_LANDING", "1", "windowed", True),
    ("RADARGNN_FUSED_PRECOMP_LAND", "1", "csr", True),
    ("RADARGNN_FUSED_SENDER_DX", "1", "windowed", False),
    ("RADARGNN_FUSED_SENDER_DX", "1", "dense", False),
    ("RADARGNN_FUSED_PRECOMP_EQ", "0", "windowed", False),
    ("RADARGNN_FUSED_PRECOMP_EQT", "1", "windowed", False),
    ("RADARGNN_FUSED_EQ_MIN_WIDTH", "64", "dense", False),
    ("RADARGNN_FUSED_DENSE_XLA_MAX_WIDTH", "64", "dense", False),
]


@pytest.fixture(scope="module")
def variant_results():
    return json.loads(_subprocess(
        _RAISES, json.dumps([case[:3] for case in _VARIANTS])))


@pytest.mark.parametrize("case", range(len(_VARIANTS)))
def test_variant_knobs_raise_where_not_ported(variant_results, case):
    """An unported variant raises NotImplementedError naming its knob; the
    TPU-only stream knobs, BF16_MAX=0 (strict, the port's routing) and
    SENDER_DX=1 on the dense and windowed paths (their backward's form)
    are accepted."""
    knob, _, _, raises = _VARIANTS[case]
    line = variant_results[case]
    if raises:
        assert line.startswith("RAISED") and knob in line, line
    else:
        assert line == "ACCEPTED", line


def test_tpu_only_knob_changes_nothing(tmp_path):
    """A stream knob set to a non-default value gives the same tiling and
    the same stacked batch as the defaults (in-process: the defaults)."""
    code = r"""
import json
from radargnn_tpu_torch import configs as tcfg
from radargnn_tpu_torch.data import synthetic as tsyn
from radargnn_tpu_torch.graph import batch as tbatch
from radargnn_tpu_torch.models import layers as tlayers
import numpy as np
arch = tcfg.GNNArchitectureConfig(
    node_feature_dimension=5, edge_feature_dimension=2,
    conv_layer_dimensions=[8], classification_head_layer_dimensions=[6],
    regression_head_layer_dimensions=[5], use_fused_aggregation=True,
    fused_tiling="dense", fused_overflow_fraction=0.3)
spec = tlayers.fused_csr_tiling(arch, k=20)
b = tbatch.stack_samples(
    tsyn.make_samples(num_frames=2, num_points=200, seed=0), max_nodes=256,
    bg_index=5, max_edges=256 * 20, csr_tiling=spec, device="cpu")
np.savez(__import__("sys").argv[1], **{k: v.numpy()
                                      for k, v in b.tensors().items()})
print(json.dumps(repr(spec)))
"""
    out = tmp_path / "knob.npz"
    arch_spec = json.loads(_subprocess(
        code, str(out), env=dict(RADARGNN_FUSED_PRECOMP_EQ="0",
                                 RADARGNN_FUSED_EQ_MIN_WIDTH="512")))
    from radargnn_tpu_torch import configs as tcfg
    arch = tcfg.GNNArchitectureConfig(
        node_feature_dimension=5, edge_feature_dimension=2,
        conv_layer_dimensions=[8], classification_head_layer_dimensions=[6],
        regression_head_layer_dimensions=[5], use_fused_aggregation=True,
        fused_tiling="dense", fused_overflow_fraction=0.3)
    spec = tlayers.fused_csr_tiling(arch, k=20)
    assert arch_spec == repr(spec)
    b = tbatch.stack_samples(
        tsyn.make_samples(num_frames=2, num_points=200, seed=0),
        max_nodes=256, bg_index=5, max_edges=256 * 20, csr_tiling=spec,
        device="cpu")
    got = np.load(out)
    for k, v in b.tensors().items():
        np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)


def test_orbax_checkpoint_backend_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("RADARGNN_CKPT_BACKEND", "orbax")
    with pytest.raises(NotImplementedError, match="RADARGNN_CKPT_BACKEND"):
        tckpt.save_train_state(str(tmp_path), params={}, batch_stats={},
                               opt_state={}, epoch=0, losses={},
                               scheduler_lr=1e-3)
    monkeypatch.setenv("RADARGNN_CKPT_BACKEND", "msgpack")
    tckpt.save_train_state(str(tmp_path), params={}, batch_stats={},
                           opt_state={}, epoch=0, losses={},
                           scheduler_lr=1e-3)
    assert (tmp_path / "meta.json").exists()


def test_bf16_max_config_still_raises_in_process():
    """The config field raises as before (the knob unset here)."""
    from radargnn_tpu_torch import configs as tcfg
    from radargnn_tpu_torch.models.detnet import DetNet
    assert tlayers.BF16_MAX_ENV is None
    with pytest.raises(NotImplementedError, match="bf16"):
        DetNet(tcfg.GNNArchitectureConfig(
            node_feature_dimension=5, edge_feature_dimension=2,
            conv_layer_dimensions=[8],
            classification_head_layer_dimensions=[6],
            regression_head_layer_dimensions=[5], fused_bf16_max=True),
            device="cpu")
