"""The JAX package's env knobs in the port (radargnn_tpu_torch.models.layers,
train.checkpoint).

Both packages read the knobs when their layers module is imported, so
each case runs in a subprocess with the knob set: the geometry knobs give
the same `fused_csr_tiling` in both packages and the same stacked, tiled
batch; every variant knob is accepted on every tiling and read as the
JAX package reads it ("1" on, anything else off), and the windowed
kernels' variant knobs act where the JAX package's do (the single-card
windowed path under bf16_max: the landing; the same path without it: the
JAX package's warning, and the baseline; elsewhere nothing); a knob that
only chooses how the TPU streams its gathers changes nothing; the orbax
checkpoint backend runs without tensorstore and zstandard (the port's own
code) and names what it does not read."""

import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest

from radargnn_tpu_torch.data import synthetic as tsyn
from radargnn_tpu_torch.graph import batch as tbatch
from radargnn_tpu_torch.models import layers as tlayers

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
# tiling; prints one JSON list of ["ACCEPTED" / "RAISED <message>", the
# windowed landing under bf16_max, whether the windowed path without
# bf16_max warns]
_ACCEPTS = r"""
import importlib, json, os, sys, warnings
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
    except Exception as err:
        line = f"RAISED {err}"
    else:
        line = "ACCEPTED"
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        baseline = tlayers.windowed_landing(False)
    results.append([line, tlayers.windowed_landing(True),
                    bool(caught) and not baseline])
    del os.environ[knob]
print(json.dumps(results))
"""

# (knob, value, fused tiling, the windowed landing under bf16_max, whether
# the windowed path warns without bf16_max)
_VARIANTS = [
    ("RADARGNN_FUSED_BF16_MAX", "1", "dense", False, False),
    ("RADARGNN_FUSED_BF16_MAX", "0", "dense", False, False),
    ("RADARGNN_FUSED_OVF_SSUM", "1", "dense", False, False),
    ("RADARGNN_FUSED_STREAM_M", "1", "windowed", False, True),
    ("RADARGNN_FUSED_BF16_LANDING", "1", "windowed", True, True),
    ("RADARGNN_FUSED_PRECOMP_LAND", "1", "csr", False, True),
    ("RADARGNN_FUSED_BF16_LANDING", "2", "windowed", False, False),
    ("RADARGNN_FUSED_STREAM_M", "true", "dense", False, False),
    ("RADARGNN_FUSED_SENDER_DX", "1", "windowed", False, False),
    ("RADARGNN_FUSED_SENDER_DX", "1", "dense", False, False),
    ("RADARGNN_FUSED_PRECOMP_EQ", "0", "windowed", False, False),
    ("RADARGNN_FUSED_PRECOMP_EQT", "1", "windowed", False, False),
    ("RADARGNN_FUSED_EQ_MIN_WIDTH", "64", "dense", False, False),
    ("RADARGNN_FUSED_DENSE_XLA_MAX_WIDTH", "64", "dense", False, False),
]


@pytest.fixture(scope="module")
def variant_results():
    return json.loads(_subprocess(
        _ACCEPTS, json.dumps([case[:3] for case in _VARIANTS])))


@pytest.mark.parametrize("case", range(len(_VARIANTS)))
def test_variant_knobs_raise_where_not_ported(variant_results, case):
    """Every variant knob is accepted on every tiling (none is left
    unported) and read as the JAX package reads it: BF16_LANDING=1 lands
    the windowed maxima in bf16 under bf16_max, any value but "1" is off,
    PRECOMP_LAND alone is ignored, and STREAM_M, BF16_LANDING or
    PRECOMP_LAND set without bf16_max warn and run the baseline; the
    TPU-only stream knobs, BF16_MAX, OVF_SSUM and SENDER_DX are
    accepted."""
    _, _, _, landing, warns = _VARIANTS[case]
    line, got_landing, got_warns = variant_results[case]
    assert line == "ACCEPTED", line
    assert (got_landing, got_warns) == (landing, warns)


def _knob_tilings():
    """The port's three single-card tilings of one small frame pair
    (geometry shrunk to fit 256 nodes)."""
    from radargnn_tpu_torch import configs as tcfg

    tilings = {}
    for mode in ("dense", "windowed", "csr"):
        arch = tcfg.GNNArchitectureConfig(
            node_feature_dimension=5, edge_feature_dimension=2,
            conv_layer_dimensions=[8],
            classification_head_layer_dimensions=[6],
            regression_head_layer_dimensions=[5],
            use_fused_aggregation=True, fused_tiling=mode,
            fused_overflow_fraction=0.3)
        spec = tlayers.fused_csr_tiling(arch, k=20)
        spec = dict(spec, node_block=64, r_tile=16) \
            if isinstance(spec, dict) else (64, 64) + tuple(spec[2:])
        b = tbatch.stack_samples(
            tsyn.make_samples(num_frames=2, num_points=200, seed=0),
            max_nodes=256, bg_index=5, max_edges=256 * 20, csr_tiling=spec,
            device="cpu")
        tilings[mode] = b.flat_tiling()
    return tilings


@pytest.mark.parametrize("bf16_max", [False, True])
def test_variant_knobs_act_only_on_the_windowed_path(monkeypatch, bf16_max):
    """With all three knobs set (the module constants the env sets), the
    windowed aggregation is asked for the landing under bf16_max and warns
    without it (the JAX package's message, the baseline run); the dense
    and CSR aggregations neither warn nor change; the halo path never
    reads the knobs."""
    import torch

    for name in ("STREAM_M", "BF16_LANDING", "PRECOMP_LAND"):
        monkeypatch.setattr(tlayers, name, True)
    asked = []
    windowed = tlayers.windowed_aggregate

    def spy(*args, **kw):
        asked.append(kw["bf16_landing"])
        return windowed(*args, **kw)

    monkeypatch.setattr(tlayers, "windowed_aggregate", spy)
    gen = torch.Generator().manual_seed(0)
    for mode, tiling in _knob_tilings().items():
        n = tiling.landing.row_ptr.shape[0] - 1
        de = tiling.edge_feat.shape[1]
        args = (torch.randn(n, 8, generator=gen),
                torch.randn(8, 8, generator=gen),
                torch.randn(de, 8, generator=gen),
                torch.randn(n, 8, generator=gen), tiling, bf16_max)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = tlayers._fused_hoisted_max(*args)
        assert torch.isfinite(out).all()
        msgs = [str(w.message) for w in caught]
        if mode == "windowed" and not bf16_max:
            assert len(msgs) == 1 and "require bf16_max routing" in msgs[0]
        else:
            assert msgs == [], (mode, msgs)
    assert asked == [bf16_max]

    # the halo path: the conv hands the bundle to the halo aggregation,
    # which never asks for the landing
    from radargnn_tpu_torch.models.layers import MPNNConv

    monkeypatch.setattr(tlayers, "windowed_landing", lambda *a: 1 / 0)
    seen = []
    monkeypatch.setattr(
        tlayers, "halo_hoisted_max_batched",
        lambda x, w_s, w_e, offset, halo, bf16: seen.append(bf16) or offset)
    conv = MPNNConv(8, 2, 8, bf16_max=bf16_max)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        conv(torch.randn(6, 8), None, None, torch.randn(4, 2), halo=object())
    assert seen == [bf16_max] and not caught


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


def test_orbax_backend_without_tensorstore_raises(tmp_path):
    """With tensorstore and zstandard hidden (as on the card's machine),
    the orbax save (RADARGNN_CKPT_BACKEND=orbax) and the load of its
    orbax/ folder run on the port's own code and give the tree back bit
    for bit; what raises is what the backend does not read: a zarr3
    checkpoint (use_zarr3: true, which the JAX package never writes), with
    an error naming it, and an unknown backend. The msgpack backend still
    writes."""
    code = r"""
import json, os, sys
import numpy as np
sys.modules["tensorstore"] = None
sys.modules["zstandard"] = None
from radargnn_tpu_torch.train import checkpoint as ckpt
folder = sys.argv[1]
kw = dict(params={"w": np.arange(6, dtype=np.float32).reshape(2, 3)},
          batch_stats={}, opt_state={"count": np.int32(3)}, epoch=2,
          losses={}, scheduler_lr=1e-3)
os.environ["RADARGNN_CKPT_BACKEND"] = "orbax"
ckpt.save_train_state(folder, **kw)
model, opt, meta = ckpt.load_train_state(folder)
same = (np.array_equal(model["params"]["w"], kw["params"]["w"])
        and model["params"]["w"].dtype == np.float32
        and opt["count"].dtype == np.int32 and int(opt["count"]) == 3
        and meta["epoch"] == 2)
path = os.path.join(folder, "orbax", "_METADATA")
with open(path) as f:
    tree = json.load(f)
with open(path, "w") as f:
    json.dump(dict(tree, use_zarr3=True), f)
raised = []
for call in (lambda: ckpt.load_train_state(folder),
             lambda: ckpt.save_train_state(folder, backend="zarr", **kw)):
    try:
        call()
    except ValueError as err:
        raised.append(str(err))
ckpt.save_train_state(folder, backend="msgpack", **kw)
bad = [m for m in sys.modules if m.split(".")[0] in (
    "tensorstore", "zstandard", "orbax", "jax") and sys.modules[m]]
print(json.dumps([same, raised, sorted(os.listdir(folder)), bad]))
"""
    same, raised, files, bad = json.loads(_subprocess(
        "import json\n" + code, str(tmp_path)))
    assert same and not bad
    assert len(raised) == 2, raised
    assert "zarr3" in raised[0] and "use_zarr3" in raised[0], raised
    assert "zarr" in raised[1] and "msgpack" in raised[1], raised
    assert {"model.msgpack", "opt_state.msgpack", "meta.json",
            "orbax"} <= set(files)


def test_bf16_max_config_still_raises_in_process(monkeypatch):
    """The config field routes the dense backward by bf16 (the knob unset
    here): a train-mode step of a DetNet with fused_bf16_max asks the
    gather-max for the bf16 bits at every layer, and the knob, where set,
    overrides the field either way."""
    import torch
    from radargnn_tpu_torch import configs as tcfg
    from radargnn_tpu_torch.models.detnet import DetNet
    from radargnn_tpu_torch.ops import dense_aggregate as da
    assert tlayers.BF16_MAX_ENV is None
    arch = tcfg.GNNArchitectureConfig(
        node_feature_dimension=5, edge_feature_dimension=2,
        conv_layer_dimensions=[8, 8],
        classification_head_layer_dimensions=[6],
        regression_head_layer_dimensions=[5], use_fused_aggregation=True,
        fused_tiling="dense", fused_overflow_fraction=0.3,
        fused_bf16_max=True)
    batch = tbatch.stack_samples(
        tsyn.make_samples(num_frames=2, num_points=200, seed=0),
        max_nodes=256, bg_index=5, max_edges=256 * 20,
        csr_tiling=tlayers.fused_csr_tiling(arch, k=20), device="cpu")
    seen = []
    plain = da.dense_fwd

    def spy(*args, **kw):
        seen.append((kw["emit_inner"], kw["bf16_max"]))
        return plain(*args, **kw)

    monkeypatch.setattr(da, "dense_fwd", spy)
    cls, _ = DetNet(arch, device="cpu").forward_batch(batch)
    cls.square().sum().backward()
    assert seen == [(True, True)] * 2
    assert torch.isfinite(cls).all()
    monkeypatch.setattr(tlayers, "BF16_MAX_ENV", "0")
    assert not tlayers.bf16_max_routing(True)
    monkeypatch.setattr(tlayers, "BF16_MAX_ENV", "1")
    assert tlayers.bf16_max_routing(False)
