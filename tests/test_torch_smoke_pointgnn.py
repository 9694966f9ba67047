"""The on-card smoke's Radar-PointGNN phase (`smoke_pointgnn.pointgnn_phase`)
rehearsed on the CPU at a small size (2 frames of 200 points, the
flagship's widths), where the wrappers take their plain versions: nothing
launches and nothing is timed. The phase's printed lines, the replaced
field, the layer shape, the launches the card must show, the kernels
line's additions; then a kernel whose output is perturbed, which each of
the phase's checks must refuse."""

import json

import numpy as np
import pytest
import torch

from radargnn_tpu_torch import smoke as sm
from radargnn_tpu_torch import smoke_pointgnn as sp
from radargnn_tpu_torch.ops import csr_aggregate as ca
from radargnn_tpu_torch.ops import dense_aggregate as da
from radargnn_tpu_torch.ops import windowed_aggregate as wa

from torch_threads import few_threads  # noqa: F401

POINTS, GRAPHS, SEED = 200, 2, 0
SHAPE = (224, 16, 240)


@pytest.mark.usefixtures("few_threads")
def test_pointgnn_phase_rehearses_on_cpu():
    lines = []
    before = torch.are_deterministic_algorithms_enabled()
    res = sp.pointgnn_phase("cpu", POINTS, GRAPHS, batches=2, seed=SEED,
                            reps=1, train_steps=2, drift_seeds=1,
                            out=lines.append)
    assert torch.are_deterministic_algorithms_enabled() == before
    assert res["replaced"] == {"conv_layer_type": "RadarPointGNNConv"}
    assert list(res["paths"]) == ["kNN", "radius", "CSR"]
    replaced = [json.loads(s.split(" the flagship configuration with ")[1]
                           .split(" replaced;")[0])
                for s in lines if s.startswith("Radar-PointGNN ")
                and " path: the flagship configuration with " in s]
    assert [r["conv_layer_type"] for r in replaced] == [
        "RadarPointGNNConv"] * 3
    assert replaced[2]["fused_tiling"] == "csr"
    assert replaced[1]["graph_construction_algorithm"] == "radius"
    for label, path in res["paths"].items():
        assert path["shapes"] == [SHAPE] * 5, label
        rows = [r for rs in path["checked"].values() for r in rs]
        assert all(r["max_abs_err"] == 0.0 and r["d_in"] == 224
                   for r in rows if "d_in" in r), label
        assert all(r["h"] == 240 for r in rows if "h" in r), label
        assert path["serve_launches"] == [0] * len(sm.KERNEL_NAMES)
        assert path["model_max_dprob"] == 0.0
        assert path["train_max_rel_loss_diff"] == 0.0
        losses = np.asarray(path["train_losses"])
        assert losses.shape == (2, 3) and losses[1, 0] < losses[0, 0]
        assert [b["rel_diff"] for b in path["bias_grads"]] == [0.0] * 5
        # the bias gradients cancel (BatchNorm after the residual update)
        assert all(b["cancelled_to"] < 1e-2 for b in path["bias_grads"])
        c3 = path["c3"]
        assert [r["kernel_vs_plain"] for r in c3["runs"]] == [0.0]
        assert c3["witness_vs_plain"]["median"] > 0.0
        assert c3["median_ratio"] == 0.0
    assert set(res["paths"]["kNN"]["checked"]) == {
        "dense_proj_v4", "dense_fwd_v4", "dense_bwd_v4"}
    assert set(res["paths"]["radius"]["checked"]) == {
        "dense_proj_v4", "windowed_fwd_v3", "windowed_bwd_v3"}
    assert [(r["site"], r["d"], r["pitch"]) for r in
            res["paths"]["CSR"]["checked"]["segment_sum_csr"]] == [
        ("d_xg", 224, 224), ("d_op", 240, 256)]
    assert all(r["bitwise_repeat"] for r in
               res["paths"]["CSR"]["checked"]["csr_bwd_v2"])

    # the lines the card's run prints
    for label in ("kNN", "radius", "CSR"):
        name = f"Radar-PointGNN {label}"
        for start in (f"launches on the {name} serving path",
                      f"launches on the {name} training path",
                      f"{name} model vs plain path",
                      f"{name} training losses",
                      f"{name} pre-MLP biases",
                      f"{name} C3: free-running loss gaps"):
            assert any(s.startswith(start) for s in lines), start
    kernel_line = [s for s in lines if s.startswith("pointgnn kernels: ")]
    assert len(kernel_line) == 1
    times = json.loads(kernel_line[0][len("pointgnn kernels: "):])
    assert times["shape"] == [list(SHAPE)] and times["card"] is None
    kernels = {"dense_proj_v4", "dense_fwd_v4", "dense_bwd_v4",
               "segment_sum_csr", "windowed_fwd_v3", "windowed_bwd_v3",
               "csr_fwd_v2", "csr_bwd_v2"}
    assert set(times) - {"shape", "card"} == kernels
    assert all(t["bound_ms"] > 0 and t["ms"] is None
               for n, t in times.items() if n in kernels)
    assert lines[-1].startswith("Radar-PointGNN phase: ")

    # what the kernels line takes from the phase: its training launches
    # (none here) and its rows, the kNN and radius paths' projections both
    assert set(res["checked"]) == kernels
    assert res["train_launches"] == [0] * len(sm.KERNEL_NAMES)
    assert len(res["checked"]["dense_proj_v4"]) == 2


def test_pointgnn_launch_expectations():
    """What the card's run must count at the smoke's size (5 layers, 3
    requests, 4 steps), in the order of KERNEL_NAMES: each path's forward
    kernels once a layer and request; in training the forward's kernels,
    the backward once a layer and step, B3 twice on the CSR path; over the
    three paths what the kernels line adds."""
    names = sm.KERNEL_NAMES
    total = np.zeros(len(names), dtype=int)
    want = {"kNN": ("dense_fwd_v4", "dense_bwd_v4"),
            "radius": ("windowed_fwd_v3", "windowed_bwd_v3"),
            "CSR": ("csr_fwd_v2", "csr_bwd_v2")}
    for label, _, _, fwd, extra in sp.PATHS:
        serve, train = sp.expected_launches(fwd, extra, 5, 3, 4, True)
        f, b = want[label]
        assert {names[i]: v for i, v in enumerate(serve) if v} == {
            "dense_proj_v4": 15, f: 15}
        assert {names[i]: v for i, v in enumerate(train) if v} == dict(
            {"dense_proj_v4": 20, f: 20, b: 20},
            **({"segment_sum_csr": 40} if label == "CSR" else {}))
        assert sp.expected_launches(fwd, extra, 5, 3, 4, False) == (
            [0] * len(names), [0] * len(names))
        total += train
    assert {names[i]: int(v) for i, v in enumerate(total) if v} == {
        "dense_proj_v4": 60, "dense_fwd_v4": 20, "dense_bwd_v4": 20,
        "windowed_fwd_v3": 20, "windowed_bwd_v3": 20, "csr_fwd_v2": 20,
        "csr_bwd_v2": 20, "segment_sum_csr": 40}


@pytest.fixture(scope="module")
def batches():
    """Each path's first batch and its configuration, at the rehearsal's
    size."""
    out = {}
    for label, graph, tiling, _, _ in sp.PATHS:
        arch, _, loader = sm.flagship_serving(
            "cpu", POINTS, GRAPHS, 1, SEED, graph=graph, tiling=tiling,
            conv=sp.CONV)
        out[label] = (arch, loader[0])
    return out


def _perturbed(mod, name: str, fault):
    """`mod.name` replaced by its plain version with `fault` applied to
    its result (the kernel's output on the card)."""
    plain = getattr(mod, f"{name}_plain")
    if name == "csr_bwd":       # the kernel's wrapper takes the landing
        plain = sm.without_landing(plain)

    def wrapper(*args, **kw):
        return fault(plain(*args, **kw), kw)
    return wrapper


def _first_entry_moved(res, kw):
    out = res[0] if isinstance(res, tuple) else res
    out = out.clone()
    out.view(-1)[0] += 1.0
    return (out,) + tuple(res[1:]) if isinstance(res, tuple) else out


def _first_output_moved(res, kw):
    return (_first_entry_moved(res[0], kw),) + tuple(res[1:])


@pytest.mark.usefixtures("few_threads")
@pytest.mark.parametrize("label,mod,name,fault", [
    ("kNN", da, "dense_fwd", _first_entry_moved),
    ("kNN", da, "dense_bwd", _first_output_moved),
    ("radius", wa, "windowed_fwd", _first_entry_moved),
    ("radius", wa, "windowed_bwd", _first_output_moved),
    ("CSR", ca, "csr_fwd", _first_entry_moved),
    ("CSR", ca, "csr_bwd", _first_output_moved),
])
def test_perturbed_kernel_fails_the_kernel_check(batches, monkeypatch, label,
                                                 mod, name, fault):
    """(a): a forward or backward kernel whose output moves by 1.0 in one
    entry fails its check against the plain version at the layer shape."""
    monkeypatch.setattr(mod, name, _perturbed(mod, name, fault))
    _, batch = batches[label]
    with pytest.raises(AssertionError):
        sp.check_kernels(batch.flat_tiling(), [SHAPE], SEED, 1, print)


def _rows_dropped(res, kw):
    """The VJP mode's maxima of the first 64 receivers lost: they read as
    empty, so the backward passes them no g (and the output is 0 there)."""
    if not kw.get("emit_inner"):
        return res
    out, inner, bits = res
    out, inner = out.clone(), inner.clone()
    out[:64] = 0.0
    inner[:64] = da._NEG
    return out, inner, bits


@pytest.mark.usefixtures("few_threads")
def test_dropped_rows_fail_the_bias_check(batches, monkeypatch):
    """(c): a forward kernel that loses receivers' maxima in VJP mode takes
    their rows out of the broadcast offset's gradient; the pre-MLP biases'
    check against the plain path refuses it, though those gradients cancel
    to rounding where nothing is lost."""
    arch, batch = batches["kNN"]
    lines = []
    res = sp.check_offset_grads("cpu", arch, batch, SEED, "kNN",
                                lines.append)
    assert [r["rel_diff"] for r in res] == [0.0] * 5
    monkeypatch.setattr(da, "dense_fwd",
                        _perturbed(da, "dense_fwd", _rows_dropped))
    with pytest.raises(AssertionError, match="pre-MLP biases"):
        sp.check_offset_grads("cpu", arch, batch, SEED, "kNN",
                              lambda s: print(s))


def _edge_grads_negated(res, kw):
    d_e, *rest = res
    return (-d_e, *rest)


@pytest.mark.usefixtures("few_threads")
def test_perturbed_backward_fails_the_training_check(batches, monkeypatch):
    """(c): a backward kernel whose edge gradient comes back negated leaves
    the plain path's gradients at the first step (the edge embedding's
    cosine near -1), and the training comparison refuses it."""
    arch, batch = batches["kNN"]
    monkeypatch.setattr(da, "dense_bwd",
                        _perturbed(da, "dense_bwd", _edge_grads_negated))
    with pytest.raises(AssertionError, match="disagrees with the plain"):
        sm._train_phase(torch.device("cpu"), arch, batch, SEED, 1,
                        [0] * len(sm.KERNEL_NAMES), "kNN", lambda s: None)
