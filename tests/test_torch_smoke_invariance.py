"""The on-card smoke's invariance phase (`smoke_invariance.invariance_phase`)
rehearsed on the CPU at a small size (2 frames of 200 points, the
flagship's widths, 2 requests, 2 steps), where the wrappers take their
plain versions: nothing launches and nothing is timed. The configurations
the phase derives from the flagship YAML, the phase's checks and printed
lines, the launches the card must show; then the host's point-pair helper
missing or wrong, which the phase must refuse."""

import json
from unittest import mock

import numpy as np
import pytest
import torch

from radargnn_tpu_torch import native
from radargnn_tpu_torch import smoke as sm
from radargnn_tpu_torch import smoke_invariance as si

from torch_threads import few_threads  # noqa: F401

POINTS, GRAPHS, SEED = 200, 2, 0
SHAPES = [(224, 16, 464)] * 3 + [(128, 16, 272), (64, 16, 144)]


def test_the_configurations_replace_only_their_fields():
    """`flagship_configs(invariance=)` replaces the box encoding, the node
    and edge features and their widths, and nothing else of the flagship
    YAML; POSTPROCESSING takes the box encoding."""
    arch, graph, bg, replaced = sm.flagship_configs()
    assert replaced == {} and sm.flagship_bb_invariance() == "translation"
    for inv in ("en", "none"):
        i_arch, i_graph, i_bg, i_replaced = sm.flagship_configs(
            invariance=inv)
        assert i_replaced == sm.INVARIANCES[inv] and i_bg == bg
        assert i_graph.node_features == i_replaced["node_features"]
        assert i_arch.node_feature_dimension == \
            i_replaced["node_feature_dimension"]
        widths = {"node_feature_dimension", "edge_feature_dimension"}
        assert {k: v for k, v in vars(i_arch).items() if k not in widths} \
            == {k: v for k, v in vars(arch).items() if k not in widths}
        assert {k: v for k, v in vars(i_graph).items()
                if not k.endswith("_features")} == \
            {k: v for k, v in vars(graph).items()
             if not k.endswith("_features")}
        post = sm.flagship_postprocessing(inv)
        assert post.bb_invariance == sm.flagship_bb_invariance(inv) == inv
        assert post.adapt_orientation_angle
        assert sm.inverts_adaption(post) == (inv == "none")
    en_arch, en_graph, _, _ = sm.flagship_configs(invariance="en")
    assert (en_arch.node_feature_dimension,
            en_arch.edge_feature_dimension) == (4, 4)
    assert en_graph.edge_features == ["point_pair_features"]
    none_arch, none_graph, _, _ = sm.flagship_configs(invariance="none")
    assert (none_arch.node_feature_dimension,
            none_arch.edge_feature_dimension) == (7, 2)
    assert none_graph.edge_features == graph.edge_features
    assert sm.inverts_adaption(sm.flagship_postprocessing())
    with pytest.raises(KeyError):
        sm.flagship_configs(invariance="rotation")


@pytest.mark.usefixtures("few_threads")
def test_invariance_phase_rehearses_on_cpu():
    lines = []
    before = torch.are_deterministic_algorithms_enabled()
    res = si.invariance_phase("cpu", POINTS, GRAPHS, batches=2, seed=SEED,
                              reps=1, train_steps=2, out=lines.append)
    assert torch.are_deterministic_algorithms_enabled() == before
    assert list(res["configs"]) == ["en", "none"]
    for inv, cfg in res["configs"].items():
        assert cfg["replaced"] == sm.INVARIANCES[inv]
        assert cfg["shapes"] == SHAPES, inv
        rows = [r for rs in cfg["checked"].values() for r in rs]
        assert len(rows) == 15
        assert all(r["max_abs_err"] == 0.0 for r in rows), inv
        assert all(r["bitwise_repeat"] and r["routed"] > 0
                   for r in cfg["checked"]["dense_bwd_v4"])
        assert cfg["serve_launches"] == [0] * len(sm.KERNEL_NAMES)
        assert cfg["model_max_dprob"] == 0.0
        assert cfg["train_max_rel_loss_diff"] == 0.0
        losses = np.asarray(cfg["train_losses"])
        assert losses.shape == (2, 3) and np.isfinite(losses).all()
        assert losses[1, 0] < losses[0, 0]
        assert 0.0 < cfg["train_witness_drift"] < 1.0
        assert [b["rel_diff"] for b in cfg["bias_grads"]] == [0.0] * 5
        # MPNNConv's offset bias cancels under the BatchNorm after each
        # conv, as RadarPointGNNConv's does
        assert all(b["cancelled_to"] < 1e-2 for b in cfg["bias_grads"])
        ev = cfg["evaluation"]
        assert ev["oracle"]["map"] == 1.0 and ev["oracle"]["box_iou_map"] \
            == 1.0
        for label in ("real", "oracle"):
            assert ev[label]["max_abs_dmap"] == ev[label]["max_abs_df1"] \
                == 0.0
    ppf = res["configs"]["en"]["native_ppf"]
    assert ppf["built"] and ppf["edges"] == GRAPHS * POINTS * 20
    assert max(ppf["rel_err"]) <= si.NATIVE_PPF_RTOL
    assert max(ppf["scale"][1:]) > 170.0       # angles up to 180 degrees
    assert "native_ppf" not in res["configs"]["none"]
    assert res["train_launches"] == [0] * len(sm.KERNEL_NAMES)
    assert set(res["checked"]) == {"dense_proj_v4", "dense_fwd_v4",
                                   "dense_bwd_v4"}
    assert len(res["checked"]["dense_fwd_v4"]) == 10

    # the lines the card's run prints
    for name in si.NAMES.values():
        for start in (f"{name} model: the flagship configuration with ",
                      f"launches on the {name} serving path",
                      f"launches on the {name} training path",
                      f"{name} model vs plain path",
                      f"{name} training losses",
                      f"{name} pre-MLP biases"):
            assert any(s.startswith(start) for s in lines), start
    for inv in ("en", "none"):
        assert any(s.startswith(f"evaluation (oracle predictions, {inv} "
                                "boxes") for s in lines), inv
    assert any(s.startswith("E(n)-invariant: the compiled point-pair helper "
                            "(native/geometry.cpp) built") for s in lines)
    kernel_line = [s for s in lines if s.startswith("invariance kernels")]
    assert len(kernel_line) == 1
    times = json.loads(kernel_line[0].split(": ", 1)[1])
    assert times["card"] is None and set(times) == {"card", "en", "none"}
    for inv in ("en", "none"):
        assert set(times[inv]) == set(res["checked"])
        assert all(t["bound_ms"] > 0 and t["ms"] is None
                   for t in times[inv].values())
    assert lines[-1].startswith("invariance phase: ")


def test_invariance_launch_expectations():
    """What the card's run must count at the smoke's size (5 layers, 3
    requests, 4 steps), in the order of KERNEL_NAMES: B1's projection and
    gather-max once a layer and request; in training those and B2 once a
    layer and step; over both configurations what the kernels line adds
    to the three dense entries."""
    names = sm.KERNEL_NAMES
    serve, train = si.expected_launches(si.FORWARD, si.TRAIN_EXTRA, 5, 3, 4,
                                        True)
    assert {names[i]: v for i, v in enumerate(serve) if v} == {
        "dense_proj_v4": 15, "dense_fwd_v4": 15}
    assert {names[i]: v for i, v in enumerate(train) if v} == {
        "dense_proj_v4": 20, "dense_fwd_v4": 20, "dense_bwd_v4": 20}
    assert si.expected_launches(si.FORWARD, si.TRAIN_EXTRA, 5, 3, 4,
                                False) == ([0] * len(names),) * 2


@pytest.fixture(scope="module")
def en_batch():
    """The "en" configuration's first request at the rehearsal's size."""
    _, _, loader = sm.flagship_serving("cpu", POINTS, GRAPHS, 1, SEED,
                                       invariance="en")
    return loader[0]


def test_native_check_refuses_a_missing_helper(en_batch):
    """Where the compiled helper did not build, the phase fails rather
    than time the numpy formula in its place."""
    lines = []
    with mock.patch.object(native, "load", lambda: None), \
            pytest.raises(AssertionError, match="did not build"):
        si.check_native_ppf(en_batch, lines.append, "en")
    assert lines == ["en: the compiled point-pair helper "
                     "(native/geometry.cpp) did not build"]


@pytest.mark.parametrize("column,shift", [(0, 1e-3), (3, 5e-3)])
def test_native_check_refuses_a_wrong_column(en_batch, column, shift):
    """A helper whose distance or last angle is off by 1e-3 m or 5e-3
    degrees (3e-5 of the distance's scale, 3e-5 of 180 degrees) on every
    edge leaves NATIVE_PPF_RTOL; the sound helper passes."""
    assert native.load() is not None
    got = si.check_native_ppf(en_batch, lambda line: None, "en")
    assert max(got["rel_err"]) <= 1e-9
    real = native.point_pair_features_2d

    def wrong(*args):
        out = real(*args)
        out[:, column] += shift
        return out

    with mock.patch.object(native, "point_pair_features_2d", wrong), \
            pytest.raises(AssertionError, match="leaves the numpy formula"):
        si.check_native_ppf(en_batch, lambda line: None, "en")
