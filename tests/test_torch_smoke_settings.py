"""The on-card smoke's ninth phase (`smoke_variants.variants_phase`)
rehearsed on the CPU at the smoke rehearsal's size (2 frames of 200
points), its second half (`settings_phase`): the unfused configurations
against the CPU, the tools as child processes, B4's bf16 landing against
its plain version and the radius configuration under the three variant
knobs, B1 and B2 at receiver tiles of 8 and 24 and two steps at 8, the
orbax backend (with tensorstore and zstandard blocked: a save and restore,
a resumed step, the stores' sizes against their arrays', the JAX
package's committed checkpoint), and the half's
entries of the kernels line. The first half
(`routing_phase`) is tests/test_torch_smoke_variants.py's. Off the card
the wrappers take their plain versions, so nothing is timed and nothing
launches."""

import sys

import numpy as np
import pytest
import torch

from radargnn_tpu_torch import smoke
from radargnn_tpu_torch import smoke_variants as sv

from test_torch_package import check_kernel_entries
from torch_threads import few_threads  # noqa: F401

POINTS, GRAPHS, SEED = 200, 2, 0


@pytest.mark.usefixtures("few_threads")
def test_settings_phase_rehearses_on_cpu(monkeypatch):
    # the card's machine has neither tensorstore nor zstandard: the orbax
    # backend runs on the port's own code
    for name in ("tensorstore", "zstandard"):
        monkeypatch.setitem(sys.modules, name, None)
    dev = torch.device("cpu")
    lines = []
    arch, model, loader = smoke.flagship_serving(dev, POINTS, GRAPHS, 1,
                                                 SEED)
    r_arch, _, r_loader = smoke.flagship_serving(dev, POINTS, GRAPHS, 1,
                                                 SEED, graph="radius")
    shapes = smoke._layer_shapes(model)
    before = torch.are_deterministic_algorithms_enabled()
    var = sv.settings_phase(dev, arch, loader[0], r_arch, r_loader[0],
                            shapes, POINTS, GRAPHS, SEED, 1, 2, lines.append)
    assert torch.are_deterministic_algorithms_enabled() == before

    # the unfused model, the tools
    assert [u["case"] for u in var["unfused"]] == [
        "MPNNConv, pre-MLP 2 layers, mean",
        "RadarPointGNNConv, pre-MLP 2 layers, add"]
    assert all(u["bitwise_repeat"] and len(u["losses"]) == 2
               for u in var["unfused"])
    tools = var["tools"]
    assert [m["metric"] for m in tools["convergence"][-2:]] == [
        "synthetic_map", "synthetic_f1_macro"]
    assert tools["preprocessing"][1].startswith("2-process pool: ")

    # the bf16 landing: equal on both kinds of inputs here (one summation
    # order), and the landing moved maxima
    landing = var["windowed_landing"]
    assert [r["d_in"] for r in landing] == [224, 224, 224, 128, 64]
    assert all(r["entries_differ"] == 0 and r["bits_flipped"] == 0
               and r["max_ulps"] == r["max_sum_ulps"] == 0.0
               and r["dyadic_equal"] and r["dyadic_landed"] > 0
               for r in landing)
    # the variant knobs: within the training and serving limits, and off
    # bf16 routing alone (whose first step is the strict run's)
    knob = var["knob_train"]
    assert knob["train_max_rel_loss_diff"] == 0.0
    assert knob["model_max_dprob"] == 0.0
    strict = sv._deterministic_runs(lambda _: smoke.flagship_training(
        dev, r_arch, r_loader[0], SEED, 1)["losses"])
    assert knob["train_losses"][0] != strict[0]
    # dense receiver tiles of 8 and 24
    for r_tile in (8, 24):
        rows = var[f"r_tile_{r_tile}"]
        assert [r["d_in"] for r in rows["fwd"]] == [224, 224, 224, 128, 64]
        assert all(r["bits_flipped"] == 0 for r in rows["fwd"])
        assert all(r["bitwise_repeat"] and r["routed"] > 0
                   for r in rows["bwd"])
        assert any(f"at r_tile {r_tile}: " in s for s in lines)
    assert var["r_tile_8_train"]["train_max_rel_loss_diff"] == 0.0
    assert np.isfinite(var["r_tile_8_train"]["train_losses"]).all()
    # orbax, on the port's own code: the state restored bit for bit, a
    # fresh trainer resumed from it stepping to the uninterrupted one's
    # losses bit for bit, the stores compressed (the trainer's and the
    # flagship state's, each beside its arrays' bytes), and the JAX
    # package's checkpoint read as its seed's state
    orbax = var["orbax"]
    assert orbax["bitwise"] and orbax["leaves"] > 100
    assert orbax["array_bytes"] > 10_000_000
    assert orbax["ratio"] == orbax["bytes"] / orbax["array_bytes"]
    assert orbax["ratio"] <= sv.ORBAX_TRAINED_RATIO
    state = orbax["state"]
    assert state["bitwise"] and state["array_bytes"] == orbax["array_bytes"]
    assert state["ratio"] <= sv.ORBAX_STATE_RATIO
    assert any(s.startswith("orbax backend on the CPU: the trainer's store "
                            f"of {orbax['bytes']} bytes for "
                            f"{orbax['array_bytes']} bytes of arrays: ratio")
               for s in lines)
    assert any(s.startswith("orbax backend on the CPU: the flagship state ")
               and f"ratio {state['ratio']:.4f} (at most 0.75)" in s
               for s in lines)
    assert "ocdbt.process_0/manifest.ocdbt" in orbax["files"]
    assert orbax["resume_bitwise"]
    assert orbax["resumed_losses"] == orbax["losses"]
    assert np.isfinite(orbax["losses"]).all()
    assert orbax["fixture"]["bitwise"] and orbax["fixture"]["meta"]
    assert orbax["fixture"]["resumed"]
    assert any(s.startswith("orbax backend: the JAX package's checkpoint")
               for s in lines)

    kernels = sv.settings_kernels(var, on_card=False)
    assert [k["name"] for k in kernels] == [
        "windowed_fwd_v3_bf16_landing", "dense_fwd_v4_r_tile_8",
        "dense_bwd_v4_r_tile_8"]
    check_kernel_entries(kernels)
