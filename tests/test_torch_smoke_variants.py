"""The on-card smoke's ninth phase (`smoke_variants.variants_phase`)
rehearsed on the CPU at the smoke rehearsal's size (2 frames of 200
points), its first half (`routing_phase`): bf16 routing against its plain
versions, ovf_ssum, the training runs under fused_bf16_max (dense,
windowed, CSR) and under ovf_ssum, and the half's entries of the kernels
line. The second half (`settings_phase`) is
tests/test_torch_smoke_settings.py's. Off the card the wrappers take their
plain versions, so nothing is timed and nothing launches."""

import numpy as np
import pytest
import torch

from radargnn_tpu_torch import smoke
from radargnn_tpu_torch import smoke_variants as sv

from test_torch_package import check_kernel_entries
from torch_threads import few_threads  # noqa: F401

POINTS, GRAPHS, SEED = 200, 2, 0


@pytest.mark.usefixtures("few_threads")
def test_routing_phase_rehearses_on_cpu():
    dev = torch.device("cpu")
    lines = []
    arch, model, loader = smoke.flagship_serving(dev, POINTS, GRAPHS, 1,
                                                 SEED)
    r_arch, _, r_loader = smoke.flagship_serving(dev, POINTS, GRAPHS, 1,
                                                 SEED, graph="radius")
    c_arch, _, c_loader = smoke.flagship_serving(dev, POINTS, GRAPHS, 1,
                                                 SEED, tiling="csr")
    shapes = smoke._layer_shapes(model)
    # the strict runs whose first step the bf16 runs must give bit for bit
    strict = sv._deterministic_runs(lambda _: {
        name: smoke.flagship_training(dev, a, b[0], SEED, 2)["losses"]
        for name, a, b in (("dense", arch, loader),
                           ("windowed", r_arch, r_loader))})
    before = torch.are_deterministic_algorithms_enabled()
    var = sv.routing_phase(dev, arch, loader[0], r_arch, r_loader[0],
                           c_arch, c_loader[0], shapes, POINTS, GRAPHS,
                           SEED, 1, 2, strict, lines.append)
    assert torch.are_deterministic_algorithms_enabled() == before
    for key in ("dense_bits", "windowed_bits"):
        assert [r["d_in"] for r in var[key]] == [224, 224, 224, 128, 64]
        assert all(r["bits_flipped"] == 0 and r["ties_bits_equal"]
                   and r["ties_routed"] > r["ties_routed_strict"]
                   for r in var[key])
    assert [r["d"] for r in var["ovf_landing"]] == [224, 224, 224, 128, 64]
    for key in ("dense_train", "windowed_train", "ovf_ssum_train"):
        assert var[key]["train_max_rel_loss_diff"] == 0.0
        assert np.isfinite(var[key]["train_losses"]).all()
    # bf16 routing: the first step's forward as the strict run's, the
    # second step's parameters moved by other gradients
    for key, name in (("dense_train", "dense"),
                      ("windowed_train", "windowed")):
        assert len(var[key]["train_losses"]) == 2
        assert var[key]["train_losses"][0] == strict[name][0]
        assert var[key]["train_losses"][1] != strict[name][1]
    assert np.isfinite(var["csr_train"]["losses"]).all()
    kernels = sv.routing_kernels(var, on_card=False)
    assert [k["name"] for k in kernels] == [
        "dense_fwd_v4_bf16_max", "windowed_fwd_v3_bf16_max",
        "segment_sum_csr_ovf_ssum"]
    check_kernel_entries(kernels)
