"""A CPU rehearsal of the tenth phase's RadarPointGNNConv runs
(`smoke_parallel.parallel_phase` with convs ("RadarPointGNNConv",)): two
gloo ranks on a {"model": 2} mesh, halo x dense on the kNN batch and halo
x windowed on the radius batch, 2 frames of 512 points, where the
wrappers take their plain versions and launch nothing. The report's
fields, then the bias check against planted faults: the pre-MLP bias
gradient without the sum over the ranks (rank 0's own part), or the
offset gradient's magnitudes without it (rank 0's rows alone), must fail
it."""

import copy

import numpy as np
import pytest
import torch

from radargnn_tpu_torch import smoke_parallel as sp
from radargnn_tpu_torch.smoke_pointgnn import BIAS_GRAD_RTOL

from torch_threads import THREADS, few_threads  # noqa: F401

CONV = "RadarPointGNNConv"


@pytest.fixture(scope="module")
def rehearsal():
    """The phase's RadarPointGNNConv runs, with the inputs each run's bias
    check took (on `few_threads`' thread count: a module's fixture comes
    before a test's)."""
    checked = []
    real = sp.bias_check

    def spy(*args):
        checked.append(args)
        return real(*args)

    lines = []
    was = torch.get_num_threads()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sp, "bias_check", spy)
        mp.setenv("OMP_NUM_THREADS", str(THREADS))
        torch.set_num_threads(THREADS)
        try:
            res = sp.parallel_phase("cpu", points=512, graphs=2,
                                    run_children=False, convs=(CONV,),
                                    out=lines.append)
        finally:
            torch.set_num_threads(was)
    return res, lines, checked, real


@pytest.mark.usefixtures("few_threads")
def test_pointgnn_runs_of_the_parallel_phase_rehearse_on_cpu(rehearsal):
    """Both runs on two gloo ranks: the broadcast-bias aggregate equal to
    the single device's, two steps within the training limits, the request
    within the serving limit, no launches off the card, and each conv's
    bias reading at each step within its limits and printed."""
    res, lines, checked, _ = rehearsal
    runs = res["runs"]
    assert [(r["graph"], r["conv"], r["backend"]) for r in runs] == [
        ("knn", CONV, "gloo"), ("radius", CONV, "gloo")]
    for r in runs:
        assert r["agg_bitwise"] and r["agg_max_abs_err"] == 0.0
        assert r["agg_scale"] > 0
        assert len(r["step_agreement"]) == 2 and len(r["step_s"]) == 2
        assert r["request_prob_err"] <= 2e-2
        assert r["launches"] == {"agg": {}, "train": {}, "request": {}}
        assert not any(r["path_launches"])
        assert r["geometry"][5:7] == (1, 2)
        bias = r["bias"]
        assert [(b["step"], b["param"]) for b in bias] == [
            (i, f"conv_{k}.pre_mlp.lin_0.bias")
            for i in range(2) for k in range(5)]
        for b in bias:
            assert b["rel_diff"] <= BIAS_GRAD_RTOL
            assert b["scale_rel"] <= sp.BIAS_SCALE_RTOL
            # the trainer's sum over the ranks is the ranks' parts summed
            assert b["parts_vs_sum"] <= 1e-6
    assert len(checked) == 2
    assert res["pointgnn_s"] > 0
    assert lines[-2].startswith("parallel phase: the RadarPointGNNConv halo "
                                "runs")
    assert sum("pre-MLP biases" in line for line in lines) == 2
    assert lines[-1].startswith("parallel phase on cpu: 2 runs")


def _without_rank_sum(res, key):
    """The ranks' results with the sum over the ranks left out of `key`:
    "grads", the bias gradient Adam took replaced by rank 0's own part;
    "rows", the other ranks' offset magnitudes zero."""
    res = copy.deepcopy(res)
    for i, step in enumerate(res[0]["offset_grads"]):
        for k, part in enumerate(step["rank"]):
            name = f"conv_{k}.pre_mlp.lin_0.bias"
            if key == "grads":
                res[0]["grads"][i][name] = part
            else:
                for r in res[1:]:
                    r["offset_grads"][i]["rows"][k] = np.zeros_like(
                        r["offset_grads"][i]["rows"][k])
    return res


@pytest.mark.usefixtures("few_threads")
@pytest.mark.parametrize("key", ["grads", "rows"])
def test_bias_check_fails_without_the_sum_over_ranks(rehearsal, key):
    """The bias check on each run's own inputs, with the sum over the ranks
    dropped from the bias gradient or from the offset gradient's
    magnitudes: it raises on both runs, where the sound inputs passed."""
    _, _, checked, bias_check = rehearsal
    for dev, arch, batch, job, res in checked:
        with pytest.raises(AssertionError, match="pre-MLP biases"):
            bias_check(dev, arch, batch, job, _without_rank_sum(res, key))
