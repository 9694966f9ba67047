"""The windowed kernels' variant knobs (RADARGNN_FUSED_BF16_LANDING,
_PRECOMP_LAND, _STREAM_M) in the port, against the JAX package on the CPU.

The JAX side runs `make_fused_hoisted_aggregate_v3` in interpret mode with
the variant flags; the port takes its plain versions, with `bf16_landing`
rounding the windowed maxima as B4's kernel does. The cases run on dyadic
inputs (tests/test_torch_bf16_max.py), whose operands are exact in
float32 in any order, so both packages land and route the same values.
The cotangent is bf16-exact: in interpret mode the JAX backward gathers g
through its landing one-hot, which `precomp_land` streams in bf16 and the
in-kernel build keeps in float32 (the interpret-mode compute dtype), so
`precomp_land` rounds g to bf16 and `bf16_landing` alone does not; on a
TPU, and for a bf16-exact g, the two are the same function (the model
hands the aggregation such a g in bf16 compute)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radargnn_tpu import configs as jcfg
from radargnn_tpu.graph import batch as jbatch
from radargnn_tpu.models import layers as jlayers
from radargnn_tpu.models.detnet import create_detnet_state
from radargnn_tpu.ops import pallas_kernels as jpk
from radargnn_tpu.train.trainer import Trainer as JTrainer
from radargnn_tpu_torch import configs as tcfg
from radargnn_tpu_torch import weights
from radargnn_tpu_torch.graph import batch as tbatch
from radargnn_tpu_torch.models import layers as tlayers
from radargnn_tpu_torch.models.detnet import DetNet
from radargnn_tpu_torch.ops import windowed_aggregate as wa
from radargnn_tpu_torch.train.trainer import Trainer

from test_torch_bf16_max import _dyadic
from test_torch_windowed import (
    _DIFF, _agg_setup, _arch_kw, _bucket, _jax_consts, _landing, _samples,
    _spec, _train_kw,
)

RTOL = ATOL = 1e-4

# (the JAX factory's variant flags with bf16_max, the port's bf16_landing)
_VARIANTS = {
    "bf16_landing": (dict(bf16_landing=True), True),
    "bf16_landing+precomp_land": (dict(bf16_landing=True, precomp_land=True),
                                  True),
    "stream_m+sender_dx": (dict(stream_m=True, sender_dx=True), False),
}


def _cotangent(geo, a, seed=7):
    """A seeded cotangent exact in bf16: multiples of 1/8 in [-2, 2]."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-16, 17, size=(geo["n"], a["w_s"].shape[1]))
            / 8.0).astype(np.float32)


def _jax_run(geo, a, g, flags):
    fused = jpk.make_fused_hoisted_aggregate_v3(
        geo["n"], geo["node_block"], geo["edge_tile"], geo["wb"],
        roll_passes=geo["roll"], bf16_max=True, **flags)
    consts = _jax_consts(a)
    args = tuple(jnp.asarray(a[k]) for k in _DIFF)
    out, vjp = jax.vjp(lambda *ar: fused(*ar, *consts), *args)
    return np.asarray(out), [np.asarray(v) for v in vjp(jnp.asarray(g))]


def _port_run(geo, a, g, bf16_landing):
    t = {k: torch.from_numpy(np.ascontiguousarray(a[k]))
         for k in _DIFF + ("recv", "blocks", "tile_win", "sloc", "ovf_s",
                           "ovf_r")}
    leaves = [t[k].clone().requires_grad_() for k in _DIFF]
    out = wa.windowed_aggregate(
        *leaves, t["recv"], t["blocks"], t["tile_win"], t["sloc"],
        t["ovf_s"], t["ovf_r"], node_block=geo["node_block"],
        edge_tile=geo["edge_tile"], landing=_landing(geo, a), bf16_max=True,
        bf16_landing=bf16_landing)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    return out.detach().numpy(), [v.numpy() for v in grads]


@pytest.mark.parametrize("variant", list(_VARIANTS))
def test_variant_matches_the_jax_factory(variant):
    """The forward and its six gradients with bf16_max and the variant,
    against the JAX v3 factory in interpret mode, at 1e-4; the landing
    moves the forward off bf16_max alone's."""
    flags, landing = _VARIANTS[variant]
    geo, a = _agg_setup(seed=5)
    a = _dyadic(a)
    g = _cotangent(geo, a)
    want_out, want = _jax_run(geo, a, g, flags)
    got_out, got = _port_run(geo, a, g, landing)
    np.testing.assert_allclose(got_out, want_out, rtol=RTOL, atol=ATOL)
    for name, u, v in zip(_DIFF, got, want):
        np.testing.assert_allclose(u, v, rtol=RTOL, atol=ATOL, err_msg=name)
    plain_out, _ = _port_run(geo, a, g, False)
    if landing:
        assert np.abs(got_out - plain_out).max() > 1e-3
    else:
        np.testing.assert_array_equal(got_out, plain_out)


def test_bf16_landing_rounds_only_the_windowed_maxima():
    """The plain forward with the landing: the slots' maxima rounded to
    bf16 (to nearest even) before the overflow maxima, which stay float32,
    are merged; receivers with neither stay empty."""
    geo, a = _agg_setup(seed=5)
    t = {k: torch.from_numpy(np.ascontiguousarray(a[k]))
         for k in ("recv", "sloc", "tile_win", "blocks")}
    n, h = geo["n"], a["w_s"].shape[1]
    gen = torch.Generator().manual_seed(0)
    y_s = torch.nn.functional.pad(torch.randn(n, h, generator=gen),
                                  (0, 64 - h))
    e_t = torch.randn(a["e_t"].shape, generator=gen)
    w_e = torch.randn(a["w_e"].shape, generator=gen)
    inner_o = torch.full((n, h), -3.0e38)
    inner_o[:4] = torch.randn(4, h, generator=gen) + 10.0
    kw = dict(node_block=geo["node_block"], edge_tile=geo["edge_tile"],
              emit_inner=True)
    args = (y_s, e_t, w_e, t["recv"], t["sloc"], t["tile_win"],
            t["blocks"], inner_o, torch.zeros(n, h))
    _, strict, _ = wa.windowed_fwd_plain(*args, **kw)
    _, landed, _ = wa.windowed_fwd_plain(*args, bf16_landing=True, **kw)
    _, win, _ = wa.windowed_fwd_plain(*args[:7], torch.full((n, h), -3.0e38),
                                      args[8], **kw)
    has = win > -1.5e38
    want = torch.where(has, win.to(torch.bfloat16).float(), win)
    torch.testing.assert_close(landed, torch.maximum(want, inner_o),
                               rtol=0, atol=0)
    assert bool((landed[:4] == inner_o[:4]).all())       # float32 kept
    assert not torch.equal(landed[4:][has[4:]], strict[4:][has[4:]])


# the knob sets the trainer cases run under (each with fused_bf16_max)
_TRAIN_KNOBS = {
    "bf16_landing": dict(BF16_LANDING=True),
    "all three": dict(BF16_LANDING=True, PRECOMP_LAND=True, STREAM_M=True),
}


@pytest.mark.parametrize("knobs", list(_TRAIN_KNOBS))
def test_knob_train_steps_match_jax(knobs, monkeypatch):
    """Two Trainer steps of the radius DetNet under fused_bf16_max and the
    knobs (each package's module constants patched as the env would set
    them), against the JAX Trainer: the losses as
    tests/test_torch_windowed.py holds the windowed steps (rtol 1e-4 /
    atol 1e-5 after one step, 1e-3 / 1e-4 after two)."""
    for name, value in _TRAIN_KNOBS[knobs].items():
        monkeypatch.setattr(jlayers, f"_{name}", value)
        monkeypatch.setattr(tlayers, name, value)
    kw = dict(_arch_kw("float32", True), fused_bf16_max=True)
    j_arch, t_arch = jcfg.GNNArchitectureConfig(**kw), \
        tcfg.GNNArchitectureConfig(**kw)
    js, ts = _samples("radius")
    max_nodes, max_edges = _bucket(js)
    spec = _spec(t_arch)
    bucket = dict(max_nodes=max_nodes, bg_index=5, max_edges=max_edges,
                  csr_tiling=spec)
    jb = jbatch.stack_samples(js, **bucket)
    tb = tbatch.stack_samples(ts, device="cpu", **bucket)
    j_model, variables = create_detnet_state(j_arch, jax.random.key(0), jb)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    jt = JTrainer(jcfg.TrainingConfig(**_train_kw()), j_model, variables)
    step = jax.jit(jt.train_step_fn)
    s1, l1 = step(jt.state, jb)
    _, l2 = step(s1, jb)
    model = DetNet(t_arch, device="cpu")
    model.load_state_dict(weights.from_jax_variables(variables))
    tt = Trainer(tcfg.TrainingConfig(**_train_kw()), model)
    got = [[float(v) for v in tt.train_step(tb)] for _ in range(2)]
    np.testing.assert_allclose(got[0], np.asarray(l1), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got[1], np.asarray(l2), rtol=1e-3, atol=1e-4)
    # the landing reached the forward: bf16_max alone gives other losses
    monkeypatch.setattr(tlayers, "BF16_LANDING", False)
    model = DetNet(dataclasses.replace(t_arch), device="cpu")
    model.load_state_dict(weights.from_jax_variables(variables))
    plain = [float(v) for v in Trainer(tcfg.TrainingConfig(**_train_kw()),
                                       model).train_step(tb)]
    assert plain != got[0]
