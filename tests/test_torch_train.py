"""The port's training pieces (radargnn_tpu_torch.train: losses, schedules,
checkpoints; the optimizer and its state bridge in weights.py) against the
JAX package's, on the CPU. Inputs come from numpy seeds; float32 on both
sides, so values agree to float32 rounding."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from radargnn_tpu.train import checkpoint as jck
from radargnn_tpu.train import losses as jl
from radargnn_tpu.train import schedules as js
from radargnn_tpu.train.trainer import _make_optimizer
from radargnn_tpu_torch import configs as tcfg
from radargnn_tpu_torch import weights
from radargnn_tpu_torch.train import checkpoint as tck
from radargnn_tpu_torch.train import losses as tl
from radargnn_tpu_torch.train import schedules as ts
from radargnn_tpu_torch.train.trainer import make_optimizer, set_seeds
from radargnn_tpu_torch.utils.profiling import StepStats
from radargnn_tpu_torch.utils.properties import ClassDistribution


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("masked", [False, True])
def test_weighted_cross_entropy_matches_jax(masked):
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(40, 6)).astype(np.float32) * 3
    labels = rng.integers(0, 6, 40).astype(np.int32)
    w = np.array([1, 2, 1, 0.5, 1, 0.05], np.float32)
    mask = rng.random(40) < 0.7 if masked else None
    want = jl.weighted_cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(w),
        None if mask is None else jnp.asarray(mask))
    got = tl.weighted_cross_entropy(_t(logits), _t(labels), _t(w),
                                    None if mask is None else _t(mask))
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    if not masked:     # and torch's own weighted CrossEntropyLoss
        ce = torch.nn.CrossEntropyLoss(weight=_t(w))(_t(logits),
                                                     _t(labels).long())
        assert float(got) == pytest.approx(float(ce), rel=1e-6)


@pytest.mark.parametrize("case", ["nan_boxes", "all_background", "masked"])
def test_masked_huber_matches_jax(case):
    rng = np.random.default_rng(2)
    n, bg = 30, 5
    pred = rng.normal(size=(n, 5)).astype(np.float32)
    true = (rng.normal(size=(n, 5)) * 2).astype(np.float32)
    labels = rng.integers(0, 6, n).astype(np.int32)
    if case == "all_background":
        labels[:] = bg
    true[labels == bg] = np.nan
    true[3, 2] = np.nan                     # a NaN box on a foreground node
    labels[3] = 0
    mask = rng.random(n) < 0.6 if case == "masked" else None
    want = jl.masked_huber_box_loss(
        jnp.asarray(pred), jnp.asarray(true), jnp.asarray(labels), bg,
        None if mask is None else jnp.asarray(mask))
    got = tl.masked_huber_box_loss(_t(pred), _t(true), _t(labels), bg,
                                   None if mask is None else _t(mask))
    assert float(got) == pytest.approx(float(want), rel=1e-6, abs=1e-7)
    # the NaN boxes pass no NaN into the gradient
    p = _t(pred).requires_grad_(True)
    tl.masked_huber_box_loss(p, _t(true), _t(labels), bg).backward()
    assert torch.isfinite(p.grad).all()


def test_detection_loss_matches_jax():
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(20, 6)).astype(np.float32)
    pred = rng.normal(size=(20, 5)).astype(np.float32)
    true = rng.normal(size=(20, 5)).astype(np.float32)
    labels = rng.integers(0, 6, 20).astype(np.int32)
    w = np.ones(6, np.float32)
    mask = rng.random(20) < 0.8
    want = jl.detection_loss(*map(jnp.asarray, (logits, pred, labels, true,
                                                w)), 5, 1.0, 0.5,
                             jnp.asarray(mask))
    got = tl.detection_loss(*map(_t, (logits, pred, labels, true, w)), 5,
                            1.0, 0.5, _t(mask))
    for u, v in zip(got, want):
        assert float(u) == pytest.approx(float(v), rel=1e-6)


def test_orientation_adaption_and_inverse_match_jax():
    rng = np.random.default_rng(5)
    boxes = rng.normal(size=(60, 5)).astype(np.float32)
    boxes[:, 4] = np.linspace(0, np.pi - 1e-6, 60)
    boxes[7] = np.nan
    want = np.asarray(jl.adapt_bb_orientation_angle(jnp.asarray(boxes)))
    got = tl.adapt_bb_orientation_angle(_t(boxes)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert np.isnan(got[7]).all()
    theta = np.concatenate([got[:7, 4], got[8:, 4], [1.5, -1.5]])
    np.testing.assert_allclose(
        tl.invert_bb_orientation_angle_adaption(_t(theta)).numpy(),
        np.asarray(jl.invert_bb_orientation_angle_adaption(
            jnp.asarray(theta))), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kw", [
    dict(reduce_lr_on_plateau_patience=1, reduce_lr_on_plateau_factor=0.5),
    dict(exponential_lr_decay_factor=0.95),
    dict(),
])
def test_schedules_step_like_jax(kw):
    """The same validation-loss sequence steps both packages' schedulers,
    chosen by make_scheduler from the same config."""
    cfg = tcfg.TrainingConfig(dataset="radarscenes", learning_rate=1e-3,
                              epochs=8, batch_size=1, shuffle=False,
                              bg_index=5, **kw)
    got, want = ts.make_scheduler(cfg), js.make_scheduler(cfg)
    assert type(got).__name__ == type(want).__name__
    for loss in (1.0, 0.9, 0.95, 0.97, 0.99, 0.5, 0.51, 0.52):
        assert got.step(loss) == want.step(loss)
        assert got.lr == want.lr


def test_class_weights_and_step_stats_match_jax():
    from radargnn_tpu.utils.profiling import StepStats as JStepStats
    from radargnn_tpu.utils.properties import ClassDistribution as JCD

    assert ClassDistribution.get_class_weights() == JCD.get_class_weights()
    got, want = StepStats(), JStepStats()
    for dt, e in ((1.0, 10), (0.5, 20), (0.25, 30)):
        got.record(dt, e)
        want.record(dt, e)
    assert got.summary() == want.summary()


def _params_and_grads(seed):
    rng = np.random.default_rng(seed)
    return ({"w": rng.normal(size=(3, 4)).astype(np.float32),
             "b": rng.normal(size=(4,)).astype(np.float32)},
            [{"w": rng.normal(size=(3, 4)).astype(np.float32),
              "b": rng.normal(size=(4,)).astype(np.float32)}
             for _ in range(3)])


def test_adam_l2_matches_the_jax_chain():
    """Three steps of the port's optimizer against `_adam_chain` (L2 added
    to the gradient before the moments), on the same parameters and
    gradients: within 1e-6."""
    p0, grads = _params_and_grads(1)
    tx = _make_optimizer(1e-2, 1e-3)
    params = jax.tree.map(jnp.asarray, p0)
    state = tx.init(params)
    for g in grads:
        updates, state = tx.update(jax.tree.map(jnp.asarray, g), state,
                                   params)
        params = optax.apply_updates(params, updates)
    tp = {k: torch.nn.Parameter(_t(v).clone()) for k, v in p0.items()}
    opt = make_optimizer(tp.values(), 1e-2, 1e-3)
    for g in grads:
        opt.zero_grad()
        for k, v in tp.items():
            v.grad = _t(g[k]).clone()
        opt.step()
    for k in p0:
        np.testing.assert_allclose(tp[k].detach().numpy(),
                                   np.asarray(params[k]), rtol=1e-6,
                                   atol=1e-6)


class _TinyModel(torch.nn.Module):
    """Two layers named as the port's modules are (lin_0 / bn_0)."""

    def __init__(self):
        super().__init__()
        from radargnn_tpu_torch.models.mlp import MaskedBatchNorm, TorchLinear

        gen = torch.Generator().manual_seed(0)
        self.lin_0 = TorchLinear(3, 4, generator=gen)
        self.bn_0 = MaskedBatchNorm(4)


def test_optimizer_state_crosses_both_ways():
    """After two steps the torch Adam's state, in the optax layout, matches
    the JAX chain's state dict (same tree, counts, moments within 1e-6),
    flax restores it into the JAX chain's state, and it loads back into a
    fresh torch Adam with the same state."""
    model = _TinyModel()
    opt = make_optimizer(model.parameters(), 1e-2, 1e-3)
    rng = np.random.default_rng(3)
    grads = [{n: rng.normal(size=p.shape).astype(np.float32)
              for n, p in model.named_parameters()} for _ in range(2)]
    for g in grads:
        opt.zero_grad()
        for n, p in model.named_parameters():
            p.grad = _t(g[n])
        opt.step()
    got = weights.optimizer_state_to_jax(opt, model)

    # the JAX chain from the same initial parameters, same gradients
    init = {n: p.detach().clone() for n, p in _TinyModel().named_parameters()}
    params = jax.tree.map(jnp.asarray, weights.to_jax_variables(init)["params"])
    tx = _make_optimizer(1e-2, 1e-3)
    state = tx.init(params)
    for g in grads:
        jg = weights.to_jax_variables({n: _t(v) for n, v in g.items()})
        updates, state = tx.update(jax.tree.map(jnp.asarray, jg["params"]),
                                   state, params)
        params = optax.apply_updates(params, updates)
    want = jax.device_get(serialization.to_state_dict(state))
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, u), (_, v) in zip(flat_g, flat_w):
        assert np.asarray(u).dtype == np.asarray(v).dtype, path
        np.testing.assert_allclose(u, v, rtol=1e-6, atol=1e-7,
                                   err_msg=str(path))
    restored = serialization.from_state_dict(state, got)
    assert int(restored.count) == 2

    fresh = _TinyModel()
    opt2 = make_optimizer(fresh.parameters(), 5.0, 0.0)
    weights.optimizer_state_from_jax(got, opt2, fresh)
    assert opt2.param_groups[0]["lr"] == pytest.approx(1e-2)
    assert opt2.param_groups[0]["weight_decay"] == pytest.approx(1e-3)
    names = dict(fresh.named_parameters())
    for n, p in model.named_parameters():
        a, b = opt.state[p], opt2.state[names[n]]
        assert float(a["step"]) == float(b["step"]) == 2.0
        torch.testing.assert_close(a["exp_avg"], b["exp_avg"])
        torch.testing.assert_close(a["exp_avg_sq"], b["exp_avg_sq"])


def test_checkpoint_files_read_by_flax(tmp_path):
    """What the port writes, flax's msgpack_restore reads to the same trees;
    what flax writes, the port reads back."""
    rng = np.random.default_rng(6)
    tree = {"params": {"conv_0": {"lin_0": {
        "kernel": rng.normal(size=(3, 4)).astype(np.float32),
        "bias": rng.normal(size=(4,)).astype(np.float32)}}},
        "batch_stats": {"bn_0": {"mean": np.zeros(4, np.float32),
                                 "var": np.ones(4, np.float32)}}}
    opt = {"count": np.asarray(3, np.int32),
           "hyperparams": {"learning_rate": np.asarray(1e-3, np.float32)},
           "hyperparams_states": {}, "inner_state": {"0": {}}}
    folder = str(tmp_path / "ckpt")
    tck.save_train_state(folder, params=tree["params"],
                         batch_stats=tree["batch_stats"], opt_state=opt,
                         epoch=4, losses={"train": [1.0, 0.5]},
                         scheduler_lr=1e-3)
    assert sorted(os.listdir(folder)) == ["meta.json", "model.msgpack",
                                          "opt_state.msgpack"]
    for name, want in (("model.msgpack", tree), ("opt_state.msgpack", opt)):
        with open(os.path.join(folder, name), "rb") as f:
            raw = f.read()
        assert raw == serialization.msgpack_serialize(want)   # same bytes
        got = serialization.msgpack_restore(raw)
        jax.tree.map(np.testing.assert_array_equal, got, want)
    model, opt_sd, meta = jck.load_train_state(folder)
    assert meta["epoch"] == 4 and meta["losses"]["train"] == [1.0, 0.5]
    jax.tree.map(np.testing.assert_array_equal, model, tree)
    # and back: flax's bytes through the port's reader
    path = str(tmp_path / "v.msgpack")
    jck.save_variables(path, tree)
    jax.tree.map(np.testing.assert_array_equal, tck.load_variables(path),
                 tree)
    with open(os.path.join(folder, "meta.json")) as f:
        assert json.load(f)["scheduler_lr"] == 1e-3


def test_set_seeds_switches_deterministic_algorithms_on():
    before = torch.are_deterministic_algorithms_enabled()
    try:
        gen = set_seeds(123, deterministic=True)
        assert torch.are_deterministic_algorithms_enabled()
        assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"
        a = torch.rand(3, generator=gen)
        assert torch.equal(a, torch.rand(3, generator=set_seeds(123)))
        assert np.random.randint(1 << 30) == np.random.RandomState(
            123).randint(1 << 30)
    finally:
        torch.use_deterministic_algorithms(before)
