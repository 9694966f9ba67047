"""The port's Trainer (radargnn_tpu_torch.train.trainer) against the JAX
package's, on the CPU at a small size: 2 frames of 200 points, kNN k=20,
two conv layers, the 64-node-block / 16-receiver dense geometry of
tests/test_pallas.py. The JAX package's initial weights cross over through
`weights.from_jax_variables`; its Pallas kernels run in interpret mode.

Tolerances. In float32 the two differ only in summation order, and a train
step carries that through the backward and Adam: losses agree to rtol 1e-4
/ atol 1e-5 after one step and 1e-3 / 1e-4 after two (the JAX package's
own dense-vs-XLA trainer test). Adam divides each moment by its root mean
square, so a weight whose gradient is within rounding of 0 may take a
step of either sign: after two steps the parameters agree to 2·lr (atol
2e-3 at lr 1e-3) and the running statistics, which see the parameters
only through one step, to 1e-4."""

import os

import jax
import numpy as np
import pytest
from flax import serialization

from radargnn_tpu import configs as jcfg
from radargnn_tpu.data.synthetic import make_samples as j_make_samples
from radargnn_tpu.graph.batch import stack_samples as j_stack
from radargnn_tpu.models.detnet import create_detnet_state
from radargnn_tpu.train.trainer import Trainer as JTrainer
from radargnn_tpu_torch import configs as tcfg
from radargnn_tpu_torch import weights
from radargnn_tpu_torch.data.synthetic import make_samples as t_make_samples
from radargnn_tpu_torch.graph.batch import stack_samples as t_stack
from radargnn_tpu_torch.models.detnet import DetNet
from radargnn_tpu_torch.models.layers import fused_csr_tiling
from radargnn_tpu_torch.ops import dense_aggregate as da
from radargnn_tpu_torch.train.trainer import Trainer

K = 20
LR = 1e-3


def _arch_kw(fused=True, dtype="float32"):
    return dict(
        node_feature_dimension=5, edge_feature_dimension=2,
        conv_layer_dimensions=[32, 24],
        classification_head_layer_dimensions=[16, 6],
        regression_head_layer_dimensions=[8, 5],
        initial_node_feature_embedding=True,
        initial_edge_feature_embedding=True,
        node_feature_embedding_layer_dimensions=[16, 24],
        edge_feature_embedding_layer_dimensions=[4, 8],
        conv_layer_type="MPNNConv", batch_norm_in_mlps=True,
        compute_dtype=dtype, assume_sorted_edges=True,
        use_fused_aggregation=fused, fused_tiling="dense")


def _train_kw(**kw):
    return dict(dict(dataset="radarscenes", learning_rate=LR, epochs=2,
                     batch_size=2, shuffle=False, bg_index=5,
                     bb_loss_weight=0.5, regularization_strength=5e-6,
                     adapt_orientation_angle=True,
                     exponential_lr_decay_factor=0.95), **kw)


def _batches(arch, seed):
    """The same 2-frame batch from both packages' loaders."""
    spec = fused_csr_tiling(arch, k=K)
    if spec is not None:
        spec = dict(spec, node_block=64, r_tile=16, ovf_frac=0.3)
    jb = j_stack(j_make_samples(num_frames=2, num_points=200, seed=seed),
                 max_nodes=256, bg_index=5, max_edges=256 * K,
                 csr_tiling=spec)
    tb = t_stack(t_make_samples(num_frames=2, num_points=200, seed=seed),
                 max_nodes=256, bg_index=5, max_edges=256 * K,
                 csr_tiling=spec, device="cpu")
    return jb, tb


def _trainers(fused=True, dtype="float32", **train_kw):
    """A JAX Trainer and a port Trainer from the same initial weights, and
    a batch for each."""
    kw = _arch_kw(fused, dtype)
    j_arch, t_arch = jcfg.GNNArchitectureConfig(**kw), \
        tcfg.GNNArchitectureConfig(**kw)
    jb, tb = _batches(t_arch, seed=0)
    j_model, variables = create_detnet_state(j_arch, jax.random.key(0), jb)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    t_model = DetNet(t_arch, device="cpu", seed=1)
    t_model.load_state_dict(weights.from_jax_variables(variables))
    tk = _train_kw(**train_kw)
    jt = JTrainer(jcfg.TrainingConfig(**tk), j_model, variables)
    tt = Trainer(tcfg.TrainingConfig(**tk), t_model)
    return jt, tt, jb, tb, t_arch


def _assert_trees_close(got, want, **tol):
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, u), (_, v) in zip(flat_g, flat_w):
        np.testing.assert_allclose(np.asarray(u), np.asarray(v),
                                   err_msg=str(path), **tol)


@pytest.mark.parametrize("fused", [True, False])
def test_train_steps_match_jax(fused):
    """Two train steps from the same weights and batch: the losses, then
    the parameters and running statistics after step 2."""
    jt, tt, jb, tb, _ = _trainers(fused)
    step = jax.jit(jt.train_step_fn)
    s1, l1 = step(jt.state, jb)
    s2, l2 = step(s1, jb)
    launches = da.dense_bwd_cuda.launches
    g1 = [float(v) for v in tt.train_step(tb)]
    g2 = [float(v) for v in tt.train_step(tb)]
    assert da.dense_bwd_cuda.launches == launches     # CPU: plain versions
    np.testing.assert_allclose(g1, np.asarray(l1), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(g2, np.asarray(l2), rtol=1e-3, atol=1e-4)
    assert g2[0] < g1[0]
    back = weights.to_jax_variables(tt.model.state_dict())
    _assert_trees_close(back["params"], jax.device_get(s2.params),
                        rtol=0, atol=2 * LR)
    _assert_trees_close(back["batch_stats"], jax.device_get(s2.batch_stats),
                        rtol=1e-4, atol=1e-4)


def test_train_steps_match_jax_bf16():
    """compute_dtype bfloat16 (the flagship's): the linears round their
    inputs to bf16 in both packages, and a float32 summation difference can
    flip one such rounding (2^-8 relative) that the step carries on, so the
    losses agree to rtol 2e-2."""
    jt, tt, jb, tb, _ = _trainers(dtype="bfloat16")
    step = jax.jit(jt.train_step_fn)
    s1, l1 = step(jt.state, jb)
    _, l2 = step(s1, jb)
    for want in (l1, l2):
        got = [float(v) for v in tt.train_step(tb)]
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-2)


def test_eval_step_keeps_running_stat_updates_without_grad():
    """The validation quirk: train-mode BatchNorm, running statistics
    updated as the JAX eval step updates them, no gradient taken."""
    jt, tt, jb, tb, _ = _trainers()
    new_stats, want = jt._eval_step(jt.state, jb)
    got = tt.eval_step(tb)
    assert not got.requires_grad
    assert all(p.grad is None for p in tt.model.parameters())
    assert float(got) == pytest.approx(float(want), rel=1e-4, abs=1e-5)
    back = weights.to_jax_variables(tt.model.state_dict())["batch_stats"]
    _assert_trees_close(back, jax.device_get(new_stats), rtol=1e-4,
                        atol=1e-5)


def test_fit_matches_jax(tmp_path):
    """Up to four epochs on tiny train / validate loaders at a high lr with
    patience 1, where the validation loss rises at epoch 3 and early
    stopping ends the run: the same loss lists, epochs run, lr (exponential
    decay), running statistics after the validation quirk, best-validation
    epoch and result-folder files. At lr 0.05 a weight whose gradient is
    within rounding of 0 can step 0.05 either way (Adam), so the running
    statistics after three epochs agree to atol 2e-2; the losses to 2e-3."""
    jt, tt, _, _, t_arch = _trainers(epochs=4, learning_rate=0.05,
                                     early_stopping_patience=1)
    loaders = []
    for trainer_batches in zip(*(_batches(t_arch, seed) for seed in (0, 1))):
        loaders.append({"train": [trainer_batches[0]],
                        "validate": [trainer_batches[1]]})
    jt.fit(loaders[0], verbose=False)
    tt.fit(loaders[1], verbose=False)
    assert len(jt.train_loss) == len(tt.train_loss) == 3   # early stopping
    for name in ("train_loss", "train_loss_cls", "train_loss_bb",
                 "valid_loss"):
        np.testing.assert_allclose(getattr(tt, name), getattr(jt, name),
                                   rtol=2e-3, atol=1e-4, err_msg=name)
    assert tt.optimizer.param_groups[0]["lr"] == pytest.approx(
        float(jt.state.opt_state.hyperparams["learning_rate"]), rel=1e-6)
    assert tt.model_lowest_valid["epoch"] == jt.model_lowest_valid["epoch"]
    back = weights.to_jax_variables(tt.model.state_dict())["batch_stats"]
    _assert_trees_close(back, jax.device_get(jt.state.batch_stats),
                        rtol=0, atol=2e-2)
    # the files the JAX package's save_results writes (its own call would
    # fail here: its best-validation snapshot holds arrays that the
    # epoch-3 step donated)
    tt.save_results(str(tmp_path), t_arch, {"dummy": 1})
    ep = jt.model_lowest_valid["epoch"]
    assert sorted(os.listdir(tmp_path / "model_01")) == sorted([
        "gnn_configs.json", "dataset_configs.json", "trained_model.msgpack",
        f"trained_model_low_val_ep{ep}.msgpack", "loss_train.npy",
        "loss_validation.npy", "loss_train_cls.npy", "loss_train_bb.npy",
        "loss_curves.png"])
    with open(tmp_path / "model_01" / "trained_model.msgpack", "rb") as f:
        saved = serialization.msgpack_restore(f.read())
    _assert_trees_close(saved["params"], jax.device_get(jt.state.params),
                        rtol=0, atol=0.15)
    np.testing.assert_allclose(np.load(tmp_path / "model_01" /
                                       "loss_validation.npy")[0],
                               jt.valid_loss, rtol=2e-3)
    tt.save_results(str(tmp_path), t_arch, {})
    assert os.path.isdir(tmp_path / "model_02")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_resume_across_packages(tmp_path, writer):
    """One package trains an epoch and checkpoints (model, optimizer state,
    meta); the other resumes from the folder and its next epoch's loss
    matches the writer's own second epoch, with the history restored."""
    jt, tt, jb, tb, _ = _trainers(checkpoint_every_epochs=1)
    first, other = (jt, tt) if writer == "jax" else (tt, jt)
    data = {id(jt): [jb], id(tt): [tb]}
    folder = str(tmp_path / "ckpt")
    first.config.epochs = 1
    first.fit({"train": data[id(first)], "validate": data[id(first)]},
              checkpoint_dir=folder, verbose=False)
    assert sorted(os.listdir(folder)) == ["meta.json", "model.msgpack",
                                          "opt_state.msgpack"]
    # the writer's own second epoch, from the state it checkpointed
    train2 = first._train_epoch(data[id(first)])[0]
    valid2 = first._eval_epoch(data[id(first)])
    other.fit({"train": data[id(other)], "validate": data[id(other)]},
              resume_from=folder, verbose=False)
    assert len(other.train_loss) == 2
    assert other.train_loss[0] == pytest.approx(first.train_loss[0],
                                                rel=1e-7)
    np.testing.assert_allclose(other.train_loss[1], train2, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(other.valid_loss[1], valid2, rtol=1e-4,
                               atol=1e-5)
