"""Trainer: train and validation steps, the epoch loop, artifacts and
checkpoints, on one device.

Port of `radargnn_tpu/train/trainer.py` (single device; the sharded batch
and the halo paths wait for ROADMAP.md §A, multi-GPU). As there: Adam with
L2 weight decay added to the gradient before the moments, the three
learning-rate schedules, weighted cross entropy with separate validation
weights, a Huber box loss on non-background nodes, the orientation-angle
adaption, early stopping on validation-loss minima, the best-validation
snapshot, numbered `model_NN` result folders (config JSONs, loss .npy
arrays, the loss-curve PNG where matplotlib imports) and a resumable
checkpoint every `checkpoint_every_epochs` in the JAX package's files.

The reference never calls `model.eval()`, so validation runs BatchNorm in
train mode and keeps its running-statistic updates; here that step runs
under `torch.no_grad()`, as the JAX eval step takes no gradient.

PyTorch runs one step per call, so `scan_steps_per_dispatch` (the JAX
package's several steps per jitted dispatch) has nothing to select here.
"""

from __future__ import annotations

import copy
import importlib.util
import json
import os
import time
from dataclasses import asdict
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from radargnn_tpu_torch import weights
from radargnn_tpu_torch.configs import GNNArchitectureConfig, TrainingConfig
from radargnn_tpu_torch.graph.batch import GraphBatch
from radargnn_tpu_torch.train import checkpoint as ckpt
from radargnn_tpu_torch.train.losses import (
    adapt_bb_orientation_angle, detection_loss,
)
from radargnn_tpu_torch.train.schedules import make_scheduler
from radargnn_tpu_torch.utils.profiling import StepStats
from radargnn_tpu_torch.utils.properties import ClassDistribution

# cuBLAS reads it when it creates its first handle; deterministic mode
# refuses cuBLAS calls without it
_CUBLAS_DETERMINISTIC = ":4096:8"


def set_seeds(seed: int, deterministic: bool = False) -> torch.Generator:
    """Seeds numpy and torch and returns a torch.Generator of `seed`.

    With `deterministic` (the flagship YAML's setting; the reference sets
    cudnn-deterministic) it also calls
    `torch.use_deterministic_algorithms(True)`: every op on the path must
    then have a deterministic implementation on the card, or raise. Call
    it before anything touches the card, so that cuBLAS sees its workspace
    setting."""
    np.random.seed(seed)
    torch.manual_seed(seed)
    if deterministic:
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG",
                              _CUBLAS_DETERMINISTIC)
        torch.use_deterministic_algorithms(True)
    return torch.Generator().manual_seed(seed)


def make_optimizer(params: Iterable[torch.nn.Parameter], learning_rate: float,
                   weight_decay: float) -> torch.optim.Adam:
    """The JAX package's `_adam_chain`: L2 added to the gradient before the
    Adam moments (b1 0.9, b2 0.999, eps 1e-8), which is torch's Adam with
    `weight_decay`."""
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=weight_decay)


class Trainer:
    """GNN trainer for a DetNet on its device. `fit(data_loaders)` runs the
    full training; `train_step` / `eval_step` take one GraphBatch."""

    def __init__(self, config: TrainingConfig, model: torch.nn.Module):
        self.config = config
        self.model = model
        device = next(model.parameters()).device

        self.train_loss = []
        self.train_loss_cls = []
        self.train_loss_bb = []
        self.valid_loss = []
        self.model_lowest_valid: dict = {}

        if config.set_weights_according_radar_scenes_distribution:
            w = list(ClassDistribution.get_class_weights().values())
            vw = w
        else:
            w = list(config.class_weights.values())
            vw = list(config.val_class_weights.values())
        self._weights = torch.tensor(w, dtype=torch.float32, device=device)
        self._val_weights = torch.tensor(vw, dtype=torch.float32,
                                         device=device)
        self.optimizer = make_optimizer(model.parameters(),
                                        config.learning_rate,
                                        config.regularization_strength)

    # ------------------------------------------------------------------
    # steps
    # ------------------------------------------------------------------

    def _loss_terms(self, logits, bb, batch: GraphBatch, class_weights):
        cfg = self.config
        boxes = batch.boxes.reshape(-1, batch.boxes.shape[-1])
        if cfg.adapt_orientation_angle and boxes.shape[-1] == 5:
            boxes = adapt_bb_orientation_angle(boxes)
        return detection_loss(
            logits, bb, batch.labels.reshape(-1), boxes, class_weights,
            cfg.bg_index, cfg.cls_loss_weight, cfg.bb_loss_weight,
            batch.node_mask.reshape(-1))

    def losses(self, batch: GraphBatch
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Train-mode forward (running statistics move) and the detection
        loss on `batch`: the (total, cls, bb) 0-d tensors that train_step
        differentiates, with their graph."""
        self.model.train()
        logits, bb = self.model.forward_batch(batch)
        return self._loss_terms(logits, bb, batch, self._weights)

    def train_step(self, batch: GraphBatch
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Train-mode forward (running statistics move), the detection
        loss, backward and one optimizer step; returns the (total, cls, bb)
        losses as 0-d tensors on the device, without waiting for them."""
        self.optimizer.zero_grad(set_to_none=True)
        total, l_cls, l_bb = self.losses(batch)
        total.backward()
        self.optimizer.step()
        return total.detach(), l_cls.detach(), l_bb.detach()

    @torch.no_grad()
    def eval_step(self, batch: GraphBatch) -> torch.Tensor:
        """The validation loss of one batch. Reference quirk: BatchNorm runs
        in train mode and keeps its running-statistic updates."""
        self.model.train()
        logits, bb = self.model.forward_batch(batch)
        total, _, _ = self._loss_terms(logits, bb, batch, self._val_weights)
        return total

    def _set_lr(self, lr: float) -> None:
        for group in self.optimizer.param_groups:
            group["lr"] = lr

    # ------------------------------------------------------------------
    # epoch loop
    # ------------------------------------------------------------------

    def fit(self, data_loaders: Dict[str, Iterable[GraphBatch]],
            resume_from: Optional[str] = None,
            checkpoint_dir: Optional[str] = None,
            verbose: bool = True) -> None:
        cfg = self.config
        scheduler = make_scheduler(cfg)
        start_epoch = 1

        if resume_from:
            model_vars, opt_sd, meta = ckpt.load_train_state(resume_from)
            self.model.load_state_dict(weights.from_jax_variables(model_vars))
            weights.optimizer_state_from_jax(opt_sd, self.optimizer,
                                             self.model)
            scheduler.lr = meta["scheduler_lr"]
            start_epoch = meta["epoch"] + 1
            for name, dest in (("train", self.train_loss),
                               ("train_cls", self.train_loss_cls),
                               ("train_bb", self.train_loss_bb),
                               ("valid", self.valid_loss)):
                dest.extend(meta["losses"].get(name, []))

        start_time = time.time()
        early_stopping_triggers = 0

        for epoch in range(start_epoch, cfg.epochs + 1):
            loss_train, loss_cls, loss_bb = self._train_epoch(
                data_loaders["train"], verbose)
            loss_valid = self._eval_epoch(data_loaders["validate"])

            self.train_loss.append(loss_train)
            self.train_loss_cls.append(loss_cls)
            self.train_loss_bb.append(loss_bb)
            self.valid_loss.append(loss_valid)

            self._set_lr(scheduler.step(loss_valid))

            if loss_valid <= min(self.valid_loss):
                # the parameters change in place: keep a copy
                self.model_lowest_valid = {
                    "state_dict": copy.deepcopy(self.model.state_dict()),
                    "epoch": epoch}

            if verbose:
                print(f">>> Epoch: {epoch}/{cfg.epochs}, "
                      f"loss_train: {round(loss_train, 5)}, "
                      f"loss_valid: {round(loss_valid, 5)}")

            if checkpoint_dir and cfg.checkpoint_every_epochs and \
                    epoch % cfg.checkpoint_every_epochs == 0:
                self._checkpoint(checkpoint_dir, epoch, scheduler.lr)

            if loss_valid > min(self.valid_loss):
                early_stopping_triggers += 1
                if verbose:
                    print("Trigger Times:", early_stopping_triggers)
                if early_stopping_triggers >= cfg.early_stopping_patience:
                    if verbose:
                        print("Early stopping!")
                    break
            else:
                early_stopping_triggers = 0

        if verbose:
            hours = (time.time() - start_time) / 3600
            print(f">>> Overall training duration: {round(hours, 2)} hours")

    def _train_epoch(self, loader: Iterable[GraphBatch], verbose=False):
        stats = StepStats()
        sums = np.zeros(3)
        n = 0
        for batch in loader:
            t0 = time.time()
            losses = self.train_step(batch)
            sums += [float(v) for v in losses]       # waits for the step
            stats.record(time.time() - t0, batch.host_valid_edges)
            n += 1
        self.last_epoch_stats = stats
        if verbose:
            s = stats.summary()
            print(f">>> epoch throughput: {s['edges_per_s']:.0f} edges/s "
                  f"over {n} batches")
        return tuple(sums / max(n, 1))

    def _eval_epoch(self, loader: Iterable[GraphBatch]) -> float:
        total = 0.0
        n = 0
        for batch in loader:
            total += float(self.eval_step(batch))
            n += 1
        return total / max(n, 1)

    def _variables(self, state_dict=None) -> Dict:
        """Flax {'params', 'batch_stats'} trees of the model's state."""
        return weights.to_jax_variables(
            self.model.state_dict() if state_dict is None else state_dict)

    def _checkpoint(self, folder: str, epoch: int, lr: float) -> None:
        variables = self._variables()
        ckpt.save_train_state(
            folder, params=variables["params"],
            batch_stats=variables["batch_stats"],
            opt_state=weights.optimizer_state_to_jax(self.optimizer,
                                                     self.model),
            epoch=epoch,
            losses={"train": self.train_loss, "train_cls": self.train_loss_cls,
                    "train_bb": self.train_loss_bb, "valid": self.valid_loss},
            scheduler_lr=lr)

    # ------------------------------------------------------------------
    # artifacts
    # ------------------------------------------------------------------

    def save_results(self, path: str, model_config: GNNArchitectureConfig,
                     dataset_config_dict: dict) -> None:
        folder_path = get_new_result_folder_path(path)
        os.makedirs(folder_path)

        json_dict = {"GNN_ARCHITECTURE_CONFIG": asdict(model_config),
                     "TRAINING_CONFIG": asdict(self.config)}
        with open(f"{folder_path}/gnn_configs.json", "w") as f:
            json.dump(json_dict, f, indent=4)
        with open(f"{folder_path}/dataset_configs.json", "w") as f:
            json.dump(dataset_config_dict, f, indent=4)

        ckpt.save_variables(f"{folder_path}/trained_model.msgpack",
                            self._variables())
        if self.model_lowest_valid:
            ep = self.model_lowest_valid["epoch"]
            ckpt.save_variables(
                f"{folder_path}/trained_model_low_val_ep{ep}.msgpack",
                self._variables(self.model_lowest_valid["state_dict"]))

        for name, data in (("loss_train", self.train_loss),
                           ("loss_validation", self.valid_loss),
                           ("loss_train_cls", self.train_loss_cls),
                           ("loss_train_bb", self.train_loss_bb)):
            with open(f"{folder_path}/{name}.npy", "wb") as f:
                np.save(f, np.array([data]))

        if importlib.util.find_spec("matplotlib") is None:
            print(f"{folder_path}/loss_curves.png not drawn: matplotlib is "
                  "not installed (the losses are in the loss_*.npy files)")
        else:
            fig, _ = self.show_learning_curves()
            fig.savefig(f"{folder_path}/loss_curves.png")

    def show_learning_curves(self):
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots()
        ax.plot(range(len(self.train_loss)), self.train_loss)
        ax.plot(range(len(self.valid_loss)), self.valid_loss)
        ax.plot(range(len(self.train_loss_cls)), self.train_loss_cls)
        ax.plot(range(len(self.train_loss_bb)), self.train_loss_bb)
        plt.legend(["Training loss", "Validation loss",
                    "Training loss classification", "Training loss bounding box"])
        plt.title("Training and validation loss")
        ax.grid("minor")
        plt.xlabel("epoch")
        plt.ylabel("loss")
        return fig, ax


def get_new_result_folder_path(path: str) -> str:
    """Numbered model_NN folders, one past the highest number there."""
    import glob

    folders = glob.glob(path + "/*/")
    if len(folders) == 0:
        folder_name = "model_01"
    else:
        numbers = []
        for folder in folders:
            number = 0
            i = 2
            while True:
                try:
                    number = int(folder[-i:-1])
                    i += 1
                except ValueError:
                    break
            numbers.append(number)
        next_number = max(numbers) + 1
        folder_name = f"model_{next_number:02d}"
    return f"{path}/{folder_name}"
