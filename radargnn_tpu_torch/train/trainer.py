"""Trainer: train and validation steps, the epoch loop, artifacts and
checkpoints, on one device or over a mesh of ranks.

Port of `radargnn_tpu/train/trainer.py`. As there: Adam with
L2 weight decay added to the gradient before the moments, the three
learning-rate schedules, weighted cross entropy with separate validation
weights, a Huber box loss on non-background nodes, the orientation-angle
adaption, early stopping on validation-loss minima, the best-validation
snapshot, numbered `model_NN` result folders (config JSONs, loss .npy
arrays, the loss-curve PNG) and a resumable
checkpoint every `checkpoint_every_epochs` in the JAX package's files.

The reference never calls `model.eval()`, so validation runs BatchNorm in
train mode and keeps its running-statistic updates; here that step runs
under `torch.no_grad()`, as the JAX eval step takes no gradient.

PyTorch runs one step per call, so `scan_steps_per_dispatch` (the JAX
package's several steps per jitted dispatch) has nothing to select here.

With `mesh=` (`parallel.mesh.make_mesh`, one process per rank) every step
first takes the rank's part of the batch (`shard_batch`: its G/dp graphs,
and under halo partitioning its node shard and halo plan). The JAX
trainer's global arrays become explicit collectives over the ranks that
hold DISTINCT rows of the batch (the world for a halo batch; the data axis
otherwise, since the model axis then holds replicas): the BatchNorm
statistics (`models.mlp.batch_stats_over`), the losses' denominators (each
rank backpropagates its own part of the batch's loss,
`losses.detection_loss(..., group=)`) and the gradient sum before Adam; the
reported losses are the parts' sum. Every rank starts from rank 0's
weights and takes identical Adam steps. With `shard_params_over_model` and
a model axis the weights are column-parallel (`parallel.tensor`). Only
rank 0 prints. Rank 0 writes a msgpack checkpoint, from the moments
gathered to full width; under the orbax backend (RADARGNN_CKPT_BACKEND=
orbax) every rank writes its own column slices, and every rank resumes
reading its own.
"""

from __future__ import annotations

import copy
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
from radargnn_tpu_torch.models.mlp import batch_stats_over
from radargnn_tpu_torch.parallel.comm import (
    all_reduce_, all_reduce_many_, broadcast_,
)
from radargnn_tpu_torch.parallel.mesh import Mesh, shard_batch
from radargnn_tpu_torch.parallel.tensor import (
    apply_param_shardings, detnet_param_shardings,
)
from radargnn_tpu_torch.postprocess.figure import Figure
from radargnn_tpu_torch.train import checkpoint as ckpt
from radargnn_tpu_torch.train import orbax_format
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
    """GNN trainer for a DetNet on its device, or on this rank's device of
    `mesh` (module docstring). `fit(data_loaders)` runs the full training;
    `train_step` / `eval_step` take one GraphBatch (the whole batch, or
    this rank's part of it)."""

    def __init__(self, config: TrainingConfig, model: torch.nn.Module,
                 mesh: Optional[Mesh] = None):
        self.config = config
        self.model = model
        self.mesh = mesh
        device = next(model.parameters()).device
        self._tp = None
        if mesh is not None:
            # every rank starts from rank 0's weights and statistics
            with torch.no_grad():
                for t in list(model.parameters()) + list(model.buffers()):
                    broadcast_(t.data, 0, mesh.world_group)
            if mesh.size("model") > 1 \
                    and getattr(config, "shard_params_over_model", False):
                self._tp = apply_param_shardings(
                    model, mesh, detnet_param_shardings(mesh, model))

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
        self.optimizer = make_optimizer(
            self._tp.params() if self._tp is not None else model.parameters(),
            config.learning_rate, config.regularization_strength)

    @property
    def is_main(self) -> bool:
        """Whether this process prints and writes files (rank 0)."""
        return self.mesh is None or self.mesh.rank == 0

    # ------------------------------------------------------------------
    # steps
    # ------------------------------------------------------------------

    def rows_group(self, batch: GraphBatch):
        """The process group of the ranks that hold distinct rows of
        `batch` (None without a mesh): the world for a halo batch, else the
        data axis (the model axis holds replicas)."""
        if self.mesh is None:
            return None
        if batch.is_halo:
            return self.mesh.world_group
        return self.mesh.group("data")

    def _loss_terms(self, logits, bb, batch: GraphBatch, class_weights):
        cfg = self.config
        boxes = batch.boxes.reshape(-1, batch.boxes.shape[-1])
        if cfg.adapt_orientation_angle and boxes.shape[-1] == 5:
            boxes = adapt_bb_orientation_angle(boxes)
        args = (logits, bb, batch.labels.reshape(-1), boxes, class_weights,
                cfg.bg_index, cfg.cls_loss_weight, cfg.bb_loss_weight,
                batch.node_mask.reshape(-1))
        return detection_loss(*args, group=self.rows_group(batch))

    def _forward(self, batch: GraphBatch):
        self.model.train()
        with batch_stats_over(self.rows_group(batch)):
            return self.model.forward_batch(batch, self.mesh)

    def losses(self, batch: GraphBatch
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Train-mode forward (running statistics move) and the detection
        loss on `batch`: the (total, cls, bb) 0-d tensors that train_step
        differentiates, with their graph (over a mesh, this rank's part of
        the batch's loss)."""
        batch = shard_batch(batch, self.mesh)
        logits, bb = self._forward(batch)
        return self._loss_terms(logits, bb, batch, self._weights)

    def _reported(self, losses, group) -> Tuple[torch.Tensor, ...]:
        """The batch's losses from the ranks' parts (detached)."""
        out = torch.stack([v.detach().float() for v in losses])
        return tuple(all_reduce_(out, group))

    def train_step(self, batch: GraphBatch
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Train-mode forward (running statistics move), the detection
        loss, backward and one optimizer step; returns the (total, cls, bb)
        losses as 0-d tensors on the device, without waiting for them. Over
        a mesh the gradients are summed over the ranks that hold distinct
        rows before Adam, and the losses are the batch's."""
        batch = shard_batch(batch, self.mesh)
        self.optimizer.zero_grad(set_to_none=True)
        if self._tp is not None:
            for p in self.model.parameters():
                p.grad = None
        losses = self.losses(batch)
        losses[0].backward()
        if self.mesh is None:
            self.optimizer.step()
            return tuple(v.detach() for v in losses)
        group = self.rows_group(batch)
        all_reduce_many_([p.grad for p in self.model.parameters()], group)
        if self._tp is not None:
            self._tp.shard_grads()
        self.optimizer.step()
        if self._tp is not None:
            self._tp.gather()
        return self._reported(losses, group)

    @torch.no_grad()
    def eval_step(self, batch: GraphBatch) -> torch.Tensor:
        """The validation loss of one batch. Reference quirk: BatchNorm runs
        in train mode and keeps its running-statistic updates."""
        batch = shard_batch(batch, self.mesh)
        logits, bb = self._forward(batch)
        total = self._loss_terms(logits, bb, batch, self._val_weights)[0]
        if self.mesh is None:
            return total
        return self._reported((total,), self.rows_group(batch))[0]

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

        verbose = verbose and self.is_main
        if resume_from:
            meta = self.resume(resume_from)
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
                self.barrier()

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

    def barrier(self) -> None:
        """Waits for every rank of the mesh (no-op without one)."""
        if self.mesh is not None and self.mesh.world_group is not None:
            torch.distributed.barrier(self.mesh.world_group)

    def _full_optimizer(self, gather: bool = True) -> torch.optim.Optimizer:
        """The optimizer over the model's own parameters: under column
        parallelism a copy of its state with the moments all-gathered to
        full width (with `gather` False, this rank's rows of them), else
        the optimizer itself."""
        if self._tp is None:
            return self.optimizer
        full = make_optimizer(self.model.parameters(), 0.0, 0.0)
        full.load_state_dict(dict(self.optimizer.state_dict(), state={}))
        names = dict(self.model.named_parameters())
        for name, p in names.items():
            leaf = self._tp.shards.get(name, p)
            st = self.optimizer.state.get(leaf)
            if st:
                full.state[p] = {"step": st["step"].clone(), **{
                    key: self._tp.full_moments(self.optimizer, name, key,
                                               gather)
                    for key in ("exp_avg", "exp_avg_sq")}}
        return full

    def _pieces(self):
        """{path in the checkpoint tree: (the weight's path, dimension,
        index, parts)} of this rank's column slice of every column-parallel
        leaf: the weights and their Adam moments (none without column
        parallelism)."""
        if self._tp is None:
            return {}
        pieces = {}
        for name in self._tp.shards:
            path, *where = self._tp.piece(name)
            weight = ("params",) + path
            pieces[weight] = (weight, *where)
            for moment in ("mu", "nu"):
                pieces[("opt_state", "inner_state", "1", moment) + path] = \
                    (weight, *where)
        return pieces

    def _moment_rows(self, path, shape):
        """`load_train_state`'s `select`: this rank's slice of a
        column-parallel Adam moment, None for every other leaf (the
        weights are read whole: each rank holds them in full)."""
        if path[0] != "opt_state":
            return None
        where = self._pieces().get(tuple(path))
        if where is None:
            return None
        _, dim, index, parts = where
        return orbax_format.part_region(shape, dim, index, parts)

    def resume(self, folder: str) -> Dict:
        """Loads a checkpoint folder (either backend, either package's):
        every rank reads the full weights and its own rows of the
        column-parallel moments. Returns its meta (epoch, losses, lr)."""
        model_vars, opt_sd, meta = ckpt.load_train_state(folder,
                                                         self._moment_rows)
        self.model.load_state_dict(weights.from_jax_variables(model_vars))
        self._load_optimizer_state(opt_sd)
        return meta

    def _load_optimizer_state(self, opt_sd) -> None:
        if self._tp is None:
            weights.optimizer_state_from_jax(opt_sd, self.optimizer,
                                             self.model)
            return
        # the column-parallel moments are this rank's rows already
        # (`_moment_rows`)
        full = make_optimizer(self.model.parameters(), 0.0, 0.0)
        weights.optimizer_state_from_jax(opt_sd, full, self.model)
        for group in self.optimizer.param_groups:
            group["lr"] = full.param_groups[0]["lr"]
            group["weight_decay"] = full.param_groups[0]["weight_decay"]
        self._tp.load_moments(self.optimizer, {
            name: full.state[p] for name, p in self.model.named_parameters()
            if p in full.state})
        self._tp.load_shards()

    def _variables(self, state_dict=None) -> Dict:
        """Flax {'params', 'batch_stats'} trees of the model's state."""
        return weights.to_jax_variables(
            self.model.state_dict() if state_dict is None else state_dict)

    def _checkpoint(self, folder: str, epoch: int, lr: float) -> None:
        """The resumable checkpoint. msgpack: written by rank 0 (every rank
        takes part in gathering column-parallel moments). orbax: every
        rank writes its own column slices (`_pieces`) and rank 0 the rest,
        with nothing gathered."""
        orbax = ckpt.backend_name() == "orbax"
        full = self._full_optimizer(gather=not orbax)
        if not (orbax or self.is_main):
            return
        variables = self._variables()
        tree = {"params": variables["params"],
                "opt_state": weights.optimizer_state_to_jax(full,
                                                            self.model)}
        mesh_kw = {}
        if orbax and self.mesh is not None:
            writer = self.mesh.coord("data") == 0

            def node_of(path):
                node = tree
                for key in path[:-1]:
                    node = node[key]
                return node

            pieces = self._pieces()
            for path, (weight, dim, index, parts) in pieces.items():
                node = node_of(path)
                local = node[path[-1]]
                # the weight's full shape (an array, or its Piece by now)
                shape = tuple(node_of(weight)[weight[-1]].shape)
                piece = orbax_format.Piece(local, shape, dim, index, parts,
                                           "model", writer)
                # the weights (and a moment not yet stepped) are whole here
                if local.shape == shape:
                    piece.data = local[piece.region()]
                node[path[-1]] = piece
            mesh_kw = dict(process=self.mesh.rank, barrier=self.barrier,
                           mesh_axes=self.mesh.axes)
        ckpt.save_train_state(
            folder, params=tree["params"],
            batch_stats=variables["batch_stats"],
            opt_state=tree["opt_state"], epoch=epoch,
            losses={"train": self.train_loss, "train_cls": self.train_loss_cls,
                    "train_bb": self.train_loss_bb, "valid": self.valid_loss},
            scheduler_lr=lr, **mesh_kw)

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

        fig, _ = self.show_learning_curves()
        fig.savefig(f"{folder_path}/loss_curves.png")

    def show_learning_curves(self):
        """The loss curves as the JAX package plots them, drawn by the
        port's own figure code: (figure, axes)."""
        fig = Figure()
        ax = fig.ax
        ax.plot(range(len(self.train_loss)), self.train_loss)
        ax.plot(range(len(self.valid_loss)), self.valid_loss)
        ax.plot(range(len(self.train_loss_cls)), self.train_loss_cls)
        ax.plot(range(len(self.train_loss_bb)), self.train_loss_bb)
        ax.legend(["Training loss", "Validation loss",
                   "Training loss classification",
                   "Training loss bounding box"])
        ax.set_title("Training and validation loss")
        ax.grid()
        ax.set_xlabel("epoch")
        ax.set_ylabel("loss")
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
