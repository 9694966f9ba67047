"""Column-parallel weights over the mesh `model` axis, and the pipeline
stage hook.

Port of `radargnn_tpu/parallel/tensor.py`. The reference's widest MLP is
464 wide, far below where tensor parallelism pays; these are capability
hooks, as there:

  * `detnet_param_shardings` — the column-parallel plan: every 2-D weight
    whose output width splits over the axis into pieces of at least
    `min_width` shards its output dimension (the JAX package's P(None,
    "model") of a flax kernel [in, out] is dim 0 of a torch weight [out,
    in]), and so does every 1-D parameter named `bias` (Linear and
    BatchNorm biases, as the JAX rule keys on the leaf name); the rest
    replicates.
  * `ColumnParallel` (`apply_param_shardings`) — each rank of the axis
    keeps only its column shard of a sharded parameter as the optimizer's
    leaf, with its Adam moments. Before use the shards are all-gathered
    into the module's full weight (outside autograd); after the backward
    the rank keeps its slice of the full gradient, which the trainer has
    already summed over the ranks that hold distinct rows. So the
    gradients of the model axis's identical replicas are never summed
    (an autograd all_gather, whose backward is a reduce-scatter, would
    multiply them by mp), and the training is the replicated one.
  * `pipeline_stage_assignment` — the contiguous layer → stage split, as
    is.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from radargnn_tpu_torch.parallel.comm import all_gather_cat
from radargnn_tpu_torch.parallel.mesh import Mesh


def detnet_param_shardings(mesh: Mesh, model: nn.Module,
                           axis: str = "model",
                           min_width: int = 2) -> Dict[str, Optional[int]]:
    """{parameter name: the dimension it shards over `axis` (0), or None
    where it replicates} (module docstring)."""
    size = mesh.size(axis)

    def shard_dim(name: str, p: torch.Tensor) -> Optional[int]:
        out = p.shape[0]
        if (p.ndim == 2 or (p.ndim == 1 and name.split(".")[-1] == "bias")) \
                and out % size == 0 and out // size >= min_width:
            return 0
        return None

    return {name: shard_dim(name, p)
            for name, p in model.named_parameters()}


class ColumnParallel:
    """A model's parameters under a column-parallel plan on this rank
    (module docstring). `params()` are the optimizer's leaves: the rank's
    shards of the sharded parameters, then the replicated parameters."""

    def __init__(self, model: nn.Module, mesh: Mesh,
                 plan: Dict[str, Optional[int]], axis: str = "model"):
        self.model = model
        self.group = mesh.group(axis)
        self.size, self.coord = mesh.size(axis), mesh.coord(axis)
        self.full: Dict[str, nn.Parameter] = dict(model.named_parameters())
        self.shards: Dict[str, nn.Parameter] = {}
        for name, dim in plan.items():
            if dim is not None:
                p = self.full[name]
                self.shards[name] = nn.Parameter(
                    p.detach()[self._rows(p)].clone())

    def _rows(self, p: torch.Tensor) -> slice:
        n = p.shape[0] // self.size
        return slice(self.coord * n, (self.coord + 1) * n)

    def params(self) -> List[nn.Parameter]:
        return list(self.shards.values()) + [
            p for name, p in self.full.items() if name not in self.shards]

    @torch.no_grad()
    def gather(self) -> None:
        """The full weights from the axis's shards (all_gather)."""
        for name, s in self.shards.items():
            self.full[name].copy_(all_gather_cat(s.detach(), self.group))

    @torch.no_grad()
    def load_shards(self) -> None:
        """Each shard from its rows of the module's full weight (after the
        module's weights were loaded)."""
        for name, s in self.shards.items():
            s.copy_(self.full[name][self._rows(self.full[name])])

    @torch.no_grad()
    def shard_grads(self) -> None:
        """Each shard's gradient: its rows of the full weight's."""
        for name, s in self.shards.items():
            g = self.full[name].grad
            s.grad = None if g is None else g[self._rows(g)].clone()

    @torch.no_grad()
    def full_moments(self, optimizer: torch.optim.Optimizer,
                     name: str, key: str,
                     gather: bool = True) -> Optional[torch.Tensor]:
        """The full-width Adam moment `key` of parameter `name`, all-gathered
        from the axis's shards (the replicated ones as they are); with
        `gather` False a sharded parameter's is this rank's rows."""
        leaf = self.shards.get(name, self.full[name])
        state = optimizer.state.get(leaf, {})
        if key not in state:
            return None
        if name in self.shards and gather:
            return all_gather_cat(state[key], self.group)
        return state[key]

    def piece(self, name: str):
        """Where this rank's shard of sharded parameter `name` lies in the
        flax leaf (the JAX package's layout): (the leaf's path under the
        params tree, the dimension the shard splits (a kernel's columns, a
        bias's entries), its index, the number of shards)."""
        *mods, _ = name.split(".")
        p = self.full[name]
        leaf, dim = ("kernel", 1) if p.ndim == 2 else ("bias", 0)
        return tuple(mods) + (leaf,), dim, self.coord, self.size

    @torch.no_grad()
    def load_moments(self, optimizer: torch.optim.Optimizer,
                     moments: Dict[str, Dict[str, torch.Tensor]]) -> None:
        """Sets each leaf's Adam state from its moments {name: {"step",
        "exp_avg", "exp_avg_sq"}}: a sharded parameter's are this rank's
        rows already (the checkpoint reads only those), a replicated one's
        are whole."""
        for name, st in moments.items():
            leaf = self.shards.get(name, self.full[name])
            optimizer.state[leaf] = {
                "step": st["step"].clone(),
                "exp_avg": st["exp_avg"].clone().to(leaf.device),
                "exp_avg_sq": st["exp_avg_sq"].clone().to(leaf.device)}


def apply_param_shardings(model: nn.Module, mesh: Mesh,
                          plan: Dict[str, Optional[int]],
                          axis: str = "model") -> ColumnParallel:
    """Puts `model`'s parameters under `plan` on this rank: its shards
    become the optimizer's leaves (`ColumnParallel.params`)."""
    return ColumnParallel(model, mesh, plan, axis)


def pipeline_stage_assignment(conv_layer_dimensions: List[int],
                              num_stages: int) -> List[int]:
    """Contiguous layer -> stage split balancing per-layer output widths (a
    proxy for per-layer FLOPs at fixed edge count). Returns the stage of
    each conv layer; stages are contiguous and non-empty when
    num_stages <= num_layers."""
    n = len(conv_layer_dimensions)
    if num_stages <= 0:
        raise ValueError("num_stages must be positive")
    num_stages = min(num_stages, n)
    weights = [float(d) for d in conv_layer_dimensions]
    total = sum(weights)
    # greedy prefix split at cumulative-weight boundaries, every stage at
    # least one layer
    bounds = [total * (s + 1) / num_stages for s in range(num_stages)]
    stages, acc, s = [], 0.0, 0
    for i, w in enumerate(weights):
        acc += w
        stages.append(s)
        remaining_layers = n - i - 1
        remaining_stages = num_stages - s - 1
        if s < num_stages - 1 and (acc >= bounds[s]
                                   or remaining_layers == remaining_stages):
            s += 1
    return stages
