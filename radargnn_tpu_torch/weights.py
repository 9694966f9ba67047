"""Weight bridge between the JAX package's flax variables and the port's
state_dict.

Flax variables are a nested dict {"params": ..., "batch_stats": ...} with
paths such as `conv_0/pre_mlp/lin_0/kernel`, `bn_0/scale` and
`batch_stats/bn_0/mean`; the port's modules carry the same names, so a path
maps to a state_dict key by joining with dots and renaming the leaf:

    params/.../kernel [in, out]   <->  ....weight [out, in] (transposed)
    params/.../bias               <->  ....bias
    params/.../scale              <->  ....weight (1-D, BatchNorm)
    batch_stats/.../mean          <->  ....running_mean
    batch_stats/.../var           <->  ....running_var

The hoisted pre-MLP kernel [2d+de, 2d+de] keeps its rows w_r | w_s | w_e;
the layers slice the transposed weight the same way.

The optimizer state crosses too (`optimizer_state_to_jax` /
`optimizer_state_from_jax`), so a run resumes from a checkpoint that either
package's trainer wrote.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_PARAM_LEAF = {"kernel": "weight", "bias": "bias", "scale": "weight"}
_STAT_LEAF = {"mean": "running_mean", "var": "running_var"}


def _walk(tree: Mapping, prefix=()):
    for name, value in tree.items():
        if isinstance(value, Mapping):
            yield from _walk(value, prefix + (name,))
        else:
            yield prefix + (name,), value


def from_jax_variables(variables: Mapping) -> Dict[str, torch.Tensor]:
    """Flax variables (nested dicts of numpy arrays) -> a state_dict for the
    port's DetNet (`model.load_state_dict(...)`)."""
    state = {}
    for collection, leaves in (("params", _PARAM_LEAF),
                               ("batch_stats", _STAT_LEAF)):
        for path, value in _walk(variables.get(collection, {})):
            *mods, leaf = path
            if leaf not in leaves:
                raise KeyError(f"unknown flax leaf {collection}/"
                               f"{'/'.join(path)}")
            arr = np.asarray(value, dtype=np.float32)
            if leaf == "kernel":
                arr = arr.T
            key = ".".join(mods + [leaves[leaf]])
            state[key] = torch.tensor(arr)      # a copy: flax leaves may be read-only
    return state


def to_jax_variables(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """The inverse of `from_jax_variables`: a state_dict -> flax variables
    (nested dicts of numpy float32 arrays)."""
    out: Dict = {"params": {}, "batch_stats": {}}
    for key, tensor in state_dict.items():
        *mods, leaf = key.split(".")
        arr = tensor.detach().cpu().numpy().astype(np.float32)
        if leaf == "running_mean":
            collection, name = "batch_stats", "mean"
        elif leaf == "running_var":
            collection, name = "batch_stats", "var"
        elif leaf == "weight":
            collection = "params"
            name = "kernel" if arr.ndim == 2 else "scale"
            if arr.ndim == 2:
                arr = np.ascontiguousarray(arr.T)
        elif leaf == "bias":
            collection, name = "params", "bias"
        else:
            raise KeyError(f"unknown state_dict entry {key}")
        node = out[collection]
        for m in mods:
            node = node.setdefault(m, {})
        node[name] = arr
    return out


# ---------------------------------------------------------------------------
# optimizer state: torch Adam <-> the JAX trainer's optax state
# ---------------------------------------------------------------------------

def _named_params(optimizer: torch.optim.Optimizer, model: torch.nn.Module):
    """(name, parameter) in the optimizer's order (one parameter group)."""
    if len(optimizer.param_groups) != 1:
        raise ValueError("the optimizer must have one parameter group")
    names = {id(p): n for n, p in model.named_parameters()}
    return [(names[id(p)], p) for p in optimizer.param_groups[0]["params"]]


def optimizer_state_to_jax(optimizer: torch.optim.Optimizer,
                           model: torch.nn.Module) -> Dict:
    """A torch Adam's state as the JAX trainer's optax state dict
    (`serialization.to_state_dict` of `inject_hyperparams(chain(
    add_decayed_weights, scale_by_adam, scale_by_learning_rate))`):
    step <-> count, exp_avg <-> mu, exp_avg_sq <-> nu (flax parameter
    trees), and the lr and weight decay as hyper-parameters."""
    group = optimizer.param_groups[0]
    mu, nu, step = {}, {}, 0
    for name, p in _named_params(optimizer, model):
        state = optimizer.state.get(p, {})
        mu[name] = state.get("exp_avg", torch.zeros_like(p))
        nu[name] = state.get("exp_avg_sq", torch.zeros_like(p))
        if "step" in state:
            step = int(state["step"])
    count = np.asarray(step, np.int32)
    return {
        "count": count,
        "hyperparams": {
            "learning_rate": np.asarray(group["lr"], np.float32),
            "weight_decay": np.asarray(group["weight_decay"], np.float32)},
        "hyperparams_states": {},
        "inner_state": {
            "0": {},
            "1": {"count": count,
                  "mu": to_jax_variables(mu)["params"],
                  "nu": to_jax_variables(nu)["params"]},
            "2": {}},
    }


def optimizer_state_from_jax(opt_state: Mapping,
                             optimizer: torch.optim.Optimizer,
                             model: torch.nn.Module) -> None:
    """Loads an optax state dict of that layout (as `checkpoint.
    load_train_state` reads it) into the torch Adam `optimizer` of
    `model`: moments, step count, lr and weight decay."""
    adam = opt_state["inner_state"]["1"]
    step = float(np.asarray(adam["count"]))
    mu = from_jax_variables({"params": adam["mu"]})
    nu = from_jax_variables({"params": adam["nu"]})
    sd = optimizer.state_dict()
    sd["state"] = {
        i: {"step": torch.tensor(step), "exp_avg": mu[name],
            "exp_avg_sq": nu[name]}
        for i, (name, _) in enumerate(_named_params(optimizer, model))}
    hyper = opt_state["hyperparams"]
    sd["param_groups"][0]["lr"] = float(np.asarray(hyper["learning_rate"]))
    sd["param_groups"][0]["weight_decay"] = float(
        np.asarray(hyper["weight_decay"]))
    optimizer.load_state_dict(sd)
