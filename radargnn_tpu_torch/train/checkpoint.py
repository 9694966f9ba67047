"""Checkpoints in the JAX package's files and layout (its msgpack backend).

Port of `radargnn_tpu/train/checkpoint.py`:

  * `save_variables` / `load_variables`: {'params', 'batch_stats'} flax
    variable trees (`weights.to_jax_variables`) as flax msgpack,
  * `save_train_state` / `load_train_state`: the mid-training state in a
    folder: `model.msgpack`, `opt_state.msgpack` (the optax state-dict
    layout, `weights.optimizer_state_to_jax`) and `meta.json` (epoch, loss
    history, scheduler lr).

Flax encodes a numpy array as the msgpack extension type 1 holding the
packed (shape, dtype name, C-order bytes) and a numpy scalar as type 3;
this module writes and reads that encoding with `msgpack` alone, so files
cross between the two packages both ways. `msgpack` is imported where it
is used. The orbax backend (multi-host) is ROADMAP item A10.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


def _ext_pack(obj):
    import msgpack

    if isinstance(obj, np.ndarray):
        code = _EXT_NDARRAY
    elif isinstance(obj, np.generic):
        code, obj = _EXT_NPSCALAR, np.asarray(obj)
    else:
        raise TypeError(f"cannot serialise {type(obj).__name__}")
    if obj.dtype.hasobject:
        raise ValueError("object arrays cannot be serialised")
    payload = (obj.shape, obj.dtype.name, obj.tobytes("C"))
    return msgpack.ExtType(code, msgpack.packb(payload, use_bin_type=True))


def _ext_unpack(code: int, data: bytes):
    import msgpack

    if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
        return msgpack.ExtType(code, data)
    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    arr = np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode())
                        ).reshape(shape)
    return arr[()] if code == _EXT_NPSCALAR else arr


def _sorted_keys(tree):
    if isinstance(tree, dict):
        return {k: _sorted_keys(tree[k]) for k in sorted(tree)}
    return tree


def msgpack_serialize(tree: Dict[str, Any]) -> bytes:
    """A tree of dicts with numpy leaves -> flax msgpack bytes (keys in
    sorted order, as flax writes them)."""
    import msgpack

    return msgpack.packb(_sorted_keys(tree), default=_ext_pack,
                         strict_types=True)


def msgpack_restore(raw: bytes) -> Dict[str, Any]:
    """Flax msgpack bytes -> a tree of dicts with numpy leaves."""
    import msgpack

    return msgpack.unpackb(raw, ext_hook=_ext_unpack, raw=False)


def save_variables(path: str, variables: Dict[str, Any]) -> None:
    with open(path, "wb") as f:
        f.write(msgpack_serialize(variables))


def load_variables(path: str) -> Dict[str, Any]:
    with open(path, "rb") as f:
        return msgpack_restore(f.read())


def save_train_state(folder: str, *, params, batch_stats, opt_state,
                     epoch: int, losses: Dict[str, list],
                     scheduler_lr: float,
                     extra: Optional[Dict[str, Any]] = None) -> None:
    """Writes model.msgpack, opt_state.msgpack and meta.json to `folder`
    (trees of numpy arrays in the flax / optax layouts)."""
    os.makedirs(folder, exist_ok=True)
    meta = {"epoch": epoch, "scheduler_lr": float(scheduler_lr),
            "losses": {k: [float(x) for x in v] for k, v in losses.items()}}
    if extra:
        meta.update(extra)
    save_variables(os.path.join(folder, "model.msgpack"),
                   {"params": params, "batch_stats": batch_stats})
    save_variables(os.path.join(folder, "opt_state.msgpack"), opt_state)
    with open(os.path.join(folder, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2)


def load_train_state(folder: str):
    """(model variables, optimizer state tree, meta) from a folder that
    either package's `save_train_state` wrote with the msgpack backend."""
    if os.path.isdir(os.path.join(folder, "orbax")):
        raise NotImplementedError("orbax checkpoints are not ported yet "
                                  "(ROADMAP.md item A10)")
    model = load_variables(os.path.join(folder, "model.msgpack"))
    opt_sd = load_variables(os.path.join(folder, "opt_state.msgpack"))
    with open(os.path.join(folder, "meta.json")) as f:
        meta = json.load(f)
    return model, opt_sd, meta
