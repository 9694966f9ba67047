"""Checkpoints in the JAX package's files and layouts (both its backends).

Port of `radargnn_tpu/train/checkpoint.py`:

  * `save_variables` / `load_variables`: {'params', 'batch_stats'} flax
    variable trees (`weights.to_jax_variables`) as flax msgpack,
  * `save_train_state` / `load_train_state`: the mid-training state in a
    folder: the model variables and the optimizer state (the optax
    state-dict layout, `weights.optimizer_state_to_jax`) and `meta.json`
    (epoch, loss history, scheduler lr). Two backends, as there:
    "msgpack" (the default: `model.msgpack`, `opt_state.msgpack`, written
    by one rank from full arrays) and "orbax" (`backend="orbax"` or
    RADARGNN_CKPT_BACKEND=orbax: orbax's PyTree layout in `orbax/`,
    `train.orbax_format`, where every rank writes its own column slices of
    the column-parallel leaves, so nothing is gathered to full width).
    `load_train_state` reads either, finding an `orbax/` folder as the JAX
    package does.

Flax encodes a numpy array as the msgpack extension type 1 holding the
packed (shape, dtype name, C-order bytes) and a numpy scalar as type 3;
this module writes and reads that encoding with `msgpack` alone, so files
cross between the two packages both ways. `msgpack` is imported where it
is used. The orbax backend needs neither orbax (which imports JAX) nor
tensorstore: the port reads and writes orbax's OCDBT, zarr v2 and zstd
layout with its own numpy code (`train.orbax_format`, `train.ocdbt`,
`train.zstd`), the same on every machine.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, Optional

import numpy as np

from radargnn_tpu_torch.train import orbax_format

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


def backend_name(backend: Optional[str] = None) -> str:
    """The checkpoint backend: `backend`, else RADARGNN_CKPT_BACKEND, else
    "msgpack" (the JAX package's rule)."""
    return backend or os.environ.get("RADARGNN_CKPT_BACKEND", "msgpack")


def save_train_state(folder: str, *, params, batch_stats, opt_state,
                     epoch: int, losses: Dict[str, list],
                     scheduler_lr: float,
                     extra: Optional[Dict[str, Any]] = None,
                     backend: Optional[str] = None, process: int = 0,
                     barrier: Callable[[], None] = lambda: None,
                     mesh_axes: Optional[Dict[str, int]] = None) -> None:
    """Writes the training state to `folder` (trees of numpy arrays in the
    flax / optax layouts) and meta.json: model.msgpack and
    opt_state.msgpack with the msgpack backend, orbax/ with the orbax one
    (`backend_name`). Under the orbax backend every rank of a mesh calls
    it (`process`, `barrier`, `mesh_axes` as `orbax_format.save_pytree`
    takes them; a sharded leaf is an `orbax_format.Piece`); process 0
    writes meta.json."""
    backend = backend_name(backend)
    if backend not in ("msgpack", "orbax"):
        raise ValueError(f'unknown checkpoint backend "{backend}": '
                         '"msgpack" or "orbax"')
    if process == 0:
        os.makedirs(folder, exist_ok=True)
    meta = {"epoch": epoch, "scheduler_lr": float(scheduler_lr),
            "losses": {k: [float(x) for x in v] for k, v in losses.items()}}
    if extra:
        meta.update(extra)
    if backend == "orbax":
        orbax_format.save_pytree(
            os.path.join(folder, "orbax"),
            {"params": params, "batch_stats": batch_stats,
             "opt_state": opt_state},
            process=process, barrier=barrier, mesh_axes=mesh_axes)
    else:
        save_variables(os.path.join(folder, "model.msgpack"),
                       {"params": params, "batch_stats": batch_stats})
        save_variables(os.path.join(folder, "opt_state.msgpack"), opt_state)
    if process == 0:
        with open(os.path.join(folder, "meta.json"), "w") as f:
            json.dump(meta, f, indent=2)


def _select_leaves(tree, select, path=()):
    """`tree` with each leaf cut to `select(path, shape)` where it gives an
    index."""
    if isinstance(tree, dict):
        return {k: _select_leaves(v, select, path + (k,))
                for k, v in tree.items()}
    index = select(path, np.shape(tree))
    return tree if index is None else np.asarray(tree)[index]


def load_train_state(folder: str, select=None):
    """(model variables, optimizer state tree, meta) from a folder that
    either package's `save_train_state` wrote, with either backend (an
    `orbax/` folder is read as orbax's layout). `select(path, shape)`,
    where given, may return the index of the part of a leaf to read
    (`path` from the top: "params", "batch_stats" or "opt_state" first);
    orbax's layout is read only there."""
    orbax_path = os.path.join(folder, "orbax")
    if os.path.isdir(orbax_path):
        tree = orbax_format.load_pytree(orbax_path, select)
        model = {"params": tree["params"],
                 "batch_stats": tree["batch_stats"]}
        opt_sd = tree["opt_state"]
    else:
        model = load_variables(os.path.join(folder, "model.msgpack"))
        opt_sd = load_variables(os.path.join(folder, "opt_state.msgpack"))
        if select is not None:
            model = _select_leaves(model, select)
            opt_sd = _select_leaves(opt_sd, select, ("opt_state",))
    with open(os.path.join(folder, "meta.json")) as f:
        meta = json.load(f)
    return model, opt_sd, meta
