"""The JAX package's orbax checkpoint layout, written and read with
`tensorstore` alone (orbax imports JAX; the port does not).

The JAX package's `backend="orbax"` saves its tree {params, batch_stats,
opt_state} with orbax-checkpoint's `PyTreeCheckpointer` (0.11.32, the
Dockerfile's pin). For a tree of `jax.Array` leaves that writes a folder:

  ocdbt.process_<i>/   process i's OCDBT key-value store: one zarr (v2)
                       array a leaf, at the key of its dotted name
                       ("params.conv_0.pre_mlp.lin_0.kernel"), chunked by
                       the piece a process writes, zstd; process i writes
                       the pieces it holds the first replica of
  manifest.ocdbt, d/   the store process 0 merges from the processes'
                       stores after they all wrote (orbax's
                       `merge_ocdbt_per_process_files`); readers open it
  array_metadatas/process_<i>   the leaves process i wrote, with their
                       write and chunk shapes (`array_metadata_store`)
  _sharding            each leaf's NamedSharding (JSON under the urlsafe
                       base64 of its dotted name)
  _METADATA            the tree: each leaf's key path and value type, and
                       every empty dict (`base_pytree_checkpoint_handler`)
  _CHECKPOINT_METADATA the handler's name and the save's timestamps

`save_pytree` writes that layout from any number of ranks, each writing
only its own pieces (`Piece`: a column slice of a column-parallel leaf),
and `load_pytree` reads it (either package's), whole or by slices. The
shardings name a mesh of device ids 0 .. world - 1 with the port's mesh
axes, so the JAX package restores the arrays on a mesh of that size.
`tensorstore` is imported where it is used: on a machine without it
either call raises ImportError.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import os
import shutil
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

_HANDLER = ("orbax.checkpoint._src.handlers.pytree_checkpoint_handler."
            "PyTreeCheckpointHandler")
_PROCESS_DIR = "ocdbt.process_"
_KEY_TYPE_DICT = 2            # orbax's KeyType.DICT
# orbax's OCDBT write options (tensorstore_utils.add_ocdbt_write_options)
_OCDBT_CONFIG = {"max_inline_value_bytes": 1024,
                 "max_decoded_node_bytes": 100000000,
                 "manifest_kind": "single"}
_CONTEXT = {"file_io_concurrency": {"limit": 128},
            "cache_pool#ocdbt": {"total_bytes_limit": 100000000}}


def tensorstore():
    """The `tensorstore` module, or ImportError saying that the orbax
    backend needs it."""
    try:
        import tensorstore as ts
    except ImportError as err:
        raise ImportError(
            "the orbax checkpoint backend (RADARGNN_CKPT_BACKEND=orbax, or "
            "an orbax/ checkpoint folder) reads and writes orbax's layout "
            "through tensorstore, which is not installed here; use the "
            "msgpack backend") from err
    return ts


@dataclasses.dataclass
class Piece:
    """This rank's piece of a leaf sharded over the mesh axis `axis_name`:
    part `index` of `parts` equal slices along dimension `dim` of the full
    array (whose shape is `shape`). `write` says whether this rank writes
    it (one rank of those holding the same part)."""

    data: np.ndarray
    shape: Tuple[int, ...]
    dim: int
    index: int
    parts: int
    axis_name: str
    write: bool

    def region(self) -> Tuple[slice, ...]:
        return part_region(self.shape, self.dim, self.index, self.parts)


def part_region(shape: Sequence[int], dim: int, index: int,
                parts: int) -> Tuple[slice, ...]:
    """The index of part `index` of `parts` equal slices along `dim` of an
    array of `shape`."""
    n = shape[dim] // parts
    idx = [slice(None)] * len(shape)
    idx[dim] = slice(index * n, (index + 1) * n)
    return tuple(idx)


def _leaves(tree: Dict, prefix=()):
    """(key path, leaf) over a tree of dicts; an empty dict is a leaf."""
    for key in sorted(tree):
        value = tree[key]
        path = prefix + (str(key),)
        if isinstance(value, dict) and value:
            yield from _leaves(value, path)
        else:
            yield path, value


def _name(path: Sequence[str]) -> str:
    return ".".join(path)


def _kvstore(directory: str, process: Optional[int] = None,
             write: bool = False) -> Dict:
    base = directory if process is None \
        else os.path.join(directory, f"{_PROCESS_DIR}{process}")
    spec = {"driver": "ocdbt", "base": {"driver": "file", "path": base},
            "cache_pool": "cache_pool#ocdbt"}
    if write:
        spec.update(config=dict(_OCDBT_CONFIG), assume_config=True)
    return spec


def _dtype_name(dtype) -> str:
    return "bfloat16" if str(dtype) == "bfloat16" else np.dtype(dtype).name


def _sharding(mesh_axes: Dict[str, int], spec: List) -> str:
    """A NamedSharding as orbax serialises it (`metadata/sharding.py`)
    over device ids 0 .. world - 1 in row-major order of `mesh_axes`."""
    shape = list(mesh_axes.values())
    ids = np.arange(int(np.prod(shape))).reshape(shape)
    return json.dumps({
        "sharding_type": "NamedSharding", "shape": shape,
        "axis_names": list(mesh_axes),
        "axis_types": ["AxisType.Auto"] * len(shape),
        "partition_spec": spec,
        "device_mesh": {"mesh": np.vectorize(
            lambda i: {"id": int(i)}, otypes=[object])(ids).tolist()}})


def save_pytree(directory: str, tree: Dict, *, process: int = 0,
                barrier: Callable[[], None] = lambda: None,
                mesh_axes: Optional[Dict[str, int]] = None) -> None:
    """Writes `tree` (nested dicts of numpy arrays or scalars, or `Piece`s
    of sharded leaves) to `directory` in orbax's PyTree layout (module
    docstring), replacing what is there. Every rank of the save calls it
    with the same tree structure, its own `process` index and a `barrier`
    over the ranks; a full leaf is written by process 0, a `Piece` by the
    ranks whose piece says `write`. Process 0 then merges the ranks'
    stores and writes the metadata. `mesh_axes` ({name: size}, default
    {"data": 1}) names the shardings' mesh."""
    ts = tensorstore()
    directory = os.path.abspath(directory)
    mesh_axes = dict(mesh_axes or {"data": 1})
    tmp = directory + ".orbax-checkpoint-tmp"
    if process == 0:
        for path in (tmp, directory):
            if os.path.isdir(path):
                shutil.rmtree(path)
        os.makedirs(tmp)
    init_ns = time.time_ns()
    barrier()

    context = ts.Context(_CONTEXT)
    leaves = list(_leaves(tree))
    txn = ts.Transaction()
    futures, written = [], []
    for path, leaf in leaves:
        if isinstance(leaf, dict):
            continue
        if isinstance(leaf, Piece):
            if not leaf.write:
                continue
            data, shape, region = leaf.data, leaf.shape, leaf.region()
        else:
            if process != 0:
                continue
            data = np.asarray(leaf)
            shape, region = data.shape, ()
        data = np.asarray(data, order="C")
        chunks = list(data.shape)
        spec = {"driver": "zarr",
                "kvstore": dict(_kvstore(tmp, process, write=True),
                                path=_name(path)),
                "dtype": _dtype_name(data.dtype),
                "metadata": {"shape": list(shape), "chunks": chunks,
                             "compressor": {"id": "zstd", "level": 1}}}
        arr = ts.open(spec, create=True, open=True, context=context,
                      transaction=txn).result()
        futures.append(arr[region].write(data) if region
                       else arr.write(data))
        written.append({"array_metadata": {
            "param_name": _name(path), "write_shape": chunks,
            "chunk_shape": chunks, "ext_metadata": None}})
    for fut in futures:
        fut.result()
    txn.commit_async().result()
    os.makedirs(os.path.join(tmp, "array_metadatas"), exist_ok=True)
    with open(os.path.join(tmp, "array_metadatas", f"process_{process}"),
              "w") as f:
        json.dump({"array_metadatas": written}, f)
    barrier()

    if process == 0:
        _merge(ts, tmp, context)
        tree_meta, shardings = {}, {}
        for path, leaf in leaves:
            entry = {"key_metadata": [{"key": k, "key_type": _KEY_TYPE_DICT}
                                      for k in path]}
            if isinstance(leaf, dict):
                entry["value_metadata"] = {"value_type": "Dict",
                                           "skip_deserialize": True}
            else:
                shape = leaf.shape if isinstance(leaf, Piece) \
                    else np.shape(leaf)
                spec = [None] * len(shape)
                write_shape = list(shape)
                if isinstance(leaf, Piece):
                    spec[leaf.dim] = leaf.axis_name
                    write_shape = list(leaf.data.shape)
                entry["value_metadata"] = {"value_type": "jax.Array",
                                           "skip_deserialize": False,
                                           "write_shape": write_shape}
                name = base64.urlsafe_b64encode(
                    _name(path).encode()).decode()
                shardings[name] = _sharding(mesh_axes, spec)
            tree_meta[str(tuple(path))] = entry
        with open(os.path.join(tmp, "_sharding"), "w") as f:
            json.dump(shardings, f)
        with open(os.path.join(tmp, "_METADATA"), "w") as f:
            json.dump({"tree_metadata": tree_meta, "use_ocdbt": True,
                       "use_zarr3": False,
                       "store_array_data_equal_to_fill_value": True,
                       "custom_metadata": None}, f)
        with open(os.path.join(tmp, "_CHECKPOINT_METADATA"), "w") as f:
            json.dump({"item_handlers": _HANDLER, "metrics": {},
                       "performance_metrics": {},
                       "init_timestamp_nsecs": init_ns,
                       "commit_timestamp_nsecs": time.time_ns(),
                       "custom_metadata": {}}, f)
        os.rename(tmp, directory)
    barrier()


def _merge(ts, directory: str, context) -> None:
    """The processes' stores copied into the folder's own OCDBT store in
    one atomic transaction (orbax's `merge_ocdbt_per_process_files`)."""
    children = [ts.KvStore.open(_kvstore(directory, int(
        name[len(_PROCESS_DIR):])), context=context).result()
        for name in sorted(os.listdir(directory))
        if name.startswith(_PROCESS_DIR)]
    parent = ts.KvStore.open(_kvstore(directory, write=True),
                             context=context).result()
    txn = ts.Transaction(atomic=True)
    for fut in [child.experimental_copy_range_to(parent.with_transaction(
            txn)) for child in children]:
        fut.result()
    txn.commit_async().result()


def load_pytree(directory: str,
                select: Optional[Callable[[Tuple[str, ...], tuple],
                                          Optional[tuple]]] = None) -> Dict:
    """The tree an orbax PyTree checkpoint in `directory` holds (either
    package's `save_pytree` / `PyTreeCheckpointer.save`), as nested dicts
    of numpy arrays (0-d for scalars). `select(path, shape)` may return
    the index (a tuple of slices) of the part of a leaf to read; None
    reads it whole."""
    ts = tensorstore()
    directory = os.path.abspath(directory)
    with open(os.path.join(directory, "_METADATA")) as f:
        meta = json.load(f)
    driver = "zarr3" if meta.get("use_zarr3") else "zarr"
    context = ts.Context(_CONTEXT)
    tree: Dict[str, Any] = {}
    pending = []
    for entry in meta["tree_metadata"].values():
        path = tuple(k["key"] for k in entry["key_metadata"])
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        value = entry["value_metadata"]
        if value["skip_deserialize"]:
            node[path[-1]] = {} if value["value_type"] == "Dict" else None
            continue
        arr = ts.open({"driver": driver,
                       "kvstore": dict(_kvstore(directory),
                                       path=_name(path))},
                      open=True, read=True, context=context).result()
        index = select(path, tuple(arr.shape)) if select else None
        pending.append((node, path[-1], (arr[index] if index else arr)
                        .read()))
    for node, key, fut in pending:
        node[key] = np.asarray(fut.result())
    return tree
