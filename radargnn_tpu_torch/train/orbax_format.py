"""The JAX package's orbax checkpoint layout, written and read with the
port's own code (`train.ocdbt` for tensorstore's OCDBT key-value store,
`train.zstd` for zstd, zarr v2 here): neither orbax (which imports JAX),
tensorstore nor a zstd or crc32c package is imported, and every machine
runs the same code.

The JAX package's `backend="orbax"` saves its tree {params, batch_stats,
opt_state} with orbax-checkpoint's `PyTreeCheckpointer` (0.11.32, the
Dockerfile's pin). For a tree of `jax.Array` leaves that writes a folder:

  ocdbt.process_<i>/   process i's OCDBT key-value store: one zarr (v2)
                       array a leaf, at the key of its dotted name
                       ("params.conv_0.pre_mlp.lin_0.kernel"): its
                       `.zarray` and its chunks `i.j...`, chunked by the
                       piece a process writes, zstd; process i writes
                       the pieces it holds the first replica of
  manifest.ocdbt, d/   the store process 0 merges from the processes'
                       stores after they all wrote (orbax's
                       `merge_ocdbt_per_process_files`); its entries refer
                       to the processes' data files; readers open it
  array_metadatas/process_<i>   the leaves process i wrote, with their
                       write and chunk shapes (`array_metadata_store`)
  _sharding            each leaf's NamedSharding (JSON under the urlsafe
                       base64 of its dotted name)
  _METADATA            the tree: each leaf's key path and value type, and
                       every empty dict (`base_pytree_checkpoint_handler`)
  _CHECKPOINT_METADATA the handler's name and the save's timestamps

`save_pytree` writes that layout from any number of ranks, each writing
only its own pieces (`Piece`: a column slice of a column-parallel leaf),
and `load_pytree` reads it (either package's), whole or by slices, reading
only the chunks a slice touches. The shardings name a mesh of device ids
0 .. world - 1 with the port's mesh axes, so the JAX package restores the
arrays on a mesh of that size. Chunks are written as zstd frames of
compressed blocks (`zstd.compress`: Huffman-coded literals and long runs
as sequences, values bit for bit) and read whatever zstd frames they
hold. The leaves are float32 or int32 (the two
packages' trees); another dtype, a compressor other than zstd or none,
filters, or `use_zarr3: true` (which the JAX package never sets) raises
ValueError naming it.
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

from radargnn_tpu_torch.train import ocdbt, zstd

_HANDLER = ("orbax.checkpoint._src.handlers.pytree_checkpoint_handler."
            "PyTreeCheckpointHandler")
_PROCESS_DIR = "ocdbt.process_"
_KEY_TYPE_DICT = 2            # orbax's KeyType.DICT
# the zarr dtypes of the two packages' trees
_DTYPES = {"<f4": np.dtype("<f4"), "<i4": np.dtype("<i4")}
_COMPRESSOR = {"id": "zstd", "level": 1}
_FILL = {"NaN": np.nan, "Infinity": np.inf, "-Infinity": -np.inf}


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


def _zarray(shape: Sequence[int], chunks: Sequence[int],
            dtype: str) -> bytes:
    """A `.zarray` as tensorstore writes it for orbax."""
    return json.dumps({
        "chunks": list(chunks), "compressor": _COMPRESSOR,
        "dimension_separator": ".", "dtype": dtype, "fill_value": None,
        "filters": None, "order": "C", "shape": list(shape),
        "zarr_format": 2}, separators=(",", ":")).encode()


def _zarr_dtype(dtype: np.dtype, name: str) -> str:
    for key, value in _DTYPES.items():
        if np.dtype(dtype) == value:
            return key
    raise ValueError(f"{name}: dtype {np.dtype(dtype).name} is not one the "
                     "orbax backend writes (float32, int32)")


def _chunk_key(index: Sequence[int], separator: str = ".") -> str:
    return separator.join(str(i) for i in index) if len(index) else "0"


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

    leaves = list(_leaves(tree))
    items: Dict[bytes, bytes] = {}
    written = []
    for path, leaf in leaves:
        if isinstance(leaf, dict):
            continue
        if isinstance(leaf, Piece):
            if not leaf.write:
                continue
            data, shape = leaf.data, leaf.shape
            index = [0] * len(shape)
            index[leaf.dim] = leaf.index
        else:
            if process != 0:
                continue
            data = np.asarray(leaf)
            shape, index = data.shape, [0] * data.ndim
        name = _name(path)
        dtype = _zarr_dtype(data.dtype, name)
        data = np.asarray(data, _DTYPES[dtype], order="C")
        chunks = list(data.shape)
        items[f"{name}/.zarray".encode()] = _zarray(shape, chunks, dtype)
        items[f"{name}/{_chunk_key(index)}".encode()] = zstd.compress(
            data.tobytes())
        written.append({"array_metadata": {
            "param_name": name, "write_shape": chunks,
            "chunk_shape": chunks, "ext_metadata": None}})
    if items:
        ocdbt.write_store(os.path.join(tmp, f"{_PROCESS_DIR}{process}"),
                          items, os.urandom)
    os.makedirs(os.path.join(tmp, "array_metadatas"), exist_ok=True)
    with open(os.path.join(tmp, "array_metadatas", f"process_{process}"),
              "w") as f:
        json.dump({"array_metadatas": written}, f)
    barrier()

    if process == 0:
        children = sorted((name for name in os.listdir(tmp)
                           if name.startswith(_PROCESS_DIR)),
                          key=lambda n: int(n[len(_PROCESS_DIR):]))
        # orbax's `merge_ocdbt_per_process_files`
        ocdbt.merge_stores(tmp, children, os.urandom)
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


def load_pytree(directory: str,
                select: Optional[Callable[[Tuple[str, ...], tuple],
                                          Optional[tuple]]] = None) -> Dict:
    """The tree an orbax PyTree checkpoint in `directory` holds (either
    package's `save_pytree` / `PyTreeCheckpointer.save`), as nested dicts
    of numpy arrays (0-d for scalars). `select(path, shape)` may return
    the index (a tuple of slices) of the part of a leaf to read; None
    reads it whole."""
    directory = os.path.abspath(directory)
    with open(os.path.join(directory, "_METADATA")) as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        raise ValueError(f"{directory}: a zarr3 checkpoint (use_zarr3: "
                         "true); the orbax backend reads zarr v2, which "
                         "orbax writes by default")
    store = ocdbt.Store(directory)
    tree: Dict[str, Any] = {}
    plans = []
    for entry in meta["tree_metadata"].values():
        path = tuple(k["key"] for k in entry["key_metadata"])
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        value = entry["value_metadata"]
        if value["skip_deserialize"]:
            node[path[-1]] = {} if value["value_type"] == "Dict" else None
            continue
        name = _name(path)
        raw = store.read(f"{name}/.zarray")
        if raw is None:
            raise ValueError(f"{directory}: no array {name}")
        array = _Zarray(name, json.loads(raw))
        index = select(path, array.shape) if select else None
        plans.append((node, path[-1], array, array.box(index)))
    # every chunk of every leaf read, and decompressed, together
    wanted = [(i, f"{array.name}/{key}".encode())
              for i, (_, _, array, box) in enumerate(plans)
              for key in array.chunk_keys(box)]
    raws = store.read_many([key for _, key in wanted])
    frames = [j for j, (i, _) in enumerate(wanted)
              if raws[j] is not None and plans[i][2].compressed]
    for j, data in zip(frames, zstd.decompress_many([raws[j]
                                                     for j in frames])):
        raws[j] = data
    parts: Dict[int, List[Optional[bytes]]] = {}
    for (i, _), raw in zip(wanted, raws):
        parts.setdefault(i, []).append(raw)
    for i, (node, key, array, box) in enumerate(plans):
        node[key] = array.assemble(box, parts.get(i, []))
    return tree


class _Zarray:
    """A zarr v2 array's metadata (`.zarray`) and the reading of its
    chunks."""

    def __init__(self, name: str, meta: Dict):
        self.name = name
        if meta.get("zarr_format") != 2:
            raise ValueError(f"{name}: zarr format {meta.get('zarr_format')}"
                             " (the orbax backend reads zarr v2)")
        if meta.get("dtype") not in _DTYPES:
            raise ValueError(f"{name}: zarr dtype {meta.get('dtype')!r} is "
                             "not one the orbax backend reads (<f4, <i4)")
        compressor = meta.get("compressor")
        if compressor is not None and compressor.get("id") != "zstd":
            raise ValueError(f"{name}: zarr compressor {compressor!r} (the "
                             "orbax backend reads zstd or none)")
        if meta.get("filters"):
            raise ValueError(f"{name}: zarr filters {meta['filters']!r} "
                             "are not read")
        if meta.get("order", "C") not in ("C", "F"):
            raise ValueError(f"{name}: zarr order {meta.get('order')!r}")
        self.dtype = _DTYPES[meta["dtype"]]
        self.compressed = compressor is not None
        self.shape = tuple(meta["shape"])
        self.chunks = tuple(meta["chunks"])
        self.order = meta.get("order", "C")
        self.separator = meta.get("dimension_separator", ".")
        fill = meta.get("fill_value")
        self.fill = 0 if fill is None else _FILL.get(fill, fill)
        if len(self.chunks) != len(self.shape) \
                or any(c < 1 for c in self.chunks):
            raise ValueError(f"{name}: chunks {self.chunks} for shape "
                             f"{self.shape}")

    def box(self, index) -> Tuple[Tuple[int, int], ...]:
        """The (start, stop) per dimension of `index` (a tuple of slices,
        or None for the whole array)."""
        if index is None:
            return tuple((0, n) for n in self.shape)
        index = tuple(index) + (slice(None),) * (len(self.shape)
                                                 - len(index))
        out = []
        for s, n in zip(index, self.shape):
            if not isinstance(s, slice) or s.step not in (None, 1):
                raise ValueError(f"{self.name}: index {s!r} is not a "
                                 "contiguous slice")
            start, stop, _ = s.indices(n)
            out.append((start, max(start, stop)))
        return tuple(out)

    def _grid(self, box):
        ranges = [range(a // c, -(-b // c)) for (a, b), c in
                  zip(box, self.chunks)]
        return list(np.ndindex(*[len(r) for r in ranges])), ranges

    def chunk_keys(self, box) -> List[str]:
        """The keys of the chunks `box` touches, in C order."""
        cells, ranges = self._grid(box)
        return [_chunk_key([r[i] for r, i in zip(ranges, cell)],
                           self.separator) for cell in cells]

    def assemble(self, box, parts: List[Optional[bytes]]) -> np.ndarray:
        """The array over `box` from its chunks' bytes (None: a chunk the
        store lacks, which holds the fill value)."""
        out = np.full([b - a for a, b in box], self.fill, self.dtype)
        cells, ranges = self._grid(box)
        size = int(np.prod(self.chunks)) * self.dtype.itemsize
        for cell, raw in zip(cells, parts):
            if raw is None:
                continue
            if len(raw) != size:
                raise ValueError(f"{self.name}: a chunk of {len(raw)} bytes"
                                 f" where {size} were expected")
            chunk = np.frombuffer(raw, self.dtype).reshape(
                self.chunks, order=self.order)
            src, dst = [], []
            for (a, b), c, r, i in zip(box, self.chunks, ranges, cell):
                lo = r[i] * c
                s0, s1 = max(a, lo), min(b, lo + c)
                src.append(slice(s0 - lo, s1 - lo))
                dst.append(slice(s0 - a, s1 - a))
            out[tuple(dst)] = chunk[tuple(src)]
        return out
