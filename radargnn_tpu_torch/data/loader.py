"""Padded-bucket graph data loading.

Port of `radargnn_tpu/data/loader.py`:

  * graphs are stored one per file as compressed npz `GraphSample`s
    (`graph_<i>.npz`), written by the dataset creation,
  * batches are padded to a fixed (max_nodes, max_edges) bucket shared by
    every split, so every step sees the same shapes,
  * shuffling is seeded (`np.random.default_rng(seed)`), so the batch order
    is the JAX package's,
  * the graph count of the last batch is padded with an empty graph,
  * with `cache_batches` every batch is stacked once and stays on the
    device; a shuffle then permutes the batches' order, not their members.

Batches land on `device`: the CUDA card by default, the CPU only where the
caller asks for it. With `halo_partition` (training over a data × model
mesh of ranks: {"dp", "mp", "ovf_frac"}) the bucket also aligns to the mp
node shards, the batch size must split over dp, and every batch carries
per-graph halo plans under one dataset-wide set of budgets
(`graph.batch.halo_dataset_budgets`, the batch-padding empty graph
included), so every batch has one shape. With `mesh` (this rank's
`parallel.mesh.Mesh`) each batch is stacked on the host and the loader
yields the rank's part of it on the rank's device (`shard_batch`: its
graphs, node shard, plan and sender landing); with `cache_batches` that
part is built once and kept.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from radargnn_tpu_torch.device import DeviceLike, resolve_device
from radargnn_tpu_torch.graph.batch import (
    GraphBatch, GraphSample, halo_dataset_budgets, roll_passes_bound,
    stack_samples,
)
from radargnn_tpu_torch.parallel.mesh import Mesh, shard_batch


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _pad_align(csr_tiling, pad_align: int = 64,
               halo_partition: Optional[dict] = None) -> int:
    """The bucket's alignment under a tiling: the dense tiling's node block
    and receiver tile, the windowed and CSR tilings' node block; under a
    halo partition also the mp node shards."""
    if isinstance(csr_tiling, dict):
        pad_align = max(pad_align, int(np.lcm(csr_tiling["node_block"],
                                              csr_tiling["r_tile"])))
    elif csr_tiling is not None:
        pad_align = max(pad_align, csr_tiling[0])
    if halo_partition is not None:
        pad_align = int(np.lcm(pad_align, halo_partition["mp"]))
    return pad_align


class GraphDataLoader:
    """Iterates GraphBatches of `batch_size` padded graphs on `device`
    (with `mesh`, this rank's part of each on the mesh's device)."""

    def __init__(self, samples: List[GraphSample], batch_size: int,
                 shuffle: bool, bg_index: int, seed: int = 0,
                 max_nodes: Optional[int] = None,
                 max_edges: Optional[int] = None,
                 pad_align: int = 64, drop_last: bool = False,
                 csr_tiling=None, cache_batches: bool = False,
                 halo_partition: Optional[dict] = None,
                 device: DeviceLike = None, mesh: Optional[Mesh] = None):
        if not samples:
            raise ValueError("empty sample list")
        if halo_partition is not None \
                and batch_size % max(halo_partition.get("dp", 1), 1):
            raise ValueError("batch_size must divide evenly over the mesh "
                             "data axis for halo training")
        self.mesh = mesh
        self.device = mesh.device if mesh is not None \
            else resolve_device(device)
        self.samples = samples
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.bg_index = bg_index
        self.drop_last = drop_last
        self.csr_tiling = csr_tiling
        pad_align = _pad_align(csr_tiling, pad_align, halo_partition)
        self._rng = np.random.default_rng(seed)
        self._pad_cache: dict = {}
        self._empty: Optional[GraphSample] = None
        self.cache_batches = cache_batches
        self._batch_cache: Optional[List[GraphBatch]] = None
        # one roll bound for the loader, so that every windowed batch has
        # one geometry
        self.roll_passes: Optional[int] = None
        if csr_tiling is not None and not isinstance(csr_tiling, dict) \
                and len(csr_tiling) >= 3:
            if len(csr_tiling) >= 5 and csr_tiling[4] is not None:
                # spread tiling caps runs at run_cap by construction
                self.roll_passes = (int(csr_tiling[4]) - 1).bit_length()
            else:
                self.roll_passes = roll_passes_bound(samples, csr_tiling[1])

        n_max = max(s.num_nodes for s in samples)
        e_max = max(s.num_edges for s in samples)
        self.max_nodes = max_nodes or _round_up(n_max, pad_align)
        self.max_edges = max_edges or _round_up(e_max, pad_align)

        self.halo_partition: Optional[dict] = None
        if halo_partition is not None and halo_partition.get("budgets"):
            # the caller's dataset-wide budgets (get_data_loaders merges
            # them across splits)
            self.halo_partition = dict(halo_partition)
        elif halo_partition is not None:
            if self.max_nodes % halo_partition["mp"]:
                raise ValueError("bucket size not divisible by mp")
            self.halo_partition = dict(halo_partition)
            self.halo_partition["budgets"] = halo_dataset_budgets(
                samples + [_empty_like(samples[0])], self.max_nodes,
                self.max_edges, bg_index, csr_tiling, halo_partition)

    def __len__(self) -> int:
        n = len(self.samples)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[GraphBatch]:
        if self.cache_batches:
            if self._batch_cache is None:
                self._batch_cache = list(self._iter_batches(shuffled=False))
            idx = np.arange(len(self._batch_cache))
            if self.shuffle:
                self._rng.shuffle(idx)
            for i in idx:
                yield self._batch_cache[i]
            return
        yield from self._iter_batches(shuffled=self.shuffle)

    def _iter_batches(self, shuffled: bool) -> Iterator[GraphBatch]:
        order = np.arange(len(self.samples))
        if shuffled:
            self._rng.shuffle(order)
        for start in range(0, len(order), self.batch_size):
            idx = order[start:start + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                break
            batch_samples = [self.samples[i] for i in idx]
            # pad the graph count with one shared empty sample, whose
            # padding the pad cache then keeps
            if len(batch_samples) < self.batch_size:
                if self._empty is None:
                    self._empty = _empty_like(batch_samples[0])
                while len(batch_samples) < self.batch_size:
                    batch_samples.append(self._empty)
            batch = stack_samples(
                batch_samples, self.max_nodes, self.bg_index, self.max_edges,
                csr_tiling=self.csr_tiling, pad_cache=self._pad_cache,
                roll_passes=self.roll_passes,
                device=self.device if self.mesh is None else "cpu",
                halo_partition=self.halo_partition)
            yield shard_batch(batch, self.mesh)


def _empty_like(sample: GraphSample) -> GraphSample:
    """A graph with zero valid nodes/edges matching a sample's feature dims."""
    return GraphSample(
        node_feat=np.zeros((0, sample.node_feat.shape[1]), np.float32),
        edge_feat=np.zeros((0, sample.edge_feat.shape[1]), np.float32),
        senders=np.zeros((0,), np.int32), receivers=np.zeros((0,), np.int32),
        labels=np.zeros((0,), np.int32),
        boxes=np.zeros((0, sample.boxes.shape[1]), np.float32),
        pos=np.zeros((0, 2), np.float32), vel=np.zeros((0, 2), np.float32))


def load_split_samples(root: str, split: str) -> List[GraphSample]:
    paths = sorted(glob.glob(f"{root}/{split}/*.npz"))
    return [GraphSample.load_npz(p) for p in paths]


def get_data_loaders(splits: List[str], root: str, batch_size: int,
                     shuffle: bool, bg_index: int = 5, seed: int = 0,
                     csr_tiling=None, halo_partition: Optional[dict] = None,
                     device: DeviceLike = None, mesh: Optional[Mesh] = None,
                     ) -> Tuple[Dict[str, GraphDataLoader], dict]:
    """Reads the graph npz files of each split into a loader (one bucket
    for all splits; only "train" shuffles), and the dataset's config.json.
    A `halo_partition` gets budgets shared by every split; with `mesh` the
    loaders yield this rank's parts (`GraphDataLoader`)."""
    device = mesh.device if mesh is not None else resolve_device(device)
    all_samples = {s: load_split_samples(root, s) for s in splits}
    n_max = max(max((g.num_nodes for g in ss), default=1)
                for ss in all_samples.values())
    e_max = max(max((g.num_edges for g in ss), default=1)
                for ss in all_samples.values())
    align = _pad_align(csr_tiling, halo_partition=halo_partition)
    n_bucket = _round_up(n_max, align)
    e_bucket = _round_up(e_max, align)
    shared = None
    if halo_partition is not None:
        # one budget for every split, so train and validate share a shape
        everything = [s for ss in all_samples.values() for s in ss]
        everything.append(_empty_like(everything[0]))
        shared = dict(halo_partition, budgets=halo_dataset_budgets(
            everything, n_bucket, e_bucket, bg_index, csr_tiling,
            halo_partition))
    loaders = {split: GraphDataLoader(
        samples, batch_size, shuffle and split == "train", bg_index,
        seed=seed, max_nodes=n_bucket, max_edges=e_bucket,
        csr_tiling=csr_tiling, halo_partition=shared, device=device,
        mesh=mesh)
        for split, samples in all_samples.items()}

    config_path = os.path.join(root, "config.json")
    dataset_config = {}
    if os.path.exists(config_path):
        with open(config_path) as f:
            dataset_config = json.load(f)
    return loaders, dataset_config
