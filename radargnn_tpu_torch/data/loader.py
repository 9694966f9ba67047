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
caller asks for it. Halo partitioning waits for ROADMAP.md §A, multi-GPU.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from radargnn_tpu_torch.device import DeviceLike, resolve_device
from radargnn_tpu_torch.graph.batch import (
    GraphBatch, GraphSample, roll_passes_bound, stack_samples,
)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _pad_align(csr_tiling, pad_align: int = 64) -> int:
    """The bucket's alignment under a tiling: the dense tiling's node block
    and receiver tile, the windowed and CSR tilings' node block."""
    if isinstance(csr_tiling, dict):
        return max(pad_align, int(np.lcm(csr_tiling["node_block"],
                                         csr_tiling["r_tile"])))
    if csr_tiling is not None:
        return max(pad_align, csr_tiling[0])
    return pad_align


def _no_halo(halo_partition: Optional[dict]) -> None:
    if halo_partition is not None:
        raise NotImplementedError(
            "halo edge partitioning spreads a graph over several cards and "
            "is not ported yet (ROADMAP.md §A, multi-GPU)")


class GraphDataLoader:
    """Iterates GraphBatches of `batch_size` padded graphs on `device`."""

    def __init__(self, samples: List[GraphSample], batch_size: int,
                 shuffle: bool, bg_index: int, seed: int = 0,
                 max_nodes: Optional[int] = None,
                 max_edges: Optional[int] = None,
                 pad_align: int = 64, drop_last: bool = False,
                 csr_tiling=None, cache_batches: bool = False,
                 halo_partition: Optional[dict] = None,
                 device: DeviceLike = None):
        _no_halo(halo_partition)
        if not samples:
            raise ValueError("empty sample list")
        self.device = resolve_device(device)
        self.samples = samples
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.bg_index = bg_index
        self.drop_last = drop_last
        self.csr_tiling = csr_tiling
        pad_align = _pad_align(csr_tiling, pad_align)
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
            yield stack_samples(batch_samples, self.max_nodes, self.bg_index,
                                self.max_edges, csr_tiling=self.csr_tiling,
                                pad_cache=self._pad_cache,
                                roll_passes=self.roll_passes,
                                device=self.device)


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
                     device: DeviceLike = None,
                     ) -> Tuple[Dict[str, GraphDataLoader], dict]:
    """Reads the graph npz files of each split into a loader (one bucket
    for all splits; only "train" shuffles), and the dataset's config.json."""
    _no_halo(halo_partition)
    device = resolve_device(device)
    all_samples = {s: load_split_samples(root, s) for s in splits}
    n_max = max(max((g.num_nodes for g in ss), default=1)
                for ss in all_samples.values())
    e_max = max(max((g.num_edges for g in ss), default=1)
                for ss in all_samples.values())
    align = _pad_align(csr_tiling)
    n_bucket = _round_up(n_max, align)
    e_bucket = _round_up(e_max, align)
    loaders = {split: GraphDataLoader(
        samples, batch_size, shuffle and split == "train", bg_index,
        seed=seed, max_nodes=n_bucket, max_edges=e_bucket,
        csr_tiling=csr_tiling, device=device)
        for split, samples in all_samples.items()}

    config_path = os.path.join(root, "config.json")
    dataset_config = {}
    if os.path.exists(config_path):
        with open(config_path) as f:
            dataset_config = json.load(f)
    return loaders, dataset_config
