"""GraphBatch — the static-shape padded graph container.

Port of `radargnn_tpu/graph/batch.py`. Every graph is padded to a bucket size
and G graphs are stacked along a leading axis:

    node_feat [G, N, Dn]   edge_feat [G, E, De]
    senders   [G, E]       receivers [G, E]        (node indices within graph)
    node_mask [G, N]       edge_mask [G, E]
    labels    [G, N]       boxes     [G, N, B]     (NaN for background nodes)
    pos       [G, N, 2]    vel       [G, N, 2]

Compute flattens to [G*N] / [G*E] with per-graph index offsets, which gives
the block-diagonal batch semantics including batch-wide BatchNorm
statistics. Index arrays stay int32, as in the JAX package.

The port builds the plain layout and the dense fixed-degree tiling of kNN
graphs (`csr_tiling={"mode": "dense", ...}`); the windowed/CSR tilings and
halo partitioning raise until their slice lands (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from radargnn_tpu_torch.device import DeviceLike, resolve_device
from radargnn_tpu_torch.ops.dense_tiles import (
    check_overflow_sorted, morton_order, prepare_dense_knn_tiles,
    window_part_mask,
)

_NOT_PORTED_TILING = (
    "only the dense tiling ({'mode': 'dense', ...}) is ported; the windowed "
    "and CSR tilings wait for ROADMAP.md item A9 (radius-graph fused path)")


class FlatTiling(NamedTuple):
    """Flattened (global-index) dense tiling bundle in slot order.

    `win` = (senders_local, tile_win, part_mask, ovf_senders, ovf_receivers,
    ovf_edge_feat) and `dense` = (r_tile, k), as in the JAX package; the
    forward reads every field but part_mask, which the backward needs."""

    senders: torch.Tensor
    receivers: torch.Tensor
    blocks: torch.Tensor
    edge_feat: torch.Tensor
    win: tuple
    node_block: int
    edge_tile: int
    dense: tuple


@dataclasses.dataclass
class GraphBatch:
    """Batched padded graphs. All tensors have the leading G axis."""

    node_feat: torch.Tensor        # [G, N, Dn] float32
    edge_feat: torch.Tensor        # [G, E, De] float32
    senders: torch.Tensor          # [G, E] int32
    receivers: torch.Tensor        # [G, E] int32
    node_mask: torch.Tensor        # [G, N] bool
    edge_mask: torch.Tensor        # [G, E] bool
    labels: torch.Tensor           # [G, N] int32
    boxes: torch.Tensor            # [G, N, B] float32 (NaN for background)
    pos: torch.Tensor              # [G, N, 2] float32
    vel: torch.Tensor              # [G, N, 2] float32

    # dense fixed-degree tiling (ops.dense_tiles), edge arrays already in
    # slot order; None when the batch was stacked without a tiling
    tiled_perm: Optional[torch.Tensor] = None        # [G, T*TE] int32
    tiled_receivers: Optional[torch.Tensor] = None   # [G, T*TE] int32, -1 pad
    tile_blocks: Optional[torch.Tensor] = None       # [G, T] int32 (local)
    tiled_senders: Optional[torch.Tensor] = None     # [G, T*TE] int32 (local)
    tiled_edge_feat: Optional[torch.Tensor] = None   # [G, T*TE, De] float32
    win_senders_local: Optional[torch.Tensor] = None  # [G, T*TE] int32, -1 pad
    tile_win: Optional[torch.Tensor] = None           # [G, T] int32 (local)
    win_part_mask: Optional[torch.Tensor] = None      # [G, WB, NBLK] bool
    ovf_senders: Optional[torch.Tensor] = None        # [G, Eo] int32 (local)
    ovf_receivers: Optional[torch.Tensor] = None      # [G, Eo] int32, -1 pad
    ovf_edge_feat: Optional[torch.Tensor] = None      # [G, Eo, De] float32

    # (node_block, edge_tile, None, ("dense", r_tile, k)) for a dense tiling
    tile_geometry: Optional[tuple] = None
    # number of valid edges, known on the host (for edges/s reporting)
    host_valid_edges: int = 0

    def tensors(self) -> Dict[str, torch.Tensor]:
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
                if isinstance(getattr(self, f.name), torch.Tensor)}

    def to(self, device: DeviceLike) -> "GraphBatch":
        """A copy of the batch with every tensor on `device`."""
        device = torch.device(device)
        return dataclasses.replace(
            self, **{k: v.to(device) for k, v in self.tensors().items()})

    @property
    def device(self) -> torch.device:
        return self.node_feat.device

    @property
    def num_graphs(self) -> int:
        return self.node_feat.shape[0]

    @property
    def max_nodes(self) -> int:
        return self.node_feat.shape[1]

    @property
    def max_edges(self) -> int:
        return self.senders.shape[1]

    # ---- flattened (block-diagonal) views --------------------------------
    def _offsets(self, per_graph: int) -> torch.Tensor:
        g = self.num_graphs
        return (torch.arange(g, dtype=torch.int32, device=self.device)
                * per_graph)[:, None]

    def flat_senders(self) -> torch.Tensor:
        """[G*E] senders with per-graph offsets — global node indices."""
        return (self.senders + self._offsets(self.max_nodes)).reshape(-1)

    def flat_receivers(self) -> torch.Tensor:
        return (self.receivers + self._offsets(self.max_nodes)).reshape(-1)

    def flat_nodes(self) -> torch.Tensor:
        return self.node_feat.reshape(-1, self.node_feat.shape[-1])

    def flat_edges(self) -> torch.Tensor:
        return self.edge_feat.reshape(-1, self.edge_feat.shape[-1])

    def flat_tiling(self) -> Optional[FlatTiling]:
        """Global flat dense tiling bundle (FlatTiling) in slot order, or None
        if the batch carries no tiling. Per-graph tilings concatenate because
        max_nodes is a multiple of node_block (global block id =
        g·(N/node_block) + local block id)."""
        if self.tiled_senders is None:
            return None
        geo = self.tile_geometry
        if geo is None or len(geo) < 4 or geo[3] is None \
                or geo[3][0] != "dense":
            raise NotImplementedError(_NOT_PORTED_TILING)
        node_block, edge_tile = geo[:2]
        r_tile, k = geo[3][1:]
        n = self.max_nodes
        if n % node_block:
            raise ValueError("max_nodes must align to node_block")
        n_off = self._offsets(n)
        b_off = self._offsets(n // node_block)
        senders = (self.tiled_senders + n_off).reshape(-1)
        recv = torch.where(self.tiled_receivers >= 0,
                           self.tiled_receivers + n_off, -1).reshape(-1)
        blocks = (self.tile_blocks + b_off).reshape(-1)
        edge_feat = self.tiled_edge_feat.reshape(
            -1, self.tiled_edge_feat.shape[-1])
        # senders_local are window-relative: no offset. part_mask
        # concatenates along the (global) block axis.
        sloc = self.win_senders_local.reshape(-1)
        t_win = (self.tile_win + b_off).reshape(-1)
        wb = self.win_part_mask.shape[1]
        pmask = self.win_part_mask.permute(1, 0, 2).reshape(wb, -1)
        ovf_mask = self.ovf_receivers >= 0
        ovf_s = torch.where(ovf_mask, self.ovf_senders + n_off, 0).reshape(-1)
        ovf_r = torch.where(ovf_mask, self.ovf_receivers + n_off,
                            -1).reshape(-1)
        ovf_e = self.ovf_edge_feat.reshape(-1, self.ovf_edge_feat.shape[-1])
        win = (sloc, t_win, pmask, ovf_s, ovf_r, ovf_e)
        return FlatTiling(senders, recv, blocks, edge_feat, win,
                          node_block, edge_tile, (r_tile, k))


@dataclasses.dataclass
class GraphSample:
    """One un-padded graph on the host (numpy); `pad_sample` +
    `stack_samples` turn lists of these into a GraphBatch."""

    node_feat: np.ndarray         # [n, Dn]
    edge_feat: np.ndarray         # [e, De]
    senders: np.ndarray           # [e]
    receivers: np.ndarray         # [e]
    labels: np.ndarray            # [n]
    boxes: np.ndarray             # [n, B]
    pos: np.ndarray               # [n, 2]
    vel: np.ndarray               # [n, 2]

    @property
    def num_nodes(self) -> int:
        return self.node_feat.shape[0]

    @property
    def num_edges(self) -> int:
        return self.senders.shape[0]


def morton_sort_sample(sample: GraphSample) -> GraphSample:
    """Reorders a sample's nodes along a Morton (Z-order) curve of their
    positions and remaps edge endpoints. Message passing is permutation
    invariant; this only improves index locality (the dense tiling's sender
    windows rely on it)."""
    perm = morton_order(sample.pos)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm), dtype=perm.dtype)
    return GraphSample(
        node_feat=sample.node_feat[perm], edge_feat=sample.edge_feat,
        senders=inv[sample.senders].astype(sample.senders.dtype),
        receivers=inv[sample.receivers].astype(sample.receivers.dtype),
        labels=sample.labels[perm], boxes=sample.boxes[perm],
        pos=sample.pos[perm], vel=sample.vel[perm])


def overflow_budget(max_edges: int, edge_tile: int,
                    frac: float = 0.08) -> int:
    """Static overflow-edge budget (the same for every sample of a bucket,
    so every batch has the same shapes)."""
    return max(edge_tile,
               -(-int(max_edges * frac) // edge_tile) * edge_tile)


def pad_sample(sample: GraphSample, max_nodes: int, max_edges: int,
               bg_index: int, sort_edges_by_receiver: bool = True,
               csr_tiling=None) -> dict:
    """Pads a GraphSample to (max_nodes, max_edges); returns a numpy dict.

    Padded nodes get label `bg_index` and NaN boxes; padded edges point at
    node max_nodes-1 and are masked out. With `sort_edges_by_receiver`
    edges are stably re-ordered by receiver (message passing is permutation
    invariant, so results are unchanged).

    `csr_tiling={"mode": "dense", "node_block", "r_tile", "k",
    "window_blocks", "ovf_frac"}` Morton-orders the nodes and adds the dense
    fixed-degree tiling and its overflow list (ops.dense_tiles).
    """
    dense_cfg = None
    if isinstance(csr_tiling, dict):
        if csr_tiling.get("mode") != "dense":
            raise ValueError(f"unknown tiling dict mode: {csr_tiling}")
        if csr_tiling.get("ovf_ssum", False):
            raise NotImplementedError(
                "the sender-sorted overflow tiling (ovf_ssum) feeds a "
                "training kernel that is not ported yet (ROADMAP.md, B3)")
        dense_cfg = dict(csr_tiling)
        sample = morton_sort_sample(sample)
    elif csr_tiling is not None:
        raise NotImplementedError(_NOT_PORTED_TILING)

    n, e = sample.num_nodes, sample.num_edges
    if n > max_nodes or e > max_edges:
        raise ValueError(f"sample ({n} nodes, {e} edges) exceeds bucket "
                         f"({max_nodes}, {max_edges})")

    s_senders, s_receivers, s_edge_feat = (
        sample.senders, sample.receivers, sample.edge_feat)
    if sort_edges_by_receiver and e:
        order = np.argsort(s_receivers, kind="stable")
        s_senders = s_senders[order]
        s_receivers = s_receivers[order]
        s_edge_feat = s_edge_feat[order]

    def pad_nodes(a, fill=0.0):
        out = np.full((max_nodes,) + a.shape[1:], fill, dtype=np.float32)
        out[:n] = a
        return out

    boxes = np.full((max_nodes, sample.boxes.shape[1]), np.nan, dtype=np.float32)
    boxes[:n] = sample.boxes

    labels = np.full((max_nodes,), bg_index, dtype=np.int32)
    labels[:n] = sample.labels

    senders = np.zeros((max_edges,), dtype=np.int32)
    receivers = np.full((max_edges,), max_nodes - 1, dtype=np.int32)
    senders[:e] = s_senders
    receivers[:e] = s_receivers

    node_mask = np.zeros((max_nodes,), dtype=bool)
    node_mask[:n] = True
    edge_mask = np.zeros((max_edges,), dtype=bool)
    edge_mask[:e] = True

    out = dict(
        node_feat=pad_nodes(sample.node_feat),
        edge_feat=np.concatenate([
            s_edge_feat.astype(np.float32),
            np.zeros((max_edges - e, sample.edge_feat.shape[1]), np.float32)],
            axis=0),
        senders=senders, receivers=receivers,
        node_mask=node_mask, edge_mask=edge_mask,
        labels=labels, boxes=boxes,
        pos=pad_nodes(sample.pos), vel=pad_nodes(sample.vel),
    )
    if dense_cfg is None:
        return out

    node_block = dense_cfg["node_block"]
    r_tile = dense_cfg["r_tile"]
    k = dense_cfg["k"]
    window_blocks = dense_cfg.get("window_blocks", 3)
    te = r_tile * k
    budget = overflow_budget(max_edges, te, dense_cfg.get("ovf_frac", 0.05))
    perm, senders_local, tile_win, ovf_idx = prepare_dense_knn_tiles(
        senders, receivers, edge_mask, max_nodes, k, r_tile,
        node_block, window_blocks, budget)
    nblocks = (max_nodes + node_block - 1) // node_block
    pmask = window_part_mask(tile_win, nblocks, window_blocks)
    ovf_valid = ovf_idx >= 0
    ovf_c = np.maximum(ovf_idx, 0)
    t = max_nodes // r_tile
    # the receiver of a slot is implicit in the layout; materialize it for
    # the validity mask of the slot-ordered edge features
    slot_recv = (np.repeat(np.arange(t), te) * r_tile
                 + np.tile(np.arange(te) % r_tile, t)).astype(np.int32)
    slot_recv = np.where(senders_local >= 0, slot_recv, -1)
    out.update(
        tiled_perm=perm, tiled_receivers=slot_recv,
        tile_blocks=((np.arange(t) * r_tile) // node_block).astype(np.int32),
        tiled_senders=senders[perm],
        tiled_edge_feat=out["edge_feat"][perm],
        win_senders_local=senders_local, tile_win=tile_win,
        win_part_mask=pmask,
        ovf_senders=np.where(ovf_valid, senders[ovf_c], 0).astype(np.int32),
        ovf_receivers=np.where(ovf_valid, receivers[ovf_c], -1
                               ).astype(np.int32),
        ovf_edge_feat=np.where(ovf_valid[:, None], out["edge_feat"][ovf_c],
                               0.0).astype(np.float32))
    check_overflow_sorted(out["ovf_receivers"], "prepare_dense_knn_tiles plan")
    return out


def stack_samples(samples: List[GraphSample], max_nodes: int, bg_index: int,
                  max_edges: Optional[int] = None,
                  sort_edges_by_receiver: bool = True,
                  csr_tiling=None, device: DeviceLike = None) -> GraphBatch:
    """Pads and stacks host samples into a GraphBatch on `device` (the CUDA
    card by default; raises when there is none and no device was given)."""
    device = resolve_device(device)
    if max_edges is None:
        max_edges = max(s.num_edges for s in samples)
    padded = [pad_sample(s, max_nodes, max_edges, bg_index,
                         sort_edges_by_receiver, csr_tiling)
              for s in samples]
    arrays = {k: np.stack([p[k] for p in padded]) for k in padded[0]}
    geometry = None
    if csr_tiling is not None:
        # edge_tile = r_tile*k slots; trailing ("dense", r_tile, k) marker
        # read by flat_tiling
        r_tile, kk = csr_tiling["r_tile"], csr_tiling["k"]
        geometry = (csr_tiling["node_block"], r_tile * kk, None,
                    ("dense", r_tile, kk))
    return GraphBatch(
        **{k: torch.from_numpy(v).to(device) for k, v in arrays.items()},
        tile_geometry=geometry,
        host_valid_edges=int(sum(s.num_edges for s in samples)))
