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

The port builds the plain layout, the dense fixed-degree tiling of kNN
graphs (`csr_tiling={"mode": "dense", ...}`), the windowed tiling that
radius graphs need (`csr_tiling=(node_block, edge_tile, window_blocks[,
ovf_frac[, run_cap]])`, `ops.windowed_tiles`) and the CSR tiling of
`fused_tiling: "csr"` (`csr_tiling=(node_block, edge_tile)`: receiver-CSR
tiles without a Morton order, and a second, sender-sorted tiling of the
same slots, `ssum_*`); halo partitioning is not ported yet (ROADMAP.md).

With a tiling the batch also carries its sender landing (`sender_landing`,
an `ops.segment_sum.SenderLanding` in the flat global layout): every valid
slot and overflow row grouped by sender, built once per batch on the host
(for the CSR tiling, read off its sender-sorted tiling). The fused
backward lands d_x through it in one deterministic segment sum, for all
conv layers. `win_part_mask`, which the TPU backward needs to
combine its window parts, is then unused by the port; it is kept so the
batch stays array-for-array the JAX package's.
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
from radargnn_tpu_torch.ops.segment_sum import (
    SenderLanding, csr_landing, sender_landing,
)
from radargnn_tpu_torch.ops.windowed_tiles import (
    prepare_csr_tiles, prepare_windowed_csr_tiles,
)


class FlatTiling(NamedTuple):
    """Flattened (global-index) tiling bundle in slot order.

    `win` = (senders_local, tile_win, part_mask, ovf_senders, ovf_receivers,
    ovf_edge_feat), None for the CSR tiling; `dense` = (r_tile, k) for the
    dense layout and None otherwise; `roll_passes` the windowed layout's
    static bound (2**roll_passes >= the longest same-receiver run in a
    tile); `ssum` = (ssum_perm, ssum_senders, ssum_blocks), the CSR
    tiling's sender-sorted second tiling, as in the JAX package. The port
    reads every field of `win` but part_mask; its kernels need no roll
    bound, and the CSR backward reads `ssum` through `landing`, the batch's
    sender landing for the backward (module docstring)."""

    senders: torch.Tensor
    receivers: torch.Tensor
    blocks: torch.Tensor
    edge_feat: torch.Tensor
    win: tuple
    node_block: int
    edge_tile: int
    dense: Optional[tuple] = None
    landing: Optional[SenderLanding] = None
    roll_passes: Optional[int] = None
    ssum: Optional[tuple] = None


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

    # dense (ops.dense_tiles), windowed or CSR (ops.windowed_tiles) tiling,
    # edge arrays already in slot order; None when stacked without a tiling
    tiled_perm: Optional[torch.Tensor] = None        # [G, T*TE] int32
    tiled_receivers: Optional[torch.Tensor] = None   # [G, T*TE] int32, -1 pad
    tile_blocks: Optional[torch.Tensor] = None       # [G, T] int32 (local)
    tiled_senders: Optional[torch.Tensor] = None     # [G, T*TE] int32 (local)
    tiled_edge_feat: Optional[torch.Tensor] = None   # [G, T*TE, De] float32
    # the CSR tiling's sender-sorted second tiling over the slots above:
    # slot index per sender-sorted slot, its sender (-1 pad), tile blocks
    ssum_perm: Optional[torch.Tensor] = None          # [G, E_s] int32
    ssum_senders: Optional[torch.Tensor] = None       # [G, E_s] int32
    ssum_blocks: Optional[torch.Tensor] = None        # [G, T_s] int32 (local)
    win_senders_local: Optional[torch.Tensor] = None  # [G, T*TE] int32, -1 pad
    tile_win: Optional[torch.Tensor] = None           # [G, T] int32 (local)
    win_part_mask: Optional[torch.Tensor] = None      # [G, WB, NBLK] bool
    ovf_senders: Optional[torch.Tensor] = None        # [G, Eo] int32 (local)
    ovf_receivers: Optional[torch.Tensor] = None      # [G, Eo] int32, -1 pad
    ovf_edge_feat: Optional[torch.Tensor] = None      # [G, Eo, De] float32

    # (node_block, edge_tile, None, ("dense", r_tile, k)) for a dense
    # tiling, (node_block, edge_tile, roll_passes) for a windowed one,
    # (node_block, edge_tile) for the CSR one
    tile_geometry: Optional[tuple] = None
    # the fused backward's d_x landing (flat global layout), with a tiling
    sender_landing: Optional[SenderLanding] = None
    # number of valid edges, known on the host (for edges/s reporting)
    host_valid_edges: int = 0

    def tensors(self) -> Dict[str, torch.Tensor]:
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
                if isinstance(getattr(self, f.name), torch.Tensor)}

    def to(self, device: DeviceLike) -> "GraphBatch":
        """A copy of the batch with every tensor on `device`."""
        device = torch.device(device)
        landing = self.sender_landing
        if landing is not None:
            landing = SenderLanding(*(t.to(device) for t in landing))
        return dataclasses.replace(
            self, sender_landing=landing,
            **{k: v.to(device) for k, v in self.tensors().items()})

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
        """Global flat tiling bundle (FlatTiling) in slot order, or None if
        the batch carries no tiling. Per-graph tilings concatenate because
        max_nodes is a multiple of node_block (global block id =
        g·(N/node_block) + local block id)."""
        if self.tiled_senders is None:
            return None
        geo = self.tile_geometry
        node_block, edge_tile = geo[:2]
        roll_passes = geo[2] if len(geo) > 2 else None
        dense = tuple(geo[3][1:]) if len(geo) > 3 and geo[3] is not None \
            and geo[3][0] == "dense" else None
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
        if self.win_senders_local is None:
            # the CSR tiling: the sender-sorted perm indexes this graph's
            # slots, so it offsets by the slots per graph
            e_off = self._offsets(self.tiled_senders.shape[1])
            ssum = ((self.ssum_perm + e_off).reshape(-1),
                    torch.where(self.ssum_senders >= 0,
                                self.ssum_senders + n_off, -1).reshape(-1),
                    (self.ssum_blocks + b_off).reshape(-1))
            return FlatTiling(senders, recv, blocks, edge_feat, None,
                              node_block, edge_tile, None,
                              self.sender_landing, roll_passes, ssum)
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
                          node_block, edge_tile, dense,
                          self.sender_landing, roll_passes)


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


def roll_passes_bound(samples: List[GraphSample], edge_tile: int) -> int:
    """Static bound on the TPU kernels' segmented-max log-roll passes for a
    windowed batch of contiguous runs: 2**passes >= the largest in-degree,
    which bounds the longest same-receiver run in a tile."""
    max_deg = 1
    for s in samples:
        if s.num_edges:
            max_deg = max(max_deg,
                          int(np.bincount(s.receivers,
                                          minlength=s.num_nodes).max()))
    full = int(np.ceil(np.log2(edge_tile)))
    return min(full, max(1, int(np.ceil(np.log2(max_deg)))))


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
    fixed-degree tiling and its overflow list (ops.dense_tiles);
    `csr_tiling=(node_block, edge_tile, window_blocks[, ovf_frac[,
    run_cap]])` Morton-orders them and adds the windowed tiling and its
    overflow list (ops.windowed_tiles); `csr_tiling=(node_block,
    edge_tile)` keeps the node order and adds the CSR tiling and its
    sender-sorted second tiling (`_csr_tiling`).
    """
    dense_cfg = windowed = csr = None
    if isinstance(csr_tiling, dict):
        if csr_tiling.get("mode") != "dense":
            raise ValueError(f"unknown tiling dict mode: {csr_tiling}")
        if csr_tiling.get("ovf_ssum", False):
            raise NotImplementedError(
                "the sender-sorted overflow tiling (ovf_ssum) feeds a "
                "training kernel that is not ported yet (ROADMAP.md, B3)")
        dense_cfg = dict(csr_tiling)
        sample = morton_sort_sample(sample)
    elif csr_tiling is not None and len(csr_tiling) >= 3:
        node_block, edge_tile, window_blocks = csr_tiling[:3]
        ovf_frac = csr_tiling[3] if len(csr_tiling) >= 4 else 0.08
        run_cap = csr_tiling[4] if len(csr_tiling) >= 5 else None
        windowed = (node_block, edge_tile, window_blocks, ovf_frac, run_cap)
        sample = morton_sort_sample(sample)
    elif csr_tiling is not None:
        if len(csr_tiling) != 2:
            raise ValueError(f"unknown csr_tiling {csr_tiling!r}")
        csr = tuple(csr_tiling)

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
    if windowed is not None:
        out.update(_windowed_tiling(out, senders, receivers, edge_mask,
                                    max_nodes, max_edges, *windowed))
        return out
    if csr is not None:
        out.update(_csr_tiling(out, senders, receivers, edge_mask,
                               max_nodes, max_edges, *csr))
        return out
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


def _windowed_tiling(out: dict, senders, receivers, edge_mask,
                     max_nodes: int, max_edges: int, node_block: int,
                     edge_tile: int, window_blocks: int, ovf_frac: float,
                     run_cap: Optional[int]) -> dict:
    """The windowed tiling's arrays of one padded sample (the JAX package's
    windowed branch of `pad_sample`): a static tile count and overflow
    budget per bucket, so every batch has the same shapes."""
    total_tiles = (max_edges + edge_tile - 1) // edge_tile \
        + (max_nodes + node_block - 1) // node_block
    budget = overflow_budget(max_edges, edge_tile, ovf_frac)
    (perm, tile_blocks, padded_recv, senders_local, tile_win,
     ovf_idx) = prepare_windowed_csr_tiles(
        senders, receivers, edge_mask, max_nodes, node_block, edge_tile,
        window_blocks, total_tiles, budget, run_cap=run_cap)
    nblocks = (max_nodes + node_block - 1) // node_block
    ovf_valid = ovf_idx >= 0
    ovf_c = np.maximum(ovf_idx, 0)
    tiled = dict(
        tiled_perm=perm, tiled_receivers=padded_recv,
        tile_blocks=tile_blocks, tiled_senders=senders[perm],
        tiled_edge_feat=out["edge_feat"][perm],
        win_senders_local=senders_local, tile_win=tile_win,
        win_part_mask=window_part_mask(tile_win, nblocks, window_blocks),
        ovf_senders=np.where(ovf_valid, senders[ovf_c], 0).astype(np.int32),
        ovf_receivers=np.where(ovf_valid, receivers[ovf_c], -1
                               ).astype(np.int32),
        ovf_edge_feat=np.where(ovf_valid[:, None], out["edge_feat"][ovf_c],
                               0.0).astype(np.float32))
    check_overflow_sorted(tiled["ovf_receivers"],
                          "prepare_windowed_csr_tiles plan")
    return tiled


def _csr_tiling(out: dict, senders, receivers, edge_mask, max_nodes: int,
                max_edges: int, node_block: int, edge_tile: int) -> dict:
    """The CSR tiling's arrays of one padded sample (the JAX package's CSR
    branch of `pad_sample`): receiver-CSR tiles of every valid edge under a
    static tile budget, and a second pass of the same tiler over the tiled
    senders, which sorts the valid slots by sender for the backward's d_x
    landing (its perm indexes the receiver tiles' slots)."""
    total_tiles = (max_edges + edge_tile - 1) // edge_tile \
        + (max_nodes + node_block - 1) // node_block
    perm, tile_blocks, padded_recv = prepare_csr_tiles(
        receivers, edge_mask, max_nodes, node_block, edge_tile, total_tiles)
    tiled_senders = senders[perm]
    s_perm, s_blocks, s_padded = prepare_csr_tiles(
        tiled_senders, padded_recv >= 0, max_nodes, node_block, edge_tile,
        total_tiles)
    return dict(tiled_perm=perm, tiled_receivers=padded_recv,
                tile_blocks=tile_blocks, tiled_senders=tiled_senders,
                tiled_edge_feat=out["edge_feat"][perm], ssum_perm=s_perm,
                ssum_senders=s_padded, ssum_blocks=s_blocks)


def stack_samples(samples: List[GraphSample], max_nodes: int, bg_index: int,
                  max_edges: Optional[int] = None,
                  sort_edges_by_receiver: bool = True,
                  csr_tiling=None, device: DeviceLike = None) -> GraphBatch:
    """Pads and stacks host samples into a GraphBatch on `device` (the CUDA
    card by default; raises when there is none and no device was given).
    A windowed batch records its roll bound as the JAX package does: log2
    of the run cap under spread tiling, else `roll_passes_bound` of these
    samples; a CSR batch records (node_block, edge_tile)."""
    device = resolve_device(device)
    if max_edges is None:
        max_edges = max(s.num_edges for s in samples)
    padded = [pad_sample(s, max_nodes, max_edges, bg_index,
                         sort_edges_by_receiver, csr_tiling)
              for s in samples]
    arrays = {k: np.stack([p[k] for p in padded]) for k in padded[0]}
    geometry = landing = None
    if isinstance(csr_tiling, dict):
        # edge_tile = r_tile*k slots; trailing ("dense", r_tile, k) marker
        # read by flat_tiling
        r_tile, kk = csr_tiling["r_tile"], csr_tiling["k"]
        node_block, slots = csr_tiling["node_block"], r_tile * kk
        geometry = (node_block, slots, None, ("dense", r_tile, kk))
    elif csr_tiling is not None and len(csr_tiling) == 2:
        node_block, slots = csr_tiling
        geometry = (node_block, slots)
    elif csr_tiling is not None:
        node_block, slots = csr_tiling[:2]
        if len(csr_tiling) >= 5 and csr_tiling[4] is not None:
            # spread tiling caps the runs by construction
            roll_passes = (int(csr_tiling[4]) - 1).bit_length()
        else:
            roll_passes = roll_passes_bound(samples, slots)
        geometry = (node_block, slots, roll_passes)
    if csr_tiling is not None:
        landing = SenderLanding(*(
            torch.from_numpy(a).to(device) for a in _flat_sender_landing(
                arrays, max_nodes, node_block, slots)))
    return GraphBatch(
        **{k: torch.from_numpy(v).to(device) for k, v in arrays.items()},
        tile_geometry=geometry, sender_landing=landing,
        host_valid_edges=int(sum(s.num_edges for s in samples)))


def _flat_sender_landing(arrays: dict, max_nodes: int, node_block: int,
                         slots_per_tile: int):
    """The sender landing of stacked tiled arrays, in the global layout
    `GraphBatch.flat_tiling` gives them (graph g's nodes and blocks offset
    by g; for the CSR tiling its slots too)."""
    g = arrays["tiled_senders"].shape[0]
    graph = np.arange(g, dtype=np.int64)[:, None]
    if "ssum_perm" in arrays:
        send = arrays["ssum_senders"]
        return csr_landing(
            (arrays["ssum_perm"]
             + graph * arrays["tiled_senders"].shape[1]).reshape(-1),
            np.where(send >= 0, send + graph * max_nodes, -1).reshape(-1),
            g * max_nodes)
    tile_win = arrays["tile_win"] + graph * (max_nodes // node_block)
    ovf_valid = arrays["ovf_receivers"] >= 0
    return sender_landing(
        arrays["win_senders_local"].reshape(-1), tile_win.reshape(-1),
        (arrays["ovf_senders"] + graph * max_nodes).reshape(-1),
        ovf_valid.reshape(-1), slots_per_tile=slots_per_tile,
        node_block=node_block, num_nodes=g * max_nodes)
