"""Host tiler of the dense fixed-degree aggregation (numpy).

Port of the host side of the dense family in
`radargnn_tpu/ops/pallas_kernels.py`: `morton_order`,
`_monotone_tile_windows`, `window_part_mask`, `prepare_dense_knn_tiles` and
`check_overflow_sorted`, unchanged, so the same graph gives the same slot
layout as the JAX package.

Slot layout: tile t covers receivers [t·R, (t+1)·R); receiver r's j-th
in-edge sits at slot t·TE + j·R + (r mod R), TE = R·K. A slot's sender is
`tile_win[t]·node_block + senders_local[slot]` (-1 marks an empty slot);
edges whose sender misses the tile's window, and a receiver's in-edges
beyond its first K, go to the fixed-budget overflow list.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def check_overflow_sorted(ovf_r, where: str) -> None:
    """Guards the receiver-sorted overflow contract: the valid overflow
    receivers (entries >= 0) must be non-decreasing. The tiler emits them
    sorted; this catches hand-built lists at plan build."""
    r = np.asarray(ovf_r)
    v = r[r >= 0]
    if v.size > 1 and np.any(np.diff(v) < 0):
        raise ValueError(
            f"{where}: overflow receivers must be non-decreasing over "
            "valid entries. Sort the overflow list by receiver.")


def morton_order(pos: np.ndarray, bits: int = 16) -> np.ndarray:
    """Spatial (Z-order) node permutation: argsort of interleaved-bit Morton
    codes of the 2D positions. Orders nodes so that kNN neighborhoods map to
    short contiguous index ranges (the sender windows' locality source)."""
    pos = np.asarray(pos, np.float64)
    if pos.shape[0] == 0:
        return np.zeros((0,), np.int32)
    lo = pos.min(axis=0)
    span = np.maximum(pos.max(axis=0) - lo, 1e-9)
    q = ((pos - lo) / span * ((1 << bits) - 1)).astype(np.uint64)

    def _part(v):
        v = v & np.uint64(0xFFFF)
        v = (v | (v << np.uint64(8))) & np.uint64(0x00FF00FF00FF00FF)
        v = (v | (v << np.uint64(4))) & np.uint64(0x0F0F0F0F0F0F0F0F)
        v = (v | (v << np.uint64(2))) & np.uint64(0x3333333333333333)
        v = (v | (v << np.uint64(1))) & np.uint64(0x5555555555555555)
        return v

    code = _part(q[:, 0]) | (_part(q[:, 1]) << np.uint64(1))
    return np.argsort(code, kind="stable").astype(np.int32)


def _monotone_tile_windows(hist: np.ndarray, wb: int) -> np.ndarray:
    """Optimal MONOTONE window-start sequence over the tile axis (DP).

    `hist [T, num_blocks]` holds per-tile sender-node-block counts; the
    returned `tile_win [T]` maximizes total in-window edges subject to
    window starts being non-decreasing (the backward's per-window d_x parts
    rely on it)."""
    t, num_blocks = hist.shape
    nmax = num_blocks - wb
    csum = np.concatenate(
        [np.zeros((t, 1), np.int64), np.cumsum(hist, axis=1)], axis=1)
    cover = csum[:, wb:] - csum[:, :-wb]          # [t, nmax+1]
    idx = np.arange(nmax + 1)
    dp = cover[0].astype(np.int64)
    back = np.zeros((t, nmax + 1), np.int32)
    back[0] = idx
    for i in range(1, t):
        pm = np.maximum.accumulate(dp)
        pmi = np.maximum.accumulate(np.where(dp == pm, idx, 0))
        dp = cover[i] + pm
        back[i] = pmi
    tile_win = np.empty(t, np.int64)
    w = int(np.argmax(dp))
    for i in range(t - 1, -1, -1):
        tile_win[i] = w
        w = int(back[i][w])
    return tile_win


def window_part_mask(tile_win: np.ndarray, num_blocks: int,
                     window_blocks: int) -> np.ndarray:
    """[WB, num_blocks] bool: which node blocks each backward d_x part
    writes (part j of a tile writes block tile_win+j)."""
    mask = np.zeros((window_blocks, num_blocks), bool)
    tw = np.unique(np.asarray(tile_win))
    for j in range(window_blocks):
        blocks = np.minimum(tw + j, num_blocks - 1)
        mask[j, blocks] = True
    return mask


def prepare_dense_knn_tiles(senders: np.ndarray, receivers: np.ndarray,
                            edge_mask: np.ndarray, num_nodes: int, k: int,
                            r_tile: int, node_block: int, window_blocks: int,
                            ovf_budget: Optional[int] = None):
    """Host tiler for the dense fixed-degree aggregation (module docstring).

    `k` is the SLOT count per receiver, not the graph's kNN degree: the
    reference aggregates at the kNN target side, so in-degree is variable
    (flagship: mean 20, max ~40), and edges beyond a receiver's first `k`
    spill to the overflow path like out-of-window senders.

    Returns (perm [T*TE], senders_local [T*TE], tile_win [T],
    ovf_idx [ovf_budget]): perm maps slots to edges (empty slots -> edge 0),
    ovf_idx lists overflow edges sorted by receiver (-1 pads), and the
    windows are monotone across tiles.
    """
    senders = np.asarray(senders)
    receivers = np.asarray(receivers)
    edge_mask = np.asarray(edge_mask)
    if num_nodes % r_tile:
        raise ValueError(f"num_nodes {num_nodes} not divisible by "
                         f"r_tile {r_tile}")
    te = r_tile * k
    t = num_nodes // r_tile
    num_blocks = -(-num_nodes // node_block)
    wb = min(window_blocks, num_blocks)

    valid = edge_mask & (receivers >= 0) & (receivers < num_nodes)
    eidx = np.flatnonzero(valid)
    r_v = receivers[eidx]
    order = np.argsort(r_v, kind="stable")
    eidx = eidx[order]
    r_v = r_v[order]
    deg = np.bincount(r_v, minlength=num_nodes)
    starts = np.cumsum(deg) - deg
    j = np.arange(len(eidx)) - starts[r_v]
    keep = j < k
    spill = eidx[~keep]
    slot = ((r_v // r_tile) * te + j * r_tile + (r_v % r_tile))[keep]

    perm = np.zeros(t * te, np.int64)
    sender_of_slot = np.full(t * te, -1, np.int64)
    perm[slot] = eidx[keep]
    sender_of_slot[slot] = senders[eidx[keep]]

    vslot = sender_of_slot >= 0
    hist = np.zeros((t, num_blocks), np.int64)
    tile_of_slot = np.repeat(np.arange(t), te)
    np.add.at(hist, (tile_of_slot[vslot], sender_of_slot[vslot] // node_block), 1)
    tile_win = _monotone_tile_windows(hist, wb)

    win_start = np.repeat(tile_win, te) * node_block
    in_win = vslot & (sender_of_slot >= win_start) \
        & (sender_of_slot < win_start + wb * node_block)
    ovf = np.concatenate([perm[vslot & ~in_win], spill])
    if ovf_budget is None:
        ovf_budget = max(te, -(-int(valid.sum() * 0.08) // te) * te)
    if len(ovf) > ovf_budget:
        raise ValueError(f"window overflow {len(ovf)} exceeds budget "
                         f"{ovf_budget}; increase window_blocks or budget")
    ovf = ovf[np.argsort(receivers[ovf], kind="stable")]
    ovf_idx = np.full(ovf_budget, -1, np.int64)
    ovf_idx[:len(ovf)] = ovf
    senders_local = np.where(in_win, sender_of_slot - win_start, -1)

    return (perm.astype(np.int32), senders_local.astype(np.int32),
            tile_win.astype(np.int32), ovf_idx.astype(np.int32))
