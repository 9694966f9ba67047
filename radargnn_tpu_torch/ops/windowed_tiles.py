"""Host tilers of the windowed (CSR-tiled) aggregation (numpy).

Port of the host side of the windowed family in
`radargnn_tpu/ops/pallas_kernels.py`: `prepare_csr_tiles`,
`_spread_place_vectorized`, `prepare_spread_csr_tiles`, `tile_roll_passes`
and `prepare_windowed_csr_tiles`, unchanged, so the same graph gives the
same tile layout as the JAX package. `morton_order`,
`_monotone_tile_windows`, `window_part_mask` and `check_overflow_sorted`
are shared with the dense tiler (`ops.dense_tiles`).

Layout. Edges are sorted by receiver and cut into tiles of `edge_tile`
slots; every tile belongs to one node block of `node_block` receivers
(`tile_blocks`, non-decreasing), and each block has at least one tile.
Slot i holds edge `perm[i]` with receiver `padded_recv[i]` (-1 marks an
empty slot) and sender `tile_win[i // edge_tile] * node_block +
senders_local[i]`. Within a tile the occupied slots come first, sorted by
receiver, so a receiver's slots form one contiguous run per tile; a
receiver may have runs in several tiles of its block. Edges whose sender
misses the tile's window go to the fixed-budget overflow list.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from radargnn_tpu_torch.ops.dense_tiles import _monotone_tile_windows


def prepare_csr_tiles(receivers: np.ndarray, edge_mask: np.ndarray,
                      num_nodes: int, node_block: int, edge_tile: int,
                      total_tiles: Optional[int] = None
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sorts edges by receiver and pads each node block's edge run to a
    multiple of `edge_tile` (a block without edges gets one dummy tile).

    Returns (perm [E_pad], tile_node_block [T], padded_receivers [E_pad]):
    dummy slots map to edge 0 and carry receiver -1. `total_tiles` pads to
    a static tile count with empty tiles of the last block."""
    receivers = np.asarray(receivers)
    edge_mask = np.asarray(edge_mask)
    # masked edges sort past every block (receiver num_nodes)
    key = np.where(edge_mask, receivers, num_nodes)
    order = np.argsort(key, kind="stable")
    sorted_recv = key[order]

    num_blocks = -(-num_nodes // node_block)
    perm_chunks = []
    recv_chunks = []
    tile_blocks = []
    for blk in range(num_blocks):
        lo = np.searchsorted(sorted_recv, blk * node_block, side="left")
        hi = np.searchsorted(sorted_recv, min((blk + 1) * node_block,
                                              num_nodes), side="left")
        run = order[lo:hi]
        pad = (-len(run)) % edge_tile
        if len(run) == 0:
            pad = edge_tile          # dummy tile so the block gets initialized
        perm_chunks.append(np.concatenate([run, np.zeros(pad, np.int64)]))
        recv_chunks.append(np.concatenate(
            [receivers[run], np.full(pad, -1, np.int64)]))
        tile_blocks.extend([blk] * ((len(run) + pad) // edge_tile))

    if not perm_chunks:
        perm_chunks = [np.zeros(edge_tile, np.int64)]
        recv_chunks = [np.full(edge_tile, -1, np.int64)]
        tile_blocks = [0]

    perm = np.concatenate(perm_chunks)
    padded_recv = np.concatenate(recv_chunks)

    if total_tiles is not None:
        cur = len(tile_blocks)
        if cur > total_tiles:
            raise ValueError(f"need {cur} tiles, budget {total_tiles}")
        extra = total_tiles - cur
        if extra:
            perm = np.concatenate([perm, np.zeros(extra * edge_tile, np.int64)])
            padded_recv = np.concatenate(
                [padded_recv, np.full(extra * edge_tile, -1, np.int64)])
            tile_blocks = list(tile_blocks) + [tile_blocks[-1]] * extra

    return (perm.astype(np.int32), np.asarray(tile_blocks, np.int32),
            padded_recv.astype(np.int32))


def _spread_place_vectorized(run, rr, bounds, degs, t, edge_tile, run_cap,
                             receivers):
    """Round-robin spread placement for one node block, or None when a tile
    would overfill (the caller then runs the greedy packer). Every tile
    holds at most `run_cap` edges of a receiver, as one contiguous run;
    chunks of a receiver that needs more than `t` tiles are returned as
    leftover edge ids for the overflow list."""
    n_ch = -(-degs // run_cap)                       # chunks per receiver
    r_count = len(degs)
    # rank receivers by descending chunk count (stable): heavy ones first
    rank = np.empty(r_count, np.int64)
    rank[np.argsort(-n_ch, kind="stable")] = np.arange(r_count)
    place_ch = np.minimum(n_ch, t)                   # placeable chunks
    tot = int(place_ch.sum())
    if tot == 0:
        return None
    rec = np.repeat(np.arange(r_count), place_ch)
    j = np.arange(tot) - np.repeat(np.cumsum(place_ch) - place_ch, place_ch)
    tile = (rank[rec] + j) % t
    size = np.minimum(run_cap, degs[rec] - j * run_cap)
    fill = np.bincount(tile, weights=size, minlength=t)
    if fill.max() > edge_tile:
        return None

    # leftover: chunks j >= t of over-degree receivers
    left = []
    for ri in np.flatnonzero(n_ch > t):
        a = bounds[ri] + t * run_cap
        left.append(run[a:bounds[ri + 1]])

    # order chunks by (tile, receiver): receiver-contiguous runs per tile
    order_c = np.lexsort((rr[bounds[rec]], tile))
    starts_e = (bounds[rec] + j * run_cap)[order_c]
    sizes_o = size[order_c].astype(np.int64)
    csum = np.cumsum(sizes_o) - sizes_o
    offs = np.repeat(starts_e, sizes_o) \
        + (np.arange(int(sizes_o.sum())) - np.repeat(csum, sizes_o))
    ids_all = run[offs]
    tile_of_edge = np.repeat(tile[order_c], sizes_o)  # non-decreasing
    te_counts = np.bincount(tile_of_edge, minlength=t).astype(np.int64)
    dst = np.repeat(np.arange(t) * edge_tile, te_counts) \
        + (np.arange(len(ids_all))
           - np.repeat(np.cumsum(te_counts) - te_counts, te_counts))
    out_ids = np.zeros(t * edge_tile, np.int64)
    out_recv = np.full(t * edge_tile, -1, np.int64)
    out_ids[dst] = ids_all
    out_recv[dst] = receivers[ids_all]
    return (list(out_ids.reshape(t, edge_tile)),
            list(out_recv.reshape(t, edge_tile)), left)


def prepare_spread_csr_tiles(receivers: np.ndarray, edge_mask: np.ndarray,
                             num_nodes: int, node_block: int, edge_tile: int,
                             run_cap: int,
                             total_tiles: Optional[int] = None):
    """Spread tiling: like prepare_csr_tiles, but each receiver's edges are
    spread over its node block's tiles so that no tile holds more than
    `run_cap` edges of one receiver (one contiguous chunk each). A block
    keeps ceil(block_edges / edge_tile) tiles; edges that cannot be placed
    under the cap are returned in `leftover` for the overflow list.

    Returns (perm, tile_node_block, padded_receivers, leftover_edge_idx)."""
    receivers = np.asarray(receivers)
    edge_mask = np.asarray(edge_mask)
    key = np.where(edge_mask, receivers, num_nodes)
    order = np.argsort(key, kind="stable")
    sorted_recv = key[order]

    num_blocks = -(-num_nodes // node_block)
    perm_chunks = []
    recv_chunks = []
    tile_blocks = []
    leftover = []
    for blk in range(num_blocks):
        lo = np.searchsorted(sorted_recv, blk * node_block, side="left")
        hi = np.searchsorted(sorted_recv, min((blk + 1) * node_block,
                                              num_nodes), side="left")
        run = order[lo:hi]                       # edge ids, receiver-sorted
        rr = sorted_recv[lo:hi]
        eb = len(run)
        t = max(1, -(-eb // edge_tile))
        if eb == 0:
            perm_chunks.append(np.zeros(edge_tile, np.int64))
            recv_chunks.append(np.full(edge_tile, -1, np.int64))
            tile_blocks.append(blk)
            continue
        # receiver runs within the block
        starts = np.flatnonzero(np.diff(rr, prepend=rr[0] - 1))
        bounds = np.append(starts, eb)
        degs = np.diff(bounds)

        placed = _spread_place_vectorized(run, rr, bounds, degs, t,
                                          edge_tile, run_cap, receivers)
        if placed is not None:
            p_chunks, r_chunks, left = placed
            perm_chunks.extend(p_chunks)
            recv_chunks.extend(r_chunks)
            tile_blocks.extend([blk] * t)
            leftover.extend(left)
            continue

        # greedy packer: receivers with the most chunks first, each chunk
        # into the emptiest tile that still has room
        fill = np.zeros(t, np.int64)
        tiles: list = [[] for _ in range(t)]     # (receiver, edge-id chunk)
        for ri in np.argsort(-degs, kind="stable"):
            a, b = bounds[ri], bounds[ri + 1]
            chunks = [run[c:min(c + run_cap, b)]
                      for c in range(a, b, run_cap)]
            used = 0
            for tid in np.argsort(fill, kind="stable"):
                if used >= len(chunks):
                    break
                c = chunks[used]
                if fill[tid] + len(c) <= edge_tile:
                    tiles[tid].append((rr[a], c))
                    fill[tid] += len(c)
                    used += 1
            leftover.extend(chunks[used:])
        for tid in range(t):
            tiles[tid].sort(key=lambda rc: rc[0])  # receiver-contiguous runs
            ids = (np.concatenate([c for _, c in tiles[tid]])
                   if tiles[tid] else np.zeros(0, np.int64))
            pad = edge_tile - len(ids)
            perm_chunks.append(np.concatenate([ids, np.zeros(pad, np.int64)]))
            recv_chunks.append(np.concatenate(
                [receivers[ids], np.full(pad, -1, np.int64)]))
            tile_blocks.append(blk)

    if not perm_chunks:
        # no node blocks at all (num_nodes == 0): one dummy tile of block 0
        perm_chunks = [np.zeros(edge_tile, np.int64)]
        recv_chunks = [np.full(edge_tile, -1, np.int64)]
        tile_blocks = [0]

    perm = np.concatenate(perm_chunks)
    padded_recv = np.concatenate(recv_chunks)
    if total_tiles is not None:
        cur = len(tile_blocks)
        if cur > total_tiles:
            raise ValueError(f"need {cur} tiles, budget {total_tiles}")
        extra = total_tiles - cur
        if extra:
            perm = np.concatenate([perm, np.zeros(extra * edge_tile,
                                                  np.int64)])
            padded_recv = np.concatenate(
                [padded_recv, np.full(extra * edge_tile, -1, np.int64)])
            tile_blocks = list(tile_blocks) + [tile_blocks[-1]] * extra
    left = (np.concatenate(leftover) if leftover
            else np.zeros(0, np.int64))
    return (perm.astype(np.int32), np.asarray(tile_blocks, np.int32),
            padded_recv.astype(np.int32), left.astype(np.int64))


def tile_roll_passes(padded_seg: np.ndarray, edge_tile: int) -> np.ndarray:
    """Per tile, ceil(log2(the longest run of one non-negative segment id)):
    the log-roll passes the TPU kernels' in-tile segmented max needs."""
    v = np.asarray(padded_seg).reshape(-1, edge_tile)
    t = v.shape[0]
    valid = v >= 0
    change = np.ones_like(v, dtype=bool)
    change[:, 1:] = v[:, 1:] != v[:, :-1]
    run_id = np.cumsum(change, axis=1)          # 1..edge_tile per row
    ids = np.arange(t)[:, None] * (edge_tile + 1) + run_id
    ids = np.where(valid, ids, 0)               # invalid slots -> global 0
    counts = np.bincount(ids.ravel(), minlength=t * (edge_tile + 1))
    counts = counts[: t * (edge_tile + 1)].reshape(t, edge_tile + 1)
    counts[:, 0] = 0                            # bucket 0 held invalid slots
    max_run = counts.max(axis=1)
    return np.ceil(np.log2(np.maximum(max_run, 1))).astype(np.int32)


def prepare_windowed_csr_tiles(senders: np.ndarray, receivers: np.ndarray,
                               edge_mask: np.ndarray, num_nodes: int,
                               node_block: int, edge_tile: int,
                               window_blocks: int,
                               total_tiles: Optional[int] = None,
                               ovf_budget: Optional[int] = None,
                               run_cap: Optional[int] = None):
    """Windowed CSR tiling (module docstring): tiles every valid edge by
    receiver (contiguous runs, or spread under `run_cap`), then picks for
    each tile the `window_blocks`-wide sender window that covers the most
    of its edges (monotone across tiles); edges outside it become empty
    slots and join the overflow list.

    Returns (perm, tile_blocks, padded_recv, senders_local, tile_win,
    ovf_idx): senders_local is the sender minus its tile's window start
    (-1 pads), tile_win the window start block per tile, ovf_idx the
    overflow edges sorted by receiver (-1 pads)."""
    senders = np.asarray(senders)
    receivers = np.asarray(receivers)
    edge_mask = np.asarray(edge_mask)
    num_blocks = -(-num_nodes // node_block)
    wb = min(window_blocks, num_blocks)

    spread_left = np.zeros(0, np.int64)
    if run_cap is not None:
        perm, tile_blocks, padded_recv, spread_left = \
            prepare_spread_csr_tiles(receivers, edge_mask, num_nodes,
                                     node_block, edge_tile, run_cap,
                                     total_tiles)
    else:
        perm, tile_blocks, padded_recv = prepare_csr_tiles(
            receivers, edge_mask, num_nodes, node_block, edge_tile,
            total_tiles)
    t = len(tile_blocks)
    valid = padded_recv >= 0
    sp = senders[perm]
    s_blk = np.where(valid, sp // node_block, 0)
    tile_ids = np.repeat(np.arange(t), edge_tile)
    hist = np.zeros((t, num_blocks), np.int64)
    np.add.at(hist, (tile_ids[valid], s_blk[valid]), 1)
    tile_win = _monotone_tile_windows(hist, wb)

    win_start_e = np.repeat(tile_win, edge_tile) * node_block
    in_win = valid & (sp >= win_start_e) \
        & (sp < win_start_e + wb * node_block)
    ovf_slots = valid & ~in_win
    ovf = np.concatenate([perm[ovf_slots], spread_left])

    if ovf_budget is None:
        ovf_budget = max(edge_tile,
                         -(-int(edge_mask.sum() * 0.08) // edge_tile)
                         * edge_tile)
    if len(ovf) > ovf_budget:
        raise ValueError(f"window overflow {len(ovf)} exceeds budget "
                         f"{ovf_budget}; increase window_blocks or budget")
    ovf = ovf[np.argsort(receivers[ovf], kind="stable")]
    ovf_idx = np.full(ovf_budget, -1, np.int64)
    ovf_idx[:len(ovf)] = ovf

    padded_recv = np.where(ovf_slots, -1, padded_recv)
    senders_local = np.where(in_win, sp - win_start_e, -1)

    # stable compaction of the in-window slots to the front of each tile:
    # a receiver's run stays contiguous and sorted
    slot_order = np.argsort(tile_ids * 2 + (~in_win), kind="stable")
    perm = perm[slot_order]
    padded_recv = padded_recv[slot_order]
    senders_local = senders_local[slot_order]

    return (perm, tile_blocks, padded_recv,
            senders_local.astype(np.int32), tile_win.astype(np.int32),
            ovf_idx.astype(np.int32))
