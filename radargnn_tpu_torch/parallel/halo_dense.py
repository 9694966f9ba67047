"""Halo edge partitioning composed with the dense fixed-degree aggregation.

Port of `radargnn_tpu/parallel/halo_dense.py`. Each rank gives its own
node shard a dense slot layout and routes the halo edges through the dense
aggregation's overflow list:

  * its received halo buffer is appended to its own node rows (`x_aug =
    [x_own ‖ halo ‖ 0]`, n_aug rows aligned to lcm(node_block, r_tile));
  * every shard-local receiver keeps `k` dense in-edge slots
    (`ops.dense_tiles.prepare_dense_knn_tiles` per shard over the
    augmented rows);
  * the halo edges, the over-degree spill and the out-of-window senders
    ride the overflow list, senders pointing into the augmented rows. That
    list is NOT receiver-sorted (the local spill first, then the halo
    edges), so it never goes through `check_overflow_sorted`; the port's
    overflow maxima (`scatter_reduce_` amax) do not depend on its order.

Per rank the dense aggregation runs unchanged (`ops.dense_aggregate`, B1's
projection and gather-max, B2 for the backward), over the rank's graphs
concatenated; the batch's sender landing for the backward is built per
rank over the augmented rows (`GraphBatch.rank_shard`), halo rows
included, so the d_x of a halo row flows back through the reverse
all_to_all to the rank that owns it. As in the JAX package the dense
routing is strict (`bf16_max` is accepted and ignored).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from radargnn_tpu_torch.ops.dense_aggregate import dense_aggregate
from radargnn_tpu_torch.ops.dense_tiles import (
    prepare_dense_knn_tiles, window_part_mask,
)
from radargnn_tpu_torch.parallel.comm import all_to_all
from radargnn_tpu_torch.parallel.halo import (
    HaloPlan, _round_up, build_halo_plan,
)


@dataclasses.dataclass(frozen=True)
class HaloDensePlan:
    """Static per-bucket plan: the halo exchange and per-shard dense
    tilings, every per-shard array of one shape. n_aug rows per shard (own
    nodes ‖ halo buffer ‖ pad), aligned to lcm(node_block, r_tile);
    overflow senders index the augmented rows. `k` is the SLOT count per
    receiver; tiles per shard t = n_aug // r_tile."""
    halo: HaloPlan
    node_block: int
    r_tile: int
    k: int
    window_blocks: int
    n_aug: int
    tile_win: np.ndarray       # [P, T]
    sloc: np.ndarray           # [P, T·TE] window-local sender, -1 dead slot
    slot_recv: np.ndarray      # [P, T·TE] shard-local receiver, -1 dead
    part_mask: np.ndarray      # [P, WB, NBLK]
    tile_eperm: np.ndarray     # [P, T·TE] into the ORIGINAL edge arrays
    ovf_s: np.ndarray          # [P, Eo] augmented-row sender
    ovf_r: np.ndarray          # [P, Eo] shard-local receiver, -1 pad
    ovf_eperm: np.ndarray      # [P, Eo] into the ORIGINAL edge arrays


def overflow_rows(hp: HaloPlan, p: int, ovf_idx: np.ndarray):
    """Shard p's overflow list: its local edges that missed the tiling
    (ovf_idx into its local arrays, -1 pad), then its halo edges, senders
    as augmented rows. Returns (ovf_s, ovf_r, ovf_eperm)."""
    ns = hp.nodes_per_shard
    ls, lr = hp.loc_senders[p], hp.loc_receivers[p]
    ov = ovf_idx >= 0
    ovc = np.maximum(ovf_idx, 0)
    o_s = np.where(ov, ls[ovc], 0)
    o_r = np.where(ov, lr[ovc], -1)
    o_e = np.where(ov, hp.loc_edge_perm[p][ovc], 0)
    hv = hp.halo_senders[p] >= 0
    h_s = np.where(hv, ns + np.maximum(hp.halo_senders[p], 0), 0)
    h_r = np.where(hv, hp.halo_receivers[p], -1)
    h_e = np.where(hv, hp.halo_edge_perm[p], 0)
    return (np.concatenate([o_s, h_s]), np.concatenate([o_r, h_r]),
            np.concatenate([o_e, h_e]))


def build_halo_dense_plan(senders: np.ndarray, receivers: np.ndarray,
                          num_nodes: int, num_shards: int, k: int,
                          r_tile: int = 64, node_block: int = 256,
                          window_blocks: int = 3,
                          edge_mask: Optional[np.ndarray] = None,
                          ovf_frac: float = 0.5,
                          pad_align: int = 8,
                          budgets: Optional[dict] = None) -> HaloDensePlan:
    """Plans the halo exchange and a dense fixed-degree tiling per shard.

    `k` is the slot count per receiver (kNN degree + extra slots).
    `ovf_frac` budgets the per-shard overflow (window overflow and
    over-degree spill; the halo edges come after it) relative to the
    local-edge budget. `budgets` (halo_b / loc_width / halo_width, from
    `plan_budgets_dense`) pins dataset-wide static shapes."""
    budgets = budgets or {}
    hp = build_halo_plan(senders, receivers, num_nodes, num_shards,
                         edge_mask, pad_align,
                         halo_b=budgets.get("halo_b"),
                         loc_width=budgets.get("loc_width"),
                         halo_width=budgets.get("halo_width"))
    p_n, ns = hp.num_shards, hp.nodes_per_shard
    b = hp.send_idx.shape[-1]
    align = int(np.lcm(node_block, r_tile))
    n_aug = _round_up(ns + p_n * b, align)
    nblocks = n_aug // node_block
    wb = min(window_blocks, nblocks)
    el = hp.loc_senders.shape[1]
    te = r_tile * k
    win_budget = max(te, _round_up(max(int(el * ovf_frac), 1), te))

    tile_win, sloc, slot_recv = [], [], []
    pmask, tile_eperm, ovf_s, ovf_r, ovf_eperm = [], [], [], [], []
    t = n_aug // r_tile
    recv_of_slot = (np.repeat(np.arange(t), te) * r_tile
                    + np.tile(np.arange(te) % r_tile, t)).astype(np.int64)
    for p in range(p_n):
        ls, lr = hp.loc_senders[p], hp.loc_receivers[p]
        mask = lr >= 0
        try:
            perm, psloc, twin, ovf_idx = prepare_dense_knn_tiles(
                np.maximum(ls, 0), np.maximum(lr, 0), mask, n_aug, k,
                r_tile, node_block, wb, ovf_budget=win_budget)
        except ValueError as e:
            raise ValueError(
                f"shard {p}/{p_n}: {e}. The halo overflow budget is "
                f"{win_budget} edges (= halo_overflow_fraction={ovf_frac} "
                f"of the {el}-edge local budget, tile-rounded); raise "
                f"halo_overflow_fraction in the MODEL_ARCHITECTURE config "
                f"(or add dense slots / widen window_blocks) and retry"
            ) from e
        tile_win.append(twin)
        sloc.append(psloc)
        slot_recv.append(np.where(psloc >= 0, recv_of_slot, -1))
        pmask.append(window_part_mask(twin, nblocks, wb))
        tile_eperm.append(hp.loc_edge_perm[p][perm])
        o_s, o_r, o_e = overflow_rows(hp, p, ovf_idx)
        ovf_s.append(o_s)
        ovf_r.append(o_r)
        ovf_eperm.append(o_e)

    return HaloDensePlan(
        hp, node_block, r_tile, k, wb, n_aug,
        np.stack(tile_win).astype(np.int32),
        np.stack(sloc).astype(np.int32),
        np.stack(slot_recv).astype(np.int32),
        np.stack(pmask),
        np.stack(tile_eperm).astype(np.int32),
        np.stack(ovf_s).astype(np.int32),
        np.stack(ovf_r).astype(np.int32),
        np.stack(ovf_eperm).astype(np.int32))


def plan_budgets_dense(plan: HaloDensePlan) -> dict:
    """Static-shape budgets (build_halo_dense_plan `budgets` format)."""
    return dict(halo_b=plan.halo.send_idx.shape[-1],
                loc_width=plan.halo.loc_senders.shape[1],
                halo_width=plan.halo.halo_senders.shape[1])


def augmented_rows(x: torch.Tensor, offset: torch.Tensor, bundle
                   ) -> tuple:
    """This rank's augmented node rows: per local graph its own rows, the
    halo buffer received over the model axis (one all_to_all for every
    graph), zero rows to n_aug; the offset padded alike. x [gl·Ns, D] and
    offset [gl·Ns, H] are the rank's shard-major rows. Returns (x_aug
    [gl·n_aug, D], off_aug [gl·n_aug, H])."""
    (_, _, _, n_aug, _, _, mp, ns, b) = bundle.geometry[:9]
    send = bundle.send_idx                         # [gl, P, B]
    gl = send.shape[0]
    d, h = x.shape[-1], offset.shape[-1]
    flat_idx = send.clamp(min=0).long() \
        + (torch.arange(gl, device=x.device) * ns)[:, None, None]
    outbound = torch.where((send >= 0)[..., None],
                           x[flat_idx.reshape(-1)].reshape(gl, mp, b, d),
                           0.0)
    # chunk q (destination q) leads for the exchange; the received buffer
    # is owner-major, matching the plan's halo slots
    group = bundle.mesh.group(bundle.axis) if bundle.mesh is not None \
        else None
    halo = all_to_all(outbound.transpose(0, 1), group).transpose(0, 1)
    x_aug = torch.cat([x.reshape(gl, ns, d), halo.reshape(gl, mp * b, d)],
                      dim=1)
    x_aug = torch.nn.functional.pad(x_aug, (0, 0, 0, n_aug - ns - mp * b))
    # the pad writes a new tensor, so a broadcast offset (RadarPointGNNConv's
    # bias, a stride-0 view) reaches the kernels as contiguous rows, and its
    # gradient comes back through the pad and the view's row sum
    off_aug = torch.nn.functional.pad(offset.reshape(gl, ns, h),
                                      (0, 0, 0, n_aug - ns))
    return x_aug.reshape(gl * n_aug, d), off_aug.reshape(gl * n_aug, h)


def local_overflow(bundle, n_aug: int):
    """The rank's overflow senders and receivers in its concatenated
    augmented rows (graph g's rows offset by g·n_aug)."""
    gl = bundle.ovf_s.shape[0]
    n_off = (torch.arange(gl, dtype=torch.int32,
                          device=bundle.ovf_s.device) * n_aug)[:, None]
    o_s = (bundle.ovf_s + n_off).reshape(-1)
    o_r = torch.where(bundle.ovf_r >= 0, bundle.ovf_r + n_off,
                      -1).reshape(-1)
    return o_s, o_r


def halo_dense_hoisted_max_batched(x: torch.Tensor, w_s: torch.Tensor,
                                   w_e: torch.Tensor, offset: torch.Tensor,
                                   bundle, bf16_max: bool = False
                                   ) -> torch.Tensor:
    """This rank's halo aggregation through the dense kernels:

        out[g, n] = offset[g, n] + max over edges e->n of graph g of
                    (x[g, send(e)] @ w_s + e_feat[e] @ w_e), 0 if no edges

    for its local graphs' node shard. x [gl·Ns, D] / offset [gl·Ns, H] are
    the rank's shard-major rows, `bundle` its HaloBundle
    (`GraphBatch.flat_halo`; geometry (node_block, TE, window_blocks,
    n_aug, -1, dp, mp, ns, halo_b, "dense", r_tile, k)). One all_to_all
    over the model axis for the boundary senders, then the dense
    aggregation over the concatenated augmented rows. Differentiable in x,
    w_s, w_e and offset; the weights' gradients are this rank's part (the
    trainer sums them over the ranks). Returns [gl·Ns, H]."""
    (node_block, _te, _wb, n_aug, _rp, _dp, _mp, ns, _b) = \
        bundle.geometry[:9]
    r_tile, k = bundle.geometry[10], bundle.geometry[11]
    gl = bundle.send_idx.shape[0]
    nblocks = n_aug // node_block
    h = w_s.shape[1]
    x_aug, off_aug = augmented_rows(x, offset, bundle)
    g_idx = torch.arange(gl, dtype=torch.int32, device=x.device)
    tw = (bundle.tile_win + (g_idx * nblocks)[:, None]).reshape(-1)
    sl = bundle.sloc.reshape(-1)                   # window-local: no offset
    et = bundle.e_t.reshape(-1, bundle.e_t.shape[-1])
    eo = bundle.e_ovf.reshape(-1, bundle.e_ovf.shape[-1])
    o_s, o_r = local_overflow(bundle, n_aug)
    out = dense_aggregate(x_aug, w_s, et, w_e, off_aug, eo, tw, sl, o_s, o_r,
                          r_tile=r_tile, k=k, node_block=node_block,
                          landing=bundle.landing, bf16_max=False)
    return out.reshape(gl, n_aug, h)[:, :ns].reshape(gl * ns, h)
