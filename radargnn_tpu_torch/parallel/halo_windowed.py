"""Halo partitioning composed with the windowed aggregation, and the halo
bundle the layers take.

Port of `radargnn_tpu/parallel/halo_windowed.py`. `parallel.halo` ships the
boundary sender features with one all_to_all; here each rank's LOCAL
reduction is the windowed aggregation (`ops.windowed_aggregate`: B1's
projection, B4's gather-max and backward), through its overflow list:

  * each rank's received halo buffer is appended to its own node rows
    (`x_aug = [x_own ‖ halo ‖ 0]`, n_aug rows, a multiple of node_block);
  * the halo edges, and the local edges the sender windows miss, ride the
    overflow list with senders pointing into the augmented rows (not
    receiver-sorted, so it never meets `check_overflow_sorted`).

So the windowed kernels run unchanged per rank, the exchange stays one
all_to_all, and the gradients flow back through its transpose (the same
exchange of the gradient). The host plan (`build_halo_windowed_plan`) is
numpy, array for array the JAX package's, static per bucket (shared tile
and overflow budgets).

`HaloBundle` is a rank's part of a halo batch (`GraphBatch.flat_halo`),
and `halo_hoisted_max_batched` dispatches on its geometry's "dense" marker
to `parallel.halo_dense` or to the windowed path here.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from radargnn_tpu_torch.ops.dense_tiles import window_part_mask
from radargnn_tpu_torch.ops.segment_sum import SenderLanding, sender_landing
from radargnn_tpu_torch.ops.windowed_aggregate import windowed_aggregate
from radargnn_tpu_torch.ops.windowed_tiles import prepare_windowed_csr_tiles
from radargnn_tpu_torch.parallel.halo import (
    HaloPlan, _round_up, build_halo_plan,
)
from radargnn_tpu_torch.parallel.halo_dense import (
    augmented_rows, halo_dense_hoisted_max_batched, local_overflow,
    overflow_rows,
)
from radargnn_tpu_torch.parallel.mesh import Mesh


@dataclasses.dataclass(frozen=True)
class HaloWindowedPlan:
    """Static per-bucket plan: the halo exchange and per-shard windowed
    tilings, every per-shard array of one shape (common tile and overflow
    budgets). n_aug rows per shard: own nodes, then the received halo
    buffer, rounded up to the node block; overflow senders index them."""
    halo: HaloPlan
    node_block: int
    edge_tile: int
    window_blocks: int
    n_aug: int
    roll_passes: int
    tile_blocks: np.ndarray    # [P, T]
    tile_win: np.ndarray       # [P, T]
    recv_t: np.ndarray         # [P, T·TE] shard-local receiver, -1 pad
    sloc: np.ndarray           # [P, T·TE] window-local sender, -1 pad
    part_mask: np.ndarray      # [P, WB, NBLK]
    tile_eperm: np.ndarray     # [P, T·TE] into the ORIGINAL edge arrays
    ovf_s: np.ndarray          # [P, Eo] augmented-row sender
    ovf_r: np.ndarray          # [P, Eo] shard-local receiver, -1 pad
    ovf_eperm: np.ndarray      # [P, Eo] into the ORIGINAL edge arrays


def build_halo_windowed_plan(senders: np.ndarray, receivers: np.ndarray,
                             num_nodes: int, num_shards: int,
                             node_block: int = 16, edge_tile: int = 32,
                             window_blocks: int = 2,
                             edge_mask: Optional[np.ndarray] = None,
                             ovf_frac: float = 0.5,
                             pad_align: int = 8,
                             budgets: Optional[dict] = None,
                             run_cap: Optional[int] = None
                             ) -> HaloWindowedPlan:
    """Plans the halo exchange and a windowed tiling per shard.

    `ovf_frac` budgets the per-shard WINDOW overflow relative to the
    local-edge budget; the halo edges come after it. `budgets` (halo_b /
    loc_width / halo_width / tiles / roll_passes, from `plan_budgets`)
    gives every sample's plan one shape."""
    budgets = budgets or {}
    hp = build_halo_plan(senders, receivers, num_nodes, num_shards,
                         edge_mask, pad_align,
                         halo_b=budgets.get("halo_b"),
                         loc_width=budgets.get("loc_width"),
                         halo_width=budgets.get("halo_width"))
    p_n, ns = hp.num_shards, hp.nodes_per_shard
    b = hp.send_idx.shape[-1]
    n_aug = _round_up(ns + p_n * b, node_block)
    nblocks = n_aug // node_block
    el = hp.loc_senders.shape[1]
    win_budget = max(edge_tile, _round_up(max(int(el * ovf_frac), 1),
                                          edge_tile))

    # pass 1: per-shard tilings; the common tile budget and roll bound
    tmax = budgets.get("tiles", 1)
    rp = ((run_cap - 1).bit_length() if run_cap is not None
          else budgets.get("roll_passes", 1))
    for p in range(p_n):
        ls, lr = hp.loc_senders[p], hp.loc_receivers[p]
        mask = lr >= 0
        try:
            prep = prepare_windowed_csr_tiles(
                np.maximum(ls, 0), np.maximum(lr, 0), mask, n_aug,
                node_block, edge_tile, window_blocks, None, win_budget,
                run_cap=run_cap)
        except ValueError as e:
            raise ValueError(
                f"shard {p}/{p_n}: {e}. The halo window-overflow budget is "
                f"{win_budget} edges (= halo_overflow_fraction={ovf_frac} of "
                f"the {el}-edge local budget, tile-rounded); raise "
                f"halo_overflow_fraction in the MODEL_ARCHITECTURE config "
                f"(or widen window_blocks) and retry") from e
        tmax = max(tmax, len(prep[1]))
        if run_cap is None and mask.any():
            deg = int(np.bincount(lr[mask], minlength=ns).max())
            rp = max(rp, int(np.ceil(np.log2(max(2, deg)))))
    if "tiles" in budgets and tmax > budgets["tiles"]:
        raise ValueError(f"tile override {budgets['tiles']} < required {tmax}")

    # pass 2: re-tile with the shared budget so every shard's shapes match
    tile_blocks, tile_win, recv_t, sloc = [], [], [], []
    pmask, tile_eperm, ovf_s, ovf_r, ovf_eperm = [], [], [], [], []
    for p in range(p_n):
        ls, lr = hp.loc_senders[p], hp.loc_receivers[p]
        mask = lr >= 0
        (perm, blocks, precv, psloc, twin, ovf_idx) = \
            prepare_windowed_csr_tiles(
                np.maximum(ls, 0), np.maximum(lr, 0), mask, n_aug,
                node_block, edge_tile, window_blocks, tmax, win_budget,
                run_cap=run_cap)
        tile_blocks.append(blocks)
        tile_win.append(twin)
        recv_t.append(precv)
        sloc.append(psloc)
        pmask.append(window_part_mask(twin, nblocks,
                                      min(window_blocks, nblocks)))
        # tiled local edges -> original edge ids (dummy slots: edge 0,
        # receiver -1 keeps them dead)
        tile_eperm.append(hp.loc_edge_perm[p][perm])
        o_s, o_r, o_e = overflow_rows(hp, p, ovf_idx)
        ovf_s.append(o_s)
        ovf_r.append(o_r)
        ovf_eperm.append(o_e)

    return HaloWindowedPlan(
        hp, node_block, edge_tile, min(window_blocks, nblocks), n_aug, rp,
        np.stack(tile_blocks).astype(np.int32),
        np.stack(tile_win).astype(np.int32),
        np.stack(recv_t).astype(np.int32),
        np.stack(sloc).astype(np.int32),
        np.stack(pmask),
        np.stack(tile_eperm).astype(np.int32),
        np.stack(ovf_s).astype(np.int32),
        np.stack(ovf_r).astype(np.int32),
        np.stack(ovf_eperm).astype(np.int32))


def plan_budgets(plan: HaloWindowedPlan) -> dict:
    """Static-shape budgets of a plan, in `build_halo_windowed_plan`'s
    `budgets` format; merge across a dataset with `merge_budgets`."""
    return dict(halo_b=plan.halo.send_idx.shape[-1],
                loc_width=plan.halo.loc_senders.shape[1],
                halo_width=plan.halo.halo_senders.shape[1],
                tiles=plan.tile_blocks.shape[1],
                roll_passes=plan.roll_passes)


def merge_budgets(budgets_list: List[dict]) -> dict:
    return {k: max(b[k] for b in budgets_list) for k in budgets_list[0]}


def shard_major_nodes(a, num_graphs: int, max_nodes: int, dp: int, mp: int):
    """Permutes batched node arrays [G, N, ...] (numpy or torch) into
    shard-major flat order [(d, m, g_local, n_local), ...]: rank (d, m)'s
    rows are one contiguous block, its graphs' node shard m. A pure
    transpose; message passing and the masked losses and BatchNorm do not
    depend on node order."""
    gl, ns = num_graphs // dp, max_nodes // mp
    a4 = a.reshape((dp, gl, mp, ns) + tuple(a.shape[2:]))
    order = (0, 2, 1, 3) + tuple(range(4, a4.ndim))
    a4 = a4.transpose(order) if isinstance(a4, np.ndarray) \
        else a4.permute(order)
    return a4.reshape((num_graphs * max_nodes,) + tuple(a.shape[2:]))


def unshard_major_nodes(a, num_graphs: int, max_nodes: int, dp: int,
                        mp: int):
    """The inverse of `shard_major_nodes`: flat shard-major rows back to
    [G, N, ...]."""
    gl, ns = num_graphs // dp, max_nodes // mp
    a4 = a.reshape((dp, mp, gl, ns) + tuple(a.shape[1:]))
    order = (0, 2, 1, 3) + tuple(range(4, a4.ndim))
    a4 = a4.transpose(order) if isinstance(a4, np.ndarray) \
        else a4.permute(order)
    return a4.reshape((num_graphs, max_nodes) + tuple(a.shape[1:]))


def halo_landing(sloc: np.ndarray, tile_win: np.ndarray, ovf_s: np.ndarray,
                 ovf_r: np.ndarray, slots_per_tile: int, node_block: int,
                 n_aug: int) -> SenderLanding:
    """A rank's sender landing for the backward (numpy in, int32 tensors
    out) over its concatenated augmented rows: sloc [gl, T·TE], tile_win
    [gl, T], ovf_s / ovf_r [gl, Eo] of its local graphs, graph g's rows
    and blocks offset by g. Halo-row senders are included: their d_x
    returns to their owners through the reverse exchange."""
    gl = sloc.shape[0]
    graph = np.arange(gl, dtype=np.int64)[:, None]
    order, row_ptr = sender_landing(
        sloc.reshape(-1), (tile_win + graph * (n_aug // node_block)
                           ).reshape(-1),
        (ovf_s + graph * n_aug).reshape(-1), (ovf_r >= 0).reshape(-1),
        slots_per_tile=slots_per_tile, node_block=node_block,
        num_nodes=gl * n_aug)
    return SenderLanding(torch.from_numpy(order), torch.from_numpy(row_ptr))


@dataclasses.dataclass
class HaloBundle:
    """A rank's part of a halo-partitioned batch: its local graphs' plan
    arrays for its model shard (leading axis gl, the rank's graphs), the
    sender landing over its augmented rows, and the static geometry
    (node_block, edge_tile, window_blocks, n_aug, roll_passes, dp, mp,
    nodes_per_shard, halo_b[, "dense", r_tile, k]) and mesh. `axis` names
    the mesh axis the exchange runs over."""
    send_idx: torch.Tensor       # [gl, P, B]
    e_t: torch.Tensor            # [gl, T·TE, De] tile-ordered edge features
    e_ovf: torch.Tensor          # [gl, Eo, De]
    recv_t: torch.Tensor         # [gl, T·TE] shard-local receiver, -1 pad
    tile_blocks: torch.Tensor    # [gl, T]
    tile_win: torch.Tensor       # [gl, T]
    sloc: torch.Tensor           # [gl, T·TE] window-local sender, -1 pad
    part_mask: torch.Tensor      # [gl, WB, NBLK]
    ovf_s: torch.Tensor          # [gl, Eo] augmented-row sender
    ovf_r: torch.Tensor          # [gl, Eo] shard-local receiver, -1 pad
    landing: Optional[SenderLanding] = None
    geometry: tuple = None
    mesh: Optional[Mesh] = None
    axis: str = "model"

    @property
    def dense(self) -> bool:
        return len(self.geometry) > 9 and self.geometry[9] == "dense"

    def replace_edge_feat(self, e_t, e_ovf) -> "HaloBundle":
        return dataclasses.replace(self, e_t=e_t, e_ovf=e_ovf)


def halo_hoisted_max_batched(x: torch.Tensor, w_s: torch.Tensor,
                             w_e: torch.Tensor, offset: torch.Tensor,
                             bundle: HaloBundle,
                             bf16_max: bool = False) -> torch.Tensor:
    """Halo aggregation by the bundle's kernel family: dense when its
    geometry carries the "dense" marker (`parallel.halo_dense`, kNN
    graphs), windowed otherwise; the layers stay family-agnostic."""
    if bundle.dense:
        return halo_dense_hoisted_max_batched(x, w_s, w_e, offset, bundle,
                                              bf16_max)
    return halo_windowed_hoisted_max_batched(x, w_s, w_e, offset, bundle,
                                             bf16_max)


def halo_windowed_hoisted_max_batched(x: torch.Tensor, w_s: torch.Tensor,
                                      w_e: torch.Tensor,
                                      offset: torch.Tensor,
                                      bundle: HaloBundle,
                                      bf16_max: bool = False
                                      ) -> torch.Tensor:
    """This rank's halo aggregation through the windowed kernels:

        out[g, n] = offset[g, n] + max over edges e->n in graph g of
                    (x[g, send(e)] @ w_s + e_feat[e] @ w_e),  0 if no edges

    x [gl·Ns, D] / offset [gl·Ns, H]: the rank's shard-major rows. One
    all_to_all over the model axis for the boundary senders, then the
    windowed aggregation over the concatenated augmented rows (graph g's
    tiles, blocks and rows offset by g, so the tile blocks stay
    non-decreasing). Differentiable in x, w_s, w_e and offset (the weights'
    gradients are this rank's part). Returns [gl·Ns, H]."""
    (node_block, edge_tile, _wb, n_aug, _rp, _dp, _mp, ns, _b) = \
        bundle.geometry[:9]
    gl = bundle.send_idx.shape[0]
    nblocks = n_aug // node_block
    h = w_s.shape[1]
    x_aug, off_aug = augmented_rows(x, offset, bundle)
    g_idx = torch.arange(gl, dtype=torch.int32, device=x.device)
    tb = (bundle.tile_blocks + (g_idx * nblocks)[:, None]).reshape(-1)
    tw = (bundle.tile_win + (g_idx * nblocks)[:, None]).reshape(-1)
    n_off = (g_idx * n_aug)[:, None]
    rt = torch.where(bundle.recv_t >= 0, bundle.recv_t + n_off,
                     -1).reshape(-1)
    sl = bundle.sloc.reshape(-1)                   # window-local: no offset
    et = bundle.e_t.reshape(-1, bundle.e_t.shape[-1])
    eo = bundle.e_ovf.reshape(-1, bundle.e_ovf.shape[-1])
    o_s, o_r = local_overflow(bundle, n_aug)
    out = windowed_aggregate(x_aug, w_s, et, w_e, off_aug, eo, rt, tb, tw,
                             sl, o_s, o_r, node_block=node_block,
                             edge_tile=edge_tile, landing=bundle.landing,
                             bf16_max=bf16_max)
    return out.reshape(gl, n_aug, h)[:, :ns].reshape(gl * ns, h)


def plan_bundle(plan: HaloWindowedPlan, e_feat: torch.Tensor, mesh: Mesh,
                axis: str = "model") -> HaloBundle:
    """The HaloBundle of one graph's plan for this rank (its shard
    `mesh.coord(axis)`), the edge features gathered from e_feat [E, De] in
    the original edge order."""
    p = mesh.coord(axis)
    dev = e_feat.device

    def arr(a):
        return torch.from_numpy(np.ascontiguousarray(a[p:p + 1])).to(dev)

    hp = plan.halo
    valid = arr(plan.ovf_r) >= 0
    landing = halo_landing(plan.sloc[p:p + 1], plan.tile_win[p:p + 1],
                           plan.ovf_s[p:p + 1], plan.ovf_r[p:p + 1],
                           plan.edge_tile, plan.node_block, plan.n_aug)
    return HaloBundle(
        send_idx=arr(hp.send_idx), e_t=e_feat[arr(plan.tile_eperm).long()],
        e_ovf=torch.where(valid[..., None],
                          e_feat[arr(plan.ovf_eperm).long()], 0.0),
        recv_t=arr(plan.recv_t), tile_blocks=arr(plan.tile_blocks),
        tile_win=arr(plan.tile_win), sloc=arr(plan.sloc),
        part_mask=arr(plan.part_mask), ovf_s=arr(plan.ovf_s),
        ovf_r=arr(plan.ovf_r),
        landing=SenderLanding(*(t.to(dev) for t in landing)),
        geometry=(plan.node_block, plan.edge_tile, plan.window_blocks,
                  plan.n_aug, plan.roll_passes, 1, hp.num_shards,
                  hp.nodes_per_shard, hp.send_idx.shape[-1]),
        mesh=mesh, axis=axis)


def halo_windowed_hoisted_max(x: torch.Tensor, w_s: torch.Tensor,
                              e_feat: torch.Tensor, w_e: torch.Tensor,
                              offset: torch.Tensor, plan: HaloWindowedPlan,
                              mesh: Mesh, axis: str = "model"
                              ) -> torch.Tensor:
    """Sharded hoisted max aggregation of one graph through the windowed
    kernels:

        out[n] = offset[n] + max over edges e->n of (x[send(e)]@w_s + e@w_e)
                 for non-empty neighbourhoods, 0 otherwise

    for this rank's node shard: x [Ns, D] and offset [Ns, H] its rows,
    e_feat [E, De] in the original edge order (replicated; only the shard's
    slices are gathered). Differentiable in x, w_s, e_feat, w_e, offset.
    Returns [Ns, H]."""
    return halo_windowed_hoisted_max_batched(
        x, w_s, w_e, offset, plan_bundle(plan, e_feat, mesh, axis))
