"""Halo-exchange edge partitioning: boundary senders over one all_to_all.

Port of `radargnn_tpu/parallel/halo.py`. A graph's nodes split into P
contiguous shards over the mesh `model` axis (Morton-ordered nodes keep the
shards spatially compact); each edge goes to its RECEIVER's shard, so the
segment reduction stays rank-local, and only the BOUNDARY sender features
(the halo) travel, with one all_to_all. The edges split on the host into
local-sender edges and remote-sender (halo) edges; the exchange is issued
first, then the local partial, which does not depend on it, then the halo
partial.

The plan (`HaloPlan`, `build_halo_plan`) is numpy, array for array the JAX
package's, static per bucket (fixed budgets) so every batch has one shape.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from radargnn_tpu_torch.parallel.comm import all_to_all
from radargnn_tpu_torch.parallel.mesh import Mesh


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class HaloPlan:
    """Static host-built partition plan for one padded graph bucket.

    P = number of shards, Ns = nodes per shard (num_nodes = P*Ns),
    El/Eh = per-shard local-/halo-edge budgets, B = per (owner, dest)
    halo-send budget."""
    num_shards: int
    nodes_per_shard: int
    # [P, P, B] owned-local node index each owner sends to each dest; -1 pad
    send_idx: np.ndarray
    # local-sender edges, per receiver shard: sender index is shard-local
    loc_senders: np.ndarray      # [P, El] int32, -1 pad
    loc_receivers: np.ndarray    # [P, El] int32 shard-local, -1 pad
    loc_edge_perm: np.ndarray    # [P, El] original edge index (gather), 0 pad
    # halo edges: sender index points into the received halo buffer [P*B]
    halo_senders: np.ndarray     # [P, Eh] int32, -1 pad
    halo_receivers: np.ndarray   # [P, Eh] int32 shard-local, -1 pad
    halo_edge_perm: np.ndarray   # [P, Eh] original edge index, 0 pad


def build_halo_plan(senders: np.ndarray, receivers: np.ndarray,
                    num_nodes: int, num_shards: int,
                    edge_mask: Optional[np.ndarray] = None,
                    pad_align: int = 8,
                    halo_b: Optional[int] = None,
                    loc_width: Optional[int] = None,
                    halo_width: Optional[int] = None) -> HaloPlan:
    """Partitions edges by receiver shard and plans the boundary exchange.

    Shard p owns nodes [p*Ns, (p+1)*Ns). `halo_b` / `loc_width` /
    `halo_width` override the derived per-(owner, dest) send budget and
    per-shard edge widths (dataset-wide maxima give every sample's plan one
    shape); an override below what the sample needs raises. O(E log E)
    vectorised numpy: one lexsorted unique over the boundary triples."""
    senders = np.asarray(senders)
    receivers = np.asarray(receivers)
    if edge_mask is None:
        edge_mask = np.ones(len(senders), bool)
    edge_mask = np.asarray(edge_mask) & (receivers >= 0)
    ns = _round_up(num_nodes, num_shards) // num_shards

    def p_of(n):
        return np.minimum(n // ns, num_shards - 1)

    r_shard = p_of(receivers)
    s_shard = p_of(senders)
    local = edge_mask & (r_shard == s_shard)
    remote = edge_mask & ~(r_shard == s_shard)

    # unique boundary (owner p, dest q, sender) triples, lexicographically
    # sorted: the rank within each (p, q) group is the sender's halo slot
    remote_idx = np.flatnonzero(remote)
    p_r = s_shard[remote_idx].astype(np.int64)
    q_r = r_shard[remote_idx].astype(np.int64)
    gid_e = p_r * num_shards + q_r
    key = gid_e * (num_nodes + 1) + senders[remote_idx]
    uniq_key, inv = np.unique(key, return_inverse=True)
    gid = uniq_key // (num_nodes + 1)
    u_send = uniq_key % (num_nodes + 1)
    starts = np.searchsorted(gid, np.arange(num_shards * num_shards))
    rank = np.arange(len(gid)) - starts[gid]
    counts = np.bincount(gid, minlength=num_shards * num_shards)
    b = int(counts.max()) if len(gid) else 1
    b = _round_up(max(b, 1), pad_align)
    if halo_b is not None:
        if halo_b < b:
            raise ValueError(f"halo_b override {halo_b} < required {b}")
        b = halo_b
    send_flat = np.full((num_shards * num_shards, b), -1, np.int64)
    send_flat[gid, rank] = u_send - (gid // num_shards) * ns   # owner-local
    send_idx = send_flat.reshape(num_shards, num_shards, b)
    # halo slot of each remote edge's sender on its dest: owner p's chunk
    # starts at p*b
    slot_of_edge = np.full(len(senders), -1, np.int64)
    slot_of_edge[remote_idx] = p_r * b + rank[inv]

    def pack(mask_per_shard, sender_map, width):
        counts = [int(m.sum()) for m in mask_per_shard]
        need = _round_up(max(counts + [1]), pad_align)
        if width is None:
            width = need
        elif width < need:
            raise ValueError(f"edge-width override {width} < required {need}")
        send = np.full((num_shards, width), -1, np.int64)
        recv = np.full((num_shards, width), -1, np.int64)
        perm = np.zeros((num_shards, width), np.int64)
        for q, m in enumerate(mask_per_shard):
            idx = np.flatnonzero(m)
            send[q, :len(idx)] = sender_map(q, idx)
            recv[q, :len(idx)] = receivers[idx] - q * ns
            perm[q, :len(idx)] = idx
        return send, recv, perm

    loc_s, loc_r, loc_p = pack(
        [local & (r_shard == q) for q in range(num_shards)],
        lambda q, idx: senders[idx] - q * ns, loc_width)
    halo_s, halo_r, halo_p = pack(
        [remote & (r_shard == q) for q in range(num_shards)],
        lambda q, idx: slot_of_edge[idx], halo_width)

    return HaloPlan(num_shards, ns, send_idx.astype(np.int32),
                    loc_s.astype(np.int32), loc_r.astype(np.int32),
                    loc_p.astype(np.int32),
                    halo_s.astype(np.int32), halo_r.astype(np.int32),
                    halo_p.astype(np.int32))


def exchange(x_own: torch.Tensor, send: torch.Tensor, group) -> torch.Tensor:
    """The halo exchange of one graph shard: x_own [Ns, D], send [P, B]
    (this owner's row per destination and slot, -1 pad) -> the received
    buffer [P, B, D], owner-major (owner p's chunk first for p = 0..P-1),
    zero at padding slots. Differentiable: the gradient of a received row
    returns to its owner and lands at its row."""
    outbound = torch.where((send >= 0)[..., None],
                           x_own[send.clamp(min=0).long()], 0.0)
    return all_to_all(outbound, group)


def _partial(reducer: str, xs: torch.Tensor, s: torch.Tensor,
             r: torch.Tensor, e: torch.Tensor, message_fn: Callable,
             ns: int) -> torch.Tensor:
    mask = r >= 0
    msg = message_fn(xs[s.clamp(min=0).long()], e)
    idx = r.clamp(min=0).long()[:, None].expand_as(msg)
    if reducer == "max":
        msg = torch.where(mask[:, None], msg, float("-inf"))
        out = torch.full((ns, msg.shape[1]), float("-inf"), dtype=msg.dtype,
                         device=msg.device)
        return out.scatter_reduce(0, idx, msg, "amax", include_self=True)
    msg = torch.where(mask[:, None], msg, 0.0)
    return torch.zeros((ns, msg.shape[1]), dtype=msg.dtype,
                       device=msg.device).index_add(0, idx[:, 0], msg)


def halo_segment_reduce(reducer: str, x_own: torch.Tensor,
                        message_fn: Callable[[torch.Tensor, torch.Tensor],
                                             torch.Tensor],
                        edge_feat: torch.Tensor, plan: HaloPlan, mesh: Mesh,
                        axis: str = "model") -> torch.Tensor:
    """out[n] = reduce over edges e->n of message_fn(x[sender(e)],
    edge_feat[e]) for this rank's node shard n (max or sum; empty max
    neighbourhoods give 0), the nodes and edges partitioned per `plan`
    over `axis` and the boundary features exchanged with one all_to_all.

    x_own [Ns, D] is this rank's node rows (shard `mesh.coord(axis)`);
    edge_feat [E, De] is in the original edge order (replicated; only the
    shard's edges are gathered). Returns [Ns, H]."""
    p = mesh.coord(axis)
    ns = plan.nodes_per_shard
    b = plan.send_idx.shape[-1]
    dev = x_own.device

    def arr(a):
        return torch.from_numpy(np.ascontiguousarray(a[p])).to(dev)

    send, loc_s, loc_r = arr(plan.send_idx), arr(plan.loc_senders), \
        arr(plan.loc_receivers)
    halo_s, halo_r = arr(plan.halo_senders), arr(plan.halo_receivers)
    e_loc = edge_feat[arr(plan.loc_edge_perm).long()]
    e_halo = edge_feat[arr(plan.halo_edge_perm).long()]
    # 1) the boundary exchange first; 2) the local partial, independent of
    # it; 3) the halo partial against the received buffer
    halo = exchange(x_own, send, mesh.group(axis))
    part_local = _partial(reducer, x_own, loc_s, loc_r, e_loc, message_fn,
                          ns)
    part_halo = _partial(reducer, halo.reshape(plan.num_shards * b, -1),
                         halo_s, halo_r, e_halo, message_fn, ns)
    if reducer == "max":
        out = torch.maximum(part_local, part_halo)
        return torch.where(out == float("-inf"), 0.0, out)
    return part_local + part_halo
