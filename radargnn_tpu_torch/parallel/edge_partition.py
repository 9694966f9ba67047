"""Edge-partitioned message passing over the mesh `model` axis.

Port of `radargnn_tpu/parallel/edge_partition.py`: each rank holds a shard
of the edge arrays and the full (replicated) node array, computes messages
and a local segment reduction over its shard, and the partial per-node
aggregates combine over the axis with one all-reduce: MAX for max
aggregation (idempotent, so nothing special happens at shard boundaries),
SUM for sum and mean, the counts always by SUM. Empty segments give 0.
Forward only, as the JAX package's tests use it.
"""

from __future__ import annotations

from typing import Callable

import torch

from radargnn_tpu_torch.parallel.comm import all_reduce_
from radargnn_tpu_torch.parallel.mesh import Mesh


def _local_partials(reducer: str, data: torch.Tensor,
                    segment_ids: torch.Tensor, num_segments: int,
                    mask: torch.Tensor):
    """Shard-local reduction with combinable partials (max keeps -inf for
    empty segments, so the cross-rank max is exact) and the counts."""
    ids = segment_ids.long()
    if reducer == "max":
        filled = torch.where(mask[:, None], data, float("-inf"))
        out = torch.full((num_segments, data.shape[1]), float("-inf"),
                         dtype=data.dtype, device=data.device)
        out = out.scatter_reduce(0, ids[:, None].expand_as(filled), filled,
                                 "amax", include_self=True)
    elif reducer in ("sum", "add", "mean"):
        filled = torch.where(mask[:, None], data, 0.0)
        out = torch.zeros((num_segments, data.shape[1]), dtype=data.dtype,
                          device=data.device).index_add_(0, ids, filled)
    else:
        raise ValueError(reducer)
    cnt = torch.zeros(num_segments, dtype=torch.int64,
                      device=data.device).index_add_(0, ids, mask.long())
    return out, cnt


def _combine(reducer: str, out: torch.Tensor, cnt: torch.Tensor, group,
             dtype: torch.dtype) -> torch.Tensor:
    all_reduce_(out, group, "max" if reducer == "max" else "sum")
    all_reduce_(cnt, group)
    if reducer == "mean":
        return torch.where(cnt[:, None] > 0,
                           out / cnt.clamp(min=1)[:, None].to(out.dtype), 0.0)
    return torch.where(cnt[:, None] > 0, out, 0.0).to(dtype)


def partitioned_segment_reduce(reducer: str, data: torch.Tensor,
                               segment_ids: torch.Tensor, num_segments: int,
                               mask: torch.Tensor, mesh: Mesh,
                               axis: str = "model") -> torch.Tensor:
    """Segment reduction with the edge axis sharded over `axis`.

    data [E_local, D], segment_ids [E_local], mask [E_local]: this rank's
    shard (the JAX package's P(axis) block); returns the replicated
    [num_segments, D] aggregate with `ops.segment.segment_reduce`'s
    semantics (empty segments -> 0)."""
    with torch.no_grad():
        out, cnt = _local_partials(reducer, data, segment_ids, num_segments,
                                   mask)
        return _combine(reducer, out, cnt, mesh.group(axis), data.dtype)


def edge_partitioned_aggregate(message_fn: Callable, reducer: str,
                               x: torch.Tensor, senders: torch.Tensor,
                               receivers: torch.Tensor,
                               edge_attr: torch.Tensor,
                               edge_mask: torch.Tensor, mesh: Mesh,
                               axis: str = "model") -> torch.Tensor:
    """Message and aggregation over this rank's edge shard.

    `message_fn(x_r, x_s, e) -> m` runs on the shard's edges, gathering
    both endpoints from the replicated node array `x` [N, D] (the
    all-gather analog of a halo exchange), then the local reduction and one
    combine over `axis`; returns the replicated [N, H] aggregate."""
    with torch.no_grad():
        msg = message_fn(x[receivers.long()], x[senders.long()], edge_attr)
        out, cnt = _local_partials(reducer, msg, receivers, x.shape[0],
                                   edge_mask)
        return _combine(reducer, out, cnt, mesh.group(axis), msg.dtype)
