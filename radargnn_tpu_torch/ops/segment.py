"""Masked segment reductions for the unfused aggregation path.

Port of `radargnn_tpu/ops/segment.py` (`segment_sum`, `segment_count`,
`segment_max`, `segment_mean`, `segment_reduce`, `hoisted_segment_max`,
`gather_with_sorted_backward`) with the same semantics: empty segments (no
valid incoming edge) give 0 for every reduction, a non-empty max segment
gives its true max even when every message is negative (the masked-out
entries are filled with the same -inf sentinel before the reduction), and
mean divides by the valid-edge count. Index tensors may be int32; they are
widened at the call.

These are XLA in the JAX package, not Pallas kernels, so they stay plain
torch here. The sums go through `index_add_`, which is deterministic on
the card under `torch.use_deterministic_algorithms(True)` (a float
`scatter_add_` with atomics would not be), so a training run repeats bit
for bit.
"""

from __future__ import annotations

from typing import Optional

import torch

_NEG = float("-inf")


def _apply_mask(data: torch.Tensor, mask: Optional[torch.Tensor],
                fill: float) -> torch.Tensor:
    if mask is None:
        return data
    shape = mask.shape + (1,) * (data.ndim - mask.ndim)
    return torch.where(mask.reshape(shape), data,
                       torch.tensor(fill, dtype=data.dtype, device=data.device))


def segment_count(segment_ids: torch.Tensor, num_segments: int,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Number of (valid) edges per segment, int64 [num_segments]."""
    ones = torch.ones(segment_ids.shape, dtype=torch.int64,
                      device=segment_ids.device)
    if mask is not None:
        ones = torch.where(mask, ones, 0)
    out = torch.zeros(num_segments, dtype=torch.int64, device=segment_ids.device)
    return out.index_add_(0, segment_ids.long(), ones)


def _raw_segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                     num_segments: int) -> torch.Tensor:
    """Per-segment max over the leading axis; empty segments hold -inf."""
    out = torch.full((num_segments,) + data.shape[1:], _NEG,
                     dtype=data.dtype, device=data.device)
    idx = segment_ids.long().reshape((-1,) + (1,) * (data.ndim - 1))
    return out.scatter_reduce_(0, idx.expand_as(data), data, "amax",
                               include_self=True)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-segment max; empty segments -> 0."""
    out = _raw_segment_max(_apply_mask(data, mask, _NEG), segment_ids,
                           num_segments)
    has = segment_count(segment_ids, num_segments, mask) > 0
    shape = has.shape + (1,) * (out.ndim - has.ndim)
    return torch.where(has.reshape(shape), out, 0).to(data.dtype)


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-segment sum in data's dtype; empty segments -> 0."""
    out = torch.zeros((num_segments,) + data.shape[1:], dtype=data.dtype,
                      device=data.device)
    return out.index_add_(0, segment_ids.long(), _apply_mask(data, mask, 0.0))


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-segment mean over the valid edges; empty segments -> 0."""
    total = segment_sum(data, segment_ids, num_segments, mask)
    count = segment_count(segment_ids, num_segments, mask)
    count = count.reshape(count.shape + (1,) * (total.ndim - count.ndim))
    return torch.where(count > 0,
                       total / count.clamp(min=1).to(total.dtype), 0.0)


_REDUCERS = {
    "max": segment_max,
    "sum": segment_sum,
    "add": segment_sum,
    "mean": segment_mean,
}


def segment_reduce(reducer: str, data: torch.Tensor,
                   segment_ids: torch.Tensor, num_segments: int,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dispatch by reducer name ('max' | 'sum'/'add' | 'mean')."""
    try:
        fn = _REDUCERS[reducer]
    except KeyError:
        raise ValueError(f"Unknown aggregation '{reducer}'; "
                         f"expected one of {sorted(_REDUCERS)}") from None
    return fn(data, segment_ids, num_segments, mask)


class _GatherSortedBackward(torch.autograd.Function):
    """values[idx] whose backward is a segment sum over the sorted
    indices."""

    @staticmethod
    def forward(ctx, values, idx, order, idx_sorted):
        ctx.num_rows = values.shape[0]
        ctx.save_for_backward(order, idx_sorted)
        return values[idx.long()]

    @staticmethod
    def backward(ctx, g):
        order, idx_sorted = ctx.saved_tensors
        d_values = segment_sum(g[order.long()], idx_sorted, ctx.num_rows)
        return d_values, None, None, None


def gather_with_sorted_backward(values: torch.Tensor, idx: torch.Tensor,
                                order: torch.Tensor,
                                idx_sorted: torch.Tensor) -> torch.Tensor:
    """values[idx] whose backward sums g at the rows of `values` in the
    sorted order: `order` = argsort(idx), `idx_sorted` = idx[order], both
    computed once per batch. Gradients flow to `values` only."""
    return _GatherSortedBackward.apply(values, idx, order, idx_sorted)


def hoisted_segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                        num_segments: int, mask: Optional[torch.Tensor],
                        per_segment_offset: torch.Tensor) -> torch.Tensor:
    """Max aggregation with a per-segment additive term hoisted out of the
    reduction: out[n] = offset[n] + max_e(data_e) for non-empty segments, 0
    for empty ones; float32 result."""
    inner = _raw_segment_max(_apply_mask(data, mask, _NEG), segment_ids,
                             num_segments)
    has = segment_count(segment_ids, num_segments, mask) > 0
    return torch.where(has[:, None],
                       per_segment_offset + inner.to(torch.float32), 0.0)
