"""Masked segment max for the unfused aggregation path.

Port of `segment_max` / `hoisted_segment_max` of `radargnn_tpu/ops/segment.py`
with the same semantics: empty segments (no valid incoming edge) give 0, a
non-empty segment gives its true max even when every message is negative,
and the masked-out entries are filled with the same -inf sentinel before
the reduction. Index tensors may be int32; they are widened at the call.
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
