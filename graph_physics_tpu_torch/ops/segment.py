"""Mask-aware segment ops (counterpart of graph_physics_tpu/ops/segment.py).

Padded edges carry ``edge_mask`` False and point at node N-1; their values
are zeroed (-inf for the max) before the scatter so the stray writes
contribute nothing.
"""

from __future__ import annotations

from typing import Optional

import torch


def _bcast(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (like.ndim - mask.ndim))


def segment_sum(
    values: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """out[i] = sum of values[e] over edges e with segment_ids[e] == i and mask[e]."""
    if mask is not None:
        values = torch.where(_bcast(mask, values), values,
                             torch.zeros((), dtype=values.dtype, device=values.device))
    out = values.new_zeros((num_segments,) + tuple(values.shape[1:]))
    return out.index_add_(0, segment_ids, values)


def segment_max(
    values: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Masked segment max: masked lanes and empty segments are -inf
    (segment.py:segment_max)."""
    if mask is not None:
        values = torch.where(_bcast(mask, values), values,
                             torch.full((), -float("inf"), dtype=values.dtype,
                                        device=values.device))
    idx = segment_ids.long().reshape((-1,) + (1,) * (values.ndim - 1)).expand_as(values)
    out = values.new_full((num_segments,) + tuple(values.shape[1:]), -float("inf"))
    return out.scatter_reduce_(0, idx, values, reduce="amax", include_self=True)


def segment_softmax(
    logits: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Softmax over each segment's edges, masked lanes -> 0
    (segment.py:segment_softmax): the shift is the segment max (0 for an
    empty segment), taken without gradient; the denominator is clamped at
    the dtype's smallest normal number."""
    seg_max = segment_max(logits, segment_ids, num_segments, mask)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, torch.zeros_like(seg_max))
    shifted = logits - seg_max.detach().index_select(0, segment_ids)
    exp = torch.exp(shifted)
    if mask is not None:
        exp = torch.where(_bcast(mask, exp), exp, torch.zeros_like(exp))
    denom = segment_sum(exp, segment_ids, num_segments)
    denom = torch.clamp(denom, min=torch.finfo(exp.dtype).tiny)
    return exp / denom.index_select(0, segment_ids)
