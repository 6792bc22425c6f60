"""Mask-aware segment sum (counterpart of graph_physics_tpu/ops/segment.py).

Padded edges carry ``edge_mask`` False and point at node N-1; their values
are zeroed before the scatter so the stray writes contribute nothing.
"""

from __future__ import annotations

from typing import Optional

import torch


def segment_sum(
    values: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """out[i] = sum of values[e] over edges e with segment_ids[e] == i and mask[e]."""
    if mask is not None:
        m = mask.reshape(mask.shape + (1,) * (values.ndim - mask.ndim))
        values = torch.where(m, values, torch.zeros((), dtype=values.dtype, device=values.device))
    out = values.new_zeros((num_segments,) + tuple(values.shape[1:]))
    return out.index_add_(0, segment_ids, values)
