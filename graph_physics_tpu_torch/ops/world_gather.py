"""Per-sample gathers and scatters of the world-edge sidecar.

Counterpart of graph_physics_tpu/ops/world_gather.py (``wtake`` :65,
``wscatter_sum`` :95) for packed ``[N, B, F...]`` node arrays with
``[W, B]`` index arrays: ``idx[w, b]`` names a node of sample ``b``. Both
work on the flattened (node, sample)-major view ``[N·B, F...]``, where row
``node·B + b`` is node ``node`` of sample ``b``: the gather is one
``index_select`` (its gradient an ``index_add_``) and the scatter one
``index_add_`` (its gradient an ``index_select``). The TPU package's
one-hot matmuls stand in for scatters the TPU serialises; the card has
scatter-adds, so they stay behind.
"""

from __future__ import annotations

from typing import Optional

import torch


def flat_ids(idx: torch.Tensor) -> torch.Tensor:
    """[W, B] node ids -> [W·B] rows of the (node, sample)-major view."""
    b = idx.shape[1]
    return (idx.long() * b + torch.arange(b, device=idx.device)).reshape(-1)


def wtake(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-sample node gather: arr [N, B, F...], idx [W, B] -> [W, B, F...]."""
    n, b = arr.shape[:2]
    flat = arr.reshape((n * b,) + arr.shape[2:])
    return flat.index_select(0, flat_ids(idx)).view(idx.shape + arr.shape[2:])


def wscatter_sum(vals: torch.Tensor, idx: torch.Tensor, n: int,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-sample masked scatter-add: vals [W, B, F...], idx [W, B] ->
    [N, B, F...], out[i, b] = the sum of vals[w, b] over the w with
    idx[w, b] == i and mask[w, b]."""
    w, b = idx.shape
    if mask is not None:
        vals = torch.where(mask.view(mask.shape + (1,) * (vals.ndim - 2)), vals,
                           torch.zeros((), dtype=vals.dtype, device=vals.device))
    flat = vals.reshape((w * b,) + vals.shape[2:])
    out = torch.zeros((n * b,) + vals.shape[2:], dtype=vals.dtype, device=vals.device)
    return out.index_add(0, flat_ids(idx), flat).view((n, b) + vals.shape[2:])
