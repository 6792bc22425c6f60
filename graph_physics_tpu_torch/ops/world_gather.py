"""Per-sample gathers and scatters of the world-edge sidecar.

Counterpart of graph_physics_tpu/ops/world_gather.py (``wtake`` :65,
``wscatter_sum`` :95) for packed ``[N, B, F...]`` node arrays with
``[W, B]`` index arrays: ``idx[w, b]`` names a node of sample ``b``. Both
work on the flattened (node, sample)-major view ``[N·B, F...]``, where row
``node·B + b`` is node ``node`` of sample ``b``: the gather is one
``segment.gather_rows`` and the scatter one ``segment.scatter_rows``, the
gather's gradient; both sums add in a fixed order (ops/segment.py). The TPU package's
one-hot matmuls stand in for scatters the TPU serialises; the card has
scatter-adds, so they stay behind.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.weak import WeakIdKeyDictionary

from graph_physics_tpu_torch.ops.segment import gather_rows, scatter_rows


#: {idx: (version, flat ids)}: flat_ids of a [W, B] index tensor, kept
#: while it lives (one sidecar serves every block of a step, and the same
#: flat ids let segment.scatter_rows keep its card indices)
_FLAT = WeakIdKeyDictionary()


def flat_ids(idx: torch.Tensor) -> torch.Tensor:
    """[W, B] node ids -> [W·B] rows of the (node, sample)-major view."""
    b = idx.shape[1]
    if idx.is_inference():  # no version to key a kept copy by
        return (idx.long() * b + torch.arange(b, device=idx.device)).reshape(-1)
    hit = _FLAT.get(idx)
    if hit is None or hit[0] != idx._version:
        hit = _FLAT[idx] = (idx._version,
                            (idx.long() * b + torch.arange(b, device=idx.device)).reshape(-1))
    return hit[1]


def wtake(arr: torch.Tensor, idx: torch.Tensor,
          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-sample node gather: arr [N, B, F...], idx [W, B] -> [W, B, F...].
    ``mask`` [W, B]: the slots off it take no gradient
    (``segment.gather_rows``)."""
    n, b = arr.shape[:2]
    flat = arr.reshape((n * b,) + arr.shape[2:])
    return gather_rows(flat, flat_ids(idx), mask).view(idx.shape + arr.shape[2:])


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
    return scatter_rows(flat, flat_ids(idx), n * b, mask).view((n, b) + vals.shape[2:])
