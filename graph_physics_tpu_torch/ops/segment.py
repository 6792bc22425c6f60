"""Mask-aware segment ops (counterpart of graph_physics_tpu/ops/segment.py).

Padded edges carry ``edge_mask`` False and point at node N-1; their values
are zeroed (-inf for the max) before the scatter so the stray writes
contribute nothing.

Every sum here adds in a fixed order, so two calls on the same inputs give
the same bits, as JAX's do on the TPU: :func:`scatter_rows` (the sums, and
the gradient of :func:`gather_rows`) takes ``index_add_`` on the CPU, which
adds row by row, and on a card ``index_put_(..., accumulate=True)``, whose
CUDA version sorts the indices (a stable sort) and adds each segment's
values in that order; ``index_add_`` there, and so the gradient of
``index_select``, adds by atomics, in the order the threads happen to run.
index_put_'s own range check costs two device-to-host syncs a call, so
the ids are checked on the device instead (``torch._assert_async``): an
id outside [0, num) stops the stream with a device assert, as
``index_add_``'s does. The card's indices are made once an ids tensor
(checked, lanes off a mask sent to spare rows) and kept while it lives,
since the graph's ids serve every block of a step.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.weak import WeakIdKeyDictionary


def _bcast(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (like.ndim - mask.ndim))


#: spare rows a masked scatter on a card sends its lanes off the mask to
#: (lane i to spare row i % SPARE_ROWS, after the real ones)
SPARE_ROWS = 1024
#: {ids: (num, versions, mask, rows, indices)}: the card's indices of an
#: ids tensor, kept while it lives
_CARD_IDS = WeakIdKeyDictionary()


def _card_ids(ids: torch.Tensor, num: int, mask: Optional[torch.Tensor]):
    """(indices, rows) for the card's sorted scatter of ``ids`` into ``num``
    rows: int64, the range checked on the device, the lanes off ``mask``
    sent to spare rows past ``num``. Made once an ids tensor, ``num``, mask
    and version (anew for inference tensors, which keep no version)."""
    cached = not ids.is_inference() and (mask is None or not mask.is_inference())
    if cached:
        versions = (ids._version, None if mask is None else mask._version)
        hit = _CARD_IDS.get(ids)
        if hit is not None and hit[:2] == (num, versions) and hit[2] is mask:
            return (ids if hit[4] is None else hit[4]), hit[3]
    out = ids.long()
    if out.numel():
        lo, hi = torch.aminmax(out)
        torch._assert_async((lo >= 0) & (hi < num), "scatter_rows: an id outside [0, num)")
    rows = num
    if mask is not None:
        # the sorted path sums a run of equal ids in one warp, in turn: the
        # lanes off the mask (padding, all pointing at one node) would make
        # one long run, so each goes to a spare row
        spare = torch.arange(out.numel(), device=out.device) % SPARE_ROWS
        out = torch.where(mask.reshape(-1), out, num + spare)
        rows = num + SPARE_ROWS
    if cached:  # not ids itself: a value holding its key would keep it alive
        _CARD_IDS[ids] = (num, versions, mask, rows, None if out is ids else out)
    return out, rows


class _ScatterRows(torch.autograd.Function):
    """:func:`scatter_rows`; its gradient is the gather ``g[ids]``."""

    @staticmethod
    def forward(ctx, values, ids, num, mask):
        mask = mask if mask is not None and mask.numel() == ids.numel() else None
        ctx.save_for_backward(ids, mask)
        if values.device.type == "cpu":
            if mask is not None:
                values = torch.where(_bcast(mask.reshape(-1), values), values,
                                     torch.zeros((), dtype=values.dtype))
            out = values.new_zeros((num,) + tuple(values.shape[1:]))
            return out.index_add_(0, ids, values)
        ids, rows = _card_ids(ids, num, mask)
        out = values.new_zeros((rows,) + tuple(values.shape[1:]))
        # index_put_'s sorted CUDA path, its range check made by _card_ids
        return torch.ops.aten._index_put_impl_(out, [ids], values, True, True)[:num]

    @staticmethod
    def backward(ctx, g):
        ids, mask = ctx.saved_tensors
        grad = g.index_select(0, ids)
        if mask is not None:
            grad = torch.where(_bcast(mask.reshape(-1), grad), grad,
                               torch.zeros((), dtype=grad.dtype, device=grad.device))
        return grad, None, None, None


def scatter_rows(values: torch.Tensor, ids: torch.Tensor, num: int,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out[i] = the sum of values[e] over the e with ids[e] == i (each id
    in [0, num)), added in a fixed order (the module's docstring); out is
    [num, ...] zeros where no e names i. ``mask`` (bool, one entry an e;
    another shape is not used): the e off it add nothing and take no
    gradient, on either device."""
    return _ScatterRows.apply(values, ids, num, mask)


class _GatherRows(torch.autograd.Function):
    """``src.index_select(0, idx)`` whose gradient is :func:`scatter_rows`."""

    @staticmethod
    def forward(ctx, src, idx, mask):
        ctx.save_for_backward(idx, mask)
        ctx.num = src.shape[0]
        return src.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        idx, mask = ctx.saved_tensors
        return scatter_rows(g.contiguous(), idx, ctx.num, mask), None, None


def gather_rows(src: torch.Tensor, idx: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """src[idx] along axis 0; under autograd its gradient sums in a fixed
    order (:func:`scatter_rows`). ``mask`` (bool, one entry an index): the
    rows read off it take no gradient (their cotangent is dropped)."""
    if torch.is_grad_enabled() and src.requires_grad:
        return _GatherRows.apply(src, idx, mask)
    return src.index_select(0, idx)


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
    return scatter_rows(values, segment_ids, num_segments, mask)


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
    return exp / gather_rows(denom, segment_ids)
