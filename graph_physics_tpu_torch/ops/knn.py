"""Brute-force nearest-neighbour and radius searches on tensors.

Counterpart of graph_physics_tpu/ops/knn.py (``pairwise_sq_dists`` :21,
``knn`` :29, ``knn_graph`` :50, ``knn_interpolate`` :72, ``radius_edges``
:91), in plain torch: a rollout finds DeformingPlate's world edges again
at every step with :func:`radius_edges` (training/rollout.py,
``DynamicWorldEdges``). No Pallas kernel sits behind these functions, so
none sits behind their port.

Two details keep the port's answers JAX's:

  * squared distances are the fp32 |a|² + |b|² − 2ab expansion JAX
    computes; on the card that product must not run in TF32
    (``torch.backends.cuda.matmul.allow_tf32``, ``set_float32_matmul_precision``),
    which :func:`pairwise_sq_dists` refuses;
  * ``jax.lax.top_k`` returns the lower index first among equal values,
    and ``torch.topk`` promises no order among them. Every selection here
    goes through :func:`smallest`, whose keys are (value bits, index)
    pairs packed in one int64, so there are no ties to order.

Where both packages compute the same distances (exactly representable
positions, as on the grid of tests/test_torch_knn.py) the index arrays are
JAX's. Elsewhere JAX's compiled search may round a distance one ulp away
from the port's (XLA fuses the expansion), which can reorder two pairs
whose distances lie that close; the pairs found are the same unless one
sits on the radius or at the edge of a binding cap or budget.

Every function takes an optional leading batch axis on its point sets
(``[B, N, D]``), one independent search per sample: a packed rollout of B
trajectories searches each trajectory's own positions in one call.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

_BIG = 1e30


def pairwise_sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., N, M] squared distances via the |a|² + |b|² − 2ab expansion
    (knn.py:pairwise_sq_dists), clamped at 0."""
    if a.is_cuda and (torch.backends.cuda.matmul.allow_tf32
                      or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError("pairwise_sq_dists needs full-fp32 matmuls: TF32 would move pairs "
                           "across the radius (torch.backends.cuda.matmul.allow_tf32 is on, "
                           "or the float32 matmul precision is not 'highest')")
    a2 = torch.sum(a * a, dim=-1, keepdim=True)
    b2 = torch.sum(b * b, dim=-1, keepdim=True)
    cross = a @ b.transpose(-1, -2)
    return torch.clamp(a2 + b2.transpose(-1, -2) - 2.0 * cross, min=0.0)


def smallest(values: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the ``k`` smallest of non-negative fp32
    ``values`` along the last axis, in ascending order, the lower index
    first among equal values: ``jax.lax.top_k(-values, k)``'s choice and
    order. Non-negative floats order as their bit patterns, so each key is
    the value's bits above the index's."""
    v = values.float() + 0.0  # -0.0 becomes +0.0, whose bits sort first
    bits = v.contiguous().view(torch.int32).to(torch.int64)
    cols = torch.arange(v.shape[-1], device=v.device, dtype=torch.int64)
    keys = torch.topk((bits << 32) | cols, k, dim=-1, largest=False, sorted=True).values
    idx = keys & 0xFFFFFFFF
    return torch.gather(v, -1, idx), idx


def _mask_distances(d2: torch.Tensor, mask_a: Optional[torch.Tensor],
                    mask_b: Optional[torch.Tensor]) -> torch.Tensor:
    """``d2`` with _BIG where a row of ``mask_a`` or a column of ``mask_b``
    is False (either may be None)."""
    keep = None
    if mask_a is not None:
        keep = mask_a[..., :, None]
    if mask_b is not None:
        keep = mask_b[..., None, :] if keep is None else keep & mask_b[..., None, :]
    if keep is None:
        return d2
    return torch.where(keep, d2, torch.full((), _BIG, dtype=d2.dtype, device=d2.device))


def knn(query_pos: torch.Tensor, ref_pos: torch.Tensor, k: int,
        ref_mask: Optional[torch.Tensor] = None,
        exclude_self: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` nearest reference points of each query: (idx [..., N, k],
    sq_dist [..., N, k]) (knn.py:knn)."""
    d2 = pairwise_sq_dists(query_pos.float(), ref_pos.float())
    d2 = _mask_distances(d2, None, ref_mask)
    if exclude_self:
        n = min(d2.shape[-2], d2.shape[-1])
        eye = torch.zeros(d2.shape[-2:], dtype=torch.bool, device=d2.device)
        eye[torch.arange(n), torch.arange(n)] = True
        d2 = torch.where(eye, torch.full((), _BIG, device=d2.device), d2)
    vals, idx = smallest(d2, k)
    return idx, vals


def knn_graph(pos: torch.Tensor, k: int, node_mask: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Undirected kNN graph of one point set: (senders [2Nk], receivers
    [2Nk], edge_mask [2Nk]) (knn.py:knn_graph)."""
    n = pos.shape[0]
    idx, d2 = knn(pos, pos, k, ref_mask=node_mask, exclude_self=True)
    src = idx.reshape(-1)
    dst = torch.arange(n, device=pos.device).repeat_interleave(k)
    valid = d2.reshape(-1) < _BIG / 2
    if node_mask is not None:
        valid = valid & node_mask.repeat_interleave(k)
    return (torch.cat([src, dst]).to(torch.int32), torch.cat([dst, src]).to(torch.int32),
            torch.cat([valid, valid]))


def knn_interpolate(x_ref: torch.Tensor, pos_ref: torch.Tensor, pos_query: torch.Tensor,
                    k: int = 3, ref_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverse-square-distance weighted interpolation of ``x_ref`` [M, F]
    at the queries, from their ``k`` nearest references: [N, F]
    (knn.py:knn_interpolate)."""
    idx, d2 = knn(pos_query, pos_ref, k, ref_mask=ref_mask)
    w = 1.0 / torch.clamp(d2, min=1e-16)
    w = torch.where(d2 < _BIG / 2, w, torch.zeros((), device=w.device))
    feats = x_ref[idx]  # [N, k, F]
    num = torch.sum(feats * w[..., None].to(feats.dtype), dim=1)
    den = torch.clamp(torch.sum(w, dim=1), min=1e-16)
    return num / den[:, None].to(feats.dtype)


def radius_edges(pos_a: torch.Tensor, pos_b: torch.Tensor, radius: float, budget: int,
                 mask_a: Optional[torch.Tensor] = None, mask_b: Optional[torch.Tensor] = None,
                 k_per_node: int = 16, max_block_elems: int = 1 << 22,
                 with_stats: bool = False) -> Tuple[torch.Tensor, ...]:
    """(a, b) pairs within ``radius``, packed to a static ``budget``
    (knn.py:radius_edges): (a_idx [..., budget], b_idx [..., budget],
    valid [..., budget]), and with ``with_stats`` the count of rows whose
    last candidate is still in radius (rows that may have lost partners to
    the cap).

    Each ``a`` keeps at most ``k_per_node`` nearest in-radius ``b``; the
    budget is filled rank-major (every row's nearest pair before any row's
    second), nearer pairs first within a rank. Distances are taken in row
    blocks of at most ``max_block_elems`` entries (over the whole batch),
    so memory stays bounded on large meshes. ``pos_a`` [N, D] / ``pos_b``
    [M, D], or with a leading batch axis [B, N, D] / [B, M, D]; the masks
    [N] / [M], or [B, N] / [B, M]."""
    batched = pos_a.ndim == 3
    pa, pb = pos_a.float(), pos_b.float()
    if not batched:
        pa, pb = pa[None], pb[None]
    bsz, n, m = pa.shape[0], pa.shape[1], pb.shape[1]
    dev = pa.device
    ma = (torch.ones(n, dtype=torch.bool, device=dev) if mask_a is None else mask_a)
    mb = (torch.ones(m, dtype=torch.bool, device=dev) if mask_b is None else mask_b)
    ma = ma.expand(bsz, n) if ma.ndim == 1 else ma
    mb = mb.expand(bsz, m) if mb.ndim == 1 else mb
    k = min(k_per_node, m)

    # row blocks: each [B, C, M] distance tile under max_block_elems
    c = max(min(n, max(max_block_elems // max(m * bsz, 1), 8)), 1)
    vals, cand = [], []
    for s in range(0, n, c):
        d2 = _mask_distances(pairwise_sq_dists(pa[:, s:s + c], pb), ma[:, s:s + c], mb)
        v, i = smallest(d2, k)  # per-row k nearest
        vals.append(v)
        cand.append(i)
    d2 = torch.cat(vals, dim=1)  # [B, N, k]
    idx = torch.cat(cand, dim=1)

    r2 = torch.tensor(radius * radius, dtype=torch.float32)
    within = d2 <= r2.to(dev)
    # rank-major score: monotone in (neighbour rank, then distance)
    rank = torch.arange(k, dtype=torch.float32, device=dev)[None, None, :]
    step = torch.tensor(2.0 * (radius * radius) + 1.0, dtype=torch.float32, device=dev)
    score = torch.where(within, rank * step + d2, torch.full((), _BIG, device=dev))
    flat = score.reshape(bsz, n * k)
    idx_flat = idx.reshape(bsz, n * k)
    if flat.shape[1] < budget:
        pad = budget - flat.shape[1]
        flat = torch.cat([flat, torch.full((bsz, pad), _BIG, device=dev)], dim=1)
        idx_flat = torch.cat([idx_flat, torch.zeros((bsz, pad), dtype=idx_flat.dtype,
                                                    device=dev)], dim=1)
    sel, fi = smallest(flat, budget)
    valid = sel < _BIG / 2
    a_idx = torch.clamp(fi // k, max=n - 1).to(torch.int32)
    b_idx = torch.gather(idx_flat, 1, fi).to(torch.int32)
    out = (a_idx, b_idx, valid)
    if with_stats:
        out = out + (within[..., -1].sum(-1).to(torch.int32),)
    return out if batched else tuple(t[0] for t in out)
