"""Edge-masked multi-head attention as gather -> segment softmax -> scatter.

Counterpart of graph_physics_tpu/ops/edge_attention.py:edge_attention
(:161-256), the plain path over an edge list (the reference's DGL
bsddmm / sparse softmax / bspmm):

  1. logit[e, h] = <q[recv[e], h, :], k[send[e], h, :]> / sqrt(D), in fp32;
  2. alpha = softmax of the logits over each receiver's valid in-edges;
  3. out[n, h, :] = sum over n's valid in-edges of alpha[e, h] · v[send[e], h, :].

Node arrays are [N, H, D] or packed [N, B, H, D] (node axis first); the
gathers and scatters act on axis 0. Padded edges contribute nothing and a
node with no valid in-edge returns zeros.

The world-edge sidecar (``MeshGraph.wedge_*``, per-sample world edges
beside the shared mesh edges): :func:`world_attention_parts` sums each
receiver's world edges into softmax pieces (num_w, den_w, s_w), and
:func:`joint_edge_attention` folds them into the mesh edges' softmax, so
the softmax runs jointly over each receiver's mesh and world neighbours,
as if the world edges were in the edge list. The kernels of
ops/fused_edge_attention_* take the same pieces. Sequence parallelism
(ROADMAP A 9) is not ported.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from graph_physics_tpu_torch.ops import segment
from graph_physics_tpu_torch.ops.world_gather import wscatter_sum, wtake

WorldParts = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _logits(q_e: torch.Tensor, k_e: torch.Tensor) -> torch.Tensor:
    """fp32 q·k / sqrt(D) over the last axis (bf16 products are exact in fp32)."""
    return (q_e.float() * k_e.float()).sum(-1) * (1.0 / math.sqrt(q_e.shape[-1]))


def world_attention_parts(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    wedge_senders: torch.Tensor,
    wedge_receivers: torch.Tensor,
    wedge_mask: Optional[torch.Tensor],
) -> WorldParts:
    """Per-receiver world-softmax pieces ``(num_w, den_w, s_w)``
    (edge_attention.py:world_attention_parts :73), all fp32:

      num_w[r] = sum over r's world edges w of exp(l_w - s_w[r]) · v[send_w]   [N, ..., H, D]
      den_w[r] = sum over r's world edges w of exp(l_w - s_w[r])               [N, ..., H]

    Packed graphs ([W, B] indices) shift by one max per (sample, head): the
    max of the sample's valid world logits, 0 where it has none, the same
    at every receiver (s_w [N, B, H]). A single graph ([W] indices) shifts
    by each receiver's own world max (0 where it has none). The shift
    carries no gradient; a receiver without world edges gets num = den =
    0.
    """
    n = q.shape[0]
    zero = torch.zeros((), device=q.device)
    if wedge_mask is None:
        wedge_mask = torch.ones(wedge_senders.shape, dtype=torch.bool, device=q.device)
    if wedge_senders.ndim == 2:
        # the masked slots take no gradient: shifted, and so all they feed, is 0 there
        logits = _logits(wtake(q, wedge_receivers, wedge_mask),
                         wtake(k, wedge_senders, wedge_mask))  # [W, B, H]
        m = wedge_mask.view(wedge_mask.shape + (1,))
        s_val = torch.where(m, logits, torch.full((), -float("inf"), device=q.device)).amax(0)
        s_val = torch.where(torch.isfinite(s_val), s_val, zero).detach()  # [B, H]
        shifted = torch.where(m, torch.exp(logits - s_val), zero)
        v_w = wtake(v, wedge_senders, wedge_mask)
        payload = torch.cat([shifted[..., None],
                             (v_w * shifted[..., None].to(v.dtype)).float()], dim=-1)
        out = wscatter_sum(payload, wedge_receivers, n, wedge_mask)
        s_w = s_val.expand((n,) + s_val.shape).contiguous()
        return out[..., 1:].contiguous(), out[..., 0].contiguous(), s_w
    logits = _logits(segment.gather_rows(q, wedge_receivers),
                     segment.gather_rows(k, wedge_senders))
    s_w = segment.segment_max(logits, wedge_receivers, n, mask=wedge_mask)
    s_w = torch.where(torch.isfinite(s_w), s_w, zero).detach()
    shifted = torch.exp(logits - segment.gather_rows(s_w, wedge_receivers))
    shifted = torch.where(segment._bcast(wedge_mask, shifted), shifted, zero)
    den_w = segment.segment_sum(shifted, wedge_receivers, n)
    v_w = segment.gather_rows(v, wedge_senders)
    num_w = segment.segment_sum(v_w * shifted[..., None].to(v.dtype), wedge_receivers, n)
    return num_w.float(), den_w, s_w


def joint_edge_attention(q, k, v, senders, receivers, edge_mask,
                         world_parts: WorldParts) -> torch.Tensor:
    """The softmax over each receiver's valid edges and its world pieces
    ``world_parts`` = (num_w, den_w, s_w) (:func:`world_attention_parts`),
    jointly: the plain version of the kernels' world seam, and the world
    branch of edge_attention.py:edge_attention (:230-256).

    The shift is the joint max m = max(mesh max, s_w) (no gradient; a
    receiver without valid edges has mesh max -inf); the mesh weights
    exp(l - m) take the inputs' dtype (bf16 for bf16 inputs, as the kernels
    round them) and are summed in fp32; the world pieces join re-based by
    exp(s_w - m); out = num / den, 0 where den is 0, in the inputs' dtype.
    JAX shifts by max(mesh max or 0, s_w): the same function up to rounding.
    """
    n = q.shape[0]
    num_w, den_w, s_w = world_parts
    logits = _logits(segment.gather_rows(q, receivers), segment.gather_rows(k, senders))
    m = torch.maximum(segment.segment_max(logits, receivers, n, mask=edge_mask),
                      s_w).detach()
    p = torch.exp(logits - segment.gather_rows(m, receivers))
    if edge_mask is not None:
        p = torch.where(segment._bcast(edge_mask, p), p, torch.zeros((), device=p.device))
    p = p.to(v.dtype).float()
    v_e = segment.gather_rows(v, senders).float()
    w = torch.exp(s_w - m)
    den = segment.segment_sum(p, receivers, n) + den_w * w
    num = segment.segment_sum(v_e * p[..., None], receivers, n) + num_w * w[..., None]
    some = den > 0
    out = num / torch.where(some, den, torch.ones((), device=den.device))[..., None]
    return torch.where(some[..., None], out, torch.zeros((), device=out.device)).to(v.dtype)


def edge_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    senders: torch.Tensor,
    receivers: torch.Tensor,
    edge_mask: Optional[torch.Tensor] = None,
    return_weights: bool = False,
    sp_axis_name: Optional[str] = None,
    wedge_senders: Optional[torch.Tensor] = None,
    wedge_receivers: Optional[torch.Tensor] = None,
    wedge_mask: Optional[torch.Tensor] = None,
):
    """Multi-head attention restricted to graph edges: [N, ..., H, D]
    (and the per-edge weights [E, ..., H] with ``return_weights``). With
    the world-edge sidecar (``wedge_*``: [W] for one graph, [W, B] packed)
    the softmax runs jointly over each receiver's mesh and world edges."""
    if sp_axis_name is not None:
        raise NotImplementedError("sequence-parallel edge attention is not ported")
    if return_weights and q.ndim == 4:
        raise NotImplementedError("return_weights on packed input is not ported")
    if wedge_senders is not None:
        if return_weights:
            raise NotImplementedError("return_weights with the world-edge sidecar is not "
                                      "supported")
        parts = world_attention_parts(q, k, v, wedge_senders, wedge_receivers, wedge_mask)
        return joint_edge_attention(q, k, v, senders, receivers, edge_mask, parts)
    n = q.shape[0]
    logits = _logits(segment.gather_rows(q, receivers), segment.gather_rows(k, senders))
    alpha = segment.segment_softmax(logits, receivers, n, mask=edge_mask)
    v_e = segment.gather_rows(v, senders)
    weighted = v_e * alpha[..., None].to(v.dtype)
    out = segment.segment_sum(weighted, receivers, n, mask=edge_mask)
    if return_weights:
        return out, alpha
    return out
