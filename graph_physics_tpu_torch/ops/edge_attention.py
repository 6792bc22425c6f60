"""Edge-masked multi-head attention as gather -> segment softmax -> scatter.

Counterpart of graph_physics_tpu/ops/edge_attention.py:edge_attention
(:161-256), the plain path over an edge list (the reference's DGL
bsddmm / sparse softmax / bspmm):

  1. logit[e, h] = <q[recv[e], h, :], k[send[e], h, :]> / sqrt(D), in fp32;
  2. alpha = softmax of the logits over each receiver's valid in-edges;
  3. out[n, h, :] = sum over n's valid in-edges of alpha[e, h] · v[send[e], h, :].

Node arrays are [N, H, D] or packed [N, B, H, D] (node axis first); the
gathers and scatters act on axis 0. Padded edges contribute nothing and a
node with no valid in-edge returns zeros. The world-edge sidecar
(ROADMAP A 5) and sequence parallelism (A 9) are not ported.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from graph_physics_tpu_torch.ops import segment


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
    (and the per-edge weights [E, ..., H] with ``return_weights``)."""
    if wedge_senders is not None or wedge_receivers is not None or wedge_mask is not None:
        raise NotImplementedError("the world-edge sidecar is not ported")
    if sp_axis_name is not None:
        raise NotImplementedError("sequence-parallel edge attention is not ported")
    if return_weights and q.ndim == 4:
        raise NotImplementedError("return_weights on packed input is not ported")
    n, d = q.shape[0], q.shape[-1]
    scale = 1.0 / math.sqrt(d)
    q_e = q.index_select(0, receivers)
    k_e = k.index_select(0, senders)
    # fp32 logits whatever the compute dtype: bf16 products are exact in fp32
    logits = (q_e.float() * k_e.float()).sum(-1) * scale
    alpha = segment.segment_softmax(logits, receivers, n, mask=edge_mask)
    v_e = v.index_select(0, senders)
    weighted = v_e * alpha[..., None].to(v.dtype)
    out = segment.segment_sum(weighted, receivers, n, mask=edge_mask)
    if return_weights:
        return out, alpha
    return out
