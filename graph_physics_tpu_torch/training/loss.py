"""Masked data loss (counterpart of graph_physics_tpu/training/loss.py:47-128).

The loss covers the valid nodes whose type is in ``mask_types`` (default
NORMAL and OUTFLOW) and that the node-masking augmentation did not
deselect (``graph.deselected``, [N] or [N, B] packed). ``mean over errors[mask]`` averages over the masked
*elements*: rows x every trailing axis, so in the packed ``[N, B, C]``
layout with a shared ``[N]`` mask it divides by rows x B x C. Only the L2
term is ported; the physics terms and MultiLoss are ROADMAP A 6.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from graph_physics_tpu_torch.core.graph import MeshGraph
from graph_physics_tpu_torch.core.nodetype import NodeType

#: node types included in the loss (loss.py:DEFAULT_MASK_TYPES)
DEFAULT_MASK_TYPES = (int(NodeType.NORMAL), int(NodeType.OUTFLOW))


def node_loss_mask(graph: MeshGraph, mask_types: Sequence[int] = DEFAULT_MASK_TYPES,
                   deselected: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[N] bool ([N, B] with a packed ``deselected``): valid nodes of the
    loss types that are not deselected (loss.py:node_loss_mask)."""
    m = torch.zeros_like(graph.node_mask)
    for mt in mask_types:
        m = m | (graph.node_type == mt)
    m = m & graph.node_mask
    if deselected is not None:
        if deselected.ndim > m.ndim:  # packed layout: deselected [N, B]
            m = m[..., None].expand(deselected.shape)
        m = m & ~deselected
    return m


def masked_num_den(errors: torch.Tensor, mask: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(numerator, denominator) of the masked mean of ``errors`` [..., N, C...]
    under a row ``mask`` [..., N]; the denominator counts rows x trailing
    elements and is not clamped (loss.py:masked_num_den)."""
    mf = mask.float()
    extra = errors.shape[mask.ndim:]
    cols = 1
    for s in extra:
        cols *= int(s)
    num = torch.sum(errors.float() * mf.view(mf.shape + (1,) * len(extra)))
    return num, torch.sum(mf) * cols


def masked_mean(errors: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """mean(errors[mask]) (loss.py:_masked_mean)."""
    num, den = masked_num_den(errors, mask)
    return num / torch.clamp(den, min=1.0)


def l2_err_mask(graph: MeshGraph, network_output: torch.Tensor, target: torch.Tensor,
                mask_types: Sequence[int] = DEFAULT_MASK_TYPES):
    """(squared error in fp32, node mask) of the masked MSE, the graph's
    deselected nodes left out (loss.py:l2_err_mask)."""
    return ((network_output.float() - target.float()) ** 2,
            node_loss_mask(graph, mask_types, graph.deselected))


def l2_loss(graph: MeshGraph, network_output: torch.Tensor, target: torch.Tensor,
            mask_types: Sequence[int] = DEFAULT_MASK_TYPES) -> torch.Tensor:
    """Masked MSE on normalized targets (loss.py:l2_loss)."""
    return masked_mean(*l2_err_mask(graph, network_output, target, mask_types))
