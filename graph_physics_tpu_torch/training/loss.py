"""Maskable data and physics losses.

Counterpart of graph_physics_tpu/training/loss.py (:36-316). The loss
covers the valid nodes whose type is in ``mask_types`` (default NORMAL and
OUTFLOW) and that the node-masking augmentation did not deselect ([N] or
[N, B] packed). ``mean over errors[mask]`` averages over the masked
*elements*: rows x every trailing axis, so in the packed ``[N, B, C]``
layout with a shared ``[N]`` mask it divides by rows x B x C.

Every term is a function of a :class:`LossInputs` bundle; ``LossType``
names them as the configs do, and ``MultiLoss`` adds weighted terms,
computing the two physical gradients (ops/voperators.py) once for all of
them. ``mean_fn`` replaces the masked mean: the packed train step passes
:func:`per_sample_mean`, so each term is a mean per sample, as JAX's
``vmap`` over the batch axis gives it (training/step.py). :func:`l2_loss`
keeps the port's ``(graph, network_output, target, mask_types)`` form.
"""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from graph_physics_tpu_torch.core.graph import MeshGraph
from graph_physics_tpu_torch.core.nodetype import NodeType
from graph_physics_tpu_torch.ops import voperators

#: node types included in the loss (loss.py:DEFAULT_MASK_TYPES)
DEFAULT_MASK_TYPES = (int(NodeType.NORMAL), int(NodeType.OUTFLOW))


@dataclass
class LossInputs:
    """loss.py:LossInputs: the graph, the normalized Δ target and
    prediction, their physical values and spatial gradients where a term
    needs them, and the deselected nodes."""

    graph: MeshGraph
    target: Optional[torch.Tensor] = None  # normalized Δ target [N, (B,) F]
    network_output: Optional[torch.Tensor] = None  # normalized prediction
    network_output_physical: Optional[torch.Tensor] = None
    target_physical: Optional[torch.Tensor] = None
    network_output_gradient: Optional[torch.Tensor] = None  # [N, (B,) F, D]
    target_gradient: Optional[torch.Tensor] = None
    deselected: Optional[torch.Tensor] = None  # [N] or [N, B] bool, True = excluded

    def replace(self, **changes) -> "LossInputs":
        return dataclasses.replace(self, **changes)


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


def per_sample_mean(errors: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[B]: the masked mean of each sample of packed ``errors`` [N, B, ...]
    under a row mask [N] (shared) or [N, B], each the :func:`masked_mean`
    of that sample alone."""
    b = errors.shape[1]
    if mask.ndim == 1:
        mask = mask[:, None].expand(mask.shape[0], b)
    mf = mask.float()
    extra = errors.shape[2:]
    cols = 1
    for s in extra:
        cols *= int(s)
    weighted = errors.float() * mf.view(mf.shape + (1,) * len(extra))
    num = weighted.reshape(weighted.shape[0], b, -1).sum(dim=(0, 2))
    return num / torch.clamp(mf.sum(0) * cols, min=1.0)


def _smooth_l1(x: torch.Tensor, beta: float) -> torch.Tensor:
    ax = x.abs()
    return torch.where(ax < beta, 0.5 * x * x / beta, ax - 0.5 * beta)


def _mask(inp: LossInputs, mask_types) -> torch.Tensor:
    return node_loss_mask(inp.graph, mask_types, inp.deselected)


# ----------------------------------------------------------------------
# data-space losses (normalized Δ)
# ----------------------------------------------------------------------

def l2_err_mask(graph: MeshGraph, network_output: torch.Tensor, target: torch.Tensor,
                mask_types: Sequence[int] = DEFAULT_MASK_TYPES, deselected=None):
    """(squared error in fp32, node mask) of the masked MSE, the nodes in
    ``deselected`` (the graph's when None) left out (loss.py:l2_err_mask)."""
    if deselected is None:
        deselected = graph.deselected
    return ((network_output.float() - target.float()) ** 2,
            node_loss_mask(graph, mask_types, deselected))


def l2_loss(graph: MeshGraph, network_output: torch.Tensor, target: torch.Tensor,
            mask_types: Sequence[int] = DEFAULT_MASK_TYPES) -> torch.Tensor:
    """Masked MSE on normalized targets (loss.py:l2_loss), of the graph,
    the prediction and the target."""
    return masked_mean(*l2_err_mask(graph, network_output, target, mask_types))


def mse_loss(inp: LossInputs, mask_types=DEFAULT_MASK_TYPES, mean_fn=None, **_) -> torch.Tensor:
    """loss.py:l2_loss on a :class:`LossInputs` bundle."""
    err, m = l2_err_mask(inp.graph, inp.network_output, inp.target, mask_types,
                         inp.deselected)
    return (mean_fn or masked_mean)(err, m)


def cosine_loss(inp: LossInputs, mask_types=DEFAULT_MASK_TYPES, mean_fn=None,
                **_) -> torch.Tensor:
    """Masked cosine-embedding loss, 1 − cos(out, target) (loss.py:cosine_loss)."""
    a = inp.network_output.float()
    b = inp.target.float()
    eps = 1e-8
    cos = torch.sum(a * b, -1) / (torch.clamp(torch.linalg.norm(a, dim=-1), min=eps)
                                  * torch.clamp(torch.linalg.norm(b, dim=-1), min=eps))
    return (mean_fn or masked_mean)(1.0 - cos, _mask(inp, mask_types))


def l1_smooth_loss(inp: LossInputs, mask_types=DEFAULT_MASK_TYPES, beta: float = 1.0,
                   mean_fn=None, **_) -> torch.Tensor:
    """Masked smooth-L1 (loss.py:l1_smooth_loss)."""
    return (mean_fn or masked_mean)(_smooth_l1(inp.network_output - inp.target, beta),
                                    _mask(inp, mask_types))


# ----------------------------------------------------------------------
# physics losses (physical space, need gradients)
# ----------------------------------------------------------------------

def _ensure_gradients(inp: LossInputs, gradient_method: str, need_target: bool
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(prediction gradient, target gradient or None), each computed unless
    the bundle holds it (loss.py:_ensure_gradients)."""
    g = inp.graph
    kw = dict(senders=g.senders, receivers=g.receivers, edge_mask=g.edge_mask,
              faces=g.faces, face_mask=g.face_mask, method=gradient_method)
    out_grad = inp.network_output_gradient
    if out_grad is None:
        out_grad = voperators.gradient(g.pos, inp.network_output_physical, **kw)
    tgt_grad = inp.target_gradient
    if need_target and tgt_grad is None:
        tgt_grad = voperators.gradient(g.pos, inp.target_physical, **kw)
    return out_grad, tgt_grad


def gradient_l2_loss(inp: LossInputs, mask_types=DEFAULT_MASK_TYPES,
                     gradient_method: str = "finite_diff", mean_fn=None, **_) -> torch.Tensor:
    """L2 between the spatial gradients of prediction and target
    (loss.py:gradient_l2_loss)."""
    out_grad, tgt_grad = _ensure_gradients(inp, gradient_method, need_target=True)
    return (mean_fn or masked_mean)((out_grad - tgt_grad) ** 2, _mask(inp, mask_types))


def convection_l2_loss(inp: LossInputs, mask_types=DEFAULT_MASK_TYPES,
                       gradient_method: str = "finite_diff", mean_fn=None,
                       **_) -> torch.Tensor:
    """L2 between the (u·∇)u terms of prediction and target
    (loss.py:convection_l2_loss)."""
    out_grad, tgt_grad = _ensure_gradients(inp, gradient_method, need_target=True)
    out_conv = voperators.convection(inp.network_output_physical, out_grad)
    tgt_conv = voperators.convection(inp.target_physical, tgt_grad)
    return (mean_fn or masked_mean)((out_conv - tgt_conv) ** 2, _mask(inp, mask_types))


def divergence_l2_loss(inp: LossInputs, mask_types=DEFAULT_MASK_TYPES,
                       gradient_method: str = "finite_diff", mean_fn=None,
                       **_) -> torch.Tensor:
    """L2 norm of ∇·u of the prediction (loss.py:divergence_l2_loss)."""
    out_grad, _ = _ensure_gradients(inp, gradient_method, need_target=False)
    return (mean_fn or masked_mean)(voperators.divergence(out_grad) ** 2,
                                    _mask(inp, mask_types))


def divergence_l1_loss(inp: LossInputs, mask_types=DEFAULT_MASK_TYPES,
                       gradient_method: str = "finite_diff", mean_fn=None,
                       **_) -> torch.Tensor:
    """L1 norm of ∇·u of the prediction (loss.py:divergence_l1_loss)."""
    out_grad, _ = _ensure_gradients(inp, gradient_method, need_target=False)
    return (mean_fn or masked_mean)(voperators.divergence(out_grad).abs(),
                                    _mask(inp, mask_types))


def divergence_l1_smooth_loss(inp: LossInputs, mask_types=DEFAULT_MASK_TYPES,
                              gradient_method: str = "finite_diff", beta: float = 1.0,
                              mean_fn=None, **_) -> torch.Tensor:
    """Smooth-L1 of ∇·u against zero (loss.py:divergence_l1_smooth_loss)."""
    out_grad, _ = _ensure_gradients(inp, gradient_method, need_target=False)
    return (mean_fn or masked_mean)(_smooth_l1(voperators.divergence(out_grad), beta),
                                    _mask(inp, mask_types))


class LossType(enum.Enum):
    """The loss registry (loss.py:LossType :255-278): member names are the
    configs' type strings upper-cased; each value is (display name, term,
    needs physical outputs)."""

    L2LOSS = ("MSE", mse_loss, False)
    COSINEL2LOSS = ("Cosine", cosine_loss, False)
    L1SMOOTHLOSS = ("L1Smooth", l1_smooth_loss, False)
    GRADIENTL2LOSS = ("GradientL2Loss", gradient_l2_loss, True)
    CONVECTIONL2LOSS = ("ConvectionL2Loss", convection_l2_loss, True)
    DIVERGENCEL2LOSS = ("DivergenceL2Loss", divergence_l2_loss, True)
    DIVERGENCEL1LOSS = ("DivergenceL1Loss", divergence_l1_loss, True)
    DIVERGENCEL1SMOOTHLOSS = ("DivergenceL1Smooth", divergence_l1_smooth_loss, True)

    @property
    def display_name(self) -> str:
        return self.value[0]

    @property
    def fn(self) -> Callable:
        return self.value[1]

    @property
    def needs_physical(self) -> bool:
        return self.value[2]


class MultiLoss:
    """A fixed-weight sum of terms that computes the two physical gradients
    once for all of them (loss.py:MultiLoss :280); returns (total, [weighted
    term, ...]) with ``return_all_losses``."""

    def __init__(self, losses: List[LossType], weights: List[float]):
        if len(losses) != len(weights):
            raise ValueError(f"{len(losses)} losses and {len(weights)} weights")
        self.losses = list(losses)
        self.weights = list(weights)
        self.needs_physical = any(loss.needs_physical for loss in self.losses)

    def __call__(self, inp: LossInputs, mask_types=DEFAULT_MASK_TYPES,
                 gradient_method: Optional[str] = "finite_diff",
                 return_all_losses: bool = False, mean_fn=None):
        if gradient_method is not None and self.needs_physical:
            out_grad, tgt_grad = _ensure_gradients(inp, gradient_method, need_target=True)
            inp = inp.replace(network_output_gradient=out_grad, target_gradient=tgt_grad)
        terms = [w * loss.fn(inp, mask_types=mask_types, gradient_method=gradient_method,
                             mean_fn=mean_fn)
                 for w, loss in zip(self.weights, self.losses)]
        total = sum(terms)
        return (total, terms) if return_all_losses else total
