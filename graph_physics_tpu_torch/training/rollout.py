"""Autoregressive rollout (counterpart of graph_physics_tpu/training/rollout.py).

A Python loop over frames in place of the JAX ``lax.scan``, with the same
semantics: each step writes the carried prediction into the frame's output
slice (unconditionally: step 0 writes frame 0's own values), runs the
simulator in eval mode, imposes the boundary conditions
(``predicted[mask] = target[mask]`` with mask = NOT(NORMAL ∪ OUTFLOW)) and
accumulates the squared error over valid nodes; the carry is fp32.
A ``frame_transform`` (training/transforms.make_eval_transform: the
world-position edge features) runs on each step's graph after the
write-back, so it sees the predicted positions (rollout.py:146-165).

Frames share one mesh topology: a MeshGraph whose ``x`` and ``y`` carry a
leading time axis ``[T, ...]`` and whose node metadata and edge arrays
are the trajectory's static ones. A world-edge sidecar is per frame: its
``wedge_*`` leaves carry the time axis too ([T, W] or [T, W, R]), each
step taking its own frame's. The on-device rediscovery of world edges
(``DynamicWorldEdges``) waits for ROADMAP A 5.2.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch

from graph_physics_tpu_torch.core.graph import WEDGE_FIELDS, MeshGraph
from graph_physics_tpu_torch.core.nodetype import NodeType
from graph_physics_tpu_torch.models.simulator import Simulator
from graph_physics_tpu_torch.training.loss import DEFAULT_MASK_TYPES, node_loss_mask


@dataclass
class RolloutResult:
    predictions: torch.Tensor  # [T, N, (R,) F] physical-space, BC-imposed
    targets: torch.Tensor  # [T, N, (R,) F]
    val_loss: torch.Tensor  # [T, (R)] masked L2 per step
    rmse_all_rollout: torch.Tensor  # [(R)] sqrt(mean over all steps)
    rmse_1step: torch.Tensor  # [(R)] first-step RMSE
    sq_sum: torch.Tensor  # [T, (R)] squared error over valid nodes
    count: torch.Tensor  # [T, (R)] element counts


def bc_mask(graph: MeshGraph) -> torch.Tensor:
    """[N] bool — nodes overwritten from ground truth: NOT(NORMAL ∪ OUTFLOW)
    (rollout.py:bc_mask). Padding rows land in the mask too."""
    t = graph.node_type
    return ~((t == int(NodeType.NORMAL)) | (t == int(NodeType.OUTFLOW)))


def _rows(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """[N] row mask broadcastable against [N, ..., F] values."""
    return mask.view(mask.shape + (1,) * (like.ndim - 1))


def _rollout(simulator: Simulator, frames: MeshGraph, mask_types,
             frame_transform=None) -> RolloutResult:
    ois, oie = simulator.output_index_start, simulator.output_index_end
    steps = frames.x.shape[0]
    last_pred = frames.x[0, ..., ois:oie].float()
    bc = bc_mask(frames)
    loss_rows = node_loss_mask(frames, mask_types)
    preds, val_losses, sq_sums, counts = [], [], [], []
    for t in range(steps):
        x = frames.x[t].clone()
        x[..., ois:oie] = last_pred
        g = frames.replace(x=x, y=frames.y[t], **{
            name: getattr(frames, name)[t] for name in WEDGE_FIELDS
            if getattr(frames, name) is not None})
        if frame_transform is not None:
            g = frame_transform(g)
        predicted = simulator.forward(g, is_training=False).outputs
        target = frames.y[t]
        predicted = torch.where(_rows(bc, predicted), target, predicted)
        last_pred = predicted

        sq = (predicted - target) ** 2
        dims = [0, sq.ndim - 1]  # nodes and channels; keeps the trajectory axis
        valid = _rows(frames.node_mask, sq).float()
        sq_sums.append((sq * valid).sum(dims))
        counts.append(valid.sum() * sq.shape[-1] * torch.ones_like(sq_sums[-1]))
        lm = _rows(loss_rows, sq).float()
        val_losses.append((sq * lm).sum(dims) / torch.clamp(lm.sum() * sq.shape[-1], min=1.0))
        preds.append(predicted)
    sq_sum, count = torch.stack(sq_sums), torch.stack(counts)
    return RolloutResult(
        predictions=torch.stack(preds),
        targets=frames.y,
        val_loss=torch.stack(val_losses),
        rmse_all_rollout=torch.sqrt(sq_sum.sum(0) / torch.clamp(count.sum(0), min=1.0)),
        rmse_1step=torch.sqrt(sq_sum[0] / torch.clamp(count[0], min=1.0)),
        sq_sum=sq_sum,
        count=count,
    )


def make_rollout_fn(simulator: Simulator, mask_types=DEFAULT_MASK_TYPES,
                    frame_transform=None):
    """``rollout(frames) -> RolloutResult`` for one trajectory, frames with
    x [T, N, F] and y [T, N, F_out] (rollout.py:make_rollout_fn);
    ``frame_transform(graph) -> graph`` runs on each step's graph."""

    @torch.no_grad()
    def rollout(frames: MeshGraph) -> RolloutResult:
        return _rollout(simulator, frames, mask_types, frame_transform)

    return rollout


def make_batched_rollout_fn(simulator: Simulator, mask_types=DEFAULT_MASK_TYPES,
                            frame_transform=None):
    """``rollout(frames) -> RolloutResult`` for R same-mesh trajectories
    packed as x [T, N, R, F] and y [T, N, R, F_out], so each step is one
    packed forward; metrics are per trajectory ([R], [T, R])
    (rollout.py:make_batched_rollout_fn), ``frame_transform`` as
    :func:`make_rollout_fn` takes it."""

    @torch.no_grad()
    def rollout(frames: MeshGraph) -> RolloutResult:
        if frames.x.ndim != 4:
            raise ValueError(f"expected x [T, N, R, F], got {tuple(frames.x.shape)}")
        return _rollout(simulator, frames, mask_types, frame_transform)

    return rollout
