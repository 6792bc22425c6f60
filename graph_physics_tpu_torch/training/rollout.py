"""Autoregressive rollout (counterpart of graph_physics_tpu/training/rollout.py).

A Python loop over frames in place of the JAX ``lax.scan``, with the same
semantics: each step writes the carried prediction into the frame's output
slice (unconditionally: step 0 writes frame 0's own values), runs the
simulator in eval mode, imposes the boundary conditions
(``predicted[mask] = target[mask]`` with mask = NOT(NORMAL ∪ OUTFLOW)) and
accumulates the squared error over valid nodes; the carry is fp32.
With ``previous_data_slice`` (ps, pe) the rollout also carries the
columns ``x[..., ps:pe]``: they start from frame 0's, each step writes
the carry there after the output slice, and the next carry is
``predicted − current`` after the BC mask, in fp32 (rollout.py:146-201):
the aneurysm configs' acceleration column. With ``dynamic_world_edges``
(:class:`DynamicWorldEdges`) each step finds the world edges again on the
device (ops/knn.radius_edges) before the transform. A
``frame_transform`` (training/transforms.make_eval_transform: the
world-position edge features) runs on each step's graph after the
write-back, so it sees the predicted positions (rollout.py:146-165).

Frames share one mesh topology: a MeshGraph whose ``x`` and ``y`` carry a
leading time axis ``[T, ...]`` and whose node metadata and edge arrays
are the trajectory's static ones. A world-edge sidecar is per frame: its
``wedge_*`` leaves carry the time axis too ([T, W] or [T, W, R]), each
step taking its own frame's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from graph_physics_tpu_torch.core.graph import WEDGE_FIELDS, MeshGraph
from graph_physics_tpu_torch.core.nodetype import NodeType
from graph_physics_tpu_torch.models.simulator import Simulator
from graph_physics_tpu_torch.ops.knn import radius_edges
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


@dataclass(frozen=True)
class DynamicWorldEdges:
    """World edges found again on the device at every rollout step
    (rollout.py:DynamicWorldEdges): a radius search (ops/knn.radius_edges)
    of pairs joining {OBSTACLE, HANDLE} with NORMAL nodes, ``budget`` pairs
    a direction, each {OBSTACLE, HANDLE} node keeping its ``k_per_node``
    nearest. ``track_predicted`` searches the step's predicted positions
    (written back into x); False searches the frame's own ground truth,
    the reference's semantics. Like JAX's device search, and unlike the
    host builder (core/mesh.radius_world_edges), it keeps pairs that are
    also mesh edges.

    Frames take the pairs in one of two places. Concat frames (mesh edges
    only, ``2 * budget`` free slots at the tail of the edge arrays): a→b
    in ``[E - 2·budget, E - budget)``, b→a after them, the mask, and the
    mesh-position features of the tail edges, as JAX writes them. Frames
    with a world-edge sidecar of ``W >= 2 * budget`` slots: a→b in slots
    ``[0, budget)``, b→a in ``[budget, 2·budget)``, unused slots as the
    sidecar pads them (sender 0, receiver N−1, mask False, zero features),
    and the mesh-position features in ``wedge_attr``'s first columns."""

    world_pos_start: int
    world_pos_end: int
    radius: float
    budget: int  # per direction
    k_per_node: int = 16
    track_predicted: bool = True


def _mesh_features(pos: torch.Tensor, senders: torch.Tensor,
                   receivers: torch.Tensor) -> torch.Tensor:
    """[Δpos, ‖Δpos‖] of the edges (senders, receivers) of ``pos`` [N, D],
    in any index shape: JAX's tail features (rollout.py:118-121)."""
    d = pos[senders.long()] - pos[receivers.long()]
    return torch.cat([d, torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True))], dim=-1)


def apply_dynamic_world_edges(g: MeshGraph, cfg: DynamicWorldEdges,
                              true_x: Optional[torch.Tensor] = None) -> MeshGraph:
    """``g`` with its world edges found again from the current positions
    (``g.x``, or ``true_x`` when ``cfg.track_predicted`` is False): the
    sidecar's slots when ``g`` has a sidecar, else the tail of its edge
    arrays (rollout.py:_apply_dynamic_world_edges). ``g`` is one frame
    (x [N, F]) or a packed step (x [N, R, F], sidecar [W, R]): one search
    per trajectory, batched over R."""
    src = g.x if (cfg.track_predicted or true_x is None) else true_x
    wp = src[..., cfg.world_pos_start:cfg.world_pos_end].float()
    t = g.node_type
    obs = ((t == int(NodeType.OBSTACLE)) | (t == int(NodeType.HANDLE))) & g.node_mask
    nrm = (t == int(NodeType.NORMAL)) & g.node_mask
    packed = wp.ndim == 3
    if packed:  # [N, R, D] -> one [R, N, D] search, the masks shared
        wp = wp.transpose(0, 1)
    a, b, valid = radius_edges(wp, wp, cfg.radius, cfg.budget, mask_a=obs, mask_b=nrm,
                               k_per_node=cfg.k_per_node)
    if g.wedge_senders is not None:
        return _into_sidecar(g, cfg, a, b, valid, packed)
    if packed:
        raise ValueError("a packed rollout takes its world edges as a sidecar: the concat "
                         "layout's edge arrays are shared by the trajectories")
    budget = cfg.budget
    off = g.senders.shape[0] - 2 * budget
    if off < 0:
        raise ValueError(f"{g.senders.shape[0]} edge slots hold no tail of 2 x {budget}")
    senders = torch.cat([g.senders[:off], a, b])
    receivers = torch.cat([g.receivers[:off], b, a])
    emask = torch.cat([g.edge_mask[:off], valid, valid])
    g = g.replace(senders=senders, receivers=receivers, edge_mask=emask)
    if g.edge_attr is not None:
        feats = _mesh_features(g.pos, senders[off:], receivers[off:]).to(g.edge_attr.dtype)
        fe = feats.shape[-1]
        tail = torch.cat([feats, g.edge_attr[off:, fe:]], dim=-1)
        g = g.replace(edge_attr=torch.cat([g.edge_attr[:off], tail]))
    return g


def _into_sidecar(g: MeshGraph, cfg: DynamicWorldEdges, a, b, valid, packed) -> MeshGraph:
    """The pairs of a search ([budget] or [R, budget]) as ``g``'s sidecar."""
    n = g.x.shape[0]
    w = g.wedge_senders.shape[0]
    if w < 2 * cfg.budget:
        raise ValueError(f"a sidecar of {w} slots holds no 2 x {cfg.budget} world edges")
    axis = -1  # the slot axis of the search's arrays
    mask = torch.cat([valid, valid], dim=axis)
    send = torch.where(mask, torch.cat([a, b], dim=axis), 0)
    recv = torch.where(mask, torch.cat([b, a], dim=axis), n - 1)
    if packed:  # [R, 2·budget] -> [2·budget, R]
        mask, send, recv = mask.t(), send.t(), recv.t()
    pad = w - 2 * cfg.budget

    def fill(used, rest):
        return torch.cat([used, rest[2 * cfg.budget:]]) if pad else used

    rep = dict(wedge_senders=fill(send.to(g.wedge_senders.dtype), g.wedge_senders),
               wedge_receivers=fill(recv.to(g.wedge_receivers.dtype), g.wedge_receivers),
               wedge_mask=fill(mask, g.wedge_mask))
    if g.wedge_attr is not None:
        feats = _mesh_features(g.pos, send, recv)
        feats = torch.where(mask[..., None], feats, 0.0).to(g.wedge_attr.dtype)
        fe = feats.shape[-1]
        used = torch.cat([feats, g.wedge_attr[:2 * cfg.budget, ..., fe:]], dim=-1)
        rep["wedge_attr"] = fill(used, g.wedge_attr)
    return g.replace(**rep)


def _rollout(simulator: Simulator, frames: MeshGraph, mask_types, frame_transform=None,
             previous_data_slice: Optional[Tuple[int, int]] = None,
             dynamic_world_edges: Optional[DynamicWorldEdges] = None) -> RolloutResult:
    ois, oie = simulator.output_index_start, simulator.output_index_end
    steps = frames.x.shape[0]
    last_pred = frames.x[0, ..., ois:oie].float()
    last_prev = None
    if previous_data_slice is not None:
        ps, pe = previous_data_slice
        last_prev = frames.x[0, ..., ps:pe].float()
    bc = bc_mask(frames)
    loss_rows = node_loss_mask(frames, mask_types)
    preds, val_losses, sq_sums, counts = [], [], [], []
    for t in range(steps):
        x = frames.x[t].clone()
        x[..., ois:oie] = last_pred
        if last_prev is not None:
            x[..., ps:pe] = last_prev
        g = frames.replace(x=x, y=frames.y[t], **{
            name: getattr(frames, name)[t] for name in WEDGE_FIELDS
            if getattr(frames, name) is not None})
        if dynamic_world_edges is not None:
            g = apply_dynamic_world_edges(g, dynamic_world_edges, true_x=frames.x[t])
        if frame_transform is not None:
            g = frame_transform(g)
        predicted = simulator.forward(g, is_training=False).outputs
        target = frames.y[t]
        predicted = torch.where(_rows(bc, predicted), target, predicted)
        if last_prev is not None:
            last_prev = predicted - x[..., ois:oie]
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


def make_rollout_fn(simulator: Simulator, previous_data_slice: Optional[Tuple[int, int]] = None,
                    mask_types=DEFAULT_MASK_TYPES, frame_transform=None,
                    dynamic_world_edges: Optional[DynamicWorldEdges] = None):
    """``rollout(frames) -> RolloutResult`` for one trajectory, frames with
    x [T, N, F] and y [T, N, F_out] (rollout.py:make_rollout_fn);
    ``frame_transform(graph) -> graph`` runs on each step's graph,
    ``previous_data_slice`` and ``dynamic_world_edges`` as the module
    says."""

    @torch.no_grad()
    def rollout(frames: MeshGraph) -> RolloutResult:
        return _rollout(simulator, frames, mask_types, frame_transform, previous_data_slice,
                        dynamic_world_edges)

    return rollout


def make_batched_rollout_fn(simulator: Simulator,
                            previous_data_slice: Optional[Tuple[int, int]] = None,
                            mask_types=DEFAULT_MASK_TYPES, frame_transform=None,
                            dynamic_world_edges: Optional[DynamicWorldEdges] = None):
    """``rollout(frames) -> RolloutResult`` for R same-mesh trajectories
    packed as x [T, N, R, F] and y [T, N, R, F_out], so each step is one
    packed forward; metrics are per trajectory ([R], [T, R])
    (rollout.py:make_batched_rollout_fn); the other arguments as
    :func:`make_rollout_fn` takes them (world edges in a sidecar, one
    search per trajectory)."""

    @torch.no_grad()
    def rollout(frames: MeshGraph) -> RolloutResult:
        if frames.x.ndim != 4:
            raise ValueError(f"expected x [T, N, R, F], got {tuple(frames.x.shape)}")
        return _rollout(simulator, frames, mask_types, frame_transform, previous_data_slice,
                        dynamic_world_edges)

    return rollout
