"""Per-step graph transforms on the device, composed into the train step
and the rollout.

Counterpart of graph_physics_tpu/training/transforms.py (:33-125). The
structural preprocessing (edges, world-edge discovery) runs on the host
when frames are built (dataset/preprocessing.py); what depends on the
step's values runs here:

  * noise on the configured columns of x (training/noise.py);
  * the world-position edge features [Δworld_pos, ‖Δworld_pos‖] appended
    to ``edge_attr`` (and to the sidecar's ``wedge_attr``), from the
    current x: in training they see the noised positions, in a rollout
    the predicted ones.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from graph_physics_tpu_torch.core.graph import MeshGraph
from graph_physics_tpu_torch.ops.world_gather import wtake
from graph_physics_tpu_torch.training.noise import add_noise
from graph_physics_tpu_torch.training.step import NoiseConfig


@dataclass(frozen=True)
class WorldPosConfig:
    start: int  # the world positions' columns of x
    end: int


def _relative(wp: torch.Tensor, senders: torch.Tensor, receivers: torch.Tensor,
              per_sample: bool) -> torch.Tensor:
    """wp[senders] - wp[receivers] for one graph or a packed batch (node
    axis 0: [N, D], [N, B, D]), per sample for a packed sidecar ([W, B]
    indices, ``per_sample``), or for a stacked batch ([B, N, D] with [B, E]
    indices)."""
    if per_sample:
        return wtake(wp, senders) - wtake(wp, receivers)
    if senders.ndim == 1:
        return wp.index_select(0, senders) - wp.index_select(0, receivers)

    def take(idx):
        return torch.gather(wp, -2, idx.long()[..., None].expand(idx.shape + wp.shape[-1:]))

    return take(senders) - take(receivers)


def append_world_pos_features(graph: MeshGraph, cfg: WorldPosConfig) -> MeshGraph:
    """edge_attr ⧺= [world_pos[send] - world_pos[recv], its norm], and the
    same columns on the sidecar's ``wedge_attr`` when it has one
    (transforms.py:append_world_pos_features :38)."""
    wp = graph.x[..., cfg.start:cfg.end]
    rel = _relative(wp, graph.senders, graph.receivers, per_sample=False)
    cols = [rel, torch.linalg.vector_norm(rel, dim=-1, keepdim=True)]
    ea = torch.cat(cols if graph.edge_attr is None else [graph.edge_attr, *cols], dim=-1)
    wea = graph.wedge_attr
    if wea is not None:
        per_sample = graph.wedge_senders.ndim == 2 and graph.node_type.ndim == 1
        wrel = _relative(wp, graph.wedge_senders, graph.wedge_receivers, per_sample)
        wea = torch.cat([wea, wrel, torch.linalg.vector_norm(wrel, dim=-1, keepdim=True)],
                        dim=-1)
    return graph.replace(edge_attr=ea, wedge_attr=wea)


def make_device_preprocess(noise_cfg: Optional[NoiseConfig] = None,
                           world_cfg: Optional[WorldPosConfig] = None,
                           num_steps: int = 1) -> Optional[Callable]:
    """``fn(graph, generator, step) -> graph`` for the train step, or None
    when there is nothing to do (transforms.py:make_device_preprocess
    :78): noise first, then the world-position features from the noised
    x, in the reference's order. ``num_steps`` scales the noise
    curriculum's progress."""
    if noise_cfg is None and world_cfg is None:
        return None

    def fn(graph: MeshGraph, generator: torch.Generator, step: int) -> MeshGraph:
        if noise_cfg is not None and noise_cfg.enabled:
            t = step / max(num_steps, 1) if noise_cfg.curriculum else None
            graph = add_noise(graph, generator, noise_cfg.starts, noise_cfg.ends,
                              noise_cfg.scales, t=t)
        if world_cfg is not None:
            graph = append_world_pos_features(graph, world_cfg)
        return graph

    return fn


def make_eval_transform(world_cfg: Optional[WorldPosConfig] = None) -> Optional[Callable]:
    """``fn(graph) -> graph`` for rollout frames, without noise
    (transforms.py:make_eval_transform :110), or None."""
    if world_cfg is None:
        return None

    def fn(graph: MeshGraph) -> MeshGraph:
        return append_world_pos_features(graph, world_cfg)

    return fn
