"""Simulator: normalization and the Δ-target contract around the processor.

Counterpart of graph_physics_tpu/models/simulator.py:Simulator:
  * inputs  = x[..., fis:fie] ⧺ one_hot(node_type, 9), normalized by the
    node normalizer;
  * edge features normalized by the edge normalizer;
  * target  = normalize(y − x[..., ois:oie]) (accumulating in training);
  * outputs = inverse-normalize(net_out) + x[..., ois:oie] in eval.

The normalizer statistics are buffers of this module (the JAX package
threads them as an explicit SimulatorState); ``state_dict()`` names follow
the reference Simulator (``model.*``, ``_output_normalizer.*``,
``_node_normalizer.*``, ``_edge_normalizer.*``). Three layouts are
accepted: the packed ``[N, B, F]`` layout (shared ``[N]`` node metadata),
the stacked ``[B, N, F]`` layout (``[B, N]`` node metadata, where JAX
vmaps the processor per sample; the processor takes the batch axis as
it is), and a single ``[N, F]`` frame. In every layout the normalizers
accumulate over all valid rows of the batch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from graph_physics_tpu_torch.core.graph import MeshGraph
from graph_physics_tpu_torch.core.nodetype import NodeType
from graph_physics_tpu_torch.models.normalizer import Normalizer


@dataclass
class SimulatorOutput:
    net_out: torch.Tensor  # [.., out] normalized-space prediction
    target_norm: Optional[torch.Tensor]  # [.., out] normalized Δ target
    outputs: Optional[torch.Tensor]  # [.., out] physical-space prediction (eval)


class Simulator(nn.Module):
    def __init__(
        self,
        node_input_size: int,
        edge_input_size: int,
        output_size: int,
        feature_index_start: int,
        feature_index_end: int,
        output_index_start: int,
        output_index_end: int,
        node_type_index: int,
        model: nn.Module,
    ):
        super().__init__()
        self.node_input_size = node_input_size
        self.edge_input_size = edge_input_size if edge_input_size > 0 else None
        self.output_size = output_size
        self.feature_index_start = feature_index_start
        self.feature_index_end = feature_index_end
        self.output_index_start = output_index_start
        self.output_index_end = output_index_end
        self.node_type_index = node_type_index
        self.model = model
        self._output_normalizer = Normalizer(output_size)
        self._node_normalizer = Normalizer(node_input_size)
        self._edge_normalizer = (
            Normalizer(edge_input_size) if self.edge_input_size is not None else None)

    @staticmethod
    def is_packed(graph: MeshGraph) -> bool:
        """Packed layout: x [N, B, F] with shared per-node metadata [N]."""
        return graph.x.ndim == 3 and graph.node_type.ndim == 1

    def pre_target(self, graph: MeshGraph) -> torch.Tensor:
        """x[..., ois:oie] — the current value of the predicted fields."""
        return graph.x[..., self.output_index_start:self.output_index_end]

    def one_hot_type(self, graph: MeshGraph) -> torch.Tensor:
        """one_hot(node_type, NodeType.SIZE); PAD (-1) rows are all zero."""
        t = graph.node_type.long()
        oh = F.one_hot(t.clamp(min=0), int(NodeType.SIZE)).float()
        oh = oh * (t >= 0).unsqueeze(-1).float()
        if self.is_packed(graph):  # [N, 9] -> [N, B, 9]
            oh = oh.unsqueeze(1).expand(oh.shape[0], graph.x.shape[1], oh.shape[-1])
        return oh

    def prepare(self, graph: MeshGraph, is_training: bool
                ) -> Tuple[MeshGraph, Optional[torch.Tensor], torch.Tensor]:
        """Normalized input graph, normalized Δ target (None without ``y``)
        and the current predicted fields; statistics accumulate when
        ``is_training``."""
        node_mask, edge_mask = graph.node_mask, graph.edge_mask
        if self.is_packed(graph):  # shared [N] masks -> per-row [N, B]
            b = graph.x.shape[1]
            node_mask = node_mask[:, None].expand(node_mask.shape[0], b)
            edge_mask = edge_mask[:, None].expand(edge_mask.shape[0], b)

        pre_t = self.pre_target(graph)
        target_norm = None
        if graph.y is not None:
            target_norm = self._output_normalizer.normalize(
                graph.y - pre_t, node_mask, accumulate=is_training)

        feats = graph.x[..., self.feature_index_start:self.feature_index_end]
        feats = torch.cat([feats, self.one_hot_type(graph)], dim=-1)
        feats_n = self._node_normalizer.normalize(feats, node_mask, accumulate=is_training)

        edge_attr = graph.edge_attr
        if self._edge_normalizer is not None and edge_attr is not None:
            edge_attr = self._edge_normalizer.normalize(
                edge_attr[..., :self.edge_input_size], edge_mask, accumulate=is_training)
        return graph.replace(x=feats_n, edge_attr=edge_attr, y=target_norm), target_norm, pre_t

    def forward(self, graph: MeshGraph, is_training: bool = False,
                gumbel: Optional[torch.Generator] = None) -> SimulatorOutput:
        """Training: (net_out, target_norm). Eval also returns physical
        outputs, and runs without autograd. ``gumbel``, a generator, goes
        to a processor that draws training-time noise (JAX's ``rngs``)."""
        with torch.set_grad_enabled(is_training and torch.is_grad_enabled()):
            g_in, target_norm, pre_t = self.prepare(graph, is_training)
            net_out = self.model(g_in) if gumbel is None else self.model(g_in, gumbel=gumbel)
            outputs = None if is_training else self.build_outputs_from_pre(net_out, pre_t)
        return SimulatorOutput(net_out=net_out, target_norm=target_norm, outputs=outputs)

    def build_outputs_from_pre(self, net_out: torch.Tensor, pre_t: torch.Tensor) -> torch.Tensor:
        """Inverse-normalize the predicted Δ and add the current value."""
        return self._output_normalizer.inverse(net_out) + pre_t
