"""Simulator: normalization and the Δ-target contract around the processor.

Counterpart of graph_physics_tpu/models/simulator.py:Simulator:
  * inputs  = x[..., fis:fie] ⧺ one_hot(node_type, 9), normalized by the
    node normalizer;
  * edge features normalized by the edge normalizer (one normalizer over
    the mesh edges and a world-edge sidecar's together);
  * target  = normalize(y − x[..., ois:oie]) (accumulating in training);
  * outputs = inverse-normalize(net_out) + x[..., ois:oie] in eval.

The normalizer statistics are buffers of this module (the JAX package
threads them as an explicit SimulatorState); ``state_dict()`` names follow
the reference Simulator (``model.*``, ``_output_normalizer.*``,
``_node_normalizer.*``, ``_edge_normalizer.*``). Three layouts are
accepted: the packed ``[N, B, F]`` layout (shared ``[N]`` node metadata),
the stacked ``[B, N, F]`` layout (``[B, N]`` node metadata and edge
arrays, where JAX vmaps the processor per sample: the Transolver takes the
batch axis as it is, the other processors run sample by sample), and a
single ``[N, F]`` frame. In every layout the normalizers accumulate over
all valid rows of the batch.
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

    @staticmethod
    def is_stacked(graph: MeshGraph) -> bool:
        """Stacked layout: x [B, N, F] with per-sample node metadata [B, N]."""
        return graph.x.ndim == 3 and graph.node_type.ndim == 2

    def apply_model(self, g_in: MeshGraph, gumbel: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
        """The processor on the normalized graph; on a stacked batch, sample
        by sample unless the processor takes the batch axis itself
        (``takes_stacked``), as JAX vmaps it."""
        kw = {} if gumbel is None else {"gumbel": gumbel}
        if not self.is_stacked(g_in) or getattr(self.model, "takes_stacked", False):
            return self.model(g_in, **kw)
        outs = [self.model(sample_of(g_in, b), **kw) for b in range(g_in.x.shape[0])]
        return torch.stack(outs)

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

        edge_attr, wedge_attr = graph.edge_attr, graph.wedge_attr
        if self._edge_normalizer is not None and edge_attr is not None:
            k = self.edge_input_size
            if wedge_attr is None:
                edge_attr = self._edge_normalizer.normalize(edge_attr[..., :k], edge_mask,
                                                            accumulate=is_training)
            else:
                # the world-edge sidecar: one normalizer over the mesh and
                # world edges, concatenated along the edge axis (simulator.py:
                # 174-201; axis 1 of a stacked batch)
                axis = 1 if self.is_stacked(graph) else 0
                e_all = self._edge_normalizer.normalize(
                    torch.cat([edge_attr[..., :k], wedge_attr[..., :k]], dim=axis),
                    torch.cat([edge_mask, graph.wedge_mask.to(edge_mask.dtype)], dim=axis),
                    accumulate=is_training)
                edge_attr, wedge_attr = e_all.split(
                    [edge_attr.shape[axis], wedge_attr.shape[axis]], dim=axis)
        return (graph.replace(x=feats_n, edge_attr=edge_attr, wedge_attr=wedge_attr,
                              y=target_norm), target_norm, pre_t)

    def forward(self, graph: MeshGraph, is_training: bool = False,
                gumbel: Optional[torch.Generator] = None) -> SimulatorOutput:
        """Training: (net_out, target_norm). Eval also returns physical
        outputs, and runs without autograd. ``gumbel``, a generator, goes
        to a processor that draws training-time noise (JAX's ``rngs``)."""
        with torch.set_grad_enabled(is_training and torch.is_grad_enabled()):
            g_in, target_norm, pre_t = self.prepare(graph, is_training)
            net_out = self.apply_model(g_in, gumbel)
            outputs = None if is_training else self.build_outputs_from_pre(net_out, pre_t)
        return SimulatorOutput(net_out=net_out, target_norm=target_norm, outputs=outputs)

    def build_outputs_from_pre(self, net_out: torch.Tensor, pre_t: torch.Tensor) -> torch.Tensor:
        """Inverse-normalize the predicted Δ and add the current value."""
        return self._output_normalizer.inverse(net_out) + pre_t


def sample_of(graph: MeshGraph, b: int) -> MeshGraph:
    """Sample ``b`` of a stacked batch: every tensor field indexed on its
    batch axis."""
    def take(v):
        return v[b] if isinstance(v, torch.Tensor) and v.ndim > 0 else v

    return graph.replace(**{name: take(getattr(graph, name))
                            for name in graph.__dataclass_fields__
                            if name not in ("layout", "n_node")},
                         n_node=(graph.n_node[b] if isinstance(graph.n_node, tuple)
                                 else graph.n_node))
