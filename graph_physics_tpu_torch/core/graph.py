"""Mesh-graph container of the port.

Counterpart of graph_physics_tpu/core/graph.py:MeshGraph with the fields
the inference slice uses. The same padding rules hold:

  * padded node rows are zero and carry ``node_type = PAD_NODE_TYPE``;
  * padded edges have ``senders == 0``, ``receivers == N-1`` and
    ``edge_mask`` False, and their messages are zeroed before any sum.

A host-built graph holds numpy arrays (``core/mesh.py``, ``ops/tiling.py``,
``training/packed.py`` work on those); :meth:`MeshGraph.from_numpy` puts
it on a torch device. Node fields are ``[N, F]`` for one frame,
``[N, B, F]`` in the packed layout, where the per-node metadata
(``node_type``, ``node_mask``) and the edge index arrays stay shared, and
``[B, N, F]`` in the stacked layout (training/packed.stack), where every
field has the batch axis first.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

#: node_type value assigned to padding rows; outside every NodeType code.
PAD_NODE_TYPE = -1


def _node_count(n):
    """An int, or a tuple of ints for a stacked batch's [B] counts."""
    if n is None:
        return None
    a = np.asarray(n)
    return int(a) if a.ndim == 0 else tuple(int(v) for v in a)


@dataclass
class MeshGraph:
    """One (possibly padded, possibly packed) mesh frame."""

    x: Any  # [N, F] or [N, B, F] node features
    pos: Any  # [N, D] mesh positions
    node_type: Any  # [N] int32, PAD_NODE_TYPE on padding
    node_mask: Any  # [N] bool, True on valid nodes
    senders: Any  # [E] int32 (0 on padding)
    receivers: Any  # [E] int32 (N-1 on padding)
    edge_mask: Any  # [E] bool, True on valid edges
    edge_attr: Optional[Any] = None  # [E, Fe] or [E, B, Fe]
    y: Optional[Any] = None  # [N, T] or [N, B, T] next-step targets
    n_node: Optional[Any] = None  # true node count; stacked: one per sample

    def replace(self, **changes) -> "MeshGraph":
        return dataclasses.replace(self, **changes)

    @classmethod
    def from_numpy(cls, host: "MeshGraph", device) -> "MeshGraph":
        """Copy a host graph of numpy arrays to ``device`` as new tensors.

        Floating arrays become float32, index arrays int32 and masks bool;
        every tensor is contiguous (the fused kernel reads whole rows).
        """

        def put(a, dtype):
            if a is None:
                return None
            return torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

        return cls(
            x=put(host.x, torch.float32),
            pos=put(host.pos, torch.float32),
            node_type=put(host.node_type, torch.int32),
            node_mask=put(host.node_mask, torch.bool),
            senders=put(host.senders, torch.int32),
            receivers=put(host.receivers, torch.int32),
            edge_mask=put(host.edge_mask, torch.bool),
            edge_attr=put(host.edge_attr, torch.float32),
            y=put(host.y, torch.float32),
            n_node=_node_count(host.n_node),
        )
