"""Mesh-graph container of the port.

Counterpart of graph_physics_tpu/core/graph.py:MeshGraph with the fields
the port's paths use, the per-sample world-edge sidecar (``wedge_*``,
graph.py:68-87) among them. The same padding rules hold:

  * padded node rows are zero and carry ``node_type = PAD_NODE_TYPE``;
  * padded edges have ``senders == 0``, ``receivers == N-1`` and
    ``edge_mask`` False, and their messages are zeroed before any sum;
  * so do the sidecar's unused world-edge slots.

A host-built graph holds numpy arrays (``core/mesh.py``, ``ops/tiling.py``,
``training/packed.py`` work on those); :meth:`MeshGraph.from_numpy` puts
it on a torch device. Node fields are ``[N, F]`` for one frame,
``[N, B, F]`` in the packed layout, where the per-node metadata
(``node_type``, ``node_mask``) and the edge index arrays stay shared, and
``[B, N, F]`` in the stacked layout (training/packed.stack), where every
field has the batch axis first. A graph laid out for the kernels
(training/fused.py) carries its layout in ``layout``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

#: node_type value assigned to padding rows; outside every NodeType code.
PAD_NODE_TYPE = -1


def contiguous(a) -> np.ndarray:
    """``a`` as a C-contiguous array of its own shape (0-d stays 0-d)."""
    return np.ascontiguousarray(a).reshape(np.shape(a))


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
    prev: Optional[Any] = None  # [N, P] previous-step feature block
    next_data: Optional[Any] = None  # [N, Q] dynamic non-target fields at t+1
    deselected: Optional[Any] = None  # [N] bool, True = node masked out of the loss
    phi: Optional[Any] = None  # [N] per-node gate scalar of a feature hook
    faces: Optional[Any] = None  # [C, 3] or [C, 4] int32 cells (least-squares gradients)
    face_mask: Optional[Any] = None  # [C] bool
    n_edge: Optional[Any] = None  # true edge count
    traj_index: Optional[Any] = None  # trajectory id
    time: Optional[Any] = None  # physical time of the frame ([B] when packed)
    #: the NKTiling or CSRLayout the edge arrays are laid out in (ops/tiling.py)
    layout: Optional[Any] = None
    #: the world-edge sidecar: world edges change every frame (radius pairs
    #: between deformable and obstacle nodes), so they ride beside the
    #: static mesh edges as per-sample arrays padded to a fixed budget W:
    #: [W] one frame, [W, B] packed, [B, W] stacked (int32, bool mask);
    #: unused slots have sender 0, receiver N-1 and mask False
    wedge_senders: Optional[Any] = None
    wedge_receivers: Optional[Any] = None
    wedge_mask: Optional[Any] = None
    #: [W, Fe] / [W, B, Fe] / [B, W, Fe] world-edge features (the GraphNetBlock
    #: family consumes them; transformers do not)
    wedge_attr: Optional[Any] = None

    def replace(self, **changes) -> "MeshGraph":
        return dataclasses.replace(self, **changes)

    @classmethod
    def from_numpy(cls, host: "MeshGraph", device, put=None) -> "MeshGraph":
        """Copy a host graph of numpy arrays to ``device`` as new tensors.

        Floating arrays become float32, index arrays int32 and masks bool;
        every tensor is contiguous (the fused kernel reads whole rows). The
        cells go too, as the physics losses' least-squares gradients read
        them in the step. ``put(array, dtype)`` replaces the copy (the
        loader's pinned, asynchronous one).
        """

        def copy(a, dtype):
            return torch.tensor(contiguous(a), dtype=dtype, device=device)

        put = put or copy
        tensors = {name: None if getattr(host, name) is None else put(getattr(host, name), dtype)
                   for name, dtype in TENSOR_FIELDS.items()}
        return cls(**tensors, n_node=_node_count(host.n_node),
                   n_edge=_node_count(host.n_edge), traj_index=_node_count(host.traj_index),
                   layout=host.layout)


#: the fields that :meth:`MeshGraph.from_numpy` puts on the device, with their dtypes
TENSOR_FIELDS = {
    "x": torch.float32, "pos": torch.float32, "node_type": torch.int32,
    "node_mask": torch.bool, "senders": torch.int32, "receivers": torch.int32,
    "edge_mask": torch.bool, "edge_attr": torch.float32, "y": torch.float32,
    "prev": torch.float32, "next_data": torch.float32, "deselected": torch.bool,
    "phi": torch.float32, "time": torch.float32, "wedge_senders": torch.int32,
    "wedge_receivers": torch.int32, "wedge_mask": torch.bool, "wedge_attr": torch.float32,
    "faces": torch.int32, "face_mask": torch.bool,
}

#: the world-edge sidecar's fields
WEDGE_FIELDS = ("wedge_senders", "wedge_receivers", "wedge_mask", "wedge_attr")
