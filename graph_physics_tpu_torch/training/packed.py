"""Trajectory-major packed batching (counterpart of graph_physics_tpu/training/packed.py).

When every sample of a batch shares one topology, node data laid out as
``[N, B, F]`` makes each gather and each kernel row move ``B·F`` values
at once; the per-node metadata and edge index arrays stay shared.
"""

from __future__ import annotations

import numpy as np
import torch

from graph_physics_tpu_torch.core.graph import MeshGraph


def _shared(a, name: str):
    """Check that a [B, ...] array is identical across B; return element 0."""
    a = np.asarray(a)
    if not (a == a[0]).all():
        raise ValueError(f"packed batching requires shared {name} across the batch")
    return a[0]


def pack(stacked: MeshGraph) -> MeshGraph:
    """[B, N, F]-stacked host MeshGraph (shared topology) -> [N, B, F]-packed
    (packed.py:pack)."""

    def node_field(a):
        return None if a is None else np.ascontiguousarray(np.moveaxis(np.asarray(a), 0, 1))

    return MeshGraph(
        x=node_field(stacked.x),
        pos=_shared(stacked.pos, "pos"),
        node_type=_shared(stacked.node_type, "node_type"),
        node_mask=_shared(stacked.node_mask, "node_mask"),
        senders=_shared(stacked.senders, "senders"),
        receivers=_shared(stacked.receivers, "receivers"),
        edge_mask=_shared(stacked.edge_mask, "edge_mask"),
        edge_attr=node_field(stacked.edge_attr),
        y=node_field(stacked.y),
        n_node=None if stacked.n_node is None else int(np.asarray(stacked.n_node).reshape(-1)[0]),
    )


def stack(graphs) -> MeshGraph:
    """Stack same-shape host MeshGraphs on a leading batch axis."""
    g0 = graphs[0]

    def st(name):
        vals = [getattr(g, name) for g in graphs]
        return None if vals[0] is None else np.stack([np.asarray(v) for v in vals])

    return MeshGraph(
        x=st("x"), pos=st("pos"), node_type=st("node_type"), node_mask=st("node_mask"),
        senders=st("senders"), receivers=st("receivers"), edge_mask=st("edge_mask"),
        edge_attr=st("edge_attr"), y=st("y"),
        n_node=None if g0.n_node is None else np.asarray([g.n_node for g in graphs]),
    )


def unpack_nodes(out: torch.Tensor) -> torch.Tensor:
    """[N, B, F] model output -> [B, N, F]."""
    return torch.movedim(out, 0, 1)
