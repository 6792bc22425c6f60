"""Trajectory-major packed batching (counterpart of graph_physics_tpu/training/packed.py).

When every sample of a batch shares one topology, node data laid out as
``[N, B, F]`` makes each gather and each kernel row move ``B·F`` values
at once; the per-node metadata and edge index arrays stay shared.
:func:`pack_frames` assembles a batch from frames that share their static
leaves as the same numpy objects (the loader's frames do), and with
``broadcast_static`` ships a leaf shared by every frame as an ``[E, 1, F]``
view; the train step widens it on the device (:func:`expand_static_leaves`)
into a contiguous tensor, so no kernel ever reads a stride-0 view. The
world-edge sidecar's leaves (``MeshGraph.wedge_*``) are per sample:
[W] a frame, [W, B] packed, [B, W] stacked, always copied per frame,
never shared as statics.
"""

from __future__ import annotations

import numpy as np
import torch

from graph_physics_tpu_torch import native
from graph_physics_tpu_torch.core.graph import WEDGE_FIELDS, MeshGraph

#: per-sample leaves: [N, F] per frame, [N, B, F] packed
DYNAMIC_FIELDS = ("x", "edge_attr", "y", "prev", "next_data", "deselected", "phi")
#: static (shared-topology) attributes of a packed batch
_STATIC_ATTRS = ("pos", "node_type", "node_mask", "senders", "receivers", "edge_mask",
                 "faces", "face_mask")


def _shared(a, name: str):
    """Check that a [B, ...] array is identical across B; return element 0."""
    a = np.asarray(a)
    if not (a == a[0]).all():
        raise ValueError(f"packed batching requires shared {name} across the batch")
    return a[0]


def _first(a):
    return None if a is None else np.asarray(a).reshape(-1)[0].item()


def pack(stacked: MeshGraph) -> MeshGraph:
    """[B, N, F]-stacked host MeshGraph (shared topology) -> [N, B, F]-packed
    (packed.py:pack)."""

    def node_field(a):
        return None if a is None else np.ascontiguousarray(np.moveaxis(np.asarray(a), 0, 1))

    def shared(name):
        a = getattr(stacked, name)
        return None if a is None else _shared(a, name)

    return stacked.replace(
        **{name: node_field(getattr(stacked, name)) for name in DYNAMIC_FIELDS + WEDGE_FIELDS},
        **{name: shared(name) for name in _STATIC_ATTRS},
        n_node=None if stacked.n_node is None else int(_first(stacked.n_node)),
        n_edge=_first(stacked.n_edge),
        traj_index=_first(stacked.traj_index),
        time=None if stacked.time is None else np.asarray(stacked.time, np.float32),
    )


def stack(graphs) -> MeshGraph:
    """Stack same-shape host MeshGraphs on a leading batch axis; they must
    share one layout object (or none)."""
    g0 = graphs[0]
    if any(g.layout is not g0.layout for g in graphs[1:]):
        raise ValueError("stacked frames must share one edge layout")

    def st(name):
        vals = [getattr(g, name) for g in graphs]
        return None if vals[0] is None else np.stack([np.asarray(v) for v in vals])

    return g0.replace(
        **{name: st(name) for name in DYNAMIC_FIELDS + WEDGE_FIELDS + _STATIC_ATTRS
           + ("n_edge", "traj_index", "time")},
        n_node=None if g0.n_node is None else np.asarray([g.n_node for g in graphs]),
    )


def pack_frames(frames, broadcast_static: bool = False) -> MeshGraph:
    """Frames of one trajectory -> [N, B, F]-packed batch, directly
    (packed.py:pack_frames :109). When the frames share their static leaves
    (and layout) as the same objects, only the dynamic leaves are stacked;
    otherwise the checked ``pack(stack(frames))``. ``broadcast_static``: a
    dynamic-slot leaf that is one object in every frame (the static edge
    features) becomes an [N, 1, F] view instead of B copies. The sidecar's
    leaves are stacked per frame (packed.py:pack_frames :181-184)."""
    f0 = frames[0]
    shared = all(getattr(f, a) is getattr(f0, a)
                 for f in frames[1:] for a in _STATIC_ATTRS + ("layout",))
    if not shared:
        return pack(stack(frames))

    def dyn(name):
        if getattr(f0, name) is None:
            return None
        vals = [np.asarray(getattr(f, name)) for f in frames]
        if all(v is vals[0] for v in vals[1:]):
            if broadcast_static:
                return vals[0][:, None]
            return native.repeat_rows(vals[0], len(vals))
        return native.pack_rows(vals)

    def per_frame(name):
        if getattr(f0, name) is None:
            return None
        return native.pack_rows([np.asarray(getattr(f, name)) for f in frames])

    return f0.replace(
        **{name: dyn(name) for name in DYNAMIC_FIELDS},
        **{name: per_frame(name) for name in WEDGE_FIELDS},
        time=None if f0.time is None else np.asarray([np.asarray(f.time) for f in frames],
                                                     np.float32),
    )


def finalize_packed(graph: MeshGraph, batch: int, broadcast_static: bool) -> MeshGraph:
    """Give a half-packed graph (``FrameBuilder.build_packed``,
    ``FusedTopologyManager.transform_packed``) its static-slot batch axes:
    edge_attr [E, F] and phi [N] become [E, 1, F] / [N, 1] views under
    ``broadcast_static``, full repeats otherwise, as :func:`pack_frames`
    lays them out (packed.py:finalize_packed :194)."""

    def add_axis(a):
        a = np.asarray(a)
        return a[:, None] if broadcast_static else native.repeat_rows(a, batch)

    rep = {}
    if graph.edge_attr is not None and np.ndim(graph.edge_attr) == 2:
        rep["edge_attr"] = add_axis(graph.edge_attr)
    if graph.phi is not None and np.ndim(graph.phi) == 1:
        rep["phi"] = add_axis(graph.phi)
    return graph.replace(**rep) if rep else graph


def expand_static_leaves(graph: MeshGraph) -> MeshGraph:
    """Widen the [N, 1, F] leaves of a ``broadcast_static`` batch to the
    batch size of ``x`` on the device (packed.py:expand_static_leaves
    :224): contiguous copies, never stride-0 views, so the values equal
    the host-repeated layout's and a kernel reads every row. A no-op for
    unpacked graphs and for leaves at full width."""
    x = graph.x
    if x is None or x.ndim != 3 or graph.node_type.ndim != 1:
        return graph
    b = x.shape[1]
    if b <= 1:
        return graph

    def expand(a):
        if a is None or a.ndim < 2 or a.shape[1] != 1:
            return a
        return a.expand(a.shape[:1] + (b,) + a.shape[2:]).contiguous()

    return graph.replace(**{name: expand(getattr(graph, name)) for name in DYNAMIC_FIELDS})


def unpack_nodes(out: torch.Tensor) -> torch.Tensor:
    """[N, B, F] model output -> [B, N, F]."""
    return torch.movedim(out, 0, 1)
