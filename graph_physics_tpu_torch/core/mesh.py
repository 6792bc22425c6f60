"""Host-side mesh -> graph construction (numpy).

Copies of graph_physics_tpu/core/mesh.py:faces_to_edges and k_hop_edges
on the host mesh library (graph_physics_tpu_torch/native.py), of
edge_features and build_mesh_graph, and of the world-edge discovery:
radius_world_edges, world_edge_exclude_keys and budget_world_pairs
(scipy's cKDTree, the path JAX takes without its library, whose pair
order differs from the library's grid).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from graph_physics_tpu_torch import native
from graph_physics_tpu_torch.core import padding
from graph_physics_tpu_torch.core.graph import PAD_NODE_TYPE, MeshGraph
from graph_physics_tpu_torch.core.nodetype import NodeType


def tetra_to_faces(tets: np.ndarray) -> np.ndarray:
    """Expand [C, 4] tetrahedra into their 4 triangular faces [4C, 3]
    (copy of graph_physics_tpu/core/mesh.py:tetra_to_faces)."""
    t = np.asarray(tets)
    return np.concatenate(
        [t[:, [0, 1, 2]], t[:, [0, 1, 3]], t[:, [0, 2, 3]], t[:, [1, 2, 3]]], axis=0
    )


def faces_to_edges(faces: np.ndarray, num_nodes: int) -> np.ndarray:
    """Unique undirected edges (both directions) from simplex cells, by the
    host mesh library (graph_physics_tpu/core/mesh.py:faces_to_edges on its
    library path; native.faces_to_edges_plain is the numpy path). Returns
    int32 [2, E], sorted by receiver then sender, no self-loops."""
    return native.faces_to_edges(faces, num_nodes)


def k_hop_edges(edge_index: np.ndarray, num_nodes: int, k: int) -> np.ndarray:
    """k-hop neighbourhood edges, self-loops removed, sorted by receiver
    then sender, by the host mesh library (graph_physics_tpu/core/mesh.py:
    k_hop_edges on its library path; native.k_hop_plain is the numpy
    path)."""
    return native.k_hop(edge_index, num_nodes, k)


def edge_features(pos: np.ndarray, senders: np.ndarray, receivers: np.ndarray) -> np.ndarray:
    """Per-edge [pos_send - pos_recv, |pos_send - pos_recv|] features
    (copy of graph_physics_tpu/core/mesh.py:edge_features)."""
    d = pos[senders] - pos[receivers]
    n = np.linalg.norm(d, axis=-1, keepdims=True)
    return np.concatenate([d, n], axis=-1).astype(np.float32)


def build_mesh_graph(
    x: np.ndarray,
    pos: np.ndarray,
    node_type: np.ndarray,
    edge_index: np.ndarray,
    y: Optional[np.ndarray] = None,
    n_pad: Optional[int] = None,
    e_pad: Optional[int] = None,
    prev: Optional[np.ndarray] = None,
    next_data: Optional[np.ndarray] = None,
    faces: Optional[np.ndarray] = None,
    c_pad: Optional[int] = None,
    with_edge_features: bool = True,
    traj_index: int = 0,
    time: float = 0.0,
) -> MeshGraph:
    """Assemble a padded host MeshGraph (numpy arrays).

    Copy of graph_physics_tpu/core/mesh.py:build_mesh_graph: edges are
    stably sorted by receiver, padding rows are zero with PAD_NODE_TYPE,
    padded edges point 0 -> n_pad-1 with edge_mask False, cells pad to
    ``c_pad`` with ``face_mask``.
    """
    n = x.shape[0]
    e = edge_index.shape[1]
    n_pad = n_pad or padding.bucket_size(n)
    e_pad = e_pad or padding.bucket_size(e)

    order = np.argsort(edge_index[1], kind="stable")
    edge_index = edge_index[:, order]

    node_mask = np.zeros(n_pad, dtype=bool)
    node_mask[:n] = True
    edge_mask = np.zeros(e_pad, dtype=bool)
    edge_mask[:e] = True

    nt = padding.pad_axis(
        np.asarray(node_type, dtype=np.int32).reshape(-1), n_pad, fill=PAD_NODE_TYPE
    )
    ea = None
    if with_edge_features:
        ea = padding.pad_axis(edge_features(np.asarray(pos), edge_index[0], edge_index[1]),
                              e_pad)

    fc, fm = None, None
    if faces is not None:
        faces = np.asarray(faces, dtype=np.int32)
        c_pad = c_pad or padding.bucket_size(faces.shape[0])
        fm = np.zeros(c_pad, dtype=bool)
        fm[:faces.shape[0]] = True
        fc = padding.pad_axis(faces, c_pad)

    def pad(a):
        if a is None:
            return None
        return padding.pad_axis(np.asarray(a, dtype=np.float32), n_pad)

    return MeshGraph(
        x=pad(x),
        pos=pad(pos),
        node_type=nt,
        node_mask=node_mask,
        senders=padding.pad_axis(edge_index[0].astype(np.int32), e_pad),
        receivers=padding.pad_axis(edge_index[1].astype(np.int32), e_pad, fill=n_pad - 1),
        edge_mask=edge_mask,
        edge_attr=ea,
        y=pad(y),
        n_node=n,
        prev=pad(prev),
        next_data=pad(next_data),
        faces=fc,
        face_mask=fm,
        n_edge=e,
        traj_index=int(traj_index),
        time=np.float32(time),
    )


def radius_world_edges(world_pos: np.ndarray, node_type: np.ndarray, radius: float,
                       exclude_edges: Optional[np.ndarray] = None,
                       exclude_keys: Optional[np.ndarray] = None) -> np.ndarray:
    """World edges: radius pairs between deformable and obstacle nodes,
    int32 [2, E'] (copy of graph_physics_tpu/core/mesh.py:radius_world_edges
    :132 on its path without the native library: one cKDTree over every
    node, then the type filter). Pairs joining {OBSTACLE, HANDLE} with
    NORMAL nodes, both directions, minus the edges already in the mesh
    (``exclude_edges`` [2, E], or their sorted keys ``exclude_keys`` from
    :func:`world_edge_exclude_keys`)."""
    from scipy.spatial import cKDTree

    t = np.asarray(node_type).reshape(-1)
    obs_ids = np.where((t == NodeType.OBSTACLE) | (t == NodeType.HANDLE))[0]
    nrm_ids = np.where(t == NodeType.NORMAL)[0]
    if not obs_ids.size or not nrm_ids.size:
        return np.zeros((2, 0), dtype=np.int32)
    pairs = cKDTree(world_pos).query_pairs(radius, output_type="ndarray")
    if len(pairs) == 0:
        return np.zeros((2, 0), dtype=np.int32)
    a, b = pairs[:, 0], pairs[:, 1]

    def obs(x):
        return (t[x] == NodeType.OBSTACLE) | (t[x] == NodeType.HANDLE)

    def nrm(x):
        return t[x] == NodeType.NORMAL

    keep = (obs(a) & nrm(b)) | (nrm(a) & obs(b))
    a, b = a[keep], b[keep]
    if len(a) == 0:
        return np.zeros((2, 0), dtype=np.int32)
    send = np.concatenate([a, b])
    recv = np.concatenate([b, a])
    existing = exclude_keys
    if existing is None and exclude_edges is not None and exclude_edges.size:
        existing = world_edge_exclude_keys(exclude_edges, world_pos.shape[0])
    if existing is not None and existing.size:
        n = int(max(world_pos.shape[0], 1))
        key = send.astype(np.int64) * n + recv
        idx = np.minimum(np.searchsorted(existing, key), len(existing) - 1)
        keep = existing[idx] != key
        send, recv = send[keep], recv[keep]
    return np.stack([send, recv]).astype(np.int32)


def world_edge_exclude_keys(edge_index: np.ndarray, num_nodes: int) -> np.ndarray:
    """Sorted s·n + r keys of an edge set, for :func:`radius_world_edges`'s
    ``exclude_keys`` (copy of mesh.py:world_edge_exclude_keys :196): the
    mesh is static, so per-frame callers compute them once a trajectory."""
    n = int(max(num_nodes, 1))
    return np.unique(np.asarray(edge_index[0], np.int64) * n + edge_index[1])


def budget_world_pairs(wedges: np.ndarray, world_pos: np.ndarray, budget: int) -> np.ndarray:
    """At most ``budget`` directed world edges, trimmed on undirected pairs
    (both directions kept or dropped together), each node's farthest
    partners first: pairs ranked by the larger of their endpoints' distance
    ranks, then by distance (copy of mesh.py:budget_world_pairs :206).
    Warns with the number dropped."""
    if wedges.shape[1] <= budget:
        return wedges
    import warnings

    s, r = np.asarray(wedges[0], np.int64), np.asarray(wedges[1], np.int64)
    u, v = np.minimum(s, r), np.maximum(s, r)
    pairs = np.unique(np.stack([u, v], axis=1), axis=0)
    p = pairs.shape[0]
    keep_n = budget // 2
    d = np.linalg.norm(np.asarray(world_pos, np.float64)[pairs[:, 0]]
                       - np.asarray(world_pos, np.float64)[pairs[:, 1]], axis=1)
    # each node's distance ranks over both columns of the pairs it is in
    endpoint = np.concatenate([pairs[:, 0], pairs[:, 1]])
    dd = np.concatenate([d, d])
    order = np.lexsort((dd, endpoint))
    grp = np.r_[True, endpoint[order][1:] != endpoint[order][:-1]]
    starts = np.flatnonzero(grp)
    sizes = np.diff(np.r_[starts, 2 * p])
    within = np.arange(2 * p) - np.repeat(starts, sizes)
    rk = np.empty(2 * p, np.int64)
    rk[order] = within
    rank = np.maximum(rk[:p], rk[p:])
    kept = pairs[np.lexsort((d, rank))[:keep_n]]
    warnings.warn(f"world-edge budget exceeded: kept {keep_n} of {p} pairs "
                  f"({2 * (p - keep_n)} directed edges dropped rank-fairly; raise "
                  "world_pos_parameters.edge_budget to keep all)", stacklevel=2)
    return np.concatenate([kept.T, kept.T[::-1]], axis=1).astype(np.int32)
