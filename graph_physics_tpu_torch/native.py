"""Host array helpers of the loader, numpy only.

Copies of the numpy branches that graph_physics_tpu/native/__init__.py's
callers take when its C++ library (``native/meshops.cc``) is not built:
``pack_block`` (:249), ``pack_rows`` (:199), ``repeat_rows`` (:228),
``faces_to_edges`` (:108) and ``k_hop`` (:123). The C++ library itself is
not ported (ROADMAP A 4's remainder); these give the same arrays in the
same order, so the loader's batches are the JAX package's bit for bit.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from graph_physics_tpu_torch.core import mesh as mesh_lib


def pack_block(src: np.ndarray, out: np.ndarray, col: int) -> None:
    """Write one contiguous [B, N, w] block into ``out[:N, :, col:col+w]``
    of the [N', B, F] batch (the numpy branch of
    graph_physics_tpu/dataset/preprocessing.py:FrameBuilder.build_packed's
    per-field write, native/__init__.py:pack_block)."""
    num_b, num_n, w = src.shape
    out[:num_n, :, col:col + w] = src.transpose(1, 0, 2)


def pack_rows(vals: Sequence[np.ndarray]) -> np.ndarray:
    """[B x (N, F...)] frame leaves -> one contiguous [N, B, F...] array: a
    [B, N, F] stack, then one transpose (the numpy branch of
    graph_physics_tpu/training/packed.py:pack_frames, native/__init__.py:
    pack_rows)."""
    return np.ascontiguousarray(np.stack(vals, axis=0).swapaxes(0, 1))


def repeat_rows(val: np.ndarray, num_b: int) -> np.ndarray:
    """One shared (N, F...) leaf -> [N, B, F...], B identical copies (the
    numpy branch of native/__init__.py:repeat_rows's callers)."""
    return np.repeat(np.asarray(val)[:, None], num_b, axis=1)


def faces_to_edges(faces: np.ndarray, num_nodes: int) -> np.ndarray:
    """Unique directed edges of simplex cells, sorted by receiver then
    sender (native/__init__.py:faces_to_edges; core/mesh.faces_to_edges)."""
    return mesh_lib.faces_to_edges(faces, num_nodes)


def k_hop(edge_index: np.ndarray, num_nodes: int, k: int) -> np.ndarray:
    """k-hop edges, sorted by receiver then sender (native/__init__.py:k_hop;
    core/mesh.k_hop_edges)."""
    return mesh_lib.k_hop_edges(edge_index, num_nodes, k)
