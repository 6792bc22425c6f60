"""Sub-mesh partitions: recursive coordinate bisection (RCB) of a mesh.

Counterpart of graph_physics_tpu/dataset/partition.py (:27-105):
``rcb_partition``, ``num_parts_for``, ``extract_subgraph`` and
``PartitionCache``. The JAX package replaces the reference's METIS with
RCB; a trajectory's frames train as independent sub-meshes, one sample
per (frame, part).

``rcb_partition`` is JAX's path through its C++ library
(partition.py:37-41), here through the port's copy of that library
(native.rcb_labels). JAX's numpy recursion (:43-56), taken where its
library does not build, cuts at Python's ``round`` and breaks coordinate
ties by the order of the current ids, and so gives other parts on some
meshes; the port does not copy it. native.rcb_labels_plain is the numpy
version of the library's recursion.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from graph_physics_tpu_torch import native


def rcb_partition(pos: np.ndarray, num_parts: int) -> List[np.ndarray]:
    """``num_parts`` sorted node-id arrays, balanced within one node at
    every split (partition.py:rcb_partition): each split cuts its widest
    axis at the size-proportional quantile."""
    n = pos.shape[0]
    if num_parts <= 1 or n <= 1:
        return [np.arange(n)]
    labels = native.rcb_labels(np.asarray(pos, np.float32), num_parts)
    return [np.sort(np.where(labels == p)[0]) for p in range(num_parts)]


def num_parts_for(num_nodes: int, num_partitions: Optional[int],
                  max_nodes_per_partition: Optional[int]) -> int:
    """The part count: enough parts of at most ``max_nodes_per_partition``
    nodes where that is given, else ``num_partitions``
    (partition.py:num_parts_for)."""
    if max_nodes_per_partition:
        return max(int(np.ceil(num_nodes / max_nodes_per_partition)), 1)
    return max(int(num_partitions or 1), 1)


def extract_subgraph(node_ids: np.ndarray, edge_index: np.ndarray,
                     num_nodes: int) -> Tuple[np.ndarray, np.ndarray]:
    """(the part's edges relabelled to its local ids, int32 [2, E_p]; the
    global -> local map [N], -1 off the part) (partition.py:extract_subgraph):
    an edge stays when both its ends lie in the part."""
    mapping = np.full(num_nodes, -1, dtype=np.int64)
    mapping[node_ids] = np.arange(len(node_ids))
    s = mapping[edge_index[0]]
    r = mapping[edge_index[1]]
    keep = (s >= 0) & (r >= 0)
    return np.stack([s[keep], r[keep]]).astype(np.int32), mapping


class PartitionCache:
    """Each trajectory's parts and their subgraphs, computed once
    (partition.py:PartitionCache)."""

    def __init__(self, num_partitions: Optional[int], max_nodes: Optional[int]):
        self.num_partitions = num_partitions
        self.max_nodes = max_nodes
        self._cache: Dict = {}

    def parts_for(self, key, pos: np.ndarray, edge_index: np.ndarray):
        """(parts, [extract_subgraph of each part]) of the mesh ``key``."""
        if key not in self._cache:
            parts = rcb_partition(pos, num_parts_for(len(pos), self.num_partitions,
                                                     self.max_nodes))
            self._cache[key] = (parts, [extract_subgraph(ids, edge_index, len(pos))
                                        for ids in parts])
        return self._cache[key]
