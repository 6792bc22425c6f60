"""Per-topology choice of the kernels' edge layout.

Counterpart of the layout part of graph_physics_tpu/training/fused.py:
FusedTopologyManager (:31-519): the per-topology cache (:257-277), the
NK-vs-CSR pricing (:339-382) and ``transform_frame`` (:476-519). A mesh of
near-uniform degree takes the NK slot layout (ops/tiling.NKTiling, the NK
kernels); a degree-graded one, whose slot rows would exceed the CSR rows
by more than the NK kernels' constant advantage, takes the CSR layout
(ops/tiling.CSRLayout, the CSR kernels).

Left out, with their reasons:
  * the jit step cache (``step_for``, ``key_for``): PyTorch runs eagerly;
  * ``wb_buckets`` and the RCM reorder: they serve the TPU kernel's sender
    windows, which the CSR layout does not have;
  * ``transform_packed`` and the static-template fast path: they belong
    to the loader (ROADMAP A 8);
  * ``NKBucketTiling`` (:320-338): where JAX may take the per-block-K NK
    layout for an ``epd`` model, this manager takes the CSR or the
    global-K NK layout. That changes the kernels' schedule, not the
    function the model computes.

Two differences of the port's layouts show in the pricing. The CSR rows
are the valid edges padded to a multiple of 128 (JAX prices its blocked
layout's rows, each node block padded to the largest block's edge count),
so the port's ratio is the stricter of the two. And the graph is laid out
in the chosen layout for both families: the port's NK attention kernel reads
the graph's slot arrays, where JAX's reads its own tiling's indices on a
CSR-ordered graph.
"""

from __future__ import annotations

import zlib
from collections import OrderedDict
from typing import Tuple

import numpy as np

from graph_physics_tpu_torch.core.graph import MeshGraph
from graph_physics_tpu_torch.ops import tiling as tiling_lib

#: NK acceptance per model family: the most slot rows per CSR row at which
#: the NK layout still wins (fused.py:79-80, :355-359, the NK kernels'
#: constant advantage at equal rows, measured by the JAX package):
#: ``nk_accept_ratio`` for ``epd`` (the NK GraphNetBlock) and
#: ``nk_attn_accept_ratio`` for the transformer (the NK attention)
NK_ACCEPT_RATIO = {"epd": 1.10, "transformer": 1.20}

#: the LRU bound of the per-topology cache, as in JAX (real datasets hold
#: ~1,000 meshes)
MAX_CACHED_TILINGS = 512


class FusedTopologyManager:
    """Per-topology layout cache and frame converter for one model family,
    ``"epd"`` or ``"transformer"``, which sets the NK acceptance ratio."""

    def __init__(self, model: str):
        self.nk_accept_ratio = NK_ACCEPT_RATIO[model]
        #: (traj id, n_edge, topology digest) -> CSR or NK layout
        self._tilings: "OrderedDict[Tuple, tiling_lib.Layout]" = OrderedDict()

    def layout_for(self, g: MeshGraph, traj_index: int = 0) -> tiling_lib.Layout:
        """The layout chosen for ``g``'s topology: NK when it builds and is
        priced in, CSR otherwise. Both hold ids into ``g``'s full edge
        arrays; the masked edges are left out of them."""
        send = np.asarray(g.senders, np.int32)
        recv = np.asarray(g.receivers, np.int32)
        mask = np.asarray(g.edge_mask, bool)
        n_valid = int(g.n_node) if g.n_node is not None else int(np.asarray(g.node_mask).sum())
        # a content hash of the topology, as JAX keys it: distinct edge sets
        # of one trajectory (sub-mesh partitions) must not share a layout
        chk = zlib.crc32(np.where(mask, send, -1).tobytes()) ^ (
            zlib.crc32(np.where(mask, recv, -1).tobytes()) << 1)
        key = (int(traj_index), int(mask.sum()), chk)
        if key in self._tilings:
            self._tilings.move_to_end(key)
            return self._tilings[key]
        csr = tiling_lib.build_csr_layout(send, recv, n_valid, edge_mask=mask)
        nk = tiling_lib.build_nk_tiling(send, recv, n_valid, edge_mask=mask)
        # priced only at >= 8 node blocks: below that the slot quantization
        # per 128-node block dominates both layouts
        if (nk is not None and csr.num_groups >= 8
                and nk.total_rows > self.nk_accept_ratio * csr.total_rows):
            nk = None
        if nk is None:
            print(f"[fused] NK layout rejected for trajectory {int(traj_index)} (degree "
                  "skew: slot rows would exceed the CSR row count beyond the "
                  "kernel-constant margin); the CSR kernel serves it", flush=True)
        self._tilings[key] = layout = csr if nk is None else nk
        while len(self._tilings) > MAX_CACHED_TILINGS:
            self._tilings.popitem(last=False)
        return layout

    def transform_frame(self, g: MeshGraph, traj_index: int = 0) -> MeshGraph:
        """One host frame converted into the layout chosen for its topology."""
        layout = self.layout_for(g, traj_index)
        if isinstance(layout, tiling_lib.NKTiling):
            return tiling_lib.apply_to_graph_nk(g, layout)
        return tiling_lib.apply_to_graph(g, layout)
