"""Per-topology choice of the kernels' edge layout, and the loader's
conversion of frames and batches into it.

Counterpart of the layout part of graph_physics_tpu/training/fused.py:
FusedTopologyManager (:31-519): the per-topology cache (:257-277), the
NK-vs-CSR pricing (:339-382), ``transform_frame`` (:476-519) with its
static-template fast path, and ``transform_packed`` (:456-474). The
world-edge sidecar rides through untouched but for its unused slots'
receiver (fused.py:444-449): the layout is chosen from the mesh edges
alone, and no layout reorders the nodes. A mesh of
near-uniform degree takes the NK slot layout (ops/tiling.NKTiling, the NK
kernels); a degree-graded one, whose slot rows would exceed the CSR rows
by more than the NK kernels' constant advantage, takes the CSR layout
(ops/tiling.CSRLayout, the CSR kernels). ``nk=False`` takes the CSR
layout for every topology (the CLI's ``--no-fused_gn_nk`` and
``--no-fused_attn_nk``). A converted graph carries its layout
(``MeshGraph.layout``); the model runs on the layout of the batch it is
given (training/trainer.py).

Left out, with their reasons:
  * the jit step cache (``step_for``, ``key_for``): PyTorch runs eagerly;
  * ``wb_buckets`` and the RCM reorder: they serve the TPU kernel's sender
    windows, which the CSR layout does not have;
  * ``NKBucketTiling`` (:320-338, ROADMAP A 8): where JAX may take the
    per-block-K NK layout for an ``epd`` model, this manager takes the CSR
    or the global-K NK layout. That changes the kernels' schedule, not the
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

import threading
import zlib
from collections import OrderedDict
from typing import Optional, Tuple

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
    ``"epd"`` or ``"transformer"``, which sets the NK acceptance ratio;
    ``nk=False`` keeps every topology on the CSR layout."""

    def __init__(self, model: str, nk: bool = True):
        self.nk_accept_ratio = NK_ACCEPT_RATIO[model]
        self.nk = nk
        #: (traj id, n_edge, topology digest) -> CSR or NK layout
        self._tilings: "OrderedDict[Tuple, tiling_lib.Layout]" = OrderedDict()
        #: layout key -> (converted static template, its source pos and
        #: edge_attr objects): frames served from the dataset's skeleton
        #: share those leaves, so only their dynamic node leaves are padded
        #: onto the template
        self._converted: "OrderedDict[Tuple, Tuple[MeshGraph, object, object]]" = OrderedDict()
        #: the loader's worker threads may convert frames concurrently
        self._lock = threading.Lock()

    def _key_and_layout(self, g: MeshGraph, traj_index: Optional[int]):
        if traj_index is None:
            traj_index = 0 if g.traj_index is None else int(np.asarray(g.traj_index))
        send = np.asarray(g.senders, np.int32)
        recv = np.asarray(g.receivers, np.int32)
        mask = np.asarray(g.edge_mask, bool)
        n_valid = int(g.n_node) if g.n_node is not None else int(np.asarray(g.node_mask).sum())
        # a content hash of the topology, as JAX keys it: distinct edge sets
        # of one trajectory (sub-mesh partitions) must not share a layout
        chk = zlib.crc32(np.where(mask, send, -1).tobytes()) ^ (
            zlib.crc32(np.where(mask, recv, -1).tobytes()) << 1)
        key = (int(traj_index), int(mask.sum()), chk)
        with self._lock:
            if key in self._tilings:
                self._tilings.move_to_end(key)
                return key, self._tilings[key]
        csr = tiling_lib.build_csr_layout(send, recv, n_valid, edge_mask=mask)
        nk = tiling_lib.build_nk_tiling(send, recv, n_valid, edge_mask=mask) if self.nk else None
        # priced only at >= 8 node blocks: below that the slot quantization
        # per 128-node block dominates both layouts
        if (nk is not None and csr.num_groups >= 8
                and nk.total_rows > self.nk_accept_ratio * csr.total_rows):
            nk = None
        if nk is None and self.nk:
            print(f"[fused] NK layout rejected for trajectory {int(traj_index)} (degree "
                  "skew: slot rows would exceed the CSR row count beyond the "
                  "kernel-constant margin); the CSR kernel serves it", flush=True)
        with self._lock:  # a thread that built the same layout first wins: one object a key
            layout = self._tilings.setdefault(key, csr if nk is None else nk)
            while len(self._tilings) > MAX_CACHED_TILINGS:
                self._tilings.popitem(last=False)
        return key, layout

    def layout_for(self, g: MeshGraph, traj_index: Optional[int] = None) -> tiling_lib.Layout:
        """The layout chosen for ``g``'s topology: NK when it builds and is
        priced in, CSR otherwise. Both hold ids into ``g``'s full edge
        arrays; the masked edges are left out of them. The trajectory id
        is ``g.traj_index`` unless given."""
        return self._key_and_layout(g, traj_index)[1]

    @staticmethod
    def _apply_template(tmpl: MeshGraph, g: MeshGraph) -> MeshGraph:
        """The converted static leaves of ``tmpl`` with this frame's (or
        half-packed batch's) dynamic node leaves padded along axis 0 to the
        layout's node count, and its world-edge sidecar
        (fused.py:_apply_template): the same node ids, the unused slots'
        receiver the layout's last node (tiling.sidecar_on)."""
        n_new = tmpl.x.shape[0]

        def pad_nodes(a, fill=0):
            if a is None:
                return None
            a = np.asarray(a)
            if a.shape[0] == n_new:
                return a
            if a.shape[0] > n_new:
                return a[:n_new]
            pad = np.full((n_new - a.shape[0],) + a.shape[1:], fill, a.dtype)
            return np.concatenate([a, pad], axis=0)

        return tmpl.replace(x=pad_nodes(g.x), y=pad_nodes(g.y), prev=pad_nodes(g.prev),
                            next_data=pad_nodes(g.next_data),
                            deselected=pad_nodes(g.deselected, False), time=g.time,
                            wedge_senders=g.wedge_senders, wedge_mask=g.wedge_mask,
                            wedge_attr=g.wedge_attr, **tiling_lib.sidecar_on(g, n_new))

    def _template(self, key, g: MeshGraph) -> Optional[MeshGraph]:
        with self._lock:
            cached = self._converted.get(key)
        if cached is None or cached[1] is not g.pos or cached[2] is not g.edge_attr:
            return None
        return cached[0]

    def transform_frame(self, g: MeshGraph, traj_index: Optional[int] = None) -> MeshGraph:
        """One host frame converted into the layout chosen for its topology.
        Frames whose static leaves (pos, edge_attr) are the objects of the
        last converted frame of the topology take the template's converted
        static leaves; the others convert in full."""
        key, layout = self._key_and_layout(g, traj_index)
        tmpl = self._template(key, g)
        if tmpl is not None:
            return self._apply_template(tmpl, g)
        if isinstance(layout, tiling_lib.NKTiling):
            out = tiling_lib.apply_to_graph_nk(g, layout)
        else:
            out = tiling_lib.apply_to_graph(g, layout)
        with self._lock:  # strong refs: identity is sound while the sources live
            self._converted[key] = (out, g.pos, g.edge_attr)
            while len(self._converted) > MAX_CACHED_TILINGS:
                self._converted.popitem(last=False)
        return out

    def transform_packed(self, g: MeshGraph) -> Optional[MeshGraph]:
        """The layout conversion of a half-packed batch (node leaves
        [N, B, F], static slots single: ``FrameBuilder.build_packed``)
        through the topology's template, or None when there is none yet
        (the first batch of a trajectory runs frame by frame and makes it)
        (fused.py:transform_packed)."""
        key, _ = self._key_and_layout(g, None)
        tmpl = self._template(key, g)
        return None if tmpl is None else self._apply_template(tmpl, g)
