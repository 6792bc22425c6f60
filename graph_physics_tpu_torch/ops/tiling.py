"""Host-side edge layouts: the uniform-degree ("NK") slot layout and
receiver-sorted CSR.

Every receiver gets exactly K edge slots (K = max in-degree), laid out
k-major inside blocks of ``node_block`` receivers: receiver
``g·nb + r`` owns slots ``g·K·nb + k·nb + r`` for k = 0..K-1. Padded
slots follow the repo convention (sender 0, receiver N-1, mask False).
So ``senders.view(G, K, nb)`` is a dense neighbour table, and a kernel
sums a receiver's messages over its K slots with no atomics.

Copies (host numpy) of graph_physics_tpu/ops/fused_edge_attention_nk.py:
NKTiling, nk_row_maps, build_nk_tiling and graph_physics_tpu/ops/
tiling.py:apply_to_graph_nk, without what only the TPU kernel needs: the
64-row sender windows (``win_start``/``sidx``), their runtime copies
(``tiling_idx_nk``) and the 128-lane conditions. The slot order, padding
and row-inflation guard are the same, so both packages lay out the same
graph identically.

:class:`CSRLayout`, :func:`build_csr_layout` and :func:`apply_to_graph`
are the counterparts of graph_physics_tpu/ops/tiling.py:EdgeTiling (:48),
build_edge_tiling (:268) and apply_to_graph (:112) for graphs of any
degree: plain receiver-sorted CSR. What only the TPU kernel needs stays
behind: the per-block edge padding, the sender windows (``win_start``,
``sidx``, ``ridx``), their size refusal and the RCM node order that keeps
them narrow (``rcm_order``). A kernel walks receiver r's rows
``row_ptr[r]:row_ptr[r + 1]``, so it sums at the receiver with no atomics.
:func:`sender_slots` is the transpose of either layout's rows, on the
device, over which the backward kernels sum at each sender.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple, Union

import numpy as np
import torch

from graph_physics_tpu_torch.core.graph import PAD_NODE_TYPE, MeshGraph

#: receivers per node block of the slot layout
NODE_BLOCK = 128
#: the layout is refused when K·N exceeds this multiple of the edge count
MAX_ROW_INFLATION = 2.0


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True, eq=False)
class NKTiling:
    """Uniform-degree slot layout (host-built, static per topology).

    Shapes: G = node blocks, S = K * node_block slots per block.
    """

    #: [G * S] int32 — original edge id per slot; -1 on padding
    perm: np.ndarray
    k_slots: int  # K
    node_block: int  # nb
    num_nodes: int  # padded node count (multiple of node_block)
    #: device data the kernels' wrappers derive from a graph in this layout
    #: and reuse across calls (the backward's transpose of the slot table)
    derived: dict = field(default_factory=dict, repr=False)

    @property
    def num_groups(self) -> int:
        return self.num_nodes // self.node_block

    @property
    def slots(self) -> int:
        return self.k_slots * self.node_block

    @property
    def total_rows(self) -> int:
        return self.num_groups * self.slots

    def expand_edges(self, edge_vals: np.ndarray, fill=0) -> np.ndarray:
        """Re-order a per-edge array [E, ...] into the slot layout [G*S, ...]."""
        out = np.full((self.perm.shape[0],) + tuple(edge_vals.shape[1:]), fill,
                      dtype=edge_vals.dtype)
        valid = self.perm >= 0
        out[valid] = edge_vals[self.perm[valid]]
        return out

    def reduce_edges(self, slot_vals: np.ndarray, num_edges: int) -> np.ndarray:
        """Inverse of :meth:`expand_edges`."""
        out = np.zeros((num_edges,) + tuple(slot_vals.shape[1:]), slot_vals.dtype)
        valid = self.perm >= 0
        out[self.perm[valid]] = slot_vals[valid]
        return out


def nk_row_maps(t: NKTiling) -> Tuple[np.ndarray, np.ndarray]:
    """Per slot row: (node block id, receiver row inside the block)."""
    gids = np.repeat(np.arange(t.num_groups), t.slots)
    loc_r = np.tile(np.arange(t.slots) % t.node_block, t.num_groups)
    return gids, loc_r


def build_nk_tiling(
    senders: np.ndarray,
    receivers: np.ndarray,
    num_nodes: int,
    edge_mask: Optional[np.ndarray] = None,
) -> Optional[NKTiling]:
    """Build the uniform-degree layout, or None when K·N exceeds
    ``MAX_ROW_INFLATION`` x the edge count (a degree-skewed graph)."""
    senders = np.asarray(senders, np.int64)
    receivers = np.asarray(receivers, np.int64)
    keep = (np.ones(senders.shape[0], bool) if edge_mask is None
            else np.asarray(edge_mask, bool))
    orig_ids = np.nonzero(keep)[0]
    s = senders[orig_ids]
    r = receivers[orig_ids]

    node_block = NODE_BLOCK
    n_pad = _round_up(max(num_nodes, 1), node_block)
    n_groups = n_pad // node_block

    order = np.argsort(r, kind="stable")  # receiver-major, stable edge order
    s, r, orig_ids = s[order], r[order], orig_ids[order]
    deg = np.bincount(r, minlength=n_pad)
    k_slots = max(int(deg.max()) if deg.size else 1, 1)
    if s.size and k_slots * n_pad > MAX_ROW_INFLATION * max(s.size, 1) + n_pad:
        return None

    run_start = np.zeros(n_pad + 1, np.int64)
    run_start[1:] = np.cumsum(deg)
    rank = np.arange(s.size) - run_start[r]  # k of each edge at its receiver

    slots = k_slots * node_block
    gid = r // node_block
    perm = np.full(n_groups * slots, -1, np.int64)
    perm[gid * slots + rank * node_block + (r - gid * node_block)] = orig_ids
    return NKTiling(perm=perm.astype(np.int32), k_slots=k_slots,
                    node_block=node_block, num_nodes=n_pad)


@dataclass(frozen=True, eq=False)
class CSRLayout:
    """Receiver-sorted CSR edge layout (host-built, static per topology).

    Rows: the valid edges sorted stably by receiver, then padding rows up
    to a multiple of ``ROW_ALIGN`` (sender 0, receiver N-1, mask False),
    which no receiver's row range covers.
    """

    #: [total_rows] int32 — original edge id per row; -1 on padding
    perm: np.ndarray
    #: [num_nodes + 1] int32 — receiver r owns rows row_ptr[r]:row_ptr[r+1]
    row_ptr: np.ndarray
    num_nodes: int  # padded node count (multiple of NODE_BLOCK)
    #: device data the kernels' wrappers derive from the layout and reuse
    #: across calls (``row_ptr`` on each device, the backward's transpose
    #: of the rows)
    derived: dict = field(default_factory=dict, repr=False)

    @property
    def num_groups(self) -> int:
        return self.num_nodes // NODE_BLOCK

    @property
    def total_rows(self) -> int:
        return int(self.perm.shape[0])

    def row_ptr_on(self, device) -> torch.Tensor:
        """``row_ptr`` as an int32 tensor on ``device``, copied once."""
        key = ("row_ptr", str(torch.device(device)))
        if key not in self.derived:
            self.derived[key] = torch.as_tensor(self.row_ptr, dtype=torch.int32, device=device)
        return self.derived[key]

    expand_edges = NKTiling.expand_edges
    reduce_edges = NKTiling.reduce_edges


#: a graph's kernel layout; its type picks the kernels
Layout = Union[NKTiling, CSRLayout]


def sender_slots(senders: torch.Tensor, edge_mask: torch.Tensor,
                 num_nodes: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The transpose of a layout's rows (NK slots or CSR rows): (order,
    offsets), int32, where ``order[offsets[j]:offsets[j+1]]`` are the valid
    rows whose sender is j, in row order. The backward kernels sum the
    sender-side gradients over them. Padding rows (mask False) are left
    out. No value comes back to the host."""
    key = torch.where(edge_mask, senders.long(), num_nodes)  # padding rows sort last
    keys, order = torch.sort(key, stable=True)
    offsets = torch.searchsorted(keys, torch.arange(num_nodes + 1, device=keys.device))
    return order.to(torch.int32), offsets.to(torch.int32)


def cached_sender_slots(senders: torch.Tensor, edge_mask: torch.Tensor,
                        layout: Layout) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`sender_slots` of the graph's row arrays, kept in
    ``layout.derived`` and computed again only for other arrays: every
    block of a model, and every step on one graph, pass the same two
    tensors (held there, so the same objects at the same versions hold the
    same values)."""
    versions = (senders._version, edge_mask._version)
    hit = layout.derived.get("sender_slots")
    if hit is None or hit[0] is not senders or hit[1] is not edge_mask or hit[2] != versions:
        hit = (senders, edge_mask, versions, sender_slots(senders, edge_mask, layout.num_nodes))
        layout.derived["sender_slots"] = hit
    return hit[3]


#: CSR rows are padded to a multiple of this
ROW_ALIGN = 128


def build_csr_layout(
    senders: np.ndarray,
    receivers: np.ndarray,
    num_nodes: int,
    edge_mask: Optional[np.ndarray] = None,
) -> CSRLayout:
    """The CSR layout of the valid edges (``edge_mask``, default all) of a
    graph with ``num_nodes`` nodes; it fits every topology."""
    receivers = np.asarray(receivers, np.int64)
    keep = (np.ones(receivers.shape[0], bool) if edge_mask is None
            else np.asarray(edge_mask, bool))
    orig_ids = np.nonzero(keep)[0]
    r = receivers[orig_ids]
    order = np.argsort(r, kind="stable")
    n_pad = _round_up(max(num_nodes, 1), NODE_BLOCK)
    row_ptr = np.zeros(n_pad + 1, np.int64)
    row_ptr[1:] = np.cumsum(np.bincount(r, minlength=n_pad))
    perm = np.full(_round_up(max(r.size, 1), ROW_ALIGN), -1, np.int64)
    perm[:r.size] = orig_ids[order]
    return CSRLayout(perm=perm.astype(np.int32), row_ptr=row_ptr.astype(np.int32),
                     num_nodes=n_pad)


def sidecar_on(graph: MeshGraph, n_new: int) -> dict:
    """The world-edge sidecar's receivers on ``n_new`` nodes: the unused
    slots' receiver becomes node ``n_new`` - 1, as the padding convention
    has it (their old one, FrameBuilder's last padding row, may be gone
    when the layout trims bucket padding); the used slots keep theirs.
    Empty without a sidecar."""
    recv = graph.wedge_receivers
    if recv is None:
        return {}
    recv = np.asarray(recv)
    return {"wedge_receivers": np.where(np.asarray(graph.wedge_mask), recv,
                                        np.int32(n_new - 1)).astype(np.int32)}


def _pad_nodes(graph: MeshGraph, n_new: int):
    """pad_nodes(a, fill) of graph's node arrays to ``n_new`` rows (or a
    trim of bucket-padding rows)."""
    pad_n = n_new - graph.x.shape[0]

    def pad_nodes(a, fill=0):
        if a is None or pad_n == 0:
            return a
        a = np.asarray(a)
        if pad_n < 0:  # trim bucket-padding rows
            return a[:n_new]
        pad = np.full((pad_n,) + a.shape[1:], fill, a.dtype)
        return np.concatenate([a, pad], axis=0)

    return dict(**sidecar_on(graph, n_new), x=pad_nodes(graph.x), pos=pad_nodes(graph.pos),
                node_type=pad_nodes(graph.node_type, PAD_NODE_TYPE),
                node_mask=pad_nodes(graph.node_mask, False), y=pad_nodes(graph.y),
                prev=pad_nodes(graph.prev), next_data=pad_nodes(graph.next_data),
                deselected=pad_nodes(graph.deselected, False), phi=pad_nodes(graph.phi))


def apply_to_graph(graph: MeshGraph, layout: CSRLayout) -> MeshGraph:
    """Convert a host MeshGraph to the CSR layout: nodes pad (or trim
    bucket padding) to ``layout.num_nodes``, edge arrays re-order by
    receiver, padding rows get sender 0, receiver N-1 and mask False; the
    graph carries ``layout``."""
    n_new = layout.num_nodes
    valid = layout.perm >= 0
    ids = layout.perm[valid]
    new_send = np.zeros(layout.total_rows, np.int32)
    new_recv = np.full(layout.total_rows, n_new - 1, np.int32)
    new_send[valid] = np.asarray(graph.senders)[ids]
    new_recv[valid] = np.asarray(graph.receivers)[ids]
    edge_attr = graph.edge_attr
    if edge_attr is not None:
        edge_attr = layout.expand_edges(np.asarray(edge_attr))
    return graph.replace(senders=new_send, receivers=new_recv, edge_mask=valid,
                         edge_attr=edge_attr, layout=layout, **_pad_nodes(graph, n_new))


def apply_to_graph_nk(graph: MeshGraph, tiling: NKTiling) -> MeshGraph:
    """Convert a host MeshGraph to the NK slot layout.

    Nodes pad (or trim bucket padding) to ``tiling.num_nodes``; edge arrays
    re-order into the k-major slot layout; padded slots get sender 0,
    receiver N-1 and mask False; the graph carries ``tiling``.
    """
    n_new = tiling.num_nodes
    gids, loc_r = nk_row_maps(tiling)
    valid = tiling.perm >= 0
    senders = np.asarray(graph.senders)
    new_send = np.zeros(tiling.perm.shape[0], np.int32)
    new_recv = np.full(tiling.perm.shape[0], n_new - 1, np.int32)
    new_send[valid] = senders[tiling.perm[valid]]
    new_recv[valid] = gids[valid] * tiling.node_block + loc_r[valid]

    edge_attr = graph.edge_attr
    if edge_attr is not None:
        edge_attr = tiling.expand_edges(np.asarray(edge_attr))
    return graph.replace(senders=new_send, receivers=new_recv, edge_mask=valid,
                         edge_attr=edge_attr, layout=tiling, **_pad_nodes(graph, n_new))
