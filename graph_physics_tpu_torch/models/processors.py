"""Processors (counterparts of graph_physics_tpu/models/processors.py).

EncodeProcessDecode, MeshGraphNet: node and edge MLP encoders, M
GraphNetBlocks, an MLP decoder without a final norm, output cast to fp32;
a world-edge sidecar's features are encoded by the same edge encoder and
updated by every block beside the mesh edges.
On a bf16 packed graph in the NK slot or CSR layout the edge encoder is
folded into block 0's fused kernel, so the encoded edge array is never
written out; the last block's edge output is dead and the kernel skips it.

EncodeTransformDecode, the graph transformer: the same encoder and decoder
around TransformerBlocks, with no edge features.

TransolverProcessor, Transolver++ (models/transolver.py) on the graph's
node features, positions and mask; stacked [B, N, F] batches or one graph.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from graph_physics_tpu_torch.core.graph import MeshGraph
from graph_physics_tpu_torch.models.layers import (
    MLP,
    GraphNetBlock,
    TransformerBlock,
    fused_path_ok,
)
from graph_physics_tpu_torch.models.transolver import TransolverModel
from graph_physics_tpu_torch.ops.tiling import Layout


class EncodeProcessDecode(nn.Module):
    def __init__(
        self,
        message_passing_num: int,
        node_input_size: int,
        edge_input_size: int,
        output_size: int,
        hidden_size: int = 128,
        use_rope_embeddings: bool = False,
        use_gated_attention: bool = False,
        use_gated_mlp: bool = False,
        use_temporal_block: bool = False,
        tiling: Optional[Layout] = None,
        dtype=torch.float32,
    ):
        super().__init__()
        if use_temporal_block:
            raise NotImplementedError("the temporal block is not ported")
        self.hidden_size = hidden_size
        #: NK slot or CSR layout of the graphs this model runs on
        #: (ops/tiling.py; processors.py:64, ``edge_tiling_nk`` or
        #: ``edge_tiling``); None: every block takes the plain edge list
        self.tiling = tiling
        self.dtype = dtype
        self.nodes_encoder = MLP(node_input_size, hidden_size, hidden_size, dtype=dtype)
        self.edges_encoder = MLP(edge_input_size, hidden_size, hidden_size, dtype=dtype)
        self.processor_list = nn.ModuleList(
            GraphNetBlock(
                hidden_size,
                use_rope=use_rope_embeddings,
                use_gate=use_gated_attention,
                use_gated_mlp=use_gated_mlp,
                is_last_block=i == message_passing_num - 1,
                dtype=dtype,
            )
            for i in range(message_passing_num)
        )
        self.decode_module = MLP(hidden_size, hidden_size, output_size, layer_norm=False,
                                 dtype=dtype)

    def forward(self, graph: MeshGraph) -> torch.Tensor:
        x = self.nodes_encoder(graph.x.to(self.dtype))
        edge_attr = graph.edge_attr.to(self.dtype)
        # the block's own predicate with the raw edge width (processors.py:100-107)
        fold = fused_path_ok(self.tiling, x, edge_attr, self.hidden_size, self.dtype,
                             raw_edge=True)
        if not fold:
            edge_attr = self.edges_encoder(edge_attr)
        # the world-edge sidecar's stream encodes in plain PyTorch even when
        # the mesh edges' encoder is folded, and each block updates it
        # (processors.py:121-128)
        wedge_attr = graph.wedge_attr
        world = {}
        if wedge_attr is not None:
            wedge_attr = self.edges_encoder(wedge_attr.to(self.dtype))
            world = dict(wedge_senders=graph.wedge_senders,
                         wedge_receivers=graph.wedge_receivers, wedge_mask=graph.wedge_mask)
        for i, block in enumerate(self.processor_list):
            out = block(
                x, edge_attr, graph.senders, graph.receivers, graph.edge_mask,
                tiling=self.tiling,
                edge_encoder=self.edges_encoder if fold and i == 0 else None,
                wedge_attr=wedge_attr, **world,
            )
            x, edge_attr = out[:2]
            wedge_attr = out[2] if wedge_attr is not None else None
        return self.decode_module(x).float()


class EncodeTransformDecode(nn.Module):
    """Graph transformer (processors.py:EncodeTransformDecode): a node
    encoder MLP, M TransformerBlocks attending over the mesh edges, an MLP
    decoder without a final norm, output cast to fp32. With
    ``tiling`` set, blocks on a packed bf16 graph in that NK slot or CSR
    layout run their attention and FFN halves as kernels; without it
    every block takes the plain path. Multigrid,
    the temporal block, remat and sp are not ported (ROADMAP A 7, A 9)."""

    def __init__(
        self,
        message_passing_num: int,
        node_input_size: int,
        output_size: int,
        hidden_size: int = 128,
        num_heads: int = 4,
        use_rope_embeddings: bool = False,
        use_gated_attention: bool = False,
        rope_pos_dimension: int = 3,
        rope_base: float = 10000.0,
        use_temporal_block: bool = False,
        use_silu: bool = False,
        remat: bool = False,
        sp_axis_name: Optional[str] = None,
        use_multigrid: bool = False,
        tiling: Optional[Layout] = None,
        dtype=torch.float32,
    ):
        super().__init__()
        for name, on in (("use_multigrid", use_multigrid), ("use_temporal_block",
                         use_temporal_block), ("remat", remat),
                         ("sp_axis_name", sp_axis_name is not None)):
            if on:
                raise NotImplementedError(f"EncodeTransformDecode option {name} is not ported")
        self.hidden_size = hidden_size
        self.use_rope_embeddings = use_rope_embeddings
        #: NK slot or CSR layout of the graphs this model runs on
        #: (ops/tiling.py; processors.py:217-222)
        self.tiling = tiling
        self.dtype = dtype
        self.nodes_encoder = MLP(node_input_size, hidden_size, hidden_size, dtype=dtype)
        self.processor_list = nn.ModuleList(
            TransformerBlock(
                hidden_size,
                num_heads=num_heads,
                use_rope_embeddings=use_rope_embeddings,
                use_gated_attention=use_gated_attention,
                pos_dimension=rope_pos_dimension,
                rope_base=rope_base,
                use_silu=use_silu,
                dtype=dtype,
            )
            for _ in range(message_passing_num)
        )
        self.decode_module = MLP(hidden_size, hidden_size, output_size, layer_norm=False,
                                 dtype=dtype)

    def forward(self, graph: MeshGraph) -> torch.Tensor:
        x = self.nodes_encoder(graph.x.to(self.dtype))
        if self.use_rope_embeddings and graph.pos is None:
            raise ValueError("use_rope_embeddings=True requires node positions.")
        for block in self.processor_list:
            x = block(x, graph.senders, graph.receivers, graph.edge_mask, graph.node_mask,
                      graph.pos, tiling=self.tiling, wedge_senders=graph.wedge_senders,
                      wedge_receivers=graph.wedge_receivers, wedge_mask=graph.wedge_mask)
        return self.decode_module(x).float()


class TransolverProcessor(nn.Module):
    """Adapter around Transolver++ with the processor API
    (processors.py:TransolverProcessor): the inner ``model`` takes
    ``graph.x`` in the compute dtype, ``graph.pos`` and ``graph.node_mask``
    and returns fp32. ``forward``'s ``gumbel`` generator turns the
    training-time slice noise on. The JAX processor's fields that it does
    not pass on to its model (dropout, RoPE, the attention gate) are left
    out, and so is ``dp_axis_name`` (ROADMAP A 9)."""

    #: the Transolver takes a stacked [B, N, F] batch as it is
    takes_stacked = True

    def __init__(
        self,
        message_passing_num: int,
        node_input_size: int,
        output_size: int,
        hidden_size: int = 64,
        num_heads: int = 2,
        mlp_ratio: int = 1,
        slice_num: int = 32,
        ref: int = 8,
        unified_pos: bool = False,
        use_temporal_block: bool = False,
        fused_gumbel: bool = False,
        dtype=torch.float32,
    ):
        super().__init__()
        self.dtype = dtype
        self.model = TransolverModel(
            n_layers=message_passing_num, n_hidden=hidden_size, n_head=num_heads,
            mlp_ratio=mlp_ratio, fun_dim=node_input_size, out_dim=output_size,
            slice_num=slice_num, ref=ref, unified_pos=unified_pos,
            use_temporal_block=use_temporal_block, fused_gumbel=fused_gumbel, dtype=dtype)

    def forward(self, graph: MeshGraph, gumbel: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.model(graph.x.to(self.dtype), graph.pos, graph.node_mask,
                          gumbel=gumbel).float()
