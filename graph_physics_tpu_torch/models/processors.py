"""EncodeProcessDecode (counterpart of graph_physics_tpu/models/processors.py).

MeshGraphNet: node and edge MLP encoders, M GraphNetBlocks, an MLP decoder
without a final norm, output cast to fp32. On a bf16 packed graph in the
NK slot layout the edge encoder is folded into block 0's fused kernel, so
the encoded edge array is never written out; the last block's edge output
is dead and the kernel skips it.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from graph_physics_tpu_torch.core.graph import MeshGraph
from graph_physics_tpu_torch.models.layers import MLP, GraphNetBlock, fused_path_ok_nk
from graph_physics_tpu_torch.ops.tiling import NKTiling


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
        edge_tiling_nk: Optional[NKTiling] = None,
        dtype=torch.float32,
    ):
        super().__init__()
        if use_temporal_block:
            raise NotImplementedError("the temporal block is not ported")
        self.hidden_size = hidden_size
        #: NK slot layout of the graphs this model runs on (ops/tiling.py);
        #: None runs every block on the plain edge-list path
        self.edge_tiling_nk = edge_tiling_nk
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
        nk = self.edge_tiling_nk
        fold = fused_path_ok_nk(nk, x, edge_attr, self.hidden_size, self.dtype, raw_edge=True)
        if not fold:
            edge_attr = self.edges_encoder(edge_attr)
        for i, block in enumerate(self.processor_list):
            x, edge_attr = block(
                x, edge_attr, graph.senders, graph.receivers, graph.edge_mask,
                nk_tiling=nk, edge_encoder=self.edges_encoder if fold and i == 0 else None,
            )
        return self.decode_module(x).float()
