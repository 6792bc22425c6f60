"""NN building blocks (counterparts of graph_physics_tpu/models/layers.py).

Parameters are kept in fp32 and cast to the compute dtype where they are
used, as flax ``Dense(dtype=bf16)`` does; RMSNorm statistics are fp32.
Module and parameter names follow the reference ``state_dict`` layout that
graph_physics_tpu/utils/convert.py reads: an MLP is an ``nn.Sequential``
of numbered Linear and activation children with an RMSNorm child whose
parameter is named ``scale``.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from graph_physics_tpu_torch.ops import segment
from graph_physics_tpu_torch.ops.fused_gnblock_nk import fused_gn_block_nk
from graph_physics_tpu_torch.ops.tiling import NKTiling


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """Erf-form GELU evaluated in fp32 (layers.py:gelu_exact)."""
    xf = x.float()
    y = 0.5 * xf * (1.0 + torch.erf(xf * 0.7071067811865476))
    return y.to(x.dtype)


ACTIVATIONS = {"relu": F.relu, "gelu": gelu_exact, "silu": F.silu}


class Activation(nn.Module):
    """Elementwise activation by name (layers.py:resolve_activation)."""

    def __init__(self, name: str):
        super().__init__()
        self.name = name
        self.fn = ACTIVATIONS[name]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(x)

    def extra_repr(self) -> str:
        return self.name


class Dense(nn.Linear):
    """``nn.Linear`` that runs in its input's dtype (fp32 parameters cast at
    use). The bias is added after the product, so in bf16 both round, as
    in flax ``Dense``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype)) + self.bias.to(x.dtype)


class RMSNorm(nn.Module):
    """x / (rms + eps) * scale with rms = sqrt(sum(x²) + 1e-24) / sqrt(dim),
    statistics in fp32 (layers.py:RMSNorm; the reference divides by
    rms + eps, not sqrt(ms + eps))."""

    eps = 1e-8

    def __init__(self, dim: int, dtype=torch.float32):
        super().__init__()
        self.dim = dim
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        norm = torch.sqrt(torch.sum(xf * xf, dim=-1, keepdim=True) + 1e-24)
        rms = norm / math.sqrt(self.dim)
        return (xf / (rms + self.eps) * self.scale).to(self.dtype)


class MLP(nn.Sequential):
    """``nb_of_layers`` Dense layers with activations between them and an
    optional RMSNorm tail (layers.py:MLP; reference build_mlp)."""

    def __init__(
        self,
        in_size: int,
        hidden_size: int,
        out_size: int,
        nb_of_layers: int = 4,
        layer_norm: bool = True,
        activation: str = "relu",
        dtype=torch.float32,
    ):
        layers: List[nn.Module] = []
        width = in_size
        for _ in range(nb_of_layers - 1):
            layers += [Dense(width, hidden_size), Activation(activation)]
            width = hidden_size
        layers.append(Dense(width, out_size))
        if layer_norm:
            layers.append(RMSNorm(out_size, dtype=dtype))
        super().__init__(*layers)
        self.activation = activation
        self.act_fn = ACTIVATIONS[activation]
        self.dtype = dtype

    @property
    def denses(self) -> List[Dense]:
        return [m for m in self if isinstance(m, Dense)]

    @property
    def norm(self) -> Optional[RMSNorm]:
        last = self[-1]
        return last if isinstance(last, RMSNorm) else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.to(self.dtype))


def reset_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Re-draw every Dense from ``generator`` with torch's default Linear
    distribution (uniform in ±1/sqrt(fan_in)); RMSNorm scales stay 1."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, Dense):
                bound = 1.0 / math.sqrt(m.in_features)
                m.weight.copy_(torch.rand(m.weight.shape, generator=generator) * 2 * bound - bound)
                m.bias.copy_(torch.rand(m.bias.shape, generator=generator) * 2 * bound - bound)


def fused_path_ok_nk(
    nk_tiling: Optional[NKTiling],
    x: torch.Tensor,
    edge_attr: torch.Tensor,
    hidden_size: int,
    dtype,
    raw_edge: bool = False,
) -> bool:
    """Whether the fused NK GraphNetBlock applies (layers.py:fused_path_ok_nk
    without its 128-lane terms). ``raw_edge``: edge_attr carries the raw
    features and the edge encoder folds into the block."""
    t = nk_tiling
    return (
        t is not None
        and dtype == torch.bfloat16
        and x.ndim == 3
        and edge_attr.ndim == 3
        and x.shape[-1] == hidden_size
        and x.shape[0] == t.num_nodes
        and edge_attr.shape[0] == t.total_rows
        and (edge_attr.shape[-1] <= hidden_size // 2 if raw_edge
             else edge_attr.shape[-1] == hidden_size)
    )


class GraphNetBlock(nn.Module):
    """Message passing with edge and node MLPs and residuals.

    edge' = MLP([e, x_recv, x_send]); agg = sum of edge' over a receiver's
    valid in-edges; node' = MLP([x, agg]) (layers.py:GraphNetBlock). On a
    bf16 packed graph in the NK slot layout the block runs as one fused
    kernel (:func:`ops.fused_gnblock_nk.fused_gn_block_nk`); otherwise as
    plain gathers, a masked ``index_add_`` and the two MLPs. RoPE, the
    φ-gate, gated MLPs, the world-edge sidecar and sp are not ported. The
    MLPs are the reference's: 4 relu Dense layers and an RMSNorm tail.
    """

    def __init__(
        self,
        hidden_size: int,
        use_rope: bool = False,
        use_gated_mlp: bool = False,
        use_gate: bool = False,
        sp_axis_name: Optional[str] = None,
        is_last_block: bool = False,
        dtype=torch.float32,
    ):
        super().__init__()
        if use_rope or use_gate or use_gated_mlp or sp_axis_name is not None:
            raise NotImplementedError(
                "GraphNetBlock options rope, gate, gated MLP and sp are not ported")
        self.hidden_size = hidden_size
        self.is_last_block = is_last_block
        self.dtype = dtype
        self.edge_block = MLP(3 * hidden_size, hidden_size, hidden_size, dtype=dtype)
        self.node_block = MLP(2 * hidden_size, hidden_size, hidden_size, dtype=dtype)

    def forward(
        self,
        x: torch.Tensor,
        edge_attr: torch.Tensor,
        senders: torch.Tensor,
        receivers: torch.Tensor,
        edge_mask: torch.Tensor,
        nk_tiling: Optional[NKTiling] = None,
        edge_encoder: Optional[MLP] = None,
        wedge_attr: Optional[torch.Tensor] = None,
    ):
        """Returns ``(x', edge_attr')``. ``edge_encoder``: the edge encoder
        folded into this (first) block's kernel, with raw edge features in
        ``edge_attr``."""
        if wedge_attr is not None:
            raise NotImplementedError("the world-edge sidecar is not ported")
        fold = edge_encoder is not None
        if fused_path_ok_nk(nk_tiling, x, edge_attr, self.hidden_size, self.dtype,
                            raw_edge=fold):
            x_new, e_new = fused_gn_block_nk(
                x.to(self.dtype), edge_attr.to(self.dtype), senders, edge_mask,
                self.edge_block, self.node_block, nk_tiling,
                encoder_params=edge_encoder, last_block=self.is_last_block,
            )
            return x_new.to(x.dtype), e_new.to(edge_attr.dtype)
        if fold:
            raise ValueError("edge_encoder given but the fused path does not apply")

        x_send = x.index_select(0, senders)
        x_recv = x.index_select(0, receivers)
        edge_upd = self.edge_block(torch.cat([edge_attr, x_recv, x_send], dim=-1))
        agg = segment.segment_sum(edge_upd, receivers, x.shape[0], mask=edge_mask)
        node_upd = self.node_block(torch.cat([x, agg], dim=-1))
        return x + node_upd, edge_attr + edge_upd
