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
from graph_physics_tpu_torch.ops.activation import gelu_values, silu
from graph_physics_tpu_torch.ops.edge_attention import edge_attention, world_attention_parts
from graph_physics_tpu_torch.ops.fused_edge_attention_csr import fused_edge_attention_csr
from graph_physics_tpu_torch.ops.fused_edge_attention_nk import fused_edge_attention_nk
from graph_physics_tpu_torch.ops.fused_ffn import fused_gated_ffn
from graph_physics_tpu_torch.ops.fused_gnblock_csr import fused_gn_block_csr
from graph_physics_tpu_torch.ops.fused_gnblock_nk import fused_gn_block_nk
from graph_physics_tpu_torch.ops.tiling import Layout, NKTiling
from graph_physics_tpu_torch.ops.world_gather import wscatter_sum, wtake


#: Erf-form GELU evaluated in fp32, rounded once (layers.py:gelu_exact)
gelu_exact = gelu_values


#: silu on bf16 tensors rounds each step as XLA does (ops/activation.py)
ACTIVATIONS = {"relu": F.relu, "gelu": gelu_exact, "silu": silu}


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


def dense(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """``x @ weight.T + bias`` in ``x``'s dtype: the product rounds, then
    the bias add rounds, as in flax ``Dense``; no add without a bias."""
    y = F.linear(x, weight.to(x.dtype))
    return y if bias is None else y + bias.to(x.dtype)


class Dense(nn.Linear):
    """``nn.Linear`` that runs in its input's dtype (fp32 parameters cast at
    use), through :func:`dense`; ``bias=False`` is flax's ``use_bias=False``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.weight, self.bias)


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


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(epsilon=eps, dtype=dtype)`` with the reference's
    ``weight``/``bias`` names: statistics in fp32 with flax's fast variance
    ``max(0, E[x²] - E[x]²)`` (normalization.py:_compute_stats), then
    ``(x - mean) · (rsqrt(var + eps) · weight) + bias`` in fp32 with fp32
    parameters, cast to ``dtype`` last (_normalize)."""

    def __init__(self, dim: int, eps: float = 1e-5, dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean, min=0.0)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(self.dtype)


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


class GatedMLP(nn.Module):
    """act(linear1(x)) * linear2(x), ``expansion_factor * hidden_size``
    wide; act is the exact GELU, or SiLU with ``use_silu``
    (layers.py:GatedMLP; reference layers.py:213-249)."""

    def __init__(self, in_size: int, hidden_size: int, expansion_factor: int = 3,
                 use_silu: bool = False):
        super().__init__()
        width = expansion_factor * hidden_size
        self.use_silu = use_silu
        self.act_fn = ACTIVATIONS["silu" if use_silu else "gelu"]
        self.linear1 = Dense(in_size, width)
        self.linear2 = Dense(in_size, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act_fn(self.linear1(x)) * self.linear2(x)


class GatedMLPBlock(nn.Sequential):
    """RMSNorm -> GatedMLP -> Dense(out) (layers.py:GatedMLPBlock; reference
    build_gated_mlp :252-278), children ``0``, ``1``, ``2`` as in the
    reference ``state_dict``."""

    def __init__(self, in_size: int, hidden_size: int, out_size: int,
                 expansion_factor: int = 3, use_silu: bool = False, dtype=torch.float32):
        super().__init__(
            RMSNorm(in_size, dtype=dtype),
            GatedMLP(in_size, hidden_size, expansion_factor, use_silu),
            Dense(expansion_factor * hidden_size, out_size),
        )

    @property
    def norm(self) -> RMSNorm:
        return self[0]

    @property
    def gated(self) -> GatedMLP:
        return self[1]

    @property
    def out(self) -> Dense:
        return self[2]


def reset_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Re-draw every Dense from ``generator`` with torch's default Linear
    distribution (uniform in ±1/sqrt(fan_in)); RMSNorm scales stay 1."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, Dense):
                bound = 1.0 / math.sqrt(m.in_features)
                m.weight.copy_(torch.rand(m.weight.shape, generator=generator) * 2 * bound - bound)
                if m.bias is not None:
                    m.bias.copy_(torch.rand(m.bias.shape, generator=generator) * 2 * bound - bound)


#: flax's truncated-normal correction: the std of a standard normal cut at ±2
TRUNC_STD = 0.87962566103423978


def lecun_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Re-draw every Dense as the JAX package's flax Dense initialises it:
    the kernel from lecun_normal (a normal of variance 1/fan_in, cut at two
    standard deviations), the bias 0."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, Dense):
                std = math.sqrt(1.0 / m.in_features) / TRUNC_STD
                nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std,
                                      generator=generator)
                if m.bias is not None:
                    m.bias.zero_()


#: the TPU kernels' lane width (ops/fused_gnblock.py:LANES), which the
#: fused GraphNetBlock's hidden size must divide
LANES = 128


def fused_path_ok(
    tiling,
    x: torch.Tensor,
    edge_attr: torch.Tensor,
    hidden_size: int,
    dtype,
    raw_edge: bool = False,
) -> bool:
    """Whether a fused GraphNetBlock applies on ``tiling``, a CSRLayout or
    an NKTiling (layers.py:fused_path_ok and fused_path_ok_nk without their
    B·H lane term, which serves the TPU's packing only): shared by
    GraphNetBlock and EncodeProcessDecode, so the processor's fold decision
    is the block's. The hidden size must divide LANES, as JAX fuses only
    such widths (hidden 24 or 48 take the plain path in both packages).
    ``raw_edge``: edge_attr carries the raw features and the edge encoder
    folds into the block."""
    return (
        tiling is not None
        and dtype == torch.bfloat16
        and x.ndim == 3
        and edge_attr.ndim == 3
        and x.shape[-1] == hidden_size
        and LANES % hidden_size == 0
        and x.shape[0] == tiling.num_nodes
        and edge_attr.shape[0] == tiling.total_rows
        and (edge_attr.shape[-1] <= hidden_size // 2 if raw_edge
             else edge_attr.shape[-1] == hidden_size)
    )


class GraphNetBlock(nn.Module):
    """Message passing with edge and node MLPs and residuals.

    edge' = MLP([e, x_recv, x_send]); agg = sum of edge' over a receiver's
    valid in-edges; node' = MLP([x, agg]) (layers.py:GraphNetBlock). On a
    bf16 packed graph the block runs as one fused kernel, dispatched in
    JAX's order (layers.py:884-930): in the NK slot layout
    (:func:`ops.fused_gnblock_nk.fused_gn_block_nk`), else in the CSR
    layout (:func:`ops.fused_gnblock_csr.fused_gn_block_csr`); otherwise
    as plain gathers, a masked segment sum (both adding in a fixed order,
    ops/segment.py) and the two MLPs. With the
    world-edge sidecar (``wedge_attr`` and its index arrays), the world
    edges' messages run through the same edge MLP in plain PyTorch, are
    summed per receiver and sample, and join the aggregate: through the
    kernels' ``extra_agg`` seam, or added to the plain path's sum
    (layers.py:855-882, :959-960). RoPE, the φ-gate, gated MLPs and sp are
    not ported. The MLPs are the reference's: ``nb_of_layers`` Dense layers
    (1 to 8 on the kernels) with ``activation`` (relu, silu or gelu)
    between them and an RMSNorm tail when ``layer_norm``; JAX's fields
    (layers.py:737-738, :744), passed to both MLPs as JAX passes them
    (:833-848), and taken by the kernels too.
    """

    def __init__(
        self,
        hidden_size: int,
        nb_of_layers: int = 4,
        layer_norm: bool = True,
        use_rope: bool = False,
        use_gated_mlp: bool = False,
        use_gate: bool = False,
        sp_axis_name: Optional[str] = None,
        is_last_block: bool = False,
        dtype=torch.float32,
        activation: str = "relu",
    ):
        super().__init__()
        if use_rope or use_gate or use_gated_mlp or sp_axis_name is not None:
            raise NotImplementedError(
                "GraphNetBlock options rope, gate, gated MLP and sp are not ported")
        self.hidden_size = hidden_size
        self.is_last_block = is_last_block
        self.dtype = dtype
        self.activation = activation
        self.nb_of_layers = nb_of_layers
        self.layer_norm = layer_norm
        mlp = dict(nb_of_layers=nb_of_layers, layer_norm=layer_norm, activation=activation,
                   dtype=dtype)
        self.edge_block = MLP(3 * hidden_size, hidden_size, hidden_size, **mlp)
        self.node_block = MLP(2 * hidden_size, hidden_size, hidden_size, **mlp)

    def forward(
        self,
        x: torch.Tensor,
        edge_attr: torch.Tensor,
        senders: torch.Tensor,
        receivers: torch.Tensor,
        edge_mask: torch.Tensor,
        tiling: Optional[Layout] = None,
        edge_encoder: Optional[MLP] = None,
        wedge_attr: Optional[torch.Tensor] = None,
        wedge_senders: Optional[torch.Tensor] = None,
        wedge_receivers: Optional[torch.Tensor] = None,
        wedge_mask: Optional[torch.Tensor] = None,
    ):
        """Returns ``(x', edge_attr')``, and the updated world stream
        ``wedge_attr'`` third when ``wedge_attr`` is given. ``tiling``: the
        graph's NK or CSR layout. ``edge_encoder``: the edge encoder folded
        into this (first) block's kernel, with raw edge features in
        ``edge_attr``. ``wedge_*``: the world-edge sidecar, [W, B] index
        arrays of a packed [N, B, H] graph ([W] of a single one), its
        encoded features ``wedge_attr`` [W, (B,) H]."""
        world_agg = w_upd = None
        if wedge_attr is not None:
            world_agg, w_upd = self.world_messages(x, wedge_attr, wedge_senders,
                                                   wedge_receivers, wedge_mask)

        def out(x_new, e_new):
            if w_upd is None:
                return x_new, e_new
            return x_new, e_new, wedge_attr + w_upd.to(wedge_attr.dtype)

        fold = edge_encoder is not None
        if fused_path_ok(tiling, x, edge_attr, self.hidden_size, self.dtype, raw_edge=fold):
            xb, eb = x.to(self.dtype), edge_attr.to(self.dtype)
            kw = dict(encoder_params=edge_encoder, last_block=self.is_last_block,
                      extra_agg=None if world_agg is None else world_agg.to(self.dtype))
            if isinstance(tiling, NKTiling):
                x_new, e_new = fused_gn_block_nk(xb, eb, senders, edge_mask, self.edge_block,
                                                 self.node_block, tiling, **kw)
            else:
                x_new, e_new = fused_gn_block_csr(xb, eb, senders, receivers, edge_mask,
                                                  self.edge_block, self.node_block, tiling, **kw)
            return out(x_new.to(x.dtype), e_new.to(edge_attr.dtype))
        if fold:
            raise ValueError("edge_encoder given but the fused path does not apply")

        x_send = segment.gather_rows(x, senders)
        x_recv = segment.gather_rows(x, receivers)
        edge_upd = self.edge_block(torch.cat([edge_attr, x_recv, x_send], dim=-1))
        agg = segment.segment_sum(edge_upd, receivers, x.shape[0], mask=edge_mask)
        if world_agg is not None:
            agg = agg + world_agg.to(agg.dtype)
        node_upd = self.node_block(torch.cat([x, agg], dim=-1))
        return out(x + node_upd, edge_attr + edge_upd)

    def world_messages(self, x, wedge_attr, wedge_senders, wedge_receivers, wedge_mask):
        """(world aggregate [N, (B,) H], masked world messages): each world
        edge's message through the block's edge MLP from [wedge_attr,
        x_recv, x_send], zero on masked slots, summed per receiver (and
        sample: JAX's one-hot contraction sums in fp32 and rounds once,
        world_gather.py:95-104, so the packed sum does too)."""
        n = x.shape[0]
        per_sample = wedge_senders.ndim == 2
        take = wtake if per_sample else segment.gather_rows
        # the masked slots take no gradient: their messages are zeroed below
        edge_in = torch.cat([wedge_attr.to(self.dtype), take(x, wedge_receivers, wedge_mask),
                             take(x, wedge_senders, wedge_mask)], dim=-1)
        w_upd = self.edge_block(edge_in)
        w_upd = torch.where(segment._bcast(wedge_mask, w_upd), w_upd,
                            torch.zeros((), dtype=w_upd.dtype, device=w_upd.device))
        if per_sample:
            return wscatter_sum(w_upd.float(), wedge_receivers, n).to(w_upd.dtype), w_upd
        return segment.segment_sum(w_upd, wedge_receivers, n), w_upd


# ----------------------------------------------------------------------
# RoPE, attention, transformer
# ----------------------------------------------------------------------

def make_inv_freq(m: int, base: float, device=None) -> torch.Tensor:
    """Inverse frequencies of spatial RoPE (layers.py:make_inv_freq)."""
    if m <= 0:
        return torch.zeros((0,), dtype=torch.float32, device=device)
    step = math.log(base) / max(m, 1)
    return torch.exp(-torch.arange(m, dtype=torch.float32, device=device) * step)


def apply_spatial_rope(x: torch.Tensor, pos: torch.Tensor, inv_freq: torch.Tensor) -> torch.Tensor:
    """Multi-axis spatial RoPE over the head dim (layers.py:apply_spatial_rope).

    x is [N, ..., Dh] (e.g. [N, H, Dh] or packed [N, B, H, Dh]), pos [N, P]:
    the first ``P * 2m`` channels of each head are rotated in pairs, axis
    by axis, by the angles pos[:, axis] * inv_freq; the rest pass through.
    """
    p = pos.shape[-1]
    m = inv_freq.shape[0]
    d_rope = p * 2 * m
    if m == 0 or d_rope == 0:
        return x
    angles = pos[:, :, None].float() * inv_freq[None, None, :]  # [N, P, m]
    mid = (1,) * (x.ndim - 2)  # broadcast over heads / packed-batch dims
    cos = torch.cos(angles).reshape((x.shape[0],) + mid + (p, m))
    sin = torch.sin(angles).reshape((x.shape[0],) + mid + (p, m))
    part = x[..., :d_rope].reshape(x.shape[:-1] + (p, m, 2))
    even = part[..., 0].float()
    odd = part[..., 1].float()
    rot = torch.stack([even * cos - odd * sin, even * sin + odd * cos], dim=-1)
    rot = rot.reshape(x.shape[:-1] + (d_rope,))
    return torch.cat([rot.to(x.dtype), x[..., d_rope:]], dim=-1)


def head_perm(hidden: int, heads: int) -> torch.Tensor:
    """perm[c] = the reference's channel for heads-first channel c = h·dh + d:
    the reference reshapes projections to (dh, H), heads last, so its
    channel is d·H + h (graph_physics_tpu/utils/convert.py:_head_perm)."""
    dh = hidden // heads
    c = torch.arange(hidden)
    return (c % dh) * heads + c // dh


class Attention(nn.Module):
    """Edge-masked multi-head self-attention over graph nodes
    (layers.py:Attention; reference layers.py:564-698).

    Separate q/k/v projections, optional spatial RoPE, optional sigmoid
    output gate, output ``proj``, all with biases.
    The weights keep the reference's heads-last layout (the weight
    bridge's contract); at use, the q/k/v/gate rows and the ``proj``
    columns are taken in :func:`head_perm` order, so the activations come
    out heads first, ``[..., H, dh]`` contiguous, as the JAX package lays
    them out and the attention kernel reads them. On a packed bf16 graph
    the attention runs as one kernel, dispatched as JAX's ``use_nk``
    (layers.py:291-396): in the NK slot layout
    (:func:`ops.fused_edge_attention_nk.fused_edge_attention_nk`), else in
    the CSR layout (:func:`ops.fused_edge_attention_csr.fused_edge_attention_csr`);
    otherwise on the plain edge list (:func:`ops.edge_attention.edge_attention`),
    or densely over the valid nodes when there are no edges. The world-edge
    sidecar (``wedge_*``) joins the softmax (layers.py:355-405): on the
    kernel path as the pieces of
    :func:`ops.edge_attention.world_attention_parts`, which the kernel folds
    in; on the plain path inside ``edge_attention``.
    """

    def __init__(
        self,
        hidden_size: int,
        num_heads: int = 4,
        pos_dimension: int = 3,
        use_rope_embeddings: bool = False,
        use_gated_attention: bool = False,
        rope_base: float = 10000.0,
        dtype=torch.float32,
    ):
        super().__init__()
        if hidden_size % num_heads:
            raise ValueError(f"hidden {hidden_size} is not a multiple of {num_heads} heads")
        self.hidden_size = hidden_size
        self.num_heads = num_heads
        self.pos_dimension = pos_dimension
        self.use_rope_embeddings = use_rope_embeddings
        self.rope_base = rope_base
        self.dtype = dtype
        self.q_proj = Dense(hidden_size, hidden_size)
        self.k_proj = Dense(hidden_size, hidden_size)
        self.v_proj = Dense(hidden_size, hidden_size)
        self.gate_proj = Dense(hidden_size, hidden_size) if use_gated_attention else None
        self.proj = Dense(hidden_size, hidden_size)
        self.register_buffer("head_perm", head_perm(hidden_size, num_heads), persistent=False)

    def _heads(self, proj: Dense, x: torch.Tensor) -> torch.Tensor:
        """proj(x) heads first: [..., H, dh]."""
        perm = self.head_perm
        y = dense(x, proj.weight.index_select(0, perm), proj.bias.index_select(0, perm))
        return y.view(x.shape[:-1] + (self.num_heads, self.hidden_size // self.num_heads))

    def _fused_ok(self, x, senders, return_attention, tiling) -> bool:
        """Whether a kernel applies on ``tiling``, an NKTiling or a
        CSRLayout (layers.py:Attention._fused_attn_ok :290): a head width
        dividing ``LANES``, as JAX's gate asks, and the graph's edge arrays
        the layout's rows. JAX's B·H lane term serves the TPU kernel's lane
        packing only, and stays out."""
        return (
            tiling is not None
            and LANES % (self.hidden_size // self.num_heads) == 0
            and senders is not None
            and not return_attention
            and self.dtype == torch.bfloat16
            and x.dtype == torch.bfloat16
            and x.ndim == 3
            and x.shape[0] == tiling.num_nodes
            and senders.shape[0] == tiling.total_rows
        )

    def forward(
        self,
        x: torch.Tensor,
        senders: Optional[torch.Tensor] = None,
        receivers: Optional[torch.Tensor] = None,
        edge_mask: Optional[torch.Tensor] = None,
        node_mask: Optional[torch.Tensor] = None,
        pos: Optional[torch.Tensor] = None,
        return_attention: bool = False,
        tiling: Optional[Layout] = None,
        wedge_senders: Optional[torch.Tensor] = None,
        wedge_receivers: Optional[torch.Tensor] = None,
        wedge_mask: Optional[torch.Tensor] = None,
    ):
        if self.use_rope_embeddings and pos is None:
            raise ValueError("RoPE embeddings require positional information.")
        lead = x.shape[:-1]  # [N] or packed [N, B]
        dh = self.hidden_size // self.num_heads
        q, k, v = (self._heads(p, x) for p in (self.q_proj, self.k_proj, self.v_proj))
        if self.use_rope_embeddings:
            inv = make_inv_freq(dh // max(self.pos_dimension * 2, 1), self.rope_base, x.device)
            q = apply_spatial_rope(q, pos[:, :self.pos_dimension], inv)
            k = apply_spatial_rope(k, pos[:, :self.pos_dimension], inv)

        weights = None
        if self._fused_ok(x, senders, return_attention, tiling):
            world = {}
            if wedge_senders is not None:  # the world edges' softmax pieces
                world["world_parts"] = world_attention_parts(q, k, v, wedge_senders,
                                                             wedge_receivers, wedge_mask)
            fused = (fused_edge_attention_nk if isinstance(tiling, NKTiling)
                     else fused_edge_attention_csr)
            y = fused(q, k, v, senders, receivers, edge_mask, tiling, **world)
        elif senders is not None:
            y = edge_attention(q, k, v, senders, receivers, edge_mask,
                               return_weights=return_attention, wedge_senders=wedge_senders,
                               wedge_receivers=wedge_receivers, wedge_mask=wedge_mask)
            if return_attention:
                y, weights = y
        else:  # dense over the valid nodes: [..., H, N, M] logits
            qh, kh, vh = (t.movedim(0, -2) for t in (q, k, v))
            logits = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) / math.sqrt(dh)
            if node_mask is not None:
                logits = torch.where(node_mask, logits,
                                     torch.full((), -float("inf"), device=x.device))
            weights = torch.softmax(logits, dim=-1)
            y = torch.matmul(weights.to(v.dtype), vh).movedim(-2, 0)

        if self.gate_proj is not None:
            y = y * torch.sigmoid(self._heads(self.gate_proj, x)).to(y.dtype)
        perm = self.head_perm
        out = dense(y.reshape(lead + (self.hidden_size,)), self.proj.weight.index_select(1, perm),
                    self.proj.bias)
        return (out, weights) if return_attention else out


class TransformerBlock(nn.Module):
    """Pre-norm transformer block with a gated-MLP FFN
    (layers.py:TransformerBlock; reference Transformer, layers.py:700-819):
    x += attention(norm1(x)); x += gated_mlp(norm2(x)), the gated MLP
    opening with its own RMSNorm. With an NK slot or CSR layout on a
    packed bf16 graph the FFN half runs as one kernel
    (:func:`ops.fused_ffn.fused_gated_ffn`), keyed on the layout as the JAX
    package keys it on its tiling, at the hidden widths JAX fuses, those
    that divide ``LANES`` = 128 (layers.py:517-524). JAX's other two
    conditions, B·H and N multiples of 128, serve the TPU kernel's lane
    packing: the port's layouts pad N to 128, and its kernels take any B.
    """

    def __init__(
        self,
        hidden_size: int,
        num_heads: int = 4,
        use_rope_embeddings: bool = False,
        use_gated_attention: bool = False,
        pos_dimension: int = 3,
        rope_base: float = 10000.0,
        use_silu: bool = False,
        dtype=torch.float32,
    ):
        super().__init__()
        self.hidden_size = hidden_size
        self.dtype = dtype
        self.norm1 = RMSNorm(hidden_size, dtype=dtype)
        self.attention = Attention(
            hidden_size, num_heads=num_heads, pos_dimension=pos_dimension,
            use_rope_embeddings=use_rope_embeddings, use_gated_attention=use_gated_attention,
            rope_base=rope_base, dtype=dtype)
        self.norm2 = RMSNorm(hidden_size, dtype=dtype)
        self.gated_mlp = GatedMLPBlock(hidden_size, hidden_size, hidden_size,
                                       use_silu=use_silu, dtype=dtype)

    def forward(
        self,
        x: torch.Tensor,
        senders: Optional[torch.Tensor] = None,
        receivers: Optional[torch.Tensor] = None,
        edge_mask: Optional[torch.Tensor] = None,
        node_mask: Optional[torch.Tensor] = None,
        pos: Optional[torch.Tensor] = None,
        tiling: Optional[Layout] = None,
        wedge_senders: Optional[torch.Tensor] = None,
        wedge_receivers: Optional[torch.Tensor] = None,
        wedge_mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        x = x + self.attention(self.norm1(x), senders, receivers, edge_mask, node_mask, pos,
                               tiling=tiling, wedge_senders=wedge_senders,
                               wedge_receivers=wedge_receivers, wedge_mask=wedge_mask)
        if (tiling is not None and self.dtype == torch.bfloat16 and x.ndim == 3
                and x.shape[0] == tiling.num_nodes and LANES % self.hidden_size == 0):
            return fused_gated_ffn(x.to(self.dtype), self.gated_mlp, self.norm2).to(x.dtype)
        return x + self.gated_mlp(self.norm2(x))
