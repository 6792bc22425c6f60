"""Transolver++: slice-token physics attention.

Port of graph_physics_tpu/models/transolver.py (gumbel_softmax :41,
PhysicsAttention :68, TransolverBlock :179, TransolverModel :238): a
learned-temperature gumbel-softmax assigns each node to G slices, the
slice tokens are the assignment-weighted means of the node features, the
G tokens attend to each other, and the result is spread back to the nodes
through the same weights; pre-LN blocks with a ratio MLP.

Where JAX vmaps one graph [N, C] over the batch, the port writes the
batch out: every function takes [..., N, C], and the slice statistics sum
over the node axis of each sample, never over the batch. A single [N, C]
graph (the rollout's) is the case with no leading axis.

Training-time slice noise comes from a ``torch.Generator`` passed as
``gumbel`` (JAX's 'gumbel' rng collection); without one the assignment
is the noise-free tempered softmax (eval and rollout). With
``fused_gumbel`` each block draws a fresh Philox key from the generator,
on the generator's device, and perturbs its logits in one kernel
(ops/gumbel.py); otherwise it draws a ``torch.rand`` uniform tensor, the
counterpart of JAX's XLA draw.

Casts follow JAX's: x_mid in the compute dtype; the temperature and the
slice weights fp32; the slice tokens summed in fp32 and cast after the
division by the slice norm; q·k logits fp32, attention weights cast to
the compute dtype; the de-slicing uses the weights in the compute dtype.
Not ported (ROADMAP A 7): RoPE, the attention gate, the condition
embedding and the temporal block raise. The slice statistics' psum
across data-parallel shards (transolver.py:148-151) is a plain sum on one
card (A 9).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from graph_physics_tpu_torch.models.layers import MLP, Activation, Dense, LayerNorm, reset_parameters
from graph_physics_tpu_torch.ops import gumbel as gumbel_ops


def gumbel_softmax(logits: torch.Tensor, tau: torch.Tensor, gumbel: Optional[torch.Generator],
                   hard: bool = False, fused: bool = False,
                   perturb=gumbel_ops.gumbel_perturb) -> torch.Tensor:
    """Tempered, optionally gumbel-perturbed or straight-through softmax
    over the last axis, in fp32 (transolver.py:gumbel_softmax).

    ``gumbel``: the generator of the noise, or None for none. ``fused``
    draws a Philox key from it and adds the noise with ``perturb``
    (ops/gumbel.gumbel_perturb: the kernel on the card); otherwise a
    ``torch.rand`` uniform draw goes through the same double log.
    """
    if gumbel is not None and fused:
        y = perturb(logits, gumbel_ops.draw_key(gumbel, logits.device))
    else:
        y = logits.float()
        if gumbel is not None:
            u = torch.rand(logits.shape, generator=gumbel, device=logits.device,
                           dtype=torch.float32)
            y = y + gumbel_ops.gumbel_noise(u)
    y = torch.softmax(y / tau.float(), dim=-1)
    if hard:
        y_hard = F.one_hot(y.argmax(-1), y.shape[-1]).to(y.dtype)
        y = y_hard + y - y.detach()
    return y


class PhysicsAttention(nn.Module):
    """Physics_Attention_1D_Eidetic (transolver.py:PhysicsAttention) on
    [..., N, C]. ``perturb`` is the fused draw's function: the kernel's
    wrapper, or its plain version on the plain path (:func:`use_plain_gumbel`)."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64, slice_num: int = 64,
                 use_rope_embeddings: bool = False, use_gated_attention: bool = False,
                 fused_gumbel: bool = False, dtype=torch.float32):
        super().__init__()
        if use_rope_embeddings or use_gated_attention:
            raise NotImplementedError("Transolver RoPE and attention gate are not ported")
        self.heads, self.dim_head, self.slice_num = heads, dim_head, slice_num
        self.fused_gumbel = fused_gumbel
        self.dtype = dtype
        self.perturb = gumbel_ops.gumbel_perturb
        inner = heads * dim_head
        self.in_project_x = Dense(dim, inner)
        self.proj_temperature = nn.Sequential(Dense(dim_head, slice_num), Activation("gelu"),
                                              Dense(slice_num, 1), Activation("gelu"))
        # the reference's [1, H, 1, 1] (batched); JAX keeps [1, H, 1]
        self.bias = nn.Parameter(torch.full((1, heads, 1, 1), 0.5))
        self.in_project_slice = Dense(dim_head, slice_num)
        self.to_q = Dense(dim_head, dim_head, bias=False)
        self.to_k = Dense(dim_head, dim_head, bias=False)
        self.to_v = Dense(dim_head, dim_head, bias=False)
        self.to_out = nn.Sequential(Dense(inner, dim))

    def forward(self, x: torch.Tensor, node_mask: Optional[torch.Tensor] = None,
                gumbel: Optional[torch.Generator] = None) -> torch.Tensor:
        *lead, n, _ = x.shape
        h, d = self.heads, self.dim_head
        cd = self.dtype
        x_mid = self.in_project_x(x.to(cd)).view(*lead, n, h, d)
        # learned per-node, per-head temperature (+0.5-init bias, clamp 0.01)
        t = self.proj_temperature(x_mid)
        temperature = torch.clamp(t.float() + self.bias.view(h, 1), min=0.01)  # [..., N, H, 1]
        slice_logits = self.in_project_slice(x_mid)  # [..., N, H, G]
        w = gumbel_softmax(slice_logits, temperature, gumbel, fused=self.fused_gumbel,
                           perturb=self.perturb)  # fp32
        if node_mask is not None:
            w = w * node_mask.float()[..., None, None]
        slice_norm = w.sum(-3)  # [..., H, G]: over the nodes of each sample
        slice_token = torch.einsum("...nhd,...nhg->...hgd", x_mid.float(), w)
        slice_token = (slice_token / (slice_norm + 1e-5)[..., None]).to(cd)
        q, k, v = self.to_q(slice_token), self.to_k(slice_token), self.to_v(slice_token)
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(d)
        attn = torch.softmax(logits, dim=-1).to(cd)
        out_token = torch.matmul(attn, v)  # [..., H, G, D]
        out_x = torch.einsum("...hgd,...nhg->...nhd", out_token, w.to(cd))
        return self.to_out(out_x.reshape(*lead, n, h * d))


class TransolverBlock(nn.Module):
    """Transolver_plus_block (transolver.py:TransolverBlock): pre-LN
    physics attention and ratio MLP, with ``ln_3``/``mlp2`` on the last."""

    def __init__(self, num_heads: int, hidden_dim: int, mlp_ratio: int = 4,
                 last_layer: bool = False, out_dim: int = 1, slice_num: int = 32,
                 use_rope_embeddings: bool = False, use_gated_attention: bool = False,
                 fused_gumbel: bool = False, dtype=torch.float32):
        super().__init__()
        self.last_layer = last_layer
        self.ln_1 = LayerNorm(hidden_dim, dtype=dtype)
        self.Attn = PhysicsAttention(hidden_dim, heads=num_heads,
                                     dim_head=hidden_dim // num_heads, slice_num=slice_num,
                                     use_rope_embeddings=use_rope_embeddings,
                                     use_gated_attention=use_gated_attention,
                                     fused_gumbel=fused_gumbel, dtype=dtype)
        self.ln_2 = LayerNorm(hidden_dim, dtype=dtype)
        self.mlp = MLP(hidden_dim, hidden_dim * mlp_ratio, hidden_dim, nb_of_layers=2,
                       layer_norm=False, activation="gelu", dtype=dtype)
        if last_layer:
            self.ln_3 = LayerNorm(hidden_dim, dtype=dtype)
            self.mlp2 = Dense(hidden_dim, out_dim)

    def forward(self, fx: torch.Tensor, node_mask: Optional[torch.Tensor] = None,
                gumbel: Optional[torch.Generator] = None) -> torch.Tensor:
        fx = fx + self.Attn(self.ln_1(fx), node_mask, gumbel)
        fx = fx + self.mlp(self.ln_2(fx))
        if self.last_layer:
            fx = self.mlp2(self.ln_3(fx))
        return fx


def reference_grid(ref: int) -> np.ndarray:
    """The fixed [ref³, 3] lattice of ``unified_pos`` (transolver.py:
    TransolverModel._ref_grid): x in [-1.5, 1.5], y in [0, 2], z in [-4, 4]."""
    axes = (np.linspace(-1.5, 1.5, ref), np.linspace(0.0, 2.0, ref), np.linspace(-4.0, 4.0, ref))
    xx, yy, zz = np.meshgrid(*axes, indexing="ij")
    return np.stack([xx, yy, zz], axis=-1).reshape(ref**3, 3).astype(np.float32)


class TransolverModel(nn.Module):
    """Model (transolver.py:TransolverModel) on [..., N, fun_dim]: the
    ``preprocess`` MLP (with the ``unified_pos`` distances to the
    reference grid appended), the ``placeholder`` token, ``n_layers``
    blocks; output fp32."""

    def __init__(self, n_layers: int = 5, n_hidden: int = 256, n_head: int = 8,
                 mlp_ratio: int = 1, fun_dim: int = 1, out_dim: int = 1, slice_num: int = 32,
                 ref: int = 8, unified_pos: bool = False, use_rope_embeddings: bool = False,
                 use_gated_attention: bool = False, use_temporal_block: bool = False,
                 fused_gumbel: bool = False, dtype=torch.float32):
        super().__init__()
        if use_temporal_block:
            raise NotImplementedError("the Transolver temporal block is not ported")
        self.unified_pos = unified_pos
        self.dtype = dtype
        self.register_buffer("ref_grid", torch.from_numpy(reference_grid(ref)),
                             persistent=False)
        in_dim = fun_dim + (ref**3 if unified_pos else 0)
        self.preprocess = MLP(in_dim, n_hidden * 2, n_hidden, nb_of_layers=2, layer_norm=False,
                              activation="gelu", dtype=dtype)
        self.placeholder = nn.Parameter(torch.rand(n_hidden) / n_hidden)
        self.blocks = nn.ModuleList(
            TransolverBlock(n_head, n_hidden, mlp_ratio=mlp_ratio,
                            last_layer=i == n_layers - 1, out_dim=out_dim, slice_num=slice_num,
                            use_rope_embeddings=use_rope_embeddings,
                            use_gated_attention=use_gated_attention,
                            fused_gumbel=fused_gumbel, dtype=dtype)
            for i in range(n_layers))

    def forward(self, x: torch.Tensor, pos: Optional[torch.Tensor] = None,
                node_mask: Optional[torch.Tensor] = None,
                gumbel: Optional[torch.Generator] = None,
                condition: Optional[torch.Tensor] = None) -> torch.Tensor:
        if condition is not None:
            raise NotImplementedError("the Transolver condition embedding is not ported")
        if self.unified_pos and pos is not None:
            p3 = pos[..., :3] if pos.shape[-1] >= 3 else F.pad(pos, (0, 3 - pos.shape[-1]))
            diff = p3.float()[..., :, None, :] - self.ref_grid
            dist = torch.sqrt(torch.sum(diff * diff, dim=-1))  # [..., N, R]
            x = torch.cat([x, dist.to(x.dtype)], dim=-1)
        fx = self.preprocess(x) + self.placeholder.to(self.dtype)
        for block in self.blocks:
            fx = block(fx, node_mask, gumbel)
        return fx.float()


@torch.no_grad()
def init_parameters(model: nn.Module, generator: torch.Generator,
                    dense_init=reset_parameters) -> None:
    """Draw a Transolver's weights from ``generator`` as the reference
    initialises them: every Dense as torch's Linear (``dense_init``,
    layers.reset_parameters; layers.lecun_parameters draws them as the JAX
    package does), ``in_project_slice`` orthogonal, ``placeholder`` uniform
    in [0, 1/n_hidden); LayerNorms 1 and 0, the temperature bias 0.5."""
    dense_init(model, generator)
    for m in model.modules():
        if isinstance(m, PhysicsAttention):
            nn.init.orthogonal_(m.in_project_slice.weight, generator=generator)
        elif isinstance(m, TransolverModel):
            n = m.placeholder.numel()
            m.placeholder.copy_(torch.rand(n, generator=generator) / n)


def use_plain_gumbel(module: nn.Module) -> nn.Module:
    """Route every PhysicsAttention's fused draw in ``module`` through the
    plain version (ops/gumbel.reference_with_backward): the same Philox
    bits on the card without the kernel. Returns ``module``."""
    for m in module.modules():
        if isinstance(m, PhysicsAttention):
            m.perturb = gumbel_ops.reference_with_backward
    return module
