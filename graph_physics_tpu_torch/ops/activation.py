"""SiLU on bf16 tensors as the JAX package evaluates it, and the exact GELU
with the Pallas kernels' derivative.

XLA evaluates ``jax.nn.silu`` on a bf16 array step by step, rounding each
step to bf16: x · bf16(1 / bf16(1 + bf16(exp(−x)))) (the compiled HLO of
``jax.jit(jax.nn.silu)`` converts to bf16 after the exponential, the sum
and the quotient), and the Pallas kernels' derivative
``_act_grad("silu", pre)`` (graph_physics_tpu/ops/fused_gnblock.py:141-143)
on a bf16 ``pre`` rounds each of 1 − s, pre·(1 − s), 1 + … and s·(…).
``F.silu`` rounds once, and differs from that chain on about 40% of
normal bf16 inputs by up to a few bf16 ulps, which four layers and an
RMSNorm tail carry past the kernels' bound. fp32 tensors take ``F.silu``.
The CUDA kernels compute the same chain (``csrc/act_common.cuh``).

:func:`gelu_kernel_grad` is the exact GELU (fp32, rounded once) whose
backward, on bf16, is the Pallas kernels' ``g * _act_grad("gelu", pre)``
(:144-148): the derivative rounded to bf16, then the product; autograd of
the fp32 formula rounds the product only. The GraphNetBlock's plain
version uses it (``ops/fused_gnblock_nk.mlp_tail_reference``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _bf(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _sigmoid_chain(xf: torch.Tensor) -> torch.Tensor:
    """bf16(1 / bf16(1 + bf16(exp(−x)))) as fp32 values, from fp32 ``xf``
    holding bf16 values."""
    return _bf(1.0 / _bf(1.0 + _bf(torch.exp(-xf))))


def silu_values(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` of a bf16 tensor, every step rounded, no gradient."""
    xf = x.float()
    return (xf * _sigmoid_chain(xf)).to(torch.bfloat16)


def silu_grad(x: torch.Tensor) -> torch.Tensor:
    """SiLU's derivative at ``x`` in ``x``'s dtype: on bf16,
    ``_act_grad("silu", x)``'s chain s·(1 + x·(1 − s)) with s the sigmoid
    chain and every step rounded; otherwise in ``x``'s dtype."""
    if x.dtype != torch.bfloat16:
        s = torch.sigmoid(x)
        return s * (1.0 + x * (1.0 - s))
    xf = x.float()
    s = _sigmoid_chain(xf)
    return (s * _bf(1.0 + _bf(xf * _bf(1.0 - s)))).to(torch.bfloat16)


class _SiluBF16(torch.autograd.Function):
    """:func:`silu_values` with the Pallas kernels' backward: the cotangent
    times :func:`silu_grad`, rounded to bf16 (fused_gnblock.py:_mlp_bwd)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return silu_values(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return (g.float() * silu_grad(x).float()).to(g.dtype)


def gelu_values(x: torch.Tensor) -> torch.Tensor:
    """The exact GELU in fp32, rounded once to ``x``'s dtype."""
    xf = x.float()
    return (0.5 * xf * (1.0 + torch.erf(xf * 0.7071067811865476))).to(x.dtype)


def gelu_grad(x: torch.Tensor) -> torch.Tensor:
    """The exact GELU's derivative Φ(x) + x·φ(x) in fp32, rounded once to
    ``x``'s dtype (_act_grad("gelu", x))."""
    xf = x.float()
    d = 0.5 * (1.0 + torch.erf(xf * 0.7071067811865476)) + \
        xf * torch.exp(-0.5 * xf * xf) * 0.3989422804014327
    return d.to(x.dtype)


class _GeluKernelGrad(torch.autograd.Function):
    """:func:`gelu_values` with the Pallas kernels' backward: the cotangent
    times :func:`gelu_grad`, rounded to the cotangent's dtype."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return gelu_values(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return (g.float() * gelu_grad(x).float()).to(g.dtype)


def gelu_kernel_grad(x: torch.Tensor) -> torch.Tensor:
    """The exact GELU; on bf16 its gradient rounds the derivative first, as
    the Pallas kernels do."""
    return _GeluKernelGrad.apply(x) if x.dtype == torch.bfloat16 else gelu_values(x)


def silu(x: torch.Tensor) -> torch.Tensor:
    """SiLU: the rounded chain on bf16 tensors, ``F.silu`` otherwise."""
    return _SiluBF16.apply(x) if x.dtype == torch.bfloat16 else F.silu(x)
