"""Edge attention on the uniform-degree (NK) slot layout.

Replaces the TPU Pallas kernels graph_physics_tpu/ops/fused_edge_attention_nk.py:
_nk_fwd_kernel (:476, body _nk_common :437) and _nk_bwd_kernel (:495)
behind fused_edge_attention_nk (:545), without the world-edge sidecar.
The forward CUDA kernel (``csrc/fused_edge_attention_nk.cu``) runs one
thread per (receiver, sample, head) over the receiver's K slots; the
backward (``csrc/fused_edge_attention_nk_bwd.cu``) recomputes the softmax
the same way, writes dq, and sums dk and dv at each sender over a
sender-sorted list of slots, with no atomics. See the sources' headers
for the designs and the bounds.

:func:`fused_edge_attention_nk_reference` is the plain PyTorch version of
the forward: gather by ``senders.view(G, K, nb)``, a masked softmax over K
and the weighted sum, rounding where the kernel rounds;
:func:`fused_edge_attention_nk_backward_reference` is the plain version of
the backward. The wrapper uses the forward's plain version, with plain
autograd, for tensors on the CPU; for CUDA tensors it launches the
kernels (the backward through ``torch.autograd.Function``) or raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch
from torch.autograd.function import once_differentiable

from graph_physics_tpu_torch.ops import kernel_build
from graph_physics_tpu_torch.ops.tiling import cached_sender_slots

#: head widths the kernels are compiled for (``DH`` template instances):
#: the canonical configs' hidden 64 and 128 over 4 heads
KERNEL_HEAD_DIMS = (16, 32)
#: most slots per receiver the kernels take (``MAXK``)
KERNEL_MAX_SLOTS = 32

_vp, _i = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "edge_attention_nk": {"ea_nk_fwd": [_vp, _vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i, _i, _i,
                                        _vp]},
    "edge_attention_nk_bwd": {"ea_nk_bwd": [_vp] * 14 + [_i] * 6 + [_vp]},
}


def _check(q, k, v, senders, edge_mask, nk):
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must be packed [N, B, H, dh] of one shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise ValueError(f"bf16 q, k, v required, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.shape[0] != nk.num_nodes:
        raise ValueError(f"{q.shape[0]} nodes do not match the NK layout's {nk.num_nodes}")
    if senders.shape != (nk.total_rows,) or edge_mask.shape != (nk.total_rows,):
        raise ValueError("senders and edge_mask must hold one entry per slot")
    if senders.dtype != torch.int32 or edge_mask.dtype != torch.bool:
        raise ValueError("senders must be int32 and edge_mask bool")
    for t in (q, k, v, senders, edge_mask):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("inputs must be contiguous and on one device")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_fwd(q, k, v, senders, edge_mask, nk):
    n, b, h, dh = q.shape
    out = torch.empty_like(q)
    err = kernel_build.load("edge_attention_nk", _ARGTYPES["edge_attention_nk"]).ea_nk_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), senders.data_ptr(),
        edge_mask.data_ptr(), n, b, h, dh, nk.k_slots, nk.node_block, _stream(q))
    if err != 0:
        raise RuntimeError(f"fused_edge_attention_nk launch failed with CUDA error {err}")
    fused_edge_attention_nk.launches += 1
    return out


def _launch_bwd(q, k, v, senders, edge_mask, nk, g_out):
    """dq, dk, dv (bf16) from the backward kernel."""
    n, b, h, dh = q.shape
    order, offsets = cached_sender_slots(senders, edge_mask, nk)
    dq, dk, dv, gp = (torch.empty_like(q) for _ in range(4))
    p_slot = torch.empty((nk.total_rows, b, h), dtype=q.dtype, device=q.device)
    gl_slot = torch.empty_like(p_slot)
    err = kernel_build.load("edge_attention_nk_bwd",
                            _ARGTYPES["edge_attention_nk_bwd"]).ea_nk_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g_out.data_ptr(), senders.data_ptr(),
        edge_mask.data_ptr(), order.data_ptr(), offsets.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), gp.data_ptr(), p_slot.data_ptr(), gl_slot.data_ptr(),
        n, b, h, dh, nk.k_slots, nk.node_block, _stream(q))
    if err != 0:
        raise RuntimeError(f"fused_edge_attention_nk backward launch failed with CUDA error {err}")
    fused_edge_attention_nk.backward_launches += 1
    return dq, dk, dv


class _FusedEdgeAttentionNK(torch.autograd.Function):
    """A forward with its backward as the gradient: the kernels
    (``_launch_fwd``, ``_launch_bwd``) or the plain versions
    (:data:`PLAIN`), given as the pair ``impl``."""

    @staticmethod
    def forward(ctx, q, k, v, senders, edge_mask, nk, impl):
        ctx.save_for_backward(q, k, v, senders, edge_mask)
        ctx.nk, ctx.impl = nk, impl
        return impl[0](q, k, v, senders, edge_mask, nk)

    @staticmethod
    @once_differentiable
    def backward(ctx, g_out):
        q, k, v, senders, edge_mask = ctx.saved_tensors
        dq, dk, dv = ctx.impl[1](q, k, v, senders, edge_mask, ctx.nk, g_out.contiguous())
        return dq, dk, dv, None, None, None, None


def fused_edge_attention_nk(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    senders: torch.Tensor,
    edge_mask: torch.Tensor,
    nk,
) -> torch.Tensor:
    """Edge-masked multi-head attention on the NK slot layout, in bf16.

    q, k, v are bf16 [N, B, H, dh] (heads first, as the JAX package lays
    them out); ``senders`` [G·K·nb] int32 and ``edge_mask`` [G·K·nb] bool
    are the graph's slot arrays (slot g·K·nb + k·nb + r belongs to
    receiver g·nb + r); ``nk`` is the NKTiling. Returns bf16
    [N, B, H, dh]; a receiver with no valid slot gets zeros. CPU tensors
    take :func:`fused_edge_attention_nk_reference` (gradient by plain
    autograd); CUDA tensors launch the kernel, counted in
    ``fused_edge_attention_nk.launches``, and under autograd its gradient
    is the backward kernel, counted in
    ``fused_edge_attention_nk.backward_launches``.
    """
    _check(q, k, v, senders, edge_mask, nk)
    if q.device.type == "cpu":
        return fused_edge_attention_nk_reference(q, k, v, senders, edge_mask, nk)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    dh = q.shape[-1]
    if dh not in KERNEL_HEAD_DIMS:
        raise NotImplementedError(f"the kernel is built for head widths {KERNEL_HEAD_DIMS}, "
                                  f"got {dh}")
    if nk.k_slots > KERNEL_MAX_SLOTS:
        raise NotImplementedError(f"the kernel takes at most {KERNEL_MAX_SLOTS} slots per "
                                  f"receiver, got {nk.k_slots}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FusedEdgeAttentionNK.apply(q, k, v, senders, edge_mask, nk, KERNELS)
    return _launch_fwd(q, k, v, senders, edge_mask, nk)


fused_edge_attention_nk.launches = 0
fused_edge_attention_nk.backward_launches = 0


def _softmax_parts(q, k, v, senders, edge_mask, nk):
    """The slots' gathered k and v [G, K, nb, B, H, dh], q broadcast over K
    [G, 1, nb, B, H, dh], the valid-slot mask [G, K, nb, 1, 1], the bf16
    weights p = exp(logit - the receiver's max) [G, K, nb, B, H] and their
    fp32 sum [G, nb, B, H]."""
    n, b, h, dh = q.shape
    g, kk, nb = nk.num_groups, nk.k_slots, nk.node_block
    ke = k.index_select(0, senders).view(g, kk, nb, b, h, dh)
    ve = v.index_select(0, senders).view(g, kk, nb, b, h, dh)
    qe = q.view(g, 1, nb, b, h, dh)
    logits = (qe * ke).float().sum(-1) / math.sqrt(dh)  # [G, K, nb, B, H]
    valid = edge_mask.view(g, kk, nb, 1, 1)
    neg_inf = torch.full((), -float("inf"), device=q.device)
    shift = torch.where(valid, logits, neg_inf).amax(1, keepdim=True)
    shift = torch.where(torch.isfinite(shift), shift, torch.zeros_like(shift))
    p = torch.where(valid, torch.exp(logits - shift), torch.zeros_like(logits)).to(q.dtype)
    return qe, ke, ve, valid, p, p.float().sum(1)


def fused_edge_attention_nk_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    senders: torch.Tensor,
    edge_mask: torch.Tensor,
    nk,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_edge_attention_nk`, rounding
    as the kernel and _nk_common do: bf16 q·k products summed in fp32 and
    divided by sqrt(dh), exp(logit - max) over the receiver's valid slots
    rounded to bf16, p·v rounded to bf16, fp32 sums over the K slots, an
    fp32 division, bf16 out. The max is the receiver's own (the TPU kernel
    shifts by one max per tile; the softmax is the same up to rounding)."""
    _, _, ve, _, p, denom = _softmax_parts(q, k, v, senders, edge_mask, nk)
    num = (p.unsqueeze(-1) * ve).float().sum(1)  # [G, nb, B, H, dh]
    out = torch.where(denom.unsqueeze(-1) > 0, num / denom.clamp_min(1e-30).unsqueeze(-1),
                      torch.zeros_like(num))
    return out.reshape(q.shape).to(q.dtype)


def fused_edge_attention_nk_backward_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    senders: torch.Tensor,
    edge_mask: torch.Tensor,
    nk,
    g_out: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernel: (dq, dk, dv) of
    Σ out·g_out, following _nk_bwd_kernel (fused_edge_attention_nk.py:
    509-536) without the world sidecar and rounding where it rounds. p
    and its sum are recomputed with the forward's shift (the receiver's
    own max, which cancels in p/denom);
      inv = 1/denom (0 for a receiver with no valid slot),
      gp = bf16(g_out · inv),  abar_s = Σ_d bf16(v_s · gp)  (bf16),
      s_r = bf16(Σ_s bf16(p_s · abar_s) · inv),
      g_s = bf16(bf16(p_s · bf16(abar_s − s_r)) / sqrt(dh)),
      dq = bf16(Σ_s bf16(g_s · k_s)),
    and at each sender j, over the valid slots s that it sends on,
      dk_j = bf16(Σ_s bf16(g_s · q_r(s))),  dv_j = bf16(Σ_s bf16(p_s · gp_r(s))).
    Sums are fp32."""
    cd = q.dtype
    n, b, h, dh = q.shape
    g, nb = nk.num_groups, nk.node_block
    qe, ke, ve, valid, p, denom = _softmax_parts(q, k, v, senders, edge_mask, nk)
    inv = torch.where(denom > 0, 1.0 / denom.clamp_min(1e-30), torch.zeros_like(denom))
    gp = (g_out.view(g, 1, nb, b, h, dh).float() * inv.unsqueeze(1).unsqueeze(-1)).to(cd)
    abar = (ve * gp).float().sum(-1).to(cd)  # [G, K, nb, B, H]
    s_r = ((p * abar).float().sum(1, keepdim=True) * inv.unsqueeze(1)).to(cd)
    g_logit = ((p * (abar - s_r)) / math.sqrt(dh)).to(cd)
    zero = torch.zeros((), dtype=cd, device=q.device)
    g_logit = torch.where(valid, g_logit, zero).unsqueeze(-1)
    dq = (g_logit * ke).float().sum(1).reshape(q.shape).to(cd)
    per_slot = (-1, b, h, dh)
    dk = torch.zeros(q.shape, dtype=torch.float32, device=q.device).index_add_(
        0, senders, (g_logit * qe).reshape(per_slot).float())
    dv = torch.zeros(q.shape, dtype=torch.float32, device=q.device).index_add_(
        0, senders, torch.where(valid.unsqueeze(-1), p.unsqueeze(-1) * gp, zero)
        .reshape(per_slot).float())
    return dq, dk.to(cd), dv.to(cd)


#: the forward and backward as kernels, and as plain versions
KERNELS = (_launch_fwd, _launch_bwd)
PLAIN = (fused_edge_attention_nk_reference, fused_edge_attention_nk_backward_reference)


def reference_with_backward(q, k, v, senders, edge_mask, nk) -> torch.Tensor:
    """:func:`fused_edge_attention_nk_reference` with
    :func:`fused_edge_attention_nk_backward_reference` as its gradient,
    through the same ``torch.autograd.Function`` as the kernels."""
    _check(q, k, v, senders, edge_mask, nk)
    return _FusedEdgeAttentionNK.apply(q, k, v, senders, edge_mask, nk, PLAIN)
