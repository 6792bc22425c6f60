"""Edge attention on the uniform-degree (NK) slot layout.

Replaces the TPU Pallas kernel graph_physics_tpu/ops/fused_edge_attention_nk.py:
_nk_fwd_kernel (:476, body _nk_common :437) behind fused_edge_attention_nk
(:545), without the world-edge sidecar. The CUDA kernel
(``csrc/fused_edge_attention_nk.cu``) runs one thread per (receiver,
sample, head) over the receiver's K slots; see its header for the design
and the bound.

:func:`fused_edge_attention_nk_reference` is the plain PyTorch version:
gather by ``senders.view(G, K, nb)``, a masked softmax over K and the
weighted sum, rounding where the kernel rounds. The wrapper uses it for
tensors on the CPU; for CUDA tensors it launches the kernel or raises.
Only the forward is ported (ROADMAP B row 6 is the backward).
"""

from __future__ import annotations

import ctypes
import math

import torch

from graph_physics_tpu_torch.ops import kernel_build

#: head widths the kernel is compiled for (``DH`` template instances): the
#: canonical configs' hidden 64 and 128 over 4 heads
KERNEL_HEAD_DIMS = (16, 32)
#: most slots per receiver the kernel takes (``MAXK``)
KERNEL_MAX_SLOTS = 32

_vp, _i = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {"ea_nk_fwd": [_vp, _vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i, _i, _i, _vp]}


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
    take :func:`fused_edge_attention_nk_reference`; CUDA tensors launch
    the kernel, counted in ``fused_edge_attention_nk.launches``.
    """
    _check(q, k, v, senders, edge_mask, nk)
    if q.device.type == "cpu":
        return fused_edge_attention_nk_reference(q, k, v, senders, edge_mask, nk)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    n, b, h, dh = q.shape
    if dh not in KERNEL_HEAD_DIMS:
        raise NotImplementedError(f"the kernel is built for head widths {KERNEL_HEAD_DIMS}, "
                                  f"got {dh}")
    if nk.k_slots > KERNEL_MAX_SLOTS:
        raise NotImplementedError(f"the kernel takes at most {KERNEL_MAX_SLOTS} slots per "
                                  f"receiver, got {nk.k_slots}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError("the attention kernel's backward is not ported")
    out = torch.empty_like(q)
    err = kernel_build.load("edge_attention_nk", _ARGTYPES).ea_nk_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), senders.data_ptr(),
        edge_mask.data_ptr(), n, b, h, dh, nk.k_slots, nk.node_block,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_edge_attention_nk launch failed with CUDA error {err}")
    fused_edge_attention_nk.launches += 1
    return out


fused_edge_attention_nk.launches = 0


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
    denom = p.float().sum(1)  # [G, nb, B, H]
    num = (p.unsqueeze(-1) * ve).float().sum(1)  # [G, nb, B, H, dh]
    out = torch.where(denom.unsqueeze(-1) > 0, num / denom.clamp_min(1e-30).unsqueeze(-1),
                      torch.zeros_like(num))
    return out.reshape(n, b, h, dh).to(q.dtype)
