"""Edge attention on the receiver-sorted CSR edge layout.

Replaces the TPU Pallas kernels graph_physics_tpu/ops/fused_edge_attention.py:
_fwd_kernel (:124) and _bwd_kernel (:143) behind fused_edge_attention
(:206), without ``world_parts`` (the world sidecar, ROADMAP A 5). The
forward CUDA kernel (``csrc/fused_edge_attention_csr.cu``) runs one thread
per (receiver, sample, head) and two passes over the receiver's CSR rows
(the max of the logits, then exp and the weighted sum), so the degree has
no cap; the backward (``csrc/fused_edge_attention_csr_bwd.cu``) recomputes
the softmax the same way, writes dq, and sums dk and dv at each sender
over the layout's sender-sorted row list, with no atomics. See the
sources' headers for the designs and the bounds.

The plain version is :func:`ops.edge_attention.edge_attention` on the
graph's CSR edge list, and its gradient plain autograd
(:func:`edge_attention_backward_reference`). The wrapper uses it for
tensors on the CPU; for CUDA tensors it launches the kernels (the backward
through ``torch.autograd.Function``) or raises.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from graph_physics_tpu_torch.ops import kernel_build
from graph_physics_tpu_torch.ops.edge_attention import edge_attention
from graph_physics_tpu_torch.ops.fused_edge_attention_nk import KERNEL_HEAD_DIMS
from graph_physics_tpu_torch.ops.tiling import cached_sender_slots

_vp, _i = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "edge_attention_csr": {"ea_csr_fwd": [_vp] * 7 + [_i] * 4 + [_vp]},
    "edge_attention_csr_bwd": {"ea_csr_bwd": [_vp] * 16 + [_i] * 4 + [_vp]},
}


def _load(name: str):
    return kernel_build.load(name, _ARGTYPES[name])


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_fwd(q, k, v, senders, receivers, edge_mask, csr):
    n, b, h, dh = q.shape
    out = torch.empty_like(q)
    err = _load("edge_attention_csr").ea_csr_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        csr.row_ptr_on(q.device).data_ptr(), senders.data_ptr(), edge_mask.data_ptr(),
        n, b, h, dh, _stream(q))
    if err != 0:
        raise RuntimeError(f"fused_edge_attention_csr launch failed with CUDA error {err}")
    fused_edge_attention_csr.launches += 1
    return out


def _launch_bwd(q, k, v, senders, receivers, edge_mask, csr, g_out):
    """dq, dk, dv (bf16) from the backward kernel."""
    n, b, h, dh = q.shape
    order, offsets = cached_sender_slots(senders, edge_mask, csr)
    dq, dk, dv, gp = (torch.empty_like(q) for _ in range(4))
    p_row = torch.empty((csr.total_rows, b, h), dtype=q.dtype, device=q.device)
    g_row = torch.empty_like(p_row)
    err = _load("edge_attention_csr_bwd").ea_csr_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g_out.data_ptr(),
        csr.row_ptr_on(q.device).data_ptr(), senders.data_ptr(), receivers.data_ptr(),
        edge_mask.data_ptr(), order.data_ptr(), offsets.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), gp.data_ptr(), p_row.data_ptr(), g_row.data_ptr(),
        n, b, h, dh, _stream(q))
    if err != 0:
        raise RuntimeError(f"fused_edge_attention_csr backward launch failed with CUDA error "
                           f"{err}")
    fused_edge_attention_csr.backward_launches += 1
    return dq, dk, dv


def _reference_fwd(q, k, v, senders, receivers, edge_mask, csr):
    return edge_attention(q, k, v, senders, receivers, edge_mask)


def edge_attention_backward_reference(q, k, v, senders, receivers, edge_mask, csr, g_out):
    """Plain version of the backward kernel: (dq, dk, dv) of Σ out·g_out by
    plain autograd of :func:`ops.edge_attention.edge_attention`."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = edge_attention(*leaves, senders, receivers, edge_mask)
        return torch.autograd.grad(out, leaves, g_out)


#: the forward and backward as kernels, and as plain versions
KERNELS = (_launch_fwd, _launch_bwd)
PLAIN = (_reference_fwd, edge_attention_backward_reference)


class _FusedEdgeAttentionCSR(torch.autograd.Function):
    """A forward with its backward as the gradient: the kernels
    (:data:`KERNELS`) or the plain versions (:data:`PLAIN`), given as the
    pair ``impl``."""

    @staticmethod
    def forward(ctx, q, k, v, senders, receivers, edge_mask, csr, impl):
        ctx.save_for_backward(q, k, v, senders, receivers, edge_mask)
        ctx.csr, ctx.impl = csr, impl
        return impl[0](q, k, v, senders, receivers, edge_mask, csr)

    @staticmethod
    @once_differentiable
    def backward(ctx, g_out):
        q, k, v, senders, receivers, edge_mask = ctx.saved_tensors
        dq, dk, dv = ctx.impl[1](q, k, v, senders, receivers, edge_mask, ctx.csr,
                                 g_out.contiguous())
        return dq, dk, dv, None, None, None, None, None


def fused_edge_attention_csr(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    senders: torch.Tensor,
    receivers: torch.Tensor,
    edge_mask: torch.Tensor,
    csr,
) -> torch.Tensor:
    """Edge-masked multi-head attention on the CSR layout, in bf16.

    q, k, v are bf16 [N, B, H, dh] (heads first); ``senders``,
    ``receivers`` [S] int32 and ``edge_mask`` [S] bool are the graph's row
    arrays (receiver r owns rows ``csr.row_ptr[r]:csr.row_ptr[r+1]``);
    ``csr`` is the CSRLayout. Returns bf16 [N, B, H, dh]; a receiver with
    no valid row gets zeros. CPU tensors take
    :func:`ops.edge_attention.edge_attention` (gradient by plain autograd);
    CUDA tensors launch the forward kernel, counted in
    ``fused_edge_attention_csr.launches``, and under autograd its gradient
    is the backward kernel, counted in
    ``fused_edge_attention_csr.backward_launches``.
    """
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must be packed [N, B, H, dh] of one shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise ValueError(f"bf16 q, k, v required, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.shape[0] != csr.num_nodes:
        raise ValueError(f"{q.shape[0]} nodes do not match the CSR layout's {csr.num_nodes}")
    if any(t.shape != (csr.total_rows,) for t in (senders, receivers, edge_mask)):
        raise ValueError("senders, receivers and edge_mask must hold one entry per row")
    if senders.dtype != torch.int32 or receivers.dtype != torch.int32 or \
            edge_mask.dtype != torch.bool:
        raise ValueError("senders and receivers must be int32 and edge_mask bool")
    for t in (q, k, v, senders, receivers, edge_mask):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("inputs must be contiguous and on one device")
    if q.device.type == "cpu":
        return edge_attention(q, k, v, senders, receivers, edge_mask)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    dh = q.shape[-1]
    if dh not in KERNEL_HEAD_DIMS:
        raise NotImplementedError(f"the kernel is built for head widths {KERNEL_HEAD_DIMS}, "
                                  f"got {dh}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FusedEdgeAttentionCSR.apply(q, k, v, senders, receivers, edge_mask, csr,
                                            KERNELS)
    return _launch_fwd(q, k, v, senders, receivers, edge_mask, csr)


fused_edge_attention_csr.launches = 0
fused_edge_attention_csr.backward_launches = 0


def reference_with_backward(q, k, v, senders, receivers, edge_mask, csr) -> torch.Tensor:
    """The plain forward with :func:`edge_attention_backward_reference` as
    its gradient, through the same ``torch.autograd.Function`` as the
    kernels."""
    return _FusedEdgeAttentionCSR.apply(q, k, v, senders, receivers, edge_mask, csr, PLAIN)
