"""Edge attention on the receiver-sorted CSR edge layout.

Replaces the TPU Pallas kernel graph_physics_tpu/ops/fused_edge_attention.py:
_fwd_kernel (:124) behind fused_edge_attention (:206), without
``world_parts`` (the world sidecar, ROADMAP A 11). The CUDA kernel
(``csrc/fused_edge_attention_csr.cu``) runs one thread per (receiver,
sample, head) and two passes over the receiver's CSR rows (the max of the
logits, then exp and the weighted sum), so the degree has no cap. See the
source's header for the design and the bound.

The plain version is :func:`ops.edge_attention.edge_attention` on the
graph's CSR edge list. The wrapper uses it for tensors on the CPU; for
CUDA tensors it launches the kernel or raises. There is no backward
kernel yet, so on a CUDA tensor that needs a gradient the wrapper raises.
"""

from __future__ import annotations

import ctypes

import torch

from graph_physics_tpu_torch.ops import kernel_build
from graph_physics_tpu_torch.ops.edge_attention import edge_attention
from graph_physics_tpu_torch.ops.fused_edge_attention_nk import KERNEL_HEAD_DIMS

_vp, _i = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {"ea_csr_fwd": [_vp] * 7 + [_i] * 4 + [_vp]}


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
    :func:`ops.edge_attention.edge_attention`; CUDA tensors launch the
    kernel, counted in ``fused_edge_attention_csr.launches``.
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
    n, b, h, dh = q.shape
    if dh not in KERNEL_HEAD_DIMS:
        raise NotImplementedError(f"the kernel is built for head widths {KERNEL_HEAD_DIMS}, "
                                  f"got {dh}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError("the CSR edge attention has no backward kernel yet: call it "
                                  "under torch.no_grad() or inference_mode()")
    out = torch.empty_like(q)
    err = kernel_build.load("edge_attention_csr", _ARGTYPES).ea_csr_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        csr.row_ptr_on(q.device).data_ptr(), senders.data_ptr(), edge_mask.data_ptr(),
        n, b, h, dh, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_edge_attention_csr launch failed with CUDA error {err}")
    fused_edge_attention_csr.launches += 1
    return out


fused_edge_attention_csr.launches = 0
