"""Edge attention on the uniform-degree (NK) slot layout.

Replaces the TPU Pallas kernels graph_physics_tpu/ops/fused_edge_attention_nk.py:
_nk_fwd_kernel (:476, body _nk_common :437) and _nk_bwd_kernel (:495)
behind fused_edge_attention_nk (:545), without the world-edge sidecar.
The CUDA kernels (``csrc/fused_edge_attention_nk.cu``,
``fused_edge_attention_nk_bwd.cu``) are the CSR attention's bodies
(``csrc/ea_fwd.cuh``, ``ea_bwd_passes.cuh``) on the NK row map
(``csrc/gn_rows.cuh``: receiver g·nb + r owns the K slots g·K·nb + k·nb +
r, masked ones among them): one walk of a receiver's valid slots, with
an online softmax, so K has no cap; under autograd the forward keeps the
softmax statistics, and the backward takes them and the forward's output,
walks each receiver's slots once for dq, and sums dk and dv at each
sender over the slots' sender-sorted transpose
(:func:`ops.fused_edge_attention_csr.sender_places`), with no atomics.
See the sources' headers for the designs and the bounds.

The slot arrays are rows, each with its receiver (``receivers``, as
``ops.tiling.apply_to_graph_nk`` lays it out), so everything but the
kernels is the CSR module's: the plain version
:func:`fused_edge_attention_nk_reference` is
:func:`ops.edge_attention.edge_attention` on the slot arrays, its
gradient plain autograd
(:func:`ops.fused_edge_attention_csr.edge_attention_backward_reference`),
and ``softmax_stats`` the plain version of the kept statistics. Both
layouts keep every q·k and p·v product exact in fp32 (the Pallas NK
kernel rounds each to bf16). The wrapper uses the plain version for
tensors on the CPU; for CUDA tensors it launches the kernels (the backward
through ``torch.autograd.Function``) or raises.
"""

from __future__ import annotations

import ctypes

import torch

from graph_physics_tpu_torch.ops import kernel_build
from graph_physics_tpu_torch.ops.edge_attention import edge_attention
# KERNEL_HEAD_DIMS, PLAIN and reference_with_backward serve both layouts
from graph_physics_tpu_torch.ops.fused_edge_attention_csr import (  # noqa: F401
    KERNEL_HEAD_DIMS,
    PLAIN,
    check_inputs,
    launch_or_plain,
    reference_with_backward,
    sender_places,
)

_vp, _i = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "edge_attention_nk": {"ea_nk_fwd": [_vp] * 8 + [_i] * 6 + [_vp]},
    "edge_attention_nk_bwd": {"ea_nk_bwd": [_vp] * 16 + [_i] * 6 + [_vp]},
}


def _load(name: str):
    return kernel_build.load(name, _ARGTYPES[name])


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_fwd(q, k, v, senders, receivers, edge_mask, nk, keep_stats=False):
    """The output (bf16), and with ``keep_stats`` the softmax statistics
    (m, inv) the backward takes, from the forward kernel."""
    n, b, h, dh = q.shape
    out = torch.empty_like(q)
    m = inv = None
    if keep_stats:
        m, inv = (torch.empty((n, b, h), dtype=torch.float32, device=q.device) for _ in range(2))
    err = _load("edge_attention_nk").ea_nk_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        m.data_ptr() if keep_stats else None, inv.data_ptr() if keep_stats else None,
        senders.data_ptr(), edge_mask.data_ptr(), n, b, h, dh, nk.k_slots, nk.node_block,
        _stream(q))
    if err != 0:
        raise RuntimeError(f"fused_edge_attention_nk launch failed with CUDA error {err}")
    fused_edge_attention_nk.launches += 1
    return (out, (m, inv)) if keep_stats else out


def _launch_bwd(q, k, v, senders, receivers, edge_mask, nk, g_out, saved):
    """dq, dk, dv (bf16) from the backward kernels, given ``saved`` = the
    forward's (out, m, inv)."""
    n, b, h, dh = q.shape
    out, m, inv = saved
    offsets, place, recv = sender_places(senders, receivers, edge_mask, nk)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    pg = torch.empty((nk.total_rows, b, h), dtype=torch.int32, device=q.device)
    err = _load("edge_attention_nk_bwd").ea_nk_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), m.data_ptr(),
        inv.data_ptr(), g_out.data_ptr(), senders.data_ptr(), edge_mask.data_ptr(),
        offsets.data_ptr(), place.data_ptr(), recv.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), pg.data_ptr(), n, b, h, dh, nk.k_slots, nk.node_block, _stream(q))
    if err != 0:
        raise RuntimeError(f"fused_edge_attention_nk backward launch failed with CUDA error {err}")
    fused_edge_attention_nk.backward_launches += 1
    return dq, dk, dv


#: the forward and backward as kernels (the plain versions, :data:`PLAIN`,
#: are the CSR module's): the forward called with ``keep_stats=True``
#: returns (out, (m, inv)), and the backward takes (out, m, inv) as
#: ``saved``
KERNELS = (_launch_fwd, _launch_bwd)


def fused_edge_attention_nk(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    senders: torch.Tensor,
    receivers: torch.Tensor,
    edge_mask: torch.Tensor,
    nk,
) -> torch.Tensor:
    """Edge-masked multi-head attention on the NK slot layout, in bf16.

    q, k, v are bf16 [N, B, H, dh] (heads first, as the JAX package lays
    them out); ``senders``, ``receivers`` [G·K·nb] int32 and ``edge_mask``
    [G·K·nb] bool are the graph's slot arrays (slot g·K·nb + k·nb + r
    belongs to receiver g·nb + r, which ``receivers`` holds on its valid
    slots); ``nk`` is the NKTiling. Returns bf16 [N, B, H, dh]; a
    receiver with no valid slot gets zeros. CPU tensors take
    :func:`fused_edge_attention_nk_reference` (gradient by plain
    autograd); CUDA tensors launch the kernel, counted in
    ``fused_edge_attention_nk.launches``, and under autograd its gradient
    is the backward kernel, counted in
    ``fused_edge_attention_nk.backward_launches``.
    """
    check_inputs(q, k, v, senders, receivers, edge_mask, nk, name="NK layout", row="slot")
    return launch_or_plain(q, k, v, senders, receivers, edge_mask, nk, KERNELS)


fused_edge_attention_nk.launches = 0
fused_edge_attention_nk.backward_launches = 0


def fused_edge_attention_nk_reference(q, k, v, senders, receivers, edge_mask, nk) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_edge_attention_nk`:
    :func:`ops.edge_attention.edge_attention` on the slot arrays (fp32
    logits of exact products, the softmax over each receiver's valid
    slots, the weights rounded to the inputs' dtype). The kernel shifts by
    the receiver's own max, the TPU kernel by one max per tile; the
    softmax is the same up to rounding."""
    return edge_attention(q, k, v, senders, receivers, edge_mask)

