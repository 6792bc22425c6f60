"""Edge attention on the uniform-degree (NK) slot layout.

Replaces the TPU Pallas kernels graph_physics_tpu/ops/fused_edge_attention_nk.py:
_nk_fwd_kernel (:476, body _nk_common :437) and _nk_bwd_kernel (:495)
behind fused_edge_attention_nk (:545), with ``world_parts``, the
world-edge sidecar's seam (its forward :455-466, its backward :535-542;
the CSR module states the contract).
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
from graph_physics_tpu_torch.ops.edge_attention import edge_attention, joint_edge_attention
# KERNEL_HEAD_DIMS, PLAIN and reference_with_backward serve both layouts
from graph_physics_tpu_torch.ops.fused_edge_attention_csr import (  # noqa: F401
    KERNEL_HEAD_DIMS,
    PLAIN,
    check_inputs,
    check_world,
    forward_outputs,
    kept,
    launch_or_plain,
    ptrs,
    reference_with_backward,
    sender_places,
    world_grads,
)

_vp, _i = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "edge_attention_nk": {"ea_nk_fwd": [_vp] * 12 + [_i] * 6 + [_vp]},
    "edge_attention_nk_bwd": {"ea_nk_bwd": [_vp] * 19 + [_i] * 6 + [_vp]},
}


def _load(name: str):
    return kernel_build.load(name, _ARGTYPES[name])


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_fwd(q, k, v, senders, receivers, edge_mask, nk, keep_stats=False, world=None):
    """The output (bf16), and with ``keep_stats`` the softmax statistics
    (m, inv, and with world pieces the fp32 output before rounding) the
    backward takes, from the forward kernel; ``world``: the world pieces
    (num_w, den_w, s_w) or None."""
    n, b, h, dh = q.shape
    out, m, inv, out32 = forward_outputs(q, keep_stats, world)
    err = _load("edge_attention_nk").ea_nk_fwd(
        *ptrs(q, k, v, out, m, inv, senders, edge_mask, *(world or (None,) * 3), out32),
        n, b, h, dh, nk.k_slots, nk.node_block, _stream(q))
    if err != 0:
        raise RuntimeError(f"fused_edge_attention_nk launch failed with CUDA error {err}")
    fused_edge_attention_nk.launches += 1
    return kept(out, m, inv, out32) if keep_stats else out


def _launch_bwd(q, k, v, senders, receivers, edge_mask, nk, g_out, saved, world=None):
    """dq, dk, dv (bf16) from the backward kernels, given ``saved`` = the
    forward's (out, m, inv); with the world pieces ``world`` also dnum_w
    and dden_w (fp32), ``out`` then the fp32 output before rounding."""
    n, b, h, dh = q.shape
    out, m, inv = saved
    offsets, place, recv = sender_places(senders, receivers, edge_mask, nk)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    dnum_w, dden_w = world_grads(q, world)
    pg = torch.empty((nk.total_rows, b, h), dtype=torch.int32, device=q.device)
    err = _load("edge_attention_nk_bwd").ea_nk_bwd(
        *ptrs(q, k, v, out, m, inv, g_out, senders, edge_mask, offsets, place, recv, dq, dk,
              dv, pg, None if world is None else world[2], dnum_w, dden_w),
        n, b, h, dh, nk.k_slots, nk.node_block, _stream(q))
    if err != 0:
        raise RuntimeError(f"fused_edge_attention_nk backward launch failed with CUDA error {err}")
    fused_edge_attention_nk.backward_launches += 1
    return (dq, dk, dv) if world is None else (dq, dk, dv, dnum_w, dden_w)


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
    world_parts=None,
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
    ``fused_edge_attention_nk.backward_launches``. ``world_parts``: the
    world-edge sidecar's pieces (num_w, den_w, s_w), as
    :func:`ops.fused_edge_attention_csr.fused_edge_attention_csr` takes
    them.
    """
    check_inputs(q, k, v, senders, receivers, edge_mask, nk, name="NK layout", row="slot")
    check_world(q, world_parts)
    return launch_or_plain(q, k, v, senders, receivers, edge_mask, nk, KERNELS, world_parts)


fused_edge_attention_nk.launches = 0
fused_edge_attention_nk.backward_launches = 0


def fused_edge_attention_nk_reference(q, k, v, senders, receivers, edge_mask, nk,
                                      world_parts=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_edge_attention_nk`:
    :func:`ops.edge_attention.edge_attention` on the slot arrays (fp32
    logits of exact products, the softmax over each receiver's valid
    slots, the weights rounded to the inputs' dtype), or with the world
    pieces :func:`ops.edge_attention.joint_edge_attention`. The kernel
    shifts by the receiver's own max, the TPU kernel by one max per tile;
    the softmax is the same up to rounding."""
    if world_parts is not None:
        return joint_edge_attention(q, k, v, senders, receivers, edge_mask, world_parts)
    return edge_attention(q, k, v, senders, receivers, edge_mask)

