"""Edge attention on the receiver-sorted CSR edge layout, and what both
layouts' attention ops share.

Replaces the TPU Pallas kernels graph_physics_tpu/ops/fused_edge_attention.py:
_fwd_kernel (:124) and _bwd_kernel (:143) behind fused_edge_attention
(:206), without ``world_parts`` (the world sidecar, ROADMAP A 5). The
forward CUDA kernel (``csrc/fused_edge_attention_csr.cu``) walks each
receiver's CSR rows once, a warp per receiver walking its groups of
samples and heads, with an online softmax across chunks of rows, so the
degree has no cap; under autograd it also keeps the softmax statistics
(the max and 1 / the denominator, fp32 [N, B, H]). The backward
(``csrc/fused_edge_attention_csr_bwd.cu``) takes them and the forward's
output, walks each receiver's rows once for dq, and sums dk and dv at each
sender over the layout's sender-sorted rows (:func:`sender_places`), with
no atomics. Both are the bodies of ``csrc/ea_fwd.cuh`` and
``csrc/ea_bwd_passes.cuh`` on the CSR row map; the NK kernels
(``ops/fused_edge_attention_nk``) are the same bodies on the NK row map,
and share this module's plain versions, statistics, transpose and
``torch.autograd.Function``. See the sources' headers for the designs and
the bounds.

The plain version is :func:`ops.edge_attention.edge_attention` on the
graph's row arrays (each row with its receiver), and its gradient plain
autograd (:func:`edge_attention_backward_reference`); :func:`softmax_stats`
is the plain version of the kept statistics. The wrapper uses them for
tensors on the CPU; for CUDA tensors it launches the kernels (the backward
through ``torch.autograd.Function``) or raises.
"""

from __future__ import annotations

import ctypes
import math

import torch
from torch.autograd.function import once_differentiable

from graph_physics_tpu_torch.ops import kernel_build, segment
from graph_physics_tpu_torch.ops.edge_attention import edge_attention
from graph_physics_tpu_torch.ops.tiling import cached_sender_slots

#: head widths the kernels are compiled for (``DH`` template instances):
#: the canonical configs' hidden 64 and 128 over 4 heads
KERNEL_HEAD_DIMS = (16, 32)
_vp, _i = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "edge_attention_csr": {"ea_csr_fwd": [_vp] * 9 + [_i] * 4 + [_vp]},
    "edge_attention_csr_bwd": {"ea_csr_bwd": [_vp] * 17 + [_i] * 4 + [_vp]},
}


def _load(name: str):
    return kernel_build.load(name, _ARGTYPES[name])


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_fwd(q, k, v, senders, receivers, edge_mask, csr, keep_stats=False):
    """The output (bf16), and with ``keep_stats`` the softmax statistics
    (m, inv) the backward takes, from the forward kernel."""
    n, b, h, dh = q.shape
    out = torch.empty_like(q)
    m = inv = None
    if keep_stats:
        m, inv = (torch.empty((n, b, h), dtype=torch.float32, device=q.device) for _ in range(2))
    err = _load("edge_attention_csr").ea_csr_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        m.data_ptr() if keep_stats else None, inv.data_ptr() if keep_stats else None,
        csr.row_ptr_on(q.device).data_ptr(), senders.data_ptr(), edge_mask.data_ptr(),
        n, b, h, dh, _stream(q))
    if err != 0:
        raise RuntimeError(f"fused_edge_attention_csr launch failed with CUDA error {err}")
    fused_edge_attention_csr.launches += 1
    return (out, (m, inv)) if keep_stats else out


def sender_places(senders, receivers, edge_mask, layout):
    """The transpose of a layout's rows (CSR rows or NK slots) as the
    backward's sender pass walks it: (offsets, place, recv), int32, where
    node j sends on the places ``offsets[j]:offsets[j+1]`` (the valid rows
    sorted by sender, :func:`ops.tiling.cached_sender_slots`), ``place[s]``
    is row s's place and ``recv[i]`` the receiver of the row at place i.
    Kept on the layout beside the transpose it is built from, for the same
    arrays."""
    order, offsets = cached_sender_slots(senders, edge_mask, layout)
    hit = layout.derived.get("sender_places")
    if hit is None or hit[0] is not order or hit[1] is not receivers or \
            hit[2] != receivers._version:
        rows = order.long()
        place = torch.empty_like(order)
        place[rows] = torch.arange(rows.numel(), dtype=order.dtype, device=order.device)
        hit = (order, receivers, receivers._version,
               (offsets, place, receivers.index_select(0, rows)))
        layout.derived["sender_places"] = hit
    return hit[3]


def _launch_bwd(q, k, v, senders, receivers, edge_mask, csr, g_out, saved):
    """dq, dk, dv (bf16) from the backward kernels, given ``saved`` = the
    forward's (out, m, inv)."""
    n, b, h, dh = q.shape
    out, m, inv = saved
    offsets, place, recv = sender_places(senders, receivers, edge_mask, csr)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    pg = torch.empty((csr.total_rows, b, h), dtype=torch.int32, device=q.device)
    err = _load("edge_attention_csr_bwd").ea_csr_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), m.data_ptr(),
        inv.data_ptr(), g_out.data_ptr(), csr.row_ptr_on(q.device).data_ptr(),
        senders.data_ptr(), edge_mask.data_ptr(), offsets.data_ptr(), place.data_ptr(),
        recv.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), pg.data_ptr(),
        n, b, h, dh, _stream(q))
    if err != 0:
        raise RuntimeError(f"fused_edge_attention_csr backward launch failed with CUDA error "
                           f"{err}")
    fused_edge_attention_csr.backward_launches += 1
    return dq, dk, dv


def softmax_stats(q, k, senders, receivers, edge_mask):
    """Plain version of the statistics the forward kernel keeps for the
    backward, fp32 [N, B, H] each: ``m``, the max of each receiver's valid
    logits (-inf where it has none), and ``inv`` = 1 / Σ bf16(exp(logit -
    m)) over them (0 where it has none). The logits are
    :func:`ops.edge_attention.edge_attention`'s."""
    n, dh = q.shape[0], q.shape[-1]
    logits = (q.index_select(0, receivers).float() * k.index_select(0, senders).float()).sum(-1)
    logits = logits * (1.0 / math.sqrt(dh))
    m = segment.segment_max(logits, receivers, n, mask=edge_mask)
    p = torch.exp(logits - m.index_select(0, receivers)).to(torch.bfloat16).float()
    den = segment.segment_sum(p, receivers, n, mask=edge_mask)
    inv = torch.where(den > 0, 1.0 / den, torch.zeros((), device=den.device))
    return m, inv


def _reference_fwd(q, k, v, senders, receivers, edge_mask, csr, keep_stats=False):
    out = edge_attention(q, k, v, senders, receivers, edge_mask)
    if keep_stats:
        return out, softmax_stats(q, k, senders, receivers, edge_mask)
    return out


def edge_attention_backward_reference(q, k, v, senders, receivers, edge_mask, csr, g_out,
                                      saved=None):
    """Plain version of the backward kernel: (dq, dk, dv) of Σ out·g_out by
    plain autograd of :func:`ops.edge_attention.edge_attention`. It takes
    the forward's ``saved`` (out, m, inv) as the kernel does, and needs
    none of it."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = edge_attention(*leaves, senders, receivers, edge_mask)
        return torch.autograd.grad(out, leaves, g_out)


#: the forward and backward as kernels, and as plain versions: the forward
#: called with ``keep_stats=True`` returns (out, (m, inv)), and the
#: backward takes (out, m, inv) as ``saved``
KERNELS = (_launch_fwd, _launch_bwd)
PLAIN = (_reference_fwd, edge_attention_backward_reference)


class _FusedEdgeAttention(torch.autograd.Function):
    """A forward with its backward as the gradient, on either layout: a
    layout's kernels (this module's :data:`KERNELS`, or the NK module's)
    or the plain versions (:data:`PLAIN`), given as the pair ``impl``."""

    @staticmethod
    def forward(ctx, q, k, v, senders, receivers, edge_mask, layout, impl):
        out, stats = impl[0](q, k, v, senders, receivers, edge_mask, layout, keep_stats=True)
        ctx.save_for_backward(q, k, v, senders, receivers, edge_mask, out, *stats)
        ctx.layout, ctx.impl = layout, impl
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g_out):
        q, k, v, senders, receivers, edge_mask, *saved = ctx.saved_tensors
        dq, dk, dv = ctx.impl[1](q, k, v, senders, receivers, edge_mask, ctx.layout,
                                 g_out.contiguous(), saved)
        return dq, dk, dv, None, None, None, None, None


def check_inputs(q, k, v, senders, receivers, edge_mask, layout, name="CSR layout", row="row"):
    """Raises ValueError unless q, k, v are contiguous bf16 [N, B, H, dh] of
    one shape on the layout's N nodes and the row arrays hold one entry per
    ``row`` of the layout ``name``, int32 (bool mask), all on one device."""
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must be packed [N, B, H, dh] of one shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise ValueError(f"bf16 q, k, v required, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.shape[0] != layout.num_nodes:
        raise ValueError(f"{q.shape[0]} nodes do not match the {name}'s {layout.num_nodes}")
    if any(t.shape != (layout.total_rows,) for t in (senders, receivers, edge_mask)):
        raise ValueError(f"senders, receivers and edge_mask must hold one entry per {row}")
    if senders.dtype != torch.int32 or receivers.dtype != torch.int32 or \
            edge_mask.dtype != torch.bool:
        raise ValueError("senders and receivers must be int32 and edge_mask bool")
    for t in (q, k, v, senders, receivers, edge_mask):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("inputs must be contiguous and on one device")


def launch_or_plain(q, k, v, senders, receivers, edge_mask, layout, kernels):
    """The attention on CPU tensors by its plain version, on CUDA tensors
    by ``kernels`` (a layout's forward and backward): the forward alone,
    or under autograd through :class:`_FusedEdgeAttention`."""
    if q.device.type == "cpu":
        return edge_attention(q, k, v, senders, receivers, edge_mask)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    dh = q.shape[-1]
    if dh not in KERNEL_HEAD_DIMS:
        raise NotImplementedError(f"the kernel is built for head widths {KERNEL_HEAD_DIMS}, "
                                  f"got {dh}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FusedEdgeAttention.apply(q, k, v, senders, receivers, edge_mask, layout,
                                         kernels)
    return kernels[0](q, k, v, senders, receivers, edge_mask, layout)


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
    check_inputs(q, k, v, senders, receivers, edge_mask, csr)
    return launch_or_plain(q, k, v, senders, receivers, edge_mask, csr, KERNELS)


fused_edge_attention_csr.launches = 0
fused_edge_attention_csr.backward_launches = 0


def reference_with_backward(q, k, v, senders, receivers, edge_mask, layout) -> torch.Tensor:
    """The plain forward with :func:`edge_attention_backward_reference` as
    its gradient, through the same ``torch.autograd.Function`` as the
    kernels, on either layout."""
    return _FusedEdgeAttention.apply(q, k, v, senders, receivers, edge_mask, layout, PLAIN)
