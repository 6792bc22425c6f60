"""Edge attention on the receiver-sorted CSR edge layout, and what both
layouts' attention ops share.

Replaces the TPU Pallas kernels graph_physics_tpu/ops/fused_edge_attention.py:
_fwd_kernel (:124) and _bwd_kernel (:143) behind fused_edge_attention
(:206), with ``world_parts``, the world-edge sidecar's seam. The
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

With ``world_parts`` = (num_w [N, B, H, dh], den_w [N, B, H], s_w
[N, B, H], fp32: ops/edge_attention.world_attention_parts) both kernels
run their world seam (``csrc/ea_fwd.cuh``, ``ea_bwd_passes.cuh``): the
softmax is joint over each receiver's rows and its world pieces, the kept
statistics are the joint ones, and the backward also gives the cotangents
of num_w and den_w (s_w, a shift, takes none). Their plain versions are
:func:`ops.edge_attention.joint_edge_attention`, its autograd and
:func:`softmax_stats` with the pieces.
"""

from __future__ import annotations

import ctypes
import math

import torch
from torch.autograd.function import once_differentiable

from graph_physics_tpu_torch.ops import kernel_build, segment
from graph_physics_tpu_torch.ops.edge_attention import edge_attention, joint_edge_attention
from graph_physics_tpu_torch.ops.tiling import cached_sender_slots

#: head widths the kernels are compiled for (``DH`` template instances):
#: every width dividing JAX's LANES = 128, the widths its gate fuses
KERNEL_HEAD_DIMS = (1, 2, 4, 8, 16, 32, 64, 128)
_vp, _i = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "edge_attention_csr": {"ea_csr_fwd": [_vp] * 13 + [_i] * 4 + [_vp]},
    "edge_attention_csr_bwd": {"ea_csr_bwd": [_vp] * 20 + [_i] * 4 + [_vp]},
}


def _load(name: str):
    return kernel_build.load(name, _ARGTYPES[name])


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def ptrs(*tensors):
    """The tensors' device addresses, None for a tensor that is None."""
    return [None if t is None else t.data_ptr() for t in tensors]


#: head widths up to which the forward under autograd keeps its fp32 output
#: for the backward's s_r without world pieces too (csrc/ea_common.cuh:
#: Head<DH>::FP32_GRAD)
FP32_OUT_UP_TO = 8


def forward_outputs(q, keep_stats, world):
    """The forward kernel's outputs: out (bf16), and with ``keep_stats`` the
    statistics: m and inv (fp32 [N, B, H]), and with the world pieces or up
    to head width ``FP32_OUT_UP_TO`` the fp32 output before rounding (fp32
    [N, B, H, dh]), else None."""
    n, b, h, dh = q.shape
    out = torch.empty_like(q)
    m = inv = out32 = None
    if keep_stats:
        m, inv = (torch.empty((n, b, h), dtype=torch.float32, device=q.device) for _ in range(2))
        if world is not None or dh <= FP32_OUT_UP_TO:
            out32 = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    return out, m, inv, out32


def kept(out, m, inv, out32):
    """The forward's return value with ``keep_stats``: (out, statistics)."""
    return out, (m, inv) if out32 is None else (m, inv, out32)


def _launch_fwd(q, k, v, senders, receivers, edge_mask, csr, keep_stats=False, world=None):
    """The output (bf16), and with ``keep_stats`` the softmax statistics
    (m, inv, and with world pieces the fp32 output before rounding) the
    backward takes, from the forward kernel; ``world``: the world pieces
    (num_w, den_w, s_w) or None."""
    n, b, h, dh = q.shape
    out, m, inv, out32 = forward_outputs(q, keep_stats, world)
    err = _load("edge_attention_csr").ea_csr_fwd(
        *ptrs(q, k, v, out, m, inv, csr.row_ptr_on(q.device), senders, edge_mask,
              *(world or (None,) * 3), out32),
        n, b, h, dh, _stream(q))
    if err != 0:
        raise RuntimeError(f"fused_edge_attention_csr launch failed with CUDA error {err}")
    fused_edge_attention_csr.launches += 1
    return kept(out, m, inv, out32) if keep_stats else out


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


def world_grads(q, world):
    """Empty fp32 dnum_w [N, B, H, dh] and dden_w [N, B, H] for the
    backward kernel's world seam, or (None, None) without world pieces."""
    if world is None:
        return None, None
    return torch.empty(q.shape, dtype=torch.float32, device=q.device), \
        torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)


def _launch_bwd(q, k, v, senders, receivers, edge_mask, csr, g_out, saved, world=None):
    """dq, dk, dv (bf16) from the backward kernels, given ``saved`` = the
    forward's (out, m, inv); with the world pieces ``world`` also dnum_w
    and dden_w (fp32). ``out`` is the fp32 output before rounding where the
    forward kept it (``forward_outputs``)."""
    n, b, h, dh = q.shape
    out, m, inv = saved
    offsets, place, recv = sender_places(senders, receivers, edge_mask, csr)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    dnum_w, dden_w = world_grads(q, world)
    pg = torch.empty((csr.total_rows, b, h), dtype=torch.int32, device=q.device)
    err = _load("edge_attention_csr_bwd").ea_csr_bwd(
        *ptrs(q, k, v, out, m, inv, g_out, csr.row_ptr_on(q.device), senders, edge_mask,
              offsets, place, recv, dq, dk, dv, pg, None if world is None else world[2],
              dnum_w, dden_w),
        n, b, h, dh, _stream(q))
    if err != 0:
        raise RuntimeError(f"fused_edge_attention_csr backward launch failed with CUDA error "
                           f"{err}")
    fused_edge_attention_csr.backward_launches += 1
    return (dq, dk, dv) if world is None else (dq, dk, dv, dnum_w, dden_w)


def softmax_stats(q, k, senders, receivers, edge_mask, world=None):
    """Plain version of the statistics the forward kernel keeps for the
    backward, fp32 [N, B, H] each: ``m``, the max of each receiver's valid
    logits (-inf where it has none), and ``inv`` = 1 / Σ bf16(exp(logit -
    m)) over them (0 where it has none). The logits are
    :func:`ops.edge_attention.edge_attention`'s. With the world pieces
    ``world`` = (num_w, den_w, s_w) they are the joint ones: m = max(mesh
    max, s_w) and the denominator gains den_w · exp(s_w - m)."""
    n, dh = q.shape[0], q.shape[-1]
    logits = (segment.gather_rows(q, receivers).float()
              * segment.gather_rows(k, senders).float()).sum(-1)
    logits = logits * (1.0 / math.sqrt(dh))
    m = segment.segment_max(logits, receivers, n, mask=edge_mask)
    if world is not None:
        m = torch.maximum(m, world[2])
    p = torch.exp(logits - segment.gather_rows(m, receivers)).to(torch.bfloat16).float()
    den = segment.segment_sum(p, receivers, n, mask=edge_mask)
    if world is not None:
        den = den + world[1] * torch.exp(world[2] - m)
    inv = torch.where(den > 0, 1.0 / den, torch.zeros((), device=den.device))
    return m, inv


def _plain_fn(senders, receivers, edge_mask, world):
    """The plain forward on the row arrays as a function of q, k, v (and
    num_w, den_w with world pieces)."""
    if world is None:
        return lambda q, k, v: edge_attention(q, k, v, senders, receivers, edge_mask)
    return lambda q, k, v, num_w, den_w: joint_edge_attention(
        q, k, v, senders, receivers, edge_mask, (num_w, den_w, world[2]))


def _reference_fwd(q, k, v, senders, receivers, edge_mask, csr, keep_stats=False, world=None):
    out = _plain_fn(senders, receivers, edge_mask, world)(q, k, v, *(world or ())[:2])
    if keep_stats:  # the plain backward needs none of the statistics
        return kept(out, *softmax_stats(q, k, senders, receivers, edge_mask, world),
                    None if world is None else out.float())
    return out


def edge_attention_backward_reference(q, k, v, senders, receivers, edge_mask, csr, g_out,
                                      saved=None, world=None):
    """Plain version of the backward kernel: (dq, dk, dv) of Σ out·g_out by
    plain autograd of :func:`ops.edge_attention.edge_attention`, and with
    the world pieces ``world`` (dq, dk, dv, dnum_w, dden_w) of
    :func:`ops.edge_attention.joint_edge_attention`. It takes the forward's
    ``saved`` (out, m, inv) as the kernel does, and needs none of it."""
    with torch.enable_grad():
        inputs = (q, k, v) if world is None else (q, k, v, *world[:2])
        leaves = [t.detach().requires_grad_(True) for t in inputs]
        out = _plain_fn(senders, receivers, edge_mask, world)(*leaves)
        return torch.autograd.grad(out, leaves, g_out)


#: the forward and backward as kernels, and as plain versions: the forward
#: called with ``keep_stats=True`` returns (out, (m, inv)), and the
#: backward takes (out, m, inv) as ``saved``; both take the world pieces
#: as ``world``: the forward's statistics then also hold the fp32 output
#: before rounding, which the backward takes for ``out``, and the backward
#: also returns dnum_w and dden_w; the kernels' forward keeps the fp32
#: output up to head width ``FP32_OUT_UP_TO`` without world pieces too
KERNELS = (_launch_fwd, _launch_bwd)
PLAIN = (_reference_fwd, edge_attention_backward_reference)


def world_kw(world):
    """``world`` as a forward's or backward's keyword argument, none without
    world pieces (so a pair without the world seam serves mesh-only calls)."""
    return {} if world is None else {"world": world}


class _FusedEdgeAttention(torch.autograd.Function):
    """A forward with its backward as the gradient, on either layout: a
    layout's kernels (this module's :data:`KERNELS`, or the NK module's)
    or the plain versions (:data:`PLAIN`), given as the pair ``impl``;
    num_w, den_w, s_w are the world pieces, or None each."""

    @staticmethod
    def forward(ctx, q, k, v, senders, receivers, edge_mask, layout, impl, num_w=None,
                den_w=None, s_w=None):
        world = None if num_w is None else (num_w, den_w, s_w)
        out, (m, inv, *out32) = impl[0](q, k, v, senders, receivers, edge_mask, layout,
                                        keep_stats=True, **world_kw(world))
        ctx.save_for_backward(q, k, v, senders, receivers, edge_mask, *(out32 or [out]), m, inv,
                              *(world or ()))
        ctx.layout, ctx.impl = layout, impl
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g_out):
        q, k, v, senders, receivers, edge_mask, out, m, inv, *world = ctx.saved_tensors
        grads = ctx.impl[1](q, k, v, senders, receivers, edge_mask, ctx.layout,
                            g_out.contiguous(), (out, m, inv), **world_kw(tuple(world) or None))
        return (*grads[:3], None, None, None, None, None, *grads[3:], *(None,) * (
            1 if world else 3))


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


def check_world(q, world_parts):
    """Raises ValueError unless ``world_parts`` is None or (num_w, den_w,
    s_w), contiguous fp32 [N, B, H, dh], [N, B, H], [N, B, H] on q's
    device."""
    if world_parts is None:
        return
    shapes = (tuple(q.shape), tuple(q.shape[:3]), tuple(q.shape[:3]))
    if len(world_parts) != 3 or any(
            tuple(t.shape) != want or t.dtype != torch.float32 or t.device != q.device
            or not t.is_contiguous() for t, want in zip(world_parts, shapes)):
        raise ValueError("world_parts must be contiguous fp32 (num_w [N, B, H, dh], den_w "
                         "[N, B, H], s_w [N, B, H]) on q's device")


def launch_or_plain(q, k, v, senders, receivers, edge_mask, layout, kernels, world_parts=None):
    """The attention on CPU tensors by its plain version, on CUDA tensors
    by ``kernels`` (a layout's forward and backward): the forward alone,
    or under autograd through :class:`_FusedEdgeAttention`; with the world
    pieces ``world_parts``, jointly with them."""
    if q.device.type == "cpu":
        if world_parts is not None:
            return joint_edge_attention(q, k, v, senders, receivers, edge_mask, world_parts)
        return edge_attention(q, k, v, senders, receivers, edge_mask)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    dh = q.shape[-1]
    if dh not in KERNEL_HEAD_DIMS:
        raise NotImplementedError(f"the kernel is built for head widths {KERNEL_HEAD_DIMS}, "
                                  f"got {dh}: a width that JAX's gate does not fuse either "
                                  f"(LANES % head width != 0)")
    world = tuple(world_parts or (None,) * 3)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (q, k, v, *world)):
        return _FusedEdgeAttention.apply(q, k, v, senders, receivers, edge_mask, layout,
                                         kernels, *world)
    return kernels[0](q, k, v, senders, receivers, edge_mask, layout, **world_kw(world_parts))


def fused_edge_attention_csr(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    senders: torch.Tensor,
    receivers: torch.Tensor,
    edge_mask: torch.Tensor,
    csr,
    world_parts=None,
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
    ``fused_edge_attention_csr.backward_launches``. ``world_parts``: the
    world-edge sidecar's pieces (num_w, den_w, s_w) of
    :func:`ops.edge_attention.world_attention_parts`, fp32, joined into
    the softmax (on the CPU :func:`ops.edge_attention.joint_edge_attention`);
    under autograd num_w and den_w get their gradients.
    """
    check_inputs(q, k, v, senders, receivers, edge_mask, csr)
    check_world(q, world_parts)
    return launch_or_plain(q, k, v, senders, receivers, edge_mask, csr, KERNELS, world_parts)


fused_edge_attention_csr.launches = 0
fused_edge_attention_csr.backward_launches = 0


def reference_with_backward(q, k, v, senders, receivers, edge_mask, layout,
                            world_parts=None) -> torch.Tensor:
    """The plain forward with :func:`edge_attention_backward_reference` as
    its gradient, through the same ``torch.autograd.Function`` as the
    kernels, on either layout, with the world pieces ``world_parts`` or
    without."""
    return _FusedEdgeAttention.apply(q, k, v, senders, receivers, edge_mask, layout, PLAIN,
                                     *(world_parts or (None,) * 3))
