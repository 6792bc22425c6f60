"""Fused GraphNetBlock on the receiver-sorted CSR edge layout.

Replaces the TPU Pallas kernels graph_physics_tpu/ops/fused_gnblock.py:
_fwd_kernel (:392) and _bwd_kernel (:453) behind fused_gn_block (:687),
without ``lanes``, ``tiling_idx`` and ``extra_agg`` (the world sidecar,
ROADMAP A 5). Two CUDA kernels: the forward (``csrc/fused_gnblock_csr.cu``)
runs a pre-pass that writes each node's sender partial x @ Ks, then one
thread per (receiver, sample) over the receiver's CSR rows, so graphs of
any degree sum at the receiver with no atomics; the backward
(``csrc/fused_gnblock_csr_bwd.cu``) rematerializes that forward from
(x, e) and the aggregate the forward kept, one thread per (row, sample),
and returns dx, de and fp32 weight gradients, its sender-side sums taken
over the layout's sender-sorted row list. See the sources' headers for
the designs and the bounds.

:func:`fused_gn_block_csr_reference` is the plain PyTorch version,
following blocked_reference (fused_gnblock.py:1109-1191) on the CSR edge
list; its gradient is plain autograd
(:func:`fused_gn_block_csr_backward_reference`). The wrapper uses it for
tensors on the CPU; for CUDA tensors it launches the kernels (the
backward through ``torch.autograd.Function``) or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from graph_physics_tpu_torch.ops import kernel_build
from graph_physics_tpu_torch.ops.fused_gnblock_nk import (
    BACKWARD_LAYERS,
    KERNEL_HIDDEN,
    KERNEL_MAX_LAYERS,
    _check_mlp,
    _mlp_params,
    _mlp_reference,
    _mlp_tensors,
    _pointers,
    backward_buffers,
    mlp_tail_reference,
    rounded_grads,
)
from graph_physics_tpu_torch.ops.tiling import cached_sender_slots

_vp, _i = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "gn_csr_fwd": {"gn_csr_fwd": [_vp] * 9 + [_i] * 4 + [_vp, _i] * 3 + [_vp]},
    "gn_csr_bwd": {"gn_csr_bwd": [_vp] * 17 + [_i] * 4 + [_vp, _vp, _i] * 3 + [_vp]},
}


def _load(name: str):
    return kernel_build.load(name, _ARGTYPES[name])


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_fwd(x, edge_attr, senders, receivers, edge_mask, csr, mlps, last_block,
                keep_agg=False):
    """(x_out, e_out, agg): e_out is ``edge_attr`` on the last block; with
    ``keep_agg`` the kernel also writes the bf16 aggregate [N, B, H] the
    backward kernel reads (else agg is None)."""
    enc, edge, node = mlps
    n, b, h = x.shape
    x_out = torch.empty_like(x)
    e_out = None if last_block else torch.empty((csr.total_rows, b, h), dtype=x.dtype,
                                                device=x.device)
    agg = torch.empty_like(x) if keep_agg else None
    xks = torch.empty_like(x)  # the pre-pass's sender partials
    err = _load("gn_csr_fwd").gn_csr_fwd(
        x.data_ptr(), edge_attr.data_ptr(), xks.data_ptr(), x_out.data_ptr(),
        None if e_out is None else e_out.data_ptr(), None if agg is None else agg.data_ptr(),
        csr.row_ptr_on(x.device).data_ptr(), senders.data_ptr(), edge_mask.data_ptr(), n, b,
        csr.total_rows,
        edge_attr.shape[-1] if enc is not None else 0,
        None if enc is None else _pointers(enc), 0 if enc is None else len(enc.denses),
        _pointers(edge), len(edge.denses), _pointers(node), len(node.denses), _stream(x))
    if err != 0:
        raise RuntimeError(f"fused_gn_block_csr launch failed with CUDA error {err}")
    fused_gn_block_csr.launches += 1
    return x_out, (edge_attr if last_block else e_out), agg


def _launch_bwd(x, edge_attr, agg, g_xout, g_eout, senders, receivers, edge_mask, csr, mlps):
    """dx (bf16), de (bf16, None when the encoder is folded) and the
    parameter gradients (fp32 holding bf16 values, as the plain version's
    bf16 autograd gives them) in ``_mlp_params`` order per MLP. ``agg`` is
    the aggregate the forward kept."""
    n, b, _ = x.shape
    rows = csr.total_rows
    order, offsets = cached_sender_slots(senders, edge_mask, csr)
    dx, de, (xkr, xks, gagg, gh0), grads, ptrs = backward_buffers(x, rows, mlps)
    err = _load("gn_csr_bwd").gn_csr_bwd(
        x.data_ptr(), edge_attr.data_ptr(), agg.data_ptr(), g_xout.data_ptr(),
        None if g_eout is None else g_eout.data_ptr(), dx.data_ptr(),
        None if de is None else de.data_ptr(), xkr.data_ptr(), xks.data_ptr(),
        gagg.data_ptr(), gh0.data_ptr(), csr.row_ptr_on(x.device).data_ptr(),
        senders.data_ptr(), receivers.data_ptr(), edge_mask.data_ptr(), order.data_ptr(),
        offsets.data_ptr(), n, b, rows, edge_attr.shape[-1] if mlps[0] is not None else 0,
        *ptrs, _stream(x))
    if err != 0:
        raise RuntimeError(f"fused_gn_block_csr backward launch failed with CUDA error {err}")
    fused_gn_block_csr.backward_launches += 1
    return dx, de, rounded_grads(grads)


def _reference_fwd(x, edge_attr, senders, receivers, edge_mask, csr, mlps, last_block):
    """:func:`fused_gn_block_csr_reference` in bf16, returned as the kernel
    forward's are (with nothing kept for the backward)."""
    enc, edge, node = mlps
    return (*fused_gn_block_csr_reference(
        x, edge_attr, senders, receivers, edge_mask, edge, node, csr, encoder_params=enc,
        last_block=last_block, compute_dtype=torch.bfloat16), None)


def fused_gn_block_csr_backward_reference(x, edge_attr, agg, g_xout, g_eout, senders, receivers,
                                          edge_mask, csr, mlps):
    """Plain version of the backward kernel: plain bf16 autograd of
    :func:`fused_gn_block_csr_reference` (``agg`` is not used), returned as
    the kernel's are (dx, de or None when the encoder is folded, the
    parameter gradients in ``_mlp_params`` order per MLP)."""
    enc = mlps[0]
    params = [p for m in mlps if m is not None for p in _mlp_params(m)]
    with torch.enable_grad():
        xl = x.detach().requires_grad_(True)
        el = edge_attr.detach().requires_grad_(enc is None)
        x_out, e_out, _ = _reference_fwd(xl, el, senders, receivers, edge_mask, csr, mlps,
                                         g_eout is None)
        outs, cots = ([x_out], [g_xout]) if g_eout is None else ([x_out, e_out], [g_xout, g_eout])
        wrt = [xl] + ([el] if enc is None else []) + params
        grads = torch.autograd.grad(outs, wrt, cots)
    if enc is None:
        return grads[0], grads[1], list(grads[2:])
    return grads[0], None, list(grads[1:])


#: the forward (keeping its aggregate) and backward as kernels, and as
#: plain versions
KERNELS = (functools.partial(_launch_fwd, keep_agg=True), _launch_bwd)
PLAIN = (_reference_fwd, fused_gn_block_csr_backward_reference)


class _FusedGNBlockCSR(torch.autograd.Function):
    """A forward with its backward as the gradient: the kernels
    (:data:`KERNELS`) or the plain versions (:data:`PLAIN`), given as the
    pair ``impl``. The MLPs' parameters are inputs so autograd routes their
    gradients; on the last block only x_out is an output (the edge stream
    passes through outside), so no cotangent of the dead edge stream
    reaches the backward."""

    @staticmethod
    def forward(ctx, x, edge_attr, senders, receivers, edge_mask, csr, mlps, last_block, impl,
                *params):
        x_out, e_out, agg = impl[0](x, edge_attr, senders, receivers, edge_mask, csr, mlps,
                                    last_block)
        ctx.save_for_backward(x, edge_attr, agg, senders, receivers, edge_mask)
        ctx.csr, ctx.mlps, ctx.impl = csr, mlps, impl
        return x_out if last_block else (x_out, e_out)

    @staticmethod
    @once_differentiable
    def backward(ctx, g_xout, g_eout=None):
        x, edge_attr, agg, senders, receivers, edge_mask = ctx.saved_tensors
        dx, de, grads = ctx.impl[1](
            x, edge_attr, agg, g_xout.contiguous(),
            None if g_eout is None else g_eout.contiguous(), senders, receivers, edge_mask,
            ctx.csr, ctx.mlps)
        return (dx, de, None, None, None, None, None, None, None, *grads)


def apply_with_backward(impl, x, edge_attr, senders, receivers, edge_mask, csr, mlps,
                        last_block):
    """The block through :class:`_FusedGNBlockCSR` with ``impl`` (the
    kernels or the plain versions): (x_out, e_out), e_out being
    ``edge_attr`` on the last block."""
    params = [p for m in mlps if m is not None for p in _mlp_params(m)]
    out = _FusedGNBlockCSR.apply(x, edge_attr, senders, receivers, edge_mask, csr, mlps,
                                 last_block, impl, *params)
    return (out, edge_attr) if last_block else out


def fused_gn_block_csr(
    x: torch.Tensor,
    edge_attr: torch.Tensor,
    senders: torch.Tensor,
    receivers: torch.Tensor,
    edge_mask: torch.Tensor,
    edge_params,
    node_params,
    csr,
    *,
    encoder_params=None,
    last_block: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One GraphNetBlock on the CSR layout, in bf16.

    x [N, B, H] and edge_attr [S, B, H] (raw [S, B, fe] when
    ``encoder_params``, the edge encoder MLP, is folded in) are bf16;
    ``senders``, ``receivers`` [S] int32 and ``edge_mask`` [S] bool are the
    graph's row arrays; ``edge_params``/``node_params`` are the block's edge
    and node MLPs (models/layers.MLP); ``csr`` is the CSRLayout. Returns
    (x_out, e_out); on the last block e_out is ``edge_attr`` unchanged.
    CPU tensors take :func:`fused_gn_block_csr_reference` (gradient by
    plain autograd); CUDA tensors launch the forward kernel, counted in
    ``fused_gn_block_csr.launches``, and under autograd its gradient is
    the backward kernel, counted in ``fused_gn_block_csr.backward_launches``.
    """
    n, b, h = x.shape
    rows = csr.total_rows
    fe = edge_attr.shape[-1] if encoder_params is not None else h
    if x.dtype != torch.bfloat16 or edge_attr.dtype != torch.bfloat16:
        raise ValueError(f"bf16 inputs required, got {x.dtype} / {edge_attr.dtype}")
    if n != csr.num_nodes or edge_attr.shape != (rows, b, fe):
        raise ValueError(f"shapes x {tuple(x.shape)}, edge_attr {tuple(edge_attr.shape)} "
                         f"do not match the CSR layout ({csr.num_nodes} nodes, {rows} rows)")
    if any(t.shape != (rows,) for t in (senders, receivers, edge_mask)):
        raise ValueError("senders, receivers and edge_mask must hold one entry per row")
    if senders.dtype != torch.int32 or receivers.dtype != torch.int32 or \
            edge_mask.dtype != torch.bool:
        raise ValueError("senders and receivers must be int32 and edge_mask bool")
    checks = [(edge_params, 3 * h, "edge MLP"), (node_params, 2 * h, "node MLP")]
    if encoder_params is not None:
        checks.append((encoder_params, fe, "edge encoder"))
    for mlp, in_dim, name in checks:
        _check_mlp(mlp, in_dim, h, x.device, name)
    for t in (x, edge_attr, senders, receivers, edge_mask):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("inputs must be contiguous and on one device")

    if x.device.type == "cpu":
        return fused_gn_block_csr_reference(
            x, edge_attr, senders, receivers, edge_mask, edge_params, node_params, csr,
            encoder_params=encoder_params, last_block=last_block, compute_dtype=torch.bfloat16)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    mlps = (encoder_params, edge_params, node_params)
    used = [m for m in mlps if m is not None]
    if h != KERNEL_HIDDEN:
        raise NotImplementedError(f"the kernel is built for hidden {KERNEL_HIDDEN}, got {h}")
    if any(m.activation != "relu" for m in used):
        raise NotImplementedError("the kernel implements relu MLPs only")
    if any(len(m.denses) > KERNEL_MAX_LAYERS for m in used):
        raise NotImplementedError(f"at most {KERNEL_MAX_LAYERS} Dense layers per MLP")
    params = [p for m in used for p in _mlp_params(m)]
    if torch.is_grad_enabled() and any(t.requires_grad for t in [x, edge_attr, *params]):
        if any(len(m.denses) != BACKWARD_LAYERS for m in used):
            raise NotImplementedError(
                f"the backward kernel is built for MLPs of {BACKWARD_LAYERS} Dense layers")
        if encoder_params is not None and fe > h:
            raise NotImplementedError("raw edge features wider than the hidden size")
        return apply_with_backward(KERNELS, x, edge_attr, senders, receivers, edge_mask, csr,
                                   mlps, last_block)
    return _launch_fwd(x, edge_attr, senders, receivers, edge_mask, csr, mlps, last_block)[:2]


fused_gn_block_csr.launches = 0
fused_gn_block_csr.backward_launches = 0


def fused_gn_block_csr_reference(
    x: torch.Tensor,
    edge_attr: torch.Tensor,
    senders: torch.Tensor,
    receivers: torch.Tensor,
    edge_mask: torch.Tensor,
    edge_params,
    node_params,
    csr,
    *,
    encoder_params=None,
    last_block: bool = False,
    compute_dtype=torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`fused_gn_block_csr`, computing in
    ``compute_dtype`` in blocked_reference's order: the edge MLP's first
    layer sums, in fp32, the product e_in @ Ke and the node partials
    x @ Kr and x @ Ks, each computed per node and rounded to
    ``compute_dtype`` before the gather; the messages are masked before
    the fp32 sum at the receiver (``index_add_``). Padding rows keep
    e_out = e_in."""
    cd = compute_dtype
    n, b, h = x.shape
    xc = x.to(cd)
    e_in = edge_attr.to(cd)
    if encoder_params is not None:
        e_in = _mlp_reference(encoder_params, [e_in], cd)
    ws, bs, _ = _mlp_tensors(edge_params)
    k0 = ws[0].to(cd)  # [H, 3H]: the e, receiver and sender parts
    x_kr = F.linear(xc, k0[:, h:2 * h])
    x_ks = F.linear(xc, k0[:, 2 * h:])
    h0 = (F.linear(e_in.float(), k0[:, :h].float()) + x_kr.index_select(0, receivers).float()
          + x_ks.index_select(0, senders).float())
    eh = mlp_tail_reference(edge_params, h0.to(cd) + bs[0].to(cd), cd)
    ehm = torch.where(edge_mask.view(-1, 1, 1), eh, torch.zeros((), dtype=cd, device=x.device))
    agg = torch.zeros((n, b, h), dtype=torch.float32, device=x.device).index_add_(
        0, receivers, ehm.float()).to(cd)
    nh = _mlp_reference(node_params, [xc, agg], cd)
    x_out = (xc + nh).to(x.dtype)
    if last_block:
        return x_out, edge_attr
    return x_out, e_in + ehm
