"""Fused GraphNetBlock on the receiver-sorted CSR edge layout.

Replaces the TPU Pallas kernels graph_physics_tpu/ops/fused_gnblock.py:
_fwd_kernel (:392) and _bwd_kernel (:453) behind fused_gn_block (:687),
with its ``extra_agg`` seam (the world edges' aggregate) and without
``lanes`` and ``tiling_idx``. Two CUDA kernels, every MLP product on tensor-core tiles
(``csrc/gn_tile.cuh``): the forward (``csrc/fused_gnblock_csr.cu``, its
body ``csrc/gn_fwd.cuh`` shared with the NK forward) runs a pre-pass that
writes each node's sender partial x @ Ks, then one warp per (receiver, 16
samples) over the receiver's CSR rows, so graphs of any degree sum at the
receiver with no atomics; the backward
(``csrc/fused_gnblock_csr_bwd.cu``) rematerializes that forward from
(x, e) and the aggregate the forward kept, one warp per (row, 16
samples), and returns dx, de and fp32 weight gradients (per-block
partials added in block order, no atomics), its sender-side sums taken
over the layout's sender-sorted row list. Those are the
tile kernels, one library for each hidden width 1 to 32; at hidden 64
and 128 the wrapper launches its width's
``csrc/fused_gnblock_wide_csr.cu`` and ``_csr_bwd.cu``, the passes the NK
layout's wide kernels run (``fused_gnblock_nk``) on the CSR row map.
Every MLP takes relu, SiLU or the exact GELU; other widths, and MLPs
without their RMSNorm tail or of other depths, raise. See the sources'
headers for the designs and the bounds.

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

from graph_physics_tpu_torch.ops.fused_gnblock_nk import (
    TILE_HIDDEN,
    WIDE_HIDDEN,
    _check_mlp,
    _mlp_params,
    _mlp_reference,
    _mlp_tensors,
    _ptr,
    add_extra,
    backward_buffers,
    block_autograd,
    check_extra_agg,
    check_kernel_mlps,
    extra_kw,
    library_name,
    load_library,
    mlp_args,
    mlp_tail_reference,
    rounded_grads,
    wide_backward_buffers,
    wide_forward_buffers,
    wide_image_buffer,
)
from graph_physics_tpu_torch.ops.segment import gather_rows, scatter_rows
from graph_physics_tpu_torch.ops.tiling import cached_sender_slots

_vp, _i = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    **{library_name("gn_csr_fwd", h): {
        "gn_csr_fwd": [_vp] * 10 + [_i] * 4 + [_vp, _i, _i] * 3 + [_vp]} for h in TILE_HIDDEN},
    **{library_name("gn_csr_bwd", h): {
        "gn_csr_bwd": [_vp] * 17 + [_i] * 4 + [_vp, _vp, _i, _i] * 3 + [_vp]}
       for h in TILE_HIDDEN},
    **{f"gn_csr_fwd{h}": {"gnw_csr_fwd": [_vp] * 13 + [_i] * 4 + [_vp, _i, _i] * 3 + [_vp],
                          "gnw_image_bytes": [_i] * 4, "gnw_hidden": []} for h in WIDE_HIDDEN},
    **{f"gn_csr_bwd{h}": {"gnw_csr_bwd": [_vp] * 16 + [_i] * 4 + [_vp, _vp, _i, _i] * 3 + [_vp],
                          "gnw_bwd_sizes": [_i, _i, _i, ctypes.c_longlong] + [_i] * 4,
                          "gnw_hidden": []} for h in WIDE_HIDDEN},
}


def _load(name: str):
    return load_library(name, _ARGTYPES)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_fwd(x, edge_attr, senders, receivers, edge_mask, csr, mlps, last_block,
                keep_agg=False, extra=None):
    """(x_out, e_out, agg): e_out is ``edge_attr`` on the last block; with
    ``keep_agg`` the kernel also writes the bf16 aggregate [N, B, H] the
    backward kernel reads (else agg is None). ``extra`` [N, B, H] (bf16,
    or None) joins the aggregate before the node MLP, and the kept
    aggregate is that sum. Hidden 1 to 32 launch their width's
    ``csrc/fused_gnblock_csr.cu``, 64 and 128 theirs of
    ``csrc/fused_gnblock_wide_csr.cu``."""
    n, b, h = x.shape
    x_out = torch.empty_like(x)
    e_out = None if last_block else torch.empty((csr.total_rows, b, h), dtype=x.dtype,
                                                device=x.device)
    row_ptr = csr.row_ptr_on(x.device).data_ptr()
    if h in WIDE_HIDDEN:
        lib = _load(f"gn_csr_fwd{h}")
        xkr, xks, agg, ein, fe = wide_forward_buffers(x, edge_attr, csr.total_rows, mlps,
                                                      last_block)
        img = wide_image_buffer(lib, x, fe, mlps)
        err = lib.gnw_csr_fwd(
            x.data_ptr(), edge_attr.data_ptr(), xkr.data_ptr(), xks.data_ptr(), _ptr(ein),
            img.data_ptr(), x_out.data_ptr(), _ptr(e_out), agg.data_ptr(), _ptr(extra), row_ptr,
            senders.data_ptr(),
            edge_mask.data_ptr(), n, b, csr.total_rows, fe, *mlp_args(mlps), _stream(x))
        agg = agg if keep_agg else None
    else:
        agg = torch.empty_like(x) if keep_agg else None
        xks = torch.empty_like(x)  # the pre-pass's sender partials
        err = _load(library_name("gn_csr_fwd", h)).gn_csr_fwd(
            x.data_ptr(), edge_attr.data_ptr(), xks.data_ptr(), x_out.data_ptr(), _ptr(e_out),
            _ptr(agg), _ptr(extra), row_ptr, senders.data_ptr(), edge_mask.data_ptr(), n, b,
            csr.total_rows, edge_attr.shape[-1] if mlps[0] is not None else 0,
            *mlp_args(mlps), _stream(x))
    if err != 0:
        raise RuntimeError(f"fused_gn_block_csr launch failed with CUDA error {err}")
    fused_gn_block_csr.launches += 1
    return x_out, (edge_attr if last_block else e_out), agg


def _launch_bwd(x, edge_attr, agg, g_xout, g_eout, senders, receivers, edge_mask, csr, mlps,
                extra=None):
    """dx (bf16), de (bf16, None when the encoder is folded) and the
    parameter gradients (fp32 holding bf16 values, as the plain version's
    bf16 autograd gives them) in ``_mlp_params`` order per MLP; given the
    forward's ``extra``, also its cotangent dea (bf16 [N, B, H]). ``agg``
    is the aggregate the forward kept. Hidden 1 to 32 launch their width's
    ``csrc/fused_gnblock_csr_bwd.cu``, 64 and 128 theirs of
    ``csrc/fused_gnblock_wide_csr_bwd.cu``."""
    n, b, h = x.shape
    rows = csr.total_rows
    order, offsets = cached_sender_slots(senders, edge_mask, csr)
    row_ptr = csr.row_ptr_on(x.device).data_ptr()
    if h in WIDE_HIDDEN:
        lib = _load(f"gn_csr_bwd{h}")
        dx, de, scratch, part, grads, ptrs, fe = wide_backward_buffers(lib, x, edge_attr, rows,
                                                                       mlps)
        dea = None if extra is None else torch.empty_like(x)
        err = lib.gnw_csr_bwd(
            x.data_ptr(), edge_attr.data_ptr(), agg.data_ptr(), g_xout.data_ptr(),
            _ptr(g_eout), dx.data_ptr(), _ptr(de), _ptr(dea), scratch.data_ptr(),
            part.data_ptr(), row_ptr,
            senders.data_ptr(), receivers.data_ptr(), edge_mask.data_ptr(), order.data_ptr(),
            offsets.data_ptr(), n, b, rows, fe, *ptrs, _stream(x))
    else:
        dx, de, (xkr, xks, gagg, gh0), grads, ptrs = backward_buffers(x, rows, mlps)
        dea = gagg  # the node-MLP pass's g_agg
        err = _load(library_name("gn_csr_bwd", h)).gn_csr_bwd(
            x.data_ptr(), edge_attr.data_ptr(), agg.data_ptr(), g_xout.data_ptr(),
            _ptr(g_eout), dx.data_ptr(), _ptr(de), xkr.data_ptr(), xks.data_ptr(),
            gagg.data_ptr(), gh0.data_ptr(), row_ptr, senders.data_ptr(), receivers.data_ptr(),
            edge_mask.data_ptr(), order.data_ptr(), offsets.data_ptr(), n, b, rows,
            edge_attr.shape[-1] if mlps[0] is not None else 0, *ptrs, _stream(x))
    if err != 0:
        raise RuntimeError(f"fused_gn_block_csr backward launch failed with CUDA error {err}")
    fused_gn_block_csr.backward_launches += 1
    grads = rounded_grads(grads)
    return (dx, de, grads) if extra is None else (dx, de, grads, dea)


def _reference_fwd(x, edge_attr, senders, receivers, edge_mask, csr, mlps, last_block,
                   extra=None):
    """:func:`fused_gn_block_csr_reference` in bf16, returned as the kernel
    forward's are (with nothing kept for the backward)."""
    enc, edge, node = mlps
    return (*fused_gn_block_csr_reference(
        x, edge_attr, senders, receivers, edge_mask, edge, node, csr, encoder_params=enc,
        last_block=last_block, compute_dtype=torch.bfloat16, extra_agg=extra), None)


def fused_gn_block_csr_backward_reference(x, edge_attr, agg, g_xout, g_eout, senders, receivers,
                                          edge_mask, csr, mlps, extra=None):
    """Plain version of the backward kernel: plain bf16 autograd of
    :func:`fused_gn_block_csr_reference` (``agg`` is not used), returned as
    the kernel's are (dx, de or None when the encoder is folded, the
    parameter gradients in ``_mlp_params`` order per MLP, and with
    ``extra`` its cotangent)."""
    return block_autograd(
        lambda xl, el, xa: _reference_fwd(xl, el, senders, receivers, edge_mask, csr, mlps,
                                          g_eout is None, xa),
        x, edge_attr, extra, g_xout, g_eout, mlps)


#: the forward (keeping its aggregate) and backward as kernels, and as
#: plain versions
KERNELS = (functools.partial(_launch_fwd, keep_agg=True), _launch_bwd)
PLAIN = (_reference_fwd, fused_gn_block_csr_backward_reference)


class _FusedGNBlockCSR(torch.autograd.Function):
    """A forward with its backward as the gradient: the kernels
    (:data:`KERNELS`) or the plain versions (:data:`PLAIN`), given as the
    pair ``impl``. The MLPs' parameters are inputs so autograd routes their
    gradients, as is the extra aggregate (None without one); on the last
    block only x_out is an output (the edge stream passes through
    outside), so no cotangent of the dead edge stream reaches the
    backward."""

    @staticmethod
    def forward(ctx, x, edge_attr, extra, senders, receivers, edge_mask, csr, mlps, last_block,
                impl, *params):
        x_out, e_out, agg = impl[0](x, edge_attr, senders, receivers, edge_mask, csr, mlps,
                                    last_block, **extra_kw(extra))
        ctx.save_for_backward(x, edge_attr, agg, senders, receivers, edge_mask, extra)
        ctx.csr, ctx.mlps, ctx.impl = csr, mlps, impl
        return x_out if last_block else (x_out, e_out)

    @staticmethod
    @once_differentiable
    def backward(ctx, g_xout, g_eout=None):
        x, edge_attr, agg, senders, receivers, edge_mask, extra = ctx.saved_tensors
        dx, de, grads, *dea = ctx.impl[1](
            x, edge_attr, agg, g_xout.contiguous(),
            None if g_eout is None else g_eout.contiguous(), senders, receivers, edge_mask,
            ctx.csr, ctx.mlps, **extra_kw(extra))
        return (dx, de, dea[0] if dea else None, None, None, None, None, None, None, None,
                *grads)


def apply_with_backward(impl, x, edge_attr, senders, receivers, edge_mask, csr, mlps,
                        last_block, extra=None):
    """The block through :class:`_FusedGNBlockCSR` with ``impl`` (the
    kernels or the plain versions): (x_out, e_out), e_out being
    ``edge_attr`` on the last block. ``extra``: the extra aggregate, or
    None."""
    params = [p for m in mlps if m is not None for p in _mlp_params(m)]
    out = _FusedGNBlockCSR.apply(x, edge_attr, extra, senders, receivers, edge_mask, csr, mlps,
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
    extra_agg=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One GraphNetBlock on the CSR layout, in bf16.

    x [N, B, H] and edge_attr [S, B, H] (raw [S, B, fe] when
    ``encoder_params``, the edge encoder MLP, is folded in) are bf16;
    ``senders``, ``receivers`` [S] int32 and ``edge_mask`` [S] bool are the
    graph's row arrays; ``edge_params``/``node_params`` are the block's edge
    and node MLPs (models/layers.MLP); ``csr`` is the CSRLayout.
    ``extra_agg`` [N, B, H] bf16, node-aligned, joins the aggregate before
    the node MLP (fused_gnblock.py:1188-1189), as in
    :func:`fused_gnblock_nk.fused_gn_block_nk`. Returns (x_out, e_out); on
    the last block e_out is ``edge_attr`` unchanged.
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
    check_extra_agg(extra_agg, x)
    for t in (x, edge_attr, senders, receivers, edge_mask):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("inputs must be contiguous and on one device")

    if x.device.type == "cpu":
        return fused_gn_block_csr_reference(
            x, edge_attr, senders, receivers, edge_mask, edge_params, node_params, csr,
            encoder_params=encoder_params, last_block=last_block, compute_dtype=torch.bfloat16,
            extra_agg=extra_agg)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    mlps = (encoder_params, edge_params, node_params)
    check_kernel_mlps(h, mlps, False, fe)
    params = [p for m in mlps if m is not None for p in _mlp_params(m)]
    wants = [x, edge_attr, *params] + ([extra_agg] if extra_agg is not None else [])
    if torch.is_grad_enabled() and any(t.requires_grad for t in wants):
        check_kernel_mlps(h, mlps, True, fe)
        return apply_with_backward(KERNELS, x, edge_attr, senders, receivers, edge_mask, csr,
                                   mlps, last_block, extra_agg)
    return _launch_fwd(x, edge_attr, senders, receivers, edge_mask, csr, mlps, last_block,
                       **extra_kw(extra_agg))[:2]


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
    extra_agg=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`fused_gn_block_csr`, computing in
    ``compute_dtype`` in blocked_reference's order: the edge MLP's first
    layer sums, in fp32, the product e_in @ Ke and the node partials
    x @ Kr and x @ Ks, each computed per node and rounded to
    ``compute_dtype`` before the gather; the messages are masked before
    the fp32 sum at the receiver (``segment.scatter_rows``, in a fixed
    order), whose rounded sum takes
    ``extra_agg`` in ``compute_dtype``. Padding rows keep e_out = e_in."""
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
    # gathered in fp32, so the backward's sums at a node (P_r, P_s) are fp32
    # sums rounded once, as the kernels form them
    h0 = (F.linear(e_in.float(), k0[:, :h].float()) + gather_rows(x_kr.float(), receivers)
          + gather_rows(x_ks.float(), senders))
    eh = mlp_tail_reference(edge_params, h0.to(cd) + bs[0].to(cd), cd)
    ehm = torch.where(edge_mask.view(-1, 1, 1), eh, torch.zeros((), dtype=cd, device=x.device))
    agg = add_extra(scatter_rows(ehm.float(), receivers, n).to(cd), extra_agg)
    nh = _mlp_reference(node_params, [xc, agg], cd)
    x_out = (xc + nh).to(x.dtype)
    if last_block:
        return x_out, edge_attr
    return x_out, e_in + ehm
