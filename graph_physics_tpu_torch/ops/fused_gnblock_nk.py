"""Fused GraphNetBlock on the uniform-degree (NK) slot layout.

Replaces the TPU Pallas kernels graph_physics_tpu/ops/fused_gnblock_nk.py:
_nk_fwd_kernel (:147) and _nk_bwd_kernel (:189) behind fused_gn_block_nk
(:332). Two CUDA kernels: the forward (``csrc/fused_gnblock_nk.cu``) runs
one thread per (receiver, sample) over the receiver's K slots, so the
K-sum needs no atomics, the edge messages stay in registers and the MLP
weights sit in shared memory; under autograd it also keeps its bf16
aggregate. The backward (``csrc/fused_gnblock_nk_bwd.cu``) runs the CSR
backward's passes (``csrc/gn_bwd_passes.cuh``) on the NK row map: node
pre-passes, a node-MLP pass that reads the kept aggregate, a row pass
with one thread per (slot, sample) and a sender pass over the layout's
sender-sorted slot list, returning dx, de and fp32 weight gradients with
no atomics on dx or de. Both are bound by fp32 FMA throughput on the CUDA
cores; tensor cores are later work. See the sources' headers for the
designs.

:func:`fused_gn_block_nk_reference` is the plain PyTorch version of the
same function, following blocked_reference_nk (fused_gnblock_nk.py:731),
with the first edge layer in the JAX kernel's order (the node partials
x @ Kr and x @ Ks rounded per node, as the forward kernel and
fused_gnblock.py:blocked_reference round them). Its gradient is plain
autograd, which :func:`fused_gn_block_nk_backward_reference` returns as
the backward kernel returns its gradients. The wrapper uses the plain
forward for tensors on the CPU; for CUDA tensors it launches the kernels
(the backward through ``torch.autograd.Function``) or raises.

Build: ``ops/kernel_build.py`` compiles each source with nvcc into a
shared library with a plain C interface at first use; ctypes loads it.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from graph_physics_tpu_torch.ops import kernel_build
from graph_physics_tpu_torch.ops.tiling import cached_sender_slots

#: hidden width the kernels are compiled for (``H`` in the sources)
KERNEL_HIDDEN = 32
#: most Dense layers per MLP the forward kernel takes (``MAXL``)
KERNEL_MAX_LAYERS = 8
#: Dense layers per MLP the backward kernel is built for (``NL``)
BACKWARD_LAYERS = 4

_vp, _i = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "gn_nk_fwd": {"gn_nk_fwd": [_vp] * 8 + [_i] * 5 + [_vp, _i] * 3 + [_vp]},
    "gn_nk_bwd": {"gn_nk_bwd": [_vp] * 15 + [_i] * 5 + [_vp, _vp, _i] * 3 + [_vp]},
}


def _load(name: str):
    return kernel_build.load(name, _ARGTYPES[name])


def _mlp_tensors(mlp):
    """(weights [out, in], biases, RMSNorm scale or None) of a ported MLP."""
    denses = mlp.denses
    norm = mlp.norm
    return ([d.weight for d in denses], [d.bias for d in denses],
            None if norm is None else norm.scale)


def _mlp_params(mlp):
    """The MLP's parameters in the kernels' order: w0, b0, w1, b1, ..., scale."""
    ws, bs, scale = _mlp_tensors(mlp)
    return [t for pair in zip(ws, bs) for t in pair] + ([scale] if scale is not None else [])


def _check_mlp(mlp, in_dim: int, hidden: int, device, name: str):
    ws, bs, scale = _mlp_tensors(mlp)
    if ws[0].shape[1] != in_dim or any(w.shape[0] != hidden for w in ws):
        raise ValueError(f"{name}: expected Dense layers {in_dim}->{hidden}..., got "
                         f"{[tuple(w.shape) for w in ws]}")
    for t in ws + bs + ([scale] if scale is not None else []):
        if t.device != device:
            raise ValueError(f"{name}: parameters on {t.device}, inputs on {device}")


def _pointers(mlp, tensors=None):
    """ctypes array of the MLP's parameter pointers (or of ``tensors``, laid
    out like them) with a null RMSNorm scale when it has none."""
    tensors = _mlp_params(mlp) if tensors is None else tensors
    for t in tensors:
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("kernel MLP parameters must be contiguous fp32")
    ptrs = [t.data_ptr() for t in tensors] + ([None] if mlp.norm is None else [])
    return (ctypes.c_void_p * len(ptrs))(*ptrs)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_fwd(x, edge_attr, senders, edge_mask, nk, mlps, last_block, keep_agg=False):
    """(x_out, e_out, agg): e_out is None on the last block; with
    ``keep_agg`` the kernel also writes the bf16 aggregate [N, B, H] the
    backward kernel reads (else agg is None)."""
    enc, edge, node = mlps
    n, b, h = x.shape
    x_out = torch.empty_like(x)
    e_out = None if last_block else torch.empty((nk.total_rows, b, h), dtype=x.dtype,
                                                device=x.device)
    agg = torch.empty_like(x) if keep_agg else None
    xks = torch.empty_like(x)  # the pre-pass's sender partials
    err = _load("gn_nk_fwd").gn_nk_fwd(
        x.data_ptr(), edge_attr.data_ptr(), xks.data_ptr(), x_out.data_ptr(),
        None if e_out is None else e_out.data_ptr(), None if agg is None else agg.data_ptr(),
        senders.data_ptr(), edge_mask.data_ptr(), n, b, nk.k_slots, nk.node_block,
        edge_attr.shape[-1] if enc is not None else 0,
        None if enc is None else _pointers(enc), 0 if enc is None else len(enc.denses),
        _pointers(edge), len(edge.denses), _pointers(node), len(node.denses), _stream(x))
    if err != 0:
        raise RuntimeError(f"fused_gn_block_nk launch failed with CUDA error {err}")
    fused_gn_block_nk.launches += 1
    return x_out, e_out, agg


def backward_buffers(x, rows, mlps):
    """What a GraphNetBlock backward kernel of either layout fills: dx
    [N, B, H] and de [rows, B, H] (None when the encoder is folded), its
    bf16 scratch (x @ Kr, x @ Ks and g_agg [N, B, H], g_h0 [rows, B, H]),
    the zeroed fp32 gradients per MLP and their pointer arguments (weights,
    gradients and layer count of each MLP, nulls for a missing encoder)."""
    b, h = x.shape[1:]
    dx, xkr, xks, gagg = (torch.empty_like(x) for _ in range(4))
    de = None if mlps[0] is not None else torch.empty((rows, b, h), dtype=x.dtype,
                                                      device=x.device)
    gh0 = torch.empty((rows, b, h), dtype=x.dtype, device=x.device)
    grads = [[torch.zeros_like(p, dtype=torch.float32) for p in _mlp_params(m)]
             if m is not None else None for m in mlps]
    ptrs = []
    for m, gs in zip(mlps, grads):
        ptrs += ([None, None, 0] if m is None
                 else [_pointers(m), _pointers(m, gs), len(m.denses)])
    return dx, de, (xkr, xks, gagg, gh0), grads, ptrs


def rounded_grads(grads):
    """The kernels' fp32 gradient sums as one list, rounded to bf16 values
    as the plain version's bf16 autograd gives them."""
    return [g.to(torch.bfloat16).float() for gs in grads if gs is not None for g in gs]


def _launch_bwd(x, edge_attr, agg, g_xout, g_eout, senders, edge_mask, nk, mlps):
    """dx (bf16), de (bf16, None when the encoder is folded) and the
    parameter gradients (fp32 holding bf16 values) in ``_mlp_params`` order
    per MLP. ``agg`` is the aggregate the forward kept."""
    n, b, _ = x.shape
    order, offsets = cached_sender_slots(senders, edge_mask, nk)
    dx, de, scratch, grads, ptrs = backward_buffers(x, nk.total_rows, mlps)
    err = _load("gn_nk_bwd").gn_nk_bwd(
        x.data_ptr(), edge_attr.data_ptr(), agg.data_ptr(), g_xout.data_ptr(),
        None if g_eout is None else g_eout.data_ptr(), dx.data_ptr(),
        None if de is None else de.data_ptr(), *[t.data_ptr() for t in scratch],
        senders.data_ptr(), edge_mask.data_ptr(), order.data_ptr(), offsets.data_ptr(), n, b,
        nk.k_slots, nk.node_block, edge_attr.shape[-1] if mlps[0] is not None else 0, *ptrs,
        _stream(x))
    if err != 0:
        raise RuntimeError(f"fused_gn_block_nk backward launch failed with CUDA error {err}")
    fused_gn_block_nk.backward_launches += 1
    return dx, de, rounded_grads(grads)


class _FusedGNBlockNK(torch.autograd.Function):
    """The forward kernel (keeping its aggregate), with the backward kernel
    as its gradient. The MLPs' parameters are inputs so autograd routes
    their gradients; on the last block only x_out is an output (the edge
    stream passes through outside), so no cotangent of the dead edge
    stream reaches the kernel."""

    @staticmethod
    def forward(ctx, x, edge_attr, senders, edge_mask, nk, mlps, last_block, *params):
        x_out, e_out, agg = _launch_fwd(x, edge_attr, senders, edge_mask, nk, mlps, last_block,
                                        keep_agg=True)
        ctx.save_for_backward(x, edge_attr, agg, senders, edge_mask)
        ctx.nk, ctx.mlps = nk, mlps
        return x_out if last_block else (x_out, e_out)

    @staticmethod
    @once_differentiable
    def backward(ctx, g_xout, g_eout=None):
        x, edge_attr, agg, senders, edge_mask = ctx.saved_tensors
        dx, de, grads = _launch_bwd(
            x, edge_attr, agg, g_xout.contiguous(),
            None if g_eout is None else g_eout.contiguous(), senders, edge_mask, ctx.nk,
            ctx.mlps)
        return (dx, de, None, None, None, None, None, *grads)


def fused_gn_block_nk(
    x: torch.Tensor,
    edge_attr: torch.Tensor,
    senders: torch.Tensor,
    edge_mask: torch.Tensor,
    edge_params,
    node_params,
    nk,
    *,
    encoder_params=None,
    last_block: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One GraphNetBlock on the NK slot layout, in bf16.

    x [N, B, H] and edge_attr [G·K·nb, B, H] (raw [G·K·nb, B, fe] when
    ``encoder_params``, the edge encoder MLP, is folded in) are bf16;
    ``senders`` [G·K·nb] int32 and ``edge_mask`` [G·K·nb] bool are the
    graph's slot arrays; ``edge_params``/``node_params`` are the block's
    edge and node MLPs (models/layers.MLP); ``nk`` is the NKTiling.
    Returns (x_out, e_out); on the last block e_out is ``edge_attr``
    unchanged (the edge stream is dead). CPU tensors take
    :func:`fused_gn_block_nk_reference` (gradient by plain autograd); CUDA
    tensors launch the forward kernel, counted in
    ``fused_gn_block_nk.launches``, and under autograd its gradient is the
    backward kernel, counted in ``fused_gn_block_nk.backward_launches``.
    """
    n, b, h = x.shape
    rows = nk.total_rows
    fe = edge_attr.shape[-1] if encoder_params is not None else h
    if x.dtype != torch.bfloat16 or edge_attr.dtype != torch.bfloat16:
        raise ValueError(f"bf16 inputs required, got {x.dtype} / {edge_attr.dtype}")
    if n != nk.num_nodes or edge_attr.shape != (rows, b, fe):
        raise ValueError(f"shapes x {tuple(x.shape)}, edge_attr {tuple(edge_attr.shape)} "
                         f"do not match the NK layout ({nk.num_nodes} nodes, {rows} slots)")
    if senders.shape != (rows,) or edge_mask.shape != (rows,):
        raise ValueError("senders and edge_mask must hold one entry per slot")
    if senders.dtype != torch.int32 or edge_mask.dtype != torch.bool:
        raise ValueError("senders must be int32 and edge_mask bool")
    checks = [(edge_params, 3 * h, "edge MLP"), (node_params, 2 * h, "node MLP")]
    if encoder_params is not None:
        checks.append((encoder_params, fe, "edge encoder"))
    for mlp, in_dim, name in checks:
        _check_mlp(mlp, in_dim, h, x.device, name)
    for t in (x, edge_attr, senders, edge_mask):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("inputs must be contiguous and on one device")

    if x.device.type == "cpu":
        return fused_gn_block_nk_reference(
            x, edge_attr, senders, edge_mask, edge_params, node_params, nk,
            encoder_params=encoder_params, last_block=last_block,
            compute_dtype=torch.bfloat16)
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

    return _run_kernels(x, edge_attr, senders, edge_mask, nk, mlps, last_block)


def _run_kernels(x, edge_attr, senders, edge_mask, nk, mlps, last_block):
    """The CUDA branch of :func:`fused_gn_block_nk` on checked inputs: the
    forward kernel, through ``_FusedGNBlockNK`` (keeping the aggregate)
    when a gradient is wanted."""
    used = [m for m in mlps if m is not None]
    params = [p for m in used for p in _mlp_params(m)]
    if torch.is_grad_enabled() and any(t.requires_grad for t in [x, edge_attr, *params]):
        if any(len(m.denses) != BACKWARD_LAYERS for m in used):
            raise NotImplementedError(
                f"the backward kernel is built for MLPs of {BACKWARD_LAYERS} Dense layers")
        if mlps[0] is not None and edge_attr.shape[-1] > x.shape[-1]:
            raise NotImplementedError("raw edge features wider than the hidden size")
        out = _FusedGNBlockNK.apply(x, edge_attr, senders, edge_mask, nk, mlps, last_block,
                                    *params)
        return (out, edge_attr) if last_block else out
    x_out, e_out, _ = _launch_fwd(x, edge_attr, senders, edge_mask, nk, mlps, last_block)
    return x_out, (edge_attr if last_block else e_out)


fused_gn_block_nk.launches = 0
fused_gn_block_nk.backward_launches = 0


def _mlp_reference(mlp, parts, cd):
    """The kernel's MLP numerics in plain PyTorch: one product over the
    concatenated inputs per Dense, rounded to ``cd`` before and after the
    bias; fp32 RMS statistics of ``cd`` squares (fused_gnblock.py:_mlp_fwd,
    _rms_fwd)."""
    ws, bs, _ = _mlp_tensors(mlp)
    h = torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]
    return mlp_tail_reference(mlp, F.linear(h, ws[0].to(cd)) + bs[0].to(cd), cd)


def mlp_tail_reference(mlp, h, cd):
    """Layers 1.. of the MLP and its RMSNorm on ``h``, the first Dense's
    output in ``cd``, with :func:`_mlp_reference`'s numerics."""
    ws, bs, scale = _mlp_tensors(mlp)
    for w, bias in zip(ws[1:], bs[1:]):
        h = F.linear(mlp.act_fn(h), w.to(cd)) + bias.to(cd)
    if scale is not None:
        gs = (h * h).float().sum(-1, keepdim=True)
        rms = torch.sqrt(gs + 1e-24) / math.sqrt(h.shape[-1])
        inv = 1.0 / (rms + 1e-8)
        h = h * inv.to(cd) * scale.to(cd)
    return h


def fused_gn_block_nk_reference(
    x: torch.Tensor,
    edge_attr: torch.Tensor,
    senders: torch.Tensor,
    edge_mask: torch.Tensor,
    edge_params,
    node_params,
    nk,
    *,
    encoder_params=None,
    last_block: bool = False,
    compute_dtype=torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`fused_gn_block_nk`, computing in
    ``compute_dtype``: the edge MLP's first layer sums, in fp32, the
    product e_in @ Ke and the node partials x @ Kr and x @ Ks, each
    computed per node and rounded to ``compute_dtype`` (the JAX kernel's
    _edge_fwd order), the receiver's repeated over its K slots and the
    sender's gathered with ``index_select``; the masked messages are summed
    over K with a reshape."""
    x_out, e_out, _ = _reference_parts(x, edge_attr, senders, edge_mask,
                                       (encoder_params, edge_params, node_params), nk,
                                       compute_dtype)
    return (x_out, edge_attr) if last_block else (x_out, e_out)


def _reference_parts(x, edge_attr, senders, edge_mask, mlps, nk, cd):
    """(x_out, e_out, agg) of :func:`fused_gn_block_nk_reference`."""
    enc, edge, node = mlps
    n, b, h = x.shape
    g, k, nb = nk.num_groups, nk.k_slots, nk.node_block
    xc = x.to(cd)
    e_in = edge_attr.to(cd)
    if enc is not None:
        e_in = _mlp_reference(enc, [e_in], cd)
    ws, bs, _ = _mlp_tensors(edge)
    k0 = ws[0].to(cd)  # [H, 3H]: the e, receiver and sender parts
    x_kr = F.linear(xc, k0[:, h:2 * h])
    x_ks = F.linear(xc, k0[:, 2 * h:])
    h0 = (F.linear(e_in.float(), k0[:, :h].float())
          + x_kr.view(g, 1, nb, b, h).expand(g, k, nb, b, h).reshape(-1, b, h).float()
          + x_ks.index_select(0, senders).float())
    eh = mlp_tail_reference(edge, h0.to(cd) + bs[0].to(cd), cd)
    ehm = torch.where(edge_mask.view(-1, 1, 1), eh, torch.zeros((), dtype=cd, device=x.device))
    agg = ehm.float().view(g, k, nb, b, h).sum(1).reshape(n, b, h).to(cd)
    nh = _mlp_reference(node, [xc, agg], cd)
    x_out = (xc + nh).to(x.dtype)
    return x_out, e_in + ehm, agg


def fused_gn_block_nk_backward_reference(x, edge_attr, agg, g_xout, g_eout, senders, edge_mask,
                                         nk, mlps):
    """Plain version of the backward kernel: plain autograd of
    :func:`fused_gn_block_nk_reference` in ``x``'s dtype (``agg`` is not
    used), returned as the kernel's are (dx, de or None when the encoder is
    folded, the parameter gradients in ``_mlp_params`` order per MLP), as
    :func:`fused_gnblock_csr.fused_gn_block_csr_backward_reference` is for
    the CSR layout."""
    enc = mlps[0]
    params = [p for m in mlps if m is not None for p in _mlp_params(m)]
    with torch.enable_grad():
        xl = x.detach().requires_grad_(True)
        el = edge_attr.detach().requires_grad_(enc is None)
        x_out, e_out, _ = _reference_parts(xl, el, senders, edge_mask, mlps, nk, x.dtype)
        outs, cots = ([x_out], [g_xout]) if g_eout is None else ([x_out, e_out], [g_xout, g_eout])
        wrt = [xl] + ([el] if enc is None else []) + params
        grads = torch.autograd.grad(outs, wrt, cots)
    if enc is None:
        return grads[0], grads[1], list(grads[2:])
    return grads[0], None, list(grads[1:])
