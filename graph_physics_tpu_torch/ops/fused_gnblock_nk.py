"""Fused GraphNetBlock on the uniform-degree (NK) slot layout.

Replaces the TPU Pallas kernels graph_physics_tpu/ops/fused_gnblock_nk.py:
_nk_fwd_kernel (:147) and _nk_bwd_kernel (:189) behind fused_gn_block_nk
(:332). Two CUDA kernels, both on tensor-core tiles (``csrc/gn_tile.cuh``)
and both sharing their bodies with the CSR layout's kernels, on the NK
row map (``csrc/gn_rows.cuh``). The forward (``csrc/fused_gnblock_nk.cu``,
body ``csrc/gn_fwd.cuh``) runs a node pre-pass, then one warp per
(receiver, 16 samples) over the receiver's K slots, so the K-sum needs no
atomics and the edge messages stay in registers; under autograd it also
keeps its bf16 aggregate. The backward (``csrc/fused_gnblock_nk_bwd.cu``)
runs the CSR backward's passes (``csrc/gn_bwd_passes.cuh``): a node
pre-pass, a node-MLP pass that reads the kept aggregate and a row pass,
both with one warp per (slot or node, 16 samples), and a sender pass over
the layout's sender-sorted slot list, returning dx, de and fp32 weight
gradients with no atomics (the weight gradients are per-block partials
added in block order). Those are the tile kernels, one library for each
hidden width 1 to 32 (below 16 their tiles are zero-padded to the tensor
cores' 16 columns; ``csrc/gn_tile.cuh``).
At hidden 64 and 128 (MeshGraphNets' latent width) the wrapper launches
its width's ``csrc/fused_gnblock_wide_nk.cu`` and
``csrc/fused_gnblock_wide_nk_bwd.cu`` (the passes of
``csrc/gn_wide_fwd.cuh`` and ``gn_wide_bwd.cuh``, one library a width):
every product a Hopper ``wgmma`` over a warpgroup's 64 (row, sample)
pairs with the MLP's packed bf16 weights in shared memory (the wrapper
passes the bytes the packing takes, ``wide_image_buffer``); the weights
no longer fit one block, so each pass holds one MLP, and the backward
writes what the weight gradients contract over to a bf16 scratch and
forms them as products over the rows, summed from partials in a fixed
order (two calls give the same bits). Every MLP takes relu, SiLU or the
exact GELU (``csrc/act_common.cuh``), has 1 to 8 Dense layers (JAX's
``nb_of_layers``) and has its RMSNorm tail or not (``layer_norm``): the
tile backward takes MLPs of another depth than 4 in instances of their
own, and at hidden 128 the wide kernels stream an MLP's layers past what
fits a block's shared memory through two slots. Other widths, and
deeper MLPs, raise. See the sources' headers for the designs. At every
width the kernels take the world seam ``extra_agg`` (_nk_fwd_kernel's
``has_extra_agg``): a node-aligned aggregate added to the rounded one
before the node MLP, whose cotangent the backward returns.

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
from graph_physics_tpu_torch.ops.activation import gelu_kernel_grad, silu
from graph_physics_tpu_torch.ops.segment import gather_rows
from graph_physics_tpu_torch.ops.tiling import cached_sender_slots

#: hidden widths the kernels are built for: every width dividing JAX's
#: LANES = 128, the widths its gate fuses: TILE_HIDDEN and WIDE_HIDDEN
KERNEL_HIDDEN = (1, 2, 4, 8, 16, 32, 64, 128)
#: the widths of ``csrc/fused_gnblock_nk.cu`` and ``fused_gnblock_nk_bwd.cu``
#: (``H`` in their sources, one library a width: hidden 32's without a
#: width in its name, ``kernel_build.GN_SMALL_HIDDENS`` with theirs)
TILE_HIDDEN = (1, 2, 4, 8, 16, 32)
#: the widths of ``csrc/fused_gnblock_wide_nk.cu`` and ``_bwd.cu`` (the
#: passes of ``csrc/gn_wide_fwd.cuh``, ``gn_wide_bwd.cuh``), one library
#: a width
WIDE_HIDDEN = (64, 128)
#: the codes of the MLP activations the kernels take
#: (``csrc/act_common.cuh``: ``mlp_act::Kind``)
ACT_CODES = {"relu": 0, "silu": 1, "gelu": 2}
#: most Dense layers per MLP the kernels take (``MAXL``,
#: ``csrc/gn_nk_common.cuh``)
KERNEL_MAX_LAYERS = 8

_vp, _i = ctypes.c_void_p, ctypes.c_int


def library_name(kind: str, h: int) -> str:
    """The library of a GraphNetBlock kernel (``kind``: gn_nk_fwd, gn_nk_bwd,
    gn_csr_fwd, gn_csr_bwd) at hidden ``h`` (ops/kernel_build.py)."""
    return kind if h == 32 else f"{kind}{h}"


_ARGTYPES = {
    **{library_name("gn_nk_fwd", h): {
        "gn_nk_fwd": [_vp] * 9 + [_i] * 5 + [_vp, _i, _i] * 3 + [_vp]} for h in TILE_HIDDEN},
    **{library_name("gn_nk_bwd", h): {
        "gn_nk_bwd": [_vp] * 15 + [_i] * 5 + [_vp, _vp, _i, _i] * 3 + [_vp]}
       for h in TILE_HIDDEN},
    **{f"gn_nk_fwd{h}": {"gnw_nk_fwd": [_vp] * 12 + [_i] * 5 + [_vp, _i, _i] * 3 + [_vp],
                         "gnw_image_bytes": [_i] * 4, "gnw_hidden": []} for h in WIDE_HIDDEN},
    **{f"gn_nk_bwd{h}": {"gnw_nk_bwd": [_vp] * 14 + [_i] * 5 + [_vp, _vp, _i, _i] * 3 + [_vp],
                         "gnw_bwd_sizes": [_i, _i, _i, ctypes.c_longlong] + [_i] * 4,
                         "gnw_hidden": []} for h in WIDE_HIDDEN},
}


def load_library(name: str, argtypes):
    """kernel_build.load for a GraphNetBlock library of either layout; a
    wide library's ``gnw_bwd_sizes`` and ``gnw_image_bytes`` return 64-bit
    counts, and its ``gnw_hidden`` must be the width its name says."""
    lib = kernel_build.load(name, argtypes[name])
    for fn in ("gnw_bwd_sizes", "gnw_image_bytes"):
        if fn in argtypes[name]:
            getattr(lib, fn).restype = ctypes.c_longlong
    if "gnw_hidden" in argtypes[name]:
        width = int(name[len(name.rstrip("0123456789")):])
        if lib.gnw_hidden() != width:
            raise RuntimeError(f"{name}: built for hidden {lib.gnw_hidden()}, not {width}")
    return lib


def _load(name: str):
    return load_library(name, _ARGTYPES)


def check_kernel_mlps(h: int, mlps, backward: bool, fe: int):
    """Raise NotImplementedError where the kernels of either layout do not
    take the block: a width JAX does not fuse (one not dividing 128; its
    gate sends those to the plain path), an MLP of more than
    ``KERNEL_MAX_LAYERS`` Dense layers (no caller or config builds one),
    raw edge features wider than the hidden size (the backward, and any
    wide kernel). Each MLP goes to the kernels with its own depth (1 to
    8), RMSNorm tail or none, and activation (relu, silu or gelu) by its
    code."""
    used = [m for m in mlps if m is not None]
    if h not in KERNEL_HIDDEN:
        raise NotImplementedError(f"the GraphNetBlock kernels are built for hidden "
                                  f"{KERNEL_HIDDEN}, got {h}")
    if any(len(m.denses) > KERNEL_MAX_LAYERS for m in used):
        raise NotImplementedError(f"the GraphNetBlock kernels take MLPs of 1 to "
                                  f"{KERNEL_MAX_LAYERS} Dense layers, got "
                                  f"{[len(m.denses) for m in used]}")
    if mlps[0] is not None and fe > h and (backward or h not in TILE_HIDDEN):
        raise NotImplementedError("raw edge features wider than the hidden size")


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


def _ptr(t):
    """A tensor's device address, or None (a null pointer) for no tensor."""
    return None if t is None else t.data_ptr()


def mlp_args(mlps):
    """The forward kernels' MLP arguments: pointers, layer count and
    activation code of the encoder (nulls when not folded), the edge and
    the node MLP."""
    out = []
    for m in mlps:
        out += ([None, 0, 0] if m is None
                else [_pointers(m), len(m.denses), ACT_CODES[m.activation]])
    return out


def wide_forward_buffers(x, edge_attr, rows, mlps, last_block):
    """What a wide forward kernel of either layout fills besides x_out and
    e_out: the pre-pass's node partials x @ Kr and x @ Ks, the aggregate
    [N, B, H] (bf16), and, on a folded last block, a [rows, B, H] scratch
    for the encoder's output (else None); and fe (0 when not folded)."""
    b, h = x.shape[1:]
    fold = mlps[0] is not None
    xkr, xks, agg = (torch.empty_like(x) for _ in range(3))
    ein = torch.empty((rows, b, h), dtype=x.dtype, device=x.device) if fold and last_block \
        else None
    return xkr, xks, agg, ein, edge_attr.shape[-1] if fold else 0


def wide_image_buffer(lib, x, fe, mlps):
    """The bytes a wide kernel of either layout (``lib``, its width's
    library) packs the call's MLPs into (``gnw_image_bytes``)."""
    depths = [0 if m is None else len(m.denses) for m in mlps]
    return torch.empty(lib.gnw_image_bytes(fe, *depths), dtype=torch.uint8, device=x.device)


def _launch_fwd(x, edge_attr, senders, edge_mask, nk, mlps, last_block, keep_agg=False,
                extra=None):
    """(x_out, e_out, agg): e_out is None on the last block; with
    ``keep_agg`` the kernel also writes the bf16 aggregate [N, B, H] the
    backward kernel reads (else agg is None). ``extra`` [N, B, H] (bf16,
    or None) joins the aggregate before the node MLP, and the kept
    aggregate is that sum. Hidden 1 to 32 launch their width's
    ``csrc/fused_gnblock_nk.cu``, 64 and 128 theirs of
    ``csrc/fused_gnblock_wide_nk.cu``."""
    n, b, h = x.shape
    x_out = torch.empty_like(x)
    e_out = None if last_block else torch.empty((nk.total_rows, b, h), dtype=x.dtype,
                                                device=x.device)
    if h in WIDE_HIDDEN:
        lib = _load(f"gn_nk_fwd{h}")
        xkr, xks, agg, ein, fe = wide_forward_buffers(x, edge_attr, nk.total_rows, mlps,
                                                      last_block)
        img = wide_image_buffer(lib, x, fe, mlps)
        err = lib.gnw_nk_fwd(
            x.data_ptr(), edge_attr.data_ptr(), xkr.data_ptr(), xks.data_ptr(), _ptr(ein),
            img.data_ptr(), x_out.data_ptr(), _ptr(e_out), agg.data_ptr(), _ptr(extra),
            senders.data_ptr(), edge_mask.data_ptr(), n, b, nk.k_slots, nk.node_block, fe,
            *mlp_args(mlps), _stream(x))
        agg = agg if keep_agg else None
    else:
        agg = torch.empty_like(x) if keep_agg else None
        xks = torch.empty_like(x)  # the pre-pass's sender partials
        err = _load(library_name("gn_nk_fwd", h)).gn_nk_fwd(
            x.data_ptr(), edge_attr.data_ptr(), xks.data_ptr(), x_out.data_ptr(), _ptr(e_out),
            _ptr(agg), _ptr(extra), senders.data_ptr(), edge_mask.data_ptr(), n, b, nk.k_slots,
            nk.node_block, edge_attr.shape[-1] if mlps[0] is not None else 0,
            *mlp_args(mlps), _stream(x))
    if err != 0:
        raise RuntimeError(f"fused_gn_block_nk launch failed with CUDA error {err}")
    fused_gn_block_nk.launches += 1
    return x_out, e_out, agg


def gradient_buffers(mlps):
    """The zeroed fp32 gradients per MLP (None for a missing encoder) and
    the backward kernels' pointer arguments (weights, gradients, layer
    count and activation code of each MLP, nulls for a missing encoder)."""
    grads = [[torch.zeros_like(p, dtype=torch.float32) for p in _mlp_params(m)]
             if m is not None else None for m in mlps]
    ptrs = []
    for m, gs in zip(mlps, grads):
        ptrs += ([None, None, 0, 0] if m is None
                 else [_pointers(m), _pointers(m, gs), len(m.denses), ACT_CODES[m.activation]])
    return grads, ptrs


def backward_buffers(x, rows, mlps):
    """What a tile GraphNetBlock backward kernel (hidden 1 to 32) of either
    layout fills: dx [N, B, H] and de [rows, B, H] (None when the encoder is
    folded), its bf16 scratch (x @ Kr, x @ Ks and g_agg [N, B, H], g_h0
    [rows, B, H]), the zeroed fp32 gradients per MLP and their pointer
    arguments (weights, gradients and layer count of each MLP, nulls for a
    missing encoder)."""
    b, h = x.shape[1:]
    dx, xkr, xks, gagg = (torch.empty_like(x) for _ in range(4))
    de = None if mlps[0] is not None else torch.empty((rows, b, h), dtype=x.dtype,
                                                      device=x.device)
    gh0 = torch.empty((rows, b, h), dtype=x.dtype, device=x.device)
    grads, ptrs = gradient_buffers(mlps)
    return dx, de, (xkr, xks, gagg, gh0), grads, ptrs


def wide_backward_buffers(lib, x, edge_attr, rows, mlps):
    """What a wide backward kernel of either layout (``lib``, its width's
    library) fills: dx, de (None when the encoder is folded), the bf16
    scratch and fp32 partials the library sizes (``gnw_bwd_sizes``), the
    zeroed gradients, their pointer arguments, and fe (0 when not
    folded)."""
    n, b, h = x.shape
    fe = edge_attr.shape[-1] if mlps[0] is not None else 0
    dx = torch.empty_like(x)
    de = None if fe else torch.empty((rows, b, h), dtype=x.dtype, device=x.device)
    depths = [0 if m is None else len(m.denses) for m in (mlps[1], mlps[2], mlps[0])]
    scratch = torch.empty(lib.gnw_bwd_sizes(0, n, b, rows, fe, *depths), dtype=x.dtype,
                          device=x.device)
    part = torch.empty(lib.gnw_bwd_sizes(1, n, b, rows, fe, *depths), dtype=torch.float32,
                       device=x.device)
    grads, ptrs = gradient_buffers(mlps)
    return dx, de, scratch, part, grads, ptrs, fe


def rounded_grads(grads):
    """The kernels' fp32 gradient sums as one list, rounded to bf16 values
    as the plain version's bf16 autograd gives them."""
    return [g.to(torch.bfloat16).float() for gs in grads if gs is not None for g in gs]


def _launch_bwd(x, edge_attr, agg, g_xout, g_eout, senders, edge_mask, nk, mlps, extra=None):
    """dx (bf16), de (bf16, None when the encoder is folded) and the
    parameter gradients (fp32 holding bf16 values) in ``_mlp_params`` order
    per MLP; given the forward's ``extra``, also its cotangent dea (bf16
    [N, B, H], the aggregate's). ``agg`` is the aggregate the forward kept.
    Hidden 1 to 32 launch their width's ``csrc/fused_gnblock_nk_bwd.cu``,
    64 and 128 theirs of ``csrc/fused_gnblock_wide_nk_bwd.cu``."""
    n, b, h = x.shape
    order, offsets = cached_sender_slots(senders, edge_mask, nk)
    if h in WIDE_HIDDEN:
        lib = _load(f"gn_nk_bwd{h}")
        dx, de, scratch, part, grads, ptrs, fe = wide_backward_buffers(
            lib, x, edge_attr, nk.total_rows, mlps)
        dea = None if extra is None else torch.empty_like(x)
        err = lib.gnw_nk_bwd(
            x.data_ptr(), edge_attr.data_ptr(), agg.data_ptr(), g_xout.data_ptr(),
            _ptr(g_eout), dx.data_ptr(), _ptr(de), _ptr(dea), scratch.data_ptr(),
            part.data_ptr(), senders.data_ptr(), edge_mask.data_ptr(), order.data_ptr(),
            offsets.data_ptr(), n, b, nk.k_slots, nk.node_block, fe, *ptrs, _stream(x))
    else:
        dx, de, scratch, grads, ptrs = backward_buffers(x, nk.total_rows, mlps)
        dea = scratch[2]  # the node-MLP pass's g_agg
        err = _load(library_name("gn_nk_bwd", h)).gn_nk_bwd(
            x.data_ptr(), edge_attr.data_ptr(), agg.data_ptr(), g_xout.data_ptr(),
            _ptr(g_eout), dx.data_ptr(), _ptr(de), *[t.data_ptr() for t in scratch],
            senders.data_ptr(), edge_mask.data_ptr(), order.data_ptr(), offsets.data_ptr(), n,
            b, nk.k_slots, nk.node_block, edge_attr.shape[-1] if mlps[0] is not None else 0,
            *ptrs, _stream(x))
    if err != 0:
        raise RuntimeError(f"fused_gn_block_nk backward launch failed with CUDA error {err}")
    fused_gn_block_nk.backward_launches += 1
    grads = rounded_grads(grads)
    return (dx, de, grads) if extra is None else (dx, de, grads, dea)


def extra_kw(extra):
    """The ``extra`` keyword of a forward or backward, or none without an
    extra aggregate: the calls without one are the calls as they were."""
    return {} if extra is None else {"extra": extra}


class _FusedGNBlockNK(torch.autograd.Function):
    """The forward kernel (keeping its aggregate), with the backward kernel
    as its gradient. The MLPs' parameters are inputs so autograd routes
    their gradients, as is the extra aggregate (None without one); on the
    last block only x_out is an output (the edge stream passes through
    outside), so no cotangent of the dead edge stream reaches the kernel."""

    @staticmethod
    def forward(ctx, x, edge_attr, extra, senders, edge_mask, nk, mlps, last_block, *params):
        x_out, e_out, agg = _launch_fwd(x, edge_attr, senders, edge_mask, nk, mlps, last_block,
                                        keep_agg=True, **extra_kw(extra))
        ctx.save_for_backward(x, edge_attr, agg, senders, edge_mask, extra)
        ctx.nk, ctx.mlps = nk, mlps
        return x_out if last_block else (x_out, e_out)

    @staticmethod
    @once_differentiable
    def backward(ctx, g_xout, g_eout=None):
        x, edge_attr, agg, senders, edge_mask, extra = ctx.saved_tensors
        dx, de, grads, *dea = _launch_bwd(
            x, edge_attr, agg, g_xout.contiguous(),
            None if g_eout is None else g_eout.contiguous(), senders, edge_mask, ctx.nk,
            ctx.mlps, **extra_kw(extra))
        return (dx, de, dea[0] if dea else None, None, None, None, None, None, *grads)


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
    extra_agg=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One GraphNetBlock on the NK slot layout, in bf16.

    x [N, B, H] and edge_attr [G·K·nb, B, H] (raw [G·K·nb, B, fe] when
    ``encoder_params``, the edge encoder MLP, is folded in) are bf16;
    ``senders`` [G·K·nb] int32 and ``edge_mask`` [G·K·nb] bool are the
    graph's slot arrays; ``edge_params``/``node_params`` are the block's
    edge and node MLPs (models/layers.MLP); ``nk`` is the NKTiling.
    ``extra_agg`` [N, B, H] bf16, node-aligned (the world edges'
    aggregate), joins the messages' aggregate before the node MLP:
    agg = bf16(bf16(Σ messages) + extra) (fused_gnblock_nk.py:807-808);
    under autograd its cotangent is the aggregate's.
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
    check_extra_agg(extra_agg, x)
    for t in (x, edge_attr, senders, edge_mask):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("inputs must be contiguous and on one device")

    if x.device.type == "cpu":
        return fused_gn_block_nk_reference(
            x, edge_attr, senders, edge_mask, edge_params, node_params, nk,
            encoder_params=encoder_params, last_block=last_block,
            compute_dtype=torch.bfloat16, extra_agg=extra_agg)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    mlps = (encoder_params, edge_params, node_params)
    check_kernel_mlps(h, mlps, False, fe)
    return _run_kernels(x, edge_attr, senders, edge_mask, nk, mlps, last_block, extra_agg)


def check_extra_agg(extra, x):
    """Raise ValueError unless ``extra`` is None or a contiguous bf16
    tensor shaped and placed like ``x``."""
    if extra is not None and (extra.shape != x.shape or extra.dtype != torch.bfloat16
                              or extra.device != x.device or not extra.is_contiguous()):
        raise ValueError(f"extra_agg must be a contiguous bf16 {tuple(x.shape)} tensor on "
                         f"{x.device}, got {extra.dtype} {tuple(extra.shape)} on {extra.device}")


def _run_kernels(x, edge_attr, senders, edge_mask, nk, mlps, last_block, extra=None):
    """The CUDA branch of :func:`fused_gn_block_nk` on checked inputs: the
    forward kernel, through ``_FusedGNBlockNK`` (keeping the aggregate)
    when a gradient is wanted."""
    used = [m for m in mlps if m is not None]
    params = [p for m in used for p in _mlp_params(m)]
    wants = [x, edge_attr, *params] + ([extra] if extra is not None else [])
    if torch.is_grad_enabled() and any(t.requires_grad for t in wants):
        check_kernel_mlps(x.shape[-1], mlps, True, edge_attr.shape[-1])
        out = _FusedGNBlockNK.apply(x, edge_attr, extra, senders, edge_mask, nk, mlps,
                                    last_block, *params)
        return (out, edge_attr) if last_block else out
    x_out, e_out, _ = _launch_fwd(x, edge_attr, senders, edge_mask, nk, mlps, last_block,
                                  **extra_kw(extra))
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


#: the activations of the plain version in bf16, with the Pallas kernels'
#: derivatives (_mlp_bwd's ``g * _act_grad(pre)``)
_KERNEL_ACTS = {"relu": F.relu, "silu": silu, "gelu": gelu_kernel_grad}


def mlp_tail_reference(mlp, h, cd):
    """Layers 1.. of the MLP and its RMSNorm on ``h``, the first Dense's
    output in ``cd``, with :func:`_mlp_reference`'s numerics. In bf16 the
    activations' and the RMSNorm's gradients round where the Pallas
    kernels' _mlp_bwd rounds them (:class:`_RmsTail`)."""
    ws, bs, scale = _mlp_tensors(mlp)
    act = _KERNEL_ACTS[mlp.activation] if cd == torch.bfloat16 else mlp.act_fn
    for w, bias in zip(ws[1:], bs[1:]):
        h = F.linear(act(h), w.to(cd)) + bias.to(cd)
    if scale is not None:
        if cd == torch.bfloat16:
            return _RmsTail.apply(h, scale)
        h, _, _ = _rms_tail(h, scale)
    return h


def _rms_tail(h, scale):
    """_rms_fwd in ``h``'s dtype: (bf16(bf16(h · bf16(inv)) · scale), u =
    bf16(h · bf16(inv)), inv), the statistic from fp32 sums of the squares."""
    cd = h.dtype
    gs = (h * h).float().sum(-1, keepdim=True)
    rms = torch.sqrt(gs + 1e-24) / math.sqrt(h.shape[-1])
    inv = 1.0 / (rms + 1e-8)
    u = h * inv.to(cd)
    return u * scale.to(cd), u, inv


class _RmsTail(torch.autograd.Function):
    """The RMSNorm tail in bf16 with the Pallas kernels' backward (_rms_bwd,
    fused_gnblock.py:201, inline in _mlp_bwd :259-270): d_scale = Σ g·u
    (bf16 products, fp32 sum, rounded to a bf16 value as the bf16
    gradients of the other parameters are), g_u = g·scale, corr =
    bf16(Σ g_u·v · inv² / (H · rms)), dv = g_u·bf16(inv) − v·corr, every
    elementwise step rounded to bf16."""

    @staticmethod
    def forward(ctx, h, scale):
        y, u, inv = _rms_tail(h, scale)
        ctx.save_for_backward(h, u, inv, scale)
        return y

    @staticmethod
    def backward(ctx, g):
        v, u, inv, scale = ctx.saved_tensors
        cd = g.dtype
        d_scale = (g * u).float().reshape(-1, g.shape[-1]).sum(0).to(cd).float()
        g_u = g * scale.to(cd)
        dot = (g_u * v).float().sum(-1, keepdim=True)
        rms = (1.0 / inv - 1e-8).clamp_min(1e-30)
        corr = (dot * (inv * inv) / (g.shape[-1] * rms)).to(cd)
        return g_u * inv.to(cd) - v * corr, d_scale


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
    extra_agg=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`fused_gn_block_nk`, computing in
    ``compute_dtype``: the edge MLP's first layer sums, in fp32, the
    product e_in @ Ke and the node partials x @ Kr and x @ Ks, each
    computed per node and rounded to ``compute_dtype`` (the JAX kernel's
    _edge_fwd order), the receiver's repeated over its K slots and the
    sender's gathered (``segment.gather_rows``); the masked messages are summed
    over K with a reshape, rounded, and ``extra_agg`` added to the rounded
    sum in ``compute_dtype`` (blocked_reference_nk :807-808)."""
    x_out, e_out, _ = _reference_parts(x, edge_attr, senders, edge_mask,
                                       (encoder_params, edge_params, node_params), nk,
                                       compute_dtype, extra_agg)
    return (x_out, edge_attr) if last_block else (x_out, e_out)


def add_extra(agg, extra):
    """The aggregate with the extra one added in its dtype (one rounding of
    the sum), as blocked_reference(_nk) adds it."""
    return agg if extra is None else agg + extra.to(agg.dtype)


def _reference_parts(x, edge_attr, senders, edge_mask, mlps, nk, cd, extra=None):
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
          + gather_rows(x_ks.float(), senders))  # P_s an fp32 sum rounded once
    eh = mlp_tail_reference(edge, h0.to(cd) + bs[0].to(cd), cd)
    ehm = torch.where(edge_mask.view(-1, 1, 1), eh, torch.zeros((), dtype=cd, device=x.device))
    agg = add_extra(ehm.float().view(g, k, nb, b, h).sum(1).reshape(n, b, h).to(cd), extra)
    nh = _mlp_reference(node, [xc, agg], cd)
    x_out = (xc + nh).to(x.dtype)
    return x_out, e_in + ehm, agg


def fused_gn_block_nk_backward_reference(x, edge_attr, agg, g_xout, g_eout, senders, edge_mask,
                                         nk, mlps, extra=None):
    """Plain version of the backward kernel: plain autograd of
    :func:`fused_gn_block_nk_reference` in ``x``'s dtype (``agg`` is not
    used), returned as the kernel's are (dx, de or None when the encoder is
    folded, the parameter gradients in ``_mlp_params`` order per MLP, and
    with ``extra`` its cotangent), as
    :func:`fused_gnblock_csr.fused_gn_block_csr_backward_reference` is for
    the CSR layout."""
    return block_autograd(
        lambda xl, el, xa: _reference_parts(xl, el, senders, edge_mask, mlps, nk, x.dtype, xa),
        x, edge_attr, extra, g_xout, g_eout, mlps)


def block_autograd(fn, x, edge_attr, extra, g_xout, g_eout, mlps):
    """A plain block's backward: autograd of ``fn(x, edge_attr, extra)`` ->
    (x_out, e_out, ...) from the cotangents (g_eout None on the last
    block), returned as the backward kernels return theirs."""
    enc = mlps[0]
    params = [p for m in mlps if m is not None for p in _mlp_params(m)]
    with torch.enable_grad():
        xl = x.detach().requires_grad_(True)
        el = edge_attr.detach().requires_grad_(enc is None)
        xa = None if extra is None else extra.detach().requires_grad_(True)
        x_out, e_out = fn(xl, el, xa)[:2]
        outs, cots = ([x_out], [g_xout]) if g_eout is None else ([x_out, e_out], [g_xout, g_eout])
        wrt = [xl] + ([el] if enc is None else []) + params + ([xa] if xa is not None else [])
        grads = list(torch.autograd.grad(outs, wrt, cots))
    dea = [grads.pop()] if xa is not None else []
    de = grads.pop(1) if enc is None else None
    return (grads[0], de, grads[1:], *dea)
