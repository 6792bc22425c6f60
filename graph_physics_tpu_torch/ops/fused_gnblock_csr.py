"""Fused GraphNetBlock on the receiver-sorted CSR edge layout.

Replaces the TPU Pallas kernel graph_physics_tpu/ops/fused_gnblock.py:
_fwd_kernel (:392) behind fused_gn_block (:687), without ``lanes``,
``tiling_idx`` and ``extra_agg`` (the world sidecar, ROADMAP A 11). The
CUDA kernel (``csrc/fused_gnblock_csr.cu``) runs a pre-pass that writes
each node's sender partial x @ Ks, then one thread per (receiver, sample)
over the receiver's CSR rows, so graphs of any degree sum at the receiver
with no atomics. See the source's header for the design and the bound.

:func:`fused_gn_block_csr_reference` is the plain PyTorch version,
following blocked_reference (fused_gnblock.py:1109-1191) on the CSR edge
list. The wrapper uses it for tensors on the CPU; for CUDA tensors it
launches the kernel or raises. There is no backward kernel yet, so on a
CUDA tensor that needs a gradient the wrapper raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from graph_physics_tpu_torch.ops import kernel_build
from graph_physics_tpu_torch.ops.fused_gnblock_nk import (
    KERNEL_HIDDEN,
    KERNEL_MAX_LAYERS,
    _check_mlp,
    _mlp_params,
    _mlp_reference,
    _mlp_tensors,
    _pointers,
    mlp_tail_reference,
)

_vp, _i = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {"gn_csr_fwd": [_vp] * 8 + [_i] * 4 + [_vp, _i] * 3 + [_vp]}


def _launch(x, edge_attr, senders, edge_mask, csr, mlps, last_block):
    enc, edge, node = mlps
    n, b, h = x.shape
    x_out = torch.empty_like(x)
    e_out = None if last_block else torch.empty((csr.total_rows, b, h), dtype=x.dtype,
                                                device=x.device)
    xks = torch.empty_like(x)  # the pre-pass's sender partials
    err = kernel_build.load("gn_csr_fwd", _ARGTYPES).gn_csr_fwd(
        x.data_ptr(), edge_attr.data_ptr(), xks.data_ptr(), x_out.data_ptr(),
        None if e_out is None else e_out.data_ptr(), csr.row_ptr_on(x.device).data_ptr(),
        senders.data_ptr(), edge_mask.data_ptr(), n, b, csr.total_rows,
        edge_attr.shape[-1] if enc is not None else 0,
        None if enc is None else _pointers(enc), 0 if enc is None else len(enc.denses),
        _pointers(edge), len(edge.denses), _pointers(node), len(node.denses),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_gn_block_csr launch failed with CUDA error {err}")
    fused_gn_block_csr.launches += 1
    return x_out, (edge_attr if last_block else e_out)


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
    CPU tensors take :func:`fused_gn_block_csr_reference`; CUDA tensors
    launch the kernel, counted in ``fused_gn_block_csr.launches``.
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
        raise NotImplementedError("the CSR GraphNetBlock has no backward kernel yet: call it "
                                  "under torch.no_grad() or inference_mode()")
    return _launch(x, edge_attr, senders, edge_mask, csr, mlps, last_block)


fused_gn_block_csr.launches = 0


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
