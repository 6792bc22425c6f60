"""Fused GraphNetBlock on the uniform-degree (NK) slot layout.

Replaces the TPU Pallas kernels graph_physics_tpu/ops/fused_gnblock_nk.py:
_nk_fwd_kernel (:147) and _nk_bwd_kernel (:189) behind fused_gn_block_nk
(:332). Two CUDA kernels: the forward (``csrc/fused_gnblock_nk.cu``) runs
one thread per (receiver, sample) over the receiver's K slots, so the
K-sum needs no atomics, the edge messages stay in registers and the MLP
weights sit in shared memory; the backward (``csrc/fused_gnblock_nk_bwd.cu``)
rematerializes that forward from (x, e) and returns dx, de and fp32
weight gradients, reduced per block in shared memory. Both are bound by
fp32 FMA throughput on the CUDA cores; tensor cores are later work. See
the sources' headers for the designs.

:func:`fused_gn_block_nk_reference` is the plain PyTorch version of the
same function, following blocked_reference_nk (fused_gnblock_nk.py:731);
its gradient is plain autograd. The wrapper uses it for tensors on the
CPU; for CUDA tensors it launches the kernels (the backward through
``torch.autograd.Function``) or raises.

Build: at first use, ``nvcc -gencode arch=compute_90a,code=sm_90a`` turns
each source into a shared library with a plain C interface under
``build/kernels/`` of the checkout (git-ignored), both compiles running at
once; the libraries are loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
from pathlib import Path
from typing import Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
#: the kernel sources by library name; both include HEADER
SOURCES = {"fwd": CSRC / "fused_gnblock_nk.cu", "bwd": CSRC / "fused_gnblock_nk_bwd.cu"}
HEADER = CSRC / "gn_nk_common.cuh"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
#: hidden width the kernels are compiled for (``H`` in the sources)
KERNEL_HIDDEN = 32
#: most Dense layers per MLP the forward kernel takes (``MAXL``)
KERNEL_MAX_LAYERS = 8
#: Dense layers per MLP the backward kernel is built for (``NL``)
BACKWARD_LAYERS = 4
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_libs = {}


def library_path(name: str = "fwd") -> Path:
    src = SOURCES[name]
    digest = hashlib.sha256(src.read_bytes() + HEADER.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}_{digest}.so"


def build() -> str:
    """Compile the kernel libraries that are not built yet, one nvcc
    process per source, all at once; returns nvcc's output (ptxas
    register and shared-memory reports), empty when all are cached."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name, src in SOURCES.items():
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((proc, tmp, out))
    logs = []
    for proc, tmp, out in jobs:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) for {out.name}:\n{text}")
        os.replace(tmp, out)
        logs.append(text)
    return "".join(logs)


def _load(name: str):
    if name not in _libs:
        build()
        for lib_name in SOURCES:
            lib = ctypes.CDLL(str(library_path(lib_name)))
            vp, i = ctypes.c_void_p, ctypes.c_int
            if lib_name == "fwd":
                lib.gn_nk_fwd.argtypes = [vp, vp, vp, vp, vp, vp, i, i, i, i, i,
                                          vp, i, vp, i, vp, i, vp]
                lib.gn_nk_fwd.restype = i
            else:
                lib.gn_nk_bwd.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, i, i, i, i, i,
                                          vp, vp, i, vp, vp, i, vp, vp, i, vp]
                lib.gn_nk_bwd.restype = i
            _libs[lib_name] = lib
    return _libs[name]


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


def _launch_fwd(x, edge_attr, senders, edge_mask, nk, mlps, last_block):
    enc, edge, node = mlps
    n, b, h = x.shape
    x_out = torch.empty_like(x)
    e_out = None if last_block else torch.empty((nk.total_rows, b, h), dtype=x.dtype,
                                                device=x.device)
    err = _load("fwd").gn_nk_fwd(
        x.data_ptr(), edge_attr.data_ptr(), x_out.data_ptr(),
        None if e_out is None else e_out.data_ptr(),
        senders.data_ptr(), edge_mask.data_ptr(), n, b, nk.k_slots, nk.node_block,
        edge_attr.shape[-1] if enc is not None else 0,
        None if enc is None else _pointers(enc), 0 if enc is None else len(enc.denses),
        _pointers(edge), len(edge.denses), _pointers(node), len(node.denses),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_gn_block_nk launch failed with CUDA error {err}")
    fused_gn_block_nk.launches += 1
    return x_out, e_out


def _launch_bwd(x, edge_attr, g_xout, g_eout, senders, edge_mask, nk, mlps):
    """dx (bf16), de (bf16, None when the encoder is folded) and the
    parameter gradients (fp32 holding bf16 values, as the plain version's
    bf16 autograd gives them) in ``_mlp_params`` order per MLP."""
    enc, edge, node = mlps
    n, b, h = x.shape
    dx = torch.zeros((n, b, h), dtype=torch.float32, device=x.device)
    de = None if enc is not None else torch.empty((nk.total_rows, b, h), dtype=x.dtype,
                                                  device=x.device)
    grads = [[torch.zeros_like(p, dtype=torch.float32) for p in _mlp_params(m)]
             if m is not None else None for m in mlps]
    err = _load("bwd").gn_nk_bwd(
        x.data_ptr(), edge_attr.data_ptr(), g_xout.data_ptr(),
        None if g_eout is None else g_eout.data_ptr(), dx.data_ptr(),
        None if de is None else de.data_ptr(), senders.data_ptr(), edge_mask.data_ptr(),
        n, b, nk.k_slots, nk.node_block, edge_attr.shape[-1] if enc is not None else 0,
        None if enc is None else _pointers(enc), None if enc is None else _pointers(enc, grads[0]),
        0 if enc is None else len(enc.denses),
        _pointers(edge), _pointers(edge, grads[1]), len(edge.denses),
        _pointers(node), _pointers(node, grads[2]), len(node.denses),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_gn_block_nk backward launch failed with CUDA error {err}")
    fused_gn_block_nk.backward_launches += 1
    flat = [g.to(torch.bfloat16).float() for gs in grads if gs is not None for g in gs]
    return dx.to(torch.bfloat16), de, flat


class _FusedGNBlockNK(torch.autograd.Function):
    """The forward kernel, with the backward kernel as its gradient. The
    MLPs' parameters are inputs so autograd routes their gradients; on the
    last block only x_out is an output (the edge stream passes through
    outside), so no cotangent of the dead edge stream reaches the kernel."""

    @staticmethod
    def forward(ctx, x, edge_attr, senders, edge_mask, nk, mlps, last_block, *params):
        x_out, e_out = _launch_fwd(x, edge_attr, senders, edge_mask, nk, mlps, last_block)
        ctx.save_for_backward(x, edge_attr, senders, edge_mask)
        ctx.nk, ctx.mlps = nk, mlps
        return x_out if last_block else (x_out, e_out)

    @staticmethod
    @once_differentiable
    def backward(ctx, g_xout, g_eout=None):
        x, edge_attr, senders, edge_mask = ctx.saved_tensors
        dx, de, grads = _launch_bwd(
            x, edge_attr, g_xout.contiguous(), None if g_eout is None else g_eout.contiguous(),
            senders, edge_mask, ctx.nk, ctx.mlps)
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
    forward kernel, through ``_FusedGNBlockNK`` when a gradient is wanted."""
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
    x_out, e_out = _launch_fwd(x, edge_attr, senders, edge_mask, nk, mlps, last_block)
    return x_out, (edge_attr if last_block else e_out)


fused_gn_block_nk.launches = 0
fused_gn_block_nk.backward_launches = 0


def _mlp_reference(mlp, parts, cd):
    """The kernel's MLP numerics in plain PyTorch: one product over the
    concatenated inputs per Dense, rounded to ``cd`` before and after the
    bias; fp32 RMS statistics of ``cd`` squares (fused_gnblock.py:_mlp_fwd,
    _rms_fwd)."""
    ws, bs, scale = _mlp_tensors(mlp)
    act = mlp.act_fn
    h = torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]
    h = F.linear(h, ws[0].to(cd)) + bs[0].to(cd)
    for w, bias in zip(ws[1:], bs[1:]):
        h = F.linear(act(h), w.to(cd)) + bias.to(cd)
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
    """Plain PyTorch version of :func:`fused_gn_block_nk` (``index_select``
    sender gather, receiver rows repeated over the K slots, reshape-sum over
    K), computing in ``compute_dtype``."""
    cd = compute_dtype
    n, b, h = x.shape
    g, k, nb = nk.num_groups, nk.k_slots, nk.node_block
    xc = x.to(cd)
    e_in = edge_attr.to(cd)
    if encoder_params is not None:
        e_in = _mlp_reference(encoder_params, [e_in], cd)
    x_recv = xc.view(g, 1, nb, b, h).expand(g, k, nb, b, h).reshape(-1, b, h)
    x_send = xc.index_select(0, senders)
    eh = _mlp_reference(edge_params, [e_in, x_recv, x_send], cd)
    ehm = torch.where(edge_mask.view(-1, 1, 1), eh, torch.zeros((), dtype=cd, device=x.device))
    agg = ehm.float().view(g, k, nb, b, h).sum(1).reshape(n, b, h).to(cd)
    nh = _mlp_reference(node_params, [xc, agg], cd)
    x_out = (xc + nh).to(x.dtype)
    if last_block:
        return x_out, edge_attr
    return x_out, e_in + ehm
