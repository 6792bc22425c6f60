"""Fused GraphNetBlock on the uniform-degree (NK) slot layout.

Replaces the TPU Pallas kernel graph_physics_tpu/ops/fused_gnblock_nk.py:
_nk_fwd_kernel (:147) behind fused_gn_block_nk (:332), forward only. The
CUDA kernel (``csrc/fused_gnblock_nk.cu``) runs one thread per (receiver,
sample) over the receiver's K slots: the K-sum needs no atomics and the
edge messages stay in registers, the MLP weights sit in shared memory.
On the H100 it is bound by fp32 FMA throughput on the CUDA cores (~20
GFLOP per cylinder block against ~0.25 GB of traffic); tensor cores are
later work. See the source's header for the design.

:func:`fused_gn_block_nk_reference` is the plain PyTorch version of the
same function, following blocked_reference_nk (fused_gnblock_nk.py:731).
The wrapper uses it for tensors on the CPU; for a CUDA tensor it launches
the kernel or raises.

Build: at first use, ``nvcc -gencode arch=compute_90a,code=sm_90a`` turns
the source into a shared library with a plain C interface under
``build/kernels/`` of the checkout (git-ignored), loaded with ctypes.
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

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "fused_gnblock_nk.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
#: hidden width the kernel is compiled for (``H`` in the source)
KERNEL_HIDDEN = 32
#: most Dense layers per MLP the kernel takes (``MAXL`` in the source)
KERNEL_MAX_LAYERS = 8
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lib = None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libfused_gnblock_nk_{digest}.so"


def build() -> str:
    """Compile the kernel library if it is not built yet; returns nvcc's
    output (ptxas register and shared-memory report), empty when cached."""
    out = library_path()
    if out.exists():
        return ""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return proc.stdout + proc.stderr


def _load():
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(str(library_path()))
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.gn_nk_fwd.argtypes = [vp, vp, vp, vp, vp, vp, i, i, i, i, i,
                                  vp, i, vp, i, vp, i, vp]
        lib.gn_nk_fwd.restype = i
        _lib = lib
    return _lib


def _mlp_tensors(mlp):
    """(weights [out, in], biases, RMSNorm scale or None) of a ported MLP."""
    denses = mlp.denses
    norm = mlp.norm
    return ([d.weight for d in denses], [d.bias for d in denses],
            None if norm is None else norm.scale)


def _check_mlp(mlp, in_dim: int, hidden: int, device, name: str):
    ws, bs, scale = _mlp_tensors(mlp)
    if ws[0].shape[1] != in_dim or any(w.shape[0] != hidden for w in ws):
        raise ValueError(f"{name}: expected Dense layers {in_dim}->{hidden}..., got "
                         f"{[tuple(w.shape) for w in ws]}")
    for t in ws + bs + ([scale] if scale is not None else []):
        if t.device != device:
            raise ValueError(f"{name}: parameters on {t.device}, inputs on {device}")


def _mlp_pointers(mlp):
    ws, bs, scale = _mlp_tensors(mlp)
    tensors = [t for pair in zip(ws, bs) for t in pair]
    for t in tensors + ([scale] if scale is not None else []):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("kernel MLP parameters must be contiguous fp32")
    ptrs = [t.data_ptr() for t in tensors] + [None if scale is None else scale.data_ptr()]
    return (ctypes.c_void_p * len(ptrs))(*ptrs), len(ws)


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
    :func:`fused_gn_block_nk_reference`; CUDA tensors launch the kernel
    and count it in ``fused_gn_block_nk.launches``.
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
    mlps = [(edge_params, 3 * h, "edge MLP"), (node_params, 2 * h, "node MLP")]
    if encoder_params is not None:
        mlps.append((encoder_params, fe, "edge encoder"))
    for mlp, in_dim, name in mlps:
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
    params = [p for mlp, _, _ in mlps for p in mlp.parameters()]
    if torch.is_grad_enabled() and any(t.requires_grad for t in [x, edge_attr, *params]):
        raise NotImplementedError("fused_gn_block_nk has no backward kernel yet; "
                                  "run inference under torch.no_grad()")
    if h != KERNEL_HIDDEN:
        raise NotImplementedError(f"the kernel is built for hidden {KERNEL_HIDDEN}, got {h}")
    if any(mlp.activation != "relu" for mlp, _, _ in mlps):
        raise NotImplementedError("the kernel implements relu MLPs only")
    if any(len(mlp.denses) > KERNEL_MAX_LAYERS for mlp, _, _ in mlps):
        raise NotImplementedError(f"at most {KERNEL_MAX_LAYERS} Dense layers per MLP")

    x_out = torch.empty_like(x)
    e_out = None if last_block else torch.empty((rows, b, h), dtype=x.dtype, device=x.device)
    edge_w, n_edge = _mlp_pointers(edge_params)
    node_w, n_node = _mlp_pointers(node_params)
    enc_w, n_enc = (_mlp_pointers(encoder_params) if encoder_params is not None
                    else (None, 0))
    err = _load().gn_nk_fwd(
        x.data_ptr(), edge_attr.data_ptr(), x_out.data_ptr(),
        None if e_out is None else e_out.data_ptr(),
        senders.data_ptr(), edge_mask.data_ptr(), n, b, nk.k_slots, nk.node_block,
        fe if encoder_params is not None else 0,
        enc_w, n_enc, edge_w, n_edge, node_w, n_node,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_gn_block_nk launch failed with CUDA error {err}")
    fused_gn_block_nk.launches += 1
    return x_out, (edge_attr if last_block else e_out)


fused_gn_block_nk.launches = 0


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
