"""The transformer block's gated feed-forward half as one kernel.

Replaces the TPU Pallas kernel graph_physics_tpu/ops/fused_ffn.py:
_ffn_fwd_kernel (:74) behind fused_gated_ffn (:165), with the block's
norm2 folded in (``pre_norm``):

    y = x + W3 · (act(W1·n + b1) ⊙ (W2·n + b2)) + b3,   n = RMS_0(RMS_norm2(x)).

The CUDA kernel (``csrc/fused_ffn.cu``) runs one thread per row of
[N·B, H] with the weights in shared memory; see its header for the design
and the bound. :func:`gated_ffn_reference` is the plain PyTorch version,
rounding where the kernel rounds (gated_ffn_reference, fused_ffn.py:282,
with _rms_fwd's numerics). The wrapper uses it for tensors on the CPU; for
CUDA tensors it launches the kernel or raises. Only the forward is ported
(ROADMAP B row 10 is the backward).
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from graph_physics_tpu_torch.ops import kernel_build

#: hidden width the kernel is compiled for (``H``); its middle is 3H wide
KERNEL_HIDDEN = 64

_vp = ctypes.c_void_p
_ARGTYPES = {"ffn_fwd": [_vp, _vp, ctypes.c_longlong, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp,
                         ctypes.c_int, _vp]}


def _params(block, norm2):
    """The kernel's parameters in its order: norm2 scale, the block's
    RMSNorm scale, W1, b1, W2, b2, W3, b3 (nn.Linear layout)."""
    g = block.gated
    return [norm2.scale, block.norm.scale, g.linear1.weight, g.linear1.bias,
            g.linear2.weight, g.linear2.bias, block.out.weight, block.out.bias]


def fused_gated_ffn(x: torch.Tensor, block, norm2) -> torch.Tensor:
    """``x + block(norm2(x))`` in bf16, for the TransformerBlock's FFN half.

    x is bf16 [N, B, H]; ``block`` is the block's GatedMLPBlock (RMSNorm,
    GatedMLP, Dense; models/layers.py) and ``norm2`` its RMSNorm. CPU
    tensors take :func:`gated_ffn_reference`; CUDA tensors launch the
    kernel, counted in ``fused_gated_ffn.launches``.
    """
    if x.dtype != torch.bfloat16 or x.ndim != 3:
        raise ValueError(f"bf16 packed [N, B, H] input required, got {x.dtype} "
                         f"{tuple(x.shape)}")
    params = _params(block, norm2)
    if any(p is None for p in params):
        raise ValueError("the gated FFN's Dense layers need their biases")
    if not x.is_contiguous() or any(p.device != x.device for p in params):
        raise ValueError("x must be contiguous and on the parameters' device")
    if x.device.type == "cpu":
        return gated_ffn_reference(x, block, norm2)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    h = x.shape[-1]
    if h != KERNEL_HIDDEN or block.gated.linear1.weight.shape != (3 * h, h) or \
            block.out.weight.shape != (h, 3 * h):
        raise NotImplementedError(f"the kernel is built for hidden {KERNEL_HIDDEN} with a "
                                  f"{3 * KERNEL_HIDDEN}-wide middle")
    if torch.is_grad_enabled() and (x.requires_grad or any(p.requires_grad for p in params)):
        raise NotImplementedError("the gated FFN kernel's backward is not ported")
    for p in params:
        if p.dtype != torch.float32 or not p.is_contiguous():
            raise ValueError("kernel parameters must be contiguous fp32")
    y = torch.empty_like(x)
    err = kernel_build.load("ffn", _ARGTYPES).ffn_fwd(
        x.data_ptr(), y.data_ptr(), x.shape[0] * x.shape[1], *[p.data_ptr() for p in params],
        int(block.gated.use_silu), torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_gated_ffn launch failed with CUDA error {err}")
    fused_gated_ffn.launches += 1
    return y


fused_gated_ffn.launches = 0


def _rms(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """_rms_fwd (fused_gnblock.py:182) in ``x``'s dtype: squares in that
    dtype, their sum in fp32, ``inv = 1/(rms + 1e-8)`` rounded to the dtype,
    then two rounded products."""
    gs = (x * x).float().sum(-1, keepdim=True)
    rms = torch.sqrt(gs + 1e-24) / math.sqrt(x.shape[-1])
    inv = 1.0 / (rms + 1e-8)
    return x * inv.to(x.dtype) * scale.to(x.dtype)


def gated_ffn_reference(x: torch.Tensor, block, norm2) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_gated_ffn`, computing in
    ``x``'s dtype: each product accumulates in fp32 and rounds, then the
    bias adds and rounds; the gate's product and the residual round."""
    cd = x.dtype
    g = block.gated
    n = _rms(_rms(x, norm2.scale), block.norm.scale)
    a1 = F.linear(n, g.linear1.weight.to(cd)) + g.linear1.bias.to(cd)
    a2 = F.linear(n, g.linear2.weight.to(cd)) + g.linear2.bias.to(cd)
    mid = g.act_fn(a1) * a2
    return x + (F.linear(mid, block.out.weight.to(cd)) + block.out.bias.to(cd))
