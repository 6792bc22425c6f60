"""The transformer block's gated feed-forward half as one kernel.

Replaces the TPU Pallas kernels graph_physics_tpu/ops/fused_ffn.py:
_ffn_fwd_kernel (:74) and _ffn_bwd_kernel (:99) behind fused_gated_ffn
(:165), with the block's norm2 folded in (``pre_norm``):

    y = x + W3 · (act(W1·n + b1) ⊙ (W2·n + b2)) + b3,   n = RMS_0(RMS_norm2(x)).

The kernels come in instances by the hidden width H, every H dividing
128 (the widths JAX's gate fuses). At H = 64 both
run their products on the tensor cores in one pass over row tiles of
[N·B, H], with the weights in shared memory. The forward
(``csrc/fused_ffn.cu``, 128-row tiles) runs its three products and keeps
the 192-wide middle in registers. The backward
(``csrc/fused_ffn_bwd.cu``, 64-row tiles) runs eight: it recomputes the
rows from x, gives dx, and keeps each block's sums of the eight parameter
gradients, which a second kernel adds in block order. At H = 128 (the
panels workload) the weights no longer fit a block's shared memory: the
forward (``csrc/fused_ffn128.cu``) streams them through it in slices of
64 middle columns beside warpgroup products, and the backward
(``csrc/fused_ffn128_bwd.cu``) runs in clusters of six blocks, each
owning a slice of the middle and its weights, that add their parts of
the cotangent through each other's shared memory and keep their slices
of the weight gradients in registers, so no scratch of the middle goes
to device memory. At H = 32 and
below (``csrc/fused_ffn_small.cu``, ``fused_ffn_small_bwd.cu`` on
``csrc/ffn_small.cuh``, one library a width) the products run on tiles
zero-padded to the tensor cores' 16-wide steps, the elementwise work a
thread a row; the backward keeps the weight gradients' tiles in
registers and adds each block's sums in block order. Any other H, which
JAX's gate does not fuse either, raises. See the sources' headers for the
designs and the bounds.
:func:`gated_ffn_reference` is the plain PyTorch version of the forward,
rounding where the kernel rounds (gated_ffn_reference, fused_ffn.py:282,
with _rms_fwd's numerics), and :func:`gated_ffn_backward_reference` that
of the backward. The wrapper uses the forward's plain version, with
plain autograd, for tensors on the CPU; for CUDA tensors it launches the
kernels (the backward through ``torch.autograd.Function``) or raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from graph_physics_tpu_torch.ops import kernel_build
from graph_physics_tpu_torch.ops.activation import silu_grad

#: hidden widths the kernels are compiled for (``H``): every width dividing
#: JAX's LANES_ = 128, the widths its gate fuses; the middle is 3H wide
KERNEL_HIDDENS = (1, 2, 4, 8, 16, 32, 64, 128)
#: the widths of the small kernels (csrc/fused_ffn_small*.cu, a library each)
SMALL_HIDDENS = kernel_build.FFN_SMALL_HIDDENS
#: RMSNorm epsilon (layers.RMSNorm.eps, _rms_fwd's eps)
RMS_EPS = 1e-8

_vp, _i = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "ffn": {"ffn_fwd": [_vp, _vp, ctypes.c_longlong] + [_vp] * 8 + [_i, _vp]},
    "ffn_bwd": {"ffn_bwd": [_vp] * 5 + [ctypes.c_longlong] + [_vp] * 8 + [_i, _i, _vp]},
    "ffn128": {"ffn128_fwd": [_vp] * 3 + [ctypes.c_longlong] + [_vp] * 8 + [_i, _vp],
               "ffn128_fwd_image_bytes": []},
    "ffn128_bwd": {"ffn128_bwd": [_vp] * 6 + [ctypes.c_longlong] + [_vp] * 7 + [_i] * 2 + [_vp],
                   "ffn128_bwd_sizes": [_i], "ffn128_bwd_clusters": [ctypes.c_longlong]},
}
for _h in SMALL_HIDDENS:
    _ARGTYPES[f"ffn_small{_h}"] = {"ffn_small_fwd": _ARGTYPES["ffn"]["ffn_fwd"]}
    _ARGTYPES[f"ffn_small_bwd{_h}"] = {"ffn_small_bwd": _ARGTYPES["ffn_bwd"]["ffn_bwd"]}


def _grad_shapes(h: int):
    """The backward's fp32 gradient buffer at hidden ``h``, in its order:
    name -> shape."""
    w = 3 * h
    return {"w1": (w, h), "w2": (w, h), "w3": (h, w), "b1": (w,), "b2": (w,), "b3": (h,),
            "scale": (h,), "scale2": (h,)}



#: ``_params``' order of the same gradients
_PARAM_ORDER = ("scale2", "scale", "w1", "b1", "w2", "b2", "w3", "b3")


def _params(block, norm2):
    """The kernels' parameters in their order: norm2 scale, the block's
    RMSNorm scale, W1, b1, W2, b2, W3, b3 (nn.Linear layout)."""
    g = block.gated
    return [norm2.scale, block.norm.scale, g.linear1.weight, g.linear1.bias,
            g.linear2.weight, g.linear2.bias, block.out.weight, block.out.bias]


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


#: (library, C function) of the forward and of the backward kernel at
#: hidden 64 and at each small width
_FUNCS = {64: (("ffn", "ffn_fwd"), ("ffn_bwd", "ffn_bwd")),
          **{h: ((f"ffn_small{h}", "ffn_small_fwd"), (f"ffn_small_bwd{h}", "ffn_small_bwd"))
             for h in SMALL_HIDDENS}}


def _kernel_fn(h, backward):
    lib, fn = _FUNCS[h][backward]
    return getattr(kernel_build.load(lib, _ARGTYPES[lib]), fn)


def _launch_fwd(x, block, norm2):
    if x.shape[-1] == 128:
        return _launch_fwd128(x, block, norm2)
    y = torch.empty_like(x)
    err = _kernel_fn(x.shape[-1], False)(
        x.data_ptr(), y.data_ptr(), x.shape[0] * x.shape[1],
        *[p.data_ptr() for p in _params(block, norm2)], int(block.gated.use_silu), _stream(x))
    if err != 0:
        raise RuntimeError(f"fused_gated_ffn launch failed with CUDA error {err}")
    fused_gated_ffn.launches += 1
    return y


def _launch_fwd128(x, block, norm2):
    """The hidden-128 forward: its first kernel packs the weights into the
    bf16 image ``img`` that the second streams through shared memory."""
    lib = kernel_build.load("ffn128", _ARGTYPES["ffn128"])
    y = torch.empty_like(x)
    img = torch.empty(lib.ffn128_fwd_image_bytes(), dtype=torch.uint8, device=x.device)
    err = lib.ffn128_fwd(
        x.data_ptr(), y.data_ptr(), img.data_ptr(), x.shape[0] * x.shape[1],
        *[p.data_ptr() for p in _params(block, norm2)], int(block.gated.use_silu), _stream(x))
    if err != 0:
        raise RuntimeError(f"fused_gated_ffn (hidden 128) launch failed with CUDA error {err}")
    fused_gated_ffn.launches += 1
    return y


def _named_grads(grads, h):
    """The flat fp32 gradient buffer as the parameters' gradients in
    ``_params`` order."""
    shapes = _grad_shapes(h)
    sizes = [math.prod(shape) for shape in shapes.values()]
    named = {name: t.view(shape) for (name, shape), t in zip(shapes.items(), grads.split(sizes))}
    return [named[k] for k in _PARAM_ORDER]


def _launch_bwd(x, block, norm2, g_out):
    """dx (bf16) and the fp32 parameter gradients in ``_params`` order."""
    if x.shape[-1] == 128:
        return _launch_bwd128(x, block, norm2, g_out)
    rows = x.shape[0] * x.shape[1]
    dev = x.device
    parts = torch.cuda.get_device_properties(dev).multi_processor_count
    dx = torch.empty_like(x)
    sizes = [math.prod(shape) for shape in _grad_shapes(x.shape[-1]).values()]
    partials = torch.empty((parts, sum(sizes)), dtype=torch.float32, device=dev)
    grads = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    err = _kernel_fn(x.shape[-1], True)(
        x.data_ptr(), g_out.data_ptr(), dx.data_ptr(), partials.data_ptr(), grads.data_ptr(),
        rows, *[p.data_ptr() for p in _params(block, norm2)],
        int(block.gated.use_silu), parts, _stream(x))
    if err != 0:
        raise RuntimeError(f"fused_gated_ffn backward launch failed with CUDA error {err}")
    fused_gated_ffn.backward_launches += 1
    return dx, _named_grads(grads, x.shape[-1])


def _launch_bwd128(x, block, norm2, g_out):
    """The hidden-128 backward: the weights packed into a bf16 image, one
    launch of clusters that each own a tile of rows at a time and write
    their sums of the gradients as partials, and a last kernel that adds
    the clusters' partials in order."""
    lib = kernel_build.load("ffn128_bwd", _ARGTYPES["ffn128_bwd"])
    rows = x.shape[0] * x.shape[1]
    dev = x.device
    with torch.cuda.device(dev):
        clusters = lib.ffn128_bwd_clusters(rows)
    if clusters < 1:
        raise RuntimeError(f"fused_gated_ffn (hidden 128) backward: no cluster fits the card "
                           f"(CUDA error {-clusters})")
    dx = torch.empty_like(x)
    img = torch.empty(lib.ffn128_bwd_sizes(0), dtype=torch.uint8, device=dev)
    part = torch.empty((clusters, lib.ffn128_bwd_sizes(1)), dtype=torch.float32, device=dev)
    grads = torch.empty(lib.ffn128_bwd_sizes(2), dtype=torch.float32, device=dev)
    params = _params(block, norm2)
    err = lib.ffn128_bwd(
        x.data_ptr(), g_out.data_ptr(), dx.data_ptr(), img.data_ptr(), part.data_ptr(),
        grads.data_ptr(), rows, *[p.data_ptr() for p in params[:7]],
        int(block.gated.use_silu), clusters, _stream(x))
    if err != 0:
        raise RuntimeError(f"fused_gated_ffn (hidden 128) backward launch failed with CUDA "
                           f"error {err}")
    fused_gated_ffn.backward_launches += 1
    return dx, _named_grads(grads, x.shape[-1])


class _FusedGatedFFN(torch.autograd.Function):
    """A forward with its backward as the gradient: the kernels
    (``_launch_fwd``, ``_launch_bwd``) or the plain versions
    (:data:`PLAIN`), given as the pair ``impl``. The eight parameters are
    inputs so autograd routes their gradients."""

    @staticmethod
    def forward(ctx, x, block, norm2, impl, *params):
        ctx.save_for_backward(x)
        ctx.block, ctx.norm2, ctx.impl = block, norm2, impl
        return impl[0](x, block, norm2)

    @staticmethod
    @once_differentiable
    def backward(ctx, g_out):
        (x,) = ctx.saved_tensors
        dx, grads = ctx.impl[1](x, ctx.block, ctx.norm2, g_out.contiguous())
        return (dx, None, None, None, *grads)


def _check(x, block, norm2):
    if x.dtype != torch.bfloat16 or x.ndim != 3:
        raise ValueError(f"bf16 packed [N, B, H] input required, got {x.dtype} "
                         f"{tuple(x.shape)}")
    params = _params(block, norm2)
    if any(p is None for p in params):
        raise ValueError("the gated FFN's Dense layers need their biases")
    if not x.is_contiguous() or any(p.device != x.device for p in params):
        raise ValueError("x must be contiguous and on the parameters' device")
    return params


def fused_gated_ffn(x: torch.Tensor, block, norm2) -> torch.Tensor:
    """``x + block(norm2(x))`` in bf16, for the TransformerBlock's FFN half.

    x is bf16 [N, B, H]; ``block`` is the block's GatedMLPBlock (RMSNorm,
    GatedMLP, Dense; models/layers.py) and ``norm2`` its RMSNorm. CPU
    tensors take :func:`gated_ffn_reference` (gradient by plain autograd);
    CUDA tensors launch the kernel of their H (any H dividing 128; any
    other raises), counted in ``fused_gated_ffn.launches``,
    and under autograd its gradient is the backward kernel, counted in
    ``fused_gated_ffn.backward_launches``.
    """
    params = _check(x, block, norm2)
    if x.device.type == "cpu":
        return gated_ffn_reference(x, block, norm2)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    h = x.shape[-1]
    if h not in KERNEL_HIDDENS or block.gated.linear1.weight.shape != (3 * h, h) or \
            block.out.weight.shape != (h, 3 * h):
        raise NotImplementedError(f"the gated-FFN kernels are built for hidden {KERNEL_HIDDENS} "
                                  f"with a 3H-wide middle, not hidden {h}: widths that JAX's "
                                  f"gate does not fuse either (LANES_ % hidden != 0)")
    for p in params:
        if p.dtype != torch.float32 or not p.is_contiguous():
            raise ValueError("kernel parameters must be contiguous fp32")
    if torch.is_grad_enabled() and (x.requires_grad or any(p.requires_grad for p in params)):
        return _FusedGatedFFN.apply(x, block, norm2, KERNELS, *params)
    return _launch_fwd(x, block, norm2)


fused_gated_ffn.launches = 0
fused_gated_ffn.backward_launches = 0


def _rms(x: torch.Tensor, scale: torch.Tensor):
    """_rms_fwd (fused_gnblock.py:182) in ``x``'s dtype: squares in that
    dtype, their sum in fp32, ``inv = 1/(rms + eps)`` (fp32), then
    ``u = x · inv`` and ``u · scale`` with ``inv`` and ``scale`` rounded to
    the dtype. Returns (u · scale, u, inv)."""
    gs = (x * x).float().sum(-1, keepdim=True)
    rms = torch.sqrt(gs + 1e-24) / math.sqrt(x.shape[-1])
    inv = 1.0 / (rms + RMS_EPS)
    u = x * inv.to(x.dtype)
    return u * scale.to(x.dtype), u, inv


def _rms_backward(g, v, u, inv, scale):
    """_rms_bwd (fused_gnblock.py:201) in ``g``'s dtype: the cotangent of
    the RMSNorm input ``v`` and the fp32 gradient of ``scale``."""
    cd = g.dtype
    d_scale = (g * u).float().reshape(-1, g.shape[-1]).sum(0)
    g_u = g * scale.to(cd)
    dot = (g_u * v).float().sum(-1, keepdim=True)
    rms = (1.0 / inv - RMS_EPS).clamp_min(1e-30)
    corr = (dot * (inv * inv) / (g.shape[-1] * rms)).to(cd)
    return g_u * inv.to(cd) - v * corr, d_scale


def _act_grad(a: torch.Tensor, use_silu: bool) -> torch.Tensor:
    """_act_grad (fused_gnblock.py:137) of the gate's activation at the
    pre-activation ``a``: SiLU's on bf16 with every step rounded
    (ops/activation.silu_grad), the exact GELU's in fp32, rounded to
    ``a``'s dtype."""
    if use_silu:
        return silu_grad(a)
    x = a.float()  # exact GELU: Φ(x) + x·φ(x)
    d = 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0))) + x * torch.exp(-0.5 * x * x) / \
        math.sqrt(2.0 * math.pi)
    return d.to(a.dtype)


def _gate(n, block):
    """(a1, a2, act(a1), the gated middle) of the normalised rows ``n``."""
    cd = n.dtype
    g = block.gated
    a1 = F.linear(n, g.linear1.weight.to(cd)) + g.linear1.bias.to(cd)
    a2 = F.linear(n, g.linear2.weight.to(cd)) + g.linear2.bias.to(cd)
    act1 = g.act_fn(a1)
    return a1, a2, act1, act1 * a2


def gated_ffn_reference(x: torch.Tensor, block, norm2) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_gated_ffn`, computing in
    ``x``'s dtype: each product accumulates in fp32 and rounds, then the
    bias adds and rounds; the gate's product and the residual round."""
    cd = x.dtype
    n = _rms(_rms(x, norm2.scale)[0], block.norm.scale)[0]
    mid = _gate(n, block)[3]
    return x + (F.linear(mid, block.out.weight.to(cd)) + block.out.bias.to(cd))


@torch.no_grad()
def gated_ffn_backward_reference(x: torch.Tensor, block, norm2,
                                 g_out: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Plain PyTorch version of the backward kernel: dx (in ``x``'s dtype)
    and the fp32 gradients of the eight parameters in ``_params`` order,
    following _ffn_bwd_kernel (fused_ffn.py:99-162) with ``pre_norm``:
    rematerialise t = RMS_norm2(x), n = RMS_0(t), a1, a2, act1, gmid from x;
      db3 = Σ g,  dW3 = gᵀ gmid,  g_mid = bf16(g W3),
      ga1 = bf16(bf16(g_mid · a2) · act'(a1)),  ga2 = bf16(g_mid · act1),
      db1 = Σ ga1,  dW1 = ga1ᵀ n,  db2 = Σ ga2,  dW2 = ga2ᵀ n,
      g_h = bf16(ga1 W1 + ga2 W2),
    then _rms_bwd through the block's norm and through norm2 (each gives
    its scale's gradient), and dx = g_out + g_in. Products are of bf16
    values with fp32 sums; weights are used as bf16 values."""
    cd = x.dtype
    h = x.shape[-1]
    gm = block.gated
    t, u0, inv0 = _rms(x, norm2.scale)
    n, u, inv = _rms(t, block.norm.scale)
    a1, a2, act1, gmid = _gate(n, block)
    w1, w2, w3 = (w.to(cd).float() for w in (gm.linear1.weight, gm.linear2.weight,
                                             block.out.weight))
    rows = (-1, h)
    g = g_out.reshape(rows)
    g_mid = (g.float() @ w3).to(cd).view(a1.shape)
    ga1 = g_mid * a2 * _act_grad(a1, gm.use_silu)
    ga2 = g_mid * act1
    nf, ga1f, ga2f = (t.reshape(-1, t.shape[-1]).float() for t in (n, ga1, ga2))
    g_h = (ga1f @ w1 + ga2f @ w2).to(cd).view(x.shape)
    g_in, d_scale = _rms_backward(g_h, t, u, inv, block.norm.scale)
    g_in, d_scale2 = _rms_backward(g_in, x, u0, inv0, norm2.scale)
    grads = [d_scale2, d_scale, ga1f.T @ nf, ga1f.sum(0), ga2f.T @ nf, ga2f.sum(0),
             g.float().T @ gmid.reshape(-1, gmid.shape[-1]).float(), g.float().sum(0)]
    return g_out + g_in, grads


#: the forward and backward as kernels, and as plain versions
KERNELS = (_launch_fwd, _launch_bwd)
PLAIN = (gated_ffn_reference, gated_ffn_backward_reference)


def reference_with_backward(x: torch.Tensor, block, norm2) -> torch.Tensor:
    """:func:`gated_ffn_reference` with :func:`gated_ffn_backward_reference`
    as its gradient, through the same ``torch.autograd.Function`` as the
    kernels."""
    params = _check(x, block, norm2)
    return _FusedGatedFFN.apply(x, block, norm2, PLAIN, *params)
