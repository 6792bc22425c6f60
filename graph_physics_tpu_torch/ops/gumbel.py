"""Gumbel perturbation of Transolver slice logits as one kernel.

Port of graph_physics_tpu/ops/gumbel.py: gumbel_perturb (:104), the
Pallas kernel _kernel (:51) and its custom VJP (:62-92). The function is

    out = f32(logits) + g,   g = -log(-log(u + 1e-8) + 1e-8),
    u = bitcast_f32((bits >> 9) | 0x3F800000) - 1      (gumbel.py:54-58)

with ``bits`` 32 random bits per element. The TPU kernel draws them from
the core's hardware generator; here they come from Philox4x32-10
(Salmon et al., SC'11, as in Random123), keyed by a 2-word key tensor on
the device: element ``e`` of the flattened logits takes word ``e % 4`` of
the Philox block at counter ``(e // 4, 0, 0, 0)`` (the counter's second
word holds the high bits of ``e // 4``). The CUDA kernel
(``csrc/gumbel.cu``) makes each block in a thread and writes only the
output: the fp32 uniform tensor never reaches device memory.
:func:`gumbel_perturb_reference` is the plain PyTorch version, the same
Philox on int64 tensors, so that on the card both give the same bits.

Gradient: the noise is additive, so the backward is the exact passthrough
``ct.to(logits.dtype)`` (_bwd :87-89): no kernel, no saved tensors. Any
``[..., H, G]`` shape is taken: JAX's 128-lane rule (``supported``,
:95-101) is a TPU layout constraint.
"""

from __future__ import annotations

import ctypes

import torch

from graph_physics_tpu_torch.ops import kernel_build

#: Philox4x32 multipliers and Weyl key increments (Random123)
M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
ROUNDS = 10
MASK32 = 0xFFFFFFFF
#: the additive guard of both logs (gumbel.py:58)
EPS = 1e-8
#: input dtypes the kernel is built for, by its type code
KERNEL_DTYPES = {torch.bfloat16: 0, torch.float32: 1}

_vp = ctypes.c_void_p
_ARGTYPES = {
    "gumbel_perturb": [_vp, _vp, _vp, ctypes.c_longlong, ctypes.c_int, _vp],
    "philox_bits": [_vp, _vp, ctypes.c_longlong, _vp],
}


def _mulhilo(a: int, b: torch.Tensor):
    """(low, high) 32-bit words of ``a · b`` for a constant ``a < 2^32``
    and int64 words ``b < 2^32``. ``b`` is taken as 16-bit halves, so no
    intermediate overflows a signed int64."""
    x = a * (b & 0xFFFF)  # < 2^48
    y = a * (b >> 16)  # < 2^48
    t = (x & MASK32) + ((y & 0xFFFF) << 16)  # < 2^33
    return t & MASK32, (x >> 32) + (y >> 16) + (t >> 32)


def philox4x32_10(counter: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Philox4x32-10 on int64 tensors holding 32-bit words: ``counter``
    [..., 4], ``key`` [..., 2] (broadcast against it); returns [..., 4]."""
    c0, c1, c2, c3 = counter.unbind(-1)
    k0, k1 = key.unbind(-1)
    for _ in range(ROUNDS):
        lo0, hi0 = _mulhilo(M0, c0)
        lo1, hi1 = _mulhilo(M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + W0) & MASK32, (k1 + W1) & MASK32
    return torch.stack([c0, c1, c2, c3], dim=-1)


def random_bits(n: int, key: torch.Tensor) -> torch.Tensor:
    """The kernel's ``n`` random words (int64 in [0, 2^32)) for ``key``
    (int64 [2]), on the key's device: element e is word e % 4 of the block
    at counter (e // 4 low word, e // 4 high word, 0, 0)."""
    i = torch.arange((n + 3) // 4, dtype=torch.int64, device=key.device)
    zero = torch.zeros_like(i)
    counter = torch.stack([i & MASK32, i >> 32, zero, zero], dim=-1)
    return philox4x32_10(counter, key.to(torch.int64) & MASK32).reshape(-1)[:n]


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """u in [0, 1) on the 2^-23 grid: 1.0's exponent over the top 23 bits,
    minus 1 (gumbel.py:54-57)."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def gumbel_noise(u: torch.Tensor) -> torch.Tensor:
    """``-log(-log(u + 1e-8) + 1e-8)`` in fp32 (gumbel.py:58, transolver.py:59)."""
    return -torch.log(-torch.log(u + EPS) + EPS)


def gumbel_perturb_reference(logits: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``f32(logits) + g`` with the
    kernel's Philox bits for ``key``."""
    u = uniform_from_bits(random_bits(logits.numel(), key))
    return logits.float() + gumbel_noise(u).view(logits.shape)


def draw_key(generator: torch.Generator, device) -> torch.Tensor:
    """A fresh Philox key, int64 [2] in [0, 2^32), drawn from ``generator``
    on ``device`` (the generator's own device), with no host sync."""
    return torch.randint(0, 2**32, (2,), generator=generator, device=device,
                         dtype=torch.int64)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _library():
    return kernel_build.load("gumbel", _ARGTYPES)


def _launch(logits: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    out = torch.empty(logits.shape, dtype=torch.float32, device=logits.device)
    if logits.numel() == 0:
        return out
    err = _library().gumbel_perturb(logits.data_ptr(), key.data_ptr(), out.data_ptr(),
                                    logits.numel(), KERNEL_DTYPES[logits.dtype],
                                    _stream(logits))
    if err != 0:
        raise RuntimeError(f"gumbel_perturb launch failed with CUDA error {err}")
    gumbel_perturb.launches += 1
    return out


class _GumbelPerturb(torch.autograd.Function):
    """``impl(logits, key)`` (the kernel's launch or the plain version)
    with the exact passthrough gradient of _bwd (gumbel.py:87-89)."""

    @staticmethod
    def forward(ctx, logits, key, impl):
        ctx.dtype = logits.dtype
        return impl(logits, key)

    @staticmethod
    def backward(ctx, ct):
        return ct.to(ctx.dtype), None, None


def _check(logits: torch.Tensor, key: torch.Tensor) -> None:
    if not logits.is_floating_point():
        raise ValueError(f"floating logits required, got {logits.dtype}")
    if key.dtype != torch.int64 or tuple(key.shape) != (2,) or key.device != logits.device:
        raise ValueError(f"the key must be int64 [2] on the logits' device, got {key.dtype} "
                         f"{tuple(key.shape)} on {key.device}")


def gumbel_perturb(logits: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """``f32(logits) + Gumbel(0, 1)`` noise drawn from Philox with ``key``.

    ``logits``: [..., H, G], any float dtype on the CPU, bf16 or fp32 on
    the card; ``key``: int64 [2] on the same device (:func:`draw_key`).
    CPU tensors take :func:`gumbel_perturb_reference`; CUDA tensors launch
    the kernel, counted in ``gumbel_perturb.launches``, or raise. The
    gradient is the exact passthrough.
    """
    _check(logits, key)
    if logits.device.type == "cpu":
        return _GumbelPerturb.apply(logits, key, gumbel_perturb_reference)
    if logits.device.type != "cuda":
        raise ValueError(f"unsupported device {logits.device}")
    if logits.dtype not in KERNEL_DTYPES:
        raise NotImplementedError(f"the kernel is built for bf16 and fp32, not {logits.dtype}")
    if not (logits.is_contiguous() and key.is_contiguous()):
        raise ValueError("logits and key must be contiguous")
    return _GumbelPerturb.apply(logits, key, _launch)


gumbel_perturb.launches = 0


def reference_with_backward(logits: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """:func:`gumbel_perturb_reference` on any device, through the same
    ``torch.autograd.Function`` (passthrough gradient) as the kernel: the
    plain path of the model on the card."""
    _check(logits, key)
    return _GumbelPerturb.apply(logits, key, gumbel_perturb_reference)


def philox_bits(n: int, key: torch.Tensor) -> torch.Tensor:
    """The kernel's ``n`` random words as int64, made on the card by the
    kernel's own Philox (``csrc/gumbel.cu:philox_bits``): the check that
    the kernel and :func:`random_bits` draw the same bits. CUDA only."""
    if key.device.type != "cuda" or key.dtype != torch.int64 or tuple(key.shape) != (2,):
        raise ValueError("philox_bits takes an int64 [2] key on a CUDA device")
    out = torch.empty(n, dtype=torch.int32, device=key.device)
    if n:
        err = _library().philox_bits(key.data_ptr(), out.data_ptr(), n, _stream(key))
        if err != 0:
            raise RuntimeError(f"philox_bits launch failed with CUDA error {err}")
    return out.to(torch.int64) & MASK32
