"""Gradients through a kernel, its plain version and fp32, and the bounds
that hold a backward kernel against them on a card.

A backward kernel is held three ways on the same bf16 inputs: against its
plain PyTorch version in bf16, and, beside that plain version, against
the fp32 gradient (fp32 inputs holding the bf16 values, parameters
rounded to their bf16 values, as the kernels use them).

Two bf16 backwards of the same function disagree in a few values however
carefully they round: where a pre-activation lies within a bf16 rounding
of a kink (relu's zero, a softmax weight that rounds the other way), one
side passes the cotangent and the other stops it, and the two values
then differ by a whole term. The plain version has as many such values
against the fp32 gradient as the kernel has. So the streams (the
gradients of the activations: dx, de; dq, dk, dv) are held to the JAX
suite's bound (rtol = atol = 0.05, tests/test_fused_gnblock_nk.py:101-106)
on all but ``OUTSIDE_SHARE`` of their values, and both versions are held
against the fp32 gradient: the kernel's relative L2 error and its largest
error there may not exceed the plain version's by more than
``FP32_L2_RATIO`` and ``FP32_MAX_RATIO``. Weight gradients are fp32 sums
over every row; they meet the JAX suite's bound
``|a - b| <= 0.04 · max|b|`` (tests/test_fused_gnblock_nk.py:150-156,
tests/test_fused_edge_attention_nk.py:119-125, tests/test_fused_ffn.py:
33-61 and 100-128).
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, List, Sequence, Tuple

import torch

from graph_physics_tpu_torch.ops import fused_gnblock_csr as csr_ops
from graph_physics_tpu_torch.ops import fused_gnblock_nk as nk_ops
from graph_physics_tpu_torch.ops.tiling import CSRLayout

STREAM_TOL = 0.05
OUTSIDE_SHARE = 1e-4
WEIGHT_REL = 0.04
FP32_L2_RATIO = 1.1
FP32_MAX_RATIO = 1.5


def rounded_copy(module):
    """A copy of ``module`` whose fp32 parameters hold their bf16 values
    (the kernels use the weights as bf16), for an fp32 reference."""
    if module is None:
        return None
    module = copy.deepcopy(module)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(p.to(torch.bfloat16).float())
    return module


def grads_of(fn: Callable, inputs: Sequence[torch.Tensor],
             cots: Sequence[torch.Tensor]) -> Tuple[List[torch.Tensor], tuple]:
    """Gradients, as fp32, of Σ out·cot through ``fn`` with respect to the
    inputs and then the parameters, and ``kept`` = (outputs, those leaves,
    cotangents) with the graph retained, so a caller can time the backward
    again with ``torch.autograd.grad(*kept, retain_graph=True)``.
    ``fn(*leaves) -> (outputs, params)`` gets fresh leaves of ``inputs``
    that require grad; outputs is a tensor or a sequence of tensors, one
    per cotangent."""
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    outs, params = fn(*leaves)
    outs = list(outs) if isinstance(outs, (tuple, list)) else [outs]
    cots = [c.to(o.dtype) for c, o in zip(cots, outs)]
    wrt = leaves + list(params)
    grads = torch.autograd.grad(outs, wrt, cots, retain_graph=True)
    return [g.float() for g in grads], (outs, wrt, cots)


def _rel_l2(a: torch.Tensor, ref: torch.Tensor) -> float:
    return ((a - ref).norm() / ref.norm().clamp_min(1e-30)).item()


def compare_grads(names, kernel, plain, fp32, streams: Sequence[str]) -> Tuple[List[Dict], bool]:
    """One row per gradient with the errors that the bounds above read,
    and whether every row is inside them. ``streams`` names the
    activation gradients; the others are weights."""
    rows, ok = [], True
    for name, k, p, f in zip(names, kernel, plain, fp32):
        if not torch.isfinite(k).all():
            rows.append({"name": name, "finite": False, "ok": False})
            ok = False
            continue
        diff = (k - p).abs()
        f_scale = f.abs().max().clamp_min(1e-30)
        row = {
            "name": name,
            "max_abs_err": diff.max().item(),
            "rel_to_max": (diff.max() / p.abs().max().clamp_min(1e-3)).item(),
            "kernel_fp32_l2": _rel_l2(k, f),
            "plain_fp32_l2": _rel_l2(p, f),
            "kernel_fp32_max": ((k - f).abs().max() / f_scale).item(),
            "plain_fp32_max": ((p - f).abs().max() / f_scale).item(),
        }
        if name in streams:
            row["outside"] = int((diff > STREAM_TOL + STREAM_TOL * p.abs()).sum())
            row["count"] = diff.numel()
            good = row["outside"] <= OUTSIDE_SHARE * row["count"]
        else:
            good = row["rel_to_max"] <= WEIGHT_REL
        good = (good and row["kernel_fp32_l2"] <= FP32_L2_RATIO * row["plain_fp32_l2"] + 1e-3
                and row["kernel_fp32_max"] <= FP32_MAX_RATIO * row["plain_fp32_max"] + 1e-3)
        row["ok"] = good
        ok = ok and good
        rows.append(row)
    return rows, ok


def check_backward(names: Sequence[str], streams: Sequence[str], kernel_fn: Callable,
                   plain_fn: Callable, fp32_fn: Callable, inputs: Sequence[torch.Tensor],
                   cots: Sequence[torch.Tensor]):
    """Gradients of one function through the kernel (``kernel_fn``), its
    plain version in bf16 (``plain_fn``) and in fp32 (``fp32_fn``, given
    the inputs as fp32), each as :func:`grads_of` takes it, compared by
    :func:`compare_grads`. Returns (rows, ok, {"kernel": kept, "plain":
    kept}) with the retained autograd graphs."""
    gk, kept_k = grads_of(kernel_fn, inputs, cots)
    gp, kept_p = grads_of(plain_fn, inputs, cots)
    gf, _ = grads_of(fp32_fn, [t.float() for t in inputs], cots)
    rows, ok = compare_grads(names, gk, gp, gf, streams)
    return rows, ok, {"kernel": kept_k, "plain": kept_p}


def check_block_backward(x, e, rows, mlps, layout, last_block, cot_x, cot_e):
    """:func:`check_backward` of one GraphNetBlock with ``mlps`` =
    (encoder or None, edge MLP, node MLP), from the cotangents of x_out
    and (unless on the last block) e_out. The layout's type picks the
    block: on an NKTiling ``fused_gn_block_nk`` with ``rows`` = (senders,
    edge_mask), on a CSRLayout ``fused_gn_block_csr`` with ``rows`` =
    (senders, receivers, edge_mask), each against its plain version.
    Gradients: dx, de unless the encoder is folded (raw edge features take
    none), then every MLP parameter in the kernels' order."""
    if isinstance(layout, CSRLayout):
        fn, reference = csr_ops.fused_gn_block_csr, csr_ops.fused_gn_block_csr_reference
    else:
        fn, reference = nk_ops.fused_gn_block_nk, nk_ops.fused_gn_block_nk_reference
    enc = mlps[0]

    def block(fn, mlps_, **kw):
        def run(xx, *ee):
            e_in = ee[0] if ee else (e if xx.dtype == torch.bfloat16 else e.float())
            xo, eo = fn(xx, e_in, *rows, mlps_[1], mlps_[2], layout, encoder_params=mlps_[0],
                        last_block=last_block, **kw)
            params = [p for m in mlps_ if m is not None for p in nk_ops._mlp_params(m)]
            return (xo if last_block else (xo, eo)), params
        return run

    names = ["dx"] + (["de"] if enc is None else [])
    for tag, mlp in zip(("enc", "edge", "node"), mlps):
        if mlp is not None:
            names += [f"{tag}.{i}" for i in range(len(nk_ops._mlp_params(mlp)))]
    inputs = [x] + ([e] if enc is None else [])
    cots = [cot_x] + ([] if last_block else [cot_e])
    return check_backward(
        names, ("dx", "de"), block(fn, mlps),
        block(reference, mlps, compute_dtype=torch.bfloat16),
        block(reference, [rounded_copy(m) for m in mlps], compute_dtype=torch.float32),
        inputs, cots)
