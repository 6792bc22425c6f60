"""Gradients of one NK GraphNetBlock, and the bounds that hold the backward
kernel against the plain version's autograd on a card.

Two bf16 backwards of the same block disagree in a few values however
carefully they round: where a pre-activation lies within a bf16 rounding
of zero, one side's relu passes the cotangent and the other's stops it,
and the two dx or de values then differ by a whole term. The plain
version has as many such values against the fp32 gradient as the kernel
has. So the streams dx and de are held to the JAX suite's bound
(rtol = atol = 0.05, tests/test_fused_gnblock_nk.py:101-106) on all but
``OUTSIDE_SHARE`` of their values, and both versions are held against the
fp32 gradient of the same bf16 inputs and bf16-rounded weights: the
kernel's relative L2 error and its largest error there may not exceed the
plain version's by more than ``FP32_L2_RATIO`` and ``FP32_MAX_RATIO``.
Weight gradients are fp32 sums over every slot and sample; they meet the
JAX suite's bound ``|a - b| <= 0.04 · max|b|``
(tests/test_fused_gnblock_nk.py:150-156). The kernel adds them with fp32
atomics, so their last bits change from run to run.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Tuple

import torch

from graph_physics_tpu_torch.ops import fused_gnblock_nk as nk_ops

STREAM_TOL = 0.05
OUTSIDE_SHARE = 1e-4
WEIGHT_REL = 0.04
FP32_L2_RATIO = 1.1
FP32_MAX_RATIO = 1.5


def rounded_copy(mlp):
    """A copy of ``mlp`` whose fp32 parameters hold their bf16 values (the
    kernels use the weights as bf16), for an fp32 reference."""
    if mlp is None:
        return None
    mlp = copy.deepcopy(mlp)
    with torch.no_grad():
        for p in mlp.parameters():
            p.copy_(p.to(torch.bfloat16).float())
    return mlp


def block_grads(fn, x, e, senders, edge_mask, mlps, nk, last_block, cot_x, cot_e,
                **kw) -> Tuple[List[str], List[torch.Tensor], tuple]:
    """(names, gradients, kept) of Σ x_out·cot_x + Σ e_out·cot_e (no e_out
    term on the last block) through ``fn``, one NK block with ``mlps`` =
    (encoder or None, edge MLP, node MLP). Gradients, as fp32: dx, de
    unless the encoder is folded, then every MLP parameter in the kernels'
    order. ``kept`` = (outputs, inputs, cotangents) with the graph
    retained, so a caller can time the backward again with
    ``torch.autograd.grad(*kept, retain_graph=True)``."""
    enc, edge, node = mlps
    xx = x.detach().clone().requires_grad_(True)
    ee = e.detach().clone().requires_grad_(enc is None)
    xo, eo = fn(xx, ee, senders, edge_mask, edge, node, nk, encoder_params=enc,
                last_block=last_block, **kw)
    outs, cots = [xo], [cot_x.to(xo.dtype)]
    if not last_block:
        outs.append(eo)
        cots.append(cot_e.to(eo.dtype))
    names, inputs = ["dx"], [xx]
    if enc is None:
        names.append("de")
        inputs.append(ee)
    for tag, mlp in zip(("enc", "edge", "node"), mlps):
        if mlp is None:
            continue
        params = nk_ops._mlp_params(mlp)
        names += [f"{tag}.{i}" for i in range(len(params))]
        inputs += params
    grads = torch.autograd.grad(outs, inputs, cots, retain_graph=True)
    return names, [g.float() for g in grads], (outs, inputs, cots)


def _rel_l2(a: torch.Tensor, ref: torch.Tensor) -> float:
    return ((a - ref).norm() / ref.norm().clamp_min(1e-30)).item()


def compare_block_grads(names, kernel, plain, fp32) -> Tuple[List[Dict], bool]:
    """One row per gradient with the errors that the bounds above read,
    and whether every row is inside them."""
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
        if name in ("dx", "de"):
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


def check_block_backward(x, e, senders, edge_mask, mlps, nk, last_block, cot_x, cot_e):
    """Gradients of one block through the kernel wrapper, the plain
    version in bf16 and the plain version in fp32 (bf16-rounded weights,
    the same bf16 inputs), compared by :func:`compare_block_grads`.
    Returns (rows, ok, {"kernel": kept, "plain": kept}) with the retained
    autograd graphs of :func:`block_grads`."""
    args = (x, e, senders, edge_mask)
    names, gk, kept_k = block_grads(nk_ops.fused_gn_block_nk, *args, mlps, nk, last_block,
                                    cot_x, cot_e)
    _, gp, kept_p = block_grads(nk_ops.fused_gn_block_nk_reference, *args, mlps, nk,
                                last_block, cot_x, cot_e, compute_dtype=torch.bfloat16)
    _, gf, _ = block_grads(nk_ops.fused_gn_block_nk_reference, x.float(), e.float(), senders,
                           edge_mask, [rounded_copy(m) for m in mlps], nk, last_block,
                           cot_x, cot_e, compute_dtype=torch.float32)
    rows, ok = compare_block_grads(names, gk, gp, gf)
    return rows, ok, {"kernel": kept_k, "plain": kept_p}
