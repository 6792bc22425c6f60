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
33-61 and 100-128). The plain bf16 backward runs with PyTorch's
deterministic algorithms (``index_add_`` on a card then sums in a fixed
order, not by atomics), so the reference the kernel is held to is the
same on every run.

A GraphNetBlock's relu MLPs are H wide, and one flip moves a whole
H-wide message: at its receiver and its sender (P_r, P_s) every one of dx's
H values for that sample, and de's H values of the row; and a row has 3H
relu units where a flip can happen. dx gathers the flips of every row a
node receives or sends on, de those of its own row. So dx's share grows
with H, and ``check_block_backward`` allows ``BLOCK_OUTSIDE_SHARE`` of dx
by the width (de: ``OUTSIDE_SHARE``). Each lies between two readings on a
card (PERF.md §6): the kernel's largest dx share, and that of a control,
the fp32 gradient (none of the plain backward's bf16 roundings). At
hidden 32, 64 and 128 (``scripts/block_fp32_error.py``; the cases of
``tests/test_torch_cuda.py::
test_wide_backward_share_separates_the_kernel_from_the_fp32_control``,
six seeds on a hub graph, folded and middle block) the share exceeds the
kernel's 1.16 (H=32), 4.1 (H=64) and 4.7 (H=128) times, and the
control's is at least 533, 244 and 199 times it. At hidden 16 to 2
(``test_small_backward_share_separates_the_kernel_from_the_fp32_control``,
three seeds on the hub graph and the NK mesh) the kernel leaves the bound
on no dx value, and the control on 5 to 250 times the share at each
width; at hidden 1 on none either (each MLP's RMSNorm tail of one value
passes no gradient, so dx is g_xout in every version). The L2 and max
bounds against fp32 keep their ratios at every width.

A caller may name stream values to be judged against the fp32 gradient
instead (``fp32_judged``: a boolean mask per stream): there the kernel
may leave the 0.05 bound around the fp32 gradient on no more values than
the plain version does. At a receiver of very high in-degree (a hub),
two bf16 backwards of equal accuracy each disagree with the fp32
gradient on a quarter of the hub's values, and with each other on more
than the share allows; the fp32 gradient is the one reference both are
held to there.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from graph_physics_tpu_torch.ops import fused_gnblock_csr as csr_ops
from graph_physics_tpu_torch.ops import fused_gnblock_nk as nk_ops
from graph_physics_tpu_torch.ops.tiling import CSRLayout

STREAM_TOL = 0.05
OUTSIDE_SHARE = 1e-4
#: the share of a GraphNetBlock's dx values that may leave the bound
#: around the plain backward, by hidden width (the module's docstring)
BLOCK_OUTSIDE_SHARE = {1: OUTSIDE_SHARE, 2: OUTSIDE_SHARE, 4: OUTSIDE_SHARE, 8: OUTSIDE_SHARE,
                       16: OUTSIDE_SHARE, 32: OUTSIDE_SHARE, 64: 4e-4, 128: 8e-4}
WEIGHT_REL = 0.04
FP32_L2_RATIO = 1.1
FP32_MAX_RATIO = 1.5


def block_outside_share(hidden: int) -> float:
    """The share of a GraphNetBlock's dx values that may leave the bound
    around the plain backward at ``hidden`` (the module's docstring says
    why it grows with the width)."""
    return BLOCK_OUTSIDE_SHARE[hidden]


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


def _outside(a: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Where ``a`` leaves the stream bound around ``ref``."""
    return (a - ref).abs() > STREAM_TOL + STREAM_TOL * ref.abs()


def compare_grads(names, kernel, plain, fp32, streams: Sequence[str],
                  fp32_judged: Optional[Dict[str, torch.Tensor]] = None,
                  outside_share: Optional[Dict[str, float]] = None,
                  noise: Sequence[str] = ()) -> Tuple[List[Dict], bool]:
    """One row per gradient with the errors that the bounds above read,
    and whether every row is inside them. ``streams`` names the
    activation gradients; the others are weights. ``fp32_judged`` maps a
    stream to the mask of its values judged against the fp32 gradient;
    ``outside_share`` maps a stream to the share of its values that may
    leave the bound around the plain version (others: ``OUTSIDE_SHARE``).
    ``noise`` names weight gradients that are 0 in exact arithmetic and
    rounding noise in every bf16 backward (``check_block_backward`` at
    hidden 1): each is held to WEIGHT_REL of the largest plain weight
    gradient of the call, with no ratio against the fp32 gradient (noise
    against noise)."""
    fp32_judged = fp32_judged or {}
    floor = max((p.abs().max().item() for name, p in zip(names, plain) if name not in streams),
                default=0.0)
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
            judged = fp32_judged.get(name)
            rest = torch.ones_like(diff, dtype=torch.bool) if judged is None else ~judged
            row["outside"] = int(_outside(k, p)[rest].sum())
            row["count"] = int(rest.sum())
            # the control: the fp32 gradient, which keeps none of the plain
            # version's bf16 roundings, scored as the kernel is
            row["fp32_outside"] = int(_outside(f, p)[rest].sum())
            share = (outside_share or {}).get(name, OUTSIDE_SHARE)
            good = row["outside"] <= share * row["count"]
            if judged is not None:
                row["fp32_judged"] = int(judged.sum())
                row["outside_all"] = int(_outside(k, p).sum())  # the judged values too
                row["kernel_outside_fp32"] = int(_outside(k, f)[judged].sum())
                row["plain_outside_fp32"] = int(_outside(p, f)[judged].sum())
                good = good and row["kernel_outside_fp32"] <= row["plain_outside_fp32"]
        elif name in noise:
            row["noise_floor"] = floor
            row["rel_to_floor"] = diff.max().item() / max(floor, 1e-3)
            good = row["rel_to_floor"] <= WEIGHT_REL
        else:
            good = row["rel_to_max"] <= WEIGHT_REL
        if name not in noise:
            good = (good
                    and row["kernel_fp32_l2"] <= FP32_L2_RATIO * row["plain_fp32_l2"] + 1e-3
                    and row["kernel_fp32_max"] <= FP32_MAX_RATIO * row["plain_fp32_max"] + 1e-3)
        row["ok"] = good
        ok = ok and good
        rows.append(row)
    return rows, ok


@contextlib.contextmanager
def deterministic():
    """PyTorch's deterministic algorithms inside the block (a warning, not
    an error, for an op that has none), the caller's setting after it."""
    was = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn_only)


def check_backward(names: Sequence[str], streams: Sequence[str], kernel_fn: Callable,
                   plain_fn: Callable, fp32_fn: Callable, inputs: Sequence[torch.Tensor],
                   cots: Sequence[torch.Tensor],
                   fp32_judged: Optional[Dict[str, torch.Tensor]] = None,
                   outside_share: Optional[Dict[str, float]] = None, noise: Sequence[str] = ()):
    """Gradients of one function through the kernel (``kernel_fn``), its
    plain version in bf16 (``plain_fn``, under :func:`deterministic`) and
    in fp32 (``fp32_fn``, given the inputs as fp32), each as
    :func:`grads_of` takes it, compared by :func:`compare_grads`. Returns (rows, ok, {"kernel": kept, "plain":
    kept}) with the retained autograd graphs."""
    gk, kept_k = grads_of(kernel_fn, inputs, cots)
    with deterministic():
        gp, kept_p = grads_of(plain_fn, inputs, cots)
    gf, _ = grads_of(fp32_fn, [t.float() for t in inputs], cots)
    rows, ok = compare_grads(names, gk, gp, gf, streams, fp32_judged, outside_share, noise)
    return rows, ok, {"kernel": kept_k, "plain": kept_p}


def check_block_backward(x, e, rows, mlps, layout, last_block, cot_x, cot_e,
                         fp32_judged=None, extra=None):
    """:func:`check_backward` of one GraphNetBlock with ``mlps`` =
    (encoder or None, edge MLP, node MLP), from the cotangents of x_out
    and (unless on the last block) e_out. The layout's type picks the
    block: on an NKTiling ``fused_gn_block_nk`` with ``rows`` = (senders,
    edge_mask), on a CSRLayout ``fused_gn_block_csr`` with ``rows`` =
    (senders, receivers, edge_mask), each against its plain version.
    ``extra``: an extra aggregate [N, B, H] (bf16) the block adds to its
    own (``extra_agg``). Gradients: dx, de unless the encoder is folded
    (raw edge features take none), dea (the extra aggregate's) with
    ``extra``, then every MLP parameter in the kernels' order.
    ``fp32_judged`` goes to :func:`compare_grads`; dx's outside share is
    :func:`block_outside_share` of the width, and so is dea's (the node
    MLP's relu flips move both, H values at a time), de's
    ``OUTSIDE_SHARE``. At hidden 1 each MLP's RMSNorm tail turns its one
    value into ±scale, so the gradient of every Dense layer before it is 0
    in exact arithmetic and rounding noise in each bf16 backward: those
    are ``noise`` gradients of :func:`compare_grads`, the scales' are
    held as at every width."""
    if isinstance(layout, CSRLayout):
        fn, reference = csr_ops.fused_gn_block_csr, csr_ops.fused_gn_block_csr_reference
    else:
        fn, reference = nk_ops.fused_gn_block_nk, nk_ops.fused_gn_block_nk_reference
    enc = mlps[0]

    def block(fn, mlps_, **kw):
        def run(xx, *rest):
            rest = list(rest)
            if enc is None:
                e_in = rest.pop(0)
            else:  # raw features, no gradient
                e_in = e if xx.dtype == torch.bfloat16 else e.float()
            xo, eo = fn(xx, e_in, *rows, mlps_[1], mlps_[2], layout, encoder_params=mlps_[0],
                        last_block=last_block, extra_agg=rest[0] if rest else None, **kw)
            params = [p for m in mlps_ if m is not None for p in nk_ops._mlp_params(m)]
            return (xo if last_block else (xo, eo)), params
        return run

    names = ["dx"] + (["de"] if enc is None else []) + (["dea"] if extra is not None else [])
    noise = []
    for tag, mlp in zip(("enc", "edge", "node"), mlps):
        if mlp is not None:
            mine = [f"{tag}.{i}" for i in range(len(nk_ops._mlp_params(mlp)))]
            names += mine
            if x.shape[-1] == 1 and mlp.norm is not None:
                noise += mine[:-1]
    inputs = [x] + ([e] if enc is None else []) + ([extra] if extra is not None else [])
    cots = [cot_x] + ([] if last_block else [cot_e])
    share = block_outside_share(x.shape[-1])
    return check_backward(
        names, ("dx", "de", "dea"), block(fn, mlps),
        block(reference, mlps, compute_dtype=torch.bfloat16),
        block(reference, [rounded_copy(m) for m in mlps], compute_dtype=torch.float32),
        inputs, cots, fp32_judged, {"dx": share, "dea": share}, noise)
