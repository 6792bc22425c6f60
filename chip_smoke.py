#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths on one NVIDIA GPU: the inference
and training paths of the cylinder ``epd`` and of the graph transformer,
on the cylinder mesh (NK layout) and on the graded mesh (CSR layout), and
the Transolver++ train step with its gumbel kernel.

    python3 chip_smoke.py        # from the root of a checkout; needs one card

Phases (any failure raises, so the exit code is non-zero):
  1. device: the card's name and power limit (nvidia-smi); TF32 off;
  2. build: nvcc builds every kernel of the port from csrc/ (NK and CSR
     GraphNetBlock, NK and CSR edge attention and gated FFN, each forward
     and backward, and the gumbel perturbation), one process per source,
     all at once; ptxas's registers and spills of the two redesigned
     backwards (gated FFN, NK GraphNetBlock) on lines of their own;
  3. kernel check: each forward variant (folded encoder, middle block,
     last block) against its plain PyTorch version at the slice's shape
     (1,920 nodes x 128 samples x hidden 32, K=6 slots), same bf16 inputs;
  4. backward kernel check: each variant's gradients (dx, de or the folded
     encoder's, every weight) from random bf16 cotangents against the
     plain version's autograd in bf16 and in fp32 (utils/gradcheck.py);
     each variant's time beside its plain backward's;
  5. slice: the B=128 packed eval forward through the kernel path, which
     must launch the kernel once per block, against the plain path;
  6. rollout: 8 windows of one trajectory, 50 steps, kernel path against
     the plain path;
  7. training: 20 train steps of bench.py's configuration (B=128, noise
     σ=0.02, masked L2, AdamW with warmup) on the kernel path, 5 forward
     and 5 backward launches a step, against the same steps on the plain
     path from the same weights and noise;
  8. timing: CUDA-event medians of kernel and plain versions, blocks,
     forward and train step, with the step's device time (torch.profiler)
     and the host's time to enqueue it;
  9. transformer kernel checks, at the transformer slice's shape (1,920
     nodes x 64 samples, hidden 64, 4 heads of 16, K=6): the NK edge
     attention against its plain version on random bf16 q, k, v (and
     exact zeros where a receiver has no valid slot), the gated FFN
     against its plain version with block 0's weights;
 10. transformer slice: the B=64 packed eval forward of the 10-block
     transformer through the kernel path (each kernel once per block)
     against the plain path, then 8 windows x 50 steps of rollout on both
     paths;
 11. transformer timing: both kernels, their plain versions and the
     library's masked attention, one middle block and the forward on
     both paths;
 12. transformer backward kernel checks at the same shape: the attention
     backward and the gated-FFN backward (GELU with block 0's weights, and
     SiLU) against their plain backwards, both against fp32 autograd
     (utils/gradcheck.py); the attention's dk, dv also against plain
     autograd of its forward's plain version; dq exactly 0 where a
     receiver has no valid slot;
 13. transformer training: 20 train steps of scripts/bench_models.py's
     transformer step (B=64, noise σ=0.02, masked L2, AdamW with warmup)
     on the kernel path, 10 forward and 10 backward launches of each
     kernel a step, against the same steps on the plain path;
 14. transformer train timing: each backward kernel, its plain backward,
     the library's masked attention forward + backward, one middle block
     forward + backward and the train step on both paths, with the step's
     device time, the host's time to enqueue a step and the syncs a step
     makes;
 15. layout, on the graded mesh (27,000 nodes, ~160k directed edges, a
     long in-degree tail; its statistics are logged first):
     FusedTopologyManager chooses the CSR layout for it for both model
     families (``epd`` and transformer), and still the NK layout for the
     cylinder;
 16. CSR kernel checks at the graded slices' shapes (27,008 nodes x 16
     samples): each CSR GraphNetBlock variant against its plain version
     on the same bf16 inputs; the CSR attention against its plain version
     (ops/edge_attention.edge_attention), with exact zeros on receivers
     without a valid row; the gated FFN against its plain version on the
     transformer's [27,008, 16, 64] input;
 17. graded slices: the B=16 eval forward of ``epd`` (5 CSR GraphNetBlock
     launches) and of the transformer (10 CSR attention and 10 FFN
     launches) against the plain path, then 8 windows x 50 steps of
     rollout of each on both paths;
 18. graded timing: both CSR kernels, their plain versions and bounds, the
     gated FFN and its plain version at the graded shape, the library's
     masked attention where its dense mask fits, one middle
     block and the forward of each model on both paths;
 19. CSR backward kernel checks at the graded shapes: each CSR
     GraphNetBlock variant's gradients (dx, de or the folded encoder's,
     every weight) from random bf16 cotangents, the CSR attention's (dq
     exactly 0 where a receiver has no valid row) and the gated FFN's at
     [27,008, 16, 64] with a graded block's weights, each against its plain
     backward and fp32 autograd (utils/gradcheck.py);
 20. graded training: 20 train steps of each family at B=16
     (``entry.graded_train_setup``, ``graded_transformer_train_setup``)
     on the kernel path, 5 + 5 CSR GraphNetBlock launches, or 10 + 10 of
     the CSR attention and of the FFN, a step, against the same steps on
     the plain path; peak device memory of each path;
 21. graded train timing: both CSR backward kernels and their plain
     backwards, the library's masked attention forward + backward where it
     fits, one middle block forward + backward of each family and the
     train steps on both paths, with each step's device time and the
     host's time to enqueue it; the gated-FFN backward's time and bound at
     the graded shape;
 22. gumbel kernel check at the Transolver slice's logits [16·2,432, 4, 32]
     (1,920 nodes padded to 2,432 rows, as scripts/bench_models.py's
     graph) and the graded mesh's [16·27,136, 4, 32], bf16: the kernel's Philox
     words equal the plain version's, bit for bit; outputs within 1e-5;
     the gradient is the exact passthrough; over the slice's 5.0M draws
     the noise's mean and std (γ, π/√6), its Kolmogorov-Smirnov statistic
     against the Gumbel CDF, and another key's draw uncorrelated;
 23. Transolver slice (4 blocks, hidden 64, 4 heads, 32 slices, bf16,
     stacked B=16 on the cylinder's 1,920 nodes): the eval forward on both
     paths (no noise, no launch), then 20 train steps of
     ``entry.transolver_train_setup`` on the kernel path, 4 launches a
     step and none in the backward, against the same steps on the plain
     path (the gumbel kernel's plain version on the same keys, so the
     same bits); peak device memory of each path;
 24. Transolver timing: the kernel, its plain version and the torch.rand
     draw (JAX's XLA draw's counterpart) at both shapes with the bound;
     the train steps with the kernel, with the torch.rand draw and on the
     plain path, on the cylinder and on the graded mesh's 27,000 points,
     with the host's time to enqueue a step and the syncs a step makes.
Before the device JSON, the last line, come the card's name and the
kernels' JSON record (launches on the main paths, errors, times, bounds;
the gumbel kernel's ``library_ms`` is the torch.rand draw's time; both
GraphNetBlock backwards add each variant's times under ``variants``, the
gated-FFN backward its profiler device time under ``device_ms`` and its
graded-shape times and bound under ``graded``).
It imports nothing of JAX.
"""

import copy
import json
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda:0"
#: kernel vs plain version, rtol = atol (tests/test_fused_gnblock_nk.py:101-106)
KERNEL_TOL = 0.05
#: kernel path vs plain path of the whole model, rtol = atol, valid nodes
#: (tests/test_fused_gnblock_nk.py:305-308)
SLICE_TOL = 0.15
#: per-trajectory rollout RMSE, kernel path vs plain path, relative
ROLLOUT_RTOL = 0.15
ROLLOUT_WINDOWS = 8
ROLLOUT_STEPS = 50
TRAIN_STEPS = 20
#: step-1 loss, kernel path vs plain path, relative (the JAX suite's value
#: bound, tests/test_fused_gnblock_nk.py:150)
STEP1_LOSS_RTOL = 0.02
#: step-1 gradients, |a - b| <= 0.04 · max|b| over all parameters together
#: (tests/test_fused_gnblock_nk.py:150-156); PERF.md §6 says why not per
#: parameter
STEP1_GRAD_REL = 0.04
#: loss on steps 2..20, kernel path vs plain path, relative: 10x the
#: largest difference of the first run on the card, 9.5e-5 (PERF.md §6)
LATER_LOSS_RTOL = 1e-3
#: attention kernel vs plain version (tests/test_fused_edge_attention_nk.py:96-99)
ATTN_RTOL, ATTN_ATOL = 0.03, 0.02
#: gated-FFN kernel vs plain version, rtol = atol (tests/test_fused_ffn.py:27-30)
FFN_TOL = 0.05
#: transformer kernel path vs plain path, rtol = atol, valid nodes
#: (tests/test_fused_edge_attention_nk.py:171)
TF_SLICE_TOL = 0.1
#: receivers per node block whose slots the empty-receiver check masks out
EMPTY_RECEIVERS = 5
#: the card's published peaks (H100 SXM data sheet, at 700 W): HBM bytes/s
#: and dense bf16 tensor-core FLOP/s
HBM_BYTES_PER_S, BF16_FLOPS = 3.35e12, 989e12
#: the kernels whose ptxas reports (registers, spills) are logged apart:
#: the gated-FFN backward and the NK GraphNetBlock backward's passes
REDESIGNED = ("ffn_bwd_kernel", "gn_nk_bwd_")
FWD = {"name": "fused_gn_block_nk", "source": "graph_physics_tpu_torch/csrc/fused_gnblock_nk.cu",
       "replaces": "graph_physics_tpu/ops/fused_gnblock_nk.py:147"}
BWD = {"name": "fused_gn_block_nk_backward",
       "source": "graph_physics_tpu_torch/csrc/fused_gnblock_nk_bwd.cu",
       "replaces": "graph_physics_tpu/ops/fused_gnblock_nk.py:189"}
ATTN = {"name": "fused_edge_attention_nk",
        "source": "graph_physics_tpu_torch/csrc/fused_edge_attention_nk.cu",
        "replaces": "graph_physics_tpu/ops/fused_edge_attention_nk.py:476"}
FFN = {"name": "fused_gated_ffn", "source": "graph_physics_tpu_torch/csrc/fused_ffn.cu",
       "replaces": "graph_physics_tpu/ops/fused_ffn.py:74"}
ATTN_BWD = {"name": "fused_edge_attention_nk_backward",
            "source": "graph_physics_tpu_torch/csrc/fused_edge_attention_nk_bwd.cu",
            "replaces": "graph_physics_tpu/ops/fused_edge_attention_nk.py:495"}
FFN_BWD = {"name": "fused_gated_ffn_backward",
           "source": "graph_physics_tpu_torch/csrc/fused_ffn_bwd.cu",
           "replaces": "graph_physics_tpu/ops/fused_ffn.py:99"}
GN_CSR = {"name": "fused_gn_block_csr", "source": "graph_physics_tpu_torch/csrc/fused_gnblock_csr.cu",
          "replaces": "graph_physics_tpu/ops/fused_gnblock.py:392"}
ATTN_CSR = {"name": "fused_edge_attention_csr",
            "source": "graph_physics_tpu_torch/csrc/fused_edge_attention_csr.cu",
            "replaces": "graph_physics_tpu/ops/fused_edge_attention.py:124"}
GN_CSR_BWD = {"name": "fused_gn_block_csr_backward",
              "source": "graph_physics_tpu_torch/csrc/fused_gnblock_csr_bwd.cu",
              "replaces": "graph_physics_tpu/ops/fused_gnblock.py:453"}
ATTN_CSR_BWD = {"name": "fused_edge_attention_csr_backward",
                "source": "graph_physics_tpu_torch/csrc/fused_edge_attention_csr_bwd.cu",
                "replaces": "graph_physics_tpu/ops/fused_edge_attention.py:143"}
#: receivers of the graded mesh whose rows the empty-receiver check masks
#: out: every EMPTY_STRIDE-th
EMPTY_STRIDE = 97
GUMBEL = {"name": "gumbel_perturb", "source": "graph_physics_tpu_torch/csrc/gumbel.cu",
          "replaces": "graph_physics_tpu/ops/gumbel.py:51"}
#: gumbel kernel vs plain version on the same bits, max abs: logf on the
#: card against torch.log, at |noise| < 17 (a few fp32 ulps)
GUMBEL_ATOL = 1e-5
#: mean and std of the draws against γ and π/√6, in standard errors of
#: Gumbel(0, 1)'s sample mean and std (σ/√n = 1.2825/√n and, with its
#: excess kurtosis 2.4, σ·√(4.4/4)/√n = 1.345/√n; the larger is taken):
#: 0.0042 over the 5.0M draws of the slice's shape
GUMBEL_MOMENT_SES, GUMBEL_SE_COEFF = 7.0, 1.345
#: Kolmogorov-Smirnov statistic against the Gumbel CDF: the α = 0.001
#: critical value is KS_COEFF / sqrt(draws)
KS_COEFF = 1.949


def log(*args):
    print(*args, flush=True)


def kernel_resources(build_log, keys):
    """{kernel: its ptxas report (registers, spill stores and loads)} for
    the entry functions whose mangled names hold one of ``keys``, from
    nvcc's -Xptxas=-v output."""
    found, current = {}, None
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line.strip()
            current = name if any(k in name for k in keys) else None
            if current:
                found[current] = []
        elif current and ("registers" in line or "spill" in line):
            found[current].append(line.split(":", 1)[-1].strip())
    return {k: "; ".join(v) for k, v in found.items()}


def compare(name, got, want, rtol, rows=None, atol=None):
    """Max abs / rel error; raises unless |got - want| <= atol + rtol·|want|
    (atol = rtol unless given)."""
    import torch

    atol = rtol if atol is None else atol
    got, want = got.float(), want.float()
    if rows is not None:
        got, want = got[rows], want[rows]
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite values")
    diff = (got - want).abs()
    max_abs = diff.max().item()
    big = want.abs() >= atol  # where a relative error means something
    max_rel = (diff[big] / want.abs()[big]).max().item() if big.any() else 0.0
    bad = int((diff > atol + rtol * want.abs()).sum())
    log(f"  {name}: max_abs_err {max_abs:.6g} max_rel_err {max_rel:.6g} where |ref| >= {atol} "
        f"(rtol={rtol}, atol={atol}, {bad} of {diff.numel()} outside)")
    if bad:
        raise AssertionError(f"{name}: {bad} values outside rtol={rtol}, atol={atol}")
    return max_abs


def bound(nbytes, flops):
    """(bound_ms, bound_by): the least time the card could take, the larger
    of the bytes over the HBM rate and the operations over the bf16
    tensor-core peak (the kernels' inputs are bf16)."""
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * flops / BF16_FLOPS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gn_block_work(x, e, edge_mask, blk, backward=False):
    """(bytes, FLOPs) of one middle NK GraphNetBlock on these inputs: x and
    e read, x_out and e_out written (bf16), the fp32 weights read, the slot
    arrays read; the edge MLP on valid slots only, the node MLP on every
    row. The backward also reads both cotangents, writes dx and de (bf16)
    and fp32 weight gradients, and does three times the forward's
    multiply-adds (recompute, input and weight gradients)."""
    n, b, h = x.shape
    rows = e.shape[0]
    acts = 2 * (x.numel() + e.numel())  # bf16 bytes of x and e
    params = sum(p.numel() for p in blk.parameters())
    macs = (int(edge_mask.sum()) * b * sum(d.weight.numel() for d in blk.edge_block.denses)
            + n * b * sum(d.weight.numel() for d in blk.node_block.denses))
    if backward:
        return 3 * acts + 8 * params + 5 * rows, 3 * 2 * macs
    return 2 * acts + 4 * params + 5 * rows, 2 * macs


def ffn_backward_times(kept):
    """The gated-FFN backward's times from the retained graphs of
    ``gradcheck.check_backward``: one autograd call through the kernel by
    CUDA events, its device time by the profiler (a call of a fraction of
    a millisecond is otherwise timed with the host's launch), and the
    plain backward's by CUDA events."""
    import torch

    def grad(k):
        return lambda: torch.autograd.grad(*kept[k], retain_graph=True)

    return {"ms": cuda_ms(grad("kernel")), "device_ms": device_ms(grad("kernel")),
            "plain_ms": cuda_ms(grad("plain"))}


def cuda_ms(fn, warmup=3, reps=20):
    """Median milliseconds of ``fn`` by CUDA events, after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps=20):
    """Device milliseconds per call of ``fn``: the summed time of the CUDA
    kernels ``reps`` calls launch, by torch.profiler. Unlike ``cuda_ms``
    it leaves out the gaps where the device waits for the host, which
    dominate a call of a few microseconds of kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            total_us += getattr(ev, "self_device_time_total", None) or getattr(
                ev, "self_cuda_time_total", 0.0)
    if total_us <= 0:
        raise AssertionError("the profiler recorded no device time")
    return total_us / 1e3 / reps


def check_rollouts(label, res, res_plain):
    """Logs both rollouts' per-trajectory RMSEs; raises unless both are
    finite and the RMSEs agree within ROLLOUT_RTOL."""
    import torch

    rk, rp = res.rmse_all_rollout.tolist(), res_plain.rmse_all_rollout.tolist()
    log(f"{label} rollout rmse_all_rollout (R={ROLLOUT_WINDOWS}, T={ROLLOUT_STEPS}), kernel "
        "path: " + " ".join(f"{v:.6g}" for v in rk))
    log(f"{label} rollout rmse_all_rollout, plain path:  " + " ".join(f"{v:.6g}" for v in rp))
    for name, r in (("kernel", res), ("plain", res_plain)):
        if not (torch.isfinite(r.predictions).all() and torch.isfinite(r.rmse_all_rollout).all()):
            raise AssertionError(f"{label} rollout ({name} path): non-finite values")
    worst = max(abs(a - c) / abs(c) for a, c in zip(rk, rp))
    log(f"  rollout rmse max relative difference {worst:.6g} (limit {ROLLOUT_RTOL})")
    if worst > ROLLOUT_RTOL:
        raise AssertionError(f"{label} rollout RMSE differs by {worst:.4g} relative")


def log_grad_rows(rows):
    """The streams (activation gradients) in full; the weight gradients as
    their worst values; any row out of bounds in full."""
    def line(r):
        if not r.get("finite", True):
            return f"  {r['name']}: non-finite values"
        extra = (f" {r['outside']} of {r['count']} outside rtol=atol=0.05;"
                 if "outside" in r else "")
        return (f"  {r['name']}: max_abs_err {r['max_abs_err']:.6g} |a-b|/max|b| "
                f"{r['rel_to_max']:.6g};{extra} vs fp32: rel L2 kernel {r['kernel_fp32_l2']:.6g} "
                f"plain {r['plain_fp32_l2']:.6g}, max/|max| kernel {r['kernel_fp32_max']:.6g} "
                f"plain {r['plain_fp32_max']:.6g}{'' if r['ok'] else '  <-- OUT OF BOUNDS'}")

    weights = [r for r in rows if "outside" not in r and r.get("finite", True)]
    for r in rows:
        if "outside" in r or not r["ok"]:
            log(line(r))
    if weights:
        def worst(key):
            return max(weights, key=key)

        w = worst(lambda r: r["rel_to_max"])
        l2 = worst(lambda r: r["kernel_fp32_l2"] / max(r["plain_fp32_l2"], 1e-30))
        mx = worst(lambda r: r["kernel_fp32_max"] / max(r["plain_fp32_max"], 1e-30))
        log(f"  {len(weights)} weight gradients: worst |a-b|/max|b| {w['rel_to_max']:.6g} "
            f"({w['name']}); vs fp32, worst kernel/plain rel L2 {l2['kernel_fp32_l2']:.6g}/"
            f"{l2['plain_fp32_l2']:.6g} ({l2['name']}), max {mx['kernel_fp32_max']:.6g}/"
            f"{mx['plain_fp32_max']:.6g} ({mx['name']})")


def launch_counts(k):
    """(forward, backward) launches of a wrapper; a wrapper whose gradient
    needs no kernel has no backward count."""
    return k.launches, getattr(k, "backward_launches", 0)


def reset_counts(kernels):
    for k in kernels:
        k.launches = 0
        if hasattr(k, "backward_launches"):
            k.backward_launches = 0


def batch_size(graph):
    """B of a packed [N, B, F] or stacked [B, N, F] batch."""
    return graph.x.shape[0] if graph.node_type.ndim == 2 else graph.x.shape[1]


def plain_copy(sim):
    """A copy of ``sim`` on the plain path: no edge layout, or, for a
    Transolver, the gumbel kernel's plain version on the same bits."""
    from graph_physics_tpu_torch.models.processors import TransolverProcessor
    from graph_physics_tpu_torch.models.transolver import use_plain_gumbel

    sim = copy.deepcopy(sim)
    if isinstance(sim.model, TransolverProcessor):
        return use_plain_gumbel(sim)
    sim.model.tiling = None
    return sim


def train_run(step, state, sim, graph, seed, n_steps, kernels=()):
    """``n_steps`` train steps of ``sim`` with noise from a generator seeded
    with ``seed``; returns (losses, grad norms, launches per step of each
    wrapper in ``kernels`` as (forward, backward) pairs, and the unclipped
    gradients of step 1 by parameter name)."""
    import torch

    gen = torch.Generator(device=graph.x.device).manual_seed(seed)
    params = dict(sim.named_parameters())
    losses, norms, launches, grads = [], [], [], None
    for i in range(1, n_steps + 1):
        before = [launch_counts(k) for k in kernels]
        m = step(state, graph, gen)
        after = [launch_counts(k) for k in kernels]
        launches.append(tuple((f1 - f0, b1 - b0) for (f0, b0), (f1, b1) in zip(before, after)))
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
        if i == 1:  # undo the clip: g · min(1, clip / norm)
            undo = max(norms[-1] / state.optimizer.grad_clip, 1.0)
            grads = {k: p.grad.float() * undo for k, p in params.items()}
    return losses, norms, launches, grads


def training_phase(label, train, kernels, seed, per_step_want=None):
    """``TRAIN_STEPS`` steps of ``train`` (an entry train setup) on the
    kernel path, counts set to 0 just before, against the same steps on a
    copy whose blocks all take the plain path (``plain_copy``), from the
    same weights and noise. Every wrapper in ``kernels`` must launch
    ``per_step_want`` (forward, backward) times a step, by default once
    forward and once backward per block; the step-1 loss and gradients and
    the later losses must agree. Returns (plain simulator, its state and
    step, {wrapper name: (forward, backward) launches in all})."""
    import torch
    from graph_physics_tpu_torch import entry

    tgraph = train.graph
    if per_step_want is None:
        n_blocks = len(train.simulator.model.processor_list)
        per_step_want = (n_blocks, n_blocks)
    plain_sim = plain_copy(train.simulator)
    plain_state, plain_step = entry.make_trainer(plain_sim)
    fg = step1_fp32_grads(plain_sim, tgraph, seed)
    reset_counts(kernels)
    torch.cuda.reset_peak_memory_stats()
    kl, kn, per_step, kg = train_run(train.train_step, train.state, train.simulator, tgraph,
                                     seed, TRAIN_STEPS, kernels)
    torch.cuda.synchronize()
    launches = {k.__name__: launch_counts(k) for k in kernels}
    peak = {"kernel": torch.cuda.max_memory_allocated()}
    torch.cuda.reset_peak_memory_stats()
    pl, pn, _, pg = train_run(plain_step, plain_state, plain_sim, tgraph, seed, TRAIN_STEPS)
    torch.cuda.synchronize()
    peak["plain"] = torch.cuda.max_memory_allocated()
    log(f"{label} ({TRAIN_STEPS} steps, B={batch_size(tgraph)}): launches per step "
        f"(forward, backward) of {', '.join(launches)}: {sorted(set(per_step))}; in all "
        f"{list(launches.values())}; max_memory_allocated kernel path "
        f"{peak['kernel'] / 2**30:.4f} GiB, plain path {peak['plain'] / 2**30:.4f} GiB")
    log("  loss, kernel path:      " + " ".join(f"{v:.6g}" for v in kl))
    log("  loss, plain path:       " + " ".join(f"{v:.6g}" for v in pl))
    log("  grad_norm, kernel path: " + " ".join(f"{v:.6g}" for v in kn))
    log("  grad_norm, plain path:  " + " ".join(f"{v:.6g}" for v in pn))
    want = tuple(per_step_want for _ in kernels)
    if any(s != want for s in per_step):
        raise AssertionError(f"{label}: expected {per_step_want} (forward, backward) launches "
                             f"of each kernel per train step, got {per_step}")
    if not all(map(lambda v: v == v and abs(v) != float("inf"), kl + kn + pl + pn)):
        raise AssertionError(f"{label}: non-finite loss or gradient norm")
    loss_rel = [abs(a - c) / abs(c) for a, c in zip(kl, pl)]
    log(f"  loss relative difference: step 1 {loss_rel[0]:.6g} (limit {STEP1_LOSS_RTOL}), "
        f"steps 2-{TRAIN_STEPS} max {max(loss_rel[1:]):.6g} (limit {LATER_LOSS_RTOL})")
    names = sorted(pg)
    if sorted(kg) != names or sorted(fg) != names:
        raise AssertionError(f"{label}: the paths have gradients for different parameters")
    flat = {k: torch.cat([g[n].flatten() for n in names]) for k, g in
            (("kernel", kg), ("plain", pg), ("fp32", fg))}
    grad_rel = ((flat["kernel"] - flat["plain"]).abs().max()
                / flat["plain"].abs().max()).item()
    per_param = {n: ((kg[n] - pg[n]).abs().max() / pg[n].abs().max().clamp_min(1e-30)).item()
                 for n in names}
    worst = max(per_param, key=per_param.get)
    l2 = {k: ((flat[k] - flat["fp32"]).norm() / flat["fp32"].norm()).item()
          for k in ("kernel", "plain")}
    log(f"  step-1 gradients over {len(names)} parameters: max |a-b| / max|b| {grad_rel:.6g} "
        f"(limit {STEP1_GRAD_REL}); per parameter at most {per_param[worst]:.6g} ({worst}); "
        f"rel L2 against the fp32 plain path: kernel path {l2['kernel']:.6g}, "
        f"plain path {l2['plain']:.6g}")
    if loss_rel[0] > STEP1_LOSS_RTOL or max(loss_rel[1:]) > LATER_LOSS_RTOL:
        raise AssertionError(f"{label}: loss of the kernel path is off the plain path's")
    if grad_rel > STEP1_GRAD_REL:
        raise AssertionError(f"{label}: step-1 gradients off the plain path's")
    for k, p in train.simulator.named_parameters():
        if not torch.isfinite(p).all():
            raise AssertionError(f"{label}: parameter {k} is not finite")
    return plain_sim, plain_state, plain_step, launches


def step_timing(train, plain_state, plain_step, seed):
    """CUDA-event medians of ``train``'s step (an entry train setup) and of
    the plain path's, the kernel path's device time a step (the profiler's
    sum of its kernels, ``device_ms``), then whether the kernel path's step
    is bound by the host: the host's time to enqueue one step from a
    synchronised start, and the device-to-host synchronisations one step
    makes (logged, not bounded)."""
    import torch

    graph = train.graph
    gen = torch.Generator(device=graph.x.device).manual_seed(seed)
    out = {"train_step_ms": cuda_ms(lambda: train.train_step(train.state, graph, gen),
                                    warmup=2, reps=10),
           "train_step_plain_ms": cuda_ms(lambda: plain_step(plain_state, graph, gen),
                                          warmup=2, reps=10)}
    enqueue = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train.train_step(train.state, graph, gen)
        enqueue.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as syncs:
        warnings.simplefilter("always")
        train.train_step(train.state, graph, gen)
    torch.cuda.set_sync_debug_mode("default")
    out["train_step_host_enqueue_ms"] = statistics.median(enqueue)
    out["train_step_syncs"] = len(syncs)
    out["train_step_device_ms"] = device_ms(lambda: train.train_step(train.state, graph, gen),
                                            reps=5)
    return out


def step1_fp32_grads(sim, graph, seed):
    """Gradients of the first train step's loss (same noise draws, slice
    noise too) on an fp32 copy of ``sim`` on the plain path, by parameter
    name."""
    import torch
    from graph_physics_tpu_torch import entry
    from graph_physics_tpu_torch.training.loss import l2_loss
    from graph_physics_tpu_torch.training.noise import add_noise
    from graph_physics_tpu_torch.training.step import model_uses_gumbel

    sim = plain_copy(sim)
    for m in sim.modules():  # modules that cast to a compute dtype
        if hasattr(m, "dtype"):
            m.dtype = torch.float32
    gen = torch.Generator(device=graph.x.device).manual_seed(seed)
    cfg = entry.NOISE
    g = add_noise(graph, gen, cfg.starts, cfg.ends, cfg.scales)
    with torch.enable_grad():
        out = sim.forward(g, is_training=True,
                          gumbel=gen if model_uses_gumbel(sim.model) else None)
        l2_loss(g, out.net_out, out.target_norm).backward()
    return {k: p.grad.float() for k, p in sim.named_parameters()}


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; it needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT))
    from graph_physics_tpu_torch import entry
    from graph_physics_tpu_torch.ops import fused_gnblock_nk as nk_ops
    from graph_physics_tpu_torch.ops import kernel_build
    from graph_physics_tpu_torch.training.rollout import make_batched_rollout_fn
    from graph_physics_tpu_torch.utils import gradcheck

    kernel = nk_ops.fused_gn_block_nk
    plain = nk_ops.fused_gn_block_nk_reference
    device = torch.device(DEVICE)
    torch.cuda.set_device(device)

    # 1. device
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    # 2. build
    t0 = time.perf_counter()
    build_log = kernel_build.build()
    libs = ", ".join(str(kernel_build.library_path(n).relative_to(ROOT))
                     for n in kernel_build.LIBRARIES)
    log(f"build: {time.perf_counter() - t0:.1f} s -> {libs}")
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line or "Compiling" in line:
            log(f"  {line.strip()}")
    for name, use in kernel_resources(build_log, REDESIGNED).items():
        log(f"ptxas, redesigned kernel {name}: {use}")

    # the slice: model, NK layout, packed B=128 batch, normalizer statistics
    setup = entry.cylinder_setup(device, num_steps=ROLLOUT_WINDOWS + ROLLOUT_STEPS + 1)
    sim, graph, nk = setup.simulator, setup.graph, setup.tiling
    model = sim.model
    n, b = graph.x.shape[:2]
    hidden = model.hidden_size
    log(f"slice: {n} nodes x {b} samples, hidden {hidden}, K={nk.k_slots}, "
        f"{nk.total_rows} slots ({int(graph.edge_mask.sum())} edges), "
        f"{len(model.processor_list)} blocks")

    # 3. kernel check: each variant against its plain version, same inputs
    gen = torch.Generator(device=device).manual_seed(1)

    def randn(*shape, scale=0.5):
        return (torch.randn(shape, generator=gen, device=device) * scale).to(torch.bfloat16)

    x_in = randn(n, b, hidden)
    e_in = randn(nk.total_rows, b, hidden)
    raw_in = randn(nk.total_rows, b, entry.EDGE_INPUT)
    blocks = model.processor_list
    variants = {
        "folded": (blocks[0], raw_in, model.edges_encoder, False),
        "middle": (blocks[1], e_in, None, False),
        "last": (blocks[-1], e_in, None, True),
    }
    valid_slots = graph.edge_mask
    errors, timing = {}, {}
    with torch.inference_mode():
        for name, (blk, e, enc, last) in variants.items():
            args = (x_in, e, graph.senders, graph.edge_mask, blk.edge_block, blk.node_block, nk)
            kw = dict(encoder_params=enc, last_block=last)
            xk, ek = kernel(*args, **kw)
            xp, ep = plain(*args, **kw, compute_dtype=torch.bfloat16)
            torch.cuda.synchronize()
            log(f"kernel check [{name}]")
            err = compare("x_out", xk, xp, KERNEL_TOL)
            if not last:  # padded slots of a folded block hold enc(raw): valid only
                err = max(err, compare("e_out", ek, ep, KERNEL_TOL,
                                       rows=valid_slots if enc is not None else None))
            errors[name] = err
            timing[name] = {"ms": cuda_ms(lambda: kernel(*args, **kw)),
                            "plain_ms": cuda_ms(lambda: plain(*args, **kw,
                                                              compute_dtype=torch.bfloat16))}
            log(f"  time: kernel {timing[name]['ms']:.4f} ms, plain {timing[name]['plain_ms']:.4f} ms"
                f" ({card})")

    # 4. backward kernel check: random cotangents, padded slots included
    bwd_errors, bwd_timing, failed = {}, {}, []
    for name, (blk, e, enc, last) in variants.items():
        cot_x, cot_e = randn(n, b, hidden, scale=1.0), randn(nk.total_rows, b, hidden, scale=1.0)
        before = kernel.backward_launches
        grad_rows, ok, kept = gradcheck.check_block_backward(
            x_in, e, (graph.senders, graph.edge_mask), (enc, blk.edge_block, blk.node_block),
            nk, last, cot_x, cot_e)
        torch.cuda.synchronize()
        log(f"backward kernel check [{name}] ({kernel.backward_launches - before} launch)")
        log_grad_rows(grad_rows)
        if kernel.backward_launches != before + 1:
            raise AssertionError(f"backward [{name}]: the backward kernel did not launch")
        if not ok:
            failed.append(name)
        bwd_errors[name] = max(r.get("max_abs_err", float("inf")) for r in grad_rows)
        bwd_timing[name] = {
            "ms": cuda_ms(lambda: torch.autograd.grad(*kept["kernel"], retain_graph=True)),
            "plain_ms": cuda_ms(lambda: torch.autograd.grad(*kept["plain"], retain_graph=True))}
        log(f"  backward time: kernel {bwd_timing[name]['ms']:.4f} ms, plain "
            f"{bwd_timing[name]['plain_ms']:.4f} ms ({card})")
        del kept
    if failed:
        raise AssertionError(f"backward kernel out of bounds for {failed}")

    # 5. slice: the packed B=128 eval forward through the kernel path
    plain_sim = copy.deepcopy(sim)
    plain_sim.model.tiling = None  # every block on the plain edge-list path
    rows = graph.node_mask
    kernel.launches = kernel.backward_launches = 0
    out = sim.forward(graph, is_training=False)
    torch.cuda.synchronize()
    forward_launches = kernel.launches
    # 6. rollout: R windows of one trajectory, T steps, kernel path
    frames = entry.rollout_frames(setup, range(ROLLOUT_WINDOWS), ROLLOUT_STEPS)
    res = make_batched_rollout_fn(sim)(frames)
    torch.cuda.synchronize()
    infer_launches = kernel.launches
    n_blocks = len(blocks)
    log(f"slice forward: {forward_launches} kernel launches ({n_blocks} blocks); "
        f"with the {ROLLOUT_STEPS}-step rollout: {infer_launches}")
    if forward_launches != n_blocks:
        raise AssertionError(f"expected {n_blocks} launches per forward, got {forward_launches}")
    if infer_launches != n_blocks * (1 + ROLLOUT_STEPS) or kernel.backward_launches:
        raise AssertionError(f"expected {n_blocks * (1 + ROLLOUT_STEPS)} forward and no "
                             f"backward launches, got {infer_launches}, "
                             f"{kernel.backward_launches}")

    out_plain = plain_sim.forward(graph, is_training=False)
    torch.cuda.synchronize()
    if tuple(out.outputs.shape) != (n, b, entry.OUTPUT) or out.outputs.dtype != torch.float32:
        raise AssertionError(f"unexpected output {tuple(out.outputs.shape)} {out.outputs.dtype}")
    log("slice forward vs plain path (valid nodes)")
    compare("net_out", out.net_out, out_plain.net_out, SLICE_TOL, rows=rows)
    compare("outputs", out.outputs, out_plain.outputs, SLICE_TOL, rows=rows)

    check_rollouts("epd", res, make_batched_rollout_fn(plain_sim)(frames))
    log("epd rollout rmse_1step, kernel path: "
        + " ".join(f"{v:.6g}" for v in res.rmse_1step.tolist()))

    # 7. training: bench.py's step, kernel path against the plain path
    train = entry.cylinder_train_setup(device)
    tgraph = train.graph
    _, plain_state, plain_step, train_launches = training_phase("training", train, [kernel], 7)
    train_launches = train_launches[kernel.__name__]

    # 8. timing: one B=128 forward and one train step, kernel path vs plain path
    fwd_ms = cuda_ms(lambda: sim.forward(graph, is_training=False))
    fwd_plain_ms = cuda_ms(lambda: plain_sim.forward(graph, is_training=False))
    log(f"forward B={b}: kernel path {fwd_ms:.4f} ms, plain path {fwd_plain_ms:.4f} ms ({card})")
    st = step_timing(train, plain_state, plain_step, 8)
    tb = tgraph.x.shape[1]
    log(f"train step B={tb}: kernel path {st['train_step_ms']:.4f} ms "
        f"({1000 * tb / st['train_step_ms']:.1f} graph-steps/s; device time "
        f"{st['train_step_device_ms']:.4f} ms; the host enqueues a step in "
        f"{st['train_step_host_enqueue_ms']:.4f} ms), plain path "
        f"{st['train_step_plain_ms']:.4f} ms ({1000 * tb / st['train_step_plain_ms']:.1f} "
        f"graph-steps/s) ({card})")
    log("timing " + json.dumps({"card": card, "forward_ms": fwd_ms, "forward_plain_ms": fwd_plain_ms,
                                **st, "blocks": timing, "backward_blocks": bwd_timing}))

    # 9.-11. the graph transformer's inference path; 12.-14. its train step
    tf_records = transformer_phases(device, card)
    tf_train_records, tf_train_launches = transformer_train_phases(device, card)
    for rec in tf_records:  # the forward kernels also ran in the train steps
        rec["launches"] += tf_train_launches[rec["name"]][0]
    # 15.-18. both models' inference paths on the graded mesh (CSR layout)
    graded_records, graded_ffn_launches, graded_ffn = graded_phases(device, card)
    tf_records[1]["launches"] += graded_ffn_launches
    tf_records[1]["max_abs_err"] = max(tf_records[1]["max_abs_err"],
                                       graded_ffn.pop("max_abs_err"))
    tf_records[1]["graded"] = graded_ffn  # its time and bound at [27,008·16, 64]
    # 19.-21. both models' training steps on the graded mesh (CSR layout)
    graded_train_records, graded_train_launches, graded_ffn_bwd = graded_train_phases(
        device, card)
    # 22.-24. the Transolver++ train step and its gumbel kernel
    gumbel_record = transolver_phases(device, card)
    ffn_name = tf_records[1]["name"]
    for rec in graded_records:  # the CSR forward kernels also ran in the train steps
        rec["launches"] += graded_train_launches[rec["name"]][0]
    tf_records[1]["launches"] += graded_train_launches[ffn_name][0]
    tf_train_records[1]["launches"] += graded_train_launches[ffn_name][1]
    tf_train_records[1]["max_abs_err"] = max(tf_train_records[1]["max_abs_err"],
                                             graded_ffn_bwd.pop("max_abs_err"))
    tf_train_records[1]["graded"] = graded_ffn_bwd  # its time and bound at [27,008·16, 64]

    fwd_bound = bound(*gn_block_work(x_in, e_in, graph.edge_mask, blocks[1]))
    bwd_bound = bound(*gn_block_work(x_in, e_in, graph.edge_mask, blocks[1], backward=True))
    log(f"card: {card}")
    log(json.dumps({"kernels": [
        dict(FWD, route="cuda", launches=infer_launches + train_launches[0],
             max_abs_err=max(errors.values()), ms=timing["middle"]["ms"],
             plain_ms=timing["middle"]["plain_ms"], bound_ms=fwd_bound[0],
             bound_by=fwd_bound[1], library_ms=None),
        dict(BWD, route="cuda", launches=train_launches[1],
             max_abs_err=max(bwd_errors.values()), ms=bwd_timing["middle"]["ms"],
             plain_ms=bwd_timing["middle"]["plain_ms"], bound_ms=bwd_bound[0],
             bound_by=bwd_bound[1], library_ms=None, variants=bwd_timing),
        *tf_records,
        *tf_train_records,
        *graded_records,
        *graded_train_records,
        gumbel_record,
    ]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


def transformer_phases(device, card):
    """Phases 9-11 on the graph transformer of scripts/bench_models.py
    (10 blocks, hidden 64, 4 heads, B=64); returns the kernels' records."""
    import torch
    import torch.nn.functional as F
    from graph_physics_tpu_torch import entry
    from graph_physics_tpu_torch.ops import fused_edge_attention_nk as ea_ops
    from graph_physics_tpu_torch.ops import fused_ffn as ffn_ops
    from graph_physics_tpu_torch.ops import fused_gnblock_nk as nk_ops
    from graph_physics_tpu_torch.training.rollout import make_batched_rollout_fn

    attn, attn_plain = ea_ops.fused_edge_attention_nk, ea_ops.fused_edge_attention_nk_reference
    ffn, ffn_plain = ffn_ops.fused_gated_ffn, ffn_ops.gated_ffn_reference
    gn = nk_ops.fused_gn_block_nk
    setup = entry.transformer_setup(device, num_steps=ROLLOUT_WINDOWS + ROLLOUT_STEPS + 1)
    sim, graph, nk = setup.simulator, setup.graph, setup.tiling
    model = sim.model
    blocks = model.processor_list
    n, b = graph.x.shape[:2]
    hidden = model.hidden_size
    heads = blocks[0].attention.num_heads
    dh = hidden // heads
    n_blocks = len(blocks)
    valid_slots = int(graph.edge_mask.sum())
    log(f"transformer slice: {n} nodes x {b} samples, hidden {hidden}, {heads} heads of {dh}, "
        f"K={nk.k_slots}, {nk.total_rows} slots ({valid_slots} edges), {n_blocks} blocks")

    # 9. kernel checks at the slice's shape, same inputs for kernel and plain version
    gen = torch.Generator(device=device).manual_seed(2)

    def randn(*shape, scale=0.5):
        return (torch.randn(shape, generator=gen, device=device) * scale).to(torch.bfloat16)

    q, k, v = (randn(n, b, heads, dh) for _ in range(3))
    args = (q, k, v, graph.senders, graph.edge_mask, nk)
    blk0 = blocks[0]
    x = randn(n, b, hidden, scale=1.0)
    ffn_args = (x, blk0.gated_mlp, blk0.norm2)
    with torch.inference_mode():
        out = attn(*args)
        torch.cuda.synchronize()
        ref = attn_plain(*args)
        log("attention kernel check")
        attn_err = compare("out", out, ref, ATTN_RTOL, atol=ATTN_ATOL)
        g_, k_, nb_ = nk.num_groups, nk.k_slots, nk.node_block
        mask = graph.edge_mask.clone().view(g_, k_, nb_)
        mask[:, :, :EMPTY_RECEIVERS] = False
        mask = mask.reshape(-1).contiguous()
        out_e = attn(q, k, v, graph.senders, mask, nk)
        torch.cuda.synchronize()
        ref_e = attn_plain(q, k, v, graph.senders, mask, nk)
        attn_err = max(attn_err, compare(f"out, {EMPTY_RECEIVERS} receivers a node block "
                                         "without a valid slot", out_e, ref_e, ATTN_RTOL,
                                         atol=ATTN_ATOL))
        empty = out_e.view(g_, nb_, -1)[:, :EMPTY_RECEIVERS]
        if not torch.equal(empty, torch.zeros_like(empty)):
            raise AssertionError("attention: a receiver without valid slots is not exactly 0")
        log(f"  {g_ * EMPTY_RECEIVERS} receivers without a valid slot: exact zeros")

        y = ffn(*ffn_args)
        torch.cuda.synchronize()
        y_ref = ffn_plain(*ffn_args)
        log("gated FFN kernel check (block 0's weights)")
        ffn_err = compare("y", y, y_ref, FFN_TOL)

        # 11. (kernel part) times of the kernels, their plain versions and
        # the library's masked attention on the same inputs: dense, with
        # the mesh's adjacency as its boolean mask (rows: receivers)
        attn_t = {"ms": cuda_ms(lambda: attn(*args)), "plain_ms": cuda_ms(lambda: attn_plain(*args))}
        adj = torch.zeros((n, n), dtype=torch.bool, device=device)
        ev = graph.edge_mask
        adj[graph.receivers[ev].long(), graph.senders[ev].long()] = True
        qd, kd, vd = (t.permute(1, 2, 0, 3).contiguous() for t in (q, k, v))

        def library():
            return F.scaled_dot_product_attention(qd, kd, vd, attn_mask=adj)

        lib_out = library().permute(2, 0, 1, 3)
        rows = graph.node_mask
        lib_err = (lib_out[rows].float() - ref[rows].float()).abs().max().item()
        attn_t["library_ms"] = cuda_ms(library)
        ffn_t = {"ms": cuda_ms(lambda: ffn(*ffn_args)),
                 "plain_ms": cuda_ms(lambda: ffn_plain(*ffn_args))}
    log(f"  attention time: kernel {attn_t['ms']:.4f} ms, plain {attn_t['plain_ms']:.4f} ms, "
        f"scaled_dot_product_attention with the adjacency mask {attn_t['library_ms']:.4f} ms "
        f"(max abs difference to the plain version {lib_err:.6g}) ({card})")
    log(f"  gated FFN time: kernel {ffn_t['ms']:.4f} ms, plain {ffn_t['plain_ms']:.4f} ms ({card})")
    del lib_out, qd, kd, vd, adj

    # 10. slice: the B=64 forward and the rollout, kernel path, counts from 0
    plain_sim = copy.deepcopy(sim)
    plain_sim.model.tiling = None  # every block on the plain path
    attn.launches = ffn.launches = gn.launches = gn.backward_launches = 0
    out = sim.forward(graph, is_training=False)
    torch.cuda.synchronize()
    fwd_launches = (attn.launches, ffn.launches)
    frames = entry.rollout_frames(setup, range(ROLLOUT_WINDOWS), ROLLOUT_STEPS)
    res = make_batched_rollout_fn(sim)(frames)
    torch.cuda.synchronize()
    launches = (attn.launches, ffn.launches)
    log(f"transformer forward: (attention, FFN) kernel launches {fwd_launches} ({n_blocks} "
        f"blocks); with the {ROLLOUT_STEPS}-step rollout: {launches}")
    if fwd_launches != (n_blocks, n_blocks):
        raise AssertionError(f"expected {n_blocks} launches of each kernel per forward, "
                             f"got {fwd_launches}")
    want = n_blocks * (1 + ROLLOUT_STEPS)
    if launches != (want, want) or gn.launches or gn.backward_launches:
        raise AssertionError(f"expected {want} launches of each transformer kernel and none "
                             f"of the GraphNetBlock's, got {launches}, {gn.launches}, "
                             f"{gn.backward_launches}")

    out_plain = plain_sim.forward(graph, is_training=False)
    torch.cuda.synchronize()
    if tuple(out.outputs.shape) != (n, b, entry.OUTPUT) or out.outputs.dtype != torch.float32:
        raise AssertionError(f"unexpected output {tuple(out.outputs.shape)} {out.outputs.dtype}")
    log("transformer forward vs plain path (valid nodes)")
    rows = graph.node_mask
    compare("net_out", out.net_out, out_plain.net_out, TF_SLICE_TOL, rows=rows)
    compare("outputs", out.outputs, out_plain.outputs, TF_SLICE_TOL, rows=rows)
    check_rollouts("transformer", res, make_batched_rollout_fn(plain_sim)(frames))

    # 11. timing: the B=64 forward and one middle block, kernel path vs plain path
    fwd_ms = cuda_ms(lambda: sim.forward(graph, is_training=False))
    fwd_plain_ms = cuda_ms(lambda: plain_sim.forward(graph, is_training=False))
    mid = blocks[n_blocks // 2]
    block_args = (randn(n, b, hidden, scale=1.0), graph.senders, graph.receivers,
                  graph.edge_mask, graph.node_mask, graph.pos)
    with torch.inference_mode():
        block_ms = cuda_ms(lambda: mid(*block_args, tiling=nk))
        block_plain_ms = cuda_ms(lambda: mid(*block_args))
    log(f"transformer forward B={b}: kernel path {fwd_ms:.4f} ms "
        f"({1000 * b / fwd_ms:.1f} graph-steps/s), plain path {fwd_plain_ms:.4f} ms "
        f"({1000 * b / fwd_plain_ms:.1f}); middle block {block_ms:.4f} ms, plain "
        f"{block_plain_ms:.4f} ms ({card})")
    log("transformer timing " + json.dumps({
        "card": card, "forward_ms": fwd_ms, "forward_plain_ms": fwd_plain_ms,
        "block_ms": block_ms, "block_plain_ms": block_plain_ms, "attention": attn_t,
        "ffn": ffn_t}))

    # bounds from this run's inputs: bf16 q, k, v read and out written, the
    # slot arrays read, q·k and p·v on the valid slots; x read and y written,
    # the fp32 weights read, 3 products of 64 x 192 per row
    attn_bound = bound(2 * 4 * q.numel() + 5 * nk.total_rows,
                       valid_slots * b * heads * 4 * dh)
    ffn_params = sum(p.numel() for p in (*blk0.gated_mlp.parameters(), blk0.norm2.scale))
    ffn_bound = bound(2 * 2 * x.numel() + 4 * ffn_params,
                      2 * n * b * sum(p.numel() for p in (blk0.gated_mlp.gated.linear1.weight,
                                                         blk0.gated_mlp.gated.linear2.weight,
                                                         blk0.gated_mlp.out.weight)))
    log(f"  bounds: attention {attn_bound[0]:.6g} ms ({attn_bound[1]}), gated FFN "
        f"{ffn_bound[0]:.6g} ms ({ffn_bound[1]})")
    return [
        dict(ATTN, route="cuda", launches=launches[0], max_abs_err=attn_err, ms=attn_t["ms"],
             plain_ms=attn_t["plain_ms"], bound_ms=attn_bound[0], bound_by=attn_bound[1],
             library_ms=attn_t["library_ms"]),
        dict(FFN, route="cuda", launches=launches[1], max_abs_err=ffn_err, ms=ffn_t["ms"],
             plain_ms=ffn_t["plain_ms"], bound_ms=ffn_bound[0], bound_by=ffn_bound[1],
             library_ms=None),
    ]


def transformer_train_phases(device, card):
    """Phases 12-14 on the graph transformer's train step
    (scripts/bench_models.py:62-99 for ``transformer_nk``, :142-166: 10
    blocks, hidden 64, 4 heads, B=64); returns the backward kernels'
    records and {wrapper name: (forward, backward) launches} of phase 13."""
    import torch
    import torch.nn.functional as F
    from graph_physics_tpu_torch import entry
    from graph_physics_tpu_torch.models.layers import ACTIVATIONS
    from graph_physics_tpu_torch.ops import fused_edge_attention_nk as ea_ops
    from graph_physics_tpu_torch.ops import fused_ffn as ffn_ops
    from graph_physics_tpu_torch.ops import fused_gnblock_nk as nk_ops
    from graph_physics_tpu_torch.utils import gradcheck

    attn, ffn = ea_ops.fused_edge_attention_nk, ffn_ops.fused_gated_ffn
    train = entry.transformer_train_setup(device)
    sim, graph, nk = train.simulator, train.graph, train.tiling
    blocks = sim.model.processor_list
    n, b = graph.x.shape[:2]
    hidden = sim.model.hidden_size
    heads = blocks[0].attention.num_heads
    dh = hidden // heads
    valid_slots = int(graph.edge_mask.sum())
    senders, mask = graph.senders, graph.edge_mask
    gen = torch.Generator(device=device).manual_seed(3)

    def randn(*shape, scale=0.5):
        return (torch.randn(shape, generator=gen, device=device) * scale).to(torch.bfloat16)

    # 12. backward kernel checks at the slice's shape: each kernel against
    # its plain backward and both against fp32 autograd (utils/gradcheck.py)
    q, k, v = (randn(n, b, heads, dh) for _ in range(3))
    cot = randn(n, b, heads, dh, scale=1.0)

    def attention(fn, m=mask):
        return lambda *qkv: (fn(*qkv, senders, m, nk), [])

    def attention_grads(m):
        """(kernel, plain backward, fp32) gradients and the kernel's and plain
        backward's retained graphs, with ``m`` as the slot mask."""
        before = attn.backward_launches
        gk, kept_k = gradcheck.grads_of(attention(attn, m), (q, k, v), [cot])
        torch.cuda.synchronize()
        if attn.backward_launches != before + 1:
            raise AssertionError("attention: the backward kernel did not launch once")
        gp, kept_p = gradcheck.grads_of(attention(ea_ops.reference_with_backward, m), (q, k, v),
                                        [cot])
        gf, _ = gradcheck.grads_of(attention(ea_ops.fused_edge_attention_nk_reference, m),
                                   (q.float(), k.float(), v.float()), [cot])
        return gk, gp, gf, kept_k, kept_p

    names = ("dq", "dk", "dv")
    gk, gp, gf, kept_k, kept_p = attention_grads(mask)
    rows, ok = gradcheck.compare_grads(names, gk, gp, gf, names)
    log("attention backward kernel check (against the plain backward; both against fp32)")
    log_grad_rows(rows)
    ga, _ = gradcheck.grads_of(attention(ea_ops.fused_edge_attention_nk_reference), (q, k, v),
                               [cot])
    rows_a, ok_a = gradcheck.compare_grads(names[1:], gk[1:], ga[1:], gf[1:], names)
    log("  dk, dv against plain bf16 autograd of the forward's plain version")
    log_grad_rows(rows_a)
    attn_bwd_err = max(r.get("max_abs_err", float("inf")) for r in rows)
    # 14. (kernel part) the backward kernel, its plain backward, and the
    # library's masked attention forward + backward on the same q, k, v
    attn_t = {"ms": cuda_ms(lambda: torch.autograd.grad(*kept_k, retain_graph=True)),
              "plain_ms": cuda_ms(lambda: torch.autograd.grad(*kept_p, retain_graph=True))}
    del kept_k, kept_p, gk, gp, gf, ga
    g_, nb_ = nk.num_groups, nk.node_block
    mask_e = mask.clone().view(g_, nk.k_slots, nb_)
    mask_e[:, :, :EMPTY_RECEIVERS] = False
    mask_e = mask_e.reshape(-1).contiguous()
    ge, gpe, gfe, _, _ = attention_grads(mask_e)
    rows_e, ok_e = gradcheck.compare_grads(names, ge, gpe, gfe, names)
    log(f"  {EMPTY_RECEIVERS} receivers a node block without a valid slot")
    log_grad_rows(rows_e)
    empty = ge[0].view(g_, nb_, -1)[:, :EMPTY_RECEIVERS]
    if not torch.equal(empty, torch.zeros_like(empty)):
        raise AssertionError("attention backward: dq of a receiver without valid slots is not 0")
    log(f"  dq of the {g_ * EMPTY_RECEIVERS} receivers without a valid slot: exact zeros")
    if not (ok and ok_a and ok_e):
        raise AssertionError("attention backward kernel out of bounds")
    del ge, gpe, gfe
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    attn_t["fwd_bwd_ms"] = cuda_ms(
        lambda: torch.autograd.grad(attn(*leaves, senders, mask, nk), leaves, cot))
    adj = torch.zeros((n, n), dtype=torch.bool, device=device)
    adj[graph.receivers[mask].long(), senders[mask].long()] = True
    dense = [t.permute(1, 2, 0, 3).contiguous().requires_grad_(True) for t in (q, k, v)]
    cot_d = cot.permute(1, 2, 0, 3).contiguous()
    attn_t["library_ms"] = cuda_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(*dense, attn_mask=adj), dense, cot_d))
    del adj, dense, cot_d, leaves
    log(f"  attention backward time: kernel {attn_t['ms']:.4f} ms, plain backward "
        f"{attn_t['plain_ms']:.4f} ms; forward + backward: kernels {attn_t['fwd_bwd_ms']:.4f} ms, "
        f"scaled_dot_product_attention with the adjacency mask {attn_t['library_ms']:.4f} ms "
        f"({card})")

    blk0 = blocks[0]
    x = randn(n, b, hidden, scale=1.0)
    cot_x = randn(n, b, hidden, scale=1.0)
    ffn_names = ["dx", "norm2.scale", "norm.scale", "W1", "b1", "W2", "b2", "W3", "b3"]
    silu_mlp = copy.deepcopy(blk0.gated_mlp)
    silu_mlp.gated.use_silu, silu_mlp.gated.act_fn = True, ACTIVATIONS["silu"]

    def feed_forward(fn, mlp, norm2):
        return lambda xx: (fn(xx, mlp, norm2), ffn_ops._params(mlp, norm2))

    ffn_errs = []
    for act, mlp in (("gelu", blk0.gated_mlp), ("silu", silu_mlp)):
        norm2 = blk0.norm2
        before = ffn.backward_launches
        f_rows, f_ok, kept = gradcheck.check_backward(
            ffn_names, ("dx",), feed_forward(ffn, mlp, norm2),
            feed_forward(ffn_ops.reference_with_backward, mlp, norm2),
            feed_forward(ffn_ops.gated_ffn_reference, gradcheck.rounded_copy(mlp),
                         gradcheck.rounded_copy(norm2)), [x], [cot_x])
        torch.cuda.synchronize()
        log(f"gated FFN backward kernel check ({act}, block 0's weights; against the plain "
            f"backward, both against fp32)")
        log_grad_rows(f_rows)
        if ffn.backward_launches != before + 1:
            raise AssertionError("gated FFN: the backward kernel did not launch once")
        if not f_ok:
            raise AssertionError(f"gated FFN backward kernel ({act}) out of bounds")
        ffn_errs.append(max(r.get("max_abs_err", float("inf")) for r in f_rows))
        if act == "gelu":  # 14. (kernel part)
            ffn_t = ffn_backward_times(kept)
        del kept
    log(f"  gated FFN backward time: kernel {ffn_t['ms']:.4f} ms (device time "
        f"{ffn_t['device_ms']:.4f} ms), plain backward {ffn_t['plain_ms']:.4f} ms ({card})")

    # 13. training: 20 steps of the train step, kernel path against the plain path
    gn = nk_ops.fused_gn_block_nk
    gn.launches = gn.backward_launches = 0
    _, plain_state, plain_step, launches = training_phase("transformer training", train,
                                                          [attn, ffn], 9)
    if gn.launches or gn.backward_launches:
        raise AssertionError("transformer training launched the GraphNetBlock kernels")

    # 14. timing: one middle block forward + backward and the train step,
    # kernel path vs plain path
    mid = blocks[len(blocks) // 2]
    xb = randn(n, b, hidden, scale=1.0).requires_grad_(True)
    cot_b = randn(n, b, hidden, scale=1.0)
    wrt = [xb, *mid.parameters()]

    def block_fwd_bwd(tiling):
        y = mid(xb, senders, graph.receivers, mask, graph.node_mask, graph.pos, tiling=tiling)
        return torch.autograd.grad(y, wrt, cot_b)

    block_ms = cuda_ms(lambda: block_fwd_bwd(nk))
    block_plain_ms = cuda_ms(lambda: block_fwd_bwd(None))
    st = step_timing(train, plain_state, plain_step, 10)
    log(f"transformer train step B={b}: kernel path {st['train_step_ms']:.4f} ms "
        f"({1000 * b / st['train_step_ms']:.1f} graph-steps/s; device time "
        f"{st['train_step_device_ms']:.4f} ms; the host enqueues a step in "
        f"{st['train_step_host_enqueue_ms']:.4f} ms, {st['train_step_syncs']} device-to-host "
        f"syncs a step), plain path {st['train_step_plain_ms']:.4f} ms "
        f"({1000 * b / st['train_step_plain_ms']:.1f} graph-steps/s); middle block forward + "
        f"backward {block_ms:.4f} ms, plain {block_plain_ms:.4f} ms ({card})")
    log("transformer train timing " + json.dumps({
        "card": card, **st, "block_fwd_bwd_ms": block_ms,
        "block_fwd_bwd_plain_ms": block_plain_ms, "attention_backward": attn_t,
        "ffn_backward": ffn_t}))

    # bounds from this run's inputs: q, k, v, g_out read and dq, dk, dv
    # written (bf16), the slot arrays read, 5 products of dh per valid slot,
    # sample and head; x, g read and dx written, the fp32 weights read and
    # their gradients written, 8 products of 64 x 192 per row
    attn_bound = bound(2 * 7 * q.numel() + 5 * nk.total_rows, valid_slots * b * heads * 10 * dh)
    ffn_params = ffn_ops._params(blk0.gated_mlp, blk0.norm2)
    ffn_bound = bound(2 * 3 * x.numel() + 8 * sum(p.numel() for p in ffn_params),
                      2 * 8 * n * b * blk0.gated_mlp.gated.linear1.weight.numel())
    log(f"  bounds: attention backward {attn_bound[0]:.6g} ms ({attn_bound[1]}), gated FFN "
        f"backward {ffn_bound[0]:.6g} ms ({ffn_bound[1]})")
    records = [
        dict(ATTN_BWD, route="cuda", launches=launches[attn.__name__][1], max_abs_err=attn_bwd_err,
             ms=attn_t["ms"], plain_ms=attn_t["plain_ms"], bound_ms=attn_bound[0],
             bound_by=attn_bound[1], library_ms=attn_t["library_ms"]),
        dict(FFN_BWD, route="cuda", launches=launches[ffn.__name__][1], max_abs_err=max(ffn_errs),
             ms=ffn_t["ms"], plain_ms=ffn_t["plain_ms"], bound_ms=ffn_bound[0],
             bound_by=ffn_bound[1], library_ms=None, device_ms=ffn_t["device_ms"]),
    ]
    return records, launches


def rollout_pair(label, sim, plain_sim, setup):
    """R windows x T steps of rollout on the kernel path and the plain path,
    held to each other by :func:`check_rollouts`."""
    from graph_physics_tpu_torch import entry
    from graph_physics_tpu_torch.training.rollout import make_batched_rollout_fn

    frames = entry.rollout_frames(setup, range(ROLLOUT_WINDOWS), ROLLOUT_STEPS)
    check_rollouts(label, make_batched_rollout_fn(sim)(frames),
                   make_batched_rollout_fn(plain_sim)(frames))


def graded_phases(device, card):
    """Phases 15-18: the inference paths of ``epd`` (cylinder widths) and
    the graph transformer (10 blocks, hidden 64, 4 heads) on the graded
    mesh at B=16 (scripts/bench_airfoil.py's batch), in the CSR layout.
    Returns the two CSR kernels' records, and the FFN kernel's launches on
    the graded transformer path and its error against its plain version
    at the graded shape."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from graph_physics_tpu_torch import entry
    from graph_physics_tpu_torch.core import mesh as mesh_lib
    from graph_physics_tpu_torch.dataset import synthetic
    from graph_physics_tpu_torch.ops import fused_ffn as ffn_ops
    from graph_physics_tpu_torch.ops import tiling as tiling_lib
    from graph_physics_tpu_torch.ops.edge_attention import edge_attention
    from graph_physics_tpu_torch.ops.fused_edge_attention_csr import fused_edge_attention_csr
    from graph_physics_tpu_torch.ops.fused_edge_attention_nk import fused_edge_attention_nk
    from graph_physics_tpu_torch.ops.fused_ffn import fused_gated_ffn, gated_ffn_reference
    from graph_physics_tpu_torch.ops.fused_gnblock_csr import (
        fused_gn_block_csr,
        fused_gn_block_csr_reference,
    )
    from graph_physics_tpu_torch.ops.fused_gnblock_nk import fused_gn_block_nk
    from graph_physics_tpu_torch.training.fused import FusedTopologyManager

    gn, gn_plain, attn, ffn = (fused_gn_block_csr, fused_gn_block_csr_reference,
                               fused_edge_attention_csr, fused_gated_ffn)
    steps = ROLLOUT_WINDOWS + ROLLOUT_STEPS + 1

    # 15. layout: the graded mesh's statistics, then the manager's choices
    traj = synthetic.make_graded_trajectory(num_steps=2)
    n_valid = traj["mesh_pos"].shape[1]
    ei = mesh_lib.faces_to_edges(traj["cells"][0], n_valid)
    deg = np.bincount(ei[1], minlength=n_valid)
    log(f"graded mesh: {n_valid} nodes, {ei.shape[1]} directed edges, in-degree {deg.min()} to "
        f"{deg.max()} (mean {deg.mean():.4g}, 99th percentile {np.percentile(deg, 99):.4g})")
    cylinder = entry.frame_graph(synthetic.make_trajectory(48, 40, num_steps=2), 0)
    graded = entry.frame_graph(traj, 0)
    for family in ("epd", "transformer"):
        for name, g, want in (("graded", graded, tiling_lib.CSRLayout),
                              ("cylinder", cylinder, tiling_lib.NKTiling)):
            got = FusedTopologyManager(family).layout_for(g)
            log(f"layout [{family}] {name}: {type(got).__name__} ({got.total_rows} rows for "
                f"{int(g.edge_mask.sum())} edges)")
            if not isinstance(got, want):
                raise AssertionError(f"layout [{family}]: {name} took {type(got).__name__}, "
                                     f"expected {want.__name__}")
    del traj, cylinder, graded

    setup = entry.graded_setup(device, num_steps=steps)
    tsetup = entry.graded_transformer_setup(device, num_steps=steps)
    sim, graph, csr = setup.simulator, setup.graph, setup.tiling
    model = sim.model
    n, b = graph.x.shape[:2]
    hidden = model.hidden_size
    valid = int(graph.edge_mask.sum())
    log(f"graded epd slice: {n} nodes x {b} samples, hidden {hidden}, {csr.total_rows} CSR rows "
        f"({valid} edges), {len(model.processor_list)} blocks")

    # 16. CSR kernel checks: each variant against its plain version, same inputs
    gen = torch.Generator(device=device).manual_seed(5)

    def randn(*shape, scale=0.5):
        return (torch.randn(shape, generator=gen, device=device) * scale).to(torch.bfloat16)

    x_in = randn(n, b, hidden)
    e_in = randn(csr.total_rows, b, hidden)
    raw_in = randn(csr.total_rows, b, entry.EDGE_INPUT)
    blocks = model.processor_list
    variants = {
        "folded": (blocks[0], raw_in, model.edges_encoder, False),
        "middle": (blocks[1], e_in, None, False),
        "last": (blocks[-1], e_in, None, True),
    }
    errors, timing = {}, {}
    with torch.inference_mode():
        for name, (blk, e, enc, last) in variants.items():
            args = (x_in, e, graph.senders, graph.receivers, graph.edge_mask, blk.edge_block,
                    blk.node_block, csr)
            kw = dict(encoder_params=enc, last_block=last)
            xk, ek = gn(*args, **kw)
            torch.cuda.synchronize()
            xp, ep = gn_plain(*args, **kw, compute_dtype=torch.bfloat16)
            log(f"CSR GraphNetBlock kernel check [{name}]")
            err = compare("x_out", xk, xp, KERNEL_TOL)
            if not last:  # padding rows included: both keep e_in there
                err = max(err, compare("e_out", ek, ep, KERNEL_TOL))
            errors[name] = err
            timing[name] = {"ms": cuda_ms(lambda: gn(*args, **kw)),
                            "plain_ms": cuda_ms(lambda: gn_plain(*args, **kw,
                                                                 compute_dtype=torch.bfloat16))}
            log(f"  time: kernel {timing[name]['ms']:.4f} ms, plain "
                f"{timing[name]['plain_ms']:.4f} ms ({card})")
        del xk, ek, xp, ep

        tsim, tgraph, tcsr = tsetup.simulator, tsetup.graph, tsetup.tiling
        tblocks = tsim.model.processor_list
        heads = tblocks[0].attention.num_heads
        dh = tsim.model.hidden_size // heads
        q, k, v = (randn(n, b, heads, dh) for _ in range(3))
        ta = (tgraph.senders, tgraph.receivers)
        out = attn(q, k, v, *ta, tgraph.edge_mask, tcsr)
        torch.cuda.synchronize()
        ref = edge_attention(q, k, v, *ta, tgraph.edge_mask)
        log("CSR attention kernel check")
        attn_err = compare("out", out, ref, ATTN_RTOL, atol=ATTN_ATOL)
        gone = torch.arange(0, n, EMPTY_STRIDE, device=device)
        mask_e = tgraph.edge_mask & ~torch.isin(tgraph.receivers, gone)
        out_e = attn(q, k, v, *ta, mask_e, tcsr)
        torch.cuda.synchronize()
        ref_e = edge_attention(q, k, v, *ta, mask_e)
        attn_err = max(attn_err, compare(f"out, every {EMPTY_STRIDE}th receiver without a valid "
                                         "row", out_e, ref_e, ATTN_RTOL, atol=ATTN_ATOL))
        empty = torch.cat([out_e[gone], out_e[~tgraph.node_mask]])
        if not torch.equal(empty, torch.zeros_like(empty)):
            raise AssertionError("CSR attention: a receiver without valid rows is not exactly 0")
        log(f"  {len(gone)} receivers with their rows masked out and "
            f"{int((~tgraph.node_mask).sum())} padding nodes: exact zeros")
        del out_e, ref_e, mask_e

        tx = randn(n, b, tsim.model.hidden_size, scale=1.0)
        ffn_args = (tx, tblocks[0].gated_mlp, tblocks[0].norm2)
        y = ffn(*ffn_args)
        torch.cuda.synchronize()
        y_ref = gated_ffn_reference(*ffn_args)
        log("gated FFN kernel check at the graded shape (block 0's weights)")
        ffn_err = compare("y", y, y_ref, FFN_TOL)
        del y, y_ref

    # 17. graded slices: the B=16 forwards and the rollouts, counts from 0
    plain_sim = copy.deepcopy(sim)
    plain_sim.model.tiling = None  # every block on the plain edge-list path
    others = (fused_gn_block_nk, fused_edge_attention_nk)
    for kern in (gn, attn, ffn, *others):
        kern.launches = 0
    with torch.no_grad():
        out = sim.forward(graph, is_training=False)
    torch.cuda.synchronize()
    fwd_launches = gn.launches
    log(f"graded epd forward: {fwd_launches} CSR GraphNetBlock launches ({len(blocks)} blocks)")
    if fwd_launches != len(blocks):
        raise AssertionError(f"expected {len(blocks)} CSR GraphNetBlock launches per forward, "
                             f"got {fwd_launches}")
    with torch.no_grad():
        out_plain = plain_sim.forward(graph, is_training=False)
    rows = graph.node_mask
    if tuple(out.outputs.shape) != (n, b, entry.OUTPUT) or out.outputs.dtype != torch.float32:
        raise AssertionError(f"unexpected output {tuple(out.outputs.shape)} {out.outputs.dtype}")
    log("graded epd forward vs plain path (valid nodes)")
    compare("net_out", out.net_out, out_plain.net_out, SLICE_TOL, rows=rows)
    compare("outputs", out.outputs, out_plain.outputs, SLICE_TOL, rows=rows)
    rollout_pair("graded epd", sim, plain_sim, setup)  # the plain rollout launches none
    gn_launches = gn.launches
    if gn_launches != len(blocks) * (1 + ROLLOUT_STEPS):
        raise AssertionError(f"expected {len(blocks) * ROLLOUT_STEPS} CSR GraphNetBlock launches "
                             f"in the rollout, got {gn_launches - fwd_launches}")

    t_plain = copy.deepcopy(tsim)
    t_plain.model.tiling = None
    attn.launches = ffn.launches = 0
    with torch.no_grad():
        tout = tsim.forward(tgraph, is_training=False)
    torch.cuda.synchronize()
    t_fwd = (attn.launches, ffn.launches)
    log(f"graded transformer forward: (CSR attention, FFN) launches {t_fwd} "
        f"({len(tblocks)} blocks)")
    if t_fwd != (len(tblocks), len(tblocks)):
        raise AssertionError(f"expected {len(tblocks)} launches of each kernel, got {t_fwd}")
    with torch.no_grad():
        tout_plain = t_plain.forward(tgraph, is_training=False)
    log("graded transformer forward vs plain path (valid nodes)")
    compare("net_out", tout.net_out, tout_plain.net_out, TF_SLICE_TOL, rows=rows)
    compare("outputs", tout.outputs, tout_plain.outputs, TF_SLICE_TOL, rows=rows)
    rollout_pair("graded transformer", tsim, t_plain, tsetup)
    want = len(tblocks) * (1 + ROLLOUT_STEPS)
    t_launches = (attn.launches, ffn.launches)
    if t_launches != (want, want) or any(k.launches for k in others) or \
            gn.launches != gn_launches:
        raise AssertionError(f"expected {want} launches of each graded transformer kernel and "
                             f"no other, got {t_launches}")

    # 18. timing: the kernels, their plain versions, the library's masked
    # attention, a middle block and the forward of each model, both paths
    with torch.inference_mode():
        attn_args = (q, k, v, *ta, tgraph.edge_mask)
        attn_t = {"ms": cuda_ms(lambda: attn(*attn_args, tcsr)),
                  "plain_ms": cuda_ms(lambda: edge_attention(*attn_args)),
                  "library_ms": None}
        ffn_t = {"ms": cuda_ms(lambda: ffn(*ffn_args)),
                 "plain_ms": cuda_ms(lambda: gated_ffn_reference(*ffn_args))}
        adj = qd = None
        try:  # dense [N, N] adjacency as the mask: 0.73 GB as bool
            adj = torch.zeros((n, n), dtype=torch.bool, device=device)
            ev = tgraph.edge_mask
            adj[tgraph.receivers[ev].long(), tgraph.senders[ev].long()] = True
            qd, kd, vd = (t.permute(1, 2, 0, 3).contiguous() for t in (q, k, v))
            attn_t["library_ms"] = cuda_ms(
                lambda: F.scaled_dot_product_attention(qd, kd, vd, attn_mask=adj), reps=5)
            lib_note = f"{attn_t['library_ms']:.4f} ms"
        except RuntimeError as exc:  # out of memory, or no kernel for the mask
            lib_note = f"does not run on the card ({str(exc).splitlines()[0]})"
        del adj, qd
        torch.cuda.empty_cache()
        mid, tmid = blocks[len(blocks) // 2], tblocks[len(tblocks) // 2]
        gblk = (x_in, e_in, graph.senders, graph.receivers, graph.edge_mask)
        tblk = (tx, tgraph.senders, tgraph.receivers, tgraph.edge_mask, tgraph.node_mask,
                tgraph.pos)
        blocks_t = {"epd_block_ms": cuda_ms(lambda: mid(*gblk, tiling=csr)),
                    "epd_block_plain_ms": cuda_ms(lambda: mid(*gblk)),
                    "transformer_block_ms": cuda_ms(lambda: tmid(*tblk, tiling=tcsr)),
                    "transformer_block_plain_ms": cuda_ms(lambda: tmid(*tblk))}
        fwd = {"epd_forward_ms": cuda_ms(lambda: sim.forward(graph, is_training=False)),
               "epd_forward_plain_ms": cuda_ms(lambda: plain_sim.forward(graph,
                                                                          is_training=False)),
               "transformer_forward_ms": cuda_ms(lambda: tsim.forward(tgraph, is_training=False)),
               "transformer_forward_plain_ms": cuda_ms(
                   lambda: t_plain.forward(tgraph, is_training=False))}
    log(f"  CSR attention time: kernel {attn_t['ms']:.4f} ms, plain {attn_t['plain_ms']:.4f} ms, "
        f"scaled_dot_product_attention with the adjacency mask: {lib_note} ({card})")
    log(f"  gated FFN time at the graded shape: kernel {ffn_t['ms']:.4f} ms, plain "
        f"{ffn_t['plain_ms']:.4f} ms ({card})")
    log(f"graded forward B={b}: epd kernel path {fwd['epd_forward_ms']:.4f} ms "
        f"({1000 * b / fwd['epd_forward_ms']:.1f} graph-steps/s), plain "
        f"{fwd['epd_forward_plain_ms']:.4f} ms; transformer kernel path "
        f"{fwd['transformer_forward_ms']:.4f} ms ({1000 * b / fwd['transformer_forward_ms']:.1f}"
        f" graph-steps/s), plain {fwd['transformer_forward_plain_ms']:.4f} ms; middle blocks: "
        f"epd {blocks_t['epd_block_ms']:.4f} / {blocks_t['epd_block_plain_ms']:.4f} ms, "
        f"transformer {blocks_t['transformer_block_ms']:.4f} / "
        f"{blocks_t['transformer_block_plain_ms']:.4f} ms ({card})")
    log("graded timing " + json.dumps({"card": card, **fwd, **blocks_t, "gn_blocks": timing,
                                       "attention": attn_t, "ffn": ffn_t, "library": lib_note}))

    # bounds from this run's inputs: the CSR block as gn_block_work with the
    # row pointers read and the first layer's receiver and sender parts done
    # per node; the attention's q, k, v read and out written (bf16), the row
    # arrays read, q·k and p·v on the valid rows
    nbytes, flops = gn_block_work(x_in, e_in, graph.edge_mask, blocks[1])
    first = 2 * hidden * hidden  # the x_recv and x_send parts of the first layer
    flops -= 2 * b * first * (valid - n)
    gn_bound = bound(nbytes + 4 * (n + 1), flops)
    attn_bound = bound(2 * 4 * q.numel() + 5 * tcsr.total_rows + 4 * (n + 1),
                       valid * b * heads * 4 * dh)
    # the gated FFN as phase 11's bound: x read and y written (bf16), the fp32
    # weights read, 3 products of 64 x 192 a row
    mlp0 = tblocks[0].gated_mlp
    ffn_params = ffn_ops._params(mlp0, tblocks[0].norm2)
    ffn_t["bound_ms"], ffn_t["bound_by"] = bound(
        2 * 2 * tx.numel() + 4 * sum(p.numel() for p in ffn_params),
        2 * n * b * sum(w.numel() for w in (mlp0.gated.linear1.weight,
                                             mlp0.gated.linear2.weight, mlp0.out.weight)))
    log(f"  bounds: CSR GraphNetBlock {gn_bound[0]:.6g} ms ({gn_bound[1]}), CSR attention "
        f"{attn_bound[0]:.6g} ms ({attn_bound[1]}), gated FFN at the graded shape "
        f"{ffn_t['bound_ms']:.6g} ms ({ffn_t['bound_by']})")
    records = [
        dict(GN_CSR, route="cuda", launches=gn_launches, max_abs_err=max(errors.values()),
             ms=timing["middle"]["ms"], plain_ms=timing["middle"]["plain_ms"],
             bound_ms=gn_bound[0], bound_by=gn_bound[1], library_ms=None),
        dict(ATTN_CSR, route="cuda", launches=t_launches[0], max_abs_err=attn_err,
             ms=attn_t["ms"], plain_ms=attn_t["plain_ms"], bound_ms=attn_bound[0],
             bound_by=attn_bound[1], library_ms=attn_t["library_ms"]),
    ]
    return records, t_launches[1], dict(ffn_t, max_abs_err=ffn_err)


def graded_train_phases(device, card):
    """Phases 19-21: the training steps of ``epd`` (cylinder widths) and
    the graph transformer (10 blocks, hidden 64, 4 heads) on the graded
    mesh at B=16, in the CSR layout. Returns the two CSR backward
    kernels' records, {wrapper name: (forward, backward) launches} of the
    phase-20 runs, and the gated-FFN backward's numbers at the graded
    shape: its error against its plain backward, its time, its plain
    backward's and its bound."""
    import torch
    import torch.nn.functional as F
    from graph_physics_tpu_torch import entry
    from graph_physics_tpu_torch.ops import fused_edge_attention_csr as ea_ops
    from graph_physics_tpu_torch.ops import fused_ffn as ffn_ops
    from graph_physics_tpu_torch.ops import fused_gnblock_csr as gn_ops
    from graph_physics_tpu_torch.ops.edge_attention import edge_attention
    from graph_physics_tpu_torch.utils import gradcheck

    gn, attn, ffn = (gn_ops.fused_gn_block_csr, ea_ops.fused_edge_attention_csr,
                     ffn_ops.fused_gated_ffn)
    train = entry.graded_train_setup(device)
    ttrain = entry.graded_transformer_train_setup(device)
    sim, graph, csr = train.simulator, train.graph, train.tiling
    tsim, tgraph, tcsr = ttrain.simulator, ttrain.graph, ttrain.tiling
    model, blocks, tblocks = sim.model, sim.model.processor_list, tsim.model.processor_list
    n, b = graph.x.shape[:2]
    hidden, thidden = model.hidden_size, tsim.model.hidden_size
    heads = tblocks[0].attention.num_heads
    dh = thidden // heads
    valid = int(graph.edge_mask.sum())
    gen = torch.Generator(device=device).manual_seed(11)

    def randn(*shape, scale=0.5):
        return (torch.randn(shape, generator=gen, device=device) * scale).to(torch.bfloat16)

    # 19. backward kernel checks at the graded shapes: each CSR GraphNetBlock
    # variant, the CSR attention and the gated FFN against their plain
    # backwards, all against fp32 autograd (utils/gradcheck.py)
    x_in, e_in = randn(n, b, hidden), randn(csr.total_rows, b, hidden)
    raw_in = randn(csr.total_rows, b, entry.EDGE_INPUT)
    variants = {
        "folded": (blocks[0], raw_in, model.edges_encoder, False),
        "middle": (blocks[1], e_in, None, False),
        "last": (blocks[-1], e_in, None, True),
    }
    rows3 = (graph.senders, graph.receivers, graph.edge_mask)
    gn_errors, gn_t, failed = {}, {}, []
    for name, (blk, e, enc, last) in variants.items():
        cot_x, cot_e = randn(n, b, hidden, scale=1.0), randn(csr.total_rows, b, hidden, scale=1.0)
        before = gn.backward_launches
        grad_rows, ok, kept = gradcheck.check_block_backward(
            x_in, e, rows3, (enc, blk.edge_block, blk.node_block), csr, last, cot_x, cot_e)
        torch.cuda.synchronize()
        log(f"CSR GraphNetBlock backward kernel check [{name}] "
            f"({gn.backward_launches - before} launch)")
        log_grad_rows(grad_rows)
        if gn.backward_launches != before + 1:
            raise AssertionError(f"CSR backward [{name}]: the backward kernel did not launch")
        if not ok:
            failed.append(name)
        gn_errors[name] = max(r.get("max_abs_err", float("inf")) for r in grad_rows)
        gn_t[name] = {
            "ms": cuda_ms(lambda: torch.autograd.grad(*kept["kernel"], retain_graph=True)),
            "plain_ms": cuda_ms(lambda: torch.autograd.grad(*kept["plain"], retain_graph=True))}
        log(f"  backward time: kernel {gn_t[name]['ms']:.4f} ms, plain "
            f"{gn_t[name]['plain_ms']:.4f} ms ({card})")
        del kept
    if failed:
        raise AssertionError(f"CSR GraphNetBlock backward kernel out of bounds for {failed}")

    q, k, v = (randn(n, b, heads, dh) for _ in range(3))
    cot = randn(n, b, heads, dh, scale=1.0)
    ta = (tgraph.senders, tgraph.receivers)
    gone = torch.arange(0, n, EMPTY_STRIDE, device=device)
    names = ("dq", "dk", "dv")
    attn_err, attn_t = 0.0, {}
    for label, m in (("", tgraph.edge_mask),
                     (f", every {EMPTY_STRIDE}th receiver without a valid row",
                      tgraph.edge_mask & ~torch.isin(tgraph.receivers, gone))):
        def attention(fn, m=m):
            return lambda *qkv: (fn(*qkv, *ta, m, tcsr), [])

        before = attn.backward_launches
        # the plain backward is plain autograd of edge_attention
        a_rows, ok, kept = gradcheck.check_backward(
            names, names, attention(attn), attention(ea_ops.reference_with_backward),
            lambda *qkv, m=m: (edge_attention(*qkv, *ta, m), []), (q, k, v), [cot])
        torch.cuda.synchronize()
        log(f"CSR attention backward kernel check{label} (against autograd of edge_attention; "
            "both against fp32)")
        log_grad_rows(a_rows)
        if attn.backward_launches != before + 1:
            raise AssertionError("CSR attention: the backward kernel did not launch once")
        if not ok:
            raise AssertionError(f"CSR attention backward kernel out of bounds{label}")
        attn_err = max([attn_err] + [r.get("max_abs_err", float("inf")) for r in a_rows])
        if not label:  # 21. (kernel part)
            attn_t = {"ms": cuda_ms(lambda: torch.autograd.grad(*kept["kernel"],
                                                                retain_graph=True)),
                      "plain_ms": cuda_ms(lambda: torch.autograd.grad(*kept["plain"],
                                                                      retain_graph=True))}
        else:
            dq = torch.autograd.grad(*kept["kernel"], retain_graph=True)[0]
            empty = torch.cat([dq[gone], dq[~tgraph.node_mask]])
            if not torch.equal(empty, torch.zeros_like(empty)):
                raise AssertionError("CSR attention backward: dq of a receiver without valid "
                                     "rows is not exactly 0")
            log(f"  dq of the {len(gone)} receivers with their rows masked out and of the "
                f"{int((~tgraph.node_mask).sum())} padding nodes: exact zeros")
        del kept

    blk0 = tblocks[0]
    tx, cot_t = randn(n, b, thidden, scale=1.0), randn(n, b, thidden, scale=1.0)
    ffn_names = ["dx", "norm2.scale", "norm.scale", "W1", "b1", "W2", "b2", "W3", "b3"]

    def feed_forward(fn, mlp, norm2):
        return lambda xx: (fn(xx, mlp, norm2), ffn_ops._params(mlp, norm2))

    before = ffn.backward_launches
    f_rows, f_ok, kept = gradcheck.check_backward(
        ffn_names, ("dx",), feed_forward(ffn, blk0.gated_mlp, blk0.norm2),
        feed_forward(ffn_ops.reference_with_backward, blk0.gated_mlp, blk0.norm2),
        feed_forward(ffn_ops.gated_ffn_reference, gradcheck.rounded_copy(blk0.gated_mlp),
                     gradcheck.rounded_copy(blk0.norm2)), [tx], [cot_t])
    torch.cuda.synchronize()
    log("gated FFN backward kernel check at the graded shape (block 0's weights; against the "
        "plain backward, both against fp32)")
    log_grad_rows(f_rows)
    if ffn.backward_launches != before + 1:
        raise AssertionError("gated FFN: the backward kernel did not launch once")
    if not f_ok:
        raise AssertionError("gated FFN backward kernel out of bounds at the graded shape")
    ffn_t = ffn_backward_times(kept)
    del kept
    # its bound as phase 14's: x, g read and dx written (bf16), the fp32
    # weights read and their gradients written, 8 products of 64 x 192 a row
    ffn_params = ffn_ops._params(blk0.gated_mlp, blk0.norm2)
    ffn_t["bound_ms"], ffn_t["bound_by"] = bound(
        2 * 3 * tx.numel() + 8 * sum(p.numel() for p in ffn_params),
        2 * 8 * n * b * blk0.gated_mlp.gated.linear1.weight.numel())
    ffn_t["max_abs_err"] = max(r.get("max_abs_err", float("inf")) for r in f_rows)
    log(f"  gated FFN backward time at the graded shape: kernel {ffn_t['ms']:.4f} ms (device "
        f"time {ffn_t['device_ms']:.4f} ms), plain backward {ffn_t['plain_ms']:.4f} ms, bound "
        f"{ffn_t['bound_ms']:.6g} ms ({ffn_t['bound_by']}) ({card})")

    # 20. graded training: 20 steps of each family, kernel path against the
    # plain path, counts from 0 just before each
    _, plain_state, plain_step, launches = training_phase("graded epd training", train, [gn], 12)
    _, t_plain_state, t_plain_step, t_launches = training_phase(
        "graded transformer training", ttrain, [attn, ffn], 13)
    launches.update(t_launches)

    # 21. timing: a middle block forward + backward of each family and the
    # train steps on both paths; the library's masked attention forward +
    # backward over the dense adjacency, where it fits
    mid, tmid = blocks[len(blocks) // 2], tblocks[len(tblocks) // 2]
    xb = randn(n, b, hidden).requires_grad_(True)
    eb = randn(csr.total_rows, b, hidden).requires_grad_(True)
    txb = randn(n, b, thidden, scale=1.0).requires_grad_(True)
    cots = (randn(n, b, hidden, scale=1.0), randn(csr.total_rows, b, hidden, scale=1.0))
    cot_tb = randn(n, b, thidden, scale=1.0)
    wrt, twrt = [xb, eb, *mid.parameters()], [txb, *tmid.parameters()]

    def epd_block(tiling):
        return torch.autograd.grad(mid(xb, eb, *rows3, tiling=tiling), wrt, cots)

    def tf_block(tiling):
        y = tmid(txb, *ta, tgraph.edge_mask, tgraph.node_mask, tgraph.pos, tiling=tiling)
        return torch.autograd.grad(y, twrt, cot_tb)

    blocks_t = {"epd_block_fwd_bwd_ms": cuda_ms(lambda: epd_block(csr)),
                "epd_block_fwd_bwd_plain_ms": cuda_ms(lambda: epd_block(None)),
                "transformer_block_fwd_bwd_ms": cuda_ms(lambda: tf_block(tcsr)),
                "transformer_block_fwd_bwd_plain_ms": cuda_ms(lambda: tf_block(None))}
    steps = {"epd": step_timing(train, plain_state, plain_step, 14),
             "transformer": step_timing(ttrain, t_plain_state, t_plain_step, 15)}
    for fam, st in steps.items():
        log(f"graded {fam} train step B={b}: kernel path {st['train_step_ms']:.4f} ms "
            f"({1000 * b / st['train_step_ms']:.1f} graph-steps/s; device time "
            f"{st['train_step_device_ms']:.4f} ms; the host enqueues a step in "
            f"{st['train_step_host_enqueue_ms']:.4f} ms, {st['train_step_syncs']} "
            f"device-to-host syncs a step), plain path {st['train_step_plain_ms']:.4f} ms "
            f"({1000 * b / st['train_step_plain_ms']:.1f} graph-steps/s) ({card})")
    log(f"  middle blocks forward + backward: epd {blocks_t['epd_block_fwd_bwd_ms']:.4f} / "
        f"{blocks_t['epd_block_fwd_bwd_plain_ms']:.4f} ms, transformer "
        f"{blocks_t['transformer_block_fwd_bwd_ms']:.4f} / "
        f"{blocks_t['transformer_block_fwd_bwd_plain_ms']:.4f} ms (kernel / plain) ({card})")
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    attn_t["fwd_bwd_ms"] = cuda_ms(
        lambda: torch.autograd.grad(attn(*leaves, *ta, tgraph.edge_mask, tcsr), leaves, cot))
    attn_t["library_ms"] = None
    adj = dense = cot_d = None
    try:  # dense [N, N] adjacency as the mask: 0.73 GB as bool
        adj = torch.zeros((n, n), dtype=torch.bool, device=device)
        ev = tgraph.edge_mask
        adj[tgraph.receivers[ev].long(), tgraph.senders[ev].long()] = True
        dense = [t.permute(1, 2, 0, 3).contiguous().requires_grad_(True) for t in (q, k, v)]
        cot_d = cot.permute(1, 2, 0, 3).contiguous()
        attn_t["library_ms"] = cuda_ms(lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(*dense, attn_mask=adj), dense, cot_d), reps=5)
        lib_note = f"{attn_t['library_ms']:.4f} ms"
    except RuntimeError as exc:  # out of memory, or no kernel for the mask
        lib_note = f"does not run on the card ({str(exc).splitlines()[0]})"
        attn_t["library_note"] = lib_note
    del adj, dense, cot_d, leaves
    torch.cuda.empty_cache()
    log(f"  CSR attention backward: kernel {attn_t['ms']:.4f} ms, plain backward "
        f"{attn_t['plain_ms']:.4f} ms; forward + backward: kernels {attn_t['fwd_bwd_ms']:.4f} ms, "
        f"scaled_dot_product_attention with the adjacency mask: {lib_note} ({card})")
    log("graded train timing " + json.dumps({
        "card": card, **{f"{fam}_{k}": v for fam, st in steps.items() for k, v in st.items()},
        **blocks_t, "gn_backward": gn_t, "attention_backward": attn_t,
        "ffn_backward": ffn_t}))

    # bounds from this run's inputs: the CSR block's backward as
    # gn_block_work's, with the forward's aggregate, the row pointers and
    # the transpose read and the first layer's receiver and sender parts
    # done per node; the attention
    # backward's q, k, v, g_out read and dq, dk, dv written (bf16), the row
    # arrays and the transpose read, 5 products of dh per valid row, sample
    # and head
    nbytes, flops = gn_block_work(x_in, e_in, graph.edge_mask, blocks[1], backward=True)
    flops -= 3 * 2 * b * 2 * hidden * hidden * (valid - n)
    gn_bound = bound(nbytes + 2 * x_in.numel() + 4 * (n + 1) * 2 + 4 * valid, flops)
    attn_bound = bound(2 * 7 * q.numel() + 9 * tcsr.total_rows + 8 * (n + 1) + 4 * valid,
                       valid * b * heads * 10 * dh)
    log(f"  bounds: CSR GraphNetBlock backward {gn_bound[0]:.6g} ms ({gn_bound[1]}), CSR "
        f"attention backward {attn_bound[0]:.6g} ms ({attn_bound[1]})")
    records = [
        dict(GN_CSR_BWD, route="cuda", launches=launches[gn.__name__][1],
             max_abs_err=max(gn_errors.values()), ms=gn_t["middle"]["ms"],
             plain_ms=gn_t["middle"]["plain_ms"], bound_ms=gn_bound[0], bound_by=gn_bound[1],
             library_ms=None, variants=gn_t),
        dict(ATTN_CSR_BWD, route="cuda", launches=launches[attn.__name__][1],
             max_abs_err=attn_err, ms=attn_t["ms"], plain_ms=attn_t["plain_ms"],
             bound_ms=attn_bound[0], bound_by=attn_bound[1], library_ms=attn_t["library_ms"]),
    ]
    return records, launches, ffn_t



def transolver_phases(device, card):
    """Phases 22-24: the gumbel kernel at the Transolver slice's logits
    [16·2,432, 4, 32] and at the graded mesh's [16·27,136, 4, 32], the
    B=16 Transolver++ eval forward and train step
    (``entry.transolver_train_setup``: 4 blocks, hidden 64, 4 heads, 32
    slices) on the kernel path against the plain path on the same bits,
    and their times. Returns the kernel's record."""
    import math

    import torch
    from graph_physics_tpu_torch import entry
    from graph_physics_tpu_torch.ops import gumbel as gumbel_ops

    kernel = gumbel_ops.gumbel_perturb
    train = entry.transolver_train_setup(device)
    gtrain = entry.transolver_train_setup(device, graded=True)
    sim, graph = train.simulator, train.graph
    blocks = sim.model.model.blocks
    heads, slices = blocks[0].Attn.heads, blocks[0].Attn.slice_num
    b, n = graph.x.shape[:2]
    gn = gtrain.graph.x.shape[1]
    log(f"Transolver slice: B={b} x {n} nodes (graded: {gn} points), hidden "
        f"{sim.model.model.placeholder.numel()}, {heads} heads, {slices} slices, "
        f"{len(blocks)} blocks, stacked [B, N, F]")
    gen = torch.Generator(device=device).manual_seed(22)
    shapes = {"slice": (b * n, heads, slices), "graded": (b * gn, heads, slices)}

    # 22. the kernel against its plain version on the same key: the same
    # bits, outputs within GUMBEL_ATOL; the noise's distribution; other
    # keys; the passthrough gradient
    errors = {}
    for label, shape in shapes.items():
        x = torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
        key = gumbel_ops.draw_key(gen, device)
        count = x.numel()
        out = kernel(x, key)
        torch.cuda.synchronize()
        same_bits = torch.equal(gumbel_ops.philox_bits(count, key),
                                gumbel_ops.random_bits(count, key))
        log(f"gumbel kernel check [{label}] {list(shape)} bf16 ({count} draws): the kernel's "
            f"Philox words equal the plain version's: {same_bits}")
        if not same_bits:
            raise AssertionError(f"gumbel [{label}]: the kernel's random bits differ")
        errors[label] = compare("out", out, gumbel_ops.gumbel_perturb_reference(x, key), 0.0,
                                atol=GUMBEL_ATOL)
        xg = x.clone().requires_grad_(True)
        cot = torch.randn(shape, generator=gen, device=device)
        (grad,) = torch.autograd.grad(kernel(xg, key), xg, cot)
        if not torch.equal(grad, cot.to(torch.bfloat16)):
            raise AssertionError(f"gumbel [{label}]: the gradient is not the exact passthrough")
        log("  gradient: the exact passthrough cot.to(bf16)")
        if label != "slice":
            continue
        g = kernel(torch.zeros_like(x), key).flatten().double()
        other = kernel(torch.zeros_like(x), gumbel_ops.draw_key(gen, device)).flatten().double()
        mean, std = g.mean().item(), g.std().item()
        srt = torch.sort(g).values
        cdf = torch.exp(-torch.exp(-srt))
        i = torch.arange(1, count + 1, device=device, dtype=torch.float64)
        ks = max((i / count - cdf).max().item(), (cdf - (i - 1) / count).max().item())
        corr = torch.corrcoef(torch.stack([g, other]))[0, 1].item()
        ks_limit, corr_limit = KS_COEFF / math.sqrt(count), 5.0 / math.sqrt(count)
        moment_limit = GUMBEL_MOMENT_SES * GUMBEL_SE_COEFF / math.sqrt(count)
        gamma, sigma = 0.5772156649, math.pi / math.sqrt(6.0)
        log(f"  noise over {count} draws: mean {mean:.6f} (γ {gamma:.6f}), std {std:.6f} "
            f"(π/√6 {sigma:.6f}; limit ±{moment_limit:.4g} each), KS against the Gumbel CDF "
            f"{ks:.6g} (limit {ks_limit:.6g}), correlation with another key's draw "
            f"{corr:.3g} (limit {corr_limit:.3g})")
        if abs(mean - gamma) > moment_limit or abs(std - sigma) > moment_limit:
            raise AssertionError("gumbel: the noise's mean or std is off Gumbel(0, 1)'s")
        if ks > ks_limit or abs(corr) > corr_limit or torch.equal(g, other):
            raise AssertionError("gumbel: the noise is not Gumbel(0, 1) or two keys agree")
        del g, other, srt, cdf, i
    del x, xg, out, grad, cot
    torch.cuda.empty_cache()

    # 23. the B=16 eval forward on both paths (no noise, no launch), then 20
    # train steps on the kernel path, 4 launches a step, against the plain
    # path on the same bits
    base = entry.transolver_setup(device)
    plain_eval = plain_copy(base.simulator)
    reset_counts([kernel])
    with torch.inference_mode():
        out = base.simulator.forward(base.graph, is_training=False)
        ref = plain_eval.forward(base.graph, is_training=False)
    torch.cuda.synchronize()
    if tuple(out.outputs.shape) != (b, n, entry.OUTPUT) or out.outputs.dtype != torch.float32:
        raise AssertionError(f"unexpected output {tuple(out.outputs.shape)} {out.outputs.dtype}")
    log(f"Transolver eval forward B={b}: {kernel.launches} gumbel launches (eval draws no "
        "noise); kernel path vs plain path (valid nodes)")
    if kernel.launches:
        raise AssertionError("the Transolver eval forward launched the gumbel kernel")
    compare("outputs", out.outputs, ref.outputs, TF_SLICE_TOL, rows=base.graph.node_mask)
    fwd_ms = cuda_ms(lambda: base.simulator.forward(base.graph, is_training=False))
    del base, plain_eval, out, ref
    _, plain_state, plain_step, launches = training_phase(
        "Transolver training", train, [kernel], 23, per_step_want=(len(blocks), 0))

    # 24. times: the kernel, its plain version and the torch.rand draw at
    # both shapes; the train steps with the kernel, with the torch.rand
    # draw and on the plain path, at both sizes
    draw_t = {}
    for label, shape in shapes.items():
        x = torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
        key = gumbel_ops.draw_key(gen, device)

        def torch_rand_draw():  # the counterpart of JAX's XLA draw (transolver.py:57-59)
            u = torch.rand(shape, generator=gen, device=device)
            return x.float() + gumbel_ops.gumbel_noise(u)

        bnd = bound(x.numel() * (2 + 4), 0)
        fns = {"": lambda: kernel(x, key),
               "plain_": lambda: gumbel_ops.gumbel_perturb_reference(x, key),
               "torch_rand_": torch_rand_draw}
        t = {"bound_ms": bnd[0], "bound_by": bnd[1]}
        for name, fn in fns.items():
            t[f"{name}ms"] = device_ms(fn)
            t[f"{name}call_ms"] = cuda_ms(fn)
        draw_t[label] = t
        log(f"gumbel [{label}] {list(shape)}, device time (call time by CUDA events): kernel "
            f"{t['ms']:.4f} ({t['call_ms']:.4f}) ms, plain version {t['plain_ms']:.4f} "
            f"({t['plain_call_ms']:.4f}) ms, torch.rand draw {t['torch_rand_ms']:.4f} "
            f"({t['torch_rand_call_ms']:.4f}) ms; bound {t['bound_ms']:.6g} ms ({t['bound_by']}) "
            f"({card})")
        del x
    steps = {}
    for label, setup in (("slice", train), ("graded", gtrain)):
        if label == "slice":
            p_state, p_step = plain_state, plain_step
        else:
            p_state, p_step = entry.make_trainer(plain_copy(setup.simulator))
        st = step_timing(setup, p_state, p_step, 24)
        rand = entry.transolver_train_setup(device, fused_gumbel=False, graded=label == "graded")
        st["train_step_torch_rand_ms"] = cuda_ms(
            lambda: rand.train_step(rand.state, rand.graph, gen), warmup=2, reps=10)
        steps[label] = st
        bb = batch_size(setup.graph)
        log(f"Transolver train step [{label}] B={bb} x {setup.graph.x.shape[1]} nodes: gumbel "
            f"kernel {st['train_step_ms']:.4f} ms ({1000 * bb / st['train_step_ms']:.1f} "
            f"graph-steps/s; the host enqueues a step in {st['train_step_host_enqueue_ms']:.4f} "
            f"ms, {st['train_step_syncs']} device-to-host syncs a step), torch.rand draw "
            f"{st['train_step_torch_rand_ms']:.4f} ms, plain path {st['train_step_plain_ms']:.4f}"
            f" ms ({card})")
        del rand, p_state, p_step
        torch.cuda.empty_cache()
    faster = "kernel" if draw_t["slice"]["ms"] < draw_t["slice"]["torch_rand_ms"] else "torch.rand"
    log(f"  the faster draw at the slice's shape: {faster}; eval forward B={b} {fwd_ms:.4f} ms")
    log("transolver timing " + json.dumps({"card": card, "forward_ms": fwd_ms, "draw": draw_t,
                                           "steps": steps}))
    t = draw_t["slice"]
    return dict(GUMBEL, route="cuda", launches=launches[kernel.__name__][0],
                max_abs_err=max(errors.values()), ms=t["ms"], plain_ms=t["plain_ms"],
                bound_ms=t["bound_ms"], bound_by=t["bound_by"], library_ms=t["torch_rand_ms"])


if __name__ == "__main__":
    main()
