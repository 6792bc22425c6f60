#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths on one NVIDIA GPU: the cylinder
``epd`` inference and training paths and the graph-transformer inference
path.

    python3 chip_smoke.py        # from the root of a checkout; needs one card

Phases (any failure raises, so the exit code is non-zero):
  1. device: the card's name and power limit (nvidia-smi); TF32 off;
  2. build: nvcc builds every kernel of the port from csrc/ (NK
     GraphNetBlock forward and backward, NK edge attention, gated FFN),
     one process per source, all at once;
  3. kernel check: each forward variant (folded encoder, middle block,
     last block) against its plain PyTorch version at the slice's shape
     (1,920 nodes x 128 samples x hidden 32, K=6 slots), same bf16 inputs;
  4. backward kernel check: each variant's gradients (dx, de or the folded
     encoder's, every weight) from random bf16 cotangents against the
     plain version's autograd in bf16 and in fp32 (utils/gradcheck.py);
  5. slice: the B=128 packed eval forward through the kernel path, which
     must launch the kernel once per block, against the plain path;
  6. rollout: 8 windows of one trajectory, 50 steps, kernel path against
     the plain path;
  7. training: 20 train steps of bench.py's configuration (B=128, noise
     σ=0.02, masked L2, AdamW with warmup) on the kernel path, 5 forward
     and 5 backward launches a step, against the same steps on the plain
     path from the same weights and noise;
  8. timing: CUDA-event medians of kernel and plain versions, blocks,
     forward and train step;
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
     both paths.
Before the device JSON, the last line, come the card's name and the
kernels' JSON record (launches on the main paths, errors, times, bounds).
It imports nothing of JAX.
"""

import copy
import json
import statistics
import subprocess
import sys
import time
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


def log(*args):
    print(*args, flush=True)


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


def log_grad_rows(rows):
    """dx and de in full; the weight gradients as their worst values; any
    row out of bounds in full."""
    def line(r):
        if not r.get("finite", True):
            return f"  {r['name']}: non-finite values"
        extra = (f" {r['outside']} of {r['count']} outside rtol=atol=0.05;"
                 if "outside" in r else "")
        return (f"  {r['name']}: max_abs_err {r['max_abs_err']:.6g} |a-b|/max|b| "
                f"{r['rel_to_max']:.6g};{extra} vs fp32: rel L2 kernel {r['kernel_fp32_l2']:.6g} "
                f"plain {r['plain_fp32_l2']:.6g}, max/|max| kernel {r['kernel_fp32_max']:.6g} "
                f"plain {r['plain_fp32_max']:.6g}{'' if r['ok'] else '  <-- OUT OF BOUNDS'}")

    weights = [r for r in rows if r["name"] not in ("dx", "de") and r.get("finite", True)]
    for r in rows:
        if r["name"] in ("dx", "de") or not r["ok"]:
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


def train_run(step, state, sim, graph, seed, n_steps, kernel=None):
    """``n_steps`` train steps of ``sim`` with noise from a generator seeded
    with ``seed``; returns (losses, grad norms, launches per step as
    (forward, backward) when ``kernel`` is the wrapper, and the unclipped
    gradients of step 1 by parameter name)."""
    import torch

    gen = torch.Generator(device=graph.x.device).manual_seed(seed)
    params = dict(sim.named_parameters())
    losses, norms, launches, grads = [], [], [], None
    for i in range(1, n_steps + 1):
        before = (kernel.launches, kernel.backward_launches) if kernel else (0, 0)
        m = step(state, graph, gen)
        if kernel:
            launches.append((kernel.launches - before[0], kernel.backward_launches - before[1]))
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
        if i == 1:  # undo the clip: g · min(1, clip / norm)
            undo = max(norms[-1] / state.optimizer.grad_clip, 1.0)
            grads = {k: p.grad.float() * undo for k, p in params.items()}
    return losses, norms, launches, grads


def step1_fp32_grads(sim, graph, seed):
    """Gradients of the first train step's loss (same noise draw) on an
    fp32 copy of ``sim`` on the plain path, by parameter name."""
    import torch
    from graph_physics_tpu_torch import entry
    from graph_physics_tpu_torch.training.loss import l2_loss
    from graph_physics_tpu_torch.training.noise import add_noise

    sim = copy.deepcopy(sim)
    sim.model.edge_tiling_nk = None
    for m in sim.modules():  # modules that cast to a compute dtype
        if hasattr(m, "dtype"):
            m.dtype = torch.float32
    gen = torch.Generator(device=graph.x.device).manual_seed(seed)
    cfg = entry.NOISE
    g = add_noise(graph, gen, cfg.starts, cfg.ends, cfg.scales)
    with torch.enable_grad():
        out = sim.forward(g, is_training=True)
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
            x_in, e, graph.senders, graph.edge_mask, (enc, blk.edge_block, blk.node_block), nk,
            last, cot_x, cot_e)
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
    plain_sim.model.edge_tiling_nk = None  # every block on the plain edge-list path
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

    res_plain = make_batched_rollout_fn(plain_sim)(frames)
    rk, rp = res.rmse_all_rollout.tolist(), res_plain.rmse_all_rollout.tolist()
    log(f"rollout rmse_all_rollout (R={ROLLOUT_WINDOWS}, T={ROLLOUT_STEPS}), kernel path: "
        + " ".join(f"{v:.6g}" for v in rk))
    log("rollout rmse_all_rollout, plain path:  " + " ".join(f"{v:.6g}" for v in rp))
    log("rollout rmse_1step, kernel path:       "
        + " ".join(f"{v:.6g}" for v in res.rmse_1step.tolist()))
    for name, r in (("kernel", res), ("plain", res_plain)):
        if not (torch.isfinite(r.predictions).all() and torch.isfinite(r.rmse_all_rollout).all()):
            raise AssertionError(f"rollout ({name} path): non-finite values")
    worst = max(abs(a - c) / abs(c) for a, c in zip(rk, rp))
    log(f"  rollout rmse max relative difference {worst:.6g} (limit {ROLLOUT_RTOL})")
    if worst > ROLLOUT_RTOL:
        raise AssertionError(f"rollout RMSE differs by {worst:.4g} relative")

    # 7. training: bench.py's step, kernel path against the plain path
    train = entry.cylinder_train_setup(device)
    tgraph = train.graph
    plain_train_sim = copy.deepcopy(train.simulator)
    plain_train_sim.model.edge_tiling_nk = None
    plain_state, plain_step = entry.make_trainer(plain_train_sim)
    fg = step1_fp32_grads(plain_train_sim, tgraph, 7)
    kernel.launches = kernel.backward_launches = 0
    kl, kn, per_step, kg = train_run(train.train_step, train.state, train.simulator, tgraph, 7,
                                     TRAIN_STEPS, kernel=kernel)
    torch.cuda.synchronize()
    train_launches = (kernel.launches, kernel.backward_launches)
    pl, pn, _, pg = train_run(plain_step, plain_state, plain_train_sim, tgraph, 7, TRAIN_STEPS)
    torch.cuda.synchronize()
    log(f"training ({TRAIN_STEPS} steps, B={tgraph.x.shape[1]}): launches per step "
        f"(forward, backward): {sorted(set(per_step))}; in all {train_launches}")
    log("  loss, kernel path:      " + " ".join(f"{v:.6g}" for v in kl))
    log("  loss, plain path:       " + " ".join(f"{v:.6g}" for v in pl))
    log("  grad_norm, kernel path: " + " ".join(f"{v:.6g}" for v in kn))
    log("  grad_norm, plain path:  " + " ".join(f"{v:.6g}" for v in pn))
    if any(s != (n_blocks, n_blocks) for s in per_step):
        raise AssertionError(f"expected {n_blocks} forward and {n_blocks} backward launches "
                             f"per train step, got {per_step}")
    if not all(map(lambda v: v == v and abs(v) != float("inf"), kl + kn + pl + pn)):
        raise AssertionError("training: non-finite loss or gradient norm")
    loss_rel = [abs(a - c) / abs(c) for a, c in zip(kl, pl)]
    log(f"  loss relative difference: step 1 {loss_rel[0]:.6g} (limit {STEP1_LOSS_RTOL}), "
        f"steps 2-{TRAIN_STEPS} max {max(loss_rel[1:]):.6g} (limit {LATER_LOSS_RTOL})")
    names = sorted(pg)
    if sorted(kg) != names or sorted(fg) != names:
        raise AssertionError("training: the paths have gradients for different parameters")
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
        raise AssertionError("training: loss of the kernel path is off the plain path's")
    if grad_rel > STEP1_GRAD_REL:
        raise AssertionError("training: step-1 gradients off the plain path's")
    for k, p in train.simulator.named_parameters():
        if not torch.isfinite(p).all():
            raise AssertionError(f"training: parameter {k} is not finite")

    # 8. timing: one B=128 forward and one train step, kernel path vs plain path
    fwd_ms = cuda_ms(lambda: sim.forward(graph, is_training=False))
    fwd_plain_ms = cuda_ms(lambda: plain_sim.forward(graph, is_training=False))
    log(f"forward B={b}: kernel path {fwd_ms:.4f} ms, plain path {fwd_plain_ms:.4f} ms ({card})")
    tgen = torch.Generator(device=device).manual_seed(8)
    step_ms = cuda_ms(lambda: train.train_step(train.state, tgraph, tgen), warmup=2, reps=10)
    step_plain_ms = cuda_ms(lambda: plain_step(plain_state, tgraph, tgen), warmup=2, reps=10)
    tb = tgraph.x.shape[1]
    log(f"train step B={tb}: kernel path {step_ms:.4f} ms ({1000 * tb / step_ms:.1f} graph-steps/s), "
        f"plain path {step_plain_ms:.4f} ms ({1000 * tb / step_plain_ms:.1f} graph-steps/s) ({card})")
    log("timing " + json.dumps({"card": card, "forward_ms": fwd_ms, "forward_plain_ms": fwd_plain_ms,
                                "train_step_ms": step_ms, "train_step_plain_ms": step_plain_ms,
                                "blocks": timing, "backward_blocks": bwd_timing}))

    # 9.-11. the graph transformer's inference path
    tf_records = transformer_phases(device, card)

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
             bound_by=bwd_bound[1], library_ms=None),
        *tf_records,
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
    plain_sim.model.edge_tiling_nk = None  # every block on the plain path
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
    res_plain = make_batched_rollout_fn(plain_sim)(frames)
    rk, rp = res.rmse_all_rollout.tolist(), res_plain.rmse_all_rollout.tolist()
    log(f"transformer rollout rmse_all_rollout (R={ROLLOUT_WINDOWS}, T={ROLLOUT_STEPS}), "
        "kernel path: " + " ".join(f"{v:.6g}" for v in rk))
    log("transformer rollout rmse_all_rollout, plain path:  " + " ".join(f"{v:.6g}" for v in rp))
    for name, r in (("kernel", res), ("plain", res_plain)):
        if not (torch.isfinite(r.predictions).all() and torch.isfinite(r.rmse_all_rollout).all()):
            raise AssertionError(f"transformer rollout ({name} path): non-finite values")
    worst = max(abs(a - c) / abs(c) for a, c in zip(rk, rp))
    log(f"  rollout rmse max relative difference {worst:.6g} (limit {ROLLOUT_RTOL})")
    if worst > ROLLOUT_RTOL:
        raise AssertionError(f"transformer rollout RMSE differs by {worst:.4g} relative")

    # 11. timing: the B=64 forward and one middle block, kernel path vs plain path
    fwd_ms = cuda_ms(lambda: sim.forward(graph, is_training=False))
    fwd_plain_ms = cuda_ms(lambda: plain_sim.forward(graph, is_training=False))
    mid = blocks[n_blocks // 2]
    block_args = (randn(n, b, hidden, scale=1.0), graph.senders, graph.receivers,
                  graph.edge_mask, graph.node_mask, graph.pos)
    with torch.inference_mode():
        block_ms = cuda_ms(lambda: mid(*block_args, nk_tiling=nk))
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


if __name__ == "__main__":
    main()
