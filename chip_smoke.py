#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's cylinder inference path once on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout; needs one card

Phases (any failure raises, so the exit code is non-zero):
  1. device: the card's name and power limit (nvidia-smi); TF32 off;
  2. build: nvcc builds the fused GraphNetBlock kernel from csrc/;
  3. kernel check: each kernel variant (folded encoder, middle block, last
     block) against its plain PyTorch version at the slice's shape
     (1,920 nodes x 128 samples x hidden 32, K=6 slots), same bf16 inputs;
  4. slice: the B=128 packed eval forward through the kernel path, which
     must launch the kernel once per block, against the plain path;
  5. rollout: 8 windows of one trajectory, 50 steps, kernel path against
     the plain path;
  6. timing: CUDA-event medians of kernel and plain versions.
The last two lines are the kernels' JSON record and the device JSON.
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
#: kernel vs plain version, rtol = atol (tests/test_fused_gnblock_nk.py:101-106)
KERNEL_TOL = 0.05
#: kernel path vs plain path of the whole model, rtol = atol, valid nodes
#: (tests/test_fused_gnblock_nk.py:305-308)
SLICE_TOL = 0.15
#: per-trajectory rollout RMSE, kernel path vs plain path, relative
ROLLOUT_RTOL = 0.15
ROLLOUT_WINDOWS = 8
ROLLOUT_STEPS = 50
REPLACES = "graph_physics_tpu/ops/fused_gnblock_nk.py:147"
SOURCE = "graph_physics_tpu_torch/csrc/fused_gnblock_nk.cu"


def log(*args):
    print(*args, flush=True)


def compare(name, got, want, tol, rows=None):
    """Max abs / rel error; raises unless |got - want| <= tol + tol·|want|."""
    import torch

    got, want = got.float(), want.float()
    if rows is not None:
        got, want = got[rows], want[rows]
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite values")
    diff = (got - want).abs()
    max_abs = diff.max().item()
    big = want.abs() >= tol  # where a relative error means something
    max_rel = (diff[big] / want.abs()[big]).max().item() if big.any() else 0.0
    bad = int((diff > tol + tol * want.abs()).sum())
    log(f"  {name}: max_abs_err {max_abs:.6g} max_rel_err {max_rel:.6g} where |ref| >= {tol} "
        f"(rtol=atol={tol}, {bad} of {diff.numel()} outside)")
    if bad:
        raise AssertionError(f"{name}: {bad} values outside rtol=atol={tol}")
    return max_abs


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


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; it needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT))
    from graph_physics_tpu_torch import entry
    from graph_physics_tpu_torch.ops import fused_gnblock_nk as nk_ops
    from graph_physics_tpu_torch.training.rollout import make_batched_rollout_fn

    kernel = nk_ops.fused_gn_block_nk
    plain = nk_ops.fused_gn_block_nk_reference
    device = torch.device("cuda:0")
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
    build_log = nk_ops.build()
    log(f"build: {time.perf_counter() - t0:.1f} s -> {nk_ops.library_path().relative_to(ROOT)}")
    for line in build_log.splitlines():
        if "ptxas" in line or "error" in line:
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

    def randn(*shape):
        return (torch.randn(shape, generator=gen, device=device) * 0.5).to(torch.bfloat16)

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

    # 4. slice: the packed B=128 eval forward through the kernel path
    plain_sim = copy.deepcopy(sim)
    plain_sim.model.edge_tiling_nk = None  # every block on the plain edge-list path
    rows = graph.node_mask
    kernel.launches = 0
    out = sim.forward(graph, is_training=False)
    torch.cuda.synchronize()
    forward_launches = kernel.launches
    # 5. rollout: R windows of one trajectory, T steps, kernel path
    frames = entry.rollout_frames(setup, range(ROLLOUT_WINDOWS), ROLLOUT_STEPS)
    res = make_batched_rollout_fn(sim)(frames)
    torch.cuda.synchronize()
    launches = kernel.launches
    n_blocks = len(blocks)
    log(f"slice forward: {forward_launches} kernel launches ({n_blocks} blocks); "
        f"with the {ROLLOUT_STEPS}-step rollout: {launches}")
    if forward_launches != n_blocks:
        raise AssertionError(f"expected {n_blocks} launches per forward, got {forward_launches}")
    if launches != n_blocks * (1 + ROLLOUT_STEPS):
        raise AssertionError(f"expected {n_blocks * (1 + ROLLOUT_STEPS)} launches, got {launches}")

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

    # 6. timing: one B=128 forward, kernel path vs plain path
    fwd_ms = cuda_ms(lambda: sim.forward(graph, is_training=False))
    fwd_plain_ms = cuda_ms(lambda: plain_sim.forward(graph, is_training=False))
    log(f"forward B={b}: kernel path {fwd_ms:.4f} ms, plain path {fwd_plain_ms:.4f} ms ({card})")
    log("timing " + json.dumps({"card": card, "forward_ms": fwd_ms, "forward_plain_ms": fwd_plain_ms,
                                "blocks": timing}))

    log(f"card: {card}")
    log(json.dumps({"kernels": [{
        "name": "fused_gn_block_nk",
        "route": "cuda",
        "source": SOURCE,
        "replaces": REPLACES,
        "launches": launches,
        "max_abs_err": max(errors.values()),
        "ms": timing["middle"]["ms"],
        "plain_ms": timing["middle"]["plain_ms"],
    }]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
