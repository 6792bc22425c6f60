"""Where the time of the PyTorch port's packed eval forward, or its train
step, goes, on one NVIDIA GPU.

    python3 scripts/profile_torch_forward.py \
        [transformer|epd|transformer-train|epd-train|graded|graded-transformer|
         graded-train|graded-transformer-train|transolver-train|
         graded-transolver-train|plate-train|panels-train|mgn-train|mgn3-train|
         plate-epd-train|transformer-h32-train|epd-h16-train ...]
    # default: the two cylinder forwards

For each slice (``transformer``: entry.transformer_setup, 10 blocks, hidden
64, B=64; ``epd``: entry.cylinder_setup, 5 blocks, hidden 32, B=128; the
``-train`` slices: one train step of entry.transformer_train_setup or
entry.cylinder_train_setup, same models and batches; ``graded`` and
``graded-transformer``: the two models' forwards on the graded mesh in the
CSR layout, entry.graded_setup and entry.graded_transformer_setup, B=16;
``graded-train`` and ``graded-transformer-train``: one train step of
entry.graded_train_setup or entry.graded_transformer_train_setup;
``transolver-train`` and ``graded-transolver-train``: one train step of
entry.transolver_train_setup, stacked B=16 on the cylinder's 1,920 nodes
(2,432 rows with padding) or the graded mesh's 27,000 points (27,136);
``plate-train``: one train step of entry.plate_train_setup, plate.json's
transformer with world edges, 10 blocks, hidden 64, B=64, the noise and
the world-position features of entry.plate_preprocess; ``panels-train``:
one train step of entry.panels_train_setup, panels.json's transformer, 15
blocks, hidden 128, B=64, its 4-term MultiLoss on least-squares gradients;
``mgn-train``: one train step of entry.cylinder_train_setup at
MeshGraphNets' width, 15 blocks, hidden 128, B=128, NK, through the wide
GraphNetBlock kernels (``mgn3-train``: the same with MeshGraphNets'
3-layer MLPs, ``nb_of_layers=3`` with the RMSNorm tail, as chip_smoke.py
phase 53 builds them); ``plate-epd-train``: one train step of
entry.plate_epd_train_setup, DeformingPlate's MeshGraphNet with world
edges in every sample, 15 blocks, hidden 128, B=64, NK, the world stream
(its gathers, the edge MLP in plain PyTorch, the scatter) joining the wide
kernels through their extra_agg seam; ``transformer-h32-train``: one train
step of entry.transformer_train_setup at hidden 32 with 4 heads, head
width 8, 10 blocks, B=64, through the small-width FFN and attention
instances; ``epd-h16-train``: one train step of entry.cylinder_train_setup
at hidden 16, 5 blocks, B=128, NK, the encoder folded, through the
hidden-16 GraphNetBlock instances)
and each path (kernel path, and the plain path: no edge layout, or for
the Transolver the gumbel kernel's plain version on the same bits), runs
``torch.profiler`` over 10 calls after 3 warm-up calls and prints, per
call: the host wall time (synchronised), the device time summed over
kernels, the idle share (1 - device / wall) and the device time by kernel
group (the port's kernels by name, the GraphNetBlock backwards by pass,
GEMMs, the optimizer, elementwise, reductions, index ops, the rest), each
with its launch count. Before the profiler and again after it, it times
the calls unprofiled: the host's time to enqueue one call from a
synchronised start beside the CUDA-event time of the same calls, and the
wall time a call of ``REPS`` calls back to back. The full
per-kernel table goes to ``build/profile/profile_<slice>_<path>.txt``
(git-ignored). Builds the kernels first if needed; imports nothing of JAX.
"""

import copy
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "profile"
REPS, WARMUP = 10, 3
#: kernel groups by a substring of the CUDA kernel's name, first match wins
GROUPS = (
    ("attention kernel (ea_nk_fwd)", ("ea_nk_fwd",)),
    ("attention backward kernels (ea_nk_bwd)", ("ea_nk_bwd",)),
    ("CSR attention kernel (ea_csr_fwd)", ("ea_csr_fwd",)),
    ("CSR attention backward kernels (ea_csr_bwd)", ("ea_csr_bwd",)),
    ("gated FFN h128 backward kernels (ffn128_bwd_kernel, _pack, _sum)", ("ffn128_bwd",)),
    ("gated FFN h128 kernels (ffn128_fwd_kernel, _pack)", ("ffn128_fwd",)),
    ("wide GraphNetBlock forward, edge and node passes (gnw*_edge_fwd, node_fwd)",
     ("_edge_fwd", "_node_fwd")),
    ("wide GraphNetBlock backward, row pass (gnw*_row_bwd)", ("_row_bwd",)),
    ("wide GraphNetBlock backward, weight gradients (gnw*_wgrad, wsum)", ("_wgrad", "_wsum")),
    ("wide GraphNetBlock backward, node-MLP pass (gnw*_node_bwd)", ("_node_bwd",)),
    ("wide GraphNetBlock backward, sender pass (gnw*_send)", ("_nk_send", "_csr_send")),
    ("wide GraphNetBlock encoder passes (gnw*_enc_fwd, enc_bwd)", ("_enc_fwd", "_enc_bwd")),
    ("wide GraphNetBlock node pre-pass (gnw*_partial)", ("w64_partial", "w128_partial")),
    ("gated FFN kernel at hidden 32 and below (ffn_small_fwd)", ("ffn_small_fwd",)),
    ("gated FFN backward kernels at hidden 32 and below (ffn_small_bwd)", ("ffn_small_bwd",)),
    ("gated FFN kernel (ffn_fwd)", ("ffn_fwd",)),
    ("gated FFN backward kernels (ffn_bwd)", ("ffn_bwd",)),
    ("GraphNetBlock kernel (gn_nk_fwd)", ("gn_nk_fwd",)),
    ("GraphNetBlock backward, row pass (gn_nk_bwd_row)", ("gn_nk_bwd_row",)),
    ("GraphNetBlock backward, node-MLP pass (gn_nk_bwd_nodemlp)", ("gn_nk_bwd_nodemlp",)),
    ("GraphNetBlock backward, sender pass (gn_nk_bwd_send)", ("gn_nk_bwd_send",)),
    ("CSR GraphNetBlock backward, row pass (gn_csr_bwd_row)", ("gn_csr_bwd_row",)),
    ("CSR GraphNetBlock backward, node-MLP pass (gn_csr_bwd_nodemlp)", ("gn_csr_bwd_nodemlp",)),
    ("CSR GraphNetBlock backward, sender pass (gn_csr_bwd_send)", ("gn_csr_bwd_send",)),
    ("CSR GraphNetBlock kernel (gn_csr_fwd)", ("gn_csr",)),
    ("GraphNetBlock node pre-pass (gn_partial, both layouts)", ("gn_partial",)),
    ("gumbel kernel (gumbel_perturb)", ("gumbel_perturb",)),
    ("GEMMs", ("gemm", "cutlass", "xmma", "sm90_", "cublas", "nvjet")),
    ("optimizer (multi-tensor)", ("multi_tensor",)),
    ("sort", ("sort", "radix")),
    ("index ops", ("index", "gather", "scatter")),
    ("reductions", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def group_of(name):
    low = name.lower()
    for label, keys in GROUPS:
        if any(k in low for k in keys):
            return label
    return "other"


def unprofiled(run, label, when, card):
    """Medians over ``REPS`` calls of ``run``, each from a synchronised
    start, of the host's time to enqueue it and of its CUDA-event time;
    then the wall time a call of ``REPS`` calls back to back."""
    import torch

    enqueue, events = [], []
    for _ in range(REPS):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        run()
        enqueue.append(1e3 * (time.perf_counter() - t0))
        end.record()
        end.synchronize()
        events.append(start.elapsed_time(end))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(REPS):
        run()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / REPS
    print(f"{label}, unprofiled {when} the profiler: the host enqueues a call in "
          f"{statistics.median(enqueue):.4f} ms, CUDA events {statistics.median(events):.4f} ms "
          f"over the same calls; {wall_ms:.4f} ms a call back to back ({card})", flush=True)


def profile(run, label, card):
    """Profile ``REPS`` calls of ``run`` after ``WARMUP`` calls, timed
    unprofiled before and after."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    for _ in range(WARMUP):
        run()
    unprofiled(run, label, "before", card)
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(REPS):
            run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / REPS
    groups = defaultdict(lambda: [0.0, 0])
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        # a user annotation's range (the optimizer step's) spans the host's
        # gaps between its kernels: no kernel's time
        if dev_us <= 0 or ev.device_type != torch.autograd.DeviceType.CUDA or getattr(
                ev, "is_user_annotation", False):
            continue
        g = groups[group_of(ev.key)]
        g[0] += dev_us / 1e3 / REPS
        g[1] += ev.count / REPS
        rows.append((dev_us / 1e3 / REPS, ev.count / REPS, ev.key))
    device_ms = sum(v[0] for v in groups.values())
    print(f"{label}: host wall {wall_ms:.4f} ms per call (profiled), device {device_ms:.4f} ms, "
          f"idle share {1 - device_ms / wall_ms:.4f} ({card})", flush=True)
    for name, (ms, count) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"  {name}: {ms:.4f} ms, {count:g} launches", flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    path = OUT / f"profile_{label.replace(' ', '_')}.txt"
    with open(path, "w") as f:
        f.write(f"{label} ({card}); device ms per call, launches per call, kernel\n")
        for ms, count, key in sorted(rows, reverse=True):
            f.write(f"{ms:.5f}\t{count:g}\t{key}\n")
    if device_ms == 0:
        raise SystemExit("the profiler recorded no device time")
    unprofiled(run, label, "after", card)


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_forward: needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from graph_physics_tpu_torch import entry
    from graph_physics_tpu_torch.models.processors import TransolverProcessor
    from graph_physics_tpu_torch.models.transolver import use_plain_gumbel
    from graph_physics_tpu_torch.ops import kernel_build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip()
    kernel_build.build()
    forwards = {"transformer": entry.transformer_setup, "epd": entry.cylinder_setup,
                "graded": entry.graded_setup,
                "graded-transformer": entry.graded_transformer_setup}
    trains = {"transformer-train": entry.transformer_train_setup,
              "epd-train": entry.cylinder_train_setup,
              "graded-train": entry.graded_train_setup,
              "graded-transformer-train": entry.graded_transformer_train_setup,
              "transolver-train": entry.transolver_train_setup,
              "graded-transolver-train": lambda d: entry.transolver_train_setup(d, graded=True),
              "plate-train": entry.plate_train_setup,
              "panels-train": entry.panels_train_setup,
              "mgn-train": lambda d: entry.cylinder_train_setup(d, hidden=128, mp_steps=15),
              "mgn3-train": lambda d: chip_smoke.with_block_depth(
                  entry.cylinder_train_setup(d, hidden=128, mp_steps=15), 3, True, 53),
              "plate-epd-train": entry.plate_epd_train_setup,
              "transformer-h32-train": lambda d: entry.transformer_train_setup(d, hidden=32,
                                                                               heads=4),
              "epd-h16-train": lambda d: entry.cylinder_train_setup(d, hidden=16)}
    for name in sys.argv[1:] or ["transformer", "epd"]:
        setup = (forwards.get(name) or trains[name])("cuda")
        graph = setup.graph
        plain = copy.deepcopy(setup.simulator)
        if isinstance(plain.model, TransolverProcessor):
            use_plain_gumbel(plain)
        else:
            plain.model.tiling = None
        stacked = graph.node_type.ndim == 2
        label = f"{name} B={graph.x.shape[0 if stacked else 1]}"
        if name in forwards:
            def runner(sim):
                def run():
                    with torch.inference_mode():
                        sim.forward(graph, is_training=False)
                return run
            runs = (runner(setup.simulator), runner(plain))
        else:
            plain_state, plain_step = entry.make_trainer(plain, setup.device_preprocess,
                                                         setup.loss_fn, setup.gradient_method)
            gen = torch.Generator(device=graph.x.device).manual_seed(0)
            runs = (lambda: setup.train_step(setup.state, graph, gen),
                    lambda: plain_step(plain_state, graph, gen))
        profile(runs[0], f"{label} kernel path", card)
        profile(runs[1], f"{label} plain path", card)
        del setup, plain, runs
        torch.cuda.empty_cache()

if __name__ == "__main__":
    main()
