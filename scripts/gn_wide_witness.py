"""Rows 2 and 4 at hidden 64 and 128 (the wide GraphNetBlock backwards) on a
card, this tree's kernels beside another checkout's on the same inputs:
the gradient errors of chosen warpgroup tile cases, and the host's share
of a wide call.

    python3 scripts/gn_wide_witness.py --parent CHECKOUT \\
        [--grads DEPTH-NORM-VARIANT ...] [--host H:LAYERS:NORM:BATCH ...]

``--grads`` takes entries of tests/test_torch_cuda.py's ``TILE_DEPTHS``
(as ``4-False-last``) and runs each at every batch, width and layout of
``test_wide_gn_kernels_on_warpgroup_tiles`` (``tile_case``, the test's
inputs): ``utils/gradcheck.check_block_backward`` with this tree's
kernels, again on the same inputs, then with the parent's. For each case
it prints one JSON line: whether the bounds hold, whether the second call
and the parent's gave the same gradients bit for bit, and for every
gradient out of bounds its kernel and plain-bf16 errors against the fp32
gradient (relative L2; largest error over the fp32 gradient's largest
value) and its largest difference from the plain version. A failing case
is run again with two other weight seeds.

``--host`` takes cases of a middle block on the cylinder mesh (NK layout,
as ``scripts/gn_wide_times.py`` builds them) and times, for each tree,
the forward and the backward call: the host's time to issue the call
(median over calls that start on an idle card), the time of the C entry
point alone inside it (the kernels' host code: tensor maps, occupancy
queries, launches), the CUDA-event time and the profiler's device time;
and one ``cuTensorMapEncodeTiled`` on the host. Builds only the
GraphNetBlock libraries of both checkouts. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: the wide C entry points that launch kernels
LAUNCHES = {"gnw_nk_fwd", "gnw_nk_bwd", "gnw_csr_fwd", "gnw_csr_bwd"}
HOST_REPS = 50


class _TimedLib:
    """A kernel library whose launching entry points add their host
    seconds to ``sink``."""

    def __init__(self, lib, sink):
        self._lib, self._sink = lib, sink

    def __getattr__(self, name):
        attr = getattr(self._lib, name)
        if name not in LAUNCHES:
            return attr

        def call(*args):
            t0 = time.perf_counter()
            out = attr(*args)
            self._sink.append(time.perf_counter() - t0)
            return out
        return call


@contextlib.contextmanager
def timed_entries(names, sink):
    """Inside the block the loaded libraries ``names`` time their entries."""
    from graph_physics_tpu_torch.ops import kernel_build

    saved = {n: kernel_build._libs[n] for n in names}
    kernel_build._libs.update({n: _TimedLib(lib, sink) for n, lib in saved.items()})
    try:
        yield
    finally:
        kernel_build._libs.update(saved)


def _failing(rows):
    keys = ("name", "max_abs_err", "rel_to_max", "kernel_fp32_l2", "plain_fp32_l2",
            "kernel_fp32_max", "plain_fp32_max", "outside", "count")
    return [{k: r[k] for k in keys if k in r} for r in rows if not r["ok"]]


def grad_case(cs, tile_case, device, depth, norm, variant, batch, hidden, layout, seed=None):
    """(record, the kernel's gradients) of one tile case with this tree's
    kernels, or the parent's inside ``cs.parent_kernels``."""
    import torch
    from graph_physics_tpu_torch.utils import gradcheck

    _, _, args, kw, extra, cot_x, cot_e, lead = tile_case(device, depth, norm, variant, batch,
                                                          hidden, layout, weight_seed=seed)
    rows, ok, kept = gradcheck.check_block_backward(
        args[0], args[1], args[2:lead], (kw["encoder_params"], *args[lead:lead + 2]), args[-1],
        kw["last_block"], cot_x, cot_e, extra=extra)
    grads = [g.clone() for g in torch.autograd.grad(*kept["kernel"])]
    torch.cuda.synchronize()
    return {"ok": ok, "failing": _failing(rows)}, grads


def run_grads(cs, names, device):
    import torch

    sys.path.insert(0, str(ROOT / "tests"))  # as pytest imports the test modules
    from test_torch_cuda import TILE_BATCHES, TILE_DEPTHS, WIDE, tile_case

    depths = {f"{d}-{n}-{v}": (d, n, v) for d, n, v in TILE_DEPTHS}
    for name in names:
        depth, norm, variant = depths[name]
        for batch in TILE_BATCHES:
            for hidden in WIDE:
                for layout in ("nk", "csr"):
                    case = (depth, norm, variant, batch, hidden, layout)
                    rec, ours = grad_case(cs, tile_case, device, *case)
                    again, ours2 = grad_case(cs, tile_case, device, *case)
                    with cs.parent_kernels(*cs.gn_libs(layout, hidden, True)):
                        theirs, parents = grad_case(cs, tile_case, device, *case)
                    rec = {"case": "-".join(map(str, case)), **rec,
                           "again_ok": again["ok"],
                           "again_same_bits": all(torch.equal(a, b) for a, b in zip(ours, ours2)),
                           "parent_ok": theirs["ok"], "parent_failing": theirs["failing"],
                           "parent_same_bits": all(torch.equal(a, b)
                                                   for a, b in zip(ours, parents))}
                    if not rec["ok"]:
                        rec["other_seeds"] = {
                            s: grad_case(cs, tile_case, device, *case, seed=s)[0]
                            for s in (depth + 100, depth + 200)}
                    print("GRADS " + json.dumps(rec), flush=True)


def _host_ms(fn, entry_sink):
    """(median host ms to issue ``fn`` on an idle card, median ms of its C
    entries)."""
    import torch

    fn()
    torch.cuda.synchronize()
    calls = []
    entry_sink.clear()
    for _ in range(HOST_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        calls.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    per_call = len(entry_sink) // HOST_REPS
    entries = [sum(entry_sink[i * per_call:(i + 1) * per_call]) for i in range(HOST_REPS)]
    return statistics.median(calls) * 1e3, statistics.median(entries) * 1e3


def encode_us():
    """Host microseconds of one cuTensorMapEncodeTiled of a [4][4096][128]
    bf16 array with (64, 64, 1) boxes and the 128-byte swizzle, the maps
    the wide backward encodes (median of 1,000)."""
    import torch

    cuda = ctypes.CDLL("libcuda.so.1")
    fn = cuda.cuTensorMapEncodeTiled
    buf = torch.empty((4, 4096, 128), dtype=torch.bfloat16, device="cuda")
    raw = ctypes.create_string_buffer(256)
    addr = (ctypes.addressof(raw) + 127) // 128 * 128
    u64, u32 = ctypes.c_uint64, ctypes.c_uint32
    dims, strides = (u64 * 3)(128, 4096, 4), (u64 * 2)(256, 256 * 4096)
    box, step = (u32 * 3)(64, 64, 1), (u32 * 3)(1, 1, 1)
    # CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 = 9, INTERLEAVE_NONE = 0, SWIZZLE_128B = 3,
    # L2_PROMOTION_L2_128B = 2, FLOAT_OOB_FILL_NONE = 0
    args = (ctypes.c_void_p(addr), 9, 3, ctypes.c_void_p(buf.data_ptr()), dims, strides, box,
            step, 0, 3, 2, 0)
    if fn(*args) != 0:
        raise RuntimeError("cuTensorMapEncodeTiled failed")
    times = []
    for _ in range(1000):
        t0 = time.perf_counter()
        fn(*args)
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e6


def run_host(cs, cases, device, card):
    import torch
    from graph_physics_tpu_torch import entry
    from graph_physics_tpu_torch.ops import fused_gnblock_nk as nk_ops

    cs.log(f"one cuTensorMapEncodeTiled: {encode_us():.2f} host us")
    for case in cases:
        h, depth, norm, batch = (int(v) for v in case.split(":"))
        setup = entry.cylinder_setup(device, hidden=h, mp_steps=3, batch=batch)
        model, graph, nk = setup.simulator.model, setup.graph, setup.tiling
        cs.set_block_depth(model, depth, bool(norm), seed=52)
        blk = model.processor_list[1]
        gen = torch.Generator(device=device).manual_seed(53)
        n = graph.x.shape[0]
        x = (0.5 * torch.randn((n, batch, h), generator=gen, device=device)).bfloat16()
        e = (0.5 * torch.randn((nk.total_rows, batch, h), generator=gen,
                               device=device)).bfloat16()
        cots = [torch.randn(t.shape, generator=gen, device=device).bfloat16() for t in (x, e)]
        wrapper = cs.late(nk_ops.fused_gn_block_nk)
        libs = cs.gn_libs("nk", h, True)
        params = [p for m in (blk.edge_block, blk.node_block) for p in nk_ops._mlp_params(m)]

        def measure():
            sink = []
            fwd = lambda: wrapper(x, e, graph.senders, graph.edge_mask, blk.edge_block,  # noqa
                                  blk.node_block, nk)
            with torch.inference_mode():
                fwd()  # loads the libraries
                with timed_entries(libs[:1], sink):
                    f_host, f_entry = _host_ms(fwd, sink)
                f_ev, f_dev = cs.cuda_ms(fwd), cs.device_ms(fwd, reps=10)
            xl, el = x.clone().requires_grad_(True), e.clone().requires_grad_(True)
            outs = wrapper(xl, el, graph.senders, graph.edge_mask, blk.edge_block,
                           blk.node_block, nk)
            bwd = lambda: torch.autograd.grad(outs, [xl, el] + params, cots,  # noqa: E731
                                              retain_graph=True)
            bwd()
            with timed_entries(libs[1:], sink):
                b_host, b_entry = _host_ms(bwd, sink)
            b_ev, b_dev = cs.cuda_ms(bwd), cs.device_ms(bwd, reps=10)
            return {"fwd": [f_host, f_entry, f_ev, f_dev], "bwd": [b_host, b_entry, b_ev, b_dev]}

        turns = []
        for tree in ("this", "parent", "this", "parent"):
            if tree == "this":
                turns.append((tree, measure()))
            else:
                with cs.parent_kernels(*libs):
                    turns.append((tree, measure()))
        for tree in ("this", "parent"):
            for way in ("fwd", "bwd"):
                vals = [t[way] for name, t in turns if name == tree]
                cs.log(f"host {case} {way} {tree}: issue "
                       + ", ".join(f"{v[0]:.4f}" for v in vals) + " ms; C entry "
                       + ", ".join(f"{v[1]:.4f}" for v in vals) + " ms; events "
                       + ", ".join(f"{v[2]:.4f}" for v in vals) + " ms; device "
                       + ", ".join(f"{v[3]:.4f}" for v in vals) + f" ms ({card})")
        del setup
        torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="the checkout to compare with")
    ap.add_argument("--grads", nargs="*", default=[])
    ap.add_argument("--host", nargs="*", default=[])
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from graph_physics_tpu_torch.ops import kernel_build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "-i", "0"],
                          capture_output=True, text=True, check=True).stdout.strip()
    cs.log(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cs.PARENT = Path(args.parent).resolve()
    for name in [n for n in cs.PARENT_LIBS if not n.startswith("gn_")]:
        del cs.PARENT_LIBS[name]
    gn = {n: v for n, v in kernel_build.LIBRARIES.items() if n.startswith("gn_")}
    kernel_build.LIBRARIES.clear()
    kernel_build.LIBRARIES.update(gn)
    t0 = time.time()
    cs.start_parent_builds()
    kernel_build.build()
    for name in cs.PARENT_LIBS:
        cs.parent_library(name)
    cs.log(f"build: {time.time() - t0:.1f} s")
    device = torch.device("cuda")
    run_host(cs, args.host, device, card)
    run_grads(cs, args.grads, device)


if __name__ == "__main__":
    main()
