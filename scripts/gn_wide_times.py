"""Time rows 1-4 at hidden 64 and 128 (the wide GraphNetBlock kernels) on a
card, in turns with another checkout's, at the shapes of chip_smoke.py's
phase 53: a middle block of the cylinder ``epd`` (NK layout) with
``nb_of_layers`` Dense layers a MLP, held against its plain version forward
and backward, then timed.

    python3 scripts/gn_wide_times.py --parent CHECKOUT [--cases h:layers:norm:batch ...]

Each case ``h:layers:norm:batch`` (default: phase 53's 128:3:1:128, then
128:4:1:128, 64:3:1:128 and 128:3:1:16) goes through
``chip_smoke.main_block_check``: CUDA-event and profiler device times of
the kernels and of the parent's (parent, this tree, this tree, parent),
the plain version's, the bound, the backward's device time by pass for
both trees, and both trees' bf16 scratch bytes (``gnw_bwd_sizes``). Builds
only the GraphNetBlock libraries of both checkouts. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CASES = ("128:3:1:128", "128:4:1:128", "64:3:1:128", "128:3:1:16")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="the checkout to time in turns")
    ap.add_argument("--cases", nargs="+", default=list(CASES))
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from graph_physics_tpu_torch import entry
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
    for case in args.cases:
        h, depth, norm, batch = (int(v) for v in case.split(":"))
        setup = entry.cylinder_setup(device, hidden=h, mp_steps=3, batch=batch)
        cs.set_block_depth(setup.simulator.model, depth, bool(norm), seed=52)
        cs.main_block_check(f"hidden {h}, {depth} layers{'' if norm else ' without the norm'}, "
                            f"B={batch}", setup.simulator.model, setup.graph, setup.tiling, card,
                            seed=53)
        del setup
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
