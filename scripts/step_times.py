"""Time the train steps with the most scatters and gathers on a card: the
plate transformer (entry.plate_train_setup, B=64, world edges), the plate
MeshGraphNet (entry.plate_epd_train_setup, B=64) and panels
(entry.panels_train_setup, B=64, the physics loss), each on its kernel
path, in PyTorch's default mode.

    python3 scripts/step_times.py [--package CHECKOUT] [--steps 20] [--setups NAME ...]

``--package``: the checkout whose ``graph_physics_tpu_torch`` is imported
(default: this one), so that two trees are timed by the same script on one
card; run them in turns (parent, change, change, parent) in one call.
``--setups``: only these of the three entry setups (default: all).
After 3 warm-up steps, each step's wall time is the CUDA-event time of
``--steps`` steps, synchronised, divided by their number. Prints one line a
step kind and, last, one JSON object with the card's name and power limit.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SETUPS = ("plate_train_setup", "plate_epd_train_setup", "panels_train_setup")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", default=None, help="checkout whose package is imported")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--setups", nargs="+", choices=SETUPS, default=list(SETUPS))
    args = ap.parse_args()
    pkg = Path(args.package).resolve() if args.package else ROOT
    sys.path.insert(0, str(pkg))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("step_times: needs an NVIDIA GPU")
    import graph_physics_tpu_torch
    from graph_physics_tpu_torch import entry

    if pkg not in Path(graph_physics_tpu_torch.__file__).resolve().parents:
        raise SystemExit(f"step_times: imported {graph_physics_tpu_torch.__file__}, not the "
                         f"package of {pkg}")
    device = torch.device("cuda:0")
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip()
    out = {}
    for name in args.setups:
        train = getattr(entry, name)(device)
        gen = torch.Generator(device).manual_seed(0)
        for _ in range(3):
            train.train_step(train.state, train.graph, gen)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.steps):
            m = train.train_step(train.state, train.graph, gen)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / args.steps
        out[name] = ms
        print(f"{name}: {ms:.4f} ms a step over {args.steps} steps, B="
              f"{train.graph.x.shape[1]}, loss {m['loss'].item():.6g} ({card}; {pkg})",
              flush=True)
        del train, m
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "package": str(pkg), "steps": args.steps, "ms": out}))


if __name__ == "__main__":
    main()
