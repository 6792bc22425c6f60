"""Repeat the plate transformer's fit and rollouts on a card, to see where
predict's and validate's rollout RMSEs part (``chip_smoke.py`` phase 31
holds them to 1e-6 of each other).

    python3 scripts/rollout_repeat.py [--package CHECKOUT] [--fits 3] [--rollouts 6]
                                      [--deterministic]

``--package``: the checkout whose ``graph_physics_tpu_torch`` is imported
(default: this one, so a parent tree unpacked beside it can be measured by
the same phase); the phase is this checkout's
``chip_smoke.plate_fit_run``. Each fit is phase 31's run: ``fit`` with its
validation rollout, then predict from the checkpoint, and their relative
difference; then the same checkpoint once more through predict and the
trained model once more through validate. Then the last fit's checkpoint
is rolled out ``--rollouts`` times as predict does and as many times as
validate does, first as they run and then again under PyTorch's
deterministic algorithms (``index_add_`` on a card summing in a fixed
order, not by atomics). Prints each RMSE in full and, as its last line,
one JSON object of all of them with the card's name and power limit.
``--deterministic``: the fits too under PyTorch's deterministic
algorithms (and cuBLAS's deterministic workspace), so that what still
varies from fit to fit is not PyTorch's atomics.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", default=None, help="checkout whose package is imported")
    ap.add_argument("--fits", type=int, default=3)
    ap.add_argument("--rollouts", type=int, default=6)
    ap.add_argument("--deterministic", action="store_true")
    args = ap.parse_args()
    pkg = Path(args.package).resolve() if args.package else ROOT
    sys.path.insert(0, str(pkg))
    if args.deterministic:
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    import torch

    if args.deterministic:
        torch.use_deterministic_algorithms(True, warn_only=True)

    if not torch.cuda.is_available():
        raise SystemExit("rollout_repeat: needs an NVIDIA GPU")
    import graph_physics_tpu_torch
    from graph_physics_tpu_torch.cli import predict as predict_cli
    from graph_physics_tpu_torch.cli.common import load_inference_stack

    if pkg not in Path(graph_physics_tpu_torch.__file__).resolve().parents:
        raise SystemExit(f"rollout_repeat: imported {graph_physics_tpu_torch.__file__}, "
                         f"not the package of {pkg}")
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    device = torch.device("cuda:0")
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}; package: {pkg}; deterministic algorithms throughout: "
          f"{args.deterministic}", flush=True)

    def predictor(run):
        cli_args = predict_cli.build_argparser().parse_args([
            "--training_parameters_path", str(ROOT / "training_config" / "plate.json"),
            "--model_path", run["tr"].ckpt_dir, "--bf16", "--fused", "--device", str(device)])
        stack = load_inference_stack(cli_args, dataset=run["val_ds"])
        return lambda: float(predict_cli.predict(stack, fused=True)[0].rmse_all_rollout)

    fits = []
    for i in range(args.fits):
        run = smoke.plate_fit_run(device, card, run_name=f"fit_plate_repeat{i}")
        again = {"predict_again": predictor(run)(),
                 "validate_again": float(run["tr"].validate()["val_all_rollout_rmse"])}
        fits.append({**{k: run[k] for k in ("predict_rmse", "validate_rmse", "rel")}, **again})
        print(f"fit {i}: predict {run['predict_rmse']!r} (again {again['predict_again']!r}), "
              f"validate {run['validate_rmse']!r} (again {again['validate_again']!r}), "
              f"relative difference {run['rel']:.3g} (limit {smoke.PREDICT_RTOL})", flush=True)
    bad = [i for i, f in enumerate(fits) if f["rel"] > smoke.PREDICT_RTOL]
    print(f"{len(bad)} of {len(fits)} fits past the limit: {bad}", flush=True)

    tr, predict = run["tr"], predictor(run)

    def rollouts():
        out = {"predict": [], "validate": []}
        for _ in range(args.rollouts):
            out["predict"].append(predict())
            out["validate"].append(float(tr.validate()["val_all_rollout_rmse"]))
        torch.cuda.synchronize()
        return out

    modes = {"as run": rollouts()}
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        modes["deterministic algorithms"] = rollouts()
    finally:
        torch.use_deterministic_algorithms(was)
    for mode, out in modes.items():
        for kind, vals in out.items():
            distinct = sorted(set(vals))
            spread = (distinct[-1] - distinct[0]) / distinct[0]
            print(f"last checkpoint, {kind} rollouts {mode}: {len(distinct)} distinct of "
                  f"{len(vals)}, relative spread {spread:.3g}: "
                  + ", ".join(repr(v) for v in vals), flush=True)
    print(json.dumps({"card": card, "package": str(pkg), "deterministic": args.deterministic,
                      "fits": fits, "rollouts": modes}))


if __name__ == "__main__":
    main()
