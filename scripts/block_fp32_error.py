"""The fp32 error of a GraphNetBlock's two bf16 backwards, the kernel's and
its plain version's, on a card: the readings that ``utils/gradcheck.py``'s
ratio bounds (FP32_L2_RATIO, FP32_MAX_RATIO) and dx share
(BLOCK_OUTSIDE_SHARE) judge.

    python3 scripts/block_fp32_error.py [--package CHECKOUT] [--hidden 32 64 128] [--seeds 6]

``--package``: the checkout whose ``graph_physics_tpu_torch`` (and the
card tests' cases, ``tests/test_torch_cuda.py``) are imported; default
this one. Run it on two checkouts to compare their plain versions against
the same kernels. Cases, each at every ``--hidden`` width, folded and
middle block, ``--seeds`` seeds: the CSR hub mesh (384 nodes, a receiver
of in-degree 150, B=17) and the 16 x 16 cylinder's NK layout with masked
slots between valid ones (B=33), the cases of the card tests
``test_wide_backward_share_separates_the_kernel_from_the_fp32_control``
and ``test_wide_nk_gn_backward_kernel_matches_plain_version``. For each case
and gradient: the relative L2 and largest error of the kernel's and the
plain version's gradient against fp32, and for dx the values outside the
plain backward's 0.05 bound, the kernel's and the fp32 control's. Prints
a summary a width and layout and, as its last line, one JSON object of
all rows with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", default=None, help="checkout whose package is imported")
    ap.add_argument("--hidden", type=int, nargs="+", default=[32, 64, 128])
    ap.add_argument("--seeds", type=int, default=6)
    args = ap.parse_args()
    pkg = Path(args.package).resolve() if args.package else ROOT
    sys.path.insert(0, str(pkg))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("block_fp32_error: needs an NVIDIA GPU")
    import graph_physics_tpu_torch
    from graph_physics_tpu_torch.utils import gradcheck

    if pkg not in Path(graph_physics_tpu_torch.__file__).resolve().parents:
        raise SystemExit(f"block_fp32_error: imported {graph_physics_tpu_torch.__file__}, "
                         f"not the package of {pkg}")
    spec = importlib.util.spec_from_file_location("card_tests", pkg / "tests" /
                                                  "test_torch_cuda.py")
    cases = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cases)

    device = torch.device("cuda:0")
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}; package: {pkg}", flush=True)

    keys = ("kernel_fp32_l2", "plain_fp32_l2", "kernel_fp32_max", "plain_fp32_max")
    out = []
    for h in args.hidden:
        for layout in ("csr", "nk"):
            summary = {"l2_ratio": 0.0, "max_ratio": 0.0, "ok": True, "dx_kernel": 0,
                       "dx_control_min": None, "plain_fp32_l2": 0.0, "plain_fp32_max": 0.0}
            for variant in ("folded", "middle"):
                for seed in range(args.seeds):
                    if layout == "csr":
                        a, kw = cases._wide_hub_case(device, h, variant, 17, seed=seed)
                        x, e, senders, receivers, mask, edge, node, lay = a
                        rows_ = (senders, receivers, mask)
                        cot_x, cot_e = cases._csr_cotangents(x, lay.total_rows, 400 + seed)
                    else:
                        a, kw, cot_x, cot_e = cases._wide_nk_case(device, h, variant, 33,
                                                                  seed=seed, holes=True)
                        x, e, senders, mask, edge, node, lay = a
                        rows_ = (senders, mask)
                    rows, ok, _ = gradcheck.check_block_backward(
                        x, e, rows_, (kw["encoder_params"], edge, node), lay, kw["last_block"],
                        cot_x, cot_e)
                    dx = rows[0]
                    allowed = gradcheck.block_outside_share(h) * dx["count"]
                    out.append({"hidden": h, "layout": layout, "variant": variant, "seed": seed,
                                "ok": ok, "dx_allowed": allowed,
                                "rows": [{k: r.get(k) for k in ("name", "outside",
                                                                 "fp32_outside", "count", *keys)}
                                         for r in rows]})
                    summary["ok"] = summary["ok"] and ok
                    summary["dx_kernel"] = max(summary["dx_kernel"], dx["outside"] / allowed)
                    ctl = dx["fp32_outside"] / allowed
                    summary["dx_control_min"] = (ctl if summary["dx_control_min"] is None
                                                 else min(summary["dx_control_min"], ctl))
                    for r in rows:
                        summary["plain_fp32_l2"] = max(summary["plain_fp32_l2"],
                                                       r["plain_fp32_l2"])
                        summary["plain_fp32_max"] = max(summary["plain_fp32_max"],
                                                        r["plain_fp32_max"])
                        summary["l2_ratio"] = max(summary["l2_ratio"], r["kernel_fp32_l2"]
                                                  / max(r["plain_fp32_l2"], 1e-30))
                        summary["max_ratio"] = max(summary["max_ratio"], r["kernel_fp32_max"]
                                                   / max(r["plain_fp32_max"], 1e-30))
            print(f"hidden {h} {layout} ({2 * args.seeds} cases): all within bounds "
                  f"{summary['ok']}; kernel/plain fp32 error, largest over gradients and "
                  f"cases: L2 {summary['l2_ratio']:.4g} (bound {gradcheck.FP32_L2_RATIO}), "
                  f"max {summary['max_ratio']:.4g} (bound {gradcheck.FP32_MAX_RATIO}); the "
                  f"plain version's largest fp32 error: L2 {summary['plain_fp32_l2']:.4g}, "
                  f"max {summary['plain_fp32_max']:.4g}; dx outside the plain bound over the "
                  f"share allowed: kernel at most {summary['dx_kernel']:.4g}, fp32 control at "
                  f"least {summary['dx_control_min']:.4g}", flush=True)
            torch.cuda.empty_cache()
    print(json.dumps({"card": card, "package": str(pkg), "cases": out}))


if __name__ == "__main__":
    main()
