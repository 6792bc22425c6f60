"""Time the hidden-128 gated-FFN kernels (rows 9 and 10 at panels' width,
``csrc/fused_ffn128.cu`` and ``fused_ffn128_bwd.cu``) on a card, beside the
same products as bf16 ``torch.matmul`` calls, and with ``--parent`` in
turns with another checkout's kernels.

    python3 scripts/ffn128_times.py [--parent CHECKOUT] [--cases nodes:batch:act ...]

Each case ``nodes:batch:act`` (default: panels' shape 1920:64:gelu, then
1920:64:silu, 1001:3:gelu and 1920:8:gelu) draws x, the cotangent and a
GatedMLPBlock with its norm2 from a seed, checks the forward against its
plain version (0.05) and the backward against its plain backward and fp32
autograd (utils/gradcheck.py), then times the forward and one backward
(``autograd.grad`` on a retained graph) through
``chip_smoke.ffn128_times``: CUDA-event medians, the profiler's device
time by kernel, and the peak memory a backward call allocates beyond its
inputs. With ``--parent`` each number is also taken with the parent's
wrapper and libraries, in turns (parent, this tree, this tree, parent),
on the same inputs. At panels' shape it also times, as a
yardstick and not as the same function, the products alone as bf16
``torch.matmul`` calls at [rows, 128] x [128, 384]: the forward's 3 and
the backward's 8. Builds only the gated-FFN libraries of both checkouts.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CASES = ("1920:64:gelu", "1920:64:silu", "1001:3:gelu", "1920:8:gelu")
LIBS = ("ffn128", "ffn128_bwd")
GRAD_NAMES = ("dx", "norm2.scale", "norm.scale", "W1", "b1", "W2", "b2", "W3", "b3")


def matmul_yardstick(cs, rows, device):
    """Device ms of the forward's 3 and the backward's 8 products at
    [rows, 128] x [128, 384] as bf16 torch.matmul calls."""
    import torch

    gen = torch.Generator(device=device).manual_seed(7)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)

    n, g = rand(rows, 128), rand(rows, 128)
    w1, w2, w3 = rand(384, 128), rand(384, 128), rand(128, 384)
    mid, ga1, ga2 = rand(rows, 384), rand(rows, 384), rand(rows, 384)

    def forward():
        torch.matmul(n, w1.t()), torch.matmul(n, w2.t()), torch.matmul(mid, w3.t())

    def backward():
        torch.matmul(n, w1.t()), torch.matmul(n, w2.t()), torch.matmul(g, w3)
        torch.matmul(ga1, w1), torch.matmul(ga2, w2)
        torch.matmul(ga1.t(), n), torch.matmul(ga2.t(), n), torch.matmul(g.t(), mid)

    return {"forward_3_products_ms": cs.device_ms(forward),
            "backward_8_products_ms": cs.device_ms(backward)}


def check_case(cs, ffn_ops, gradcheck, block, norm2, x, cot):
    """The forward's max abs error against its plain version and the
    backward's gradcheck rows; raises on a bound missed."""
    import torch

    with torch.inference_mode():
        y = ffn_ops.fused_gated_ffn(x, block, norm2)
        err = cs.compare("y", y, ffn_ops.gated_ffn_reference(x, block, norm2), cs.FFN_TOL)

    def feed_forward(fn, m, n2):
        return lambda xx: (fn(xx, m, n2), ffn_ops._params(m, n2))

    rows, ok, _ = gradcheck.check_backward(
        list(GRAD_NAMES), ("dx",), feed_forward(ffn_ops.fused_gated_ffn, block, norm2),
        feed_forward(ffn_ops.reference_with_backward, block, norm2),
        feed_forward(ffn_ops.gated_ffn_reference, gradcheck.rounded_copy(block),
                     gradcheck.rounded_copy(norm2)), [x], [cot])
    cs.log_grad_rows(rows)
    if not ok:
        raise AssertionError("hidden-128 FFN backward out of bounds")
    return err


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a checkout whose kernels are timed in turns")
    ap.add_argument("--cases", nargs="+", default=list(CASES))
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from graph_physics_tpu_torch.models.layers import GatedMLPBlock, RMSNorm, reset_parameters
    from graph_physics_tpu_torch.ops import fused_ffn as ffn_ops
    from graph_physics_tpu_torch.ops import kernel_build
    from graph_physics_tpu_torch.utils import gradcheck

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "-i", "0"],
                          capture_output=True, text=True, check=True).stdout.strip()
    cs.log(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ours = {n: kernel_build.LIBRARIES[n] for n in LIBS}
    kernel_build.LIBRARIES.clear()
    kernel_build.LIBRARIES.update(ours)
    t0 = time.time()
    if args.parent:
        cs.PARENT = Path(args.parent).resolve()
        for name in [n for n in cs.PARENT_LIBS if n not in LIBS]:
            del cs.PARENT_LIBS[name]
        cs.start_parent_builds()
    cs.log(kernel_build.build())
    for name in LIBS if args.parent else ():
        cs.parent_library(name)
    cs.log(f"build: {time.time() - t0:.1f} s")
    device = torch.device("cuda")
    results = {}
    for case in args.cases:
        nodes, batch, act = case.split(":")
        nodes, batch = int(nodes), int(batch)
        gen = torch.Generator().manual_seed(24)
        block, norm2 = GatedMLPBlock(128, 128, 128, use_silu=act == "silu"), RMSNorm(128)
        reset_parameters(block, gen)
        with torch.no_grad():
            for norm in (block.norm, norm2):
                norm.scale.copy_(1.0 + 0.2 * torch.randn(128, generator=gen))
        block, norm2 = block.to(device), norm2.to(device)
        x, cot = (torch.randn((nodes, batch, 128), generator=gen).to(device, torch.bfloat16)
                  for _ in range(2))
        label = f"[{nodes}·{batch}, 128] {act}"
        cs.log(f"{label}: check")
        rec = {"max_abs_err": check_case(cs, ffn_ops, gradcheck, block, norm2, x, cot)}
        rec.update(cs.ffn128_times(x, cot, block, norm2))
        cs.log(f"{label}: " + json.dumps(rec))
        results[case] = rec
        if nodes * batch == 1920 * 64 and act == "gelu":
            ys = matmul_yardstick(cs, nodes * batch, device)
            cs.log(f"{label}: bf16 torch.matmul yardstick, device ms: " + json.dumps(ys))
            results["matmul_yardstick"] = ys
    cs.log("ffn128 times " + json.dumps({"card": card, **results}))


if __name__ == "__main__":
    main()
