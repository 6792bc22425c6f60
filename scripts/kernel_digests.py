"""Digests of the attention kernels' outputs at head widths 16 and 32, of
the gated-FFN kernels' (GELU) at every hidden width and of the
GraphNetBlock kernels' (relu) at hidden 32, 64 and 128, on one NVIDIA
GPU: whether a change to the kernels' sources left those instances' bits
as they were.

    python3 scripts/kernel_digests.py                  # this checkout's kernels
    python3 scripts/kernel_digests.py --root CHECKOUT  # another checkout's

Each case feeds fixed inputs, drawn with numpy from a seed, through one
wrapper of the checkout's port (its kernels built from its csrc/ at first
use) and hashes every output's bytes with SHA-256: the attention forward
(output, and under ``keep_stats`` the max and 1/denominator) and its
backward's dq, dk, dv, in the NK layout on the 48x40 cylinder mesh at
B=64 with 4 heads of 16 (the cylinder transformer's shape) and of 32 (the
panels transformer's head width and batch), with and without world
pieces, and in the CSR layout on a 1,500-node graded mesh at B=16; the
gated FFN's output and its backward's dx and eight parameter gradients at
[1,920, 64, h] for h = 1 to 128; a GraphNetBlock's x_out, e_out and its
backward's dx, de (none when folded) and every MLP parameter's gradient,
the folded first block and a middle block of a cylinder ``epd`` in the NK
layout (the 20x16 mesh, B=16) and in the CSR layout (a 1,536-node graded
mesh, B=4). Prints one JSON object: the card, its SM count (the
backwards' block partials follow it) and the digests. ``RECORDED`` holds
those of earlier trees, each run this way with ``--root`` on an NVIDIA
H100 80GB HBM3 (132 SMs): the attention's and the FFN's at hidden 64 and
128 from the tree before the kernels took every head width and hidden
width dividing 128, the others from the tree before the GraphNetBlock
kernels took every width and activation, but ``gn_csr_h128_middle``, from
the tree of the hidden-64/128 kernels' wgmma redesign, and ``ffn_h128``,
from the tree of the hidden-128 FFN kernels' wgmma redesign; ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` hold this tree's digests to them. Imports
nothing of JAX.
"""

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
#: earlier trees' digests, by the card's SM count: the script run with
#: --root on a parent checkout, on an NVIDIA H100 80GB HBM3 at 700 W (the
#: attention's and the FFN's at hidden 64 and 128 from the tree before the
#: kernels took every head width and FFN width, the others from the tree
#: before the GraphNetBlock kernels took every width and activation).
#: ``gn_csr_h128_middle`` is the wgmma redesign's (run on its tree): its
#: bias and RMSNorm-scale gradients add their fp32 terms in another order
#: (per-group column sums, the scale's summed per warp on the chip), which
#: moved one of its bf16-rounded gradients; the products keep the
#: tensor cores' k16 order, so the other hidden-64/128 cases kept their
#: digests, and the hidden-32-and-below instances are the parent's code.
#: ``ffn_h128`` is the hidden-128 FFN kernels' wgmma redesign's (run on its
#: tree): the forward's y and the backward's g_h and weight gradients add
#: their fp32 terms in the wgmma tiles' k16 order over another split of
#: the middle (slices of 64 columns; the backward's six shares of g_h added
#: in rank order, its weight gradients summed over each of 16 clusters'
#: tiles, then the clusters in order), and the RMS norms' row sums over
#: four chains a lane; every bf16 rounding point is the parent's.
RECORDED = {
    132: {
        "attention_nk_dh16":
            "af400d79c8173f16ddba97829bf271d2207fed26c4857f54cbd9d0a9c510d71b",
        "attention_nk_dh16_world":
            "4cb842a21c975dbeceaa40af3224221332c291da494f62044b0640ca86670403",
        "attention_nk_dh32":
            "89637e5659a64370318298a226a81def4c3033ecd952a3103e7a814c838493a3",
        "attention_nk_dh32_world":
            "909b062787441eefdab36bbf6e02c61de9be41d65eb4e242a09cb3c9ab4a7b50",
        "attention_csr_dh16":
            "f4b3721ef7df393ae514cfca1852635fa4d6408c19c78037785cada1bbe948b5",
        "attention_csr_dh32":
            "91f2832d137320930f28a341306dae8a789f79a18d83559a0c65f6f2b0a8d1dc",
        "ffn_h1":
            "c5319729fe07cdac67153f2ad1d2b058608f10c8102bbc67607848180742a171",
        "ffn_h2":
            "ee98f374aec99091a062a1b2a7662cea9c7fb062c96924c6dc88d035e474884b",
        "ffn_h4":
            "283834f0e4e9e7d4b7ed18da27873da22312619329f343b7e3b332ebf2ff31f8",
        "ffn_h8":
            "f896714aef059551f9f69f3911cf1e34550456c66dfd899cee3ba6c1213c9531",
        "ffn_h16":
            "e9962b86c5d4728523b72d6203df5df69a86edf47e1a4fc6ed24077a43ce1080",
        "ffn_h32":
            "9a07076c6025ff463e71813d75f22b543440a623849e9d680c80f1609041bfc2",
        "ffn_h64":
            "e49481239940f8edfd92bf3b7665726c939d7c1b1c0ae2d0f948d9ff03add18f",
        "ffn_h128":
            "150d174bd62851842ebaf39bacdb28f0500390bc2a8cf43c0f285011d9ba7d61",
        "gn_nk_h32_folded":
            "b514ac1c6efbdf88ccadce72c866470c57d5fa616bc529ac3b9d78e8d067fbd5",
        "gn_nk_h32_middle":
            "c04836fddeabe9d3d7c93bafc2f3fb5731c4d74a02b249365a22e336710738fd",
        "gn_nk_h64_folded":
            "276a1bb5d78e73093967418b53d8f317f02a399db261b4f3ac7ada79a6846242",
        "gn_nk_h64_middle":
            "3a8a49a289836b8bac731815d76f2336997b36f4d120a5f3cb4f83b56932e7d2",
        "gn_nk_h128_folded":
            "270e122c84de099df9e3d528e3f9cc98746bb490f13ea925652e2e28519027a0",
        "gn_nk_h128_middle":
            "cfaad6274accc974a9effc18cd10b26d7c134c46fe634be0d418ca315d9ff700",
        "gn_csr_h32_folded":
            "8bdaa08613360725ef0f3009206f4b3b9f901d306fa5096917ad7c30290aa6c6",
        "gn_csr_h32_middle":
            "93c05e98e0916bdd2f1ca6c74f433c7c723443d5f484093ce5364c3ff595b88d",
        "gn_csr_h64_folded":
            "fac82765f2ded81c858fae81e411da8b7296678efe1429deb7f090db3ac53f29",
        "gn_csr_h64_middle":
            "d760e176e941a7661f7f4d419992e695807d3b12bf1fb778d7ac5c180f7c2a14",
        "gn_csr_h128_folded":
            "c4ab64ab240bea9d8344bb5c58b8ed859b30e23094020755c98d1414c394180b",
        "gn_csr_h128_middle":
            "000edc0a65c0254e5e466c76a4cb49b6ca7f5281e67d17724f867c26d1b0ef56",
    },
}


def _bf16(torch, a, device):
    return torch.as_tensor(np.ascontiguousarray(a, np.float32)).to(device, torch.bfloat16)


def _digest(torch, tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def attention_case(torch, entry, ops, layout, head_dim, world, device):
    """Outputs of one attention case: forward, its kept statistics, and the
    backward's gradients (with world pieces also dnum_w, dden_w)."""
    rng = np.random.default_rng(1000 + head_dim + 7 * (layout == "csr") + 3 * world)
    if layout == "nk":
        setup = entry.transformer_setup(device, nx=48, ny=40, batch=64, mp_steps=1)
        fn, kernels = ops.fused_edge_attention_nk, ops.KERNELS
    else:
        setup = entry.graded_transformer_setup(device, num_nodes=1500, batch=16, mp_steps=1)
        fn, kernels = ops.fused_edge_attention_csr, ops.KERNELS
    g, lay = setup.graph, setup.tiling
    shape = (lay.num_nodes, g.x.shape[1], 4, head_dim)
    q, k, v, cot = (_bf16(torch, s * rng.standard_normal(shape), device)
                    for s in (0.5, 0.5, 0.5, 1.0))
    rows = (g.senders, g.receivers, g.edge_mask)
    parts = None
    if world:
        f32 = dict(dtype=torch.float32, device=device)
        parts = (torch.as_tensor(rng.standard_normal(shape).astype(np.float32), **f32),
                 torch.as_tensor(rng.uniform(0.5, 2.0, shape[:3]).astype(np.float32), **f32),
                 torch.as_tensor(rng.uniform(-1.0, 1.0, shape[:3]).astype(np.float32), **f32))
    kw = {} if parts is None else {"world": parts}
    with torch.no_grad():
        out, stats = kernels[0](q, k, v, *rows, lay, keep_stats=True, **kw)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    wl = [] if parts is None else [t.clone().requires_grad_(True) for t in parts[:2]]
    wp = {} if parts is None else {"world_parts": (*wl, parts[2])}
    grads = torch.autograd.grad(fn(*leaves, *rows, lay, **wp), leaves + wl, cot)
    return [out, *stats, *grads]


def ffn_case(torch, layers, ffn_ops, hidden, device):
    """Outputs of one gated-FFN case: y, then dx and the eight parameter
    gradients."""
    rng = np.random.default_rng(2000 + hidden)
    block = layers.GatedMLPBlock(hidden, hidden, hidden)
    norm2 = layers.RMSNorm(hidden)
    with torch.no_grad():
        for p in block.parameters():
            fan_in = p.shape[-1] if p.ndim == 2 else hidden
            p.copy_(torch.as_tensor(rng.standard_normal(tuple(p.shape)).astype(np.float32)
                                    / np.sqrt(fan_in)))
        for norm in (block.norm, norm2):
            norm.scale.copy_(torch.as_tensor(
                (1.0 + 0.2 * rng.standard_normal(hidden)).astype(np.float32)))
    block, norm2 = block.to(device), norm2.to(device)
    x, cot = (_bf16(torch, rng.standard_normal((1920, 64, hidden)), device) for _ in range(2))
    with torch.no_grad():
        y = ffn_ops.fused_gated_ffn(x, block, norm2)
    xl = x.clone().requires_grad_(True)
    grads = torch.autograd.grad(ffn_ops.fused_gated_ffn(xl, block, norm2),
                                [xl, *ffn_ops._params(block, norm2)], cot)
    return [y, *grads]


def gn_case(torch, entry, layout, hidden, variant, device):
    """Outputs of one GraphNetBlock case: x_out, e_out, then dx, de (not
    when folded) and every MLP parameter's gradient in the kernels'
    order."""
    rng = np.random.default_rng(3000 + hidden + 7 * (layout == "csr") + 3 * (variant == "folded"))
    if layout == "nk":
        setup = entry.cylinder_setup(device, nx=20, ny=16, hidden=hidden, batch=16, mp_steps=3)
        from graph_physics_tpu_torch.ops.fused_gnblock_nk import fused_gn_block_nk as fn
        rows = (setup.graph.senders, setup.graph.edge_mask)
    else:
        setup = entry.graded_setup(device, num_nodes=1536, hidden=hidden, batch=4, mp_steps=3)
        from graph_physics_tpu_torch.ops.fused_gnblock_csr import fused_gn_block_csr as fn
        rows = (setup.graph.senders, setup.graph.receivers, setup.graph.edge_mask)
    model, lay = setup.simulator.model, setup.tiling
    n, b = setup.graph.x.shape[:2]
    fold = variant == "folded"
    blk = model.processor_list[0 if fold else 1]
    enc = model.edges_encoder if fold else None
    width = entry.EDGE_INPUT if fold else hidden
    x = _bf16(torch, 0.5 * rng.standard_normal((n, b, hidden)), device)
    e = _bf16(torch, 0.5 * rng.standard_normal((lay.total_rows, b, width)), device)
    cots = [_bf16(torch, rng.standard_normal(shape), device)
            for shape in ((n, b, hidden), (lay.total_rows, b, hidden))]
    mlps = [m for m in (enc, blk.edge_block, blk.node_block) if m is not None]
    params = [p for m in mlps for p in m.parameters()]
    xl = x.clone().requires_grad_(True)
    el = e.clone().requires_grad_(not fold)
    xo, eo = fn(xl, el, *rows, blk.edge_block, blk.node_block, lay, encoder_params=enc)
    grads = torch.autograd.grad([xo, eo], [xl] + ([] if fold else [el]) + params, cots)
    return [xo, eo, *grads]


def digests(root=ROOT, device="cuda"):
    """{case: SHA-256 of its outputs} for the port under ``root``."""
    sys.path.insert(0, str(Path(root).resolve()))
    import torch
    from graph_physics_tpu_torch import entry
    from graph_physics_tpu_torch.models import layers
    from graph_physics_tpu_torch.ops import fused_edge_attention_csr as csr_ops
    from graph_physics_tpu_torch.ops import fused_edge_attention_nk as nk_ops
    from graph_physics_tpu_torch.ops import fused_ffn as ffn_ops

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device(device)
    out = {}
    for layout, ops in (("nk", nk_ops), ("csr", csr_ops)):
        for dh in (16, 32):
            for world in (False, True):
                if layout == "csr" and world:
                    continue
                name = f"attention_{layout}_dh{dh}" + ("_world" if world else "")
                out[name] = _digest(torch, attention_case(torch, entry, ops, layout, dh, world,
                                                          device))
    for h in (1, 2, 4, 8, 16, 32, 64, 128):
        out[f"ffn_h{h}"] = _digest(torch, ffn_case(torch, layers, ffn_ops, h, device))
    for layout in ("nk", "csr"):
        for h in (32, 64, 128):
            for variant in ("folded", "middle"):
                out[f"gn_{layout}_h{h}_{variant}"] = _digest(
                    torch, gn_case(torch, entry, layout, h, variant, device))
    torch.cuda.synchronize()
    return out


def card_key():
    """The card's SM count, which the recorded digests are keyed by."""
    import torch

    return torch.cuda.get_device_properties(0).multi_processor_count


def check(got, sms):
    """Raises unless ``got`` equals the recorded digests for a card of
    ``sms`` SMs; returns the names of the cases held."""
    want = RECORDED.get(sms)
    if want is None:
        raise AssertionError(f"no recorded digests for a card of {sms} SMs (recorded: "
                             f"{sorted(RECORDED)})")
    bad = sorted(k for k in want if got.get(k) != want[k])
    if bad or set(got) != set(want):
        raise AssertionError(f"other bits than the recorded tree's in {bad or sorted(got)}")
    return sorted(want)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=str(ROOT), help="the checkout whose port to run")
    args = parser.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "-i", "0"],
                          capture_output=True, text=True, check=True).stdout.strip()
    got = digests(args.root)
    print(json.dumps({"card": card, "sms": card_key(), "root": args.root, "digests": got}))


if __name__ == "__main__":
    main()
