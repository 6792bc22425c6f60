"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Imports no jax (the card's machine has none), so it runs there with

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Every test needs a card and skips without one. Tolerances are the JAX
suite's: rtol = atol = 0.05 kernel vs plain version, 0.15 for the whole
model against the plain edge-list path, 0.02 on a loss
(tests/test_fused_gnblock_nk.py); the backward's bounds are
graph_physics_tpu_torch/utils/gradcheck.py's. For the transformer: rtol
0.03, atol 0.02 for the attention kernel (tests/test_fused_edge_attention_nk.py:
96-99), rtol = atol = 0.05 for the gated-FFN kernel (tests/test_fused_ffn.py:
27-30) and 0.1 for the whole model (tests/test_fused_edge_attention_nk.py:171);
the transformer's backward kernels are held with utils/gradcheck.py, and
its train step to the ``epd`` step's bounds (step-1 loss 0.02, gradients
0.04 · max). The graded mesh's CSR kernels take the bounds of their NK
counterparts: 0.05 (GraphNetBlock), rtol 0.03 atol 0.02 (attention, its
plain version ``ops/edge_attention.edge_attention``), 0.15 and 0.1 for
the models; their backward kernels are held with utils/gradcheck.py at a
small size and at the graded slice's (27,000 nodes x 16 samples), and
the graded train steps to the same bounds as the cylinder's. The NK
GraphNetBlock forward and backward are also held on a mesh whose masked
slots sit between a receiver's valid ones and whose node N-1 owns valid
slots (a masked slot's e_out is its e_in, bit for bit); both, and the
gated-FFN forward and backward (also at a row count that is not a
multiple of their 128- and 64-row tiles), give the same bits on two
calls; so do their hidden-128 instances, held against the plain versions
at 1, 63, 64, 65, 1,001 x 3 and 1,920 x 8 rows with either activation
(fewer and more of the backward's 64-row tiles than its clusters), the
backward allocating less than one [rows, 3H] bf16 array at panels'
shape. The CSR
GraphNetBlock forward and backward are also held on a hub mesh (a
receiver of in-degree 150, receivers with no row or only masked rows,
node N-1 owning rows) at partial 16-sample tiles, and give the same bits
on two calls (the forward's outputs, the backward's dx and de; at hidden
32 every weight gradient too, in both layouts). The NK
attention forward and backward are also held at every head width
dividing 128, with masked slots between valid ones, on a K = 41 hub
layout, with the forward's kept statistics against ``softmax_stats``,
and give the same bits on two calls; so are the CSR attention's and both
layouts' world seams at every head width, and the gated FFN at hidden
32 to 1 (forward, backward, the same bits on two calls). A 2-block
transformer trains through both kernel families at every hidden and
head width that had no instance before, within 0.02 of the plain path's
loss; the head widths 16 and 32 and hidden 64 and 128 give the parent
tree's bits (scripts/kernel_digests.py's recorded digests). Rows
1-4 at hidden 64 and 128 (the wide GraphNetBlock kernels) are held the
same way, every variant, in both layouts (on the padding-leak NK mesh at
B=1 and 33, on the hub CSR graph at B=1 and 17), give the same bits on
two calls (outputs, dx, de and every weight gradient), and carry a
3-block ``epd`` train step at each width; they are also held at every
way a 64-sample warpgroup tile fills (B=16, 37, 64, 128) with MLPs of 1 to
8 layers, and their warpgroup products, TMA boxes and fragments
(``csrc/wgmma_common.cuh``) against ``torch.matmul``. Their world seam (``extra_agg``,
the world edges' aggregate) is held at hidden 32, 64 and 128 in both
layouts: rows 1 and 3 against their plain versions, rows 2 and 4 with
the extra aggregate's cotangent dea through utils/gradcheck.py, a zero
extra giving the bits of none, and a plate ``epd`` train step with world
edges in every sample against the plain path. Rows 1-4 at hidden 16 to
1 (relu, every variant, on the NK padding-leak mesh at B=33 and the CSR
hub graph at B=17) and with silu or exact-gelu MLPs at every width 1 to
128 are held the same way, give the same bits on two calls, keep
dx inside the width's outside share where the fp32 control leaves it,
and carry 3-block ``epd`` train steps at hidden 16, 4 and 1 and with
silu and gelu blocks within 0.02 of the plain path; hidden 16 launches
in both layouts, while hidden 24 (which JAX does not fuse) and a 9-layer
MLP raise, and a hidden-24 model runs the plain path with no launch. The
radius search (ops/knn.radius_edges) on the card gives the CPU's index
arrays on a grid of exact positions and the CPU's pairs on random ones,
and a DeformingPlate rollout whose world edges are found again at every
step, like an aneurysm rollout that carries its acceleration columns,
launches its kernels once a block a step and keeps within 0.15 of the
plain path's RMSE. The
gumbel kernel draws the same Philox bits as its plain version, bit for bit, and
its output is within 1e-5 of the plain version's (``logf`` on the card
against ``torch.log``, at |noise| < 17); the Transolver train step runs
it once per block forward and never in the backward, and keeps to the
``epd`` step's bounds against the plain path on the same bits. The
transformer's gates follow JAX's: hidden 256 with 8 heads trains with
the attention kernels and the plain FFN, head width 24 with neither. The
host mesh library (csrc/meshops.cc) builds there with g++ and gives its
plain versions' arrays, and a batch of one sub-mesh part trains through
the GraphNetBlock kernels.
"""

import copy
import itertools

import numpy as np
import pytest
import torch

from graph_physics_tpu_torch import entry
from graph_physics_tpu_torch.models.layers import (
    ACTIVATIONS,
    MLP,
    Activation,
    GatedMLPBlock,
    RMSNorm,
    reset_parameters,
)
from graph_physics_tpu_torch.ops.edge_attention import edge_attention, world_attention_parts
from graph_physics_tpu_torch.ops import fused_edge_attention_csr as ea_csr_ops
from graph_physics_tpu_torch.ops import fused_edge_attention_nk as ea_ops
from graph_physics_tpu_torch.ops import fused_ffn as ffn_ops
from graph_physics_tpu_torch.ops import fused_gnblock_csr as fused_gn_block_csr_ops
from graph_physics_tpu_torch.ops import fused_gnblock_nk as nk_ops
from graph_physics_tpu_torch.ops import gumbel as gumbel_ops
from graph_physics_tpu_torch.models.transolver import use_plain_gumbel
from graph_physics_tpu_torch.ops.fused_edge_attention_nk import (
    fused_edge_attention_nk,
    fused_edge_attention_nk_reference,
)
from graph_physics_tpu_torch.ops.fused_edge_attention_csr import fused_edge_attention_csr
from graph_physics_tpu_torch.ops.fused_ffn import fused_gated_ffn, gated_ffn_reference
from graph_physics_tpu_torch.ops.fused_gnblock_csr import (
    fused_gn_block_csr,
    fused_gn_block_csr_reference,
)
from graph_physics_tpu_torch.ops.fused_gnblock_nk import (
    fused_gn_block_nk,
    fused_gn_block_nk_reference,
)
from graph_physics_tpu_torch.ops.tiling import NKTiling, build_csr_layout
from graph_physics_tpu_torch.utils import gradcheck


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda")


#: the processor block of a variant: the first with its edge encoder folded
#: in, the first taking encoded edges (where the encoder does not fold,
#: hidden 4 and below), a middle one, the last
BLOCK_OF = {"folded": 0, "first": 0, "middle": 1, "last": -1}


def _block_args(setup, variant, seed):
    model, graph, nk = setup.simulator.model, setup.graph, setup.tiling
    n, b = graph.x.shape[:2]
    gen = torch.Generator(device=graph.x.device).manual_seed(seed)
    width = entry.EDGE_INPUT if variant == "folded" else model.hidden_size

    def randn(*shape):
        return (0.5 * torch.randn(shape, generator=gen, device=graph.x.device)).to(torch.bfloat16)

    block = BLOCK_OF[variant]
    blk = model.processor_list[block]
    args = (randn(n, b, model.hidden_size), randn(nk.total_rows, b, width), graph.senders,
            graph.edge_mask, blk.edge_block, blk.node_block, nk)
    kw = dict(encoder_params=model.edges_encoder if variant == "folded" else None,
              last_block=variant == "last")
    return args, kw


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [4, 33])
@pytest.mark.parametrize("variant", ["folded", "middle", "last"])
def test_kernel_matches_plain_version(cuda_device, variant, batch):
    setup = entry.cylinder_setup(cuda_device, nx=20, ny=16, batch=batch)
    args, kw = _block_args(setup, variant, seed=batch)
    with torch.no_grad():
        before = fused_gn_block_nk.launches
        kx, ke = fused_gn_block_nk(*args, **kw)
        torch.cuda.synchronize()
        assert fused_gn_block_nk.launches == before + 1
        px, pe = fused_gn_block_nk_reference(*args, **kw, compute_dtype=torch.bfloat16)
    torch.testing.assert_close(kx.float(), px.float(), rtol=0.05, atol=0.05)
    if variant == "last":
        assert ke is args[1]  # the dead edge stream is passed through
    else:  # padded slots of a folded block hold enc(raw): valid slots only
        rows = args[3] if variant == "folded" else slice(None)
        torch.testing.assert_close(ke.float()[rows], pe.float()[rows], rtol=0.05, atol=0.05)


@pytest.mark.cuda
def test_backward_goes_through_the_backward_kernel(cuda_device):
    setup = entry.cylinder_setup(cuda_device, nx=20, ny=16, batch=4)
    args, kw = _block_args(setup, "middle", seed=0)
    x = args[0].clone().requires_grad_(True)
    e = args[1].clone().requires_grad_(True)
    before = (fused_gn_block_nk.launches, fused_gn_block_nk.backward_launches)
    xo, eo = fused_gn_block_nk(x, e, *args[2:], **kw)  # parameters require grad
    (xo.float().sum() + eo.float().sum()).backward()
    torch.cuda.synchronize()
    assert (fused_gn_block_nk.launches, fused_gn_block_nk.backward_launches) == (
        before[0] + 1, before[1] + 1)
    blk = setup.simulator.model.processor_list[1]
    for t in (x.grad, e.grad, *[p.grad for p in blk.parameters()]):
        assert t is not None and torch.isfinite(t).all()
    assert x.grad.dtype == torch.bfloat16 and blk.edge_block[0].weight.grad.dtype == torch.float32


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [4, 33])
@pytest.mark.parametrize("variant", ["folded", "middle", "last"])
def test_backward_kernel_matches_plain_version(cuda_device, variant, batch):
    """Bounds and their reasons: graph_physics_tpu_torch/utils/gradcheck.py."""
    setup = entry.cylinder_setup(cuda_device, nx=20, ny=16, batch=batch)
    args, kw = _block_args(setup, variant, seed=batch)
    x, e, senders, mask, edge, node, nk = args
    gen = torch.Generator(device=cuda_device).manual_seed(100 + batch)
    cot_x = torch.randn(x.shape, generator=gen, device=cuda_device).to(torch.bfloat16)
    cot_e = torch.randn((nk.total_rows,) + x.shape[1:], generator=gen,
                        device=cuda_device).to(torch.bfloat16)
    before = fused_gn_block_nk.backward_launches
    rows, ok, _ = gradcheck.check_block_backward(
        x, e, (senders, mask), (kw["encoder_params"], edge, node), nk, kw["last_block"],
        cot_x, cot_e)
    torch.cuda.synchronize()
    assert fused_gn_block_nk.backward_launches == before + 1
    assert ok, [r for r in rows if not r["ok"]]


def _hole_mask(nk, mask):
    """``mask`` with slot k=1 of every third receiver whose slot k=2 is valid
    masked out: masked slots between valid slots of one receiver."""
    m = mask.clone().view(-1, nk.k_slots, nk.node_block)
    hole = m[:, 2] & (torch.arange(nk.node_block, device=mask.device) % 3 == 0)
    m[:, 1] &= ~hole
    return m.reshape(-1).contiguous()


def _nk_backward_case(cuda_device, variant, seed, holes=False):
    """A block's inputs on the 16 x 16 cylinder mesh (256 nodes in two node
    blocks: node N-1 is real and owns valid slots), B=5, and random
    cotangents of every slot."""
    setup = entry.cylinder_setup(cuda_device, nx=16, ny=16, batch=5)
    args, kw = _block_args(setup, variant, seed=seed)
    x, e, senders, mask, edge, node, nk = args
    assert nk.num_nodes == 256 and setup.graph.node_mask[-1]
    if holes:
        mask = _hole_mask(nk, mask)
    gen = torch.Generator(device=cuda_device).manual_seed(200 + seed)
    cot_x = torch.randn(x.shape, generator=gen, device=cuda_device).to(torch.bfloat16)
    cot_e = torch.randn((nk.total_rows,) + x.shape[1:], generator=gen,
                        device=cuda_device).to(torch.bfloat16)
    return x, e, (senders, mask), (kw["encoder_params"], edge, node), nk, kw["last_block"], \
        cot_x, cot_e


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["folded", "middle", "last"])
def test_backward_kernel_on_masked_slots_between_valid_ones(cuda_device, variant):
    """The padding-leak mesh: masked slots of a receiver sit between its
    valid ones, and node N-1 owns valid slots; against plain autograd of the
    plain version (utils/gradcheck.py)."""
    case = _nk_backward_case(cuda_device, variant, seed=7, holes=True)
    assert (~case[2][1].view(-1, case[4].k_slots, case[4].node_block)[:, 1]
            & case[2][1].view(-1, case[4].k_slots, case[4].node_block)[:, 2]).any()
    before = fused_gn_block_nk.backward_launches
    rows, ok, _ = gradcheck.check_block_backward(*case)
    torch.cuda.synchronize()
    assert fused_gn_block_nk.backward_launches == before + 1
    assert ok, [r for r in rows if not r["ok"]]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["middle", "last"])
def test_backward_kernel_dx_de_are_bit_identical_across_calls(cuda_device, variant):
    """No atomics are left on dx or de: two calls give the same bits."""
    x, e, (senders, mask), mlps, nk, last, cot_x, cot_e = _nk_backward_case(
        cuda_device, variant, seed=3)
    outs = []
    for _ in range(2):
        xl, el = x.clone().requires_grad_(True), e.clone().requires_grad_(True)
        xo, eo = fused_gn_block_nk(xl, el, senders, mask, mlps[1], mlps[2], nk,
                                   last_block=last)
        if last:
            outs.append(torch.autograd.grad(xo, [xl], cot_x))
        else:
            outs.append(torch.autograd.grad([xo, eo], [xl, el], [cot_x, cot_e]))
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["folded", "middle", "last"])
def test_kernel_on_masked_slots_between_valid_ones(cuda_device, variant):
    """The forward on the padding-leak mesh of the backward's test: masked
    slots of a receiver sit between its valid ones, node N-1 owns valid
    slots, B=5 (a partial 16-sample tile); against the plain version, and
    a masked slot's e_out is its e_in, bit for bit."""
    x, e, (senders, mask), (enc, edge, node), nk, last, _, _ = _nk_backward_case(
        cuda_device, variant, seed=11, holes=True)
    args = (x, e, senders, mask, edge, node, nk)
    kw = dict(encoder_params=enc, last_block=last)
    with torch.no_grad():
        before = fused_gn_block_nk.launches
        kx, ke = fused_gn_block_nk(*args, **kw)
        torch.cuda.synchronize()
        assert fused_gn_block_nk.launches == before + 1
        px, pe = fused_gn_block_nk_reference(*args, **kw, compute_dtype=torch.bfloat16)
    torch.testing.assert_close(kx.float(), px.float(), rtol=0.05, atol=0.05)
    if variant == "folded":  # e_in = enc(raw): the two encoders' roundings may differ
        torch.testing.assert_close(ke.float(), pe.float(), rtol=0.05, atol=0.05)
    elif variant == "middle":
        torch.testing.assert_close(ke.float(), pe.float(), rtol=0.05, atol=0.05)
        assert torch.equal(ke[~mask], e[~mask])


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["folded", "middle"])
def test_kernel_outputs_are_bit_identical_across_calls(cuda_device, variant):
    """No atomics in the forward: two calls give the same bits, the kept
    aggregate too."""
    x, e, (senders, mask), mlps, nk, last, _, _ = _nk_backward_case(cuda_device, variant,
                                                                     seed=12)
    with torch.no_grad():
        outs = [nk_ops._launch_fwd(x, e, senders, mask, nk, mlps, last, keep_agg=True)
                for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_train_step_goes_through_both_kernels_and_matches_plain_path(cuda_device):
    train = entry.cylinder_train_setup(cuda_device, nx=20, ny=16, batch=8)
    plain_sim = copy.deepcopy(train.simulator)
    plain_sim.model.tiling = None
    plain_state, plain_step = entry.make_trainer(plain_sim)
    n_blocks = len(train.simulator.model.processor_list)
    before = (fused_gn_block_nk.launches, fused_gn_block_nk.backward_launches)
    m = train.train_step(train.state, train.graph, torch.Generator(cuda_device).manual_seed(3))
    torch.cuda.synchronize()
    assert (fused_gn_block_nk.launches, fused_gn_block_nk.backward_launches) == (
        before[0] + n_blocks, before[1] + n_blocks)
    mp = plain_step(plain_state, train.graph, torch.Generator(cuda_device).manual_seed(3))
    assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])
    # the JAX suite's value bound (tests/test_fused_gnblock_nk.py:150)
    torch.testing.assert_close(m["loss"], mp["loss"], rtol=0.02, atol=0)
    for p in train.simulator.parameters():
        assert torch.isfinite(p).all()


@pytest.mark.cuda
def test_forward_goes_through_kernel_and_matches_plain_path(cuda_device):
    setup = entry.cylinder_setup(cuda_device, nx=20, ny=16, batch=8)
    sim, graph = setup.simulator, setup.graph
    plain = copy.deepcopy(sim)
    plain.model.tiling = None
    before = fused_gn_block_nk.launches
    out = sim.forward(graph, is_training=False)
    torch.cuda.synchronize()
    assert fused_gn_block_nk.launches == before + len(sim.model.processor_list)
    ref = plain.forward(graph, is_training=False)
    rows = graph.node_mask
    assert torch.isfinite(out.outputs).all()
    torch.testing.assert_close(out.net_out[rows], ref.net_out[rows], rtol=0.15, atol=0.15)


# ---- the graph transformer's kernels ----------------------------------------

#: every head width the attention kernels have an instance for: those
#: dividing 128, the widths JAX's gate fuses
HEAD_DIMS = (1, 2, 4, 8, 16, 32, 64, 128)

@pytest.mark.cuda
@pytest.mark.parametrize("head_dim", HEAD_DIMS)
@pytest.mark.parametrize("batch", [4, 33])
def test_attention_kernel_matches_plain_version(cuda_device, batch, head_dim):
    setup = entry.transformer_setup(cuda_device, nx=20, ny=16, batch=batch, mp_steps=2)
    g, nk = setup.graph, setup.tiling
    gen = torch.Generator(device=cuda_device).manual_seed(batch)
    q, k, v = [(0.5 * torch.randn((nk.num_nodes, batch, 4, head_dim), generator=gen,
                                  device=cuda_device)).to(torch.bfloat16) for _ in range(3)]
    mask = g.edge_mask.clone().view(nk.num_groups, nk.k_slots, nk.node_block)
    mask[:, :, :3] = False  # three receivers per node block with no valid slot
    for m in (g.edge_mask, mask.reshape(-1).contiguous()):
        before = fused_edge_attention_nk.launches
        out = fused_edge_attention_nk(q, k, v, g.senders, g.receivers, m, nk)
        torch.cuda.synchronize()
        assert fused_edge_attention_nk.launches == before + 1
        ref = fused_edge_attention_nk_reference(q, k, v, g.senders, g.receivers, m, nk)
        torch.testing.assert_close(out.float(), ref.float(), rtol=0.03, atol=0.02)
    empty = out.view(nk.num_groups, nk.node_block, -1)[:, :3]
    assert torch.equal(empty, torch.zeros_like(empty))


def _check_kept_stats(kernels, qkv, rows, layout):
    """The forward keeping its statistics gives the same output, and its max
    and 1/denominator match ``softmax_stats`` (the max to fp32 rounding of
    the logits' sum order, 1/denominator to 5e-3: a logit an ulp apart can
    round its bf16 weight the other way); -inf and 0 exactly where a
    receiver has no valid row."""
    with torch.no_grad():
        out = kernels[0](*qkv, *rows, layout)
        kept, (m, inv, *out32) = kernels[0](*qkv, *rows, layout, keep_stats=True)
        pm, pinv = ea_csr_ops.softmax_stats(*qkv[:2], *rows)
    assert torch.equal(kept, out)
    assert len(out32) == (qkv[0].shape[-1] <= ea_csr_ops.FP32_OUT_UP_TO)
    assert all(torch.equal(o.to(torch.bfloat16), out) for o in out32)
    has_rows = torch.isfinite(pm)
    torch.testing.assert_close(m[has_rows], pm[has_rows], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(inv[has_rows], pinv[has_rows], rtol=5e-3, atol=0)
    assert torch.equal(torch.isinf(m), ~has_rows) and (inv[~has_rows] == 0).all()


@pytest.mark.cuda
def test_nk_attention_kept_statistics_match_plain_version_at_the_slice(cuda_device):
    """The transformer slice's shape (the 48x40 mesh, B=64, 4 heads of 16),
    with three receivers per node block without a valid slot."""
    g, nk, qkv, _ = _attention_case(cuda_device, 64, seed=21)
    mask = g.edge_mask.clone().view(nk.num_groups, nk.k_slots, nk.node_block)
    mask[:, :, :3] = False
    for m in (g.edge_mask, mask.reshape(-1).contiguous()):
        _check_kept_stats(ea_ops.KERNELS, qkv, (g.senders, g.receivers, m), nk)


@pytest.mark.cuda
def test_nk_attention_kernels_on_masked_slots_between_valid_ones(cuda_device):
    """Masked slots of a receiver between its valid ones drop out of the
    walk: the forward, its statistics and the backward against the plain
    versions."""
    g, nk, qkv, cot = _attention_case(cuda_device, 4, seed=22, nx=16, ny=16)
    m = _hole_mask(nk, g.edge_mask)
    view = m.view(-1, nk.k_slots, nk.node_block)
    assert (~view[:, 1] & view[:, 2]).any()
    rows = (g.senders, g.receivers, m)
    with torch.no_grad():
        out = fused_edge_attention_nk(*qkv, *rows, nk)
        ref = fused_edge_attention_nk_reference(*qkv, *rows, nk)
    torch.testing.assert_close(out.float(), ref.float(), rtol=0.03, atol=0.02)
    _check_kept_stats(ea_ops.KERNELS, qkv, rows, nk)
    _check_nk_backward(qkv, rows, nk, cot)


def _check_nk_backward(qkv, rows, nk, cot):
    """The NK backward kernel against the plain backward and fp32 autograd
    (utils/gradcheck.py), launched once; returns the kernel's gradients."""
    names = ("dq", "dk", "dv")

    def attention(fn):
        return lambda *t: (fn(*t, *rows, nk), [])

    before = fused_edge_attention_nk.backward_launches
    grad_rows, ok, kept = gradcheck.check_backward(
        names, names, attention(fused_edge_attention_nk),
        attention(ea_ops.reference_with_backward),
        attention(fused_edge_attention_nk_reference), qkv, [cot])
    torch.cuda.synchronize()
    assert fused_edge_attention_nk.backward_launches == before + 1
    assert ok, [r for r in grad_rows if not r["ok"]]
    return torch.autograd.grad(*kept["kernel"])


#: the NK hub graph: receivers with more valid slots than the old kernels'
#: cap of 32 (and one masked slot each, between valid ones)
NK_HUBS = {3: 40, 200: 36}


def _nk_hub_case(cuda_device, batch, head_dim, seed):
    """q, k, v, a cotangent, the slot arrays and the NK layout of a 256-node
    graph (two node blocks) whose hubs give K = 41 slots a receiver; ten
    receivers with no slot, ten whose slots are all masked, node N-1 owning
    9; the others take 1 to 6 slots from random senders. The layout is built
    directly: the layout choice (ops/tiling.build_nk_tiling) would price
    such a skewed graph into the CSR layout."""
    rng = np.random.default_rng(seed)
    n, nb = 256, 128
    degree = rng.integers(1, 7, n)
    degree[list(NO_ROWS)], degree[n - 1] = 0, 9
    for hub, valid in NK_HUBS.items():
        degree[hub] = valid + 1
    k_slots = int(degree.max())
    receivers = np.repeat(np.arange(n), degree)
    senders = rng.integers(0, n, receivers.size)
    rank = np.arange(receivers.size) - np.repeat(np.cumsum(degree) - degree, degree)
    slot = (receivers // nb) * k_slots * nb + rank * nb + receivers % nb
    perm = np.full((n // nb) * k_slots * nb, -1, np.int32)
    perm[slot] = np.arange(receivers.size)
    nk = NKTiling(perm=perm, k_slots=k_slots, node_block=nb, num_nodes=n)
    valid = perm >= 0
    s_slots, r_slots = np.zeros(perm.size, np.int32), np.full(perm.size, n - 1, np.int32)
    s_slots[valid], r_slots[valid] = senders[perm[valid]], receivers[perm[valid]]
    m_slots = valid & ~np.isin(r_slots, list(MASKED_ROWS))
    for hub in NK_HUBS:  # one masked slot between each hub's valid ones
        m_slots[(hub // nb) * k_slots * nb + 5 * nb + hub % nb] = False
    gen = torch.Generator(device=cuda_device).manual_seed(seed)
    qkv = [(0.5 * torch.randn((n, batch, 4, head_dim), generator=gen,
                              device=cuda_device)).to(torch.bfloat16) for _ in range(3)]
    cot = torch.randn((n, batch, 4, head_dim), generator=gen,
                      device=cuda_device).to(torch.bfloat16)

    def dev(a):
        return torch.as_tensor(a, device=cuda_device).contiguous()

    return qkv, cot, (dev(s_slots), dev(r_slots), dev(m_slots)), nk


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim", HEAD_DIMS)
@pytest.mark.parametrize("batch", [1, 17])
def test_nk_attention_kernels_past_32_slots_on_hub_receivers(cuda_device, batch, head_dim):
    """K = 41, past the first kernels' cap: the forward (its chunks and
    online rescale), its statistics and the backward against the plain
    versions; exact zeros where a receiver has no valid slot (dq too), and
    dk = dv = 0 where a node sends on none."""
    qkv, cot, rows, nk = _nk_hub_case(cuda_device, batch, head_dim, seed=60 + batch)
    assert nk.k_slots > 32
    before = fused_edge_attention_nk.launches
    with torch.no_grad():
        out = fused_edge_attention_nk(*qkv, *rows, nk)
        ref = fused_edge_attention_nk_reference(*qkv, *rows, nk)
    torch.cuda.synchronize()
    assert fused_edge_attention_nk.launches == before + 1
    torch.testing.assert_close(out.float(), ref.float(), rtol=0.03, atol=0.02)
    empty = list(NO_ROWS) + list(MASKED_ROWS)
    assert torch.equal(out[empty], torch.zeros_like(out[empty]))
    _check_kept_stats(ea_ops.KERNELS, qkv, rows, nk)
    dq, dk, dv = _check_nk_backward(qkv, rows, nk, cot)
    assert torch.equal(dq[empty], torch.zeros_like(dq[empty]))
    senders, _, mask = rows
    silent = torch.ones(nk.num_nodes, dtype=torch.bool, device=cuda_device)
    silent[senders[mask].long()] = False
    for t in (dk[silent], dv[silent]):
        assert torch.equal(t, torch.zeros_like(t))


@pytest.mark.cuda
def test_nk_attention_kernels_are_bit_identical_across_calls(cuda_device):
    """No atomics: two calls give the same output, statistics and dq, dk,
    dv."""
    qkv, cot, rows, nk = _nk_hub_case(cuda_device, 17, 16, seed=9)
    calls = [ea_ops.KERNELS[0](*qkv, *rows, nk, keep_stats=True) for _ in range(2)]
    (a, (am, ai)), (b, (bm, bi)) = calls
    assert torch.equal(a, b) and torch.equal(am, bm) and torch.equal(ai, bi)
    grads = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_(True) for t in qkv]
        grads.append(torch.autograd.grad(fused_edge_attention_nk(*leaves, *rows, nk), leaves,
                                         cot))
    torch.cuda.synchronize()
    for x, y in zip(*grads):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,use_silu", [(4, False), (33, False), (4, True)])
def test_ffn_kernel_matches_plain_version(cuda_device, batch, use_silu):
    gen = torch.Generator().manual_seed(batch)
    block = GatedMLPBlock(64, 64, 64, use_silu=use_silu)
    norm2 = RMSNorm(64)
    reset_parameters(block, gen)
    with torch.no_grad():
        for norm in (block.norm, norm2):
            norm.scale.copy_(1.0 + 0.2 * torch.randn(64, generator=gen))
    block, norm2 = block.to(cuda_device), norm2.to(cuda_device)
    x = torch.randn((384, batch, 64), generator=gen).to(cuda_device, torch.bfloat16)
    with torch.no_grad():
        before = fused_gated_ffn.launches
        y = fused_gated_ffn(x, block, norm2)
        torch.cuda.synchronize()
        assert fused_gated_ffn.launches == before + 1
        ref = gated_ffn_reference(x, block, norm2)
    torch.testing.assert_close(y.float(), ref.float(), rtol=0.05, atol=0.05)


@pytest.mark.cuda
def test_transformer_forward_goes_through_both_kernels_and_matches_plain_path(cuda_device):
    setup = entry.transformer_setup(cuda_device, nx=20, ny=16, batch=8, mp_steps=3)
    sim, graph = setup.simulator, setup.graph
    plain = copy.deepcopy(sim)
    plain.model.tiling = None
    before = (fused_edge_attention_nk.launches, fused_gated_ffn.launches)
    out = sim.forward(graph, is_training=False)
    torch.cuda.synchronize()
    n_blocks = len(sim.model.processor_list)
    assert (fused_edge_attention_nk.launches, fused_gated_ffn.launches) == (
        before[0] + n_blocks, before[1] + n_blocks)
    ref = plain.forward(graph, is_training=False)
    rows = graph.node_mask
    assert torch.isfinite(out.outputs).all()
    torch.testing.assert_close(out.net_out[rows], ref.net_out[rows], rtol=0.1, atol=0.1)


# ---- the graph transformer's backward kernels and train step ----------------

def _attention_case(cuda_device, batch, seed, head_dim=16, nx=48, ny=40):
    """The slot arrays, NK layout and random q, k, v and cotangent on the
    nx x ny mesh (48x40: the transformer slice's shape)."""
    setup = entry.transformer_setup(cuda_device, nx=nx, ny=ny, batch=batch, mp_steps=1)
    g, nk = setup.graph, setup.tiling
    gen = torch.Generator(device=cuda_device).manual_seed(seed)
    q, k, v, cot = [(s * torch.randn((nk.num_nodes, batch, 4, head_dim), generator=gen,
                                     device=cuda_device)).to(torch.bfloat16)
                    for s in (0.5, 0.5, 0.5, 1.0)]
    return g, nk, (q, k, v), cot


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim", HEAD_DIMS)
@pytest.mark.parametrize("batch", [4, 64])
def test_attention_backward_kernel_matches_plain_backward(cuda_device, batch, head_dim):
    """Bounds and their reasons: graph_physics_tpu_torch/utils/gradcheck.py."""
    g, nk, qkv, cot = _attention_case(cuda_device, batch, seed=batch, head_dim=head_dim)
    mask = g.edge_mask.clone().view(nk.num_groups, nk.k_slots, nk.node_block)
    mask[:, :, :3] = False  # three receivers per node block with no valid slot
    for m in (g.edge_mask, mask.reshape(-1).contiguous()):
        dq, _, _ = _check_nk_backward(qkv, (g.senders, g.receivers, m), nk, cot)
    empty = dq.view(nk.num_groups, nk.node_block, -1)[:, :3]
    assert torch.equal(empty, torch.zeros_like(empty))


@pytest.mark.cuda
@pytest.mark.parametrize("batch,use_silu", [(4, False), (64, False), (4, True)])
def test_ffn_backward_kernel_matches_plain_backward(cuda_device, batch, use_silu):
    """Bounds and their reasons: graph_physics_tpu_torch/utils/gradcheck.py."""
    gen = torch.Generator().manual_seed(batch)
    block = GatedMLPBlock(64, 64, 64, use_silu=use_silu)
    norm2 = RMSNorm(64)
    reset_parameters(block, gen)
    with torch.no_grad():
        for norm in (block.norm, norm2):
            norm.scale.copy_(1.0 + 0.2 * torch.randn(64, generator=gen))
    block, norm2 = block.to(cuda_device), norm2.to(cuda_device)
    x, cot = [torch.randn((1920, batch, 64), generator=gen).to(cuda_device, torch.bfloat16)
              for _ in range(2)]

    def ffn(fn, mlp, norm):
        return lambda xx: (fn(xx, mlp, norm), ffn_ops._params(mlp, norm))

    before = fused_gated_ffn.backward_launches
    names = ["dx", "norm2.scale", "norm.scale", "W1", "b1", "W2", "b2", "W3", "b3"]
    rows, ok, _ = gradcheck.check_backward(
        names, ("dx",), ffn(fused_gated_ffn, block, norm2),
        ffn(ffn_ops.reference_with_backward, block, norm2),
        ffn(gated_ffn_reference, gradcheck.rounded_copy(block), gradcheck.rounded_copy(norm2)),
        [x], [cot])
    torch.cuda.synchronize()
    assert fused_gated_ffn.backward_launches == before + 1
    assert ok, [r for r in rows if not r["ok"]]


def _ffn_case(cuda_device, nodes, batch, use_silu, seed, hidden=64):
    gen = torch.Generator().manual_seed(seed)
    block = GatedMLPBlock(hidden, hidden, hidden, use_silu=use_silu)
    norm2 = RMSNorm(hidden)
    reset_parameters(block, gen)
    with torch.no_grad():
        for norm in (block.norm, norm2):
            norm.scale.copy_(1.0 + 0.2 * torch.randn(hidden, generator=gen))
    block, norm2 = block.to(cuda_device), norm2.to(cuda_device)
    x, cot = [torch.randn((nodes, batch, hidden), generator=gen).to(cuda_device, torch.bfloat16)
              for _ in range(2)]
    return block, norm2, x, cot


@pytest.mark.cuda
@pytest.mark.parametrize("use_silu", [False, True])
def test_ffn_backward_kernel_at_rows_not_a_multiple_of_64(cuda_device, use_silu):
    """1,001 x 3 rows: the last 64-row tile is ragged and masked in the
    kernel. Bounds: utils/gradcheck.py."""
    block, norm2, x, cot = _ffn_case(cuda_device, 1001, 3, use_silu, seed=5)
    assert x.shape[0] * x.shape[1] % 64 != 0

    def ffn(fn, mlp, norm):
        return lambda xx: (fn(xx, mlp, norm), ffn_ops._params(mlp, norm))

    before = fused_gated_ffn.backward_launches
    names = ["dx", "norm2.scale", "norm.scale", "W1", "b1", "W2", "b2", "W3", "b3"]
    rows, ok, _ = gradcheck.check_backward(
        names, ("dx",), ffn(fused_gated_ffn, block, norm2),
        ffn(ffn_ops.reference_with_backward, block, norm2),
        ffn(gated_ffn_reference, gradcheck.rounded_copy(block), gradcheck.rounded_copy(norm2)),
        [x], [cot])
    torch.cuda.synchronize()
    assert fused_gated_ffn.backward_launches == before + 1
    assert ok, [r for r in rows if not r["ok"]]


@pytest.mark.cuda
def test_ffn_backward_kernel_is_bit_identical_across_calls(cuda_device):
    """Block partial sums added in block order, no atomics: dx and every
    gradient come out the same, bit for bit."""
    block, norm2, x, cot = _ffn_case(cuda_device, 1920, 8, False, seed=6)
    params = ffn_ops._params(block, norm2)
    outs = []
    for _ in range(2):
        xl = x.clone().requires_grad_(True)
        outs.append(torch.autograd.grad(fused_gated_ffn(xl, block, norm2), [xl, *params], cot))
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("use_silu", [False, True])
def test_ffn_kernel_at_a_ragged_last_tile(cuda_device, use_silu):
    """1,001 x 3 rows: the last 128-row tile is ragged; its missing rows are
    zero-filled in the kernel and never stored."""
    block, norm2, x, _ = _ffn_case(cuda_device, 1001, 3, use_silu, seed=8)
    assert x.shape[0] * x.shape[1] % 128 != 0
    with torch.no_grad():
        before = fused_gated_ffn.launches
        y = fused_gated_ffn(x, block, norm2)
        torch.cuda.synchronize()
        assert fused_gated_ffn.launches == before + 1
        ref = gated_ffn_reference(x, block, norm2)
    torch.testing.assert_close(y.float(), ref.float(), rtol=0.05, atol=0.05)


@pytest.mark.cuda
def test_ffn_kernel_is_bit_identical_across_calls(cuda_device):
    """Each output's fp32 sums in one fixed order: the same bits on two calls."""
    block, norm2, x, _ = _ffn_case(cuda_device, 1921, 8, False, seed=9)
    with torch.no_grad():
        ys = [fused_gated_ffn(x, block, norm2) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(ys[0], ys[1])


FFN_GRAD_NAMES = ["dx", "norm2.scale", "norm.scale", "W1", "b1", "W2", "b2", "W3", "b3"]


#: the hidden-128 kernels' row counts as [nodes, batch]: 1, 63, 64 and 65
#: rows (one or two of the backward's 64-row tiles, fewer tiles than its
#: clusters and than the forward's blocks), 1,001 x 3 (ragged, more tiles
#: than clusters) and 1,920 x 8
FFN128_SHAPES = [(1, 1), (63, 1), (32, 2), (13, 5), (1001, 3), (1920, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("nodes,batch", FFN128_SHAPES)
@pytest.mark.parametrize("use_silu", [False, True])
def test_ffn128_kernel_matches_plain_version(cuda_device, nodes, batch, use_silu):
    """The hidden-128 forward (panels' width, weights streamed in slices of
    64 middle columns, 128-row tiles on two warpgroups) at every row count
    of FFN128_SHAPES. Bound: rtol = atol = 0.05."""
    block, norm2, x, _ = _ffn_case(cuda_device, nodes, batch, use_silu, seed=20, hidden=128)
    with torch.no_grad():
        before = fused_gated_ffn.launches
        y = fused_gated_ffn(x, block, norm2)
        torch.cuda.synchronize()
        assert fused_gated_ffn.launches == before + 1
        ref = gated_ffn_reference(x, block, norm2)
    torch.testing.assert_close(y.float(), ref.float(), rtol=0.05, atol=0.05)


@pytest.mark.cuda
@pytest.mark.parametrize("nodes,batch", FFN128_SHAPES)
@pytest.mark.parametrize("use_silu", [False, True])
def test_ffn128_backward_kernel_matches_plain_backward(cuda_device, nodes, batch, use_silu):
    """The hidden-128 backward (clusters of six blocks over 64-row tiles,
    their partials added in order) against the plain backward, both
    against fp32 autograd, at every row count of FFN128_SHAPES. Bounds:
    utils/gradcheck.py."""
    block, norm2, x, cot = _ffn_case(cuda_device, nodes, batch, use_silu, seed=21, hidden=128)

    def ffn(fn, mlp, norm):
        return lambda xx: (fn(xx, mlp, norm), ffn_ops._params(mlp, norm))

    before = fused_gated_ffn.backward_launches
    rows, ok, _ = gradcheck.check_backward(
        FFN_GRAD_NAMES, ("dx",), ffn(fused_gated_ffn, block, norm2),
        ffn(ffn_ops.reference_with_backward, block, norm2),
        ffn(gated_ffn_reference, gradcheck.rounded_copy(block), gradcheck.rounded_copy(norm2)),
        [x], [cot])
    torch.cuda.synchronize()
    assert fused_gated_ffn.backward_launches == before + 1
    assert ok, [r for r in rows if not r["ok"]]


@pytest.mark.cuda
@pytest.mark.parametrize("nodes,batch", [(1001, 3), (65, 1), (1920, 8)])
def test_ffn128_kernels_are_bit_identical_across_calls(cuda_device, nodes, batch):
    """Fixed sum orders in both hidden-128 kernels, the backward's partials
    added in a fixed order: y, dx and every gradient the same on two calls."""
    block, norm2, x, cot = _ffn_case(cuda_device, nodes, batch, False, seed=22, hidden=128)
    params = ffn_ops._params(block, norm2)
    outs = []
    for _ in range(2):
        xl = x.clone().requires_grad_(True)
        y = fused_gated_ffn(xl, block, norm2)
        outs.append((y.detach(), *torch.autograd.grad(y, [xl, *params], cot)))
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_ffn128_backward_keeps_the_middle_out_of_device_memory(cuda_device):
    """At panels' shape (1,920 x 64 rows) a backward call allocates, beyond
    what it is given, less than one bf16 [rows, 3H] array: dx, the
    clusters' partials, the packed weights and the gradients, and no
    scratch of ga1, ga2 or the gated middle."""
    block, norm2, x, cot = _ffn_case(cuda_device, 1920, 64, False, seed=23, hidden=128)
    rows = x.shape[0] * x.shape[1]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    before = fused_gated_ffn.backward_launches
    dx, grads = ffn_ops.KERNELS[1](x, block, norm2, cot)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    assert fused_gated_ffn.backward_launches == before + 1
    assert dx.shape == x.shape and torch.isfinite(dx.float()).all()
    assert dx.numel() * 2 <= peak < rows * 3 * 128 * 2, peak


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", ffn_ops.SMALL_HIDDENS)
@pytest.mark.parametrize("nodes,batch,use_silu", [(1920, 8, False), (1001, 3, True)])
def test_small_ffn_kernel_matches_plain_version(cuda_device, hidden, nodes, batch, use_silu):
    """Hidden 32 and below (csrc/fused_ffn_small.cu, products on tiles
    zero-padded to 16): 1,920 x 8 rows and a ragged 1,001 x 3. Bound: rtol
    = atol = 0.05."""
    block, norm2, x, _ = _ffn_case(cuda_device, nodes, batch, use_silu, seed=30 + hidden,
                                   hidden=hidden)
    with torch.no_grad():
        before = fused_gated_ffn.launches
        y = fused_gated_ffn(x, block, norm2)
        torch.cuda.synchronize()
        assert fused_gated_ffn.launches == before + 1
        ref = gated_ffn_reference(x, block, norm2)
    torch.testing.assert_close(y.float(), ref.float(), rtol=0.05, atol=0.05)


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", ffn_ops.SMALL_HIDDENS)
@pytest.mark.parametrize("nodes,batch,use_silu", [(1920, 8, False), (1001, 3, True)])
def test_small_ffn_backward_kernel_matches_plain_backward(cuda_device, hidden, nodes, batch,
                                                          use_silu):
    """The backward at hidden 32 and below against the plain backward, both
    against fp32 autograd. Bounds: utils/gradcheck.py."""
    block, norm2, x, cot = _ffn_case(cuda_device, nodes, batch, use_silu, seed=40 + hidden,
                                     hidden=hidden)

    def ffn(fn, mlp, norm):
        return lambda xx: (fn(xx, mlp, norm), ffn_ops._params(mlp, norm))

    before = fused_gated_ffn.backward_launches
    rows, ok, _ = gradcheck.check_backward(
        FFN_GRAD_NAMES, ("dx",), ffn(fused_gated_ffn, block, norm2),
        ffn(ffn_ops.reference_with_backward, block, norm2),
        ffn(gated_ffn_reference, gradcheck.rounded_copy(block), gradcheck.rounded_copy(norm2)),
        [x], [cot])
    torch.cuda.synchronize()
    assert fused_gated_ffn.backward_launches == before + 1
    assert ok, [r for r in rows if not r["ok"]]


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", ffn_ops.SMALL_HIDDENS)
def test_small_ffn_kernels_are_bit_identical_across_calls(cuda_device, hidden):
    """Fixed sum orders, the backward's block partials added in block
    order: y, dx and every gradient the same on two calls."""
    block, norm2, x, cot = _ffn_case(cuda_device, 1001, 3, False, seed=50 + hidden,
                                     hidden=hidden)
    params = ffn_ops._params(block, norm2)
    outs = []
    for _ in range(2):
        xl = x.clone().requires_grad_(True)
        y = fused_gated_ffn(xl, block, norm2)
        outs.append((y.detach(), *torch.autograd.grad(y, [xl, *params], cot)))
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def _kernel_digests():
    """scripts/kernel_digests.py, loaded by its path (the card's machine has
    a site-packages module named ``scripts``)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "scripts" / "kernel_digests.py"
    spec = importlib.util.spec_from_file_location("kernel_digests", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.cuda
def test_earlier_widths_keep_the_parent_trees_bits(cuda_device):
    """The attention kernels at head widths 16 and 32 (both layouts, NK with
    world pieces too) and the gated FFN at hidden 64 and 128, forward and
    backward, give the bits of the tree before every width dividing 128
    had an instance; the FFN (GELU) at hidden 1 to 32 and rows 1-4 (relu)
    at hidden 32, 64 and 128 in both layouts those of the tree before rows
    1-4 took every width and activation; on the inputs
    scripts/kernel_digests.py draws."""
    kd = _kernel_digests()
    kd.check(kd.digests(), kd.card_key())


@pytest.mark.cuda
def test_ffn_kernel_refuses_other_hidden_widths(cuda_device):
    """A hidden width without a kernel instance (96: JAX's gate does not
    fuse it either) raises, saying so."""
    block, norm2, x, _ = _ffn_case(cuda_device, 128, 4, False, seed=23, hidden=96)
    with pytest.raises(NotImplementedError, match="does not fuse"):
        fused_gated_ffn(x, block, norm2)


@pytest.mark.cuda
def test_transformer_kernels_refuse_what_they_lack_under_autograd(cuda_device):
    setup = entry.transformer_setup(cuda_device, nx=20, ny=16, batch=2, mp_steps=1)
    g, nk = setup.graph, setup.tiling
    q = torch.zeros((nk.num_nodes, 2, 4, 24), dtype=torch.bfloat16, device=cuda_device,
                    requires_grad=True)  # head width 24: no kernel instance
    with pytest.raises(NotImplementedError, match="does not fuse"):
        fused_edge_attention_nk(q, q, q, g.senders, g.receivers, g.edge_mask, nk)
    block, norm2 = GatedMLPBlock(96, 96, 96).to(cuda_device), RMSNorm(96).to(cuda_device)
    x = torch.zeros((64, 2, 96), dtype=torch.bfloat16, device=cuda_device, requires_grad=True)
    with pytest.raises(NotImplementedError, match="does not fuse"):  # hidden 96: no kernel
        fused_gated_ffn(x, block, norm2)


@pytest.mark.cuda
def test_transformer_train_step_goes_through_both_kernels_and_matches_plain_path(cuda_device):
    train = entry.transformer_train_setup(cuda_device, nx=20, ny=16, batch=8)
    plain_sim = copy.deepcopy(train.simulator)
    plain_sim.model.tiling = None
    plain_state, plain_step = entry.make_trainer(plain_sim)
    n_blocks = len(train.simulator.model.processor_list)
    kernels = (fused_edge_attention_nk, fused_gated_ffn)
    before = [(k.launches, k.backward_launches) for k in kernels]
    m = train.train_step(train.state, train.graph, torch.Generator(cuda_device).manual_seed(3))
    torch.cuda.synchronize()
    assert [(k.launches, k.backward_launches) for k in kernels] == [
        (f + n_blocks, b + n_blocks) for f, b in before]
    mp = plain_step(plain_state, train.graph, torch.Generator(cuda_device).manual_seed(3))
    assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])
    # the JAX suite's value bound (tests/test_fused_gnblock_nk.py:150)
    torch.testing.assert_close(m["loss"], mp["loss"], rtol=0.02, atol=0)

    def unclipped(sim, state, norm):  # undo the clip: g · min(1, clip / norm)
        undo = max(norm.item() / state.optimizer.grad_clip, 1.0)
        return torch.cat([p.grad.float().flatten() * undo for p in sim.parameters()])

    gk = unclipped(train.simulator, train.state, m["grad_norm"])
    gp = unclipped(plain_sim, plain_state, mp["grad_norm"])
    assert ((gk - gp).abs().max() / gp.abs().max()).item() <= gradcheck.WEIGHT_REL


# ---- the graded mesh's CSR kernels ------------------------------------------

def _graded_block_args(setup, variant, seed):
    model, graph, csr = setup.simulator.model, setup.graph, setup.tiling
    n, b = graph.x.shape[:2]
    gen = torch.Generator(device=graph.x.device).manual_seed(seed)
    width = entry.EDGE_INPUT if variant == "folded" else model.hidden_size

    def randn(*shape):
        return (0.5 * torch.randn(shape, generator=gen, device=graph.x.device)).to(torch.bfloat16)

    blk = model.processor_list[BLOCK_OF[variant]]
    args = (randn(n, b, model.hidden_size), randn(csr.total_rows, b, width), graph.senders,
            graph.receivers, graph.edge_mask, blk.edge_block, blk.node_block, csr)
    kw = dict(encoder_params=model.edges_encoder if variant == "folded" else None,
              last_block=variant == "last")
    return args, kw


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [4, 33])
@pytest.mark.parametrize("variant", ["folded", "middle", "last"])
def test_csr_gn_kernel_matches_plain_version(cuda_device, variant, batch):
    """1,536 nodes: node N-1 is real, with in-edges; the padding rows point at it."""
    setup = entry.graded_setup(cuda_device, num_nodes=1536, batch=batch, mp_steps=3)
    args, kw = _graded_block_args(setup, variant, seed=batch)
    with torch.no_grad():
        before = fused_gn_block_csr.launches
        kx, ke = fused_gn_block_csr(*args, **kw)
        torch.cuda.synchronize()
        assert fused_gn_block_csr.launches == before + 1
        px, pe = fused_gn_block_csr_reference(*args, **kw, compute_dtype=torch.bfloat16)
    torch.testing.assert_close(kx.float(), px.float(), rtol=0.05, atol=0.05)
    if variant == "last":
        assert ke is args[1]
    else:  # padding rows too: they keep e_in (the encoded raw features when folded)
        torch.testing.assert_close(ke.float(), pe.float(), rtol=0.05, atol=0.05)


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim", HEAD_DIMS)
@pytest.mark.parametrize("batch", [2, 33])
def test_csr_attention_kernel_matches_plain_version(cuda_device, batch, head_dim):
    setup = entry.graded_transformer_setup(cuda_device, num_nodes=1500, batch=batch,
                                           mp_steps=2)
    g, csr = setup.graph, setup.tiling
    gen = torch.Generator(device=cuda_device).manual_seed(batch)
    q, k, v = [(0.5 * torch.randn((csr.num_nodes, batch, 4, head_dim), generator=gen,
                                  device=cuda_device)).to(torch.bfloat16) for _ in range(3)]
    gone = torch.tensor([0, 7, csr.num_nodes // 2], device=cuda_device)
    mask = g.edge_mask & ~torch.isin(g.receivers, gone)  # three receivers with no valid row
    for m in (g.edge_mask, mask):
        before = fused_edge_attention_csr.launches
        with torch.no_grad():
            out = fused_edge_attention_csr(q, k, v, g.senders, g.receivers, m, csr)
        torch.cuda.synchronize()
        assert fused_edge_attention_csr.launches == before + 1
        ref = edge_attention(q, k, v, g.senders, g.receivers, m)
        torch.testing.assert_close(out.float(), ref.float(), rtol=0.03, atol=0.02)
    empty = torch.cat([out[gone], out[1500:]])  # and the padding nodes
    assert torch.equal(empty, torch.zeros_like(empty))


#: the attention hub mesh's receivers: two hubs (more than one chunk of
#: rows, so the forward's online rescale runs), receivers with no row,
#: receivers whose rows are all masked
ATTN_HUBS = {3: 40, 9: 300}


def _attention_hub_case(cuda_device, batch, head_dim, seed):
    """q, k, v, the row arrays and the CSR layout of a 384-node graph with
    receivers of 40 and 300 valid rows (and one masked row each, between
    valid ones), ten receivers with no row, ten whose rows are all masked
    and node N-1 owning 9 rows; the others take 1 to 6 rows from random
    senders."""
    rng = np.random.default_rng(seed)
    n = 384
    degree = rng.integers(1, 7, n)
    degree[list(NO_ROWS)], degree[n - 1] = 0, 9
    for hub, valid in ATTN_HUBS.items():
        degree[hub] = valid + 1
    receivers = np.repeat(np.arange(n), degree)
    rng.shuffle(receivers)
    senders = rng.integers(0, n, receivers.size)
    layout = build_csr_layout(senders, receivers, n)
    valid = layout.perm >= 0
    ids = layout.perm[valid]
    rows = layout.total_rows
    s_rows, r_rows = np.zeros(rows, np.int32), np.full(rows, n - 1, np.int32)
    s_rows[valid], r_rows[valid] = senders[ids], receivers[ids]
    m_rows = valid & ~np.isin(r_rows, list(MASKED_ROWS))
    for hub in ATTN_HUBS:  # one masked row inside each hub's range
        m_rows[layout.row_ptr[hub] + 5] = False
    gen = torch.Generator(device=cuda_device).manual_seed(seed)
    q, k, v = [(0.5 * torch.randn((n, batch, 4, head_dim), generator=gen,
                                  device=cuda_device)).to(torch.bfloat16) for _ in range(3)]

    def dev(a):
        return torch.as_tensor(a, device=cuda_device).contiguous()

    return (q, k, v), (dev(s_rows), dev(r_rows), dev(m_rows)), layout


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim", HEAD_DIMS)
@pytest.mark.parametrize("batch", [1, 17])
def test_csr_attention_kernel_on_hub_receivers_and_empty_receivers(cuda_device, batch,
                                                                   head_dim):
    """The forward's chunks and online rescale on receivers of 40 and 300
    valid rows, with exact zeros where a receiver has no valid row; the
    statistics it keeps against their plain version (the max to fp32
    rounding of the logits' sum order, 1/denominator to 5e-3: a logit an
    ulp apart can round its bf16 weight the other way, and across chunks
    the weights round against the running max)."""
    qkv, rows, csr = _attention_hub_case(cuda_device, batch, head_dim, seed=batch + head_dim)
    mask = rows[2].cpu().numpy()
    for hub, valid in ATTN_HUBS.items():
        assert mask[csr.row_ptr[hub]:csr.row_ptr[hub + 1]].sum() == valid
    before = fused_edge_attention_csr.launches
    with torch.no_grad():
        out = fused_edge_attention_csr(*qkv, *rows, csr)
        torch.cuda.synchronize()
        assert fused_edge_attention_csr.launches == before + 1
        ref = edge_attention(*qkv, *rows)
        torch.testing.assert_close(out.float(), ref.float(), rtol=0.03, atol=0.02)
        empty = out[list(NO_ROWS) + list(MASKED_ROWS)]
        assert torch.equal(empty, torch.zeros_like(empty))
    _check_kept_stats(ea_csr_ops.KERNELS, qkv, rows, csr)


@pytest.mark.cuda
def test_csr_attention_kernel_is_bit_identical_across_calls(cuda_device):
    """No atomics: two calls give the same output and statistics."""
    qkv, rows, csr = _attention_hub_case(cuda_device, 17, 16, seed=7)
    calls = [ea_csr_ops.KERNELS[0](*qkv, *rows, csr, keep_stats=True) for _ in range(2)]
    torch.cuda.synchronize()
    (a, (am, ai)), (b, (bm, bi)) = calls
    assert torch.equal(a, b) and torch.equal(am, bm) and torch.equal(ai, bi)


@pytest.mark.cuda
def test_csr_kernels_raise_under_autograd(cuda_device):
    """Under autograd the CSR kernels raise outside their backward's scope
    (MLPs of more than 8 Dense layers, head widths without an instance),
    and never take the plain version."""
    setup = entry.graded_setup(cuda_device, num_nodes=1536, batch=2, mp_steps=2)
    args, kw = _graded_block_args(setup, "middle", seed=0)
    deep = MLP(3 * 32, 32, 32, 9).to(cuda_device)  # 9 Dense layers: no kernel takes them
    before = fused_gn_block_csr.launches
    with pytest.raises(NotImplementedError, match="Dense layers"):
        fused_gn_block_csr(*args[:5], deep, *args[6:], **kw)
    assert fused_gn_block_csr.launches == before
    g, csr = setup.graph, setup.tiling
    q = torch.zeros((csr.num_nodes, 2, 4, 24), dtype=torch.bfloat16, device=cuda_device,
                    requires_grad=True)  # head width 24: no kernel instance
    with pytest.raises(NotImplementedError, match="head widths"):
        fused_edge_attention_csr(q, q, q, g.senders, g.receivers, g.edge_mask, csr)


def _csr_cotangents(x, rows, seed):
    gen = torch.Generator(device=x.device).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=x.device).to(torch.bfloat16)
            for shape in (x.shape, (rows,) + x.shape[1:])]


@pytest.mark.cuda
@pytest.mark.parametrize("num_nodes,batch", [(1536, 4), (1536, 33), (27_000, 16)])
@pytest.mark.parametrize("variant", ["folded", "middle", "last"])
def test_csr_gn_backward_kernel_matches_plain_version(cuda_device, variant, num_nodes, batch):
    """1,536 nodes (node N-1 real, with rows; the padding rows point at it)
    and the graded slice's 27,000 x 16. Bounds: utils/gradcheck.py."""
    setup = entry.graded_setup(cuda_device, num_nodes=num_nodes, batch=batch, mp_steps=3)
    args, kw = _graded_block_args(setup, variant, seed=batch)
    x, e, senders, receivers, mask, edge, node, csr = args
    cot_x, cot_e = _csr_cotangents(x, csr.total_rows, 200 + batch)
    before = fused_gn_block_csr.backward_launches
    rows, ok, _ = gradcheck.check_block_backward(
        x, e, (senders, receivers, mask), (kw["encoder_params"], edge, node), csr,
        kw["last_block"], cot_x, cot_e)
    torch.cuda.synchronize()
    assert fused_gn_block_csr.backward_launches == before + 1
    assert ok, [r for r in rows if not r["ok"]]


#: the hub mesh's receivers: a hub, receivers with no row, receivers whose
#: rows are all masked
HUB, HUB_DEGREE, NO_ROWS, MASKED_ROWS = 5, 150, range(10, 20), range(20, 30)


def _hub_case(cuda_device, variant, batch, seed):
    """A block's inputs on a 384-node CSR graph with a hub receiver of
    in-degree 150, ten receivers with no row, ten whose rows are all masked
    and node N-1 owning 9 rows; the other receivers take 1 to 6 rows from
    random senders. The MLPs are a cylinder ``epd`` block's (and its edge
    encoder when folded). Returns the fused_gn_block_csr arguments and
    keywords."""
    rng = np.random.default_rng(seed)
    n = 384
    degree = rng.integers(1, 7, n)
    degree[HUB], degree[list(NO_ROWS)], degree[n - 1] = HUB_DEGREE, 0, 9
    receivers = np.repeat(np.arange(n), degree)
    rng.shuffle(receivers)
    senders = rng.integers(0, n, receivers.size)
    layout = build_csr_layout(senders, receivers, n)
    valid = layout.perm >= 0
    ids = layout.perm[valid]
    rows = layout.total_rows
    s_rows, r_rows = np.zeros(rows, np.int32), np.full(rows, n - 1, np.int32)
    s_rows[valid], r_rows[valid] = senders[ids], receivers[ids]
    m_rows = valid & ~np.isin(r_rows, list(MASKED_ROWS))
    model = entry.cylinder_setup(cuda_device, nx=16, ny=16, batch=1).simulator.model
    blk = model.processor_list[BLOCK_OF[variant]]
    gen = torch.Generator(device=cuda_device).manual_seed(seed)
    width = entry.EDGE_INPUT if variant == "folded" else model.hidden_size

    def randn(*shape):
        return (0.5 * torch.randn(shape, generator=gen, device=cuda_device)).to(torch.bfloat16)

    def dev(a):
        return torch.as_tensor(a, device=cuda_device).contiguous()

    args = (randn(n, batch, model.hidden_size), randn(rows, batch, width), dev(s_rows),
            dev(r_rows), dev(m_rows), blk.edge_block, blk.node_block, layout)
    kw = dict(encoder_params=model.edges_encoder if variant == "folded" else None,
              last_block=variant == "last")
    return args, kw


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 17])
@pytest.mark.parametrize("variant", ["folded", "middle", "last"])
def test_csr_gn_kernel_on_a_hub_receiver_and_empty_receivers(cuda_device, variant, batch):
    """The forward's warp per (receiver, 16 samples) against the plain
    version: a receiver of in-degree 150, receivers with no row or only
    masked rows (their aggregate is 0), node N-1 owning rows, and chunks
    of 1 and 17 samples (a partial 16-sample tile)."""
    args, kw = _hub_case(cuda_device, variant, batch, seed=batch)
    row_ptr, mask = args[7].row_ptr, args[4].cpu().numpy()
    assert row_ptr[HUB + 1] - row_ptr[HUB] == HUB_DEGREE
    assert row_ptr[NO_ROWS.stop] == row_ptr[NO_ROWS.start]
    assert not mask[row_ptr[MASKED_ROWS.start]:row_ptr[MASKED_ROWS.stop]].any()
    assert mask[row_ptr[-2]:row_ptr[-1]].any()  # node N-1's rows
    with torch.no_grad():
        before = fused_gn_block_csr.launches
        kx, ke = fused_gn_block_csr(*args, **kw)
        torch.cuda.synchronize()
        assert fused_gn_block_csr.launches == before + 1
        px, pe = fused_gn_block_csr_reference(*args, **kw, compute_dtype=torch.bfloat16)
    torch.testing.assert_close(kx.float(), px.float(), rtol=0.05, atol=0.05)
    if variant == "last":
        assert ke is args[1]
    else:  # padding and masked rows too: they keep e_in
        torch.testing.assert_close(ke.float(), pe.float(), rtol=0.05, atol=0.05)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["folded", "middle"])
def test_csr_gn_kernel_outputs_are_bit_identical_across_calls(cuda_device, variant):
    """No atomics in the forward: two calls give the same bits, the kept
    aggregate too."""
    args, kw = _hub_case(cuda_device, variant, 17, seed=4)
    outs = []
    for _ in range(2):
        outs.append(fused_gn_block_csr_ops.KERNELS[0](
            *args[:5], args[7], (kw["encoder_params"], args[5], args[6]), kw["last_block"]))
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["folded", "middle", "last"])
def test_csr_gn_backward_kernel_on_a_hub_receiver_and_empty_receivers(cuda_device, variant):
    """The backward's tiles on the hub mesh at B=17, against plain autograd
    of the plain version (utils/gradcheck.py). With the folded encoder the
    hub's dx values are held against the fp32 gradient (``fp32_judged``):
    there the plain bf16 backward and the kernel each leave the bound on a
    quarter of the hub's values, and the kernel may leave it on no more of
    them than the plain backward does; every other value keeps the bound
    against the plain backward."""
    args, kw = _hub_case(cuda_device, variant, 17, seed=5)
    x, e, senders, receivers, mask, edge, node, csr = args
    cot_x, cot_e = _csr_cotangents(x, csr.total_rows, 205)
    judged = None
    if variant == "folded":
        hub = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
        hub[HUB] = True
        judged = {"dx": hub}
    before = fused_gn_block_csr.backward_launches
    rows, ok, _ = gradcheck.check_block_backward(
        x, e, (senders, receivers, mask), (kw["encoder_params"], edge, node), csr,
        kw["last_block"], cot_x, cot_e, fp32_judged=judged)
    print(f"[{variant}] dx:", [r for r in rows if r["name"] == "dx"])  # pytest -s shows it
    torch.cuda.synchronize()
    assert fused_gn_block_csr.backward_launches == before + 1
    assert ok, [r for r in rows if not r["ok"]]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["middle", "last"])
def test_csr_gn_backward_kernel_dx_de_are_bit_identical_across_calls(cuda_device, variant):
    """No atomics are left on dx or de: two calls give the same bits."""
    args, kw = _hub_case(cuda_device, variant, 17, seed=6)
    x, e, senders, receivers, mask, edge, node, csr = args
    last = kw["last_block"]
    cot_x, cot_e = _csr_cotangents(x, csr.total_rows, 206)
    outs = []
    for _ in range(2):
        xl, el = x.clone().requires_grad_(True), e.clone().requires_grad_(True)
        xo, eo = fused_gn_block_csr(xl, el, senders, receivers, mask, edge, node, csr,
                                    last_block=last)
        if last:
            outs.append(torch.autograd.grad(xo, [xl], cot_x))
        else:
            outs.append(torch.autograd.grad([xo, eo], [xl, el], [cot_x, cot_e]))
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("num_nodes,batch,head_dim", [
    *[(n, b, dh) for dh in (16, 32) for n, b in ((1500, 2), (1500, 33), (27_000, 16))],
    *[(1500, b, dh) for dh in HEAD_DIMS if dh not in (16, 32) for b in (2, 33)]])
def test_csr_attention_backward_kernel_matches_plain_backward(cuda_device, num_nodes, batch,
                                                              head_dim):
    """Against autograd of edge_attention and fp32 autograd (bounds:
    utils/gradcheck.py); dq exactly 0 where a receiver has no valid row,
    and dk, dv exactly 0 on nodes that send on none (the padding nodes)."""
    setup = entry.graded_transformer_setup(cuda_device, num_nodes=num_nodes, batch=batch,
                                           mp_steps=1)
    g, csr = setup.graph, setup.tiling
    gen = torch.Generator(device=cuda_device).manual_seed(batch)
    *qkv, cot = [(s * torch.randn((csr.num_nodes, batch, 4, head_dim), generator=gen,
                                  device=cuda_device)).to(torch.bfloat16)
                 for s in (0.5, 0.5, 0.5, 1.0)]
    gone = torch.tensor([0, 7, csr.num_nodes // 2], device=cuda_device)
    masked = g.edge_mask & ~torch.isin(g.receivers, gone)  # three receivers with no valid row
    names = ("dq", "dk", "dv")
    for m in (g.edge_mask, masked):
        def attention(fn):
            return lambda *t: (fn(*t, g.senders, g.receivers, m, csr), [])

        before = fused_edge_attention_csr.backward_launches
        rows, ok, _ = gradcheck.check_backward(
            names, names, attention(fused_edge_attention_csr),
            attention(ea_csr_ops.reference_with_backward),
            lambda *t: (edge_attention(*t, g.senders, g.receivers, m), []), qkv, [cot])
        torch.cuda.synchronize()
        assert fused_edge_attention_csr.backward_launches == before + 1
        assert ok, [r for r in rows if not r["ok"]]
    leaves = [t.clone().requires_grad_(True) for t in qkv]
    dq, dk, dv = torch.autograd.grad(
        fused_edge_attention_csr(*leaves, g.senders, g.receivers, masked, csr), leaves, cot)
    pad = ~g.node_mask
    for t in (dq[gone], dq[pad], dk[pad], dv[pad]):
        assert torch.equal(t, torch.zeros_like(t))


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim", HEAD_DIMS)
@pytest.mark.parametrize("batch", [1, 17])
def test_csr_attention_backward_kernel_on_hub_receivers_and_empty_receivers(
        cuda_device, batch, head_dim):
    """The backward on receivers of 40 and 300 valid rows (the forward's
    statistics kept across chunks), against autograd of edge_attention and
    fp32 autograd (utils/gradcheck.py); dq exactly 0 where a receiver has
    no valid row, dk and dv where a node sends on none."""
    qkv, rows, csr = _attention_hub_case(cuda_device, batch, head_dim, seed=50 + batch)
    gen = torch.Generator(device=cuda_device).manual_seed(batch)
    cot = torch.randn(qkv[0].shape, generator=gen, device=cuda_device).to(torch.bfloat16)
    names = ("dq", "dk", "dv")

    def attention(fn):
        return lambda *t: (fn(*t, *rows, csr), [])

    before = fused_edge_attention_csr.backward_launches
    grad_rows, ok, kept = gradcheck.check_backward(
        names, names, attention(fused_edge_attention_csr),
        attention(ea_csr_ops.reference_with_backward),
        lambda *t: (edge_attention(*t, *rows), []), qkv, [cot])
    torch.cuda.synchronize()
    assert fused_edge_attention_csr.backward_launches == before + 1
    assert ok, [r for r in grad_rows if not r["ok"]]
    dq, dk, dv = torch.autograd.grad(*kept["kernel"])
    empty = dq[list(NO_ROWS) + list(MASKED_ROWS)]
    assert torch.equal(empty, torch.zeros_like(empty))
    senders, _, mask = rows
    silent = torch.ones(csr.num_nodes, dtype=torch.bool, device=cuda_device)
    silent[senders[mask].long()] = False
    for t in (dk[silent], dv[silent]):
        assert torch.equal(t, torch.zeros_like(t))


@pytest.mark.cuda
def test_csr_attention_backward_kernel_is_bit_identical_across_calls(cuda_device):
    """No atomics: two backward calls give the same dq, dk and dv."""
    qkv, rows, csr = _attention_hub_case(cuda_device, 17, 16, seed=8)
    cot = torch.randn(qkv[0].shape, device=cuda_device).to(torch.bfloat16)
    grads = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_(True) for t in qkv]
        grads.append(torch.autograd.grad(fused_edge_attention_csr(*leaves, *rows, csr), leaves,
                                         cot))
    torch.cuda.synchronize()
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_csr_attention_kernels_index_past_2_31_values(cuda_device):
    """Tensors of 2^31 values and more (~45 GB of the card): a 128-node
    graph placed after 32,768 filler nodes, at B=1024 and 4 heads of 16,
    so its q, k, v rows lie past value 2^31 and its rows' places in the
    backward's [rows, B, H] scratch past 2^31 as well (the filler's 557,056
    rows send from lower nodes). Its output, statistics and gradients are
    the same bits as the same kernels give on the small graph alone."""
    torch.cuda.empty_cache()
    rng = np.random.default_rng(11)
    n0, n_small, batch, heads, dh = 32_768, 128, 1024, 4, 16
    n = n0 + n_small
    fill_recv = np.repeat(np.arange(n0), 17)
    fill_send = rng.integers(0, n0, fill_recv.size)
    small_recv = rng.integers(0, n_small - 8, 600)  # the last 8 nodes receive nothing
    small_send = rng.integers(0, n_small, small_recv.size)

    def case(senders, receivers, nodes):
        layout = build_csr_layout(senders, receivers, nodes)
        valid = layout.perm >= 0
        ids = layout.perm[valid]
        s_rows = np.zeros(layout.total_rows, np.int32)
        r_rows = np.full(layout.total_rows, nodes - 1, np.int32)
        s_rows[valid], r_rows[valid] = senders[ids], receivers[ids]
        rows = [torch.as_tensor(a, device=cuda_device).contiguous()
                for a in (s_rows, r_rows, valid)]
        return rows, layout

    big_rows, big = case(np.concatenate([fill_send, small_send + n0]),
                         np.concatenate([fill_recv, small_recv + n0]), n)
    small_rows, small = case(small_send, small_recv, n_small)
    assert big.num_nodes == n and (n0 * batch * heads * dh) >= 2**31
    assert fill_recv.size * batch * heads >= 2**31
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    q, k, v, cot = [torch.randn((n, batch, heads, dh), generator=gen, device=cuda_device,
                                dtype=torch.bfloat16).mul_(0.5) for _ in range(4)]
    fwd, bwd = ea_csr_ops.KERNELS
    out, (m, inv) = fwd(q, k, v, *big_rows, big, keep_stats=True)
    grads = bwd(q, k, v, *big_rows, big, cot, (out, m, inv))
    tail = [t[n0:].clone() for t in (out, m, inv, *grads)]
    del out, m, inv, grads
    part = [t[n0:] for t in (q, k, v)]
    s_out, (s_m, s_inv) = fwd(*part, *small_rows, small, keep_stats=True)
    s_grads = bwd(*part, *small_rows, small, cot[n0:], (s_out, s_m, s_inv))
    torch.cuda.synchronize()
    for a, b in zip(tail, (s_out, s_m, s_inv, *s_grads)):
        assert torch.equal(a, b)
    ref = edge_attention(*part, *small_rows)
    torch.testing.assert_close(s_out.float(), ref.float(), rtol=0.03, atol=0.02)
    del q, k, v, cot, part
    torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("setup_fn", ["graded_train_setup", "graded_transformer_train_setup"])
def test_graded_train_step_goes_through_csr_kernels_and_matches_plain_path(cuda_device,
                                                                           setup_fn):
    train = getattr(entry, setup_fn)(cuda_device, num_nodes=1500, batch=4, mp_steps=3)
    plain_sim = copy.deepcopy(train.simulator)
    plain_sim.model.tiling = None
    plain_state, plain_step = entry.make_trainer(plain_sim)
    kernels = ((fused_gn_block_csr,) if setup_fn == "graded_train_setup"
               else (fused_edge_attention_csr, fused_gated_ffn))
    before = [(k.launches, k.backward_launches) for k in kernels]
    m = train.train_step(train.state, train.graph, torch.Generator(cuda_device).manual_seed(3))
    torch.cuda.synchronize()
    assert [(k.launches, k.backward_launches) for k in kernels] == [
        (f + 3, b + 3) for f, b in before]
    mp = plain_step(plain_state, train.graph, torch.Generator(cuda_device).manual_seed(3))
    assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])
    # the JAX suite's value bound (tests/test_fused_gnblock_nk.py:150)
    torch.testing.assert_close(m["loss"], mp["loss"], rtol=0.02, atol=0)

    def unclipped(sim, state, norm):  # undo the clip: g · min(1, clip / norm)
        undo = max(norm.item() / state.optimizer.grad_clip, 1.0)
        return torch.cat([p.grad.float().flatten() * undo for p in sim.parameters()])

    gk = unclipped(train.simulator, train.state, m["grad_norm"])
    gp = unclipped(plain_sim, plain_state, mp["grad_norm"])
    assert ((gk - gp).abs().max() / gp.abs().max()).item() <= gradcheck.WEIGHT_REL
    for p in train.simulator.parameters():
        assert torch.isfinite(p).all()


@pytest.mark.cuda
@pytest.mark.parametrize("setup_fn", ["graded_setup", "graded_transformer_setup"])
def test_graded_forward_goes_through_csr_kernels_and_matches_plain_path(cuda_device, setup_fn):
    setup = getattr(entry, setup_fn)(cuda_device, num_nodes=1500, batch=4, mp_steps=3)
    sim, graph = setup.simulator, setup.graph
    plain = copy.deepcopy(sim)
    plain.model.tiling = None
    epd = setup_fn == "graded_setup"
    kernels = (fused_gn_block_csr,) if epd else (fused_edge_attention_csr, fused_gated_ffn)
    before = [k.launches for k in kernels]
    with torch.no_grad():
        out = sim.forward(graph, is_training=False)
        torch.cuda.synchronize()
        assert [k.launches for k in kernels] == [b + 3 for b in before]
        ref = plain.forward(graph, is_training=False)
    rows = graph.node_mask
    assert torch.isfinite(out.outputs).all()
    tol = 0.15 if epd else 0.1
    torch.testing.assert_close(out.net_out[rows], ref.net_out[rows], rtol=tol, atol=tol)


#: the gumbel kernel against its plain version: logf against torch.log
GUMBEL_ATOL = 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,offset", [
    ((16 * 2432, 4, 32), torch.bfloat16, 0),  # the Transolver slice's logits
    ((1001,), torch.bfloat16, 1),  # a tail of 1 and a misaligned start
    ((7, 3, 5), torch.float32, 0),
    ((4099,), torch.float32, 3),
])
def test_gumbel_kernel_matches_plain_version(cuda_device, shape, dtype, offset):
    gen = torch.Generator(device=cuda_device).manual_seed(21)
    n = torch.Size(shape).numel()
    flat = torch.randn(n + offset, generator=gen, device=cuda_device).to(dtype)
    x = flat[offset:].view(shape)
    key = gumbel_ops.draw_key(gen, cuda_device)
    before = gumbel_ops.gumbel_perturb.launches
    out = gumbel_ops.gumbel_perturb(x, key)
    torch.cuda.synchronize()
    assert gumbel_ops.gumbel_perturb.launches == before + 1
    assert torch.equal(gumbel_ops.philox_bits(n, key), gumbel_ops.random_bits(n, key))
    ref = gumbel_ops.gumbel_perturb_reference(x, key)
    assert out.dtype == torch.float32 and out.shape == x.shape and torch.isfinite(out).all()
    torch.testing.assert_close(out, ref, rtol=0, atol=GUMBEL_ATOL)
    assert torch.equal(out, gumbel_ops.gumbel_perturb(x, key))  # same key, same noise
    assert not torch.equal(out, gumbel_ops.gumbel_perturb(x, gumbel_ops.draw_key(gen, cuda_device)))


@pytest.mark.cuda
def test_gumbel_kernel_gradient_is_a_passthrough(cuda_device):
    x = torch.randn(64, 4, 32, device=cuda_device).to(torch.bfloat16).requires_grad_(True)
    key = torch.tensor([5, 6], dtype=torch.int64, device=cuda_device)
    cot = torch.randn(64, 4, 32, device=cuda_device)
    before = gumbel_ops.gumbel_perturb.launches
    (grad,) = torch.autograd.grad(gumbel_ops.gumbel_perturb(x, key), x, cot)
    assert gumbel_ops.gumbel_perturb.launches == before + 1  # the forward only
    assert grad.dtype == torch.bfloat16 and torch.equal(grad, cot.to(torch.bfloat16))


@pytest.mark.cuda
def test_gumbel_kernel_refusals_raise(cuda_device, monkeypatch):
    x = torch.zeros(8, 4, 32, device=cuda_device, dtype=torch.bfloat16)
    key = torch.zeros(2, dtype=torch.int64, device=cuda_device)
    with pytest.raises(NotImplementedError):
        gumbel_ops.gumbel_perturb(x.half(), key)
    with pytest.raises(ValueError, match="contiguous"):
        gumbel_ops.gumbel_perturb(x.transpose(0, 1), key)
    # a launch the C entry refuses (an unknown input type code) raises
    monkeypatch.setattr(gumbel_ops, "KERNEL_DTYPES", {torch.bfloat16: 7})
    before = gumbel_ops.gumbel_perturb.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        gumbel_ops.gumbel_perturb(x, key)
    assert gumbel_ops.gumbel_perturb.launches == before


@pytest.mark.cuda
def test_transolver_train_step_goes_through_the_gumbel_kernel(cuda_device):
    train = entry.transolver_train_setup(cuda_device, nx=20, ny=16, batch=4)
    plain_sim = use_plain_gumbel(copy.deepcopy(train.simulator))
    plain_state, plain_step = entry.make_trainer(plain_sim)
    n_blocks = len(train.simulator.model.model.blocks)
    kernel = gumbel_ops.gumbel_perturb
    for step in range(3):
        before = kernel.launches
        m = train.train_step(train.state, train.graph,
                             torch.Generator(cuda_device).manual_seed(step))
        torch.cuda.synchronize()
        # one launch a block forward; the backward is a passthrough
        assert kernel.launches == before + n_blocks
        before = kernel.launches
        with torch.no_grad():
            train.simulator.forward(train.graph, is_training=False)
        assert kernel.launches == before  # eval draws no noise
        mp = plain_step(plain_state, train.graph, torch.Generator(cuda_device).manual_seed(step))
        assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])
        # the same bits on both paths: the epd step's bounds hold with room
        torch.testing.assert_close(m["loss"], mp["loss"], rtol=0.02 if step == 0 else 1e-3,
                                   atol=0)
    for p in train.simulator.parameters():
        assert torch.isfinite(p).all()


# ---- the world seam of the attention kernels (rows 5-8) ---------------------

def _world_sidecar(n, n_valid, batch, targets, seed, width=96, device="cuda"):
    """A world-edge sidecar of ``width`` slots a sample ([W, B] int32
    senders and receivers, bool mask): half the slots end at ``targets``
    (receivers without a valid mesh row), the rest at random valid nodes,
    senders at random valid nodes; every fifth slot masked, and the last 8
    the padding convention's (sender 0, receiver n - 1, masked)."""
    rng = np.random.default_rng(seed)
    targets = np.asarray(targets)
    send = rng.integers(0, n_valid, (width, batch))
    recv = np.where(rng.random((width, batch)) < 0.5,
                    targets[rng.integers(0, targets.size, (width, batch))],
                    rng.integers(0, n_valid, (width, batch)))
    mask = (np.arange(width) % 5 != 4)[:, None].repeat(batch, 1)
    send[-8:], recv[-8:], mask[-8:] = 0, n - 1, False
    return [torch.as_tensor(a, device=device).contiguous()
            for a in (send.astype(np.int32), recv.astype(np.int32), mask)]


def _world_case(cuda_device, layout, head_dim, seed):
    """(q, k, v, cotangent, the row arrays with some receivers' rows all
    masked, the layout, the world pieces of a sidecar that reaches those
    receivers, the receivers with neither mesh rows nor world edges, the
    op, its plain version)."""
    batch = 4 if layout == "nk" else 2
    if layout == "nk":
        g, lay, qkv, cot = _attention_case(cuda_device, batch, seed, head_dim, nx=20, ny=16)
        nb = lay.node_block
        gone = torch.tensor([gi * nb + r for gi in range(lay.num_groups) for r in range(3)
                             if gi * nb + r < int(g.node_mask.sum())], device=cuda_device)
        op, plain = fused_edge_attention_nk, fused_edge_attention_nk_reference
    else:
        setup = entry.graded_transformer_setup(cuda_device, num_nodes=1500, batch=batch,
                                               mp_steps=1)
        g, lay = setup.graph, setup.tiling
        gen = torch.Generator(device=cuda_device).manual_seed(seed)
        *qkv, cot = [(s * torch.randn((lay.num_nodes, batch, 4, head_dim), generator=gen,
                                      device=cuda_device)).to(torch.bfloat16)
                     for s in (0.5, 0.5, 0.5, 1.0)]
        gone = torch.arange(0, 1500, 97, device=cuda_device)
        op = fused_edge_attention_csr
        plain = (lambda *a, world_parts=None: ea_csr_ops.PLAIN[0](*a, world=world_parts))
    mask = g.edge_mask & ~torch.isin(g.receivers, gone)
    n, n_valid = lay.num_nodes, int(g.node_mask.sum())
    reached = gone[::2].cpu().numpy()  # the other half of them has neither
    ws, wr, wm = _world_sidecar(n, n_valid, batch, reached, seed, device=cuda_device)
    with torch.no_grad():
        parts = world_attention_parts(*qkv, ws, wr, wm)
    hit = torch.zeros((n, batch), dtype=torch.bool, device=cuda_device)
    hit[wr[wm].long(), torch.nonzero(wm)[:, 1]] = True
    has_rows = torch.zeros(n, dtype=torch.bool, device=cuda_device)
    has_rows[g.receivers[mask].long()] = True
    neither = ~has_rows[:, None] & ~hit
    assert (hit & ~has_rows[:, None]).any() and neither.any()
    return qkv, cot, (g.senders, g.receivers, mask), lay, parts, neither, op, plain


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim", HEAD_DIMS)
@pytest.mark.parametrize("layout", ["nk", "csr"])
def test_world_attention_kernels_match_plain_versions(cuda_device, layout, head_dim):
    """The world seam of rows 5-8: the joint mesh + world forward against
    its plain version (ops/edge_attention.joint_edge_attention), on
    receivers with world edges and no valid mesh row, receivers with
    neither (exact zeros) and masked world slots; the joint statistics it
    keeps against ``softmax_stats`` with the pieces; the backward's dq,
    dk, dv, dnum_w, dden_w against the plain backward and fp32 autograd
    (utils/gradcheck.py), dnum_w and dden_w exactly 0 where a receiver has
    neither."""
    qkv, cot, rows, lay, parts, neither, op, plain = _world_case(cuda_device, layout,
                                                                 head_dim, seed=70 + head_dim)
    kernels = (ea_ops if layout == "nk" else ea_csr_ops).KERNELS
    before = op.launches
    with torch.no_grad():
        out = op(*qkv, *rows, lay, world_parts=parts)
        torch.cuda.synchronize()
        assert op.launches == before + 1
        ref = plain(*qkv, *rows, lay, world_parts=parts)
        kept, (m, inv, out32) = kernels[0](*qkv, *rows, lay, keep_stats=True, world=parts)
        pm, pinv = ea_csr_ops.softmax_stats(*qkv[:2], *rows, world=parts)
    torch.testing.assert_close(out.float(), ref.float(), rtol=0.03, atol=0.02)
    assert torch.equal(out[neither], torch.zeros_like(out[neither]))
    assert torch.equal(kept, out) and torch.equal(out32.to(torch.bfloat16), out)
    torch.testing.assert_close(m, pm, rtol=1e-5, atol=1e-5)
    some = pinv > 0
    torch.testing.assert_close(inv[some], pinv[some], rtol=5e-3, atol=0)
    assert (inv[~some] == 0).all()

    names = ("dq", "dk", "dv", "dnum_w", "dden_w")
    s_w = parts[2]

    def attention(fn):
        return lambda q, k, v, nw, dw: (fn(q, k, v, *rows, lay, world_parts=(nw, dw, s_w)), [])

    before = op.backward_launches
    grad_rows, ok, kept = gradcheck.check_backward(
        names, names, attention(op),
        attention(lambda *a, world_parts: ea_csr_ops.reference_with_backward(
            *a, world_parts=world_parts)),
        attention(plain), [*qkv, *parts[:2]], [cot])
    torch.cuda.synchronize()
    assert op.backward_launches == before + 1
    assert ok, [r for r in grad_rows if not r["ok"]]
    dnum_w, dden_w = torch.autograd.grad(*kept["kernel"])[3:]
    for t in (dnum_w[neither], dden_w[neither]):
        assert torch.equal(t, torch.zeros_like(t))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["nk", "csr"])
def test_world_attention_kernels_are_bit_identical_across_calls(cuda_device, layout):
    """No atomics in the world seam either: two calls give the same output,
    statistics (the fp32 output too) and dq, dk, dv, dnum_w, dden_w; and a
    call without world
    pieces still launches the mesh-only kernel (its output is not the
    joint one)."""
    qkv, cot, rows, lay, parts, _, op, _ = _world_case(cuda_device, layout, 16, seed=80)
    kernels = (ea_ops if layout == "nk" else ea_csr_ops).KERNELS
    calls = [kernels[0](*qkv, *rows, lay, keep_stats=True, world=parts) for _ in range(2)]
    for x, y in zip((calls[0][0], *calls[0][1]), (calls[1][0], *calls[1][1])):
        assert torch.equal(x, y)
    a = calls[0][0]
    grads = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_(True) for t in (*qkv, *parts[:2])]
        out = op(*leaves[:3], *rows, lay, world_parts=(*leaves[3:], parts[2]))
        grads.append(torch.autograd.grad(out, leaves, cot))
    torch.cuda.synchronize()
    for x, y in zip(*grads):
        assert torch.equal(x, y)
    with torch.no_grad():
        mesh_only = op(*qkv, *rows, lay)
    assert not torch.equal(mesh_only, a)
    assert torch.equal(mesh_only, kernels[0](*qkv, *rows, lay))


# ---- rows 1-4 at hidden 64 and 128 (the wide GraphNetBlock kernels) ----------

WIDE = [64, 128]


def _wide_nk_case(cuda_device, hidden, variant, batch, seed, holes=False):
    """A block's inputs on the 16 x 16 cylinder mesh's NK layout at
    ``hidden`` (256 nodes in two node blocks: node N-1 owns valid slots),
    with masked slots between valid ones when ``holes``, and random
    cotangents."""
    setup = entry.cylinder_setup(cuda_device, nx=16, ny=16, hidden=hidden, batch=batch,
                                 mp_steps=3)
    args, kw = _block_args(setup, variant, seed=seed)
    x, e, senders, mask, edge, node, nk = args
    if holes:
        mask = _hole_mask(nk, mask)
    cot_x, cot_e = _csr_cotangents(x, nk.total_rows, 300 + seed)
    return (x, e, senders, mask, edge, node, nk), kw, cot_x, cot_e


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 33])
@pytest.mark.parametrize("variant", ["folded", "middle", "last"])
@pytest.mark.parametrize("hidden", WIDE)
def test_wide_nk_gn_kernel_matches_plain_version(cuda_device, hidden, variant, batch):
    """Row 1 at hidden 64 and 128 on masked slots between valid ones, B=1
    and 33 (partial 16-sample tiles): x_out and e_out within the JAX
    suite's 0.05 of the plain version; a masked slot's e_out is its e_in."""
    args, kw, _, _ = _wide_nk_case(cuda_device, hidden, variant, batch, seed=batch, holes=True)
    with torch.no_grad():
        before = fused_gn_block_nk.launches
        kx, ke = fused_gn_block_nk(*args, **kw)
        torch.cuda.synchronize()
        assert fused_gn_block_nk.launches == before + 1
        px, pe = fused_gn_block_nk_reference(*args, **kw, compute_dtype=torch.bfloat16)
    torch.testing.assert_close(kx.float(), px.float(), rtol=0.05, atol=0.05)
    if variant == "last":
        assert ke is args[1]
    else:
        torch.testing.assert_close(ke.float(), pe.float(), rtol=0.05, atol=0.05)
    if variant == "middle":
        assert torch.equal(ke[~args[3]], args[1][~args[3]])


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 33])
@pytest.mark.parametrize("variant", ["folded", "middle", "last"])
@pytest.mark.parametrize("hidden", WIDE)
def test_wide_nk_gn_backward_kernel_matches_plain_version(cuda_device, hidden, variant, batch):
    """Row 2 at hidden 64 and 128 on the same mesh; bounds:
    utils/gradcheck.py."""
    (x, e, senders, mask, edge, node, nk), kw, cot_x, cot_e = _wide_nk_case(
        cuda_device, hidden, variant, batch, seed=batch, holes=True)
    before = fused_gn_block_nk.backward_launches
    rows, ok, _ = gradcheck.check_block_backward(
        x, e, (senders, mask), (kw["encoder_params"], edge, node), nk, kw["last_block"],
        cot_x, cot_e)
    torch.cuda.synchronize()
    assert fused_gn_block_nk.backward_launches == before + 1
    assert ok, [r for r in rows if not r["ok"]]


def _wide_hub_case(cuda_device, hidden, variant, batch, seed):
    """:func:`_hub_case`'s 384-node CSR graph (a hub of in-degree 150,
    receivers with no row or only masked rows, node N-1 owning rows) with a
    cylinder ``epd`` block of width ``hidden``."""
    args, kw = _hub_case(cuda_device, variant, batch, seed)
    model = entry.cylinder_setup(cuda_device, nx=16, ny=16, hidden=hidden, batch=1,
                                 mp_steps=3).simulator.model
    blk = model.processor_list[BLOCK_OF[variant]]
    gen = torch.Generator(device=cuda_device).manual_seed(seed)
    n, rows = args[0].shape[0], args[7].total_rows
    width = entry.EDGE_INPUT if variant == "folded" else hidden
    x = (0.5 * torch.randn((n, batch, hidden), generator=gen, device=cuda_device)).bfloat16()
    e = (0.5 * torch.randn((rows, batch, width), generator=gen, device=cuda_device)).bfloat16()
    kw = dict(kw, encoder_params=model.edges_encoder if variant == "folded" else None)
    return (x, e, *args[2:5], blk.edge_block, blk.node_block, args[7]), kw


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 17])
@pytest.mark.parametrize("variant", ["folded", "middle", "last"])
@pytest.mark.parametrize("hidden", WIDE)
def test_wide_csr_gn_kernel_on_a_hub_receiver_and_empty_receivers(cuda_device, hidden,
                                                                   variant, batch):
    """Row 3 at hidden 64 and 128 on the hub mesh against the plain version,
    padding and masked rows keeping e_in."""
    args, kw = _wide_hub_case(cuda_device, hidden, variant, batch, seed=batch)
    with torch.no_grad():
        before = fused_gn_block_csr.launches
        kx, ke = fused_gn_block_csr(*args, **kw)
        torch.cuda.synchronize()
        assert fused_gn_block_csr.launches == before + 1
        px, pe = fused_gn_block_csr_reference(*args, **kw, compute_dtype=torch.bfloat16)
    torch.testing.assert_close(kx.float(), px.float(), rtol=0.05, atol=0.05)
    if variant == "last":
        assert ke is args[1]
    else:
        torch.testing.assert_close(ke.float(), pe.float(), rtol=0.05, atol=0.05)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["folded", "middle", "last"])
@pytest.mark.parametrize("hidden", WIDE)
def test_wide_csr_gn_backward_kernel_on_a_hub_receiver_and_empty_receivers(cuda_device,
                                                                            hidden, variant):
    """Row 4 at hidden 64 and 128 on the hub mesh at B=17; bounds:
    utils/gradcheck.py, every dx value (the hub's too) held against the
    plain backward at the width's outside share: at these widths no value
    needs judging against fp32."""
    args, kw = _wide_hub_case(cuda_device, hidden, variant, 17, seed=5)
    x, e, senders, receivers, mask, edge, node, csr = args
    cot_x, cot_e = _csr_cotangents(x, csr.total_rows, 205)
    before = fused_gn_block_csr.backward_launches
    rows, ok, _ = gradcheck.check_block_backward(
        x, e, (senders, receivers, mask), (kw["encoder_params"], edge, node), csr,
        kw["last_block"], cot_x, cot_e)
    torch.cuda.synchronize()
    assert fused_gn_block_csr.backward_launches == before + 1
    assert ok, [r for r in rows if not r["ok"]]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("variant", ["folded", "middle"])
@pytest.mark.parametrize("hidden", WIDE)
def test_wide_backward_share_separates_the_kernel_from_the_fp32_control(cuda_device, hidden,
                                                                        variant, seed):
    """Rows 2 and 4's dx share (``gradcheck.block_outside_share``) at
    hidden 64 and 128 on the hub mesh (B=17) over six seeds: the kernel's
    dx stays inside it, and the control, the fp32 gradient (none of the
    plain backward's bf16 roundings), leaves it. Prints both readings, and
    de's (PERF.md §6 cites them)."""
    args, kw = _wide_hub_case(cuda_device, hidden, variant, 17, seed=seed)
    x, e, senders, receivers, mask, edge, node, csr = args
    cot_x, cot_e = _csr_cotangents(x, csr.total_rows, 400 + seed)
    rows, ok, _ = gradcheck.check_block_backward(
        x, e, (senders, receivers, mask), (kw["encoder_params"], edge, node), csr,
        kw["last_block"], cot_x, cot_e)
    dx = rows[0]
    allowed = gradcheck.block_outside_share(hidden) * dx["count"]
    print(f"hidden {hidden} {variant} seed {seed}: outside the plain backward's bound: dx "
          f"kernel {dx['outside']}, fp32 control {dx['fp32_outside']} of {dx['count']} "
          f"(allowed {allowed:.1f})" + "".join(
              f"; de kernel {r['outside']}, fp32 control {r['fp32_outside']} of {r['count']}"
              for r in rows[1:2] if r["name"] == "de"))
    assert ok, [r for r in rows if not r["ok"]]
    assert dx["fp32_outside"] > allowed


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["nk", "csr"])
@pytest.mark.parametrize("variant", ["folded", "middle"])
@pytest.mark.parametrize("hidden", WIDE)
def test_wide_gn_kernels_are_bit_identical_across_calls(cuda_device, hidden, variant, layout):
    """No atomics in the wide kernels, the weight gradients summed from
    per-split partials in a fixed order: two forward + backward calls give
    the same outputs, dx, de and every parameter's gradient, bit for bit."""
    _check_bits_across_calls(cuda_device, hidden, variant, layout)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["nk", "csr"])
@pytest.mark.parametrize("variant", ["folded", "middle"])
def test_hidden32_gn_kernels_are_bit_identical_across_calls(cuda_device, variant, layout):
    """Rows 1-4 at hidden 32 sum their weight gradients from per-block
    partials in block order (csrc/gn_bwd_common.cuh), no atomics: two
    forward + backward calls give the same outputs, dx, de and every
    parameter's gradient, bit for bit."""
    _check_bits_across_calls(cuda_device, 32, variant, layout)


def _set_activation(mlp, activation):
    """``mlp`` with ``activation`` between its Dense layers, in place (its
    parameters, and so a trainer's optimizer, stay): what
    MLP(..., activation=activation) builds."""
    mlp.activation, mlp.act_fn = activation, ACTIVATIONS[activation]
    for i, m in enumerate(mlp):
        if isinstance(m, Activation):
            mlp[i] = Activation(activation)


def _with_depth(args, kw, lead, depth, norm, seed):
    """The case's block with new edge and node MLPs (and folded encoder) of
    ``depth`` Dense layers, an RMSNorm tail when ``norm`` (weights drawn
    from ``seed``): args with them at ``lead``, lead + 1, and kw."""
    edge, node = args[lead:lead + 2]
    h, device = edge.denses[-1].weight.shape[0], edge.denses[0].weight.device
    torch.manual_seed(seed)
    mlps = [MLP(m.denses[0].weight.shape[1], h, h, nb_of_layers=depth, layer_norm=norm,
                activation=m.activation).to(device) for m in (edge, node)]
    enc = kw["encoder_params"]
    if enc is not None:
        enc = MLP(enc.denses[0].weight.shape[1], h, h, nb_of_layers=depth,
                  layer_norm=norm).to(device)
    return (*args[:lead], *mlps, *args[lead + 2:]), dict(kw, encoder_params=enc)


def _check_bits_across_calls(cuda_device, hidden, variant, layout, activation="relu",
                             depth=None, norm=True):
    if layout == "nk":
        args, kw, cot_x, cot_e = _wide_nk_case(cuda_device, hidden, variant, 33, seed=9,
                                               holes=True)
        fn, lead = fused_gn_block_nk, 4
    else:
        args, kw = _wide_hub_case(cuda_device, hidden, variant, 17, seed=9)
        cot_x, cot_e = _csr_cotangents(args[0], args[7].total_rows, 209)
        fn, lead = fused_gn_block_csr, 5
    if depth is not None:
        args, kw = _with_depth(args, kw, lead, depth, norm, seed=9)
    for mlp in args[lead:lead + 2]:
        _set_activation(mlp, activation)
    mlps = [m for m in (kw["encoder_params"], *args[lead:lead + 2]) if m is not None]
    params = [p for m in mlps for p in nk_ops._mlp_params(m)]
    runs = []
    for _ in range(2):
        xl = args[0].clone().requires_grad_(True)
        e = args[1].clone().requires_grad_(variant != "folded")
        xo, eo = fn(xl, e, *args[2:], **kw)
        wrt = [xl] + ([e] if variant != "folded" else []) + params
        grads = torch.autograd.grad([xo, eo], wrt, [cot_x, cot_e])
        runs.append([xo.detach(), eo.detach(), *grads])
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", WIDE)
def test_wide_train_step_goes_through_both_kernels_and_matches_plain_path(cuda_device, hidden):
    """A 3-block ``epd`` train step at hidden 64 and 128, B=8, NK: 3 + 3
    launches of rows 1/2, the loss within the JAX suite's 0.02 of the plain
    path."""
    train = entry.cylinder_train_setup(cuda_device, nx=20, ny=16, batch=8, hidden=hidden,
                                       mp_steps=3)
    plain_sim = copy.deepcopy(train.simulator)
    plain_sim.model.tiling = None
    plain_state, plain_step = entry.make_trainer(plain_sim)
    before = (fused_gn_block_nk.launches, fused_gn_block_nk.backward_launches)
    m = train.train_step(train.state, train.graph, torch.Generator(cuda_device).manual_seed(3))
    torch.cuda.synchronize()
    assert (fused_gn_block_nk.launches, fused_gn_block_nk.backward_launches) == (
        before[0] + 3, before[1] + 3)
    mp = plain_step(plain_state, train.graph, torch.Generator(cuda_device).manual_seed(3))
    assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])
    torch.testing.assert_close(m["loss"], mp["loss"], rtol=0.02, atol=0)


#: chip_smoke.py phase 36 compares the MeshGraphNets-width kernel path
#: with the plain path over its first MGN_COMPARED_STEPS steps, held to
#: LATER_LOSS_RTOL (both named as there)
MGN_COMPARED_STEPS, LATER_LOSS_RTOL = 7, 1e-3


@pytest.mark.cuda
def test_mgn_width_plain_training_repeats_itself_over_the_compared_steps(cuda_device):
    """``epd`` at hidden 128 and 15 blocks trains chaotically at B=32
    (phase 36's comparison): two plain runs on the same noise, the second
    from the weights scaled by 1 + 2^-16 (one in 256 to 512 of their bf16
    values rounds the other way), agree within LATER_LOSS_RTOL over the
    first MGN_COMPARED_STEPS steps. Prints each of 20 steps' relative
    difference (PERF.md §6 cites them)."""
    train = entry.cylinder_train_setup(cuda_device, hidden=128, mp_steps=15, batch=32)
    losses = []
    for scale in (1.0, 1.0 + 2.0 ** -16):
        sim = copy.deepcopy(train.simulator)
        sim.model.tiling = None
        with torch.no_grad():
            for p in sim.parameters():
                p.mul_(scale)
        state, step = entry.make_trainer(sim)
        gen = torch.Generator(cuda_device).manual_seed(38)
        losses.append([step(state, train.graph, gen)["loss"].item() for _ in range(20)])
        del sim, state, step
        torch.cuda.empty_cache()
    rel = [abs(a - b) / abs(b) for a, b in zip(losses[1], losses[0])]
    print("MGN-width plain path against itself nudged, relative loss difference by step: "
          + " ".join(f"{v:.3g}" for v in rel))
    assert all(np.isfinite(losses).ravel())
    assert max(rel[:MGN_COMPARED_STEPS]) <= LATER_LOSS_RTOL, rel


@pytest.mark.cuda
def test_gn_kernels_refuse_widths_without_a_kernel(cuda_device):
    """Every width JAX fuses has its kernels: hidden 16 launches rows 1-4 in
    both layouts, forward and backward. What the kernels do not take
    raises and counts no launch: hidden 24 (which JAX does not fuse, so no
    model sends it there), and a 9-layer MLP (the kernels take 1 to 8
    Dense layers; a 3-layer MLP, refused before they took every depth,
    launches)."""
    setup = entry.cylinder_setup(cuda_device, nx=16, ny=16, hidden=16, batch=2, mp_steps=3)
    args, kw = _block_args(setup, "middle", seed=0)
    g = entry.graded_setup(cuda_device, num_nodes=1536, hidden=16, batch=2, mp_steps=3)
    gargs, gkw = _graded_block_args(g, "middle", seed=0)
    for fn, a, k in ((fused_gn_block_nk, args, kw), (fused_gn_block_csr, gargs, gkw)):
        before = (fn.launches, fn.backward_launches)
        x = a[0].clone().requires_grad_(True)
        xo, eo = fn(x, *a[1:], **k)
        torch.autograd.grad([xo, eo], [x], [torch.ones_like(xo), torch.ones_like(eo)])
        torch.cuda.synchronize()
        assert (fn.launches, fn.backward_launches) == (before[0] + 1, before[1] + 1)
    wide = entry.cylinder_setup(cuda_device, nx=16, ny=16, hidden=24, batch=2, mp_steps=3)
    wargs, wkw = _block_args(wide, "middle", seed=0)
    before, before_bwd = fused_gn_block_nk.launches, fused_gn_block_nk.backward_launches
    with pytest.raises(NotImplementedError, match="built for hidden"):
        fused_gn_block_nk(*wargs, **wkw)
    deep = MLP(3 * 16, 16, 16, nb_of_layers=9).to(cuda_device)
    with pytest.raises(NotImplementedError, match="1 to 8 Dense layers"):
        fused_gn_block_nk(args[0].requires_grad_(True), *args[1:4], deep, *args[5:], **kw)
    assert fused_gn_block_nk.launches == before
    shallow = MLP(3 * 16, 16, 16, nb_of_layers=3).to(cuda_device)
    x = args[0].detach().clone().requires_grad_(True)
    xo, eo = fused_gn_block_nk(x, *args[1:4], shallow, *args[5:], **kw)
    torch.autograd.grad([xo, eo], [x], [torch.ones_like(xo), torch.ones_like(eo)])
    torch.cuda.synchronize()
    assert (fused_gn_block_nk.launches, fused_gn_block_nk.backward_launches) == (
        before + 1, before_bwd + 1)


@pytest.mark.cuda
def test_epd_at_hidden_24_takes_the_plain_path_on_the_card(cuda_device):
    """Hidden 24 does not divide the 128 lanes: JAX runs its plain
    GraphNetBlock, and so does the port, with no launch of rows 1-4."""
    setup = entry.cylinder_setup(cuda_device, nx=16, ny=16, hidden=24, batch=2, mp_steps=3)
    counts = lambda: (fused_gn_block_nk.launches, fused_gn_block_nk.backward_launches,  # noqa
                      fused_gn_block_csr.launches, fused_gn_block_csr.backward_launches)
    before = counts()
    out = setup.simulator.forward(setup.graph, is_training=False)
    torch.cuda.synchronize()
    assert counts() == before
    assert torch.isfinite(out.outputs).all()


# ---- rows 1-4 at hidden 16 to 1, and with silu or gelu MLPs at every width ----

SMALL_GN = [16, 8, 4, 2, 1]
ACT_HIDDEN = [1, 2, 4, 8, 16, 32, 64, 128]


def _first(hidden):
    """The first block's variant at ``hidden``: folded where JAX folds the
    edge encoder (raw features no wider than hidden // 2), else taking the
    encoded edges."""
    return "folded" if entry.EDGE_INPUT <= hidden // 2 else "first"


def _gn_case(cuda_device, layout, hidden, variant, seed, activation="relu"):
    """A block's inputs and cotangents at ``hidden``: in the NK layout the
    16 x 16 cylinder mesh with masked slots between valid ones at B=33, in
    the CSR layout the hub mesh at B=17; the block's MLPs take
    ``activation`` (the folded encoder keeps relu, as in an ``epd``).
    Returns (op, plain version, args, kw, cot_x, cot_e)."""
    if layout == "nk":
        args, kw, cot_x, cot_e = _wide_nk_case(cuda_device, hidden, variant, 33, seed,
                                                holes=True)
        ops = (fused_gn_block_nk, fused_gn_block_nk_reference)
        edge, node = args[4:6]
    else:
        args, kw = _wide_hub_case(cuda_device, hidden, variant, 17, seed)
        cot_x, cot_e = _csr_cotangents(args[0], args[7].total_rows, 500 + seed)
        ops = (fused_gn_block_csr, fused_gn_block_csr_reference)
        edge, node = args[5:7]
    _set_activation(edge, activation)
    _set_activation(node, activation)
    return (*ops, args, kw, cot_x, cot_e)


def _check_gn_forward(fn, ref, args, kw):
    """One forward launch of ``fn`` within the JAX suite's 0.05 of its plain
    version: x_out, and e_out (on the valid rows of a folded block, whose
    masked rows hold enc(raw) in the kernel; passed through on the last)."""
    mask = args[3] if fn is fused_gn_block_nk else args[4]
    with torch.no_grad():
        before = fn.launches
        kx, ke = fn(*args, **kw)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        px, pe = ref(*args, **kw, compute_dtype=torch.bfloat16)
    torch.testing.assert_close(kx.float(), px.float(), rtol=0.05, atol=0.05)
    if kw["last_block"]:
        assert ke is args[1]
        return
    rows = mask if kw["encoder_params"] is not None else slice(None)
    torch.testing.assert_close(ke.float()[rows], pe.float()[rows], rtol=0.05, atol=0.05)
    if kw["encoder_params"] is None:
        assert torch.equal(ke[~mask], args[1][~mask])  # a masked row's e_out is its e_in


def _check_gn_backward(fn, args, kw, cot_x, cot_e, print_shares=False):
    """One backward launch of ``fn``'s kernel held to utils/gradcheck.py;
    returns the rows."""
    nk = fn is fused_gn_block_nk
    rows_ = (args[2], args[3]) if nk else (args[2], args[3], args[4])
    edge, node, lay = args[4:7] if nk else args[5:8]
    before = fn.backward_launches
    rows, ok, _ = gradcheck.check_block_backward(
        args[0], args[1], rows_, (kw["encoder_params"], edge, node), lay, kw["last_block"],
        cot_x, cot_e)
    torch.cuda.synchronize()
    assert fn.backward_launches == before + 1
    assert ok, [r for r in rows if not r["ok"]]
    return rows


def _small_variants(hidden):
    return [_first(hidden), "middle", "last"]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["nk", "csr"])
@pytest.mark.parametrize("hidden,variant", [(h, v) for h in SMALL_GN for v in _small_variants(h)])
def test_small_gn_kernels_match_plain_versions(cuda_device, hidden, variant, layout):
    """Rows 1 and 3 at hidden 16 to 1 (tiles zero-padded to 16 below 16),
    every variant (the folded encoder at 16 and 8, where JAX folds it; the
    first block on encoded edges at 4 and below), on the NK mesh with
    masked slots between valid ones (B=33) and the CSR hub mesh (B=17)."""
    fn, ref, args, kw, _, _ = _gn_case(cuda_device, layout, hidden, variant, seed=hidden)
    _check_gn_forward(fn, ref, args, kw)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["nk", "csr"])
@pytest.mark.parametrize("hidden,variant", [(h, v) for h in SMALL_GN for v in _small_variants(h)])
def test_small_gn_backward_kernels_match_plain_versions(cuda_device, hidden, variant, layout):
    """Rows 2 and 4 at hidden 16 to 1 on the same meshes; bounds:
    utils/gradcheck.py. At hidden 1 each MLP's RMSNorm tail gives
    ±scale, so the gradients of every Dense parameter before it are 0 in
    exact arithmetic and rounding noise in both backwards: they are
    compare_grads' ``noise`` gradients, held to WEIGHT_REL of the block's
    largest weight gradient, with no fp32 ratio. The streams and the
    scales are held as at every width."""
    fn, _, args, kw, cot_x, cot_e = _gn_case(cuda_device, layout, hidden, variant,
                                             seed=10 + hidden)
    _check_gn_backward(fn, args, kw, cot_x, cot_e)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["nk", "csr"])
@pytest.mark.parametrize("hidden", ACT_HIDDEN)
@pytest.mark.parametrize("activation", ["silu", "gelu"])
def test_gn_kernels_with_silu_and_gelu_match_plain_versions(cuda_device, activation, hidden,
                                                            layout):
    """Rows 1-4 with silu or exact-gelu MLPs at every hidden width 1 to
    128: the first block (folded where JAX folds) in the NK layout, a
    middle block in the CSR layout, forward within 0.05 of the plain
    version and backward held to utils/gradcheck.py."""
    variant = _first(hidden) if layout == "nk" else "middle"
    fn, ref, args, kw, cot_x, cot_e = _gn_case(cuda_device, layout, hidden, variant,
                                               seed=20 + hidden, activation=activation)
    _check_gn_forward(fn, ref, args, kw)
    _check_gn_backward(fn, args, kw, cot_x, cot_e)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["nk", "csr"])
@pytest.mark.parametrize("hidden,activation", [(16, "relu"), (4, "relu"), (1, "relu"),
                                               (16, "silu"), (1, "gelu"), (128, "silu"),
                                               (64, "gelu")])
def test_small_and_activation_gn_kernels_are_bit_identical_across_calls(
        cuda_device, hidden, activation, layout):
    """The new instances sum their weight gradients from per-block partials
    in block order, no atomics: two forward + backward calls give the same
    outputs, dx, de and every parameter's gradient, bit for bit."""
    _check_bits_across_calls(cuda_device, hidden, _first(hidden), layout, activation)


#: (depth, norm) of the other-depth cases: 1 to 8 Dense layers, with and
#: without the RMSNorm tail (4 layers without it in the NL instances)
DEPTH_CASES = [(1, True), (2, False), (3, True), (3, False), (4, False), (5, True), (8, False),
               (8, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["nk", "csr"])
@pytest.mark.parametrize("hidden", ACT_HIDDEN)
@pytest.mark.parametrize("depth,norm", DEPTH_CASES)
def test_gn_kernels_at_other_depths_match_plain_versions(cuda_device, depth, norm, hidden,
                                                         layout):
    """Rows 1-4 with MLPs of 1 to 8 Dense layers, with or without the
    RMSNorm tail, at every width 1 to 128 (the tile backward's other-depth
    instances at 1 to 32; at hidden 128 the MLPs of more than 5 or 6
    layers read their last layers from device memory): the first block
    (folded where JAX folds, its encoder of the same depth and tail) in the
    NK layout, a middle block in the CSR layout; forward within 0.05 of the
    plain version, backward held to utils/gradcheck.py."""
    variant = _first(hidden) if layout == "nk" else "middle"
    fn, ref, args, kw, cot_x, cot_e = _gn_case(cuda_device, layout, hidden, variant,
                                               seed=40 + depth)
    args, kw = _with_depth(args, kw, 4 if layout == "nk" else 5, depth, norm, seed=depth)
    _check_gn_forward(fn, ref, args, kw)
    _check_gn_backward(fn, args, kw, cot_x, cot_e)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["nk", "csr"])
@pytest.mark.parametrize("hidden,depth,norm", [(32, 3, False), (8, 8, True), (16, 2, False),
                                               (64, 5, True), (128, 3, True), (128, 8, False)])
def test_other_depth_gn_kernels_are_bit_identical_across_calls(cuda_device, hidden, depth, norm,
                                                               layout):
    """The other-depth instances add each block's weight-gradient sums into
    its own slot of the partials, summed in block order: two forward +
    backward calls give the same outputs and gradients, bit for bit (the
    first block, folded where JAX folds)."""
    _check_bits_across_calls(cuda_device, hidden, _first(hidden), layout, depth=depth,
                             norm=norm)


# ---- rows 1-4 at hidden 64 and 128 on warpgroup tiles ------------------------

#: the batches of the warpgroup tiles: a 64-sample tile over four rows
#: (16), over two or three rows with a ragged chunk (37), of one row (64,
#: 128)
TILE_BATCHES = [16, 37, 64, 128]
#: (depth, norm, variant) of the tile cases: one to eight layers (the
#: eight-layer MLPs stream their last layers at hidden 128), with and
#: without the RMSNorm tail, every variant
TILE_DEPTHS = [(1, True, "folded"), (1, False, "middle"), (2, False, "last"),
               (3, True, "middle"), (3, False, "folded"), (4, True, "last"), (4, False, "last"),
               (8, True, "folded"), (8, True, "middle"), (8, False, "middle")]
#: the tile cases, by test id, whose weight gradients leave
#: utils/gradcheck.py's bounds with the parent tree's wide backward as
#: well: ROADMAP.md C, "Open: the wide backward's weight gradients on
#: three tile cases"
TILE_OPEN = {"4-False-last-16-128-csr", "4-False-last-64-128-csr", "8-True-middle-128-128-csr"}


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", WIDE)
def test_wgmma_helpers_match_torch_matmul(cuda_device, hidden):
    """csrc/wgmma_common.cuh on the card (tests/csrc/wgmma_check.cu): a 64 x H x
    H warpgroup product with A from registers and the packed weight in
    shared memory, read K-major (A · Wᵀ) and MN-major (A · W), and Gᵀ · X
    over 64 rows with both operands in TMA boxes, each within 1e-4 of
    torch.matmul on the same bf16 values in fp32 (fp32 sums of 64 to 128
    products in another order); a 16-sample TMA box read into fragments
    gives its rows exactly, zeros past the batch."""
    import ctypes

    from graph_physics_tpu_torch.ops import kernel_build
    from test_torch_kernel_build import CHECK_LIBRARIES

    vp, i = ctypes.c_void_p, ctypes.c_int
    lib = kernel_build.load("wgmma_check", {"wgc_pack": [vp, i, i, i, i, vp, vp],
                                            "wgc_rs": [i, i, vp, vp, vp, vp],
                                            "wgc_ss": [i, vp, vp, vp, vp],
                                            "wgc_box": [i, vp, i, i, i, i, vp, vp]},
                            source=CHECK_LIBRARIES["wgmma_check"])
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda_device).manual_seed(hidden)
    stream = torch.cuda.current_stream().cuda_stream

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=cuda_device) * 2 - 1

    a, g = rand(64, hidden).bfloat16(), rand(64, hidden).bfloat16()
    w = rand(hidden, hidden)
    img = torch.empty(hidden * hidden, dtype=torch.bfloat16, device=cuda_device)
    assert lib.wgc_pack(w.data_ptr(), hidden, hidden, 0, hidden, img.data_ptr(), stream) == 0
    wb = w.bfloat16().float()
    for trans, ref in ((0, a.float() @ wb.T), (1, a.float() @ wb)):
        out = torch.zeros(64, hidden, device=cuda_device)
        assert lib.wgc_rs(hidden, trans, a.data_ptr(), img.data_ptr(), out.data_ptr(),
                          stream) == 0
        torch.cuda.synchronize()
        torch.testing.assert_close(out, ref, rtol=0, atol=1e-4)
    out = torch.zeros(hidden, hidden, device=cuda_device)
    assert lib.wgc_ss(hidden, g.data_ptr(), a.data_ptr(), out.data_ptr(), stream) == 0
    torch.cuda.synchronize()
    torch.testing.assert_close(out, g.float().T @ a.float(), rtol=0, atol=1e-4)
    src = rand(5, 37, hidden).bfloat16()
    for row, b0 in ((0, 0), (3, 16), (4, 32)):
        out = torch.full((16, hidden), 7.0, dtype=torch.bfloat16, device=cuda_device)
        assert lib.wgc_box(hidden, src.data_ptr(), 5, 37, row, b0, out.data_ptr(), stream) == 0
        torch.cuda.synchronize()
        want = torch.zeros_like(out)
        want[:min(16, 37 - b0)] = src[row, b0:b0 + 16]
        assert torch.equal(out, want)


def _tile_params():
    """The tile cases (depth, norm, variant, batch, hidden, layout), those
    of ``TILE_OPEN`` expected to fail their gradient check."""
    out = []
    for (depth, norm, variant), batch, hidden, layout in itertools.product(
            TILE_DEPTHS, TILE_BATCHES, WIDE, ("nk", "csr")):
        case = (depth, norm, variant, batch, hidden, layout)
        tid = "-".join(map(str, case))
        marks = [pytest.mark.xfail(strict=True, raises=AssertionError,
                                   reason="ROADMAP.md C: the wide backward's weight gradients "
                                          "on three tile cases")] if tid in TILE_OPEN else []
        out.append(pytest.param(*case, id=tid, marks=marks))
    return out


def tile_case(cuda_device, depth, norm, variant, batch, hidden, layout, weight_seed=None):
    """A tile case's block: (wrapper, plain version, args, kw, extra
    aggregate or None, cot_x, cot_e, the edge MLP's index in args), on the
    NK mesh with masked slots between valid ones or the CSR hub graph,
    with MLPs of ``depth`` layers (weights from ``weight_seed``, by default
    ``depth``) and, on a middle block, a world seam's extra aggregate."""
    if layout == "nk":
        args, kw, cot_x, cot_e = _wide_nk_case(cuda_device, hidden, variant, batch, seed=batch,
                                                holes=True)
        fn, lead = fused_gn_block_nk, 4
    else:
        args, kw = _wide_hub_case(cuda_device, hidden, variant, batch, seed=batch)
        cot_x, cot_e = _csr_cotangents(args[0], args[-1].total_rows, 700 + batch)
        fn, lead = fused_gn_block_csr, 5
    args, kw = _with_depth(args, kw, lead, depth, norm,
                           seed=depth if weight_seed is None else weight_seed)
    ref = fused_gn_block_nk_reference if layout == "nk" else fused_gn_block_csr_reference
    extra = None
    if variant == "middle":
        gen = torch.Generator(device=cuda_device).manual_seed(800 + batch)
        extra = (0.3 * torch.randn(args[0].shape, generator=gen, device=cuda_device)).bfloat16()
    return fn, ref, args, kw, extra, cot_x, cot_e, lead


@pytest.mark.cuda
@pytest.mark.parametrize("depth,norm,variant,batch,hidden,layout", _tile_params())
def test_wide_gn_kernels_on_warpgroup_tiles(cuda_device, depth, norm, variant, batch, hidden,
                                            layout):
    """Rows 1-4 at hidden 64 and 128 at every way a 64-sample warpgroup
    tile fills (TILE_BATCHES), MLPs of 1 to 8 layers with and without the
    norm, every variant, a world seam's extra aggregate on the middle
    blocks, both layouts (the NK mesh with masked slots between valid
    ones, the CSR hub graph): forward within 0.05 of the plain version,
    backward (dea too) held to utils/gradcheck.py; at B=64 two calls give
    the same bits."""
    fn, ref, args, kw, extra, cot_x, cot_e, lead = tile_case(cuda_device, depth, norm, variant,
                                                             batch, hidden, layout)
    _check_gn_forward(fn, ref, args, dict(kw, extra_agg=extra))
    before = fn.backward_launches
    rows, ok, _ = gradcheck.check_block_backward(
        args[0], args[1], args[2:lead], (kw["encoder_params"], *args[lead:lead + 2]), args[-1],
        kw["last_block"], cot_x, cot_e, extra=extra)
    torch.cuda.synchronize()
    assert fn.backward_launches == before + 1
    assert ok, [r for r in rows if not r["ok"]]
    if batch != 64:
        return
    mlps = [m for m in (kw["encoder_params"], *args[lead:lead + 2]) if m is not None]
    params = [p for m in mlps for p in nk_ops._mlp_params(m)]
    runs = []
    for _ in range(2):
        xl = args[0].clone().requires_grad_(True)
        el = args[1].clone().requires_grad_(variant != "folded")
        xo, eo = fn(xl, el, *args[2:], **kw, extra_agg=extra)
        wrt = [xl] + ([el] if variant != "folded" else []) + params
        runs.append([xo.detach(), eo.detach(), *torch.autograd.grad([xo, eo], wrt,
                                                                    [cot_x, cot_e])])
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_fixed_order_sums_repeat_on_the_card(cuda_device):
    """ops/segment.py's sums on the card: ``segment_sum``, ``wscatter_sum``
    and ``gather_rows``'s gradient give the same bits on two calls (many
    values a segment, so atomics would race) and lie within 1e-6 of each
    segment's sum of magnitudes (fp32 sums of ~3,000 values) from the
    float64 sums, masked lanes and empty segments included."""
    from graph_physics_tpu_torch.ops import segment
    from graph_physics_tpu_torch.ops.world_gather import wscatter_sum, wtake

    gen = torch.Generator(cuda_device).manual_seed(0)
    vals = torch.randn(200_000, 8, generator=gen, device=cuda_device)
    ids = torch.randint(0, 64, (200_000,), generator=gen, device=cuda_device, dtype=torch.int32)
    ids[ids == 7] = 8  # segment 7 empty
    mask = torch.rand(200_000, generator=gen, device=cuda_device) > 0.1
    def fp64_sums(v, i):  # (the float64 sums, each segment's sum of magnitudes)
        z = torch.zeros(64, 8, dtype=torch.float64, device=cuda_device)
        return (z.index_add(0, i.long(), v.double()), z.index_add(0, i.long(), v.double().abs()))

    want, mass = fp64_sums(vals[mask], ids[mask])
    runs = [segment.segment_sum(vals, ids, 64, mask=mask) for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    assert torch.equal(runs[0][7], torch.zeros(8, device=cuda_device))
    assert ((runs[0].double() - want).abs() <= 1e-6 * mass).all()
    wv = torch.randn(4096, 16, 4, generator=gen, device=cuda_device)
    widx = torch.randint(0, 50, (4096, 16), generator=gen, device=cuda_device, dtype=torch.int32)
    wmask = torch.rand(4096, 16, generator=gen, device=cuda_device) > 0.2
    wruns = [wscatter_sum(wv, widx, 64, wmask) for _ in range(2)]
    assert torch.equal(wruns[0], wruns[1])
    node = torch.randn(64, 16, 4, generator=gen, device=cuda_device, requires_grad=True)
    cot = torch.randn(4096, 16, 4, generator=gen, device=cuda_device)
    gruns = [torch.autograd.grad(wtake(node, widx), node, cot)[0] for _ in range(2)]
    src = torch.randn(64, 8, generator=gen, device=cuda_device, requires_grad=True)
    gruns2 = [torch.autograd.grad(segment.gather_rows(src, ids), src, vals)[0]
              for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(gruns[0], gruns[1]) and torch.equal(gruns2[0], gruns2[1])
    want, mass = fp64_sums(vals, ids)
    assert ((gruns2[0].double() - want).abs() <= 1e-6 * mass).all()


@pytest.mark.cuda
def test_lanes_off_the_mask_match_the_cpu_on_the_card(cuda_device):
    """``scatter_rows`` with a mask and values left in the lanes off it: the
    card (those lanes sent to spare rows) gives the CPU's sums (those lanes
    zeroed) to 1e-6 of each segment's sum of magnitudes, and the same zero
    gradient in those lanes."""
    from graph_physics_tpu_torch.ops import segment

    gen = torch.Generator().manual_seed(11)
    vals = torch.randn(50_000, 4, generator=gen)
    ids = torch.randint(0, 32, (50_000,), generator=gen)
    mask = torch.rand(50_000, generator=gen) > 0.3
    g = torch.randn(32, 4, generator=gen)
    out = {}
    for dev in ("cpu", cuda_device):
        leaf = vals.to(dev).requires_grad_(True)
        s = segment.scatter_rows(leaf, ids.to(dev), 32, mask.to(dev))
        (dv,) = torch.autograd.grad(s, leaf, g.to(dev))
        out[str(dev)] = (s.detach().cpu(), dv.cpu())
    (s_cpu, dv_cpu), (s_card, dv_card) = out["cpu"], out[str(cuda_device)]
    mass = torch.zeros(32, 4).index_add_(0, ids, torch.where(mask[:, None], vals, 0.0).abs())
    assert ((s_card - s_cpu).abs() <= 1e-6 * mass).all()
    assert torch.equal(dv_card, dv_cpu) and not dv_card[~mask].any()


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["plate transformer", "panels"])
def test_default_mode_train_steps_repeat_bit_for_bit(cuda_device, workload):
    """Two runs of 10 train steps from the same weights and noise in
    PyTorch's default mode give the same losses and weights, bit for bit:
    the plate transformer (world edges through the kernels' seam, the
    world pieces' gathers and scatter in plain torch) and panels (the
    physics loss's segment sums)."""
    train = (entry.plate_train_setup(cuda_device) if workload == "plate transformer"
             else entry.panels_train_setup(cuda_device))
    assert not torch.are_deterministic_algorithms_enabled()
    runs = []
    for _ in range(2):
        sim = copy.deepcopy(train.simulator)
        state, step = entry.make_trainer(sim, train.device_preprocess,
                                         getattr(train, "loss_fn", None),
                                         getattr(train, "gradient_method", None))
        gen = torch.Generator(cuda_device).manual_seed(52)
        losses = [step(state, train.graph, gen)["loss"].item() for _ in range(10)]
        runs.append((losses, [p.detach().clone() for p in sim.parameters()]))
        del sim, state, step
    assert runs[0][0] == runs[1][0], runs
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("hidden", SMALL_GN)
def test_small_backward_share_separates_the_kernel_from_the_fp32_control(cuda_device, hidden,
                                                                         seed):
    """Rows 2 and 4's dx share (``gradcheck.block_outside_share``) at
    hidden 16 to 1 on the hub mesh (B=17) and the NK mesh (B=33) over
    three seeds, a middle block: the kernel's dx stays inside it, and the
    control, the fp32 gradient (none of the plain backward's bf16
    roundings), leaves it in at least one layout, but at hidden 1: there
    each MLP's RMSNorm tail of one value passes no gradient, so dx is
    g_xout in the kernel, the plain backward and fp32 alike, and the
    control leaves the bound on no value either. Prints both readings, and
    de's (PERF.md §6 cites them)."""
    control = []
    for layout in ("csr", "nk"):
        fn, _, args, kw, cot_x, cot_e = _gn_case(cuda_device, layout, hidden, "middle",
                                                 seed=40 + seed)
        rows = _check_gn_backward(fn, args, kw, cot_x, cot_e)
        dx = rows[0]
        allowed = gradcheck.block_outside_share(hidden) * dx["count"]
        print(f"hidden {hidden} {layout} seed {seed}: outside the plain backward's bound: dx "
              f"kernel {dx['outside']}, fp32 control {dx['fp32_outside']} of {dx['count']} "
              f"(allowed {allowed:.1f}); de kernel {rows[1]['outside']}, fp32 control "
              f"{rows[1]['fp32_outside']} of {rows[1]['count']}")
        control.append(dx["fp32_outside"] > allowed)
        if hidden == 1:
            assert dx["fp32_outside"] == 0
    assert any(control) or hidden == 1


@pytest.mark.cuda
@pytest.mark.parametrize("hidden,activation", [(16, "relu"), (4, "relu"), (1, "relu"),
                                               (32, "silu"), (16, "gelu")])
def test_small_and_activation_epd_train_steps_match_plain_path(cuda_device, hidden,
                                                               activation):
    """Three train steps of a 3-block ``epd``, B=8, NK, at hidden 16 (the
    encoder folded), 4 and 1 (not folded), and with silu or gelu blocks:
    3 + 3 launches of rows 1/2 a step, the loss within the JAX suite's
    0.02 of the plain path at step 1 and within LATER_LOSS_RTOL after."""
    train = entry.cylinder_train_setup(cuda_device, nx=20, ny=16, batch=8, hidden=hidden,
                                       mp_steps=3)
    for blk in train.simulator.model.processor_list:
        blk.activation = activation
        _set_activation(blk.edge_block, activation)
        _set_activation(blk.node_block, activation)
    plain_sim = copy.deepcopy(train.simulator)
    plain_sim.model.tiling = None
    plain_state, plain_step = entry.make_trainer(plain_sim)
    gens = [torch.Generator(cuda_device).manual_seed(4) for _ in range(2)]
    for step in range(3):
        before = (fused_gn_block_nk.launches, fused_gn_block_nk.backward_launches)
        m = train.train_step(train.state, train.graph, gens[0])
        torch.cuda.synchronize()
        assert (fused_gn_block_nk.launches, fused_gn_block_nk.backward_launches) == (
            before[0] + 3, before[1] + 3)
        mp = plain_step(plain_state, train.graph, gens[1])
        assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])
        torch.testing.assert_close(m["loss"], mp["loss"], rtol=0.02 if step == 0
                                   else LATER_LOSS_RTOL, atol=0)


# ---- the world seam of rows 1-4 (extra_agg) at hidden 32, 64 and 128 ---------

SEAM_HIDDEN = [32, 64, 128]


def _seam_case(cuda_device, layout, hidden, variant, seed):
    """A block's inputs at ``hidden``: on the 16 x 16 cylinder mesh's NK
    layout with masked slots between valid ones at B=33, or on the hub CSR
    graph at B=17; random cotangents, and a dense random extra aggregate
    [N, B, H] (bf16)."""
    if layout == "nk":
        args, kw, cot_x, cot_e = _wide_nk_case(cuda_device, hidden, variant, 33, seed,
                                               holes=True)
    else:
        args, kw = _wide_hub_case(cuda_device, hidden, variant, 17, seed)
        cot_x, cot_e = _csr_cotangents(args[0], args[-1].total_rows, 500 + seed)
    gen = torch.Generator(device=cuda_device).manual_seed(600 + seed)
    extra = (0.3 * torch.randn(args[0].shape, generator=gen, device=cuda_device)).bfloat16()
    return args, kw, cot_x, cot_e, extra


def _seam_ops(layout):
    return ((fused_gn_block_nk, fused_gn_block_nk_reference) if layout == "nk"
            else (fused_gn_block_csr, fused_gn_block_csr_reference))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["middle", "last"])
@pytest.mark.parametrize("hidden", SEAM_HIDDEN)
@pytest.mark.parametrize("layout", ["nk", "csr"])
def test_gn_world_seam_forward_matches_plain_version(cuda_device, layout, hidden, variant):
    """Rows 1 and 3 with ``extra_agg``: x_out and e_out within the JAX
    suite's 0.05 of the plain version, one launch; the extra moves x_out."""
    args, kw, _, _, extra = _seam_case(cuda_device, layout, hidden, variant, seed=1)
    fn, plain = _seam_ops(layout)
    with torch.no_grad():
        before = fn.launches
        kx, ke = fn(*args, **kw, extra_agg=extra)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        px, pe = plain(*args, **kw, extra_agg=extra, compute_dtype=torch.bfloat16)
        mesh_only = fn(*args, **kw)[0]
    torch.testing.assert_close(kx.float(), px.float(), rtol=0.05, atol=0.05)
    if variant == "last":
        assert ke is args[1]
    else:
        torch.testing.assert_close(ke.float(), pe.float(), rtol=0.05, atol=0.05)
    assert not torch.equal(kx, mesh_only)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["folded", "middle"])
@pytest.mark.parametrize("hidden", SEAM_HIDDEN)
@pytest.mark.parametrize("layout", ["nk", "csr"])
def test_gn_world_seam_backward_matches_plain_version(cuda_device, layout, hidden, variant):
    """Rows 2 and 4 with ``extra_agg``: dx, de, dea (the extra aggregate's
    cotangent) and the weight gradients against the plain backward and
    fp32 autograd, at utils/gradcheck.py's bounds; one backward launch."""
    args, kw, cot_x, cot_e, extra = _seam_case(cuda_device, layout, hidden, variant, seed=2)
    fn, _ = _seam_ops(layout)
    lead = 4 if layout == "nk" else 5
    before = fn.backward_launches
    rows, ok, _ = gradcheck.check_block_backward(
        args[0], args[1], args[2:lead], (kw["encoder_params"], *args[lead:lead + 2]), args[-1],
        kw["last_block"], cot_x, cot_e, extra=extra)
    torch.cuda.synchronize()
    assert fn.backward_launches == before + 1
    assert any(r["name"] == "dea" for r in rows)
    assert ok, [r for r in rows if not r["ok"]]


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", SEAM_HIDDEN)
@pytest.mark.parametrize("layout", ["nk", "csr"])
def test_gn_zero_extra_agg_gives_the_bits_of_none(cuda_device, layout, hidden):
    """agg + 0 rounds to agg: with a zero ``extra_agg`` the kernels give the
    outputs, dx, de and every weight gradient of a call without one, and
    a dea equal to the aggregate's cotangent, the same on two calls."""
    args, kw, cot_x, cot_e, extra = _seam_case(cuda_device, layout, hidden, "middle", seed=3)
    fn, _ = _seam_ops(layout)
    lead = 4 if layout == "nk" else 5
    params = [p for m in args[lead:lead + 2] for p in nk_ops._mlp_params(m)]
    runs = []
    for xa in (None, torch.zeros_like(extra), torch.zeros_like(extra)):
        xl = args[0].clone().requires_grad_(True)
        el = args[1].clone().requires_grad_(True)
        leaves = [xl, el] + ([] if xa is None else [xa.requires_grad_(True)])
        xo, eo = fn(xl, el, *args[2:], **kw, extra_agg=xa)
        grads = torch.autograd.grad([xo, eo], leaves + params, [cot_x, cot_e])
        runs.append([xo.detach(), eo.detach(), *grads])
    torch.cuda.synchronize()
    none, zero, again = runs
    dea = zero.pop(4)
    assert torch.equal(dea, again.pop(4)) and torch.isfinite(dea).all()
    assert dea.abs().max() > 0
    for a, b, c in zip(none, zero, again):
        assert torch.equal(a, b) and torch.equal(b, c)


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", [32, 128])
def test_plate_epd_train_step_goes_through_the_seam_and_matches_plain_path(cuda_device,
                                                                            hidden):
    """DeformingPlate's MeshGraphNet, 3 blocks, B=4 on a 14x10 plate whose
    frames all have world edges: 3 + 3 launches of rows 1/2 a step, the
    loss within the JAX suite's 0.02 of the plain path."""
    train = entry.plate_epd_train_setup(cuda_device, nx=14, ny=10, batch=4, radius=0.12,
                                        edge_budget=64, mp_steps=3, hidden=hidden)
    assert train.graph.wedge_mask.any(0).all()
    fn = fused_gn_block_nk if isinstance(train.tiling, NKTiling) else fused_gn_block_csr
    plain_sim = copy.deepcopy(train.simulator)
    plain_sim.model.tiling = None
    plain_state, plain_step = entry.make_trainer(plain_sim, train.device_preprocess)
    before = (fn.launches, fn.backward_launches)
    m = train.train_step(train.state, train.graph, torch.Generator(cuda_device).manual_seed(3))
    torch.cuda.synchronize()
    assert (fn.launches, fn.backward_launches) == (before[0] + 3, before[1] + 3)
    mp = plain_step(plain_state, train.graph, torch.Generator(cuda_device).manual_seed(3))
    assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])
    torch.testing.assert_close(m["loss"], mp["loss"], rtol=0.02, atol=0)


#: chip_smoke.py phase 39 compares DeformingPlate's MeshGraphNet on the
#: kernel path with the plain path over its first PLATE_EPD_COMPARED_STEPS
#: steps, held to LATER_LOSS_RTOL (named as there)
PLATE_EPD_COMPARED_STEPS = 7


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["default", "deterministic"])
def test_plate_epd_plain_training_repeats_itself_over_the_compared_steps(cuda_device, mode):
    """Phase 39's plate ``epd`` (hidden 128, 15 blocks, B=64, world edges in
    every sample) on the plain path: a second run from the same weights and
    noise gives the same losses bit for bit over all 20 steps, in
    PyTorch's default mode as under deterministic algorithms (the world
    scatter, the segment sums and the gathers' gradients add in a fixed
    order, ops/segment.py); a run from the weights scaled by 1 + 2^-16
    agrees within LATER_LOSS_RTOL over the first PLATE_EPD_COMPARED_STEPS
    steps. Prints each of 20 steps' relative differences (PERF.md §6
    cites them)."""
    train = entry.plate_epd_train_setup(cuda_device)
    losses = []
    for scale in (1.0, 1.0, 1.0 + 2.0 ** -16):
        sim = copy.deepcopy(train.simulator)
        sim.model.tiling = None
        with torch.no_grad():
            for p in sim.parameters():
                p.mul_(scale)
        state, step = entry.make_trainer(sim, train.device_preprocess)
        gen = torch.Generator(cuda_device).manual_seed(39)
        if mode == "deterministic":
            with gradcheck.deterministic():
                losses.append([step(state, train.graph, gen)["loss"].item() for _ in range(20)])
        else:
            losses.append([step(state, train.graph, gen)["loss"].item() for _ in range(20)])
        del sim, state, step
        torch.cuda.empty_cache()
    rel = {name: [abs(a - b) / abs(b) for a, b in zip(run, losses[0])]
           for name, run in (("again", losses[1]), ("nudged", losses[2]))}
    for name, r in rel.items():
        print(f"plate epd plain path ({mode} mode) against itself {name}, relative loss "
              "difference by step: " + " ".join(f"{v:.3g}" for v in r))
    assert all(np.isfinite(losses).ravel())
    assert max(rel["nudged"][:PLATE_EPD_COMPARED_STEPS]) <= LATER_LOSS_RTOL, rel
    assert losses[1] == losses[0], rel


@pytest.mark.cuda
@pytest.mark.parametrize("batched", [False, True])
def test_radius_edges_on_the_card_match_the_cpu(cuda_device, batched):
    """ops/knn.radius_edges on the card against the CPU on a regular grid of
    exactly representable positions (equal distances everywhere, the cap
    and the budget binding): the same index arrays; and on random
    positions (2,000 points, 3 samples when batched) the same pairs, apart
    from pairs within 1e-6 of r² (none are expected, and any is printed)."""
    from graph_physics_tpu_torch.ops.knn import radius_edges

    g = np.stack(np.meshgrid(np.arange(12), np.arange(10), indexing="ij"), -1).reshape(-1, 2)
    grid = np.concatenate([g * 0.125, np.zeros((len(g), 1))], 1).astype(np.float32)
    rng = np.random.default_rng(0)
    ma = rng.random(len(grid)) < 0.3
    for radius, budget, k in ((0.2, 64, 4), (0.3, 1000, 16), (0.26, 37, 3)):
        args = [torch.tensor(grid), torch.tensor(grid), radius, budget]
        kw = dict(mask_a=torch.tensor(ma), mask_b=torch.tensor(~ma), k_per_node=k,
                  with_stats=True)
        want = radius_edges(*args, **kw)
        got = radius_edges(*[a.to(cuda_device) if torch.is_tensor(a) else a for a in args],
                           **{k_: v.to(cuda_device) if torch.is_tensor(v) else v
                              for k_, v in kw.items()})
        for w, c in zip(want, got):
            assert torch.equal(c.cpu(), w)
    shape = (3, 2000, 3) if batched else (2000, 3)
    pos = torch.tensor(rng.uniform(0, 4.0, shape).astype(np.float32))
    mask = torch.tensor(rng.random(shape[:-1]) < 0.1)
    want = radius_edges(pos, pos, 0.25, 2048, mask_a=mask, mask_b=~mask)
    got = [t.cpu() for t in radius_edges(pos.to(cuda_device), pos.to(cuda_device), 0.25, 2048,
                                         mask_a=mask.to(cuda_device),
                                         mask_b=(~mask).to(cuda_device))]
    if not batched:
        want, got = [t[None] for t in want], [t[None] for t in got]
        pos = pos[None]
    for b in range(pos.shape[0]):
        sets = [set(zip(a[b][v[b]].tolist(), c[b][v[b]].tolist())) for a, c, v in (want, got)]
        diff = sets[0] ^ sets[1]
        p = pos[b].double()
        off = [(i, j) for i, j in diff
               if abs(float(((p[i] - p[j]) ** 2).sum()) - 0.0625) > 1e-6 * 0.0625]
        print(f"radius_edges card vs CPU, sample {b}: {len(sets[0])} pairs, {len(diff)} differ, "
              f"{len(off)} off the radius")
        assert sets[0] and not off


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["transformer", "epd"])
def test_dynamic_sidecar_rollout_kernel_path_matches_plain_path(cuda_device, model):
    """DeformingPlate rolled out with its world edges found again at every
    step (entry.plate_rollout_setup: 3 trajectories of a 14x10 plate,
    radius 0.12, 128 sidecar slots, 2 blocks): the kernel path (rows 5 and
    9, or row 1 with the world aggregate) launches once a block a step, and
    its RMSE is within 0.15 of the plain path's (PERF.md §2)."""
    from graph_physics_tpu_torch.training.rollout import make_batched_rollout_fn

    setup = entry.plate_rollout_setup(cuda_device, model=model, trajectories=3, steps=8,
                                      nx=14, ny=10, radius=0.12, edge_budget=128, mp_steps=2,
                                      hidden=32 if model == "epd" else 64)
    fn = (fused_edge_attention_nk if model == "transformer" else fused_gn_block_nk) \
        if isinstance(setup.tiling, NKTiling) else \
        (fused_edge_attention_csr if model == "transformer" else fused_gn_block_csr)
    before = fn.launches
    res = make_batched_rollout_fn(setup.simulator, **setup.rollout_kw)(setup.frames)
    torch.cuda.synchronize()
    assert fn.launches == before + 2 * 8
    plain = copy.deepcopy(setup.simulator)
    plain.model.tiling = None
    res_plain = make_batched_rollout_fn(plain, **setup.rollout_kw)(setup.frames)
    assert torch.isfinite(res.predictions).all()
    torch.testing.assert_close(res.rmse_all_rollout, res_plain.rmse_all_rollout, rtol=0.15,
                               atol=0)


@pytest.mark.cuda
def test_aneurysm_rollout_with_previous_data_kernel_path_matches_plain_path(cuda_device):
    """coarse-aneurysm.json's transformer (2 blocks) rolled out on a 12x10
    synthetic aneurysm with the acceleration columns carried
    (entry.aneurysm_rollout_setup): the attention and FFN kernels launch
    once a block a step, and the RMSE is within 0.15 of the plain path's."""
    from graph_physics_tpu_torch.training.rollout import make_batched_rollout_fn

    setup = entry.aneurysm_rollout_setup(cuda_device, trajectories=3, steps=6, nx=12, ny=10,
                                         mp_steps=2)
    assert setup.rollout_kw["previous_data_slice"] == (6, 9)
    attn = (fused_edge_attention_nk if isinstance(setup.tiling, NKTiling)
            else fused_edge_attention_csr)
    before = (attn.launches, fused_gated_ffn.launches)
    res = make_batched_rollout_fn(setup.simulator, **setup.rollout_kw)(setup.frames)
    torch.cuda.synchronize()
    assert (attn.launches, fused_gated_ffn.launches) == (before[0] + 12, before[1] + 12)
    plain = copy.deepcopy(setup.simulator)
    plain.model.tiling = None
    res_plain = make_batched_rollout_fn(plain, **setup.rollout_kw)(setup.frames)
    assert torch.isfinite(res.predictions).all()
    torch.testing.assert_close(res.rmse_all_rollout, res_plain.rmse_all_rollout, rtol=0.15,
                               atol=0)


# ---- the transformer's gates at widths JAX does not fuse --------------------

def _train_step_launches(train):
    """One train step of ``train`` (an entry train setup): the (forward,
    backward) launches of both attention wrappers and of the FFN's, and
    the loss."""
    kernels = (fused_edge_attention_nk, fused_edge_attention_csr, fused_gated_ffn)
    before = [(k.launches, k.backward_launches) for k in kernels]
    m = train.train_step(train.state, train.graph, torch.Generator(train.graph.x.device)
                         .manual_seed(3))
    torch.cuda.synchronize()
    return [(k.launches - f, k.backward_launches - b)
            for k, (f, b) in zip(kernels, before)], m["loss"]


@pytest.mark.cuda
def test_hidden_256_trains_with_the_attention_kernels_and_the_plain_ffn(cuda_device):
    """Hidden 256 with 8 heads (head width 32): JAX fuses the attention and
    not the FFN (its gate: hidden dividing 128), so rows 5/6 launch once
    a block and rows 9/10 never; nothing raises."""
    train = entry.transformer_train_setup(cuda_device, nx=20, ny=16, batch=4, hidden=256,
                                          heads=8, mp_steps=2)
    launches, loss = _train_step_launches(train)
    assert launches == [(2, 2), (0, 0), (0, 0)] and torch.isfinite(loss)


@pytest.mark.cuda
def test_head_width_24_trains_on_the_plain_path(cuda_device):
    """Hidden 96 with 4 heads (head width 24, which does not divide 128):
    neither kernel family launches, and nothing raises."""
    train = entry.transformer_train_setup(cuda_device, nx=20, ny=16, batch=4, hidden=96,
                                          heads=4, mp_steps=2)
    launches, loss = _train_step_launches(train)
    assert launches == [(0, 0), (0, 0), (0, 0)] and torch.isfinite(loss)


@pytest.mark.cuda
@pytest.mark.parametrize("hidden,heads", [(32, 4), (16, 4), (8, 4), (4, 4), (2, 2), (1, 1),
                                          (128, 2), (128, 1)])
def test_transformer_trains_through_both_kernels_at_every_fused_width(cuda_device, hidden,
                                                                      heads):
    """Every hidden width and head width JAX's gates fuse that had no
    instance before: head widths 8, 4, 2, 1, 64 and 128 and hidden 32 to
    1. A 2-block train step launches rows 5/6 and 9/10 once a block each,
    and its loss is the plain path's within 0.02 (the step-1 bound)."""
    train = entry.transformer_train_setup(cuda_device, nx=20, ny=16, batch=4, hidden=hidden,
                                          heads=heads, mp_steps=2)
    plain_sim = copy.deepcopy(train.simulator)
    plain_sim.model.tiling = None
    plain_state, plain_step = entry.make_trainer(plain_sim)
    launches, loss = _train_step_launches(train)
    assert launches == [(2, 2), (0, 0), (2, 2)] and torch.isfinite(loss)
    mp = plain_step(plain_state, train.graph, torch.Generator(cuda_device).manual_seed(3))
    torch.testing.assert_close(loss, mp["loss"], rtol=0.02, atol=0)


# ---- the host mesh library and sub-mesh partitions ---------------------------

@pytest.mark.cuda
def test_host_mesh_library_builds_and_matches_its_plain_versions(cuda_device):
    """On the card's machine: csrc/meshops.cc builds with g++ and each of
    its functions gives its plain version's arrays on a 40x30 grid."""
    from graph_physics_tpu_torch import native
    from graph_physics_tpu_torch.dataset import synthetic

    traj = synthetic.make_trajectory(40, 30, 5)
    pos, cells = traj["mesh_pos"][0], traj["cells"][0]
    n = len(pos)
    assert native.build().exists()
    ei = native.faces_to_edges(cells, n)
    np.testing.assert_array_equal(ei, native.faces_to_edges_plain(cells, n))
    np.testing.assert_array_equal(native.k_hop(ei, n, 2), native.k_hop_plain(ei, n, 2))
    pairs = native.radius_pairs(pos, 0.05)
    np.testing.assert_array_equal(pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))],
                                  native.radius_pairs_plain(pos, 0.05))
    for parts in (3, 4, 7):
        np.testing.assert_array_equal(native.rcb_labels(pos, parts),
                                      native.rcb_labels_plain(pos, parts))
    vals = [traj["velocity"][i] for i in range(4)]
    np.testing.assert_array_equal(native.pack_rows(vals), native.pack_rows_plain(vals))
    np.testing.assert_array_equal(native.repeat_rows(vals[0], 8),
                                  native.repeat_rows_plain(vals[0], 8))


@pytest.mark.cuda
def test_partitioned_batch_trains_through_the_kernels(cuda_device):
    """A B=4 batch of one RCB part (3 parts of a 40x30 grid) laid out by
    FusedTopologyManager: the epd train step (hidden 32, 3 blocks) launches
    rows 1/2 (3/4 on CSR) once a block and its loss is the plain path's
    within 0.02 (the step-1 bound)."""
    from graph_physics_tpu_torch.dataset import synthetic
    from graph_physics_tpu_torch.dataset.base import BaseDataset
    from graph_physics_tpu_torch.dataset.loader import BatchLoader
    from graph_physics_tpu_torch.dataset.preprocessing import FrameConfig
    from graph_physics_tpu_torch.training.fused import FusedTopologyManager

    class Memory(BaseDataset):
        def __init__(self, traj):
            super().__init__(FrameConfig(targets=("velocity",)), synthetic.meta_dict(5),
                             num_partitions=3)
            self._traj, self._traj_len = traj, [5]
            self._setup_index()

        num_trajectories = 1

        def _trajectory(self, t):
            return self._traj

    ds = Memory(synthetic.make_trajectory(40, 30, 5))
    mgr = FusedTopologyManager("epd")
    loader = BatchLoader(ds, 4, seed=0, packed=True, device=cuda_device,
                         frame_transform=mgr.transform_frame,
                         packed_transform=mgr.transform_packed)
    batch = next(iter(loader))
    assert int(batch.n_node) < 1200 // 3 + 1
    sim = entry.make_simulator(32, 3, torch.bfloat16, batch.layout, 0).to(cuda_device)
    plain = copy.deepcopy(sim)
    plain.model.tiling = None
    kernel = fused_gn_block_nk if isinstance(batch.layout, NKTiling) else fused_gn_block_csr
    state, step = entry.make_trainer(sim)
    plain_state, plain_step = entry.make_trainer(plain)
    before = (kernel.launches, kernel.backward_launches)
    m = step(state, batch, torch.Generator(cuda_device).manual_seed(4))
    torch.cuda.synchronize()
    assert (kernel.launches, kernel.backward_launches) == (before[0] + 3, before[1] + 3)
    mp = plain_step(plain_state, batch, torch.Generator(cuda_device).manual_seed(4))
    assert torch.isfinite(m["loss"])
    torch.testing.assert_close(m["loss"], mp["loss"], rtol=0.02, atol=0)


@pytest.mark.cuda
def test_queued_device_time_stands_in_for_an_empty_profiler(cuda_device, monkeypatch):
    """chip_smoke.py's stand-in for a profiler that records no launch:
    CUDA events around calls queued behind a sleeping kernel read the
    device time of the calls' kernels, not the host's gaps between them,
    and the timing helpers take it where every session came back empty."""
    import chip_smoke

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    a = torch.randn(4096, 4096, device=cuda_device, dtype=torch.bfloat16, generator=gen)
    product = lambda: a @ a  # noqa: E731 (the load timed, not a port path)
    profiled = chip_smoke.device_ms(product, reps=20)
    assert chip_smoke.queued_device_ms(product, 20) == pytest.approx(profiled, rel=0.1)
    small = a[:64, :64]
    many = lambda: [small + 1.0 for _ in range(50)]  # noqa: E731 (host-bound calls)
    assert chip_smoke.queued_device_ms(many, 5) < chip_smoke.cuda_ms(many)
    monkeypatch.setattr(chip_smoke, "_profile_session", lambda fn, reps: ({}, {}))
    times = chip_smoke.device_times(product, reps=20)
    assert list(times) == [chip_smoke.QUEUED_KERNELS]
    assert times[chip_smoke.QUEUED_KERNELS] == pytest.approx(profiled, rel=0.1)
    assert list(chip_smoke.pass_split(product)) == ["other"]
