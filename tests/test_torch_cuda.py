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
GraphNetBlock backward is also held on a mesh whose masked slots sit
between a receiver's valid ones and whose node N-1 owns valid slots; it
and the gated-FFN backward
(also at a row count that is not a multiple of its 64-row tile) give the
same bits on two calls. The gumbel
kernel draws the same Philox bits as its plain version, bit for bit, and
its output is within 1e-5 of the plain version's (``logf`` on the card
against ``torch.log``, at |noise| < 17); the Transolver train step runs
it once per block forward and never in the backward, and keeps to the
``epd`` step's bounds against the plain path on the same bits.
"""

import copy

import pytest
import torch

from graph_physics_tpu_torch import entry
from graph_physics_tpu_torch.models.layers import MLP, GatedMLPBlock, RMSNorm, reset_parameters
from graph_physics_tpu_torch.ops.edge_attention import edge_attention
from graph_physics_tpu_torch.ops import fused_edge_attention_csr as ea_csr_ops
from graph_physics_tpu_torch.ops import fused_edge_attention_nk as ea_ops
from graph_physics_tpu_torch.ops import fused_ffn as ffn_ops
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
from graph_physics_tpu_torch.utils import gradcheck


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda")


def _block_args(setup, variant, seed):
    model, graph, nk = setup.simulator.model, setup.graph, setup.tiling
    n, b = graph.x.shape[:2]
    gen = torch.Generator(device=graph.x.device).manual_seed(seed)
    width = entry.EDGE_INPUT if variant == "folded" else model.hidden_size

    def randn(*shape):
        return (0.5 * torch.randn(shape, generator=gen, device=graph.x.device)).to(torch.bfloat16)

    block = {"folded": 0, "middle": 1, "last": -1}[variant]
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

@pytest.mark.cuda
@pytest.mark.parametrize("batch", [4, 33])
def test_attention_kernel_matches_plain_version(cuda_device, batch):
    setup = entry.transformer_setup(cuda_device, nx=20, ny=16, batch=batch, mp_steps=2)
    g, nk = setup.graph, setup.tiling
    gen = torch.Generator(device=cuda_device).manual_seed(batch)
    q, k, v = [(0.5 * torch.randn((nk.num_nodes, batch, 4, 16), generator=gen,
                                  device=cuda_device)).to(torch.bfloat16) for _ in range(3)]
    mask = g.edge_mask.clone().view(nk.num_groups, nk.k_slots, nk.node_block)
    mask[:, :, :3] = False  # three receivers per node block with no valid slot
    for m in (g.edge_mask, mask.reshape(-1).contiguous()):
        before = fused_edge_attention_nk.launches
        out = fused_edge_attention_nk(q, k, v, g.senders, m, nk)
        torch.cuda.synchronize()
        assert fused_edge_attention_nk.launches == before + 1
        ref = fused_edge_attention_nk_reference(q, k, v, g.senders, m, nk)
        torch.testing.assert_close(out.float(), ref.float(), rtol=0.03, atol=0.02)
    empty = out.view(nk.num_groups, nk.node_block, -1)[:, :3]
    assert torch.equal(empty, torch.zeros_like(empty))


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

def _attention_case(cuda_device, batch, seed):
    """The slot arrays, NK layout and random q, k, v and cotangent on the
    48x40 mesh (the transformer slice's shape)."""
    setup = entry.transformer_setup(cuda_device, batch=batch, mp_steps=1)
    g, nk = setup.graph, setup.tiling
    gen = torch.Generator(device=cuda_device).manual_seed(seed)
    q, k, v, cot = [(s * torch.randn((nk.num_nodes, batch, 4, 16), generator=gen,
                                     device=cuda_device)).to(torch.bfloat16)
                    for s in (0.5, 0.5, 0.5, 1.0)]
    return g, nk, (q, k, v), cot


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [4, 64])
def test_attention_backward_kernel_matches_plain_backward(cuda_device, batch):
    """Bounds and their reasons: graph_physics_tpu_torch/utils/gradcheck.py."""
    g, nk, qkv, cot = _attention_case(cuda_device, batch, seed=batch)
    mask = g.edge_mask.clone().view(nk.num_groups, nk.k_slots, nk.node_block)
    mask[:, :, :3] = False  # three receivers per node block with no valid slot
    for m in (g.edge_mask, mask.reshape(-1).contiguous()):
        def attention(fn):
            return lambda *t: (fn(*t, g.senders, m, nk), [])

        before = fused_edge_attention_nk.backward_launches
        names = ("dq", "dk", "dv")
        rows, ok, _ = gradcheck.check_backward(
            names, names, attention(fused_edge_attention_nk),
            attention(ea_ops.reference_with_backward),
            attention(fused_edge_attention_nk_reference), qkv, [cot])
        torch.cuda.synchronize()
        assert fused_edge_attention_nk.backward_launches == before + 1
        assert ok, [r for r in rows if not r["ok"]]
    leaves = [t.clone().requires_grad_(True) for t in qkv]
    dq, _, _ = torch.autograd.grad(fused_edge_attention_nk(*leaves, g.senders, m, nk), leaves, cot)
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


def _ffn_case(cuda_device, nodes, batch, use_silu, seed):
    gen = torch.Generator().manual_seed(seed)
    block = GatedMLPBlock(64, 64, 64, use_silu=use_silu)
    norm2 = RMSNorm(64)
    reset_parameters(block, gen)
    with torch.no_grad():
        for norm in (block.norm, norm2):
            norm.scale.copy_(1.0 + 0.2 * torch.randn(64, generator=gen))
    block, norm2 = block.to(cuda_device), norm2.to(cuda_device)
    x, cot = [torch.randn((nodes, batch, 64), generator=gen).to(cuda_device, torch.bfloat16)
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
def test_transformer_kernels_refuse_what_they_lack_under_autograd(cuda_device):
    setup = entry.transformer_setup(cuda_device, nx=20, ny=16, batch=2, mp_steps=1)
    g, nk = setup.graph, setup.tiling
    q = torch.zeros((nk.num_nodes, 2, 4, 8), dtype=torch.bfloat16, device=cuda_device,
                    requires_grad=True)  # head width 8: no kernel instance
    with pytest.raises(NotImplementedError):
        fused_edge_attention_nk(q, q, q, g.senders, g.edge_mask, nk)
    block, norm2 = GatedMLPBlock(32, 32, 32).to(cuda_device), RMSNorm(32).to(cuda_device)
    x = torch.zeros((64, 2, 32), dtype=torch.bfloat16, device=cuda_device, requires_grad=True)
    with pytest.raises(NotImplementedError):  # hidden 32: no kernel
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

    blk = model.processor_list[{"folded": 0, "middle": 1, "last": -1}[variant]]
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
@pytest.mark.parametrize("batch", [2, 33])
def test_csr_attention_kernel_matches_plain_version(cuda_device, batch):
    setup = entry.graded_transformer_setup(cuda_device, num_nodes=1500, batch=batch,
                                           mp_steps=2)
    g, csr = setup.graph, setup.tiling
    gen = torch.Generator(device=cuda_device).manual_seed(batch)
    q, k, v = [(0.5 * torch.randn((csr.num_nodes, batch, 4, 16), generator=gen,
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


@pytest.mark.cuda
def test_csr_kernels_raise_under_autograd(cuda_device):
    """Under autograd the CSR kernels raise outside their backward's scope
    (MLPs of other depths, head widths without an instance), and never
    take the plain version."""
    setup = entry.graded_setup(cuda_device, num_nodes=1536, batch=2, mp_steps=2)
    args, kw = _graded_block_args(setup, "middle", seed=0)
    shallow = MLP(3 * 32, 32, 32, 3).to(cuda_device)  # 3 Dense layers: no backward kernel
    before = fused_gn_block_csr.launches
    with pytest.raises(NotImplementedError, match="Dense layers"):
        fused_gn_block_csr(*args[:5], shallow, *args[6:], **kw)
    assert fused_gn_block_csr.launches == before
    g, csr = setup.graph, setup.tiling
    q = torch.zeros((csr.num_nodes, 2, 4, 8), dtype=torch.bfloat16, device=cuda_device,
                    requires_grad=True)  # head width 8: no kernel instance
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


@pytest.mark.cuda
@pytest.mark.parametrize("num_nodes,batch", [(1500, 2), (1500, 33), (27_000, 16)])
def test_csr_attention_backward_kernel_matches_plain_backward(cuda_device, num_nodes, batch):
    """Against autograd of edge_attention and fp32 autograd (bounds:
    utils/gradcheck.py); dq exactly 0 where a receiver has no valid row,
    and dk, dv exactly 0 on nodes that send on none (the padding nodes)."""
    setup = entry.graded_transformer_setup(cuda_device, num_nodes=num_nodes, batch=batch,
                                           mp_steps=1)
    g, csr = setup.graph, setup.tiling
    gen = torch.Generator(device=cuda_device).manual_seed(batch)
    *qkv, cot = [(s * torch.randn((csr.num_nodes, batch, 4, 16), generator=gen,
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
