"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Imports no jax (the card's machine has none), so it runs there with

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Every test needs a card and skips without one. Tolerances are the JAX
suite's: rtol = atol = 0.05 kernel vs plain version, 0.15 for the whole
model against the plain edge-list path, 0.02 on a loss
(tests/test_fused_gnblock_nk.py); the backward's bounds are
graph_physics_tpu_torch/utils/gradcheck.py's.
"""

import copy

import pytest
import torch

from graph_physics_tpu_torch import entry
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
        x, e, senders, mask, (kw["encoder_params"], edge, node), nk, kw["last_block"],
        cot_x, cot_e)
    torch.cuda.synchronize()
    assert fused_gn_block_nk.backward_launches == before + 1
    assert ok, [r for r in rows if not r["ok"]]


@pytest.mark.cuda
def test_train_step_goes_through_both_kernels_and_matches_plain_path(cuda_device):
    train = entry.cylinder_train_setup(cuda_device, nx=20, ny=16, batch=8)
    plain_sim = copy.deepcopy(train.simulator)
    plain_sim.model.edge_tiling_nk = None
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
    plain.model.edge_tiling_nk = None
    before = fused_gn_block_nk.launches
    out = sim.forward(graph, is_training=False)
    torch.cuda.synchronize()
    assert fused_gn_block_nk.launches == before + len(sim.model.processor_list)
    ref = plain.forward(graph, is_training=False)
    rows = graph.node_mask
    assert torch.isfinite(out.outputs).all()
    torch.testing.assert_close(out.net_out[rows], ref.net_out[rows], rtol=0.15, atol=0.15)
