"""The port's CUDA kernel against its plain PyTorch version, on a card.

Imports no jax (the card's machine has none), so it runs there with

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Every test needs a card and skips without one. Tolerances are the JAX
suite's: rtol = atol = 0.05 kernel vs plain version, 0.15 for the whole
model against the plain edge-list path (tests/test_fused_gnblock_nk.py).
"""

import copy

import pytest
import torch

from graph_physics_tpu_torch import entry
from graph_physics_tpu_torch.ops.fused_gnblock_nk import (
    fused_gn_block_nk,
    fused_gn_block_nk_reference,
)


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
def test_kernel_refuses_autograd(cuda_device):
    setup = entry.cylinder_setup(cuda_device, nx=20, ny=16, batch=4)
    args, kw = _block_args(setup, "middle", seed=0)
    with pytest.raises(NotImplementedError, match="backward"):
        fused_gn_block_nk(*args, **kw)  # parameters require grad, grad mode on


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
