"""SiLU on bf16 as the JAX package computes it, and rows 1-4 with silu or
exact-gelu MLPs, against the JAX package on the CPU.

  * ``ops/activation.silu`` equals ``jax.nn.silu`` on bf16, and
    ``silu_grad`` equals the Pallas kernels' ``_act_grad("silu", ·)``, bit
    for bit on 100,000 bf16 values (XLA rounds each step of the sigmoid
    chain to bf16; ``F.silu`` rounds once and differs on ~40% of them);
  * the GraphNetBlock plain version with silu MLPs matches the Pallas
    kernel in interpret mode within the JAX suite's 0.05 on a middle
    block at hidden 8 (seed 2) and 32 (seed 1), B·H = 128, the cases that
    ``F.silu`` left past that bound;
  * silu at hidden 16 (NK) and 1 (CSR), middle blocks: outputs and
    gradients within 0.05 of the Pallas kernels (hidden 1's Dense
    gradients before each RMSNorm tail held as tests/test_torch_gn_small.py
    holds them). Not on a folded block: JAX's kernel applies its one
    activation to the folded edge encoder too, where the port runs each
    MLP with its own (an ``epd``'s encoder is relu, as in JAX's XLA path);
  * exact gelu at hidden 32, seed 1, a middle block: the Pallas kernel in
    interpret mode and the port's bf16 plain version differ on about half
    of the output bits (the port's differ from JAX's XLA oracle,
    ``blocked_reference_nk`` in bf16, on 57 of 32,768), and x_out leaves
    the elementwise 0.05 at one value. So the outputs are held as
    utils/gradcheck.py holds a bf16 kernel to its plain version, both
    against the fp32 result: at most OUTSIDE_SHARE of the values apart
    past 0.05, each version's relative L2 and largest error against fp32
    within FP32_L2_RATIO and FP32_MAX_RATIO of the other's; the gradients
    within 0.05 of each one's largest value, the other CPU cases' bound;
  * ``GraphNetBlock(activation=...)`` builds both MLPs with it and hands
    each MLP's code to the kernels; ``check_kernel_mlps`` takes any
    activation, depths to 8 and either tail, and raises for 9 layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from graph_physics_tpu.ops.fused_gnblock import _act_grad
from graph_physics_tpu_torch.models.layers import MLP, GraphNetBlock
from graph_physics_tpu_torch.ops import fused_gnblock_nk as nk_ops
from graph_physics_tpu_torch.ops.activation import silu, silu_grad
from graph_physics_tpu_torch.ops.fused_gnblock_csr import fused_gn_block_csr
from graph_physics_tpu_torch.ops.fused_gnblock_nk import fused_gn_block_nk
from graph_physics_tpu_torch.utils.gradcheck import compare_grads
from tests.test_torch_gn_small import _port_out, case, check_against_pallas, cotangents, grads
from tests.test_torch_gn_wide import _close_to_max, _jax_pallas, _jax_reference, _port_fn


def test_bf16_silu_and_its_derivative_match_jax_bit_for_bit():
    x = (2.0 * np.random.default_rng(0).normal(size=100_000)).astype(np.float32)
    xj, xt = jnp.asarray(x, jnp.bfloat16), torch.as_tensor(x).bfloat16()
    want = np.asarray(jax.jit(jax.nn.silu)(xj).astype(jnp.float32))
    want_grad = np.asarray(jax.jit(lambda v: _act_grad("silu", v))(xj).astype(jnp.float32))
    got = silu(xt)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    np.testing.assert_array_equal(silu_grad(xt).float().numpy(), want_grad)
    assert (F.silu(xt).float().numpy() != want).mean() > 0.3  # what the chain repairs
    # autograd through it: the cotangent times the derivative, rounded to bf16
    leaf = xt.clone().requires_grad_(True)
    g = torch.ones_like(leaf)
    (dx,) = torch.autograd.grad(silu(leaf), leaf, g)
    np.testing.assert_array_equal(dx.float().numpy(), want_grad)
    # fp32 takes F.silu
    xf = torch.as_tensor(x[:1000])
    assert torch.equal(silu(xf), F.silu(xf))


@pytest.mark.parametrize("hidden,seed", [(8, 2), (32, 1)])
def test_silu_block_matches_pallas_interpret(hidden, seed):
    """The middle-block cases where ``F.silu`` left the 0.05 bound (hidden 8:
    11 values, max 0.1196; hidden 32: 1 value, max 0.0781)."""
    c = case("nk", hidden, "middle", seed=seed, activation="silu")
    tx, te = _port_out(c, fused_gn_block_nk, fused_gn_block_csr, torch.bfloat16)
    jx, je = _jax_pallas(c)(jnp.asarray(c["x"], jnp.bfloat16),
                           jnp.asarray(c["e_jax"], jnp.bfloat16), None, c["ep"], c["np_"])
    np.testing.assert_allclose(tx.float().numpy(), np.asarray(jx, np.float32), rtol=0.05,
                               atol=0.05)
    np.testing.assert_allclose(te.float().numpy(), np.asarray(je, np.float32), rtol=0.05,
                               atol=0.05)


@pytest.mark.parametrize("layout,hidden,variant", [("nk", 16, "middle"), ("csr", 1, "middle")])
def test_silu_cpu_path_matches_pallas_interpret_bf16(layout, hidden, variant):
    check_against_pallas(case(layout, hidden, variant, seed=7, activation="silu"), seed=8)


def test_gelu_block_judged_against_fp32():
    """Exact gelu at hidden 32, seed 1, a middle block, NK."""
    c = case("nk", 32, "middle", seed=1, activation="gelu")
    xb = jnp.asarray(c["x"], jnp.bfloat16)
    eb = jnp.asarray(c["e_jax"], jnp.bfloat16)
    tx, te = _port_out(c, fused_gn_block_nk, fused_gn_block_csr, torch.bfloat16)
    jx, je = _jax_pallas(c)(xb, eb, None, c["ep"], c["np_"])

    def rounded(tree):  # the weights' bf16 values, as both bf16 versions use them
        return jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32), tree)

    fx, fe = _jax_reference(c, jnp.float32)(xb.astype(jnp.float32), eb.astype(jnp.float32),
                                            None, rounded(c["ep"]), rounded(c["np_"]))
    f32 = [torch.as_tensor(np.array(a, np.float32)) for a in (tx.float(), te.float(), jx, je,
                                                                fx, fe)]
    rows, ok = compare_grads(("x_out", "e_out"), f32[:2], f32[2:4], f32[4:],
                             ("x_out", "e_out"))
    assert ok, rows
    rows, ok = compare_grads(("x_out", "e_out"), f32[2:4], f32[:2], f32[4:],
                             ("x_out", "e_out"))
    assert ok, rows
    got, want, names = grads(c, cotangents(c, seed=2), _jax_pallas(c), jnp.bfloat16,
                             _port_fn(c, fused_gn_block_nk, fused_gn_block_csr), torch.bfloat16)
    for a, w, name in zip(got, want, names):
        _close_to_max(a, w, 0.05, name)


def test_graphnetblock_activation_reaches_both_mlps_and_the_kernels():
    blk = GraphNetBlock(4, activation="gelu")
    assert blk.activation == "gelu"
    assert blk.edge_block.activation == blk.node_block.activation == "gelu"
    assert [m.name for m in blk.edge_block if hasattr(m, "name")] == ["gelu"] * 3
    default = GraphNetBlock(4)
    assert default.edge_block.activation == default.node_block.activation == "relu"
    default = GraphNetBlock(4, activation="silu")
    enc = MLP(3, 4, 4)
    args = nk_ops.mlp_args((enc, blk.edge_block, default.node_block))
    assert args[1::3] == [4, 4, 4] and args[2::3] == [0, 2, 1]
    assert nk_ops.mlp_args((None, blk.edge_block, blk.node_block))[:3] == [None, 0, 0]


@pytest.mark.parametrize("hidden", [1, 4, 16, 32, 64, 128])
def test_check_kernel_mlps_raises_only_for_depth_or_a_missing_norm(hidden):
    edge = MLP(3 * hidden, hidden, hidden, activation="silu")
    node = MLP(2 * hidden, hidden, hidden, activation="gelu")
    for backward in (False, True):
        nk_ops.check_kernel_mlps(hidden, (None, edge, node), backward, hidden)
    # a 3-layer MLP and one without its RMSNorm tail: taken since the
    # kernels take every depth to 8 and either tail; a 9-layer one raises
    shallow = MLP(3 * hidden, hidden, hidden, nb_of_layers=3)
    nk_ops.check_kernel_mlps(hidden, (None, shallow, node), True, hidden)
    bare = MLP(2 * hidden, hidden, hidden, layer_norm=False)
    nk_ops.check_kernel_mlps(hidden, (None, edge, bare), False, hidden)
    deep = MLP(3 * hidden, hidden, hidden, nb_of_layers=9)
    with pytest.raises(NotImplementedError, match="1 to 8 Dense layers"):
        nk_ops.check_kernel_mlps(hidden, (None, deep, node), True, hidden)
    with pytest.raises(NotImplementedError, match="built for hidden"):
        nk_ops.check_kernel_mlps(24, (None, edge, node), False, 24)
