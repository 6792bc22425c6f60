"""The port's gated MLP and gated-FFN kernel wrapper against the JAX package.

  * ``GatedMLP`` and ``GatedMLPBlock`` match flax in fp32 to 1e-5, with the
    exact GELU and with SiLU;
  * the plain version ``gated_ffn_reference`` in fp32 matches the flax
    composition x + GatedMLPBlock(RMSNorm(x)) to 1e-5;
  * on CPU tensors ``fused_gated_ffn`` (the plain version) matches the
    Pallas kernel with ``norm2_scale`` in interpret mode at rtol = atol =
    0.05 (tests/test_fused_ffn.py:27-30), GELU and SiLU, and counts no
    launch.
The CUDA kernel itself is tested on a card by tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_physics_tpu.models import layers as jlayers
from graph_physics_tpu.ops.fused_ffn import fused_gated_ffn as j_fused_ffn
from graph_physics_tpu_torch.models import layers as tlayers
from graph_physics_tpu_torch.ops.fused_ffn import fused_gated_ffn, gated_ffn_reference
from graph_physics_tpu_torch.utils.convert import load_dense, load_gated_mlp

H, N, B = 64, 256, 2
TOL = dict(rtol=1e-5, atol=1e-5)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _flax_block(use_silu=False, seed=0, dtype=jnp.float32):
    """A flax GatedMLPBlock, its params (biases and scale made non-trivial)
    and the port block loaded from them."""
    mod = jlayers.GatedMLPBlock(in_size=H, hidden_size=H, out_size=H, use_silu=use_silu,
                                dtype=dtype)
    params = _np_tree(mod.init(jax.random.PRNGKey(seed), jnp.zeros((1, H)))["params"])
    rng = np.random.default_rng(seed)
    params = jax.tree.map(lambda a: a + 0.1 * rng.normal(size=a.shape).astype(np.float32), params)
    block = tlayers.GatedMLPBlock(H, H, H, use_silu=use_silu,
                                  dtype=torch.float32 if dtype == jnp.float32 else torch.bfloat16)
    load_gated_mlp(block, params)
    return mod, params, block


def _x(seed=0, lead=(N, B)):
    return (0.5 * np.random.default_rng(seed).normal(size=lead + (H,))).astype(np.float32)


@pytest.mark.parametrize("use_silu", [False, True])
def test_gated_mlp_matches_flax(use_silu):
    rng = np.random.default_rng(1)
    mod = jlayers.GatedMLP(hidden_size=H, use_silu=use_silu)
    params = _np_tree(mod.init(jax.random.PRNGKey(1), jnp.zeros((1, H)))["params"])
    x = rng.normal(size=(40, 3, H)).astype(np.float32)
    want = mod.apply({"params": params}, jnp.asarray(x))
    port = tlayers.GatedMLP(H, H, use_silu=use_silu)
    load_dense(port.linear1, params["Dense_0"])
    load_dense(port.linear2, params["Dense_1"])
    np.testing.assert_allclose(port(torch.as_tensor(x)).detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("use_silu", [False, True])
def test_gated_mlp_block_matches_flax(use_silu):
    mod, params, block = _flax_block(use_silu, seed=2)
    x = _x(seed=3, lead=(50,))
    want = mod.apply({"params": params}, jnp.asarray(x))
    np.testing.assert_allclose(block(torch.as_tensor(x)).detach().numpy(), np.asarray(want),
                               **TOL)
    assert sorted(block.state_dict()) == [
        "0.scale", "1.linear1.bias", "1.linear1.weight", "1.linear2.bias", "1.linear2.weight",
        "2.bias", "2.weight"]


def _norm2(seed=4):
    scale = (1.0 + 0.2 * np.random.default_rng(seed).normal(size=H)).astype(np.float32)
    norm = tlayers.RMSNorm(H)
    with torch.no_grad():
        norm.scale.copy_(torch.as_tensor(scale))
    return scale, norm


def test_reference_fp32_matches_flax_composition():
    mod, params, block = _flax_block(seed=5)
    scale, norm2 = _norm2()
    x = _x(seed=6)
    jn = jlayers.RMSNorm(H).apply({"params": {"scale": jnp.asarray(scale)}}, jnp.asarray(x))
    want = jnp.asarray(x) + mod.apply({"params": params}, jn)
    with torch.no_grad():
        got = gated_ffn_reference(torch.as_tensor(x), block, norm2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("use_silu", [False, True])
def test_wrapper_on_cpu_matches_pallas_interpret(use_silu):
    _, params, block = _flax_block(use_silu, seed=7, dtype=jnp.bfloat16)
    scale, norm2 = _norm2(seed=8)
    x = _x(seed=9)
    want = j_fused_ffn(jnp.asarray(x, jnp.bfloat16), params,
                       activation="silu" if use_silu else "gelu", interpret=True,
                       norm2_scale=jnp.asarray(scale))
    before = fused_gated_ffn.launches
    with torch.no_grad():
        got = fused_gated_ffn(torch.as_tensor(x).to(torch.bfloat16), block, norm2)
    assert fused_gated_ffn.launches == before  # CPU tensors: plain version, no launch
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=0.05, atol=0.05)


def test_wrapper_checks_inputs():
    _, _, block = _flax_block()
    _, norm2 = _norm2()
    x = torch.as_tensor(_x())
    with pytest.raises(ValueError, match="bf16"):
        fused_gated_ffn(x, block, norm2)
    with pytest.raises(ValueError, match="contiguous"):
        fused_gated_ffn(x.to(torch.bfloat16).transpose(0, 1), block, norm2)
