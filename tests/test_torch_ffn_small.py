"""The gated FFN at hidden 32 and below (the widths JAX's gate fuses under
64, middles 96 down to 3) against the JAX package's Pallas kernel, on the
CPU.

  * ``fused_gated_ffn`` on CPU tensors (its plain version) matches the
    Pallas kernel with ``norm2_scale`` in interpret mode at hidden 32, 16,
    8 and 1 (B·hidden = 128, so the kernel's lanes fill) at rtol = atol =
    0.05 (tests/test_fused_ffn.py:22-30), GELU and SiLU, and counts no
    launch;
  * its plain backward ``gated_ffn_backward_reference`` matches
    ``jax.grad`` through the Pallas kernel in interpret mode at the same
    widths: dx and all eight parameter gradients within 0.04·max
    (tests/test_fused_ffn.py:100-128), but for norm2's scale at hidden 1,
    whose gradient is 0 in exact arithmetic and rounding noise in both
    packages: it is held to 0.04·max of the block norm's scale gradient;
  * through ``utils/gradcheck.check_backward`` at hidden 32: the
    ``torch.autograd`` Function with the plain pair (what runs in the
    kernels' place) against plain bf16 autograd of the forward's plain
    version, both against fp32 autograd.
The CUDA kernels (csrc/fused_ffn_small.cu, fused_ffn_small_bwd.cu) are
tested on a card by tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_physics_tpu.models import layers as jlayers
from graph_physics_tpu.ops.fused_ffn import fused_gated_ffn as j_fused_ffn
from graph_physics_tpu_torch.models import layers as tlayers
from graph_physics_tpu_torch.ops import fused_ffn as ffn_ops
from graph_physics_tpu_torch.utils import gradcheck
from graph_physics_tpu_torch.utils.convert import load_gated_mlp

N = 128
GRAD_REL = 0.04  # the JAX suite's gradient bound, |a - b| <= 0.04 · max|b|
NAMES = ("dscale2", "dscale", "dW1", "db1", "dW2", "db2", "dW3", "db3")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: these small cases gain nothing from more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _case(h, use_silu, seed):
    """A flax GatedMLPBlock's params at hidden ``h`` (the init's weights,
    biases and scales made non-trivial), the port's bf16 block and norm2
    loaded from them, and x [N, 128 / h, h]."""
    mod = jlayers.GatedMLPBlock(in_size=h, hidden_size=h, out_size=h, use_silu=use_silu,
                                dtype=jnp.bfloat16)
    params = jax.tree.map(np.asarray,
                          mod.init(jax.random.PRNGKey(seed), jnp.zeros((1, h)))["params"])
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: a + 0.1 * rng.normal(size=a.shape).astype(np.float32)
        if jax.tree_util.keystr(path).endswith(("['bias']", "['scale']")) else a, params)
    block = tlayers.GatedMLPBlock(h, h, h, use_silu=use_silu, dtype=torch.bfloat16)
    load_gated_mlp(block, params)
    scale = (1.0 + 0.2 * rng.normal(size=h)).astype(np.float32)
    norm2 = tlayers.RMSNorm(h, dtype=torch.bfloat16)
    with torch.no_grad():
        norm2.scale.copy_(torch.as_tensor(scale))
    x = (0.5 * rng.normal(size=(N, 128 // h, h))).astype(np.float32)
    return params, block, scale, norm2, x


def _bf16(a):
    return torch.as_tensor(np.asarray(a, np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("use_silu", [False, True])
@pytest.mark.parametrize("h", [32, 16, 8, 1])
def test_plain_version_matches_pallas_interpret(h, use_silu):
    params, block, scale, norm2, x = _case(h, use_silu, seed=h)
    want = j_fused_ffn(jnp.asarray(x, jnp.bfloat16), params,
                       activation="silu" if use_silu else "gelu", interpret=True,
                       norm2_scale=jnp.asarray(scale))
    before = (ffn_ops.fused_gated_ffn.launches, ffn_ops.fused_gated_ffn.backward_launches)
    with torch.no_grad():
        got = ffn_ops.fused_gated_ffn(_bf16(x), block, norm2)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    assert (ffn_ops.fused_gated_ffn.launches, ffn_ops.fused_gated_ffn.backward_launches) == before
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=0.05,
                               atol=0.05)


@pytest.mark.parametrize("h,use_silu", [(32, False), (16, True), (8, False), (1, True)])
def test_plain_backward_matches_pallas_interpret(h, use_silu):
    params, block, scale, norm2, x = _case(h, use_silu, seed=100 + h)
    cot = np.random.default_rng(h).normal(size=x.shape).astype(np.float32)

    def loss(x, params, scale):
        y = j_fused_ffn(x, params, activation="silu" if use_silu else "gelu", interpret=True,
                        norm2_scale=scale)
        return jnp.sum(y.astype(jnp.float32) * cot)

    gx, gp, gs = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x, jnp.bfloat16), params,
                                                   jnp.asarray(scale))
    mlp = gp["GatedMLP_0"]
    want = [gs, gp["RMSNorm_0"]["scale"], np.asarray(mlp["Dense_0"]["kernel"]).T,
            mlp["Dense_0"]["bias"], np.asarray(mlp["Dense_1"]["kernel"]).T,
            mlp["Dense_1"]["bias"], np.asarray(gp["Dense_0"]["kernel"]).T, gp["Dense_0"]["bias"]]
    dx, grads = ffn_ops.gated_ffn_backward_reference(_bf16(x), block, norm2, _bf16(cot))
    # at hidden 1 the block's RMS norm divides norm2's scale out of its one
    # value, so dscale2 is 0 in exact arithmetic (fp32: ~1e-6) and each
    # package's bf16 backward returns rounding noise in its place (~0.4 a
    # side, against dscale's ~110): there it is held to 0.04 of dscale's max
    floor = {"dscale2": np.abs(np.asarray(want[1])).max()} if h == 1 else {}
    for got, ref, name in zip([dx, *grads], [gx, *want], ("dx",) + NAMES):
        got = got.float().numpy()
        ref = np.asarray(ref, np.float32)
        assert got.shape == ref.shape, name
        s = max(np.abs(ref).max(), floor.get(name, 0.0), 1e-3)
        np.testing.assert_allclose(got / s, ref / s, atol=GRAD_REL, err_msg=name)


def test_autograd_function_within_gradcheck_bounds_at_hidden_32():
    _, block, _, norm2, x = _case(32, False, seed=7)
    cot = _bf16(np.random.default_rng(8).normal(size=x.shape))

    def feed_forward(fn, mlp, n2):
        return lambda xx: (fn(xx, mlp, n2), ffn_ops._params(mlp, n2))

    rows, ok, _ = gradcheck.check_backward(
        ("dx",) + NAMES, ("dx",), feed_forward(ffn_ops.reference_with_backward, block, norm2),
        feed_forward(ffn_ops.gated_ffn_reference, block, norm2),
        feed_forward(ffn_ops.gated_ffn_reference, gradcheck.rounded_copy(block),
                     gradcheck.rounded_copy(norm2)), [_bf16(x)], [cot])
    assert ok, rows
    assert [r["name"] for r in rows] == ["dx", *NAMES]
