"""The port's Transolver++ modules against the JAX package, on the CPU.

Same numpy inputs and the same flax parameters (randomised around their
initial values, carried across by utils/convert.py) through
graph_physics_tpu.models.transolver and graph_physics_tpu_torch.models.
transolver, in fp32, at 1e-5:

  * ``LayerNorm`` against flax ``nn.LayerNorm(epsilon=1e-5)`` (fast
    variance, off-centre rows), and in bf16 to one bf16 step;
  * ``gumbel_softmax`` noise-free and ``hard`` (value and straight-through
    gradient);
  * ``PhysicsAttention`` with a node mask, ``TransolverBlock`` (middle and
    last) and ``TransolverModel`` with and without ``unified_pos``, on a
    stacked batch of B=3 different samples with different masks (JAX vmaps
    one graph; the port takes the batch axis, and its slice statistics
    must stay per sample) and on a single graph;
  * the same with injected slice noise: ``gumbel_softmax`` is replaced, in
    both packages and only inside the test, by one that adds a numpy
    [N, H, G] draw per block (broadcast over the batch) to the logits;
  * the weight bridge: port ``state_dict()`` -> JAX ``convert_state_dict``
    -> the flax parameters that were loaded, and back.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graph_physics_tpu.models.transolver as jtransolver
import graph_physics_tpu_torch.models.transolver as ttransolver
from graph_physics_tpu.models.processors import TransolverProcessor as JTP
from graph_physics_tpu.models.simulator import Simulator as JSim
from graph_physics_tpu.utils.convert import convert_state_dict
from graph_physics_tpu_torch.models.layers import LayerNorm
from graph_physics_tpu_torch.models.processors import TransolverProcessor
from graph_physics_tpu_torch.models.simulator import Simulator
from graph_physics_tpu_torch.utils.convert import (
    load_jax_params,
    load_physics_attention,
    load_transolver,
    load_transolver_block,
)

TOL = dict(rtol=1e-5, atol=1e-5)
N, B, C, H, G = 70, 3, 16, 2, 8
D = C // H
FUN = 11
LAYERS = 2
PARAM = {"model": {"type": "transolver", "message_passing_num": LAYERS, "node_input_size": 2,
                   "output_size": 2, "hidden_size": C, "num_heads": H}}


def _rand(*shape, seed, scale=1.0, shift=0.0):
    return (shift + scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


def _masks(seed):
    """[B, N] masks, different per sample, each with its last nodes padded."""
    rng = np.random.default_rng(seed)
    m = rng.random((B, N)) > 0.15
    for b in range(B):
        m[b, N - 5 * (b + 1):] = False
    return m


def randomized(params, seed, scale=0.1):
    """``params`` plus scale · N(0, 1) noise on every leaf (a numpy tree)."""
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_unflatten(
        tree, [np.asarray(v, np.float32) + scale * rng.normal(size=np.shape(v)).astype(np.float32)
               for v in leaves])


def _t(a):
    return torch.as_tensor(np.asarray(a))


# ---- LayerNorm and gumbel_softmax -------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_flax(dtype):
    # off-centre rows, as a residual stream's: flax's fast variance
    # E[x²] - E[x]² cancels in fp32 far off centre, where two summation
    # orders no longer agree to 1e-5
    x = _rand(B, N, C, seed=0, scale=1.0, shift=0.5)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ln = fnn.LayerNorm(epsilon=1e-5, dtype=jd)
    params = randomized(ln.init(jax.random.PRNGKey(0), x), seed=1, scale=0.5)
    want = np.asarray(ln.apply(params, jnp.asarray(x, jd)).astype(jnp.float32))
    port = LayerNorm(C, dtype=td)
    port.weight.data = _t(params["params"]["scale"])
    port.bias.data = _t(params["params"]["bias"])
    with torch.no_grad():
        got = port(_t(x).to(td))
    assert got.dtype == td
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    else:  # one bf16 step: the two round the same fp32 value
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2**-7, atol=2**-7)


@pytest.mark.parametrize("hard", [False, True])
def test_gumbel_softmax_noise_free_matches_jax(hard):
    logits = _rand(N, H, G, seed=2, scale=2.0)
    tau = np.abs(_rand(N, H, 1, seed=3)) + 0.05
    cot = _rand(N, H, G, seed=4)

    def jf(lg):
        return jtransolver.gumbel_softmax(lg, jnp.asarray(tau), None, hard=hard)

    want, vjp = jax.vjp(jf, jnp.asarray(logits))
    lt = _t(logits).requires_grad_(True)
    got = ttransolver.gumbel_softmax(lt, _t(tau), None, hard=hard)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    (g,) = torch.autograd.grad(got, lt, _t(cot))
    np.testing.assert_allclose(g.numpy(), np.asarray(vjp(jnp.asarray(cot))[0]), **TOL)
    if hard:
        assert set(np.unique(np.round(got.detach().numpy(), 6))) <= {0.0, 1.0}


# ---- injected slice noise ----------------------------------------------------

@pytest.fixture
def injected_noise(monkeypatch):
    """Replace ``gumbel_softmax`` in both packages by one that, when the
    caller asks for noise, adds the next of ``LAYERS`` numpy [N, H, G]
    draws to the logits (block i gets draw i; JAX traces each block once
    under vmap and jit). Returns a setter for the draws."""
    draws = {"noise": None}

    def fake(orig):
        count = [0]

        def gumbel_softmax(logits, tau, rng, hard=False, fused=False, **kw):
            if rng is None:
                return orig(logits, tau, None, hard=hard)
            noise = draws["noise"][count[0] % len(draws["noise"])]
            count[0] += 1
            if isinstance(logits, torch.Tensor):
                y = logits.float() + _t(noise)
            else:
                y = logits.astype(jnp.float32) + jnp.asarray(noise)
            return orig(y, tau, None, hard=hard)
        return gumbel_softmax

    monkeypatch.setattr(jtransolver, "gumbel_softmax", fake(jtransolver.gumbel_softmax))
    monkeypatch.setattr(ttransolver, "gumbel_softmax", fake(ttransolver.gumbel_softmax))

    def set_noise(n_draws, n_nodes, seed):
        rng = np.random.default_rng(seed)
        u = rng.random((n_draws, n_nodes, H, G)).astype(np.float32)
        draws["noise"] = -np.log(-np.log(u + 1e-8) + 1e-8)
    return set_noise


# ---- PhysicsAttention, blocks, model ---------------------------------------

@pytest.mark.parametrize("noisy", [False, True])
def test_physics_attention_matches_jax(noisy, injected_noise):
    x = _rand(B, N, C, seed=5)
    mask = _masks(6)
    jm = jtransolver.PhysicsAttention(dim=C, heads=H, dim_head=D, slice_num=G)
    params = randomized(jm.init(jax.random.PRNGKey(1), x[0], None, mask[0]), seed=7)
    if noisy:
        injected_noise(1, N, seed=8)
    extra = {"rngs": {"gumbel": jax.random.PRNGKey(2)}} if noisy else {}
    want = np.asarray(jax.jit(jax.vmap(lambda xx, mm: jm.apply(params, xx, None, mm, **extra)))(
        jnp.asarray(x), jnp.asarray(mask)))
    port = ttransolver.PhysicsAttention(C, heads=H, dim_head=D, slice_num=G)
    load_physics_attention(port, params["params"], "Attn")
    gen = torch.Generator().manual_seed(0) if noisy else None
    got = port(_t(x), _t(mask), gen)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    # per-sample slice statistics: sample 0 alone gives sample 0's output
    alone = port(_t(x[:1]), _t(mask[:1]), gen)
    np.testing.assert_allclose(alone.detach().numpy()[0], want[0], **TOL)


@pytest.mark.parametrize("last", [False, True])
def test_transolver_block_matches_jax(last):
    x = _rand(B, N, C, seed=9)
    mask = _masks(10)
    jb = jtransolver.TransolverBlock(num_heads=H, hidden_dim=C, mlp_ratio=2, last_layer=last,
                                     out_dim=2, slice_num=G)
    params = randomized(jb.init(jax.random.PRNGKey(3), x[0], None, mask[0]), seed=11)
    want = np.asarray(jax.jit(jax.vmap(lambda xx, mm: jb.apply(params, xx, None, mm)))(
        jnp.asarray(x), jnp.asarray(mask)))
    port = ttransolver.TransolverBlock(H, C, mlp_ratio=2, last_layer=last, out_dim=2, slice_num=G)
    load_transolver_block(port, params["params"], "block")
    got = port(_t(x), _t(mask))
    assert got.shape == ((B, N, 2) if last else (B, N, C))
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


@pytest.mark.parametrize("unified_pos", [False, True])
@pytest.mark.parametrize("noisy", [False, True])
def test_transolver_model_matches_jax(unified_pos, noisy, injected_noise):
    x = _rand(B, N, FUN, seed=12)
    pos = _rand(B, N, 2, seed=13)
    mask = _masks(14)
    kw = dict(n_layers=LAYERS, n_hidden=C, n_head=H, fun_dim=FUN, out_dim=2, slice_num=G,
              ref=3, unified_pos=unified_pos)
    jm = jtransolver.TransolverModel(**kw)
    params = randomized(jm.init(jax.random.PRNGKey(4), x[0], pos[0], mask[0]), seed=15)
    if noisy:
        injected_noise(LAYERS, N, seed=16)
    extra = {"rngs": {"gumbel": jax.random.PRNGKey(5)}} if noisy else {}
    want = np.asarray(jax.jit(jax.vmap(lambda a, p, m: jm.apply(params, a, p, m, **extra)))(
        jnp.asarray(x), jnp.asarray(pos), jnp.asarray(mask)))
    port = ttransolver.TransolverModel(**kw)
    load_transolver(port, params["params"])
    gen = torch.Generator().manual_seed(0) if noisy else None
    got = port(_t(x), _t(pos), _t(mask), gumbel=gen)
    assert got.dtype == torch.float32 and got.shape == (B, N, 2)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    # one [N, F] graph, as the rollout feeds it
    one = port(_t(x[1]), _t(pos[1]), _t(mask[1]), gumbel=gen)
    np.testing.assert_allclose(one.detach().numpy(), want[1], **TOL)


def test_unported_options_raise():
    with pytest.raises(NotImplementedError):
        ttransolver.PhysicsAttention(C, heads=H, dim_head=D, use_rope_embeddings=True)
    with pytest.raises(NotImplementedError):
        ttransolver.TransolverModel(n_hidden=C, n_head=H, use_temporal_block=True)
    with pytest.raises(NotImplementedError):
        TransolverProcessor(2, FUN, 2, hidden_size=C, use_temporal_block=True)
    model = ttransolver.TransolverModel(n_layers=1, n_hidden=C, n_head=H, fun_dim=FUN)
    with pytest.raises(NotImplementedError):
        model(torch.zeros(N, FUN), condition=torch.zeros(3))


# ---- weight bridge -----------------------------------------------------------

def _simulators(seed=17):
    jsim = JSim(node_input_size=FUN, edge_input_size=0, output_size=2, feature_index_start=0,
                feature_index_end=2, output_index_start=0, output_index_end=2,
                node_type_index=2, model=JTP(message_passing_num=LAYERS, node_input_size=FUN,
                                             output_size=2, hidden_size=C, num_heads=H,
                                             slice_num=G))
    tsim = Simulator(node_input_size=FUN, edge_input_size=0, output_size=2,
                     feature_index_start=0, feature_index_end=2, output_index_start=0,
                     output_index_end=2, node_type_index=2,
                     model=TransolverProcessor(LAYERS, FUN, 2, hidden_size=C, num_heads=H,
                                               slice_num=G))
    return jsim, tsim


def test_weight_bridge_round_trip():
    from tests.helpers import tiny_graph

    jsim, tsim = _simulators()
    g = jax.tree.map(jnp.asarray, tiny_graph(nx=14, ny=10))
    params = randomized(jax.jit(jsim.init_params)(jax.random.PRNGKey(6), g), seed=18)
    state = jax.jit(lambda gg: jsim.prepare(jsim.init_state(), gg, is_training=True)[3])(g)
    state = jax.tree.map(np.asarray, state)
    load_jax_params(tsim, params, state)
    sd = tsim.state_dict()
    assert tuple(sd["model.model.blocks.0.Attn.bias"].shape) == (1, H, 1, 1)
    assert "model.model.blocks.1.mlp2.weight" in sd and "model.model.blocks.0.mlp2.weight" not in sd
    back, back_state = convert_state_dict({k: v.numpy() for k, v in sd.items()}, PARAM)
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    flat_p = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    assert len(flat_b) == len(flat_p)
    for path, v in flat_b:
        np.testing.assert_array_equal(np.asarray(v), flat_p[path],
                                      err_msg=jax.tree_util.keystr(path))
    for norm in ("output_norm", "node_norm"):
        for f in ("acc_sum", "acc_sum_sq", "acc_count", "num_accumulations"):
            np.testing.assert_array_equal(np.asarray(getattr(getattr(back_state, norm), f)),
                                          getattr(getattr(state, norm), f))
    # and back into a fresh port simulator: the same state_dict
    _, again = _simulators()
    load_jax_params(again, jax.tree.map(np.asarray, back), back_state)
    for k, v in again.state_dict().items():
        assert torch.equal(v, sd[k]), k
