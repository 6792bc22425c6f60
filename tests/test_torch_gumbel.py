"""The port's gumbel perturbation (ops/gumbel.py) against the JAX package, on the CPU.

The TPU kernel draws its bits from the core's hardware generator and the
port from Philox4x32-10, so the two agree in distribution, not bit for
bit. Here:

  * the torch Philox matches Random123's known-answer vectors;
  * the mantissa trick gives u in [0, 1) on the 2^-23 grid, as the Pallas
    kernel's bitcast does on the same bits (gumbel.py:54-57);
  * for the same u, the port's noise equals JAX's XLA formula
    (gumbel.py:58, transolver.py:59) to 1e-6;
  * over 200,000 draws the port's noise has mean γ ± 0.02 and std
    π/√6 ± 0.02 (the JAX suite's bounds, tests/test_gumbel_kernel.py:75-83),
    and its two-sample Kolmogorov-Smirnov statistic against as many
    ``jax.random`` draws through JAX's formula stays under 0.0062, the
    critical value at α = 0.001 for two samples of 200,000;
  * the same key gives the same noise; other keys, and other counters
    (the draw's halves, neighbouring words), give uncorrelated noise;
  * the gradient is the exact passthrough ``ct.to(logits.dtype)`` and
    launches nothing (the JAX suite's one-``pallas_call`` check, :42-58).
The kernel itself is held against this plain version on a card by
tests/test_torch_cuda.py and chip_smoke.py phase 22.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_physics_tpu.models.transolver import gumbel_softmax as j_gumbel_softmax
from graph_physics_tpu_torch.models.transolver import gumbel_softmax
from graph_physics_tpu_torch.ops import gumbel as G

N_DRAWS = 200_000
GAMMA, STD = 0.5772156649, math.pi / math.sqrt(6.0)
#: two-sample KS critical value, α = 0.001, n = m = 200,000: 1.949·sqrt(2/n)
KS_LIMIT = 0.0062
#: |correlation| of two independent 200,000-draw streams: 5 standard errors
CORR_LIMIT = 5.0 / math.sqrt(N_DRAWS)


def _key(a, b):
    return torch.tensor([a, b], dtype=torch.int64)


@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(counter, key, want):
    got = G.philox4x32_10(torch.tensor(counter, dtype=torch.int64), torch.tensor(key))
    assert tuple(got.tolist()) == want


def test_random_bits_follow_the_counter_layout():
    key = _key(7, 0xDEADBEEF)
    bits = G.random_bits(10, key)
    i = torch.arange(3, dtype=torch.int64)
    zero = torch.zeros_like(i)
    blocks = G.philox4x32_10(torch.stack([i, zero, zero, zero], -1), key)
    assert torch.equal(bits, blocks.reshape(-1)[:10])
    assert bits.min() >= 0 and bits.max() < 2**32


def test_uniform_mantissa_trick_matches_the_pallas_bitcast():
    rng = np.random.default_rng(0)
    bits = np.concatenate([[0, 0x1FF, 0x200, 0xFFFFFFFF],
                           rng.integers(0, 2**32, 10_000, dtype=np.uint64)]).astype(np.uint32)
    u = G.uniform_from_bits(torch.as_tensor(bits.astype(np.int64))).numpy()
    # gumbel.py:55-57 on the same bits
    want = jax.lax.bitcast_convert_type(
        (jnp.asarray(bits) >> 9) | jnp.uint32(0x3F800000), jnp.float32) - 1.0
    np.testing.assert_array_equal(u, np.asarray(want))
    assert u.dtype == np.float32 and u.min() == 0.0 and u.max() == 1.0 - 2.0**-23
    assert u[1] == 0.0 and u[2] == 2.0**-23  # bits below the top 23 are dropped
    np.testing.assert_array_equal(u * 2**23, np.round(u * 2**23))


def test_noise_formula_matches_jax_for_the_same_u():
    u = np.random.default_rng(1).random(50_000).astype(np.float32)
    u[:3] = (0.0, 2.0**-23, 1.0 - 2.0**-23)
    want = -jnp.log(-jnp.log(jnp.asarray(u) + 1e-8) + 1e-8)
    got = G.gumbel_noise(torch.as_tensor(u))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def _port_noise(key, n=N_DRAWS):
    return G.gumbel_perturb(torch.zeros(n), key).numpy()


def _ks_2samp(a, b):
    a, b = np.sort(a), np.sort(b)
    both = np.concatenate([a, b])
    return np.max(np.abs(np.searchsorted(a, both, side="right") / len(a)
                         - np.searchsorted(b, both, side="right") / len(b)))


def test_distribution_matches_the_jax_draw():
    g = _port_noise(_key(3, 11))
    assert abs(g.mean() - GAMMA) < 0.02 and abs(g.std() - STD) < 0.02
    u = jax.random.uniform(jax.random.PRNGKey(3), (N_DRAWS,), jnp.float32)
    jg = np.asarray(-jnp.log(-jnp.log(u + 1e-8) + 1e-8))  # transolver.py:58-59
    assert abs(jg.mean() - GAMMA) < 0.02 and abs(jg.std() - STD) < 0.02
    assert _ks_2samp(g, jg) < KS_LIMIT


def test_softmax_weights_match_the_jax_draw_in_distribution():
    """The slice weights of ``gumbel_softmax`` with noise: the port's
    fused draw against JAX's (which keeps the XLA draw off the TPU) on the
    same logits and temperature, by the largest weight of each row."""
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(6250, 4, 8)).astype(np.float32)
    tau = rng.uniform(0.3, 1.5, size=(6250, 4, 1)).astype(np.float32)
    jw = j_gumbel_softmax(jnp.asarray(logits), jnp.asarray(tau), jax.random.PRNGKey(5),
                          fused=True)
    tw = gumbel_softmax(torch.as_tensor(logits), torch.as_tensor(tau),
                        torch.Generator().manual_seed(5), fused=True)
    assert tw.dtype == torch.float32
    np.testing.assert_allclose(tw.sum(-1).numpy(), 1.0, rtol=1e-6)
    jmax, tmax = np.asarray(jw).max(-1).ravel(), tw.max(-1).values.numpy().ravel()
    # 25,000 rows each: the α = 0.001 critical value is 1.949·sqrt(2/25,000)
    assert _ks_2samp(tmax, jmax) < 1.949 * math.sqrt(2 / len(tmax))


def test_same_key_same_noise_other_keys_and_counters_uncorrelated():
    a = _port_noise(_key(1, 2))
    assert np.array_equal(a, _port_noise(_key(1, 2)))
    for other in (_key(1, 3), _key(2, 2)):
        b = _port_noise(other)
        assert not np.array_equal(a, b)
        assert abs(np.corrcoef(a, b)[0, 1]) < CORR_LIMIT
    # other counters of one draw: its two halves, and neighbouring words
    half = N_DRAWS // 2
    assert abs(np.corrcoef(a[:half], a[half:])[0, 1]) < CORR_LIMIT * math.sqrt(2)
    assert abs(np.corrcoef(a[:-1], a[1:])[0, 1]) < CORR_LIMIT


def test_key_is_drawn_from_the_generator_on_its_device():
    gen = torch.Generator().manual_seed(9)
    k1, k2 = G.draw_key(gen, "cpu"), G.draw_key(gen, "cpu")
    assert k1.dtype == torch.int64 and k1.shape == (2,) and not torch.equal(k1, k2)
    assert int(k1.min()) >= 0 and int(k1.max()) < 2**32
    assert torch.equal(k1, G.draw_key(torch.Generator().manual_seed(9), "cpu"))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_is_an_exact_passthrough(dtype):
    rng = np.random.default_rng(6)
    x = torch.as_tensor(rng.normal(size=(37, 4, 8)).astype(np.float32)).to(dtype)
    x.requires_grad_(True)
    cot = torch.as_tensor(rng.normal(size=(37, 4, 8)).astype(np.float32))
    before = G.gumbel_perturb.launches
    out = G.gumbel_perturb(x, _key(4, 5))
    assert out.dtype == torch.float32 and out.grad_fn.saved_tensors == ()
    torch.testing.assert_close(out, G.gumbel_perturb_reference(x.detach(), _key(4, 5)),
                               rtol=0, atol=0)
    (grad,) = torch.autograd.grad(out, x, cot)
    assert grad.dtype == dtype and torch.equal(grad, cot.to(dtype))
    assert G.gumbel_perturb.launches == before  # the CPU takes the plain version


def test_wrapper_rejects_a_bad_key():
    x = torch.zeros(4, 4, 8)
    for key in (torch.zeros(2, dtype=torch.int32), torch.zeros(3, dtype=torch.int64)):
        with pytest.raises(ValueError, match="key"):
            G.gumbel_perturb(x, key)
    with pytest.raises(ValueError, match="floating"):
        G.gumbel_perturb(torch.zeros(4, dtype=torch.int64), _key(0, 0))
