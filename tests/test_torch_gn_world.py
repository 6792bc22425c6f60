"""The GraphNetBlock's world seam (``extra_agg``, the world edges'
aggregate) in both layouts against the JAX package's oracles, on the CPU.

With the same numpy inputs from a seed, at B=2, on the 14x10 mesh's NK
layout and the 1,536-node graded mesh's CSR layout
(tests/test_torch_gn_wide.py's cases), and a dense random node-aligned ``extra_agg`` [N, B, H]:
  * the plain versions ``fused_gn_block_nk_reference`` and
    ``fused_gn_block_csr_reference`` with ``extra_agg`` match
    ``blocked_reference_nk`` / ``blocked_reference`` with it in fp32
    (1e-5), and their autograd, the extra aggregate's cotangent ``dea``
    included, matches ``jax.grad`` of them (1e-5 of each gradient's largest
    value, the cotangents zeroed near relu kinks), at hidden 32 and 64, for
    the folded-encoder and middle variants;
  * the wrappers on CPU tensors (the plain versions in bf16) match the
    oracles in bf16 within the JAX suite's 0.05, forward and gradients
    with ``dea``; JAX's own suite holds its Pallas seam to the same oracles
    (tests/test_world_sidecar.py::test_fused_gn_extra_agg_parity);
  * the backward plain versions (the kernels' contract: dx, de, the weight
    gradients, then dea) equal autograd of the wrappers;
  * a zero ``extra_agg`` gives the bits of none, forward and backward.
The CUDA kernels' seam is tested on a card by tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_physics_tpu.models.layers import MLP as FlaxMLP
from graph_physics_tpu.ops.fused_gnblock import blocked_reference
from graph_physics_tpu.ops.fused_gnblock_nk import blocked_reference_nk
from graph_physics_tpu_torch.ops import fused_gnblock_csr as csr_ops
from graph_physics_tpu_torch.ops import fused_gnblock_nk as nk_ops
from tests.test_torch_csr_train import _jax_mlp_grads
from tests.test_torch_gn_wide import FE, _case, _close_to_max, _cotangents, _edges, _mlps

LAYOUTS = ["nk", "csr"]


def _extra(c, seed):
    rng = np.random.default_rng(seed)
    return (0.3 * rng.normal(size=c["x"].shape)).astype(np.float32)


def _jax_block(c, cd):
    """blocked_reference(_nk) of the case with ``extra_agg``, the folded
    encoder first as a flax MLP, as f(x, e, enc, ep, np_, extra)."""
    ref = blocked_reference_nk if c["layout"] == "nk" else blocked_reference

    def run(x, e, enc, ep, np_, extra):
        if enc is not None:
            e = FlaxMLP(hidden_size=c["h"], out_size=c["h"], dtype=cd).apply({"params": enc}, e)
        return ref(x, e, ep, np_, c["jt"], compute_dtype=cd, extra_agg=extra)
    return run


def _port_block(c, fn_nk, fn_csr, **kw):
    """The port's block of the case's layout as f(x, e, mlps, extra)."""
    rows = ((c["senders"], c["mask"]) if c["layout"] == "nk"
            else (c["senders"], c["receivers"], c["mask"]))
    fn = fn_nk if c["layout"] == "nk" else fn_csr

    def run(x, e, mlps, extra):
        return fn(x, e, *rows, mlps[1], mlps[2], c["tt"], encoder_params=mlps[0],
                  last_block=c["last"], extra_agg=extra, **kw)
    return run


def _grads(c, extra, cots, jdtype, port, tdtype):
    """(port, JAX) gradients of Σ x_out·cot_x (+ Σ e_out·cot_e): dx, de per
    edge unless the encoder is folded, every MLP parameter (encoder, edge,
    node) in the port's order, then dea."""
    cot_x, cot_tp, cot_jx = cots
    fold, last = c["enc"] is not None, c["last"]
    jblock = _jax_block(c, jdtype)

    def jloss(x, e, enc, ep, np_, xa):
        xo, eo = jblock(x, e, enc, ep, np_, xa)
        loss = jnp.sum(xo.astype(jnp.float32) * cot_x)
        return loss if last else loss + jnp.sum(eo.astype(jnp.float32) * cot_jx)

    # fp32 compiled (op by op, the flax encoder takes seconds); bf16 op by
    # op, where every operation rounds to bf16 as the oracle's are meant to
    grad = jax.grad(jloss, argnums=(0, 1, 2, 3, 4, 5))
    jg = (jax.jit(grad) if jdtype == jnp.float32 else grad)(
        jnp.asarray(c["x"], jdtype), jnp.asarray(c["e_jax"], jdtype), c["enc"], c["ep"],
        c["np_"], jnp.asarray(extra, jdtype))
    want = [jg[0]] + ([] if fold else [_edges(c, jg[1], False)])
    for tree in ((jg[2],) if fold else ()) + (jg[3], jg[4]):
        want += _jax_mlp_grads(tree)
    want.append(jg[5])

    mlps = _mlps(c)
    x = torch.as_tensor(c["x"]).to(tdtype).requires_grad_(True)
    e = torch.as_tensor(c["e_port"]).to(tdtype).requires_grad_(not fold)
    xa = torch.as_tensor(extra).to(tdtype).requires_grad_(True)
    xo, eo = port(x, e, mlps, xa)
    loss = (xo.float() * torch.as_tensor(cot_x)).sum()
    if not last:
        loss = loss + (eo.float() * torch.as_tensor(cot_tp)).sum()
    params = [p for m in mlps if m is not None for p in nk_ops._mlp_params(m)]
    wrt = [x] + ([] if fold else [e]) + params + [xa]
    tg = [g.float().numpy() for g in torch.autograd.grad(loss, wrt)]
    got = [tg[0]] + ([] if fold else [_edges(c, tg[1], True)]) + tg[2 - fold:]
    return got, want


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("variant", ["folded", "middle"])
@pytest.mark.parametrize("hidden", [32, 64])
def test_plain_versions_with_extra_agg_match_the_oracles_fp32(hidden, variant, layout):
    c = _case(layout, hidden, variant, seed=10)
    extra = _extra(c, seed=11)
    with torch.no_grad():
        tx, te = _port_block(c, nk_ops.fused_gn_block_nk_reference,
                             csr_ops.fused_gn_block_csr_reference, compute_dtype=torch.float32)(
            torch.as_tensor(c["x"]), torch.as_tensor(c["e_port"]), _mlps(c),
            torch.as_tensor(extra))
    jx, je = jax.jit(_jax_block(c, jnp.float32))(jnp.asarray(c["x"]), jnp.asarray(c["e_jax"]),
                                                 c["enc"], c["ep"], c["np_"],
                                                 jnp.asarray(extra))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_edges(c, te, True), _edges(c, je, False), rtol=1e-5, atol=1e-5)
    got, want = _grads(c, extra, _cotangents(c, seed=12, extra=extra), jnp.float32,
                       _port_block(c, nk_ops.fused_gn_block_nk_reference,
                                   csr_ops.fused_gn_block_csr_reference,
                                   compute_dtype=torch.float32), torch.float32)
    assert len(got) == len(want) == 2 - (variant == "folded") + 9 * (3 if variant == "folded"
                                                                     else 2) + 1
    for i, (a, w) in enumerate(zip(got, want)):
        _close_to_max(a, w, 1e-5, "dea" if i == len(got) - 1 else f"gradient {i}")


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("hidden", [32, 64])
def test_cpu_path_with_extra_agg_matches_the_oracles_bf16(hidden, layout):
    """The wrapper's bf16 CPU path (no launch) on the last block, whose
    edge stream is dead, against the oracle in bf16: outputs and
    gradients with dea within the JAX suite's 0.05 of max."""
    c = _case(layout, hidden, "last", seed=13)
    extra = _extra(c, seed=14)
    block = _port_block(c, nk_ops.fused_gn_block_nk, csr_ops.fused_gn_block_csr)
    counts = (nk_ops.fused_gn_block_nk.launches, csr_ops.fused_gn_block_csr.launches)
    with torch.no_grad():
        tx, _ = block(torch.as_tensor(c["x"]).bfloat16(), torch.as_tensor(c["e_port"]).bfloat16(),
                      _mlps(c), torch.as_tensor(extra).bfloat16())
    jx, _ = _jax_block(c, jnp.bfloat16)(jnp.asarray(c["x"], jnp.bfloat16),
                                         jnp.asarray(c["e_jax"], jnp.bfloat16), c["enc"],
                                         c["ep"], c["np_"], jnp.asarray(extra, jnp.bfloat16))
    assert tx.dtype == torch.bfloat16
    np.testing.assert_allclose(tx.float().numpy(), np.asarray(jx, np.float32), rtol=0.05,
                               atol=0.05)
    got, want = _grads(c, extra, _cotangents(c, seed=15, extra=extra), jnp.bfloat16, block,
                       torch.bfloat16)
    assert counts == (nk_ops.fused_gn_block_nk.launches, csr_ops.fused_gn_block_csr.launches)
    for i, (a, w) in enumerate(zip(got, want)):
        _close_to_max(a, w, 0.05, "dea" if i == len(got) - 1 else f"gradient {i}")


def _bf16_inputs(c, extra):
    return (torch.as_tensor(c["x"]).bfloat16(), torch.as_tensor(c["e_port"]).bfloat16(),
            None if extra is None else torch.as_tensor(extra).bfloat16())


@pytest.mark.parametrize("layout", LAYOUTS)
def test_backward_reference_returns_dea_as_the_kernels_do(layout):
    """``fused_gn_block_*_backward_reference`` with the extra aggregate
    returns (dx, de, weight gradients, dea), equal to autograd of the bf16
    wrapper; without it the three it returned before."""
    c = _case(layout, 32, "middle", seed=16)
    x, e, extra = _bf16_inputs(c, _extra(c, seed=17))
    mlps = _mlps(c)
    rng = np.random.default_rng(18)
    g_x = torch.as_tensor(rng.normal(size=x.shape), dtype=torch.bfloat16)
    g_e = torch.as_tensor(rng.normal(size=e.shape), dtype=torch.bfloat16)
    if layout == "nk":
        rows = (c["senders"], c["mask"], c["tt"])
        backward = nk_ops.fused_gn_block_nk_backward_reference
    else:
        rows = (c["senders"], c["receivers"], c["mask"], c["tt"])
        backward = csr_ops.fused_gn_block_csr_backward_reference
    dx, de, grads, dea = backward(x, e, None, g_x, g_e, *rows, mlps, extra=extra)
    assert len(backward(x, e, None, g_x, g_e, *rows, mlps)) == 3

    xl, el, xa = (t.clone().requires_grad_(True) for t in (x, e, extra))
    xo, eo = _port_block(c, nk_ops.fused_gn_block_nk, csr_ops.fused_gn_block_csr)(
        xl, el, mlps, xa)
    params = [p for m in mlps if m is not None for p in nk_ops._mlp_params(m)]
    want = torch.autograd.grad([xo, eo], [xl, el, xa, *params], [g_x, g_e])
    for a, w in zip([dx, de, dea, *grads], want):
        assert torch.equal(a, w)
    assert dea.dtype == torch.bfloat16 and dea.shape == x.shape


@pytest.mark.parametrize("layout", LAYOUTS)
def test_zero_extra_agg_gives_the_bits_of_none(layout):
    """agg + 0 rounds to agg: outputs and every gradient of the bf16
    wrapper keep their bits."""
    c = _case(layout, 32, "folded", seed=19)
    x, raw, zero = _bf16_inputs(c, np.zeros_like(c["x"]))
    mlps = _mlps(c)
    block = _port_block(c, nk_ops.fused_gn_block_nk, csr_ops.fused_gn_block_csr)
    params = [p for m in mlps if m is not None for p in nk_ops._mlp_params(m)]
    runs = []
    for extra in (None, zero):
        xl = x.clone().requires_grad_(True)
        xo, eo = block(xl, raw, mlps, extra)
        loss = (xo.float() ** 2).sum() + (eo.float() * 0.5).sum()
        runs.append([xo, eo, *torch.autograd.grad(loss, [xl, *params])])
    assert raw.shape[-1] == FE
    for a, b in zip(*runs):
        assert torch.equal(a, b)
