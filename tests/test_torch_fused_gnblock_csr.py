"""The port's CSR GraphNetBlock against the JAX package, on a graded mesh.

On the 1,536-node graded test mesh (node N-1 is a real node with in-edges,
so a padding row leaking into it would show), per original edge and in
the original node order (JAX lays the same edges out in its blocked
order; neither package permutes the nodes here):
  * the plain PyTorch version ``fused_gn_block_csr_reference`` matches
    ``blocked_reference`` in fp32 (1e-5) for the folded-encoder, middle and
    last-block variants, and in bf16 (rtol = atol = 0.05);
  * the wrapper on CPU tensors (the plain version in bf16, no launch)
    matches the Pallas kernel ``fused_gn_block`` run in interpret mode at
    rtol = atol = 0.05, the JAX suite's bound for the same check;
  * values in the padding rows change nothing.
The CUDA kernel itself is tested on a card by tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_physics_tpu.models.layers import MLP as FlaxMLP
from graph_physics_tpu.ops import tiling as jtiling
from graph_physics_tpu.ops.fused_gnblock import blocked_reference, fused_gn_block as j_fused
from graph_physics_tpu_torch.ops import tiling as ttiling
from graph_physics_tpu_torch.ops.fused_gnblock_csr import (
    fused_gn_block_csr,
    fused_gn_block_csr_reference,
)
from tests.test_torch_csr_layout import graded_graph
from tests.test_torch_fused_gnblock_nk import _port_host_graph
from tests.test_torch_layers import np_mlp_params, port_mlp

H, B, FE = 32, 4, 3
VARIANTS = ["folded", "middle", "last"]
_GRAPH = {}


def _layouts():
    """(JAX EdgeTiling, port CSRLayout, port graph arrays) of the mesh."""
    if not _GRAPH:
        g = graded_graph()
        e = int(g.n_edge)
        args = (np.asarray(g.senders)[:e], np.asarray(g.receivers)[:e], int(g.n_node))
        jt = jtiling.build_edge_tiling(*args)
        tt = ttiling.build_csr_layout(*args)
        tg = ttiling.apply_to_graph(_port_host_graph(g), tt)
        _GRAPH.update(jt=jt, tt=tt, e=e, senders=torch.as_tensor(tg.senders),
                      receivers=torch.as_tensor(tg.receivers), mask=torch.as_tensor(tg.edge_mask))
    return _GRAPH


def _case(variant, seed=0):
    c = dict(_layouts())
    assert c["jt"] is not None and c["jt"].num_nodes == c["tt"].num_nodes
    rng = np.random.default_rng(seed)
    n = c["tt"].num_nodes
    width = FE if variant == "folded" else H
    edges = (0.5 * rng.normal(size=(c["e"], B, width))).astype(np.float32)
    c.update(x=(0.5 * rng.normal(size=(n, B, H))).astype(np.float32),
             e_jax=c["jt"].expand_edges(edges), e_port=c["tt"].expand_edges(edges),
             ep=np_mlp_params(rng, 3 * H, H, H), np_=np_mlp_params(rng, 2 * H, H, H),
             enc=np_mlp_params(rng, FE, H, H) if variant == "folded" else None,
             last=variant == "last")
    return c


def _port_call(c, fn, dtype, e=None, **kw):
    enc = port_mlp(c["enc"], FE, H, H) if c["enc"] is not None else None
    e = c["e_port"] if e is None else e
    with torch.no_grad():
        return fn(torch.as_tensor(c["x"]).to(dtype), torch.as_tensor(e).to(dtype),
                  c["senders"], c["receivers"], c["mask"], port_mlp(c["ep"], 3 * H, H, H),
                  port_mlp(c["np_"], 2 * H, H, H), c["tt"], encoder_params=enc,
                  last_block=c["last"], **kw)


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a, np.float32)


def _assert_close(c, got, want, tol):
    """x_out in node order; e_out per original edge (valid edges only)."""
    (tx, te), (jx, je) = got, want
    np.testing.assert_allclose(_f32(tx), _f32(jx), rtol=tol, atol=tol)
    if not c["last"]:
        np.testing.assert_allclose(c["tt"].reduce_edges(_f32(te), c["e"]),
                                   c["jt"].reduce_edges(_f32(je), c["e"]), rtol=tol, atol=tol)


def _jax_reference(c, cd):
    e = jnp.asarray(c["e_jax"], cd)
    if c["enc"] is not None:  # the folded block: encoder first, as a flax MLP
        e = FlaxMLP(hidden_size=H, out_size=H, dtype=cd).apply({"params": c["enc"]}, e)
    return blocked_reference(jnp.asarray(c["x"], cd), e, c["ep"], c["np_"], c["jt"],
                             compute_dtype=cd)


@pytest.mark.parametrize("variant", VARIANTS)
def test_reference_matches_blocked_reference(variant):
    c = _case(variant)
    _assert_close(c, _port_call(c, fused_gn_block_csr_reference, torch.float32,
                                compute_dtype=torch.float32), _jax_reference(c, jnp.float32),
                  1e-5)
    _assert_close(c, _port_call(c, fused_gn_block_csr_reference, torch.bfloat16,
                                compute_dtype=torch.bfloat16), _jax_reference(c, jnp.bfloat16),
                  0.05)


@pytest.mark.parametrize("variant", VARIANTS)
def test_wrapper_on_cpu_matches_pallas_interpret_bf16(variant):
    c = _case(variant, seed=1)
    want = j_fused(jnp.asarray(c["x"], jnp.bfloat16), jnp.asarray(c["e_jax"], jnp.bfloat16),
                   c["ep"], c["np_"], c["jt"], interpret=True, edge_encoder_params=c["enc"],
                   last_block=c["last"])
    before = fused_gn_block_csr.launches
    got = _port_call(c, fused_gn_block_csr, torch.bfloat16)
    assert fused_gn_block_csr.launches == before  # CPU tensors: plain version, no launch
    assert got[0].dtype == torch.bfloat16
    _assert_close(c, got, want, 0.05)
    if c["last"]:
        assert got[1].shape == (c["tt"].total_rows, B, H)  # dead edge stream passed through


def test_padding_rows_change_nothing():
    """Padding rows point at node N-1, a real node here: large values in
    them must not reach its sum, and they come back as they went in."""
    c = _case("middle", seed=2)
    assert c["tt"].row_ptr[-1] > c["tt"].row_ptr[-2]  # node N-1 has valid rows
    pad = ~c["mask"].numpy()
    assert pad.any()
    e = c["e_port"].copy()
    e[pad] = 1e3
    x0, e0 = _port_call(c, fused_gn_block_csr_reference, torch.float32,
                        compute_dtype=torch.float32)
    x1, e1 = _port_call(c, fused_gn_block_csr_reference, torch.float32, e=e,
                        compute_dtype=torch.float32)
    assert torch.equal(x0, x1) and torch.equal(e0[~pad], e1[~pad])
    assert (e1[pad] == 1e3).all()


def test_wrapper_checks_inputs():
    c = _case("middle")
    with pytest.raises(ValueError, match="bf16"):
        _port_call(c, fused_gn_block_csr, torch.float32)
    with pytest.raises(ValueError, match="CSR layout"):
        _port_call(c, fused_gn_block_csr, torch.bfloat16, e=c["e_port"][:-128])
