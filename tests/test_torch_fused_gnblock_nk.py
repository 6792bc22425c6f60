"""The port's NK slot layout and fused GraphNetBlock against the JAX package.

  * the NK layout (slot order, padding) equals the JAX package's;
  * the plain PyTorch version ``fused_gn_block_nk_reference`` matches
    ``blocked_reference_nk`` in fp32 (1e-5) for the folded-encoder, middle
    and last-block variants, and the Pallas kernel run in interpret mode in
    bf16 (rtol = atol = 0.05, the JAX suite's bound for the same check);
  * on CPU tensors the wrapper takes the plain version and counts no launch.
The CUDA kernel itself is tested on a card by tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_physics_tpu.models.layers import MLP as FlaxMLP
from graph_physics_tpu.ops import tiling as jtiling
from graph_physics_tpu.ops.fused_edge_attention_nk import build_nk_tiling as j_build_nk
from graph_physics_tpu.ops.fused_gnblock_nk import blocked_reference_nk, fused_gn_block_nk as j_fused
from graph_physics_tpu_torch.core.graph import MeshGraph
from graph_physics_tpu_torch.ops import tiling as ttiling
from graph_physics_tpu_torch.ops.fused_gnblock_nk import (
    fused_gn_block_nk,
    fused_gn_block_nk_reference,
)
from tests.helpers import tiny_graph
from tests.test_torch_layers import np_mlp_params, port_mlp

H, B, FE = 32, 4, 3
VARIANTS = ["folded", "middle", "last"]


def _port_host_graph(g):
    """The JAX package's host MeshGraph as a port host MeshGraph."""
    return MeshGraph(x=g.x, pos=g.pos, node_type=g.node_type, node_mask=g.node_mask,
                     senders=g.senders, receivers=g.receivers, edge_mask=g.edge_mask,
                     edge_attr=g.edge_attr, y=g.y, n_node=int(g.n_node))


@pytest.mark.parametrize("nx,ny", [(14, 10), (20, 16)])
def test_nk_layout_matches_jax(nx, ny):
    g = tiny_graph(nx=nx, ny=ny)
    args = (np.asarray(g.senders), np.asarray(g.receivers), int(g.n_node))
    jt = j_build_nk(*args, edge_mask=np.asarray(g.edge_mask), node_block=128)
    tt = ttiling.build_nk_tiling(*args, edge_mask=np.asarray(g.edge_mask))
    assert jt is not None and tt is not None
    np.testing.assert_array_equal(tt.perm, jt.perm)
    assert (tt.k_slots, tt.node_block, tt.num_nodes) == (jt.k_slots, jt.node_block, jt.num_nodes)
    jg = jtiling.apply_to_graph_nk(g, jt)
    tg = ttiling.apply_to_graph_nk(_port_host_graph(g), tt)
    for name in ("x", "pos", "node_type", "node_mask", "senders", "receivers", "edge_mask",
                 "edge_attr", "y"):
        np.testing.assert_array_equal(np.asarray(getattr(tg, name)),
                                      np.asarray(getattr(jg, name)), err_msg=name)
    # slot s of receiver block g holds receiver g·nb + s % nb (k-major)
    valid = tg.edge_mask
    gids, loc_r = ttiling.nk_row_maps(tt)
    np.testing.assert_array_equal(tg.receivers[valid], (gids * tt.node_block + loc_r)[valid])
    vals = np.random.default_rng(0).normal(size=(g.senders.shape[0], 2))
    back = tt.reduce_edges(tt.expand_edges(vals), len(vals))
    e = int(g.n_edge)  # valid edges are a prefix; padded edges own no slot
    np.testing.assert_array_equal(back[:e], vals[:e])
    assert not back[e:].any()


def _case(variant, seed=0):
    """Inputs and parameters of one block on the 14x10 mesh's NK layout."""
    g = tiny_graph(nx=14, ny=10)
    tt = ttiling.build_nk_tiling(g.senders, g.receivers, g.x.shape[0], edge_mask=g.edge_mask)
    jt = j_build_nk(np.asarray(g.senders), np.asarray(g.receivers), g.x.shape[0],
                    edge_mask=np.asarray(g.edge_mask), node_block=128)
    tg = ttiling.apply_to_graph_nk(_port_host_graph(g), tt)
    rng = np.random.default_rng(seed)
    n, rows = tt.num_nodes, tt.total_rows
    x = (0.5 * rng.normal(size=(n, B, H))).astype(np.float32)
    width = FE if variant == "folded" else H
    e = (0.5 * rng.normal(size=(rows, B, width))).astype(np.float32)
    ep, np_ = np_mlp_params(rng, 3 * H, H, H), np_mlp_params(rng, 2 * H, H, H)
    enc = np_mlp_params(rng, FE, H, H) if variant == "folded" else None
    return dict(tt=tt, jt=jt, senders=torch.as_tensor(tg.senders),
                mask=torch.as_tensor(tg.edge_mask), x=x, e=e, ep=ep, np_=np_, enc=enc,
                last=variant == "last")


def _port_call(c, fn, dtype, **kw):
    enc = port_mlp(c["enc"], FE, H, H) if c["enc"] is not None else None
    with torch.no_grad():
        return fn(torch.as_tensor(c["x"]).to(dtype), torch.as_tensor(c["e"]).to(dtype),
                  c["senders"], c["mask"], port_mlp(c["ep"], 3 * H, H, H),
                  port_mlp(c["np_"], 2 * H, H, H), c["tt"], encoder_params=enc,
                  last_block=c["last"], **kw)


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a, np.float32)


@pytest.mark.parametrize("variant", VARIANTS)
def test_reference_matches_blocked_reference_nk_fp32(variant):
    c = _case(variant)
    e = jnp.asarray(c["e"])
    if c["enc"] is not None:  # the folded block: encoder first, as an XLA MLP
        e = FlaxMLP(hidden_size=H, out_size=H).apply({"params": c["enc"]}, e)
    jx, je = blocked_reference_nk(jnp.asarray(c["x"]), e, c["ep"], c["np_"], c["jt"],
                                  compute_dtype=jnp.float32)
    tx, te = _port_call(c, fused_gn_block_nk_reference, torch.float32,
                        compute_dtype=torch.float32)
    np.testing.assert_allclose(_f32(tx), _f32(jx), rtol=1e-5, atol=1e-5)
    if not c["last"]:
        np.testing.assert_allclose(_f32(te), _f32(je), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("variant", VARIANTS)
def test_wrapper_on_cpu_matches_pallas_interpret_bf16(variant):
    c = _case(variant, seed=1)
    jx, je = j_fused(jnp.asarray(c["x"], jnp.bfloat16), jnp.asarray(c["e"], jnp.bfloat16),
                     c["ep"], c["np_"], c["jt"], interpret=True, edge_encoder_params=c["enc"],
                     last_block=c["last"])
    before = fused_gn_block_nk.launches
    tx, te = _port_call(c, fused_gn_block_nk, torch.bfloat16)
    assert fused_gn_block_nk.launches == before  # CPU tensors: plain version, no launch
    assert tx.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(tx), _f32(jx), rtol=0.05, atol=0.05)
    if not c["last"]:
        # padded slots of a folded block hold enc(raw): compare valid slots only
        rows = c["mask"].numpy() if c["enc"] is not None else slice(None)
        np.testing.assert_allclose(_f32(te)[rows], _f32(je)[rows], rtol=0.05, atol=0.05)
    else:
        assert te.shape == (c["tt"].total_rows, B, H)  # dead edge stream passed through


def test_wrapper_checks_inputs():
    c = _case("middle")
    with pytest.raises(ValueError, match="bf16"):
        _port_call(c, fused_gn_block_nk, torch.float32)
    c["e"] = c["e"][:-128]
    with pytest.raises(ValueError, match="NK layout"):
        _port_call(c, fused_gn_block_nk, torch.bfloat16)
