"""Rows 1-4 with MLPs of 1 to 8 Dense layers, with and without their
RMSNorm tail (JAX's ``GraphNetBlock.nb_of_layers`` and ``layer_norm``),
against the JAX package on the CPU.

With the same numpy inputs from a seed, at B = 128 / hidden (the Pallas
kernels' lanes full), on the 14x10 mesh's NK layout and the 1,536-node
graded mesh's CSR layout (tests/test_torch_gn_small.py's cases):
  * the wrappers on CPU tensors (the plain versions in bf16, no launch)
    match JAX's Pallas kernels in interpret mode (``fused_gn_block_nk`` /
    ``fused_gn_block`` with ``layer_norm`` and flax parameters of the
    depth) within the JAX suite's 0.05, forward and gradients: depths 1,
    2, 3, 5 and 8, with and without the norm, at hidden 8 and 32, the
    depths and norms spread over both layouts; a folded first block and a
    world seam (``extra_agg``) at depth 2 without the norm and depth 5
    with it. JAX's kernels give the folded encoder the block's
    ``layer_norm`` (fused_gnblock.py:_flatten_encoder), so the folded
    cases' encoders carry the block's norm flag;
  * at hidden 64 and 128 the port's plain ``GraphNetBlock(h,
    nb_of_layers=n, layer_norm=b)`` matches JAX's XLA ``GraphNetBlock`` in
    fp32 within 1e-5, and a whole ``epd`` whose blocks have 3 Dense layers
    (MeshGraphNets' two hidden layers) matches JAX's within 1e-4;
  * the weight bridge both ways on 2-layer, norm-free blocks: JAX's
    ``convert_state_dict`` of a port model, then ``load_jax_params``;
  * ``check_kernel_mlps`` takes 1 to 8 layers with either tail at every
    kernel width and raises at 9; the block's fields reach both MLPs.
The CUDA kernels are tested on a card by tests/test_torch_cuda.py.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_physics_tpu.models import layers as jlayers
from graph_physics_tpu.models.layers import MLP as FlaxMLP
from graph_physics_tpu.utils.convert import convert_state_dict
from graph_physics_tpu_torch import entry
from graph_physics_tpu_torch.models.layers import MLP, GraphNetBlock
from graph_physics_tpu_torch.ops import fused_gnblock_nk as nk_ops
from graph_physics_tpu_torch.ops.fused_gnblock_csr import fused_gn_block_csr
from graph_physics_tpu_torch.ops.fused_gnblock_nk import fused_gn_block_nk
from graph_physics_tpu_torch.utils.convert import load_jax_params, load_mlp
from tests.helpers import tiny_graph
from tests.test_torch_gn_small import _port_out, case, check_grads, cotangents, grads
from tests.test_torch_gn_wide import (
    FE,
    _edges,
    _port_fn,
    j_fused,
    j_fused_nk,
)
from tests.test_torch_layers import np_mlp_params, t
from tests.test_torch_simulator import PARAM, _to_np
from tests.test_torch_train_step import _packed_graphs

DEPTHS = [1, 2, 3, 5, 8]


def depth_case(layout, h, variant, seed, n_layers, norm, extra=False):
    """tests/test_torch_gn_small.py's case with edge and node MLPs of
    ``n_layers`` Dense layers, an RMSNorm tail when ``norm``; a folded
    encoder of 4 layers with the block's norm flag, as JAX's kernels
    read it."""
    c = case(layout, h, variant, seed, extra=extra)
    rng = np.random.default_rng(seed + 500)
    c["ep"] = np_mlp_params(rng, 3 * h, h, h, n_layers, norm)
    c["np_"] = np_mlp_params(rng, 2 * h, h, h, n_layers, norm)
    if c["enc"] is not None:
        c["enc"] = np_mlp_params(rng, FE, h, h, 4, norm)
    c["norm"] = norm
    return c


def _pallas(c):
    """JAX's Pallas kernel of the case's layout in interpret mode, with the
    case's ``layer_norm``, as f(x, e, enc, ep, np_, extra)."""
    fused = j_fused_nk if c["layout"] == "nk" else j_fused

    def run(x, e, enc, ep, np_, extra=None):
        return fused(x, e, ep, np_, c["jt"], activation=c["act"], layer_norm=c["norm"],
                     interpret=True, edge_encoder_params=enc, last_block=c["last"],
                     extra_agg=extra)
    return run


def check_depth_against_pallas(c, seed):
    """The wrapper's bf16 CPU path (no launch) against the Pallas kernel in
    interpret mode: outputs and gradients within the JAX suite's 0.05."""
    counts = (fused_gn_block_nk.launches, fused_gn_block_nk.backward_launches,
              fused_gn_block_csr.launches, fused_gn_block_csr.backward_launches)
    tx, te = _port_out(c, fused_gn_block_nk, fused_gn_block_csr, torch.bfloat16)
    jextra = None if c["extra"] is None else jnp.asarray(c["extra"], jnp.bfloat16)
    jx, je = _pallas(c)(jnp.asarray(c["x"], jnp.bfloat16), jnp.asarray(c["e_jax"], jnp.bfloat16),
                        c["enc"], c["ep"], c["np_"], jextra)
    np.testing.assert_allclose(tx.float().numpy(), np.asarray(jx, np.float32), rtol=0.05,
                               atol=0.05)
    if not c["last"]:
        np.testing.assert_allclose(_edges(c, te, True), _edges(c, je, False), rtol=0.05,
                                   atol=0.05)
    got, want, names = grads(c, cotangents(c, seed), _pallas(c), jnp.bfloat16,
                             _port_fn(c, fused_gn_block_nk, fused_gn_block_csr), torch.bfloat16)
    assert counts == (fused_gn_block_nk.launches, fused_gn_block_nk.backward_launches,
                      fused_gn_block_csr.launches, fused_gn_block_csr.backward_launches)
    check_grads(c, got, want, names, 0.05)


#: (depth, norm, hidden, layout): every depth with and without the norm,
#: at both widths and in both layouts
PALLAS_CASES = [(d, norm, h, layout)
                for i, d in enumerate(DEPTHS)
                for norm, h, layout in (((True, 32, "nk"), (False, 8, "csr")) if i % 2 == 0
                                        else ((True, 8, "csr"), (False, 32, "nk")))]


@pytest.mark.parametrize("depth,norm,hidden,layout", PALLAS_CASES)
def test_middle_block_matches_pallas_interpret_bf16(depth, norm, hidden, layout):
    check_depth_against_pallas(depth_case(layout, hidden, "middle", 11, depth, norm), seed=12)


@pytest.mark.parametrize("depth,norm,hidden,layout", [
    (2, False, 8, "nk"), (5, True, 32, "csr"), (8, False, 32, "csr"), (3, True, 8, "nk")])
def test_other_depths_on_the_other_layout_bf16(depth, norm, hidden, layout):
    check_depth_against_pallas(depth_case(layout, hidden, "last", 13, depth, norm), seed=14)


@pytest.mark.parametrize("depth,norm,layout", [(2, False, "nk"), (5, True, "csr")])
def test_folded_block_matches_pallas_interpret_bf16(depth, norm, layout):
    check_depth_against_pallas(depth_case(layout, 8, "folded", 15, depth, norm), seed=16)


@pytest.mark.parametrize("depth,norm,layout", [(2, False, "csr"), (5, True, "nk")])
def test_world_seam_matches_pallas_interpret_bf16(depth, norm, layout):
    check_depth_against_pallas(depth_case(layout, 8, "middle", 17, depth, norm, extra=True),
                               seed=18)


@pytest.mark.parametrize("norm", [True, False])
@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("hidden", [64, 128])
def test_plain_block_matches_jax_xla_block_fp32(hidden, depth, norm):
    g = tiny_graph(nx=6, ny=5)
    rng = np.random.default_rng(depth + 10 * norm)
    n, e, b = g.x.shape[0], g.senders.shape[0], 2
    x = rng.normal(size=(n, b, hidden)).astype(np.float32)
    ea = rng.normal(size=(e, b, hidden)).astype(np.float32)
    params = {"edge_block": np_mlp_params(rng, 3 * hidden, hidden, hidden, depth, norm),
              "node_block": np_mlp_params(rng, 2 * hidden, hidden, hidden, depth, norm)}
    jx, je = jlayers.GraphNetBlock(hidden_size=hidden, nb_of_layers=depth,
                                   layer_norm=norm).apply(
        {"params": params}, jnp.asarray(x), jnp.asarray(ea), jnp.asarray(g.senders),
        jnp.asarray(g.receivers), jnp.asarray(g.edge_mask))
    block = GraphNetBlock(hidden, nb_of_layers=depth, layer_norm=norm)
    load_mlp(block.edge_block, params["edge_block"])
    load_mlp(block.node_block, params["node_block"])
    with torch.no_grad():
        tx, te = block(t(x), t(ea), t(g.senders), t(g.receivers), t(g.edge_mask))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-5, atol=1e-5)


def with_block_depth(model, nb_of_layers, layer_norm):
    """``model``'s processor blocks rebuilt as GraphNetBlocks of
    ``nb_of_layers`` Dense layers and ``layer_norm`` (new weights), in
    place: what an ``epd`` whose blocks were built so holds."""
    for i, blk in enumerate(model.processor_list):
        model.processor_list[i] = GraphNetBlock(
            blk.hidden_size, nb_of_layers=nb_of_layers, layer_norm=layer_norm,
            is_last_block=blk.is_last_block, dtype=blk.dtype, activation=blk.activation)
    return model


def _jax_epd(params, graph, n_blocks, hidden, depth):
    """JAX's EncodeProcessDecode forward (processors.py:73-193) with its
    blocks built as GraphNetBlock(hidden, nb_of_layers=depth): JAX's
    ``epd`` passes no depth to its blocks, so its modules are composed
    here as it composes them."""
    x = FlaxMLP(hidden_size=hidden, out_size=hidden).apply(
        {"params": params["nodes_encoder"]}, graph.x)
    e = FlaxMLP(hidden_size=hidden, out_size=hidden).apply(
        {"params": params["edges_encoder"]}, graph.edge_attr)
    for i in range(n_blocks):
        x, e = jlayers.GraphNetBlock(hidden_size=hidden, nb_of_layers=depth,
                                     is_last_block=i == n_blocks - 1).apply(
            {"params": params[f"block_{i}"]}, x, e, graph.senders, graph.receivers,
            graph.edge_mask)
    out_size = params["decode_module"]["Dense_3"]["bias"].shape[0]
    return FlaxMLP(hidden_size=hidden, out_size=out_size, layer_norm=False).apply(
        {"params": params["decode_module"]}, x)


def test_epd_with_three_layer_blocks_matches_jax_fp32():
    """A 2-block ``epd`` at hidden 64 whose blocks have 3 Dense layers: the
    port's model forward against JAX's composition within 1e-4, on the
    inputs the port's simulator hands its model, weights from JAX's
    ``convert_state_dict`` of the port's."""
    hidden, n_blocks = 64, 2
    _, tg, _, _ = _packed_graphs(nk=False)
    sim = entry.make_simulator(hidden, n_blocks, torch.float32, None, seed=4)
    with_block_depth(sim.model, 3, True)
    torch.manual_seed(5)
    for p in sim.model.parameters():  # the new blocks' weights drawn from a seed
        p.data.normal_(0.0, 0.2)
    param = {"model": dict(PARAM["model"], hidden_size=hidden, message_passing_num=n_blocks)}
    params, _ = convert_state_dict(
        {k: v.detach().numpy().copy() for k, v in sim.state_dict().items()}, param)
    assert sorted(params["params"]["block_0"]["edge_block"]) == ["Dense_0", "Dense_1", "Dense_2",
                                                                 "RMSNorm_0"]
    with torch.no_grad():
        g = _model_inputs(sim, tg)
        got = sim.model(g).numpy()
    jgraph = SimpleNamespace(**{k: jnp.asarray(getattr(g, k).numpy()) for k in (
        "x", "edge_attr", "senders", "receivers", "edge_mask")})
    want = _jax_epd(params["params"], jgraph, n_blocks, hidden, 3)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)


def _model_inputs(sim, graph):
    """The graph as the simulator hands it to its model (normalized node
    and edge features)."""
    captured = {}

    def grab(module, args):
        captured["graph"] = args[0]
    handle = sim.model.register_forward_pre_hook(grab)
    try:
        sim.forward(graph, is_training=False)
    finally:
        handle.remove()
    return captured["graph"]


def test_weight_bridge_both_ways_on_two_layer_norm_free_blocks():
    """A port ``epd`` whose blocks have 2 Dense layers and no RMSNorm:
    JAX's ``convert_state_dict`` gives each block's MLPs ``Dense_0``,
    ``Dense_1`` and no ``RMSNorm_0``; ``load_jax_params`` puts them into a
    model of the same shape with other weights, bit for bit."""
    _, tg, _, _ = _packed_graphs(nk=False)
    sims = []
    for seed in (6, 7):
        sim = entry.make_simulator(32, 2, torch.float32, None, seed=seed)
        with_block_depth(sim.model, 2, False)
        torch.manual_seed(seed)
        for p in sim.model.parameters():
            p.data.normal_(0.0, 0.2)
        sim.prepare(tg, is_training=True)
        sims.append(sim)
    param = {"model": dict(PARAM["model"], hidden_size=32, message_passing_num=2)}
    params, state = convert_state_dict(
        {k: v.detach().numpy().copy() for k, v in sims[0].state_dict().items()}, param)
    for i in range(2):
        for name in ("edge_block", "node_block"):
            assert sorted(params["params"][f"block_{i}"][name]) == ["Dense_0", "Dense_1"]
    load_jax_params(sims[1], _to_np(params), _to_np(state))
    want, got = sims[0].state_dict(), sims[1].state_dict()
    assert want.keys() == got.keys()
    for k in want:
        assert torch.equal(want[k], got[k]), k


@pytest.mark.parametrize("hidden", nk_ops.KERNEL_HIDDEN)
def test_check_kernel_mlps_takes_every_depth_and_either_tail(hidden):
    for depth in range(1, nk_ops.KERNEL_MAX_LAYERS + 1):
        for norm in (True, False):
            edge = MLP(3 * hidden, hidden, hidden, nb_of_layers=depth, layer_norm=norm)
            node = MLP(2 * hidden, hidden, hidden, nb_of_layers=depth, layer_norm=norm)
            enc = MLP(FE, hidden, hidden, nb_of_layers=9 - depth, layer_norm=not norm)
            for backward in (False, True):
                nk_ops.check_kernel_mlps(hidden, (None, edge, node), backward, hidden)
                if FE <= hidden:  # the kernels take raw features no wider than hidden
                    nk_ops.check_kernel_mlps(hidden, (enc, edge, node), backward, FE)
    deep = MLP(3 * hidden, hidden, hidden, nb_of_layers=9)
    with pytest.raises(NotImplementedError, match="1 to 8 Dense layers"):
        nk_ops.check_kernel_mlps(hidden, (None, deep, node), False, hidden)


def test_graphnetblock_depth_and_norm_reach_both_mlps_and_the_kernels():
    blk = GraphNetBlock(8, nb_of_layers=3, layer_norm=False, activation="silu")
    assert (blk.nb_of_layers, blk.layer_norm) == (3, False)
    for mlp, width in ((blk.edge_block, 24), (blk.node_block, 16)):
        assert [d.weight.shape[1] for d in mlp.denses] == [width, 8, 8]
        assert mlp.norm is None and mlp.activation == "silu"
    default = GraphNetBlock(8)
    assert len(default.edge_block.denses) == len(default.node_block.denses) == 4
    assert default.edge_block.norm is not None and default.node_block.norm is not None
    args = nk_ops.mlp_args((None, blk.edge_block, default.node_block))
    assert args[4::3] == [3, 4]
    assert args[3]._length_ == 2 * 3 + 1 and args[3][-1] is None  # no scale: a null pointer
