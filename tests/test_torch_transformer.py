"""The port's graph transformer against the JAX package, on the CPU.

  * ``Attention`` (single frame and packed, with and without spatial RoPE
    and the sigmoid gate, over edges and dense) and ``TransformerBlock``
    match flax in fp32 to 1e-5;
  * a Simulator around ``EncodeTransformDecode`` (``edge_input_size=0``)
    matches the JAX Simulator's eval forward in fp32 to 1e-4, packed and
    single frame (errors compound through normalizers and two blocks);
  * the bf16 NK path (both kernels' plain versions) matches the JAX
    model's fused path (Pallas in interpret mode) at rtol = atol = 0.1 on
    the valid nodes (tests/test_fused_edge_attention_nk.py:171);
  * the ``transformer`` case of tests/golden_values.json, at the golden
    test's tolerances;
  * the weight bridge both ways, through the head permutation;
  * ``entry.transformer_setup`` runs on the CPU, forward and rollout.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_physics_tpu.models import layers as jlayers
from graph_physics_tpu.models.processors import EncodeTransformDecode as JETD
from graph_physics_tpu.models.simulator import Simulator as JSim
from graph_physics_tpu.ops import tiling as jtiling
from graph_physics_tpu.ops.fused_edge_attention_nk import build_nk_tiling as j_build_nk
from graph_physics_tpu.training import packed as jpacked
from graph_physics_tpu.utils.convert import convert_state_dict
from graph_physics_tpu_torch import entry
from graph_physics_tpu_torch.core.graph import MeshGraph
from graph_physics_tpu_torch.models import layers as tlayers
from graph_physics_tpu_torch.models.processors import EncodeTransformDecode
from graph_physics_tpu_torch.ops import tiling as ttiling
from graph_physics_tpu_torch.ops.fused_edge_attention_nk import fused_edge_attention_nk
from graph_physics_tpu_torch.ops.fused_ffn import fused_gated_ffn
from graph_physics_tpu_torch.training import packed as tpacked
from graph_physics_tpu_torch.training.rollout import make_batched_rollout_fn
from graph_physics_tpu_torch.utils.convert import load_attention, load_gated_mlp, load_jax_params
from tests.helpers import tiny_graph
from tests.test_torch_fused_gnblock_nk import _port_host_graph

H, HEADS, B = 64, 4, 3
TOL = dict(rtol=1e-5, atol=1e-5)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _perturb(params, seed):
    """Non-trivial scales and biases (flax initialises them to 1 and 0)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: a + 0.1 * rng.normal(size=a.shape).astype(np.float32), params)


def _graph_inputs(packed, seed=0):
    g = tiny_graph(nx=14, ny=10)
    rng = np.random.default_rng(seed)
    lead = (g.x.shape[0], B) if packed else (g.x.shape[0],)
    x = rng.normal(size=lead + (H,)).astype(np.float32)
    return g, x


def _edge_args(g, dense):
    """(senders, receivers, edge_mask, node_mask, pos), numpy."""
    s, r, m = (None, None, None) if dense else (g.senders, g.receivers, g.edge_mask)
    return s, r, m, g.node_mask, g.pos


def _as(arrs, fn):
    return [None if a is None else fn(a) for a in arrs]


ATTENTION_CASES = [  # (packed, rope, gate, dense)
    (False, False, False, False), (True, False, False, False), (False, True, False, False),
    (True, True, True, False), (False, False, True, False), (True, False, False, True),
]


@pytest.mark.parametrize("packed,rope,gate,dense", ATTENTION_CASES)
def test_attention_matches_flax(packed, rope, gate, dense):
    g, x = _graph_inputs(packed, seed=1)
    args = _edge_args(g, dense)
    kw = dict(hidden_size=H, num_heads=HEADS, use_rope_embeddings=rope, use_gated_attention=gate)
    mod = jlayers.Attention(**kw)
    jargs = _as(args, jnp.asarray)
    params = _perturb(_np_tree(mod.init(jax.random.PRNGKey(2), jnp.asarray(x), *jargs)["params"]),
                      seed=3)
    want = mod.apply({"params": params}, jnp.asarray(x), *jargs)
    port = tlayers.Attention(H, HEADS, use_rope_embeddings=rope, use_gated_attention=gate)
    load_attention(port, params, "attention")
    with torch.no_grad():
        got = port(torch.as_tensor(x), *_as(args, torch.as_tensor))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("dense", [False, True])
def test_attention_weights_match_flax(dense):
    """``return_attention``: per-edge weights [E, H], or dense [H, N, N]."""
    g, x = _graph_inputs(packed=False, seed=7)
    args = _edge_args(g, dense)
    mod = jlayers.Attention(hidden_size=H, num_heads=HEADS)
    jargs = _as(args, jnp.asarray)
    params = _perturb(_np_tree(mod.init(jax.random.PRNGKey(8), jnp.asarray(x), *jargs)["params"]),
                      seed=9)
    want, want_w = mod.apply({"params": params}, jnp.asarray(x), *jargs, return_attention=True)
    port = tlayers.Attention(H, HEADS)
    load_attention(port, params, "attention")
    with torch.no_grad():
        got, got_w = port(torch.as_tensor(x), *_as(args, torch.as_tensor), return_attention=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), **TOL)


@pytest.mark.parametrize("packed", [False, True])
def test_transformer_block_matches_flax(packed):
    g, x = _graph_inputs(packed, seed=4)
    args = _edge_args(g, dense=False)
    mod = jlayers.TransformerBlock(hidden_size=H, num_heads=HEADS)
    jargs = _as(args, jnp.asarray)
    params = _perturb(_np_tree(mod.init(jax.random.PRNGKey(5), jnp.asarray(x), *jargs)["params"]),
                      seed=6)
    want = mod.apply({"params": params}, jnp.asarray(x), *jargs)
    port = tlayers.TransformerBlock(H, HEADS)
    with torch.no_grad():
        port.norm1.scale.copy_(torch.as_tensor(params["norm1"]["scale"]))
        port.norm2.scale.copy_(torch.as_tensor(params["norm2"]["scale"]))
    load_attention(port.attention, params["attention"], "attention")
    load_gated_mlp(port.gated_mlp, params["gated_mlp"])
    with torch.no_grad():
        got = port(torch.as_tensor(x), *_as(args, torch.as_tensor))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


KW = dict(message_passing_num=2, node_input_size=11, output_size=2, hidden_size=H,
          num_heads=HEADS)


def _jax_sim(model):
    return JSim(node_input_size=11, edge_input_size=0, output_size=2, feature_index_start=0,
                feature_index_end=2, output_index_start=0, output_index_end=2,
                node_type_index=2, model=model)


def _jax_setup(jgraph, model_kwargs, seed=0):
    """JAX Simulator, its params and normalizer statistics accumulated over
    ``jgraph`` (standing in for a checkpoint's state)."""
    sim = _jax_sim(JETD(**model_kwargs))
    g = jax.tree.map(jnp.asarray, jgraph)
    params = _perturb(_np_tree(sim.init_params(jax.random.PRNGKey(seed), g)), seed + 1)
    _, _, _, state = sim.prepare(sim.init_state(), g, is_training=True)
    return sim, g, params, _np_tree(state)


def _port_sim(params, state, dtype=torch.float32, tiling=None):
    sim = entry.make_transformer_simulator(H, 2, HEADS, dtype, tiling, seed=9)
    load_jax_params(sim, params, state)
    return sim


def _frames(count=4):
    return [tiny_graph(nx=14, ny=10, frame=f) for f in range(count)]


@pytest.mark.parametrize("packed", [False, True])
def test_simulator_eval_forward_fp32_matches_jax(packed):
    frames = _frames()
    if packed:
        jgraph = jpacked.pack(jax.tree.map(lambda *xs: np.stack(xs), *frames))
        tgraph = tpacked.pack(tpacked.stack([_port_host_graph(f) for f in frames]))
    else:
        jgraph, tgraph = frames[0], _port_host_graph(frames[0])
    jsim, g, params, state = _jax_setup(jgraph, KW)
    jout = jsim.forward(params, state, g, is_training=False)
    tout = _port_sim(params, state).forward(MeshGraph.from_numpy(tgraph, "cpu"),
                                            is_training=False)
    for name in ("net_out", "target_norm", "outputs"):
        np.testing.assert_allclose(getattr(tout, name).numpy(),
                                   np.asarray(getattr(jout, name)), rtol=1e-4, atol=1e-4,
                                   err_msg=name)


def test_bf16_nk_path_matches_jax_fused_path(monkeypatch):
    """Built as tests/test_fused_edge_attention_nk.py:128-171 builds it: the
    JAX model on the blocked-CSR graph with both tilings (its attention on
    the NK kernel, its FFN on the fused kernel), the port on the NK slot
    layout of the same mesh; same params, same padded packed x."""
    g = tiny_graph(nx=14, ny=10)
    args = (np.asarray(g.senders), np.asarray(g.receivers), int(g.n_node))
    t = jtiling.build_edge_tiling(*args, edge_mask=np.asarray(g.edge_mask), node_block=128)
    t_nk = j_build_nk(*args, edge_mask=np.asarray(g.edge_mask), node_block=128)
    tt = ttiling.build_nk_tiling(*args, edge_mask=np.asarray(g.edge_mask))
    assert t_nk is not None and t_nk.num_nodes == t.num_nodes == tt.num_nodes

    b, n0, n_t = 2, g.x.shape[0], t.num_nodes
    x0 = (0.5 * np.random.default_rng(4).normal(size=(n0, b, 4))).astype(np.float32)
    x_t = np.zeros((n_t, b, 4), np.float32)
    x_t[:min(n0, n_t)] = x0[:min(n0, n_t)]
    gt = jax.tree.map(jnp.asarray, jtiling.apply_to_graph(g, t)).replace(
        x=jnp.asarray(x_t), tiling_idx=None)
    kwargs = dict(message_passing_num=2, node_input_size=4, output_size=2, hidden_size=H,
                  num_heads=HEADS)
    m_xla = JETD(dtype=jnp.float32, **kwargs)
    m_nk = JETD(edge_tiling=t, edge_tiling_nk=t_nk, dtype=jnp.bfloat16, **kwargs)
    gp = jax.tree.map(jnp.asarray, g).replace(x=jnp.asarray(x0))
    params = _perturb(_np_tree(m_xla.init(jax.random.PRNGKey(1), gp)), seed=2)
    want = np.asarray(m_nk.apply(params, gt), np.float32)

    port = EncodeTransformDecode(2, 4, 2, hidden_size=H, num_heads=HEADS, tiling=tt,
                                 dtype=torch.bfloat16)
    sim = entry._simulator(port, 0, seed=0)  # only its model is used
    state = _np_tree(_jax_sim(m_xla).init_state())
    load_jax_params(sim, params, state)
    tg = MeshGraph.from_numpy(ttiling.apply_to_graph_nk(_port_host_graph(g), tt), "cpu")
    tg = tg.replace(x=torch.as_tensor(x_t))
    calls = []  # the blocks reach both kernels' wrappers
    for name in ("fused_edge_attention_nk", "fused_gated_ffn"):
        fn = getattr(tlayers, name)
        monkeypatch.setattr(tlayers, name,
                            lambda *a, _fn=fn, _name=name: calls.append(_name) or _fn(*a))
    before = (fused_edge_attention_nk.launches, fused_gated_ffn.launches)
    with torch.no_grad():
        got = port(tg).numpy()
    assert sorted(calls) == ["fused_edge_attention_nk"] * 2 + ["fused_gated_ffn"] * 2
    assert (fused_edge_attention_nk.launches, fused_gated_ffn.launches) == before
    n_real = int(g.n_node)
    np.testing.assert_allclose(got[:n_real], want[:n_real], rtol=0.1, atol=0.1)


def test_golden_transformer_case():
    """The JAX suite's committed transformer fingerprint
    (tests/golden_values.json: PRNGKey(0) weights, fresh normalizers)
    through the port, at the JAX golden test's own tolerances."""
    from tests.test_golden import GOLDEN_PATH, _cases

    g, cases = _cases()
    jsim = cases["transformer"]
    params = jsim.init_params(jax.random.PRNGKey(0), g)
    tsim = entry.make_transformer_simulator(16, 2, 4, torch.float32, None, seed=0)
    load_jax_params(tsim, _np_tree(params), _np_tree(jsim.init_state()))
    host = jax.tree.map(np.asarray, g)
    out = tsim.forward(MeshGraph.from_numpy(_port_host_graph(host), "cpu"), is_training=False)
    v = out.net_out.double().numpy()[np.asarray(host.node_mask)]
    with open(GOLDEN_PATH) as f:
        want = json.load(f)["transformer"]
    np.testing.assert_allclose(v.sum(), want["sum"], rtol=2e-3, atol=1e-4)
    np.testing.assert_allclose(np.abs(v).sum(), want["abs_sum"], rtol=2e-3)
    np.testing.assert_allclose(v[0], want["first_row"], rtol=2e-3, atol=1e-4)
    np.testing.assert_allclose(v[-1], want["last_row"], rtol=2e-3, atol=1e-4)


PARAM = {"model": {"type": "transformer", "message_passing_num": 2, "node_input_size": 2,
                   "edge_input_size": 0, "output_size": 2, "hidden_size": H,
                   "num_heads": HEADS}}


def _tree_equal(a, b):
    la, lb = jax.tree_util.tree_leaves_with_path(a), jax.tree_util.tree_leaves_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=str(path))


@pytest.mark.parametrize("gate", [False, True])
def test_weight_bridge_both_ways(gate):
    """JAX params -> load_jax_params -> port state_dict -> convert_state_dict
    gives the same flax tree back (a wrong head permutation would permute
    the q/k/v columns); and port state -> JAX -> port is exact."""
    frames = _frames(2)
    jgraph = jpacked.pack(jax.tree.map(lambda *xs: np.stack(xs), *frames))
    _, _, params, state = _jax_setup(jgraph, dict(KW, use_gated_attention=gate), seed=3)
    model = EncodeTransformDecode(2, 11, 2, hidden_size=H, num_heads=HEADS,
                                  use_gated_attention=gate)
    sim = entry._simulator(model, 0, seed=5)
    load_jax_params(sim, params, state)
    sd = sim.state_dict()
    assert "model.processor_list.1.gated_mlp.1.linear2.weight" in sd
    assert ("model.processor_list.0.attention.gate_proj.weight" in sd) == gate
    param = {"model": dict(PARAM["model"], use_gated_attention=gate)}
    back, back_state = convert_state_dict({k: v.numpy() for k, v in sd.items()}, param)
    _tree_equal(_np_tree(back), params)
    np.testing.assert_array_equal(np.asarray(back_state.node_norm.acc_sum),
                                  state.node_norm.acc_sum)

    other = entry._simulator(EncodeTransformDecode(2, 11, 2, hidden_size=H, num_heads=HEADS,
                                                   use_gated_attention=gate), 0, seed=6)
    load_jax_params(other, _np_tree(back), _np_tree(back_state))
    got = other.state_dict()
    assert sorted(got) == sorted(sd)
    for k in sd:
        assert torch.equal(got[k], sd[k]), k


def test_entry_transformer_setup_runs_on_cpu():
    setup = entry.transformer_setup(device="cpu", nx=14, ny=10, batch=4, mp_steps=2,
                                    num_steps=6)
    g, nk = setup.graph, setup.tiling
    assert g.x.shape == (nk.num_nodes, 4, 4) and g.senders.shape == (nk.total_rows,)
    assert setup.simulator.edge_input_size is None
    model = setup.simulator.model
    assert (len(model.processor_list), model.hidden_size) == (2, H)
    before = (fused_edge_attention_nk.launches, fused_gated_ffn.launches)
    out = setup.simulator.forward(g, is_training=False)
    assert out.outputs.shape == (nk.num_nodes, 4, 2) and out.outputs.dtype == torch.float32
    assert torch.isfinite(out.outputs).all()
    res = make_batched_rollout_fn(setup.simulator)(entry.rollout_frames(setup, [0, 1], 3))
    assert res.predictions.shape == (3, nk.num_nodes, 2, 2)
    assert torch.isfinite(res.rmse_all_rollout).all()
    assert (fused_edge_attention_nk.launches, fused_gated_ffn.launches) == before


def test_unported_options_raise():
    for kw in (dict(use_multigrid=True), dict(use_temporal_block=True), dict(remat=True),
               dict(sp_axis_name="sp")):
        with pytest.raises(NotImplementedError):
            EncodeTransformDecode(2, 11, 2, hidden_size=H, **kw)
