"""The port's host data path, Simulator and weight bridge against the JAX package.

  * synthetic trajectories, mesh graphs and packed batches are identical;
  * the packed and single-frame eval forward in fp32 matches the JAX
    Simulator to 1e-4 (a 2-block model whose errors compound through
    normalizers and five MLPs; fp32 sums in another order);
  * the bf16 NK path (folded encoder, last-block elision) matches the JAX
    NK fused path, Pallas in interpret mode, to rtol = atol = 0.15 on the
    valid nodes (the JAX suite's bound for NK vs XLA);
  * port state_dict -> JAX convert_state_dict -> load_jax_params is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_physics_tpu.core import mesh as jmesh
from graph_physics_tpu.dataset import synthetic as jsynth
from graph_physics_tpu.models.processors import EncodeProcessDecode as JEPD
from graph_physics_tpu.models.simulator import Simulator as JSim
from graph_physics_tpu.ops import tiling as jtiling
from graph_physics_tpu.ops.fused_edge_attention_nk import build_nk_tiling as j_build_nk
from graph_physics_tpu.training import packed as jpacked
from graph_physics_tpu.utils.convert import convert_state_dict
from graph_physics_tpu_torch import entry
from graph_physics_tpu_torch.core import mesh as tmesh
from graph_physics_tpu_torch.core.graph import MeshGraph
from graph_physics_tpu_torch.dataset import synthetic as tsynth
from graph_physics_tpu_torch.ops import tiling as ttiling
from graph_physics_tpu_torch.ops.fused_gnblock_nk import fused_gn_block_nk
from graph_physics_tpu_torch.training import packed as tpacked
from graph_physics_tpu_torch.utils.convert import load_jax_params
from tests.helpers import tiny_graph
from tests.test_torch_fused_gnblock_nk import _port_host_graph

FIELDS = ("x", "pos", "node_type", "node_mask", "senders", "receivers", "edge_mask",
          "edge_attr", "y")
PARAM = {"model": {"type": "epd", "message_passing_num": 2, "node_input_size": 2,
                   "edge_input_size": 3, "output_size": 2, "hidden_size": 32}}


def _assert_fields_equal(tg, jg):
    for name in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(tg, name)),
                                      np.asarray(getattr(jg, name)), err_msg=name)


def test_synthetic_and_mesh_builders_match_jax():
    traj_t = tsynth.make_trajectory(14, 10, num_steps=4)
    traj_j = jsynth.make_trajectory(14, 10, num_steps=4)
    for k in traj_j:
        np.testing.assert_array_equal(traj_t[k], traj_j[k], err_msg=k)
    pos, cells = traj_t["mesh_pos"][0], traj_t["cells"][0]
    np.testing.assert_array_equal(tmesh.faces_to_edges(cells, len(pos)),
                                  jmesh.faces_to_edges(cells, len(pos)))
    nt = traj_t["node_type"][0, :, 0]
    x = np.concatenate([traj_t["velocity"][0], nt[:, None].astype(np.float32)], axis=-1)
    ei = tmesh.faces_to_edges(cells, len(pos))
    tg = tmesh.build_mesh_graph(x, pos, nt, ei, y=traj_t["velocity"][1])
    jg = jmesh.build_mesh_graph(x, pos, nt, ei, y=traj_t["velocity"][1])
    _assert_fields_equal(tg, jg)
    assert tg.n_node == int(jg.n_node)


def _frames(nx=14, ny=10, count=4):
    return [tiny_graph(nx=nx, ny=ny, frame=f) for f in range(count)]


def test_pack_matches_jax():
    frames = _frames()
    jp = jpacked.pack(jax.tree.map(lambda *xs: np.stack(xs), *frames))
    tp = tpacked.pack(tpacked.stack([_port_host_graph(f) for f in frames]))
    _assert_fields_equal(tp, jp)
    assert tp.x.flags["C_CONTIGUOUS"]
    x = torch.arange(24.0).view(2, 3, 4)
    assert torch.equal(tpacked.unpack_nodes(x), x.movedim(0, 1))


def _jax_sim(model):
    return JSim(node_input_size=11, edge_input_size=3, output_size=2, feature_index_start=0,
                feature_index_end=2, output_index_start=0, output_index_end=2,
                node_type_index=2, model=model)


def _jax_setup(jgraph, model_kwargs):
    """JAX Simulator, its params and normalizer statistics accumulated over
    ``jgraph`` (standing in for a checkpoint's state)."""
    sim = _jax_sim(JEPD(**model_kwargs))
    g = jax.tree.map(jnp.asarray, jgraph)
    params = sim.init_params(jax.random.PRNGKey(0), g)
    _, _, _, state = sim.prepare(sim.init_state(), g, is_training=True)
    return sim, g, params, state


def _to_np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_sim(params, state, dtype=torch.float32, tiling=None):
    sim = entry.make_simulator(32, 2, dtype, tiling, seed=9)
    load_jax_params(sim, _to_np(params), _to_np(state))
    return sim


KW = dict(message_passing_num=2, node_input_size=11, edge_input_size=3, output_size=2,
          hidden_size=32)


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
    tsim = _port_sim(params, state)
    tout = tsim.forward(MeshGraph.from_numpy(tgraph, "cpu"), is_training=False)
    for name in ("net_out", "target_norm", "outputs"):
        np.testing.assert_allclose(getattr(tout, name).numpy(),
                                   np.asarray(getattr(jout, name)), rtol=1e-4, atol=1e-4,
                                   err_msg=name)

    # the port's own accumulation reproduces the JAX statistics
    fresh = entry.make_simulator(32, 2, torch.float32, None, seed=9)
    fresh.prepare(MeshGraph.from_numpy(tgraph, "cpu"), is_training=True)
    for norm, js in ((fresh._output_normalizer, state.output_norm),
                     (fresh._node_normalizer, state.node_norm),
                     (fresh._edge_normalizer, state.edge_norm)):
        np.testing.assert_allclose(norm._acc_sum.numpy(), np.asarray(js.acc_sum),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(norm._acc_sum_squared.numpy(), np.asarray(js.acc_sum_sq),
                                   rtol=1e-5, atol=1e-5)
        assert float(norm._acc_count) == float(js.acc_count)


def test_simulator_bf16_nk_path_matches_jax_fused():
    frames = _frames()
    n = frames[0].x.shape[0]
    args = (np.asarray(frames[0].senders), np.asarray(frames[0].receivers), n)
    jt = j_build_nk(*args, edge_mask=np.asarray(frames[0].edge_mask), node_block=128)
    tt = ttiling.build_nk_tiling(*args, edge_mask=np.asarray(frames[0].edge_mask))
    jgraph = jpacked.pack(jax.tree.map(lambda *xs: np.stack(xs),
                                       *[jtiling.apply_to_graph_nk(f, jt) for f in frames]))
    tgraph = tpacked.pack(tpacked.stack(
        [ttiling.apply_to_graph_nk(_port_host_graph(f), tt) for f in frames]))
    jsim, g, params, state = _jax_setup(jgraph, dict(KW, dtype=jnp.bfloat16,
                                                     edge_tiling_nk=jt))
    jout = jsim.forward(params, state, g, is_training=False)
    tsim = _port_sim(params, state, torch.bfloat16, tt)
    before = fused_gn_block_nk.launches
    tout = tsim.forward(MeshGraph.from_numpy(tgraph, "cpu"), is_training=False)
    assert fused_gn_block_nk.launches == before
    rows = np.asarray(tgraph.node_mask)
    np.testing.assert_allclose(tout.net_out.numpy()[rows], np.asarray(jout.net_out)[rows],
                               rtol=0.15, atol=0.15)
    np.testing.assert_allclose(tout.outputs.numpy()[rows], np.asarray(jout.outputs)[rows],
                               rtol=0.15, atol=0.15)


def test_golden_epd_case():
    """The JAX suite's committed epd fingerprint (tests/golden_values.json:
    PRNGKey(0) weights, fresh normalizers) through the port, at the JAX
    golden test's own tolerances."""
    import json

    from tests.test_golden import GOLDEN_PATH, _cases

    g, cases = _cases()
    jsim = cases["epd"]
    params = jsim.init_params(jax.random.PRNGKey(0), g)
    tsim = entry.make_simulator(16, 2, torch.float32, None, seed=0)
    load_jax_params(tsim, _to_np(params), _to_np(jsim.init_state()))
    host = jax.tree.map(np.asarray, g)
    out = tsim.forward(MeshGraph.from_numpy(_port_host_graph(host), "cpu"), is_training=False)
    v = out.net_out.double().numpy()[np.asarray(host.node_mask)]
    with open(GOLDEN_PATH) as f:
        want = json.load(f)["epd"]
    np.testing.assert_allclose(v.sum(), want["sum"], rtol=2e-3, atol=1e-4)
    np.testing.assert_allclose(np.abs(v).sum(), want["abs_sum"], rtol=2e-3)
    np.testing.assert_allclose(v[0], want["first_row"], rtol=2e-3, atol=1e-4)
    np.testing.assert_allclose(v[-1], want["last_row"], rtol=2e-3, atol=1e-4)


def test_weight_bridge_round_trip():
    setup = entry.cylinder_setup("cpu", nx=14, ny=10, hidden=32, mp_steps=2, batch=3,
                                 dtype=torch.float32, nk=False, seed=3)
    sd = setup.simulator.state_dict()
    assert float(sd["_output_normalizer._acc_count"]) > 0
    flat = {k: v.numpy() for k, v in sd.items()}
    params, state = convert_state_dict(flat, PARAM)  # raises on any unmapped tensor
    other = entry.make_simulator(32, 2, torch.float32, None, seed=4)
    load_jax_params(other, _to_np(params), _to_np(state))
    got = other.state_dict()
    assert sorted(got) == sorted(sd)
    for k in sd:
        assert torch.equal(got[k], sd[k]), k


def test_entry_setup_runs_on_cpu():
    setup = entry.cylinder_setup("cpu", nx=14, ny=10, batch=4)
    g = setup.graph
    assert g.x.shape == (setup.tiling.num_nodes, 4, 4)
    assert g.edge_attr.shape == (setup.tiling.total_rows, 4, 3)
    assert all(t.is_contiguous() for t in (g.x, g.edge_attr, g.senders, g.edge_mask))
    before = fused_gn_block_nk.launches
    out = setup.simulator.forward(g, is_training=False)
    assert fused_gn_block_nk.launches == before
    assert out.outputs.shape == (setup.tiling.num_nodes, 4, 2)
    assert out.outputs.dtype == torch.float32
    assert torch.isfinite(out.outputs).all()
