"""The port's graded-mesh inference path (CSR layout) against the JAX package.

On the 1,536-node graded test mesh, B=4 packed frames, 2 blocks, weights
carried across by utils/convert.load_jax_params, node outputs compared in
the original node order on the valid nodes:
  * ``epd`` in fp32 on the CSR-ordered graph (plain path) matches the JAX
    Simulator on the original edge list to 1e-4;
  * ``epd`` in bf16 on the CSR path (the folded encoder in block 0, the
    last-block elision; both plain versions) matches the JAX model with
    ``edge_tiling`` set (its Pallas kernel in interpret mode) to
    rtol = atol = 0.15, and the processor's fold decision is the block's;
  * the graph transformer model in bf16 on the CSR path (attention and
    gated FFN through their wrappers) matches the JAX model with
    ``edge_tiling`` set to rtol = atol = 0.1
    (tests/test_fused_edge_attention_nk.py:171), on 0.5-scale inputs as
    tests/test_torch_transformer.py holds the NK path;
  * a short rollout of ``entry.graded_setup`` / ``graded_transformer_setup``
    on the CSR path stays within 15% RMSE of the plain path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_physics_tpu.core import mesh as jmesh
from graph_physics_tpu.models.processors import EncodeTransformDecode as JETD
from graph_physics_tpu.ops import tiling as jtiling
from graph_physics_tpu.training import packed as jpacked
from graph_physics_tpu_torch import entry
from graph_physics_tpu_torch.core.graph import MeshGraph
from graph_physics_tpu_torch.dataset import synthetic
from graph_physics_tpu_torch.models import layers as tlayers
from graph_physics_tpu_torch.models.processors import EncodeTransformDecode
from graph_physics_tpu_torch.ops import tiling as ttiling
from graph_physics_tpu_torch.training import packed as tpacked
from graph_physics_tpu_torch.training.rollout import make_batched_rollout_fn
from graph_physics_tpu_torch.utils.convert import load_jax_params
from tests import test_torch_simulator as epd_case
from tests import test_torch_transformer as tf_case
from tests.test_torch_csr_layout import GRADED_NODES
from tests.test_torch_fused_gnblock_nk import _port_host_graph

_FRAMES = {}


def _frames(count=4):
    """JAX host frames 0..count-1 of the graded trajectory and its layouts."""
    if not _FRAMES:
        traj = synthetic.make_graded_trajectory(GRADED_NODES, num_steps=count + 1)
        pos, nt = traj["mesh_pos"][0], traj["node_type"][0, :, 0]
        ei = jmesh.faces_to_edges(traj["cells"][0], len(pos))
        frames = []
        for t in range(count):
            x = np.concatenate([traj["velocity"][t], nt[:, None].astype(np.float32),
                                np.full((len(pos), 1), 0.01 * t, np.float32)], axis=-1)
            frames.append(jmesh.build_mesh_graph(x, pos, nt, ei, y=traj["velocity"][t + 1]))
        g = frames[0]
        e = int(g.n_edge)
        args = (np.asarray(g.senders)[:e], np.asarray(g.receivers)[:e], int(g.n_node))
        _FRAMES.update(frames=frames, jt=jtiling.build_edge_tiling(*args),
                       tt=ttiling.build_csr_layout(*args))
    return _FRAMES


def _packed(jt=None, tt=None):
    """(JAX packed graph, port packed host graph), in the blocked and CSR
    layouts when given, else on the original edge list."""
    c = _frames()
    jf = [jtiling.apply_to_graph(f, jt).replace(tiling_idx=None) if jt is not None else f
          for f in c["frames"]]
    tf = [_port_host_graph(f) for f in c["frames"]]
    tf = [ttiling.apply_to_graph(f, tt) for f in tf] if tt is not None else tf
    return (jpacked.pack(jax.tree.map(lambda *xs: np.stack(xs), *jf)),
            tpacked.pack(tpacked.stack(tf)))


def _compare(tout, jout, rows, tol):
    for name in ("net_out", "outputs"):
        np.testing.assert_allclose(getattr(tout, name).numpy()[rows],
                                   np.asarray(getattr(jout, name))[rows], rtol=tol, atol=tol,
                                   err_msg=name)


def test_epd_fp32_on_csr_graph_matches_jax():
    c = _frames()
    jgraph, _ = _packed()
    _, tgraph = _packed(tt=c["tt"])
    jsim, g, params, state = epd_case._jax_setup(jgraph, epd_case.KW)
    jout = jsim.forward(params, state, g, is_training=False)
    tsim = epd_case._port_sim(params, state, torch.float32, c["tt"])
    tout = tsim.forward(MeshGraph.from_numpy(tgraph, "cpu"), is_training=False)
    _compare(tout, jout, slice(GRADED_NODES), 1e-4)


def test_epd_bf16_csr_path_matches_jax_fused(monkeypatch):
    c = _frames()
    jgraph, tgraph = _packed(c["jt"], c["tt"])
    jsim, g, params, state = epd_case._jax_setup(
        jgraph, dict(epd_case.KW, dtype=jnp.bfloat16, edge_tiling=c["jt"]))
    jout = jsim.forward(params, state, g, is_training=False)
    tsim = epd_case._port_sim(params, state, torch.bfloat16, c["tt"])
    calls = []  # (encoder folded, last block) of each CSR block call
    fn = tlayers.fused_gn_block_csr
    monkeypatch.setattr(tlayers, "fused_gn_block_csr", lambda *a, **kw: calls.append(
        (kw["encoder_params"] is not None, kw["last_block"])) or fn(*a, **kw))
    graph = MeshGraph.from_numpy(tgraph, "cpu")
    tout = tsim.forward(graph, is_training=False)
    assert calls == [(True, False), (False, True)]
    _compare(tout, jout, np.asarray(tgraph.node_mask), 0.15)

    block = tsim.model.processor_list[0]  # fold given where no fused path runs
    x = torch.zeros((c["tt"].num_nodes, 4, 32))
    with pytest.raises(ValueError, match="fused path does not apply"):
        block(x, graph.edge_attr, graph.senders, graph.receivers, graph.edge_mask,
              edge_encoder=tsim.model.edges_encoder)


def test_transformer_bf16_csr_path_matches_jax_fused(monkeypatch):
    """Built as tests/test_torch_transformer.py builds the NK case: the
    models alone on the same padded packed x (0.5-scale normals), the JAX
    model on the blocked-CSR graph with ``edge_tiling`` (its attention and
    FFN on the Pallas kernels), the port on the CSR layout."""
    c = _frames()
    jt, tt = c["jt"], c["tt"]
    jgraph, tgraph = _packed(jt, tt)
    b = 2
    x = (0.5 * np.random.default_rng(4).normal(size=(tt.num_nodes, b, 4))).astype(np.float32)
    kwargs = dict(message_passing_num=2, node_input_size=4, output_size=2,
                  hidden_size=tf_case.H, num_heads=tf_case.HEADS)
    gj = jax.tree.map(jnp.asarray, jgraph).replace(x=jnp.asarray(x))
    m_xla = JETD(dtype=jnp.float32, **kwargs)
    params = tf_case._perturb(tf_case._np_tree(m_xla.init(jax.random.PRNGKey(1), gj)), seed=2)
    want = np.asarray(JETD(edge_tiling=jt, dtype=jnp.bfloat16, **kwargs).apply(params, gj),
                      np.float32)
    port = EncodeTransformDecode(2, 4, 2, hidden_size=tf_case.H, num_heads=tf_case.HEADS,
                                 tiling=tt, dtype=torch.bfloat16)
    sim = entry._simulator(port, 0, seed=0)  # only its model is used
    load_jax_params(sim, params, tf_case._np_tree(tf_case._jax_sim(m_xla).init_state()))
    calls = []
    for name in ("fused_edge_attention_csr", "fused_gated_ffn"):
        fn = getattr(tlayers, name)
        monkeypatch.setattr(tlayers, name,
                            lambda *a, _fn=fn, _name=name: calls.append(_name) or _fn(*a))
    with torch.no_grad():
        got = port(MeshGraph.from_numpy(tgraph, "cpu").replace(x=torch.as_tensor(x))).numpy()
    assert sorted(calls) == ["fused_edge_attention_csr"] * 2 + ["fused_gated_ffn"] * 2
    rows = np.asarray(tgraph.node_mask)
    np.testing.assert_allclose(got[rows], want[rows], rtol=0.1, atol=0.1)


@pytest.mark.parametrize("setup_fn", [entry.graded_setup, entry.graded_transformer_setup])
def test_graded_rollout_csr_path_matches_plain_path(setup_fn):
    setup = setup_fn("cpu", num_nodes=1500, batch=2, mp_steps=2, num_steps=6)
    frames = entry.rollout_frames(setup, [0, 1], 4)
    res = make_batched_rollout_fn(setup.simulator)(frames)
    plain = setup.simulator
    plain.model.tiling = None  # every block on the plain edge-list path
    res_plain = make_batched_rollout_fn(plain)(frames)
    assert res.predictions.shape == (4, 1536, 2, 2)
    for r in (res, res_plain):
        assert torch.isfinite(r.predictions).all() and torch.isfinite(r.rmse_all_rollout).all()
    np.testing.assert_allclose(res.rmse_all_rollout.numpy(), res_plain.rmse_all_rollout.numpy(),
                               rtol=0.15)
