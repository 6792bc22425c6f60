"""The port's CSR edge layout and its layout choice against the JAX package.

  * ``expand_edges``/``reduce_edges`` round-trip every valid edge;
  * ``row_ptr`` is the cumulative in-degree (a numpy bincount), rows are
    the valid edges sorted stably by receiver, padding rows (sender 0,
    receiver N-1, mask False) come last and no receiver's range covers
    them, also when node N-1 is a real node with edges of its own;
  * the port's FusedTopologyManager chooses what JAX's
    (graph_physics_tpu/training/fused.py) chooses, for ``epd``
    (``nk_layout``) and for the transformer (``build_nk``): NK on the
    48x40 cylinder, CSR on the graded test mesh (JAX without an RCM
    reorder there, so node order is the same in both packages);
  * a frame whose masked edges sit between valid ones is laid out as the
    frame of its valid edges alone.
Exact comparisons (integer layouts).
"""

import numpy as np
import pytest

from graph_physics_tpu.core import mesh as jmesh
from graph_physics_tpu.training.fused import FusedTopologyManager as JManager
from graph_physics_tpu_torch import entry
from graph_physics_tpu_torch.core import mesh as tmesh
from graph_physics_tpu_torch.dataset import synthetic
from graph_physics_tpu_torch.ops import tiling as ttiling
from graph_physics_tpu_torch.training import fused
from graph_physics_tpu_torch.training.fused import FusedTopologyManager
from tests.test_torch_fused_gnblock_nk import _port_host_graph

#: a graded test mesh whose node count fills its node blocks, so node
#: N-1 is a real node with in-edges of its own
GRADED_NODES = 1536


def graded_graph(num_nodes=GRADED_NODES, seed=0):
    """Frame 0 of the graded trajectory as the JAX package's host graph."""
    traj = synthetic.make_graded_trajectory(num_nodes, num_steps=3, seed=seed)
    pos, nt = traj["mesh_pos"][0], traj["node_type"][0, :, 0]
    x = np.concatenate([traj["velocity"][0], nt[:, None].astype(np.float32),
                        np.zeros((len(pos), 1), np.float32)], axis=-1)
    ei = jmesh.faces_to_edges(traj["cells"][0], len(pos))
    return jmesh.build_mesh_graph(x, pos, nt, ei, y=traj["velocity"][1])


def test_graded_mesh_is_graded():
    pos, cells = synthetic.graded_mesh(2000, seed=3)
    assert pos.shape == (2000, 2) and np.array_equal(pos, synthetic.graded_mesh(2000, seed=3)[0])
    assert (np.diff(pos[:, 0]) >= 0).all()  # sorted along x
    ei = tmesh.faces_to_edges(cells, len(pos))
    deg = np.bincount(ei[1], minlength=len(pos))
    assert deg.min() >= 2 and deg.max() >= 10 and 5.5 < deg.mean() < 6.2


@pytest.mark.parametrize("num_nodes", [1500, GRADED_NODES])
def test_csr_layout_rows(num_nodes):
    g = _port_host_graph(graded_graph(num_nodes))
    e = int(np.asarray(g.edge_mask).sum())
    layout = ttiling.build_csr_layout(g.senders, g.receivers, int(g.n_node),
                                      edge_mask=g.edge_mask)
    assert layout.num_nodes == -(-num_nodes // 128) * 128
    assert layout.total_rows % ttiling.ROW_ALIGN == 0 and layout.total_rows >= e
    recv = np.asarray(g.receivers)[:e]
    want = np.zeros(layout.num_nodes + 1, np.int64)
    want[1:] = np.cumsum(np.bincount(recv, minlength=layout.num_nodes))
    np.testing.assert_array_equal(layout.row_ptr, want)
    assert layout.row_ptr[-1] == e  # padding rows lie past every receiver's range

    tg = ttiling.apply_to_graph(g, layout)
    n = layout.num_nodes
    assert tg.x.shape[0] == n and tg.senders.shape == (layout.total_rows,)
    valid = tg.edge_mask
    assert valid[:e].all() and not valid[e:].any()
    np.testing.assert_array_equal(tg.senders[e:], 0)
    np.testing.assert_array_equal(tg.receivers[e:], n - 1)
    assert (np.diff(tg.receivers[:e]) >= 0).all()  # receiver-sorted
    # each row carries its original edge, in the original (stable) order
    ids = layout.perm[:e]
    np.testing.assert_array_equal(tg.senders[:e], np.asarray(g.senders)[ids])
    np.testing.assert_array_equal(tg.receivers[:e], recv[ids])
    for r in (0, n // 2, n - 1):
        rows = np.arange(layout.row_ptr[r], layout.row_ptr[r + 1])
        np.testing.assert_array_equal(tg.receivers[rows], r)
        assert (np.diff(ids[rows]) > 0).all()
    if num_nodes == n:  # node N-1 is real and owns valid rows
        assert layout.row_ptr[n] > layout.row_ptr[n - 1]
    else:
        assert not tg.node_mask[num_nodes:].any()

    vals = np.random.default_rng(0).normal(size=(g.senders.shape[0], 3))
    back = layout.reduce_edges(layout.expand_edges(vals), len(vals))
    np.testing.assert_array_equal(back[:e], vals[:e])
    assert not back[e:].any()
    np.testing.assert_array_equal(tg.edge_attr, layout.expand_edges(np.asarray(g.edge_attr)))


def _cylinder_graph():
    traj = synthetic.make_trajectory(48, 40, num_steps=3)
    pos, nt = traj["mesh_pos"][0], traj["node_type"][0, :, 0]
    x = np.concatenate([traj["velocity"][0], nt[:, None].astype(np.float32),
                        np.zeros((len(pos), 1), np.float32)], axis=-1)
    ei = jmesh.faces_to_edges(traj["cells"][0], len(pos))
    return jmesh.build_mesh_graph(x, pos, nt, ei, y=traj["velocity"][1])


@pytest.mark.parametrize("mode", ["nk_layout", "build_nk"])
@pytest.mark.parametrize("mesh,want", [("cylinder", "nk"), ("graded", "csr")])
def test_manager_chooses_as_jax(mode, mesh, want):
    jg = _cylinder_graph() if mesh == "cylinder" else graded_graph()
    _, (t, perm, nk) = JManager(**{mode: True})._tiling_for(jg)
    assert t is not None and perm is None  # JAX keeps the node order
    assert ("nk" if nk is not None else "csr") == want
    manager = FusedTopologyManager({"nk_layout": "epd", "build_nk": "transformer"}[mode])
    g = _port_host_graph(jg)
    layout = manager.layout_for(g)
    got = manager.transform_frame(g)
    if want == "nk":
        assert isinstance(layout, ttiling.NKTiling)
        np.testing.assert_array_equal(layout.perm, nk.perm)  # JAX's NK slot order
        np.testing.assert_array_equal(got.senders, ttiling.apply_to_graph_nk(g, layout).senders)
    else:
        assert isinstance(layout, ttiling.CSRLayout) and layout.num_nodes == t.num_nodes
        np.testing.assert_array_equal(got.senders, ttiling.apply_to_graph(g, layout).senders)
    assert manager.layout_for(g) is layout  # cached per topology


def test_manager_cache_is_keyed_on_topology_and_bounded(monkeypatch):
    monkeypatch.setattr(fused, "MAX_CACHED_TILINGS", 2)
    manager = FusedTopologyManager("epd")
    g = _port_host_graph(_cylinder_graph())
    first = manager.layout_for(g)
    assert manager.layout_for(g, traj_index=1) is not first  # another trajectory
    mask = np.asarray(g.edge_mask).copy()
    mask[np.nonzero(mask)[0][0]] = False  # another edge set
    assert manager.layout_for(g.replace(edge_mask=mask)) is not first
    assert len(manager._tilings) == 2  # LRU-bounded: the first entry went
    assert manager.layout_for(g) is not first


@pytest.mark.parametrize("mesh,want", [("cylinder", ttiling.NKTiling),
                                       ("graded", ttiling.CSRLayout)])
def test_manager_lays_out_interleaved_invalid_edges(mesh, want):
    """Every 50th edge masked and pointed at random nodes: the frame is laid
    out as the frame that holds its valid edges alone."""
    g = _port_host_graph(_cylinder_graph() if mesh == "cylinder" else graded_graph())
    send, recv = np.asarray(g.senders).copy(), np.asarray(g.receivers).copy()
    mask = np.asarray(g.edge_mask).copy()
    mask[3::50] = False
    rng = np.random.default_rng(0)
    send[~mask] = rng.integers(0, int(g.n_node), int((~mask).sum()))
    recv[~mask] = rng.integers(0, int(g.n_node), int((~mask).sum()))
    ea = np.asarray(g.edge_attr)
    holed = g.replace(senders=send, receivers=recv, edge_mask=mask)
    alone = g.replace(senders=send[mask], receivers=recv[mask], edge_attr=ea[mask],
                      edge_mask=np.ones(int(mask.sum()), bool))
    got, ref = (FusedTopologyManager("epd").transform_frame(h) for h in (holed, alone))
    assert isinstance(FusedTopologyManager("epd").layout_for(holed), want)
    for name in ("senders", "receivers", "edge_mask", "edge_attr"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name), err_msg=name)


def test_graded_setups_take_csr_on_cpu():
    for setup_fn in (entry.graded_setup, entry.graded_transformer_setup):
        setup = setup_fn("cpu", num_nodes=1500, batch=2, mp_steps=1)
        assert isinstance(setup.tiling, ttiling.CSRLayout)
        assert setup.graph.x.shape[:2] == (1536, 2)
        assert setup.graph.senders.shape == (setup.tiling.total_rows,)
