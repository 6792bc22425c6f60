"""The port's host side of the world-edge sidecar against the JAX package,
bit for bit (``np.array_equal``), on the synthetic plate (8x6 sheet and
its obstacle bar; radius 0.12, so the small sheet has world edges):
  * ``make_plate_trajectory``;
  * ``radius_world_edges`` (JAX on its path without the native library,
    the path the port copies: one cKDTree over every node, then the type
    filter), with the mesh edges excluded by edge list or by cached keys;
  * ``budget_world_pairs`` when the budget trims pairs, and its warning;
  * ``insert_obstacle_displacement``;
  * ``FrameBuilder.build`` with the sidecar: every field of each frame,
    ``wedge_*`` among them, the padding convention on unused slots, the
    skeleton path of later frames too;
  * ``pack_frames``'s [W, B] sidecar leaves;
and the port's own layout conversion (training/fused.py), which keeps the
sidecar's node ids and points its unused slots at the layout's last node.
"""

import warnings

import numpy as np
import pytest

from graph_physics_tpu import native as j_native
from graph_physics_tpu.core import mesh as j_mesh
from graph_physics_tpu.dataset import preprocessing as j_pre
from graph_physics_tpu.dataset import synthetic as j_syn
from graph_physics_tpu.training import packed as j_packed
from graph_physics_tpu_torch.core import mesh as t_mesh
from graph_physics_tpu_torch.dataset import preprocessing as t_pre
from graph_physics_tpu_torch.dataset import synthetic as t_syn
from graph_physics_tpu_torch.training import packed as t_packed
from graph_physics_tpu_torch.training.fused import FusedTopologyManager

RADIUS, BUDGET, STEPS = 0.12, 64, 12
FIELDS = ("x", "y", "pos", "node_type", "node_mask", "senders", "receivers", "edge_mask",
          "edge_attr", "wedge_senders", "wedge_receivers", "wedge_mask", "wedge_attr")


@pytest.fixture
def no_native(monkeypatch):
    """JAX's radius search without its native library."""
    monkeypatch.setattr(j_native, "radius_cross_pairs", lambda *a, **k: None)
    monkeypatch.setattr(j_native, "radius_pairs", lambda *a, **k: None)


def _traj(nx=8, ny=6):
    return t_syn.make_plate_trajectory(nx, ny, STEPS)


def test_plate_trajectory_matches_jax():
    for nx, ny in ((8, 6), (44, 30)):
        a, b = j_syn.make_plate_trajectory(nx, ny, STEPS), t_syn.make_plate_trajectory(nx, ny,
                                                                                      STEPS)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("by_keys", [False, True])
def test_radius_world_edges_match_jax(no_native, by_keys):
    traj = _traj()
    nt = traj["node_type"][0, :, 0]
    n = len(nt)
    ei = t_mesh.faces_to_edges(traj["cells"][0], n)
    keys = t_mesh.world_edge_exclude_keys(ei, n)
    assert np.array_equal(keys, j_mesh.world_edge_exclude_keys(ei, n))
    found = 0
    for t in range(STEPS):
        wp = traj["world_pos"][t]
        kw = dict(exclude_keys=keys) if by_keys else dict(exclude_edges=ei)
        got = t_mesh.radius_world_edges(wp, nt, RADIUS, **kw)
        want = j_mesh.radius_world_edges(wp, nt, RADIUS, **kw)
        assert got.dtype == want.dtype == np.int32 and np.array_equal(got, want)
        found += got.shape[1]
    assert found


def test_budget_world_pairs_matches_jax_when_it_trims():
    traj = _traj()
    nt = traj["node_type"][0, :, 0]
    wp = traj["world_pos"][2]
    wedges = t_mesh.radius_world_edges(wp, nt, RADIUS)
    assert wedges.shape[1] > 16
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        got = t_mesh.budget_world_pairs(wedges, wp, 16)
        want = j_mesh.budget_world_pairs(wedges, wp, 16)
    assert np.array_equal(got, want) and got.shape == (2, 16)
    assert any("budget exceeded" in str(x.message) for x in w)
    assert t_mesh.budget_world_pairs(wedges, wp, 1024) is wedges


def test_insert_obstacle_displacement_matches_jax():
    traj = _traj()
    nt = traj["node_type"][0, :, 0]
    rng = np.random.default_rng(0)
    x = np.concatenate([traj["world_pos"][3], rng.normal(size=(len(nt), 2))], 1).astype(
        np.float32)
    y = traj["world_pos"][4]
    args = (0, 3, 6)
    got = t_pre.insert_obstacle_displacement(x, y, nt, t_pre.WorldConfig(*args))
    want = j_pre.insert_obstacle_displacement(x, y, nt, j_pre.WorldConfig(*args))
    assert got.shape == (len(nt), 8) and np.array_equal(got, want)


def _builders(budget=BUDGET):
    meta = t_syn.plate_meta_dict(STEPS)
    world = dict(world_pos_index_start=0, world_pos_index_end=3, node_type_index=6,
                 radius=RADIUS, edge_budget=budget, sidecar=True)
    return (t_pre.FrameBuilder(t_pre.FrameConfig(targets=("world_pos",),
                                                 world=t_pre.WorldConfig(**world)), meta),
            j_pre.FrameBuilder(j_pre.FrameConfig(targets=("world_pos",),
                                                 world=j_pre.WorldConfig(**world)), meta))


@pytest.mark.parametrize("budget", [BUDGET, 16])
def test_frame_builder_sidecar_matches_jax(no_native, budget):
    traj = _traj()
    tb, jb = _builders(budget)
    frames = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the trimming budget warns
        for t in range(STEPS - 1):  # frame 0 builds the skeleton, the rest reuse it
            got, want = tb.build(traj, t, cache_key=0), jb.build(traj, t, cache_key=0)
            for name in FIELDS:
                a, b = getattr(got, name), getattr(want, name)
                assert np.asarray(a).dtype == np.asarray(b).dtype, name
                assert np.array_equal(np.asarray(a), np.asarray(b)), (t, name)
            frames.append(got)
    m = np.stack([f.wedge_mask for f in frames])
    assert m.any() and (budget < BUDGET or not m.all())  # a trimmed budget fills up
    n_pad = frames[0].x.shape[0]
    for f in frames:  # the padding convention on the unused slots
        assert (f.wedge_senders[~f.wedge_mask] == 0).all()
        assert (f.wedge_receivers[~f.wedge_mask] == n_pad - 1).all()
    # pack_frames: [W, B] per-sample leaves, as JAX packs them
    jframes = [jb.build(traj, t, cache_key=0) for t in range(4)]
    got = t_packed.pack_frames(frames[:4], broadcast_static=True)
    want = j_packed.pack_frames(jframes, broadcast_static=True)
    for name in ("wedge_senders", "wedge_receivers", "wedge_mask", "wedge_attr", "x", "y"):
        a, b = getattr(got, name), np.asarray(getattr(want, name))
        assert a.flags.c_contiguous and np.array_equal(a, b), name
    assert got.wedge_senders.shape == (budget, 4)


def test_layout_keeps_the_sidecar():
    """The fused layout changes no node id: the sidecar's used slots pass
    through, its unused slots point at the layout's last node, frame by
    frame and through the template path."""
    traj = _traj()
    tb, _ = _builders()
    manager = FusedTopologyManager("transformer")
    for t in range(4):
        g = tb.build(traj, t, cache_key=0)
        out = manager.transform_frame(g)
        n_new = out.x.shape[0]
        m = g.wedge_mask
        assert np.array_equal(out.wedge_mask, m) and np.array_equal(out.wedge_senders,
                                                                      g.wedge_senders)
        assert np.array_equal(out.wedge_receivers[m], g.wedge_receivers[m])
        assert (out.wedge_receivers[~m] == n_new - 1).all()
        assert np.array_equal(out.wedge_attr, g.wedge_attr)
        np.testing.assert_array_equal(out.x[:g.x.shape[0]][:int(g.n_node)],
                                      g.x[:int(g.n_node)])
