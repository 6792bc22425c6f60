"""The port's host data path against the JAX package's, bit for bit, on
the CPU, on one h5 fixture (2 trajectories on 10x7 and 11x7 meshes, 10
steps) written by the JAX package:

  * FrameBuilder.build and build_packed with khop 1 and 2, masking 0 and
    0.3 (the same numpy rng seed on both sides);
  * H5Dataset length, index, buckets and frames;
  * BatchLoader's batch order and every leaf of every batch, packed and
    stacked, on the vectorized lane and frame by frame, broadcast_static
    on and off;
  * pack_frames, finalize_packed and expand_static_leaves;
  * FusedTopologyManager.transform_packed against transform_frame (port
    only: the layouts are the port's own), and the fused loader's two
    lanes against each other.

Tolerance: none, every comparison is exact (np.array_equal).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_physics_tpu.dataset import synthetic as jsynth
from graph_physics_tpu.dataset.h5_dataset import H5Dataset as JH5
from graph_physics_tpu.dataset.loader import BatchLoader as JLoader
from graph_physics_tpu.dataset.preprocessing import FrameBuilder as JBuilder
from graph_physics_tpu.dataset.preprocessing import FrameConfig as JFC
from graph_physics_tpu.training import packed as jpacked
from graph_physics_tpu_torch.core.graph import MeshGraph
from graph_physics_tpu_torch.dataset import synthetic as tsynth
from graph_physics_tpu_torch.dataset.h5_dataset import H5Dataset as TH5
from graph_physics_tpu_torch.dataset.h5_dataset import read_meta
from graph_physics_tpu_torch.dataset.loader import BatchLoader as TLoader
from graph_physics_tpu_torch.dataset.preprocessing import FrameBuilder as TBuilder
from graph_physics_tpu_torch.dataset.preprocessing import FrameConfig as TFC
from graph_physics_tpu_torch.ops.tiling import NKTiling
from graph_physics_tpu_torch.training import packed as tpacked
from graph_physics_tpu_torch.training.fused import FusedTopologyManager

#: counts and ids: the port keeps Python ints where JAX keeps int32 (values compared)
COUNTS = ("n_node", "n_edge", "traj_index")
#: every field both packages carry
FIELDS = ("x", "pos", "node_type", "node_mask", "senders", "receivers", "edge_mask",
          "edge_attr", "y", "prev", "next_data", "deselected", "phi", "faces", "face_mask",
          "n_node", "n_edge", "traj_index", "time")


def assert_same(tg, jg, fields=FIELDS, where=""):
    for name in fields:
        a, b = getattr(tg, name), getattr(jg, name)
        assert (a is None) == (b is None), f"{where}{name}: None on one side"
        if a is None:
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, f"{where}{name}: {a.shape} vs {b.shape}"
        if a.ndim and name not in COUNTS:
            assert a.dtype == b.dtype, f"{where}{name}: {a.dtype} vs {b.dtype}"
        assert np.array_equal(a, b), f"{where}{name} differs"


@pytest.fixture(scope="module")
def fixture_h5(tmp_path_factory):
    d = tmp_path_factory.mktemp("h5")
    train, meta = jsynth.write_h5_dataset(str(d / "train.h5"), num_trajectories=2, nx=10, ny=7,
                                          num_steps=10, meta_path=str(d / "meta.json"))
    return train, meta


def test_synthetic_writer_and_meta_match_jax(tmp_path):
    path, meta = tsynth.write_h5_dataset(str(tmp_path / "t.h5"), num_trajectories=2, nx=10,
                                         ny=7, num_steps=10)
    assert read_meta(meta) == jsynth.meta_dict(10)
    import h5py

    with h5py.File(path) as f:
        for i in range(2):
            want = jsynth.make_trajectory(10 + i, 7, 10)
            for k, v in want.items():
                assert np.array_equal(f[str(i)][k][()], v), k


def _builders(meta_path, **kw):
    meta = read_meta(meta_path)
    return TBuilder(TFC(targets=("velocity",), **kw), meta), \
        JBuilder(JFC(targets=("velocity",), **kw), meta)


@pytest.mark.parametrize("khop", [1, 2])
@pytest.mark.parametrize("masking", [0.0, 0.3])
def test_frame_builder_matches_jax(fixture_h5, khop, masking):
    train, meta = fixture_h5
    jds = JH5(train, meta, JFC(targets=("velocity",), khop=khop))
    tb, jb = _builders(meta, khop=khop, masking_ratio=masking)
    for t in range(2):
        traj = jds._trajectory(t)
        tr, jr = np.random.default_rng(3), np.random.default_rng(3)
        # twice: the first build of a trajectory makes its skeleton, the
        # second one is served from it
        for frame in list(range(9)) * 2:
            kw = dict(traj_index=t, n_pad=jds._n_pad[t], e_pad=jds._e_pad[t],
                      c_pad=jds._c_pad[t], cache_key=t)
            assert_same(tb.build(traj, frame, rng=tr, **kw), jb.build(traj, frame, rng=jr, **kw),
                        where=f"traj {t} frame {frame}: ")
        frames = np.asarray([0, 3, 3, 8])
        kw = dict(traj_index=t, n_pad=jds._n_pad[t], e_pad=jds._e_pad[t],
                  c_pad=jds._c_pad[t], cache_key=t)
        tp, jp = tb.build_packed(traj, frames, **kw), jb.build_packed(traj, frames, **kw)
        assert (tp is None) == (jp is None) == (masking > 0)
        if tp is not None:
            assert_same(tp, jp, where="build_packed: ")
    for ratio in (0.0, 0.1):
        a, b = _builders(meta, new_edges_ratio=ratio)
        assert a.edge_budget_for(1000) == b.edge_budget_for(1000)


def test_h5_dataset_index_buckets_and_frames(fixture_h5):
    train, meta = fixture_h5
    tds = TH5(train, meta, TFC(targets=("velocity",), masking_ratio=0.3), seed=5)
    jds = JH5(train, meta, JFC(targets=("velocity",), masking_ratio=0.3), seed=5)
    assert len(tds) == len(jds) == 18 and tds.num_trajectories == jds.num_trajectories == 2
    for i in range(len(jds)):
        assert tds.indices_for(i) == jds.indices_for(i)
        assert tds.bucket_of(i) == jds.bucket_of(i)
        assert_same(tds[i], jds[i], where=f"sample {i}: ")  # training frames, masking drawn
    for t in range(2):
        for a, b in zip(tds.trajectory_frames(t), jds.trajectory_frames(t), strict=True):
            assert_same(a, b)


def _loaders(train, meta, packed, broadcast, lane, seed=11, batch=4):
    tds = TH5(train, meta, TFC(targets=("velocity",)))
    jds = JH5(train, meta, JFC(targets=("velocity",)))
    tl = TLoader(tds, batch, shuffle=True, seed=seed, packed=packed, device_put=False,
                 broadcast_static=broadcast)
    jl = JLoader(jds, batch, shuffle=True, seed=seed, packed=packed, device_put=False,
                 broadcast_static=broadcast)
    if lane == "frames":
        tl._packed_fast = jl._packed_fast = lambda chunk: None
    return tl, jl


@pytest.mark.parametrize("lane", ["fast", "frames"])
@pytest.mark.parametrize("packed,broadcast", [(True, True), (True, False), (False, False)])
def test_batch_loader_matches_jax(fixture_h5, packed, broadcast, lane):
    train, meta = fixture_h5
    tl, jl = _loaders(train, meta, packed, broadcast, lane)
    assert len(tl) == len(jl)
    tl2, jl2 = _loaders(train, meta, packed, broadcast, lane)
    assert tl2._batched_indices() == jl2._batched_indices()
    n = 0
    for e in range(2):  # two epochs of one loader: the rng stream goes on
        for tb, jb in zip(tl, jl, strict=True):
            assert_same(tb, jb, where=f"epoch {e} batch {n}: ")
            n += 1
    if packed and broadcast:
        assert tb.edge_attr.shape[1] == 1


def test_pack_finalize_and_expand_match_jax(fixture_h5):
    train, meta = fixture_h5
    tds, jds = TH5(train, meta, TFC(targets=("velocity",))), JH5(train, meta, JFC(
        targets=("velocity",)))
    idx = [1, 4, 4, 7]
    for broadcast in (False, True):
        tf, jf = [tds[i] for i in idx], [jds[i] for i in idx]
        tp = tpacked.pack_frames(tf, broadcast_static=broadcast)
        jp = jpacked.pack_frames(jf, broadcast_static=broadcast)
        assert_same(tp, jp)
        # the checked path: frames that do not share their static leaves
        tc = tpacked.pack_frames([f.replace(pos=np.array(f.pos)) for f in tf], broadcast)
        jc = jpacked.pack_frames([f.replace(pos=np.array(f.pos)) for f in jf], broadcast)
        assert_same(tc, jc)
        th, jh = tds.get_frames_packed(idx), jds.get_frames_packed(idx)
        assert_same(th, jh)
        tfin = tpacked.finalize_packed(th, len(idx), broadcast)
        assert_same(tfin, jpacked.finalize_packed(jh, len(idx), broadcast))
        assert_same(tfin, tp)  # the vectorized lane equals the per-frame batch
        # expand on the device: the widened leaves equal the host repeats, contiguous
        dev = tpacked.expand_static_leaves(MeshGraph.from_numpy(tp, "cpu"))
        jexp = jpacked.expand_static_leaves(jax.tree.map(jnp.asarray, jp))
        for name in ("x", "edge_attr", "y"):
            t = getattr(dev, name)
            assert t.is_contiguous(), name
            assert np.array_equal(t.numpy(), np.asarray(getattr(jexp, name))), name
        assert dev.edge_attr.shape[1] == len(idx)


def test_expand_static_leaves_gives_contiguous_rows():
    x = torch.randn(5, 3, 2)
    e = torch.randn(7, 1, 4)
    g = MeshGraph(x=x, pos=None, node_type=torch.zeros(5, dtype=torch.int32), node_mask=None,
                  senders=None, receivers=None, edge_mask=None, edge_attr=e)
    out = tpacked.expand_static_leaves(g).edge_attr
    assert out.shape == (7, 3, 4) and out.is_contiguous() and out.stride(1) != 0
    assert torch.equal(out, e.repeat(1, 3, 1))


def test_transform_packed_equals_transform_frame(fixture_h5):
    train, meta = fixture_h5
    tds = TH5(train, meta, TFC(targets=("velocity",)))
    mgr = FusedTopologyManager("epd")
    for idx in ([0, 2, 5, 5], [9, 10, 17, 12]):
        frames = [mgr.transform_frame(tds[i]) for i in idx]
        assert all(isinstance(f.layout, NKTiling) for f in frames)
        assert all(f.layout is frames[0].layout for f in frames)
        # frames after the first come from the template: the same bits as a full conversion
        fresh = FusedTopologyManager("epd").transform_frame(tds[idx[-1]])
        assert_same(frames[-1], fresh)
        assert np.array_equal(frames[-1].layout.perm, fresh.layout.perm)
        for broadcast in (False, True):
            want = tpacked.pack_frames(frames, broadcast_static=broadcast)
            half = mgr.transform_packed(tds.get_frames_packed(idx))
            got = tpacked.finalize_packed(half, len(idx), broadcast)
            assert_same(got, want)
            assert got.layout is want.layout
    # no template yet: the caller falls back to the per-frame lane
    assert FusedTopologyManager("epd").transform_packed(tds.get_frames_packed([0, 1])) is None
    csr = FusedTopologyManager("epd", nk=False).transform_frame(tds[0])
    assert type(csr.layout).__name__ == "CSRLayout"


@pytest.mark.parametrize("broadcast", [False, True])
def test_fused_loader_lanes_agree(fixture_h5, broadcast):
    train, meta = fixture_h5
    batches = {}
    for lane in ("fast", "frames"):
        tds = TH5(train, meta, TFC(targets=("velocity",)))
        mgr = FusedTopologyManager("epd")
        tl = TLoader(tds, 4, seed=2, packed=True, device_put=False, broadcast_static=broadcast,
                     frame_transform=mgr.transform_frame, packed_transform=mgr.transform_packed)
        if lane == "frames":
            tl._packed_fast = lambda chunk: None
        batches[lane] = list(tl)
    for a, b in zip(batches["fast"], batches["frames"], strict=True):
        assert_same(a, b)
        assert isinstance(a.layout, NKTiling)


def test_loader_worker_pool_gives_the_single_thread_batches(fixture_h5):
    """Eight frame-building threads share the dataset's cache and the layout
    manager's caches (a short switch interval makes races likely): the
    batches equal a single thread's, layouts too."""
    import sys

    train, meta = fixture_h5
    batches = {}
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for workers in (1, 8):
            tds = TH5(train, meta, TFC(targets=("velocity",)))
            mgr = FusedTopologyManager("epd")
            tl = TLoader(tds, 9, seed=4, packed=True, device_put=False, workers=workers,
                         frame_transform=mgr.transform_frame)
            batches[workers] = list(tl)
    finally:
        sys.setswitchinterval(interval)
    for a, b in zip(batches[1], batches[8], strict=True):
        assert_same(a, b)
        assert np.array_equal(a.layout.perm, b.layout.perm)
