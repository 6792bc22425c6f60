"""The port's sub-mesh partitions against the JAX package's, on the CPU.

  * ``rcb_partition`` (the port's library path and its plain version
    ``native.rcb_labels_plain``) gives JAX's parts on the cases where
    JAX's own two paths disagree (its library and its numpy recursion:
    the 41x17 grid into 2-4 parts, 5x5 into 2-4, 12x10 and 30x30 into 7),
    on 1,000 random 2-D points and on a 3-D cloud with tied coordinates
    into 2, 3, 4 and 7; JAX's answer here is its library's;
  * ``extract_subgraph`` and ``num_parts_for`` equal JAX's;
  * a partitioned H5Dataset (``num_partitions`` 3, and
    ``max_nodes_per_partition`` 30: parts of odd sizes) gives JAX's
    ``len``, ``indices_for``, ``bucket_of`` and every training frame's
    arrays, masking drawn, and its rollout frames (part 0's), and the
    loader JAX's batches, packed and stacked;
  * an fp32 ``epd`` trained on 2 parts a frame (4 steps, then validation
    on the full mesh) logs JAX's Trainer's losses and metrics within 1e-4
    relative (tests/test_torch_trainer.py's bound).

Tolerance: none (np.array_equal) except the Trainer's 1e-4.
"""

import json

import jax
import numpy as np
import pytest
import torch

from graph_physics_tpu import native as j_native
from graph_physics_tpu.dataset import partition as jpart
from graph_physics_tpu.dataset import synthetic as jsynth
from graph_physics_tpu.dataset.h5_dataset import H5Dataset as JH5
from graph_physics_tpu.dataset.loader import BatchLoader as JLoader
from graph_physics_tpu.dataset.preprocessing import FrameConfig as JFC
from graph_physics_tpu.models.processors import EncodeProcessDecode as JEPD
from graph_physics_tpu.models.simulator import Simulator as JSim
from graph_physics_tpu.training.loss import LossType
from graph_physics_tpu.training.trainer import Trainer as JTrainer
from graph_physics_tpu.training.trainer import TrainerConfig as JTC
from graph_physics_tpu_torch import native
from graph_physics_tpu_torch.dataset import partition as tpart
from graph_physics_tpu_torch.dataset.h5_dataset import H5Dataset as TH5
from graph_physics_tpu_torch.dataset.loader import BatchLoader as TLoader
from graph_physics_tpu_torch.dataset.preprocessing import FrameConfig as TFC
from graph_physics_tpu_torch.models.layers import lecun_parameters
from graph_physics_tpu_torch.models.processors import EncodeProcessDecode as TEPD
from graph_physics_tpu_torch.models.simulator import Simulator as TSim
from graph_physics_tpu_torch.training.loss import l2_loss
from graph_physics_tpu_torch.training.trainer import Trainer as TTrainer
from graph_physics_tpu_torch.training.trainer import TrainerConfig as TTC
from graph_physics_tpu_torch.utils.convert import load_jax_params
from tests.test_torch_dataset import assert_same
from tests.test_torch_trainer import GRAD_NORM_RTOL, LOGGED, MODEL_KW, RTOL, SIM_KW

#: (mesh, parts) on which JAX's library and its numpy recursion disagree
SPLIT_CASES = [((41, 17), 2), ((41, 17), 3), ((41, 17), 4), ((5, 5), 2), ((5, 5), 3),
               ((5, 5), 4), ((12, 10), 7), ((30, 30), 7)]


def _grid(nx, ny):
    return jsynth.grid_mesh(nx, ny)[0].astype(np.float32)


def _jax_recursion(pos, parts, monkeypatch):
    """JAX's rcb_partition on its numpy recursion (its library withheld)."""
    with monkeypatch.context() as mp:
        mp.setattr(j_native, "rcb_labels", lambda *a, **k: None)
        return jpart.rcb_partition(pos, parts)


def _plain_parts(pos, parts):
    labels = native.rcb_labels_plain(pos, parts)
    return [np.where(labels == p)[0] for p in range(parts)]


def _assert_parts(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mesh,parts", SPLIT_CASES)
def test_rcb_partition_matches_jax_where_its_two_paths_disagree(mesh, parts, monkeypatch):
    pos = _grid(*mesh)
    want = jpart.rcb_partition(pos, parts)
    _assert_parts(tpart.rcb_partition(pos, parts), want)
    _assert_parts(_plain_parts(pos, parts), want)
    recursion = _jax_recursion(pos, parts, monkeypatch)
    assert any(not np.array_equal(a, b) for a, b in zip(recursion, want))


def _cloud(kind):
    rng = np.random.default_rng(7)
    if kind == "2d":
        return rng.uniform(-1.0, 1.0, size=(1000, 2)).astype(np.float32)
    # a 3-D cloud on a coarse lattice: many tied coordinates on every axis
    return (rng.integers(0, 9, size=(900, 3)) * np.float32(0.125)).astype(np.float32)


@pytest.mark.parametrize("kind", ["2d", "3d"])
@pytest.mark.parametrize("parts", [2, 3, 4, 7])
def test_rcb_partition_matches_jax_on_point_clouds(kind, parts):
    pos = _cloud(kind)
    want = jpart.rcb_partition(pos, parts)
    _assert_parts(tpart.rcb_partition(pos, parts), want)
    _assert_parts(_plain_parts(pos, parts), want)
    sizes = [len(p) for p in want]
    assert sum(sizes) == len(pos) and max(sizes) - min(sizes) <= 1 + parts // 2


def test_rcb_partition_of_one_part_or_one_node():
    for pos, parts in ((_grid(5, 5), 1), (np.zeros((1, 2), np.float32), 3)):
        _assert_parts(tpart.rcb_partition(pos, parts), jpart.rcb_partition(pos, parts))


@pytest.mark.parametrize("nodes,num,cap", [(70, None, None), (70, 3, None), (77, None, 30),
                                           (77, 4, 30), (1, None, 30), (64, 0, 0)])
def test_num_parts_for_matches_jax(nodes, num, cap):
    assert tpart.num_parts_for(nodes, num, cap) == jpart.num_parts_for(nodes, num, cap)


def test_extract_subgraph_matches_jax():
    pos, cells = jsynth.grid_mesh(12, 10)[:2]
    ei = native.faces_to_edges(cells, len(pos))
    for ids in tpart.rcb_partition(pos.astype(np.float32), 3):
        got, want = tpart.extract_subgraph(ids, ei, len(pos)), jpart.extract_subgraph(
            ids, ei, len(pos))
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_partition_cache_matches_jax_and_computes_once():
    pos, cells = jsynth.grid_mesh(11, 7)[:2]
    ei = native.faces_to_edges(cells, len(pos))
    tc, jc = tpart.PartitionCache(None, 30), jpart.PartitionCache(None, 30)
    got, want = tc.parts_for(0, pos, ei), jc.parts_for(0, pos, ei)
    _assert_parts(got[0], want[0])
    for (a, ma), (b, mb) in zip(got[1], want[1]):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ma, mb)
    assert tc.parts_for(0, None, None) is got


@pytest.fixture(scope="module")
def fixture_h5(tmp_path_factory):
    d = tmp_path_factory.mktemp("partition")
    train, meta = jsynth.write_h5_dataset(str(d / "train.h5"), num_trajectories=2, nx=10, ny=7,
                                          num_steps=10, meta_path=str(d / "meta.json"))
    val, _ = jsynth.write_h5_dataset(str(d / "val.h5"), num_trajectories=1, nx=10, ny=7,
                                     num_steps=10, meta_path=str(d / "m2.json"))
    return d, train, val, meta


PARTITIONS = [dict(num_partitions=3), dict(max_nodes_per_partition=30)]


@pytest.mark.parametrize("parts", PARTITIONS, ids=["num3", "max30"])
@pytest.mark.parametrize("khop", [1, 2])
def test_partitioned_dataset_matches_jax(fixture_h5, parts, khop):
    _, train, _, meta = fixture_h5
    kw = dict(targets=("velocity",), masking_ratio=0.3, khop=khop)
    tds = TH5(train, meta, TFC(**kw), seed=5, **parts)
    jds = JH5(train, meta, JFC(**kw), seed=5, **parts)
    assert len(tds) == len(jds) == 54
    for i in range(len(jds)):
        assert tds.indices_for(i) == jds.indices_for(i)
        assert tds.bucket_of(i) == jds.bucket_of(i)
        g = tds[i]
        assert_same(g, jds[i], where=f"sample {i}: ")
        assert g.faces is None and int(g.n_node) < 30 + 1
    assert tds.get_frames_packed([0, 1]) is None
    for a, b in zip(tds.trajectory_frames(0), jds.trajectory_frames(0), strict=True):
        assert_same(a, b)  # part 0's frames, as JAX's


@pytest.mark.parametrize("packed", [True, False])
def test_partitioned_loader_matches_jax(fixture_h5, packed):
    _, train, _, meta = fixture_h5
    tds = TH5(train, meta, TFC(targets=("velocity",)), max_nodes_per_partition=30)
    jds = JH5(train, meta, JFC(targets=("velocity",)), max_nodes_per_partition=30)
    tl = TLoader(tds, 4, shuffle=True, seed=3, packed=packed, device_put=False)
    jl = JLoader(jds, 4, shuffle=True, seed=3, packed=packed, device_put=False)
    assert tl._batched_indices() == jl._batched_indices()
    n = 0
    for tb, jb in zip(tl, jl, strict=True):
        assert_same(tb, jb, where=f"batch {n}: ")
        n += 1
    assert n == len(jl)


def test_world_sidecar_with_partitions_raises(fixture_h5):
    from graph_physics_tpu_torch.dataset.preprocessing import FrameBuilder, WorldConfig

    _, train, _, meta = fixture_h5
    cfg = TFC(targets=("velocity",), world=WorldConfig(0, 2, 2, sidecar=True))
    ds = TH5(train, meta, TFC(targets=("velocity",)))
    traj = ds._trajectory(0)
    with pytest.raises(ValueError, match="sidecar"):
        FrameBuilder(cfg, ds.meta).build(traj, 1, part_ids=np.arange(10))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_partitioned_epd_trains_as_jax_does(fixture_h5):
    d, train, val, meta = fixture_h5
    common = dict(epochs=1, batch_size=9, learning_rate=1e-3, warmup=10, log_every=1,
                  packed=True, out_dir=str(d / "runs"))
    jsim = JSim(**SIM_KW, model=JEPD(**MODEL_KW))
    jtr = JTrainer(jsim, JH5(train, meta, JFC(targets=("velocity",)), num_partitions=2),
                   JH5(val, meta, JFC(targets=("velocity",))), LossType.L2LOSS,
                   JTC(run_name="jax", **common))
    jtr.init_or_resume()
    params = jax.tree.map(np.asarray, jtr.state.params)
    sim_state = jax.tree.map(np.asarray, jtr.state.sim_state)
    jtr.fit()
    tsim = TSim(**SIM_KW, model=TEPD(**MODEL_KW))
    lecun_parameters(tsim, torch.Generator().manual_seed(0))
    ttr = TTrainer(tsim, TH5(train, meta, TFC(targets=("velocity",)), num_partitions=2),
                   TH5(val, meta, TFC(targets=("velocity",))), l2_loss,
                   TTC(run_name="port", **common), device="cpu")
    load_jax_params(ttr.sim, params, sim_state)
    ttr.fit()
    want = _records(d / "runs" / "jax" / "jax.metrics.jsonl")
    got = _records(d / "runs" / "port" / "port.metrics.jsonl")
    assert [r["step"] for r in got] == [r["step"] for r in want]
    assert ttr.state.step == int(jtr.state.step) == 4
    for a, b in zip(got, want):
        for key in LOGGED:
            if key in b:
                np.testing.assert_allclose(a[key], b[key], rtol=RTOL, err_msg=f"{key} @ {b}")
        if "grad_norm" in b:
            np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=GRAD_NORM_RTOL)
    assert all(np.isfinite(r[k]) for r in got for k in LOGGED if k in r)
