"""The port's xdmf dataset, use-case feature builders and workload fixtures
against the JAX package's, on the CPU, bit for bit.

  * ``synthetic.write_workload_fixture`` (panels, aneurysm) writes the files
    JAX's writes: each package's fixture read back by the port's reader
    gives the same arrays;
  * on the port's fixture, ``XDMFDataset`` with the workload's feature
    builder (``--external``: the builder and the previous frame's data)
    builds every frame of both splits as JAX's XDMFDataset does: every
    field, the 2-D drop of a zero z column (panels) and the default
    node types included;
  * the bezier builder on a random frame equals JAX's.
"""

import json
from pathlib import Path

import numpy as np
import pytest

from graph_physics_tpu.dataset import synthetic as jsynth
from graph_physics_tpu.dataset.preprocessing import FrameContext as JContext
from graph_physics_tpu.dataset.xdmf_dataset import XDMFDataset as JXDMF
from graph_physics_tpu.external import get_feature_builder as j_builder
from graph_physics_tpu.training import config as j_config
from graph_physics_tpu_torch.dataset import synthetic
from graph_physics_tpu_torch.dataset.preprocessing import FrameContext
from graph_physics_tpu_torch.dataset.xdmf_dataset import XDMFDataset
from graph_physics_tpu_torch.external import get_feature_builder
from graph_physics_tpu_torch.training import config as t_config
from graph_physics_tpu_torch.utils.xdmf import XdmfTimeSeriesReader

CONFIG_DIR = Path(__file__).resolve().parents[1] / "training_config"

FIELDS = ("x", "y", "pos", "node_type", "node_mask", "senders", "receivers", "edge_mask",
          "edge_attr", "faces", "face_mask", "prev", "next_data")
CONFIGS = {"panels": "panels", "aneurysm": "coarse-aneurysm"}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def fixture(request, tmp_path_factory):
    workload = request.param
    d = tmp_path_factory.mktemp(workload)
    paths = synthetic.write_workload_fixture(workload, str(d / "port"), num_trajectories=2,
                                             num_steps=5)
    jpaths = jsynth.write_workload_fixture(workload, str(d / "jax"), num_trajectories=2,
                                           num_steps=5)
    return workload, paths, jpaths


def _series(path):
    r = XdmfTimeSeriesReader(path)
    frames = [r.read_frame(i) for i in range(len(r))]
    r.close()
    return frames


def test_fixture_writes_what_jax_writes(fixture):
    workload, paths, jpaths = fixture
    for split in (0, 1):
        for i in range(2 if split == 0 else 1):
            mine = _series(f"{paths[split]}/traj_{i}.xdmf")
            theirs = _series(f"{jpaths[split]}/traj_{i}.xdmf")
            assert len(mine) == len(theirs) == 5
            for (p, c, d, t), (jp, jc, jd, jt) in zip(mine, theirs):
                np.testing.assert_array_equal(p, jp)
                np.testing.assert_array_equal(c, jc)
                assert list(d) == list(jd) and t == jt
                for k in d:
                    np.testing.assert_array_equal(d[k], jd[k], err_msg=k)
    assert json.load(open(paths[2])) == json.load(open(jpaths[2]))


def test_dataset_frames_match_jax(fixture):
    workload, (train, test, meta), _ = fixture
    with open(CONFIG_DIR / f"{CONFIGS[workload]}.json") as f:
        param = json.load(f)
    tcfg = t_config.get_frame_config(param, masking_ratio=0.0, use_previous_data=True,
                                     extra_node_features=get_feature_builder(workload))
    jcfg = j_config.get_frame_config(param, masking_ratio=0.0, use_previous_data=True,
                                     extra_node_features=j_builder(workload))
    for path in (train, test):
        mine, theirs = XDMFDataset(path, meta, tcfg), JXDMF(path, meta, jcfg)
        assert len(mine) == len(theirs) > 0
        assert mine.num_trajectories == theirs.num_trajectories
        for t in range(mine.num_trajectories):
            fields, jfields = mine._trajectory(t), theirs._trajectory(t)
            assert list(fields) == list(jfields)
            for k in fields:
                np.testing.assert_array_equal(fields[k], jfields[k], err_msg=k)
            if workload == "panels":  # a 2-D mesh stored with a zero z column
                assert fields["mesh_pos"].shape[-1] == 2
            for a, b in zip(mine.trajectory_frames(t), theirs.trajectory_frames(t)):
                for name in FIELDS:
                    va, vb = getattr(a, name), getattr(b, name)
                    assert (va is None) == (vb is None), name
                    if va is not None:
                        np.testing.assert_array_equal(np.asarray(va), np.asarray(vb),
                                                      err_msg=name)


def test_bezier_builder_matches_jax():
    rng = np.random.default_rng(0)
    n = 40
    markers = (rng.random((n, 5)) < 0.3).astype(np.float32)
    point_data = {"velocity": rng.normal(size=(n, 2)).astype(np.float32),
                  "pressure": rng.normal(size=(n, 1)).astype(np.float32),
                  "markers": markers}
    kw = dict(pos=rng.normal(size=(n, 2)).astype(np.float32),
              cells=np.zeros((1, 3), np.int32), node_type=np.zeros(n, np.int32), time=0.4,
              target=None, next_data=None, previous_data=None)
    got = get_feature_builder("bezier")(FrameContext(point_data=dict(point_data), **kw))
    want = j_builder("bezier")(JContext(point_data=dict(point_data), **kw))
    np.testing.assert_array_equal(got.x, want.x)
    np.testing.assert_array_equal(got.node_type, want.node_type)
