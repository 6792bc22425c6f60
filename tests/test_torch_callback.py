"""Validation visualizations (training/callback.py) on the CPU.

  * the port's Trainer, ``save_val_visualizations`` on, writes under
    ``out_dir/run_name/viz`` the files JAX's PredictionVisualizer writes
    for the same rollout (``epoch_{e}_frame_0.png``,
    ``epoch_{e}_rollout.gif``), the PNG decodes to JAX's image size and
    the GIF holds one frame a rollout step;
  * packed (the validation rollout [T, N, R, F]) and unpacked;
  * without matplotlib the call raises an ImportError that names it.
"""

import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from PIL import Image

from graph_physics_tpu.training.callback import PredictionVisualizer as JViz
from graph_physics_tpu_torch.training import callback
from tests.test_torch_trainer import data, port_trainer  # noqa: F401 - fixture


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("packed", [True, False])
def test_validate_writes_jax_visualizations(data, packed, tmp_path, monkeypatch):  # noqa: F811
    from graph_physics_tpu_torch.training import trainer as trainer_mod

    calls = []

    class Recording(callback.PredictionVisualizer):
        def __call__(self, rollout_result, frames, epoch):
            calls.append((rollout_result, frames))
            return super().__call__(rollout_result, frames, epoch)

    monkeypatch.setattr(trainer_mod, "PredictionVisualizer", Recording)
    tr = port_trainer(data, f"viz{packed}", packed=packed, save_val_visualizations=True,
                      out_dir=str(tmp_path))
    metrics = tr.validate(epoch=3)
    assert np.isfinite(metrics["val_all_rollout_rmse"])
    viz = tmp_path / f"viz{packed}" / "viz"
    got = sorted(p.name for p in viz.iterdir())
    assert got == ["epoch_3_frame_0.png", "epoch_3_rollout.gif"]

    # JAX's visualizer on the same rollout, its frames stacked per step
    (rollout, traj), = calls
    t_len = traj.x.shape[0]
    assert rollout.predictions.shape == rollout.targets.shape == (t_len,) + traj.y.shape[1:]
    frames = SimpleNamespace(
        n_node=np.full(t_len, traj.n_node), pos=np.stack([traj.pos] * t_len),
        faces=np.stack([traj.faces] * t_len), face_mask=np.stack([traj.face_mask] * t_len))
    want = JViz(str(tmp_path / "jax"))(rollout, frames, 3)
    assert sorted(p.split("/")[-1] for p in want) == got
    with Image.open(viz / "epoch_3_frame_0.png") as a, Image.open(want[0]) as b:
        a.load()
        assert a.size == b.size
    with Image.open(viz / "epoch_3_rollout.gif") as gif:
        assert gif.n_frames == t_len


def test_visualizer_takes_tensors_and_per_frame_graphs(tmp_path):
    from graph_physics_tpu.dataset import synthetic as jsynth

    pos, cells = jsynth.grid_mesh(6, 4)[:2]
    t_len, n = 3, len(pos)
    frames = SimpleNamespace(n_node=np.full(t_len, n), pos=np.stack([pos] * t_len),
                             faces=np.stack([cells] * t_len),
                             face_mask=np.ones((t_len, len(cells)), bool))
    views = callback.rollout_views(torch.zeros(t_len, n, 2), torch.ones(t_len, n, 2))
    out = callback.PredictionVisualizer(str(tmp_path), indices=(0, 2, 5))(views, frames, 1)
    assert [p.split("/")[-1] for p in out] == ["epoch_1_frame_0.png", "epoch_1_frame_2.png",
                                               "epoch_1_rollout.gif"]


def test_without_matplotlib_the_call_raises_naming_it(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        callback.render_field_comparison(np.zeros((3, 2)), None, np.zeros(3), np.zeros(3),
                                         str(tmp_path / "a.png"))
