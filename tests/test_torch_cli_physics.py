"""The physics-loss workloads through the port's train -> predict CLIs on
the CPU, on synthetic xdmf fixtures (dataset/synthetic.write_workload_fixture:
2 training trajectories of 6 frames on 7x6 and 8x6 grids, 1 validation
trajectory), each config cut to 2 blocks, fp32, ``--packed``, 2 epochs at
batch 2, lr 1e-3, warmup 5:

  * panels.json (hidden 128, the 4-term loss on least-squares gradients,
    ``--external panels``) trains; ``cli.predict`` of its checkpoint matches
    the rollout of JAX's inference stack (its xdmf dataset, panels builder
    and rollout) from the same weights (through JAX's convert_state_dict)
    to 1e-4, and its RMSE is the last validation's;
  * pinn-aneurysm.json (the 3-term loss on finite differences) and
    coarse-aneurysm.json (the L2 loss), both ``--external aneurysm`` on the
    3-D surface fixture, train and predict, with finite losses and
    predict's RMSE equal to the last validation's.
``--use_previous_data`` on the aneurysm configs is held against JAX in
tests/test_torch_previous_data.py.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from graph_physics_tpu_torch.cli import predict as predict_cli
from graph_physics_tpu_torch.cli import train as train_cli
from graph_physics_tpu_torch.cli.common import load_inference_stack
from graph_physics_tpu_torch.dataset import synthetic

CONFIG_DIR = Path(__file__).resolve().parents[1] / "training_config"

WORKLOADS = {"panels": "panels", "pinn-aneurysm": "aneurysm", "coarse-aneurysm": "aneurysm"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_physics")
    return d, {w: synthetic.write_workload_fixture(w, str(d / w), num_trajectories=2,
                                                   num_steps=6)
               for w in ("panels", "aneurysm")}


def _config(d, fixtures, name):
    with open(CONFIG_DIR / f"{name}.json") as f:
        param = json.load(f)
    train, test, meta = fixtures[WORKLOADS[name]]
    param["dataset"].update(train_path=train, test_path=test, meta_path=meta)
    param["model"]["message_passing_num"] = 2
    path = d / f"{name}.json"
    path.write_text(json.dumps(param))
    return str(path)


def _train_and_predict(name, fixtures):
    """Train ``name`` through cli.train, then predict from its checkpoint:
    (config path, the last validation record, the predict result, the
    inference stack)."""
    d, paths = fixtures
    cfg = _config(d, paths, name)
    external = WORKLOADS[name]
    out = d / "runs"
    assert train_cli.main(["--training_parameters_path", cfg, "--epochs", "2", "--batch_size",
                           "2", "--learning_rate", "1e-3", "--warmup", "5", "--packed",
                           "--external", external, "--out_dir", str(out), "--run_name", name,
                           "--device", "cpu"]) == 0
    records = [json.loads(line) for line in open(out / name / f"{name}.metrics.jsonl")]
    last = [r for r in records if "val_all_rollout_rmse" in r][-1]
    assert last["epoch"] == 1
    assert all(np.isfinite(r["train_loss_epoch"]) for r in records if "train_loss_epoch" in r)
    argv = ["--training_parameters_path", cfg, "--model_path", str(out / name / "checkpoints"),
            "--external", external, "--device", "cpu"]
    stack = load_inference_stack(predict_cli.build_argparser().parse_args(argv))
    got = predict_cli.predict(stack)[0]
    np.testing.assert_allclose(got.rmse_all_rollout, last["val_all_rollout_rmse"], rtol=1e-6)
    assert np.isfinite(got.predictions).all()
    assert predict_cli.main(argv + ["--out_dir", str(d / "preds"), "--run_name", name]) == 0
    return cfg, last, got, stack


def test_panels_trains_and_predicts_as_jax_rolls_out(fixtures):
    import jax
    import jax.numpy as jnp

    from graph_physics_tpu.external import get_feature_builder
    from graph_physics_tpu.training import config as j_config
    from graph_physics_tpu.training.rollout import make_rollout_fn
    from graph_physics_tpu.utils.convert import convert_state_dict

    cfg, last, got, stack = _train_and_predict("panels", fixtures)
    assert stack.simulator.model.hidden_size == 128
    jparam = j_config.load_params(cfg)
    params, state = convert_state_dict(
        {k: v.detach().float().numpy() for k, v in stack.simulator.state_dict().items()},
        jparam)
    frame_cfg = j_config.get_frame_config(jparam, masking_ratio=0.0, use_previous_data=True,
                                          extra_node_features=get_feature_builder("panels"))
    ds = j_config.get_dataset(jparam, frame_cfg, switch_to_val=True)
    frames = jax.tree.map(lambda *xs: jnp.asarray(np.stack(xs)), *ds.trajectory_frames(0))
    jsim = j_config.get_simulator(jparam, j_config.get_model(jparam))
    want = make_rollout_fn(jsim)(params, state, frames)
    n = int(got.trajectory.n_node)
    np.testing.assert_allclose(got.predictions[:, :n], np.asarray(want.predictions)[:, :n],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.rmse_all_rollout, float(want.rmse_all_rollout), rtol=1e-4)


@pytest.mark.parametrize("name", ["pinn-aneurysm", "coarse-aneurysm"])
def test_aneurysm_trains_and_predicts(fixtures, name):
    _, _, got, stack = _train_and_predict(name, fixtures)
    assert got.predictions.shape[-1] == 3  # 3-D velocity on the surface mesh
    assert stack.simulator.model.hidden_size == 64

