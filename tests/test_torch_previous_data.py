"""The rollout's previous-data slice (``previous_data_slice``,
``--use_previous_data``, ROADMAP A 5.3) against the JAX package on the
CPU, on the synthetic aneurysm trajectory built as ``--external
aneurysm`` builds it (external/aneurysm.build_features: the acceleration
Vitesse(t) − Vitesse(t−1) in the columns ``entry.aneurysm_previous_data``
reads off its x layout, 6:9):

  * those columns hold the acceleration;
  * coarse-aneurysm.json's transformer (2 blocks), fp32, from JAX's
    weights: the port's single rollout and its packed R=2 rollout carrying
    the columns match JAX's ``make_rollout_fn`` and vmapped
    ``make_batched_rollout_fn`` with the slice to 1e-4 (a rollout compounds
    fp32 reorderings), and each step's input holds the carry, the last
    prediction less the last input's velocity, where the frame holds its
    own acceleration;
  * ``cli.train --use_previous_data`` then ``cli.predict
    --use_previous_data`` on a tiny aneurysm xdmf fixture: predict's RMSE
    is validate's (1e-6) and JAX's rollout of the same weights with the
    slice (1e-4);
  * ``--use_previous_data`` without ``--external`` makes the frames carry
    the previous frame's data (JAX cli/train.py:175, cli/common.py:54).
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_physics_tpu.dataset import preprocessing as j_pre
from graph_physics_tpu.external import get_feature_builder as j_features
from graph_physics_tpu.training import config as j_config
from graph_physics_tpu.training import rollout as j_rollout
from graph_physics_tpu_torch import entry
from graph_physics_tpu_torch.cli import predict as predict_cli
from graph_physics_tpu_torch.cli import train as train_cli
from graph_physics_tpu_torch.cli.common import load_inference_stack
from graph_physics_tpu_torch.dataset import preprocessing as t_pre
from graph_physics_tpu_torch.dataset import synthetic
from graph_physics_tpu_torch.training import config as t_config
from graph_physics_tpu_torch.training import rollout as t_rollout
from graph_physics_tpu_torch.training.trainer import rollout_graph, stack_trajectory
from graph_physics_tpu_torch.utils.convert import load_jax_params

STEPS, BLOCKS = 6, 2
CONFIG_DIR = Path(__file__).resolve().parents[1] / "training_config"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _param():
    param = entry.aneurysm_param("coarse")
    param["model"]["message_passing_num"] = BLOCKS
    return param


def _frames(pre, features, fields, start):
    """Frames start..start+STEPS-1 of the aneurysm fields, built by
    ``pre``'s FrameBuilder with ``features``, the previous frame's data."""
    cfg = pre.FrameConfig(targets=("Vitesse",), use_previous_data=True,
                          extra_node_features=features)
    b = pre.FrameBuilder(cfg, synthetic.xdmf_meta_dict(len(fields["mesh_pos"]), 0.01))
    return [b.build(fields, t, cache_key=0, train=False) for t in range(start, start + STEPS)]


@pytest.fixture(scope="module")
def aneurysm():
    fields = entry.aneurysm_fields(7, 6, STEPS + 3)
    port = [_frames(t_pre, entry.aneurysm_frame_config().extra_node_features, fields, s)
            for s in (1, 2)]
    jax_frames = [_frames(j_pre, j_features("aneurysm"), fields, s) for s in (1, 2)]
    param = _param()
    jsim = j_config.get_simulator(param, j_config.get_model(param))
    g0 = jax.tree.map(jnp.asarray, jax_frames[0][0])
    params = jsim.init_params(jax.random.PRNGKey(0), g0)
    _, _, _, state = jsim.prepare(jsim.init_state(), g0, is_training=True)
    tsim = t_config.get_simulator(param, t_config.get_model(param))
    load_jax_params(tsim, jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state))
    return dict(fields=fields, port=port, jax=jax_frames, jsim=jsim, params=params,
                state=state, tsim=tsim, prev=entry.aneurysm_previous_data(fields))


def test_previous_data_columns_hold_the_acceleration(aneurysm):
    ps, pe = aneurysm["prev"]
    assert (ps, pe) == (6, 9)
    vel = aneurysm["fields"]["Vitesse"]
    for i, g in enumerate(aneurysm["port"][0]):
        n = int(g.n_node)
        np.testing.assert_array_equal(g.x[:n, ps:pe], vel[i + 1] - vel[i])


def _stack(frames):
    return jax.tree.map(lambda *xs: jnp.asarray(np.stack(xs)), *frames)


@pytest.mark.parametrize("batched", [False, True])
def test_previous_data_rollout_matches_jax(aneurysm, batched):
    a, prev = aneurysm, aneurysm["prev"]
    windows = [0, 1] if batched else [0]
    if batched:
        jframes = jax.tree.map(lambda *xs: jnp.stack(xs), *[_stack(a["jax"][w]) for w in windows])
        want = j_rollout.make_batched_rollout_fn(a["jsim"], previous_data_slice=prev)(
            a["params"], a["state"], jframes)
        frames = rollout_graph([stack_trajectory(a["port"][w]) for w in windows], "cpu")
        make = t_rollout.make_batched_rollout_fn
    else:
        want = j_rollout.make_rollout_fn(a["jsim"], previous_data_slice=prev)(
            a["params"], a["state"], _stack(a["jax"][0]))
        frames = rollout_graph([stack_trajectory(a["port"][0])], "cpu", packed=False)
        make = t_rollout.make_rollout_fn
    inputs = []
    forward = a["tsim"].forward

    def recording(graph, **kw):
        inputs.append(graph.x.clone())
        return forward(graph, **kw)

    a["tsim"].forward = recording
    try:
        got = make(a["tsim"], previous_data_slice=prev)(frames)
    finally:
        del a["tsim"].forward
    n = int(a["port"][0][0].n_node)
    preds = got.predictions.numpy()
    if batched:  # [T, N, R, F] -> [R, T, N, F]
        preds = preds.transpose(2, 0, 1, 3)
    np.testing.assert_allclose(preds[..., :n, :], np.asarray(want.predictions)[..., :n, :],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.rmse_all_rollout.numpy().reshape(-1),
                               np.asarray(want.rmse_all_rollout).reshape(-1), rtol=1e-4)
    # the carry: step t reads predicted(t-1) - current(t-1) in the slice,
    # not the frame's own acceleration
    ps, pe = prev
    for t in range(1, STEPS):
        np.testing.assert_array_equal(inputs[t][..., ps:pe].numpy(),
                                      (got.predictions[t - 1] - inputs[t - 1][..., 0:3]).numpy())
        assert not torch.equal(inputs[t][:n, ..., ps:pe], frames.x[t][:n, ..., ps:pe])


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("previous_data")
    paths = synthetic.write_workload_fixture("aneurysm", str(d / "aneurysm"), num_trajectories=2,
                                             num_steps=STEPS)
    return d, paths


def test_cli_previous_data_trains_and_predicts_as_jax_rolls_out(fixture_dir):
    from graph_physics_tpu.utils.convert import convert_state_dict

    d, (train, test, meta) = fixture_dir
    param = _param()
    param["dataset"].update(train_path=train, test_path=test, meta_path=meta)
    cfg = d / "coarse.json"
    cfg.write_text(json.dumps(param))
    prev = ["--use_previous_data", "--previous_data_start", "6", "--previous_data_end", "9"]
    out = d / "runs"
    assert train_cli.main(["--training_parameters_path", str(cfg), "--epochs", "2",
                           "--batch_size", "2", "--warmup", "5", "--packed", "--external",
                           "aneurysm", "--out_dir", str(out), "--run_name", "prev",
                           "--device", "cpu", *prev]) == 0
    records = [json.loads(line) for line in open(out / "prev" / "prev.metrics.jsonl")]
    last = [r for r in records if "val_all_rollout_rmse" in r][-1]
    argv = ["--training_parameters_path", str(cfg), "--model_path",
            str(out / "prev" / "checkpoints"), "--external", "aneurysm", "--device", "cpu"]
    stack = load_inference_stack(predict_cli.build_argparser().parse_args(argv + prev))
    assert stack.previous_data_slice == (6, 9)
    got = predict_cli.predict(stack)[0]
    np.testing.assert_allclose(got.rmse_all_rollout, last["val_all_rollout_rmse"], rtol=1e-6)

    jparam = j_config.load_params(str(cfg))
    params, state = convert_state_dict(
        {k: v.detach().float().numpy() for k, v in stack.simulator.state_dict().items()},
        jparam)
    fc = j_config.get_frame_config(jparam, masking_ratio=0.0, use_previous_data=True,
                                   extra_node_features=j_features("aneurysm"))
    ds = j_config.get_dataset(jparam, fc, switch_to_val=True)
    jsim = j_config.get_simulator(jparam, j_config.get_model(jparam))
    want = j_rollout.make_rollout_fn(jsim, previous_data_slice=(6, 9))(
        params, state, _stack(ds.trajectory_frames(0)))
    n = int(got.trajectory.n_node)
    np.testing.assert_allclose(got.predictions[:, :n], np.asarray(want.predictions)[:, :n],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.rmse_all_rollout, float(want.rmse_all_rollout), rtol=1e-4)


def test_use_previous_data_without_external_carries_the_previous_frame(tmp_path):
    """cylinder-like h5 frames, no feature builder: the flag alone makes
    the frames carry the previous frame's data (so frame 0 is no sample)
    and the rollouts carry the velocity columns 0:2."""
    from graph_physics_tpu_torch.cli.common import external_features

    h5, meta = synthetic.write_h5_dataset(str(tmp_path / "d.h5"), num_trajectories=1, nx=6,
                                          ny=5, num_steps=6, meta_path=str(tmp_path / "m.json"))
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({
        "dataset": {"extension": "h5", "train_path": h5, "test_path": h5, "meta_path": meta,
                    "targets": ["velocity"], "khop": 1},
        "model": {"type": "epd", "message_passing_num": 1, "hidden_size": 8,
                  "node_input_size": 2, "output_size": 2, "edge_input_size": 3},
        "index": {"feature_index_start": 0, "feature_index_end": 2, "output_index_start": 0,
                  "output_index_end": 2, "node_type_index": 2},
        "transformations": {"world_pos_parameters": {"use": False}}, "training": {}}))
    prev = ["--use_previous_data", "--previous_data_start", "0", "--previous_data_end", "2"]
    out = tmp_path / "runs"
    assert train_cli.main(["--training_parameters_path", str(cfg), "--batch_size", "2",
                           "--packed", "--out_dir", str(out), "--run_name", "r", "--device",
                           "cpu", *prev]) == 0
    records = [json.loads(line) for line in open(out / "r" / "r.metrics.jsonl")]
    last = [r for r in records if "val_all_rollout_rmse" in r][-1]
    args = predict_cli.build_argparser().parse_args(
        ["--training_parameters_path", str(cfg), "--model_path", str(out / "r" / "checkpoints"),
         "--device", "cpu", *prev])
    assert external_features(args) == (None, True)
    assert external_features(predict_cli.build_argparser().parse_args([
        "--training_parameters_path", str(cfg), "--model_path", "x"])) == (None, False)
    stack = load_inference_stack(args)
    frames = stack.dataset.trajectory_frames(0)
    assert len(frames) == 4 and frames[0].prev is not None
    got = predict_cli.predict(stack)[0]
    np.testing.assert_allclose(got.rmse_all_rollout, last["val_all_rollout_rmse"], rtol=1e-6)
