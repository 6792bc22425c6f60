"""The port's train -> predict CLIs on the CPU.

  * ``cli.train`` then ``cli.predict`` (``--device cpu``) for the three
    families on tests/test_learnability.py's protocol (2 training
    trajectories of 10 steps on 10x7 and 11x7 meshes, 1 validation
    trajectory, 8 epochs, lr 1e-3, warmup 10, batch 2): the rollout RMSE
    meets BASELINE.md's committed bars (epd < 0.006, transformer < 0.006,
    transolver < 0.02), the predicted XDMF reads back with the trajectory's
    frames, and predict's RMSE equals the last validation's (fp32, the same
    rollout; rtol 1e-6);
  * DeformingPlate (plate.json's transformer with world edges, 2 blocks,
    hidden 32) through ``cli.train --packed --bf16 --fused`` on a small
    synthetic plate (2 training trajectories on 8x6 and 9x6 sheets, 1
    validation trajectory, 12 frames each, radius 0.12, budget 64; the
    same protocol otherwise) meets ``PLATE_BAR``; ``cli.predict`` of its
    checkpoint (the rollout in fp32, each frame's world edges as the
    sidecar) matches JAX's rollout from the same weights in the concat
    layout to 1e-4;
  * DeformingPlate's MeshGraphNet (an ``epd`` with world edges: 2 blocks,
    hidden 32, 8 edge features) on the same plate workspace through
    ``cli.train --packed --bf16 --fused`` (the GraphNetBlock kernels'
    plain versions with the world aggregate as ``extra_agg``) and
    ``cli.predict``: finite losses, the XDMF written, and predict's RMSE
    validate's;
  * ``--num_partitions 2`` and ``--max_nodes_per_partition 30 --packed``
    train on sub-meshes and predict on the full mesh, predict's RMSE the
    last validation's;
  * ``--device cuda`` on a machine without a card raises;
  * an option of a later queue item raises, naming its ROADMAP item (the
    physics losses, ``--external`` and the xdmf dataset train through the
    CLIs: tests/test_torch_cli_physics.py).
"""

import json

import numpy as np
import pytest
import torch

from graph_physics_tpu_torch.cli import predict as predict_cli
from graph_physics_tpu_torch.cli import train as train_cli
from graph_physics_tpu_torch.dataset import synthetic

#: BASELINE.md:67-71
BARS = {"epd": 0.006, "transformer": 0.006, "transolver": 0.02}
#: the plate bar: the JAX package's CLI on this test's workspace and
#: protocol on the CPU,
#:   JAX_PLATFORMS=cpu python -m graph_physics_tpu.cli.train \
#:       --training_parameters_path plate.json --epochs 8 --batch_size 2 \
#:       --learning_rate 1e-3 --warmup 10 --packed --bf16 --fused
#: ended at val_all_rollout_rmse 0.00399 (seed 42) and 0.00430 (seed 1);
#: a sheet that never moves scores 0.00486, and the port's CLI 0.00109
#: (seed 42), 0.00329, 0.00291 and 0.00494 (seeds 1-3): 0.006 leaves 1.5x
#: JAX's seed-42 number as headroom. 96 steps of training beat the
#: unmoving sheet only narrowly, so the bar holds the run to JAX's, not to
#: a learned deflection.
PLATE_BAR = 0.006
MODELS = {
    "epd": {"type": "epd", "message_passing_num": 3, "hidden_size": 32, "edge_input_size": 3},
    "transformer": {"type": "transformer", "message_passing_num": 2, "hidden_size": 32,
                    "num_heads": 4, "edge_input_size": 0},
    "transolver": {"type": "transolver", "message_passing_num": 2, "hidden_size": 32,
                   "num_heads": 4, "slice_num": 8, "edge_input_size": 0},
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: these tiny models gain nothing from more, and a
    test worker sharing the machine with others slows down many-fold when
    each process runs one thread a core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    train, meta = synthetic.write_h5_dataset(str(d / "train.h5"), num_trajectories=2, nx=10,
                                             ny=7, num_steps=10, meta_path=str(d / "meta.json"))
    val, _ = synthetic.write_h5_dataset(str(d / "val.h5"), num_trajectories=1, nx=10, ny=7,
                                        num_steps=10, meta_path=str(d / "m2.json"))
    return d, train, val, meta


def write_config(d, train, val, meta, family, **blocks):
    param = {
        "dataset": {"extension": "h5", "train_path": train, "test_path": val,
                    "meta_path": meta, "targets": ["velocity"], "khop": 1},
        "model": {**MODELS[family], "node_input_size": 2, "output_size": 2},
        "index": {"feature_index_start": 0, "feature_index_end": 2, "output_index_start": 0,
                  "output_index_end": 2, "node_type_index": 2},
        "transformations": {"preprocessing": {"noise": 0, "noise_index_start": [0],
                                              "noise_index_end": [2], "masking": 0},
                            "world_pos_parameters": {"use": False}},
        "training": {},
    }
    for key, value in blocks.items():
        param[key] = {**param.get(key, {}), **value}
    path = d / f"{family}_{len(list(d.glob('*.json')))}.json"
    path.write_text(json.dumps(param))
    return str(path)


@pytest.mark.parametrize("family", sorted(BARS))
def test_train_then_predict_meets_the_bar(workspace, family):
    d, train, val, meta = workspace
    cfg = write_config(d, train, val, meta, family)
    out = d / "runs"
    assert train_cli.main(["--training_parameters_path", cfg, "--epochs", "8",
                           "--batch_size", "2", "--learning_rate", "1e-3", "--warmup", "10",
                           "--out_dir", str(out), "--run_name", family,
                           "--device", "cpu"]) == 0
    records = [json.loads(line) for line in open(out / family / f"{family}.metrics.jsonl")]
    last = [r for r in records if "val_all_rollout_rmse" in r][-1]
    assert last["epoch"] == 7
    assert last["val_all_rollout_rmse"] < BARS[family], (
        f"{family}: rollout RMSE {last['val_all_rollout_rmse']:.5f} above the committed bar")
    assert predict_cli.main(["--training_parameters_path", cfg, "--model_path",
                             str(out / family / "checkpoints"), "--out_dir", str(d / "preds"),
                             "--run_name", family, "--device", "cpu"]) == 0
    from graph_physics_tpu_torch.utils.xdmf import XdmfTimeSeriesReader

    reader = XdmfTimeSeriesReader(str(d / "preds" / family / "trajectory_0.xdmf"))
    assert len(reader) == 9
    pos, cells, fields, time = reader.read_frame(3)
    assert pos.shape == (70, 3) and cells.shape == (108, 3)
    assert set(fields) == {"prediction", "target"} and fields["prediction"].shape == (70, 2)
    assert np.isfinite(fields["prediction"]).all() and time == pytest.approx(0.03)
    reader.close()
    # predict's rollout is validation's: the same RMSE for the same weights
    from graph_physics_tpu_torch.cli.common import load_inference_stack

    args = predict_cli.build_argparser().parse_args(
        ["--training_parameters_path", cfg, "--model_path", str(out / family / "checkpoints"),
         "--device", "cpu"])
    res = predict_cli.predict(load_inference_stack(args))
    np.testing.assert_allclose(res[0].rmse_all_rollout, last["val_all_rollout_rmse"], rtol=1e-6)


@pytest.mark.parametrize("flags", [["--num_partitions", "2"],
                                   ["--max_nodes_per_partition", "30", "--packed"]],
                         ids=["num2", "max30-packed"])
def test_sub_mesh_partitions_train_then_predict(workspace, flags):
    """Training on sub-meshes (2 parts a frame, or 3 of at most 30 nodes),
    validation and predict on the full mesh: finite losses, twice the
    steps of the whole-mesh run at least, predict's RMSE validate's."""
    d, train, val, meta = workspace
    cfg = write_config(d, train, val, meta, "epd")
    run = "parts_" + flags[1]
    out = d / "runs"
    assert train_cli.main(["--training_parameters_path", cfg, "--epochs", "2",
                           "--batch_size", "2", "--warmup", "10", "--out_dir", str(out),
                           "--run_name", run, "--device", "cpu", *flags]) == 0
    records = [json.loads(line) for line in open(out / run / f"{run}.metrics.jsonl")]
    last = [r for r in records if "val_all_rollout_rmse" in r][-1]
    assert max(r["step"] for r in records) >= 36  # the whole mesh takes 18 steps
    assert all(np.isfinite(r[k]) for r in records for k in ("loss", "val_all_rollout_rmse")
               if k in r)
    from graph_physics_tpu_torch.cli.common import load_inference_stack

    args = predict_cli.build_argparser().parse_args(
        ["--training_parameters_path", cfg, "--model_path", str(out / run / "checkpoints"),
         "--device", "cpu"])
    res = predict_cli.predict(load_inference_stack(args))
    assert res[0].predictions.shape[1] >= 70  # the full 10x7 mesh
    np.testing.assert_allclose(res[0].rmse_all_rollout, last["val_all_rollout_rmse"], rtol=1e-6)


@pytest.fixture(scope="module")
def plate_workspace(tmp_path_factory):
    d = tmp_path_factory.mktemp("plate_cli")
    train, meta = synthetic.write_plate_h5_dataset(str(d / "train.h5"), num_trajectories=2,
                                                   num_steps=12, meta_path=str(d / "meta.json"))
    val, _ = synthetic.write_plate_h5_dataset(str(d / "val.h5"), num_trajectories=1,
                                              num_steps=12, meta_path=str(d / "m2.json"))
    param = {
        "dataset": {"extension": "h5", "train_path": train, "test_path": val,
                    "meta_path": meta, "targets": ["world_pos"], "khop": 1},
        "model": {"type": "transformer", "message_passing_num": 2, "hidden_size": 32,
                  "num_heads": 4, "node_input_size": 6, "output_size": 3,
                  "edge_input_size": 0},
        "index": {"feature_index_start": 0, "feature_index_end": 6, "output_index_start": 0,
                  "output_index_end": 3, "node_type_index": 6},
        "transformations": {
            "preprocessing": {"noise": 0, "noise_index_start": [0], "noise_index_end": [3],
                              "masking": 0},
            "world_pos_parameters": {"use": True, "world_pos_index_start": 0,
                                     "world_pos_index_end": 3, "radius": 0.12,
                                     "edge_budget": 64}},
        "training": {},
    }
    (d / "plate.json").write_text(json.dumps(param))
    return d, str(d / "plate.json")


def test_plate_train_then_predict_meets_the_bar_and_matches_jax(plate_workspace, monkeypatch):
    d, cfg = plate_workspace
    out = d / "runs"
    assert train_cli.main(["--training_parameters_path", cfg, "--epochs", "8",
                           "--batch_size", "2", "--learning_rate", "1e-3", "--warmup", "10",
                           "--packed", "--bf16", "--fused", "--out_dir", str(out),
                           "--run_name", "plate", "--device", "cpu"]) == 0
    records = [json.loads(line) for line in open(out / "plate" / "plate.metrics.jsonl")]
    last = [r for r in records if "val_all_rollout_rmse" in r][-1]
    assert last["epoch"] == 7
    assert last["val_all_rollout_rmse"] < PLATE_BAR, (
        f"plate: rollout RMSE {last['val_all_rollout_rmse']:.5f} above the committed bar")
    from graph_physics_tpu_torch.cli.common import load_inference_stack

    ckpt = str(out / "plate" / "checkpoints")
    argv = ["--training_parameters_path", cfg, "--model_path", ckpt, "--device", "cpu"]
    res = predict_cli.predict(load_inference_stack(
        predict_cli.build_argparser().parse_args(argv + ["--bf16"])), fused=True)
    np.testing.assert_allclose(res[0].rmse_all_rollout, last["val_all_rollout_rmse"], rtol=1e-6)
    assert predict_cli.main(argv + ["--bf16", "--fused", "--out_dir", str(d / "preds")]) == 0

    # the same weights in JAX, rolled out in the concat layout, fp32
    import jax
    import jax.numpy as jnp

    from graph_physics_tpu import native as j_native
    from graph_physics_tpu.training import config as j_config
    from graph_physics_tpu.training.rollout import make_rollout_fn
    from graph_physics_tpu.training.transforms import WorldPosConfig, make_eval_transform
    from graph_physics_tpu.utils.convert import convert_state_dict

    stack = load_inference_stack(predict_cli.build_argparser().parse_args(argv))
    got = predict_cli.predict(stack)[0]
    jparam = j_config.load_params(cfg)
    params, state = convert_state_dict(
        {k: v.detach().float().numpy() for k, v in stack.simulator.state_dict().items()},
        jparam)
    monkeypatch.setattr(j_native, "radius_cross_pairs", lambda *a, **k: None)
    monkeypatch.setattr(j_native, "radius_pairs", lambda *a, **k: None)
    ds = j_config.get_dataset(jparam, j_config.get_frame_config(jparam, masking_ratio=0.0),
                              switch_to_val=True)
    frames = jax.tree.map(lambda *xs: jnp.asarray(np.stack(xs)), *ds.trajectory_frames(0))
    jsim = j_config.get_simulator(jparam, j_config.get_model(jparam))
    want = make_rollout_fn(jsim, frame_transform=make_eval_transform(WorldPosConfig(0, 3)))(
        params, state, frames)
    n = int(got.trajectory.n_node)
    np.testing.assert_allclose(got.predictions[:, :n], np.asarray(want.predictions)[:, :n],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.rmse_all_rollout, float(want.rmse_all_rollout), rtol=1e-4)


def test_plate_epd_trains_and_predicts_through_the_clis(plate_workspace):
    d, cfg = plate_workspace
    param = json.loads(open(cfg).read())
    param["model"] = {"type": "epd", "message_passing_num": 2, "hidden_size": 32,
                      "node_input_size": 6, "output_size": 3, "edge_input_size": 8}
    epd_cfg = d / "plate_epd.json"
    epd_cfg.write_text(json.dumps(param))
    out = d / "runs_epd"
    assert train_cli.main(["--training_parameters_path", str(epd_cfg), "--epochs", "2",
                           "--batch_size", "2", "--learning_rate", "1e-3", "--warmup", "5",
                           "--packed", "--bf16", "--fused", "--out_dir", str(out),
                           "--run_name", "plate_epd", "--device", "cpu"]) == 0
    records = [json.loads(line) for line in open(out / "plate_epd" / "plate_epd.metrics.jsonl")]
    last = [r for r in records if "val_all_rollout_rmse" in r][-1]
    assert last["epoch"] == 1 and np.isfinite(last["train_loss_epoch"])
    assert np.isfinite(last["val_all_rollout_rmse"])
    argv = ["--training_parameters_path", str(epd_cfg), "--model_path",
            str(out / "plate_epd" / "checkpoints"), "--bf16", "--fused", "--device", "cpu"]
    assert predict_cli.main(argv + ["--out_dir", str(d / "preds_epd"), "--run_name", "p"]) == 0
    assert (d / "preds_epd" / "p" / "trajectory_0.xdmf").exists()
    from graph_physics_tpu_torch.cli.common import load_inference_stack

    res = predict_cli.predict(load_inference_stack(predict_cli.build_argparser().parse_args(
        argv)), fused=True)
    np.testing.assert_allclose(res[0].rmse_all_rollout, last["val_all_rollout_rmse"], rtol=1e-6)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
@pytest.mark.parametrize("cli", ["train", "predict"])
def test_cuda_without_a_card_raises(workspace, cli):
    d, train, val, meta = workspace
    cfg = write_config(d, train, val, meta, "epd")
    argv = ["--training_parameters_path", cfg, "--device", "cuda"]
    with pytest.raises(RuntimeError, match="is_available"):
        if cli == "train":
            train_cli.main(argv)
        else:
            predict_cli.main(argv + ["--model_path", str(d / "none")])


@pytest.mark.parametrize("flags,blocks,item", [
    ([], {"training": {"use_temporal_block": True}}, "A 7"),
    ([], {"training": {"use_spatial_mtp": True}}, "A 7"),
    ([], {"model": {"use_gated_mlp": True}}, "A 7"),
    (["--num_dp_devices", "2"], {}, "A 9"),
    (["--multihost"], {}, "A 9"),
])
def test_unported_option_names_its_roadmap_item(workspace, flags, blocks, item):
    d, train, val, meta = workspace
    cfg = write_config(d, train, val, meta, "epd", **blocks)
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        train_cli.main(["--training_parameters_path", cfg, "--out_dir", str(d / "refused"),
                        "--device", "cpu", *flags])
