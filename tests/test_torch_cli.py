"""The port's train -> predict CLIs on the CPU.

  * ``cli.train`` then ``cli.predict`` (``--device cpu``) for the three
    families on tests/test_learnability.py's protocol (2 training
    trajectories of 10 steps on 10x7 and 11x7 meshes, 1 validation
    trajectory, 8 epochs, lr 1e-3, warmup 10, batch 2): the rollout RMSE
    meets BASELINE.md's committed bars (epd < 0.006, transformer < 0.006,
    transolver < 0.02), the predicted XDMF reads back with the trajectory's
    frames, and predict's RMSE equals the last validation's (fp32, the same
    rollout; rtol 1e-6);
  * ``--device cuda`` on a machine without a card raises;
  * an option of a later queue item raises, naming its ROADMAP item.
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
    (["--use_previous_data"], {}, "A 5"),
    (["--external", "aneurysm"], {}, "A 5"),
    ([], {"transformations": {"world_pos_parameters": {"use": True}}}, "A 5"),
    ([], {"loss": {"type": ["l2loss", "gradientloss"], "weights": [1, 1]}}, "A 6"),
    ([], {"loss": {"type": ["l2loss"], "gradient_method": "least_squares"}}, "A 6"),
    ([], {"training": {"use_temporal_block": True}}, "A 7"),
    ([], {"training": {"use_spatial_mtp": True}}, "A 7"),
    ([], {"model": {"use_gated_mlp": True}}, "A 7"),
    (["--num_dp_devices", "2"], {}, "A 9"),
    (["--multihost"], {}, "A 9"),
    (["--num_partitions", "4"], {}, "A 4"),
    ([], {"dataset": {"extension": "xdmf"}}, "A 4"),
])
def test_unported_option_names_its_roadmap_item(workspace, flags, blocks, item):
    d, train, val, meta = workspace
    cfg = write_config(d, train, val, meta, "epd", **blocks)
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        train_cli.main(["--training_parameters_path", cfg, "--out_dir", str(d / "refused"),
                        "--device", "cpu", *flags])
