"""The port's Trainer against the JAX package's, on the CPU, on an h5
fixture of 2 training trajectories (10x7 and 11x7 meshes, 10 steps) and 1
validation trajectory, both written by the JAX package:

  * an ``epd`` of 3 blocks at hidden 32, fp32, packed batches, noise 0,
    masking 0, started from JAX's initial parameters (utils/convert.
    load_jax_params): over 2 epochs every logged loss and grad norm and
    the three validation metrics agree within 1e-4 relative, the logged
    grad norms within 1e-3, without and with gradient accumulation (JAX's
    optax.MultiSteps);
  * ``steps_per_dispatch=2`` gives the bits of 1;
  * resume: 2 epochs straight equal 1 epoch, a resume and 1 epoch bit for
    bit, with noise on: parameters, optimizer moments and count,
    normalizer accumulators and step;
  * the fused path (bf16, the NK layout; the kernels' plain versions on
    the CPU) gives the same bits with broadcast_static on and off;
  * the checkpoint manager keeps the steps JAX's orbax manager keeps, by
    recency and by a monitored metric.

Tolerances: 1e-4 relative on the JAX comparison of losses and metrics
(two fp32 programs whose sums run in different orders, compounding over
20 Adam steps), 1e-3 on grad norms (``GRAD_NORM_RTOL``); exact
(torch.equal) everywhere else.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_physics_tpu.dataset import synthetic as jsynth
from graph_physics_tpu.dataset.h5_dataset import H5Dataset as JH5
from graph_physics_tpu.dataset.preprocessing import FrameConfig as JFC
from graph_physics_tpu.models.processors import EncodeProcessDecode as JEPD
from graph_physics_tpu.models.simulator import Simulator as JSim
from graph_physics_tpu.training import checkpoint as jckpt
from graph_physics_tpu.training.loss import LossType
from graph_physics_tpu.training.trainer import Trainer as JTrainer
from graph_physics_tpu.training.trainer import TrainerConfig as JTC
from graph_physics_tpu_torch.dataset.h5_dataset import H5Dataset as TH5
from graph_physics_tpu_torch.dataset.preprocessing import FrameConfig as TFC
from graph_physics_tpu_torch.models.layers import lecun_parameters
from graph_physics_tpu_torch.models.processors import EncodeProcessDecode as TEPD
from graph_physics_tpu_torch.models.simulator import Simulator as TSim
from graph_physics_tpu_torch.training import checkpoint as tckpt
from graph_physics_tpu_torch.training.loss import l2_loss
from graph_physics_tpu_torch.training.step import NoiseConfig
from graph_physics_tpu_torch.training.trainer import Trainer as TTrainer
from graph_physics_tpu_torch.training.trainer import TrainerConfig as TTC
from graph_physics_tpu_torch.utils.convert import load_jax_params

RTOL = 1e-4
SIM_KW = dict(node_input_size=11, edge_input_size=3, output_size=2, feature_index_start=0,
              feature_index_end=2, output_index_start=0, output_index_end=2, node_type_index=2)
MODEL_KW = dict(message_passing_num=3, node_input_size=11, edge_input_size=3, output_size=2,
                hidden_size=32)
LOGGED = ("loss", "train_loss_epoch", "val_all_rollout_rmse", "val_1step_rmse", "val_loss")
#: the grad norm's bound: a relu pre-activation within rounding of its kink
#: passes the cotangent on one side and stops it on the other, so one
#: step's gradient can differ by a whole term while the losses agree to
#: 4e-7 (with accumulation, step 14: 3.1e-4)
GRAD_NORM_RTOL = 1e-3


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
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("trainer")
    train, meta = jsynth.write_h5_dataset(str(d / "train.h5"), num_trajectories=2, nx=10, ny=7,
                                          num_steps=10, meta_path=str(d / "meta.json"))
    val, _ = jsynth.write_h5_dataset(str(d / "val.h5"), num_trajectories=1, nx=10, ny=7,
                                     num_steps=10, meta_path=str(d / "m2.json"))
    return d, train, val, meta


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def port_trainer(data, run, dtype=torch.float32, noise=None, seed=0, **cfg):
    d, train, val, meta = data
    sim = TSim(**SIM_KW, model=TEPD(**MODEL_KW, dtype=dtype))
    lecun_parameters(sim, torch.Generator().manual_seed(seed))
    fc = TFC(targets=("velocity",))
    cfg = TTC(**{**dict(epochs=2, batch_size=2, learning_rate=1e-3, warmup=10, log_every=1,
                        packed=True, out_dir=str(d / "runs"), run_name=run), **cfg})
    return TTrainer(sim, TH5(train, meta, fc), TH5(val, meta, fc), l2_loss, cfg,
                    noise_cfg=noise, device="cpu")


def _jax_run(data, run, accumulate):
    d, train, val, meta = data
    sim = JSim(**SIM_KW, model=JEPD(**MODEL_KW))
    fc = JFC(targets=("velocity",))
    cfg = JTC(epochs=2, batch_size=2, learning_rate=1e-3, warmup=10, log_every=1, packed=True,
              accumulate_grad_batches=accumulate, out_dir=str(d / "runs"), run_name=run)
    tr = JTrainer(sim, JH5(train, meta, fc), JH5(val, meta, fc), LossType.L2LOSS, cfg)
    tr.init_or_resume()
    return tr, jax.tree.map(np.asarray, tr.state.params), jax.tree.map(np.asarray,
                                                                        tr.state.sim_state)


@pytest.mark.parametrize("accumulate", [1, 2])
def test_trainer_matches_jax(data, accumulate):
    jtr, params, sim_state = _jax_run(data, f"jax{accumulate}", accumulate)
    jtr.fit()
    ttr = port_trainer(data, f"port{accumulate}", accumulate_grad_batches=accumulate)
    load_jax_params(ttr.sim, params, sim_state)
    ttr.fit()
    d = data[0]
    want = _records(d / "runs" / f"jax{accumulate}" / f"jax{accumulate}.metrics.jsonl")
    got = _records(d / "runs" / f"port{accumulate}" / f"port{accumulate}.metrics.jsonl")
    assert [r["step"] for r in got] == [r["step"] for r in want]
    assert sum("val_all_rollout_rmse" in r for r in got) == 2
    for a, b in zip(got, want):
        for key in LOGGED:
            if key in b:
                np.testing.assert_allclose(a[key], b[key], rtol=RTOL, err_msg=f"{key} @ {b}")
        if "grad_norm" in b:
            np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=GRAD_NORM_RTOL)
        if "lr" in b:  # JAX evaluates the schedule in fp32, the port in float64
            np.testing.assert_allclose(a["lr"], b["lr"], rtol=1e-5)
    assert int(jtr.state.step) == ttr.state.step == 20
    assert ttr.state.optimizer.count == 20 // accumulate


def _state(tr):
    """Parameters, normalizer accumulators, optimizer moments and count, step."""
    out = {k: v.clone() for k, v in tr.sim.state_dict().items()}
    opt = tr.state.optimizer
    for i, p in enumerate(opt.params):
        for k, v in opt.adamw.state.get(p, {}).items():
            out[f"opt.{i}.{k}"] = v.clone()
    out["count"] = torch.tensor(opt.count)
    out["step"] = torch.tensor(tr.state.step)
    return out


def _assert_same_state(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_steps_per_dispatch_gives_the_same_bits(data):
    noise = NoiseConfig(starts=(0,), ends=(2,), scales=(0.02,))
    one = port_trainer(data, "spd1", noise=noise)
    one.fit()
    two = port_trainer(data, "spd2", noise=noise, steps_per_dispatch=2)
    two.fit()
    _assert_same_state(_state(one), _state(two))
    d = data[0]
    a = [r for r in _records(d / "runs/spd1/spd1.metrics.jsonl") if "train_loss_epoch" in r]
    b = [r for r in _records(d / "runs/spd2/spd2.metrics.jsonl") if "train_loss_epoch" in r]
    assert [r["train_loss_epoch"] for r in a] == [r["train_loss_epoch"] for r in b]


def test_resume_is_bit_exact(data):
    noise = NoiseConfig(starts=(0,), ends=(2,), scales=(0.02,))
    straight = port_trainer(data, "straight", noise=noise)
    straight.fit()
    first = port_trainer(data, "resumed", noise=noise)
    first.fit(stop_after_epochs=1)
    assert first.state.step == 10 and first.manager.all_steps() == [10]
    # a fresh process state: new weights, new optimizer, restored from disk
    second = port_trainer(data, "resumed", noise=noise, seed=123)
    second.fit(resume=True)
    assert second.state.step == straight.state.step == 20
    _assert_same_state(_state(straight), _state(second))
    norm = second.sim._node_normalizer
    assert float(norm._num_accumulations) == 20.0
    assert second.run_metadata["epoch"] == 0  # from the checkpoint of epoch 0


def test_fused_path_same_bits_with_broadcast_static_on_and_off(data):
    states = []
    for broadcast in (True, False):
        tr = port_trainer(data, f"fused{broadcast}", dtype=torch.bfloat16, fused=True,
                          broadcast_static=broadcast, epochs=1)
        tr.fit()
        states.append(_state(tr))
        assert type(tr.sim.model.tiling).__name__ == "NKTiling"
    _assert_same_state(*states)


@pytest.mark.parametrize("metrics", [
    None,
    [5.0, 3.0, 4.0, 1.0, 6.0, 2.0],
    [5.0, None, 4.0, 1.0, None, 2.0],
    [1.0, 2.0, 2.0, 2.0, 5.0, 0.5],
])
def test_checkpoint_policy_matches_orbax(tmp_path, metrics):
    best = None if metrics is None else "m"
    values = metrics or [None] * 6
    jm = jckpt.make_manager(str(tmp_path / "jax"), best_metric=best)
    tm = tckpt.make_manager(str(tmp_path / "port"), best_metric=best)
    for step, v in enumerate(values, start=1):
        m = None if v is None else {"m": v}
        jm.save(step, args=jckpt.ocp.args.Composite(
            state=jckpt.ocp.args.StandardSave({"a": jnp.ones(2)})), metrics=m)
        jm.wait_until_finished()
        tm.save(step, {"step": step}, metrics=m)
    assert tm.all_steps() == sorted(jm.all_steps())
    assert tm.latest_step() == jm.latest_step()
    if best:
        assert tm.best_step() == jm.best_step()
    assert tm.restore()["step"] == tm.latest_step()


def test_profile_dir_traces_steps_two_to_four(data, tmp_path):
    tr = port_trainer(data, "profiled", epochs=1, profile_dir=str(tmp_path / "trace"))
    tr.fit()
    traces = list((tmp_path / "trace").glob("trace_*.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0


def test_wandb_without_the_package_raises(data, tmp_path):
    from graph_physics_tpu_torch.training.logging import MetricsLogger

    try:
        import wandb  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="--use_wandb"):
            MetricsLogger(str(tmp_path), use_wandb=True)
    else:
        pytest.skip("wandb is installed")


def test_simulator_artifact_and_meter_round_trip(data, tmp_path):
    from graph_physics_tpu.utils.meter import AverageValueMeter as JMeter
    from graph_physics_tpu_torch.utils.meter import AverageValueMeter

    tr = port_trainer(data, "artifact")
    tckpt.save_simulator(str(tmp_path / "sim"), tr.sim, extra={"k": 1})
    other = port_trainer(data, "artifact2", seed=9)
    tckpt.load_simulator(str(tmp_path / "sim"), other.sim)
    for (k, a), b in zip(tr.sim.state_dict().items(), other.sim.state_dict().values()):
        assert torch.equal(a, b), k
    assert json.loads((tmp_path / "sim" / "extra.json").read_text()) == {"k": 1}
    tm, jm = AverageValueMeter(), JMeter()
    for v, n in ((1.0, 1), (4.0, 2), (-2.5, 3)):
        tm.add(v, n)
        jm.add(v, n)
    assert tm.value() == jm.value() and tm.sum == jm.sum


def test_stacked_batch_runs_the_processor_sample_by_sample(data):
    """A stacked [B, N, F] batch of an ``epd`` (JAX vmaps the processor):
    each sample's output equals that frame's own forward, the normalizers
    having seen the whole batch."""
    from graph_physics_tpu_torch.core.graph import MeshGraph
    from graph_physics_tpu_torch.training import packed as tpacked

    d, train, val, meta = data
    tr = port_trainer(data, "stacked")
    ds = TH5(train, meta, TFC(targets=("velocity",)))
    frames = [ds[i] for i in (0, 5, 11)]  # two trajectories, one bucket
    batch = MeshGraph.from_numpy(tpacked.stack(frames), "cpu")
    tr.sim.forward(batch, is_training=True)  # statistics from the whole batch
    out = tr.sim.forward(batch).outputs
    for b, f in enumerate(frames):
        one = tr.sim.forward(MeshGraph.from_numpy(f, "cpu")).outputs
        assert torch.equal(out[b], one), b
