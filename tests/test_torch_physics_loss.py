"""The port's data and physics losses and its MultiLoss train step against
the JAX package's, on the CPU, fp32.

  * every ``LossType`` term, with both gradient methods, on a packed
    [N, B, F] batch of panels frames (each side's FrameBuilder with its
    panels feature builder) with per-sample ``deselected`` nodes: the
    port's per-sample means (``loss.per_sample_mean``) against JAX's terms
    under ``jax.vmap`` over axis 1, as JAX's train step takes them, and one
    sample alone through the default masked mean: 1e-5;
  * ``MultiLoss`` of panels.json (least squares) and pinn-aneurysm.json
    (finite differences): the total and each weighted term, 1e-5;
  * a 2-block, hidden-128 panels model (panels.json cut to 2 blocks, B=2,
    packed and stacked, noise off), JAX's weights loaded into the port:
    three train steps with
    the 4-term loss against JAX's ``make_train_step``: the loss and each
    term at 1e-4, the gradient norm at 1e-4, the parameters within 1e-5
    (all but 1e-3 of the values, whose gradients are 0 up to rounding, at
    Adam's step bound, as tests/test_torch_transformer_train.py holds
    them);
  * ``entry.panels_train_setup`` takes two steps on the CPU, and the
    Trainer logs each term under its display name.
"""

import copy
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_physics_tpu.dataset.preprocessing import FrameBuilder as JFrameBuilder
from graph_physics_tpu.external import get_feature_builder as j_builder
from graph_physics_tpu.training import config as j_config
from graph_physics_tpu.training import loss as jloss
from graph_physics_tpu.training import packed as jpacked
from graph_physics_tpu.training import schedule as jschedule
from graph_physics_tpu.training import step as jstep
from graph_physics_tpu.utils.convert import convert_state_dict
from graph_physics_tpu_torch import entry
from graph_physics_tpu_torch.core.graph import MeshGraph
from graph_physics_tpu_torch.dataset import synthetic
from graph_physics_tpu_torch.dataset.preprocessing import FrameBuilder
from graph_physics_tpu_torch.dataset.xdmf_dataset import trajectory_fields
from graph_physics_tpu_torch.external import get_feature_builder
from graph_physics_tpu_torch.training import config as t_config
from graph_physics_tpu_torch.training import loss as tloss
from graph_physics_tpu_torch.training import packed as tpacked
from graph_physics_tpu_torch.training import schedule as tschedule
from graph_physics_tpu_torch.training import step as tstep
from graph_physics_tpu_torch.utils.convert import load_jax_params
from tests.test_torch_train_step import LR, compare_state

CONFIG_DIR = Path(__file__).resolve().parents[1] / "training_config"

TOL = 1e-5
B = 3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: these small cases gain nothing from more, and a
    test worker sharing the machine with others slows down many-fold when
    each process runs one thread a core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _param(name="panels", blocks=None):
    with open(CONFIG_DIR / f"{name}.json") as f:
        param = json.load(f)
    if blocks is not None:
        param["model"]["message_passing_num"] = blocks
    return param


def _frames(batch, nx=9, ny=7, packed=True):
    """(JAX host graph, port host graph) of frames 1..batch of a panels
    trajectory, each side's FrameBuilder with its panels builder, packed
    [N, B, F] or stacked [B, N, F]."""
    traj = synthetic.make_panels_trajectory(nx, ny, num_steps=batch + 2)
    fields = trajectory_fields(traj["mesh_pos"], traj["cells"],
                               {k: v for k, v in traj.items() if k not in ("mesh_pos", "cells")})
    meta = synthetic.xdmf_meta_dict(batch + 2, 0.2)
    param = _param()
    jb = JFrameBuilder(j_config.get_frame_config(param, use_previous_data=True,
                                                 extra_node_features=j_builder("panels")), meta)
    tb = FrameBuilder(t_config.get_frame_config(param, use_previous_data=True,
                                                extra_node_features=get_feature_builder("panels")),
                      meta)
    jf = [jb.build(fields, t, cache_key=0, train=False) for t in range(1, batch + 1)]
    tf = [tb.build(fields, t, cache_key=0, train=False) for t in range(1, batch + 1)]
    jg, tg = jax.tree.map(lambda *xs: np.stack(xs), *jf), tpacked.stack(tf)
    return (jpacked.pack(jg), tpacked.pack(tg)) if packed else (jg, tg)


@pytest.fixture(scope="module")
def batch_case():
    jg, tg = _frames(B)
    rng = np.random.default_rng(0)
    n = tg.x.shape[0]
    arrays = {k: rng.normal(size=(n, B, 2)).astype(np.float32)
              for k in ("target", "network_output", "network_output_physical",
                        "target_physical")}
    arrays["deselected"] = rng.random((n, B)) < 0.2
    return jg, MeshGraph.from_numpy(tg, "cpu"), arrays


def _jax_per_sample(jg, arrays, fn):
    """``fn(LossInputs)`` of each sample, vmapped over axis 1 as JAX's train
    step takes the terms of a packed batch."""
    g = jax.tree.map(jnp.asarray, jg)

    def one(tgt, out, out_p, tgt_p, dsel):
        return fn(jloss.LossInputs(graph=g, target=tgt, network_output=out,
                                   network_output_physical=out_p, target_physical=tgt_p,
                                   deselected=dsel))

    keys = ("target", "network_output", "network_output_physical", "target_physical",
            "deselected")
    return jax.vmap(one, in_axes=1)(*(jnp.asarray(arrays[k]) for k in keys))


def _port_inputs(tg, arrays):
    return tloss.LossInputs(graph=tg, **{k: torch.as_tensor(v) for k, v in arrays.items()})


@pytest.mark.parametrize("method", ["finite_diff", "least_squares"])
@pytest.mark.parametrize("name", [t.name for t in tloss.LossType])
def test_loss_term_matches_jax_per_sample(batch_case, name, method):
    jg, tg, arrays = batch_case
    want = np.asarray(_jax_per_sample(
        jg, arrays, lambda i: jloss.LossType[name].fn(i, gradient_method=method)))
    got = tloss.LossType[name].fn(_port_inputs(tg, arrays), gradient_method=method,
                                  mean_fn=tloss.per_sample_mean)
    assert got.shape == (B,)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL * np.abs(want).max())
    # one sample alone through the default masked mean
    one = {k: v[:, 1] for k, v in arrays.items()}
    got1 = tloss.LossType[name].fn(_port_inputs(tg, one), gradient_method=method)
    np.testing.assert_allclose(got1.item(), want[1], rtol=TOL, atol=TOL * abs(want[1]))


@pytest.mark.parametrize("config", ["panels", "pinn-aneurysm"])
def test_multiloss_matches_jax_per_sample(batch_case, config):
    jg, tg, arrays = batch_case
    param = _param(config)
    jl, _ = j_config.get_loss(param)
    tl, names = t_config.get_loss(param)
    method = t_config.get_gradient_method(param)
    assert isinstance(tl, tloss.MultiLoss) and names == [t.name for t in tl.losses]
    assert tl.weights == jl.weights and method == j_config.get_gradient_method(param)
    want_total, want_terms = _jax_per_sample(
        jg, arrays, lambda i: jl(i, gradient_method=method, return_all_losses=True))
    total, terms = tl(_port_inputs(tg, arrays), gradient_method=method, return_all_losses=True,
                      mean_fn=tloss.per_sample_mean)
    for got, want in zip([total, *terms], [want_total, *want_terms]):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL * np.abs(want).max())


@pytest.mark.parametrize("layout", ["packed", "stacked"])
def test_panels_multiloss_train_steps_match_jax(layout):
    param = _param(blocks=2)
    jg, tg = _frames(2, packed=layout == "packed")
    g = jax.tree.map(jnp.asarray, jg)
    jsim = j_config.get_simulator(param, j_config.get_model(param))
    tsim = t_config.get_simulator(param, t_config.get_model(param))
    opt = jschedule.make_optimizer(LR, warmup=1, num_steps=10)
    jstate = jstep.init_train_state(jsim, opt, jax.random.PRNGKey(0), g)
    jl, _ = j_config.get_loss(param)
    tl, _ = t_config.get_loss(param)
    method = t_config.get_gradient_method(param)
    jtrain = jstep.make_train_step(jsim, opt, jl, None, gradient_method=method, donate=False)
    load_jax_params(tsim, jax.tree.map(np.asarray, jstate.params),
                    jax.tree.map(np.asarray, jstate.sim_state))
    tstate = tstep.init_train_state(tsim, tschedule.make_optimizer(LR, warmup=1, num_steps=10))
    ttrain = tstep.make_train_step(tsim, tl, gradient_method=method)
    tgraph = MeshGraph.from_numpy(tg, "cpu")
    for i in range(3):
        jstate, jm = jtrain(jstate, g, jax.random.PRNGKey(1))
        tm = ttrain(tstate, tgraph, torch.Generator().manual_seed(1))
        assert sorted(tm) == sorted(jm)  # loss, grad_norm and loss_term_0..3
        for k in jm:
            want = float(jm[k])
            np.testing.assert_allclose(tm[k].item(), want, rtol=1e-4, err_msg=f"step {i}: {k}")
        params, sim_state = convert_state_dict(
            {k: v.detach().float().numpy().copy() for k, v in tsim.state_dict().items()},
            copy.deepcopy(param))
        compare_state(jstate, params, sim_state, param_atol=1e-5, noisy_share=1e-3,
                      noisy_atol=2 * LR * (i + 1))


def test_entry_panels_train_setup_takes_steps_on_cpu():
    train = entry.panels_train_setup("cpu", nx=14, ny=10, batch=2, mp_steps=2)
    assert train.graph.x.shape[1:] == (2, 7) and train.graph.faces is not None
    assert train.simulator.model.hidden_size == 128
    assert isinstance(train.loss_fn, tloss.MultiLoss) and train.gradient_method == "least_squares"
    gen = torch.Generator().manual_seed(0)
    metrics = [train.train_step(train.state, train.graph, gen) for _ in range(2)]
    assert train.state.step == 2
    assert all(np.isfinite(m[k].item()) for m in metrics for k in m)
    assert sorted(metrics[0]) == ["grad_norm", "loss"] + [f"loss_term_{i}" for i in range(4)]


def test_trainer_logs_each_term_under_its_name():
    from graph_physics_tpu_torch.training.trainer import loss_term_names

    multi, _ = t_config.get_loss(_param())
    rec = {"loss": 1.5, "grad_norm": 2.0, "loss_term_0": 1.0, "loss_term_1": 0.25,
           "loss_term_2": 0.125, "loss_term_3": 0.125}
    assert loss_term_names(multi)(rec) == {
        "train_multiloss": 1.5, "train_MSE": 1.0, "train_GradientL2Loss": 0.25,
        "train_ConvectionL2Loss": 0.125, "train_DivergenceL1Loss": 0.125}
    single, name = t_config.get_loss({})
    assert name == "L2LOSS" and loss_term_names(single)(rec) == {"train_MSE": 1.5}
    assert loss_term_names(tloss.l2_loss)(rec) == {}
