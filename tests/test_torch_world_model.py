"""The plate slice (training_config/plate.json's transformer with world
edges) through the port against the JAX package, at a small size: 2
blocks, hidden 32, 4 heads, the synthetic 8x6 plate, radius 0.12 (so the
small sheet meets the obstacle), a world-edge budget of 64.
  * the forward of a packed batch with each frame's sidecar, from JAX's
    weights and normalizer statistics (``load_jax_params``), fp32 on the
    plain path, matches JAX's sidecar forward to 1e-4;
  * fp32 train steps on the plain path, with the world-position edge
    features computed on the device, match JAX's ``make_train_step`` with
    ``make_device_preprocess``: step 1 on the plate's own features (loss
    and grad norm 1e-3), then 3 steps on features jittered from a seed
    (see the test) at tests/test_torch_train_step.py's fp32 bounds
    (losses 1e-5, grad norms 1e-4, parameters 1e-5 but for 1e-3 of the
    values, the key projection's bias, whose gradient is 0 up to rounding,
    held to 2·lr a step);
  * the port's validation rollout, each frame's world edges as its sidecar
    (the port's deliberate divergence), matches JAX's rollout of the same
    frames in the concat layout (the edges appended to each frame's edge
    list, as JAX's CLI validates) to 1e-4 in rmse_all_rollout and
    rmse_1step;
  * on the CPU the port's plate setup on its layout (bf16, the kernels'
    plain versions with the world pieces) matches the plain edge-list path,
    and takes train steps.
DeformingPlate's MeshGraphNet (``epd`` with world edges: 2 blocks, hidden
32, edge features 8 wide, the frames' 4 columns and the 4 world-position
ones) on frames whose sidecars all hold world edges:
  * from JAX's weights (``load_jax_params``), its fp32 forward and the
    gradients of its parameters match JAX's ``EncodeProcessDecode`` in its
    ``Simulator`` to 1e-4, and the one edge normalizer over mesh and world
    edges accumulates JAX's statistics to 1e-4;
  * two fp32 train steps match JAX's ``make_train_step``, and its sidecar
    rollout JAX's concat rollout, as the transformer's do above;
  * ``entry.plate_epd_setup`` on its layout (bf16, the GraphNetBlock
    kernels' plain versions with the world aggregate as ``extra_agg``)
    matches the plain edge-list path, and takes train steps.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_physics_tpu import native as j_native
from graph_physics_tpu.dataset import synthetic as j_syn
from graph_physics_tpu.models.processors import EncodeProcessDecode as JEPD
from graph_physics_tpu.models.processors import EncodeTransformDecode as JETD
from graph_physics_tpu.models.simulator import Simulator as JSim
from graph_physics_tpu.training import config as j_config
from graph_physics_tpu.training import loss as jloss
from graph_physics_tpu.training import packed as jpacked
from graph_physics_tpu.training import rollout as jrollout
from graph_physics_tpu.training import schedule as jschedule
from graph_physics_tpu.training import step as jstep
from graph_physics_tpu.training import transforms as jtransforms
from graph_physics_tpu.utils.convert import convert_state_dict
from graph_physics_tpu_torch import entry
from graph_physics_tpu_torch.cli.common import with_sidecar
from graph_physics_tpu_torch.core.graph import MeshGraph
from graph_physics_tpu_torch.training import config as t_config
from graph_physics_tpu_torch.training import packed as tpacked
from graph_physics_tpu_torch.training import schedule as tschedule
from graph_physics_tpu_torch.training import step as tstep
from graph_physics_tpu_torch.training.rollout import make_batched_rollout_fn
from graph_physics_tpu_torch.training.trainer import rollout_graph, trajectory_graph
from graph_physics_tpu_torch.training.transforms import (
    WorldPosConfig,
    append_world_pos_features,
    make_device_preprocess,
    make_eval_transform,
)
from graph_physics_tpu_torch.utils.convert import load_jax_params
from tests.test_torch_train_step import LR, check_fp32_steps

H, HEADS, BLOCKS, STEPS, BATCH = 32, 4, 2, 10, 3
MODEL = {"type": "transformer", "message_passing_num": BLOCKS, "node_input_size": 6,
         "edge_input_size": 0, "output_size": 3, "hidden_size": H, "num_heads": HEADS}
PARAM = {"model": MODEL}
WORLD = WorldPosConfig(0, 3)
EPD_MODEL = entry.plate_epd_block(mp_steps=BLOCKS, hidden=H)
EPD_PARAM = {"model": EPD_MODEL}
#: frames of trajectory 0 whose sidecars all hold world edges (the tests
#: assert it)
EPD_FRAMES = (5, 6, 7, 8)


@pytest.fixture(scope="module")
def plate(tmp_path_factory):
    """The plate config and both packages' validation datasets: JAX's
    concat and sidecar layouts and the port's sidecar."""
    d = tmp_path_factory.mktemp("plate")
    h5, meta = j_syn.write_plate_h5_dataset(str(d / "train.h5"), num_trajectories=2,
                                            num_steps=STEPS, meta_path=str(d / "meta.json"))
    cfg = {"dataset": {"extension": "h5", "train_path": h5, "test_path": h5, "meta_path": meta,
                       "targets": ["world_pos"], "khop": 1},
           "model": MODEL,
           "index": {"feature_index_start": 0, "feature_index_end": 6,
                     "output_index_start": 0, "output_index_end": 3, "node_type_index": 6},
           "transformations": {
               "preprocessing": {"noise": 0.0, "noise_index_start": [0],
                                 "noise_index_end": [3], "masking": 0},
               "world_pos_parameters": {"use": True, "world_pos_index_start": 0,
                                        "world_pos_index_end": 3, "radius": 0.12,
                                        "edge_budget": 64}},
           "training": {}}
    (d / "cfg.json").write_text(json.dumps(cfg))
    jparam = j_config.load_params(str(d / "cfg.json"))
    jfc = j_config.get_frame_config(jparam)
    mp = pytest.MonkeyPatch()  # JAX's radius search without its native library
    mp.setattr(j_native, "radius_cross_pairs", lambda *a, **k: None)
    mp.setattr(j_native, "radius_pairs", lambda *a, **k: None)
    j_concat = j_config.get_dataset(jparam, jfc, switch_to_val=True)
    j_side = j_config.get_dataset(jparam, dataclasses.replace(
        jfc, world=dataclasses.replace(jfc.world, sidecar=True)), switch_to_val=True)
    tparam = t_config.load_params(str(d / "cfg.json"))
    t_side = t_config.get_dataset(tparam, with_sidecar(t_config.get_frame_config(tparam)),
                                  switch_to_val=True)
    yield dict(j_concat=j_concat, j_side=j_side, t_side=t_side, param=jparam, mp=mp)
    mp.undo()


def _jax_sim(dtype=jnp.float32, epd=False):
    edges = EPD_MODEL["edge_input_size"] if epd else 0
    model = (JEPD(message_passing_num=BLOCKS, node_input_size=15, edge_input_size=edges,
                  output_size=3, hidden_size=H, dtype=dtype) if epd else
             JETD(message_passing_num=BLOCKS, node_input_size=15, output_size=3,
                  hidden_size=H, num_heads=HEADS, dtype=dtype))
    return JSim(node_input_size=15, edge_input_size=edges, output_size=3,
                feature_index_start=0, feature_index_end=6, output_index_start=0,
                output_index_end=3, node_type_index=6, model=model)


def _port_sim(epd=False):
    if epd:
        return entry.make_plate_epd_simulator(None, mp_steps=BLOCKS, hidden=H,
                                              dtype=torch.float32, seed=9)
    return entry.make_plate_simulator(None, mp_steps=BLOCKS, hidden=H, heads=HEADS,
                                      dtype=torch.float32, seed=9)


def _batches(plate, frames=(0, 1, 2)):
    """(JAX, port) packed batches of trajectory 0's frames, sidecar layout."""
    jg = jpacked.pack_frames([plate["j_side"].get_frame(0, f, train=False) for f in frames])
    tg = tpacked.pack_frames([plate["t_side"].get_frame(0, f, train=False) for f in frames])
    assert np.asarray(tg.wedge_mask).any()
    return jax.tree.map(jnp.asarray, jg), MeshGraph.from_numpy(tg, "cpu")


def _jax_state(sim, g):
    params = sim.init_params(jax.random.PRNGKey(0), g)
    _, _, _, state = sim.prepare(sim.init_state(), g, is_training=True)
    return jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state)


def test_plate_forward_matches_jax_fp32(plate):
    jg, tg = _batches(plate)
    jsim = _jax_sim()
    params, state = _jax_state(jsim, jg)
    want = jsim.forward(params, state, jg, is_training=False)
    tsim = _port_sim()
    load_jax_params(tsim, params, state)
    with torch.no_grad():
        got = tsim.forward(tg, is_training=False)
    rows = np.asarray(tg.node_mask)
    np.testing.assert_allclose(got.outputs.numpy()[rows], np.asarray(want.outputs)[rows],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.net_out.numpy()[rows], np.asarray(want.net_out)[rows],
                               rtol=1e-4, atol=1e-4)


def _train_runs(jg, tg, n_steps, epd=False):
    """``n_steps`` fp32 train steps of both packages from JAX's initial
    weights, with the world-position edge features computed on the device
    (``make_device_preprocess``, no noise), in check_fp32_steps's form."""
    jsim = _jax_sim(epd=epd)
    opt = jschedule.make_optimizer(LR, warmup=1, num_steps=10)
    # an epd's parameters take their edge width from the features the step
    # appends
    example = jtransforms.append_world_pos_features(jg, jtransforms.WorldPosConfig(0, 3)) \
        if epd else jg
    jstate = jstep.init_train_state(jsim, opt, jax.random.PRNGKey(0), example)
    jtrain = jstep.make_train_step(
        jsim, opt, jloss.LossType.L2LOSS, None, donate=False,
        device_preprocess=jtransforms.make_device_preprocess(
            None, jtransforms.WorldPosConfig(0, 3), 10))
    tsim = _port_sim(epd)
    load_jax_params(tsim, jax.tree.map(np.asarray, jstate.params),
                    jax.tree.map(np.asarray, jstate.sim_state))
    tstate = tstep.init_train_state(tsim, tschedule.make_optimizer(LR, warmup=1, num_steps=10))
    ttrain = tstep.make_train_step(tsim, device_preprocess=make_device_preprocess(None, WORLD,
                                                                                  10))
    runs = []
    for _ in range(n_steps):
        jstate, jm = jtrain(jstate, jg, jax.random.PRNGKey(1))
        tm = ttrain(tstate, tg, torch.Generator().manual_seed(1))
        params, sim_state = convert_state_dict(
            {k: v.detach().float().numpy().copy() for k, v in tsim.state_dict().items()},
            EPD_PARAM if epd else PARAM)
        runs.append((jm, tm, jstate, params, sim_state))
    return runs


def test_plate_train_steps_match_jax_fp32(plate):
    """Step 1 on the plate's own features: the loss and grad norm. The
    synthetic plate's displacement columns hold one value on every node
    (the obstacle's nodes all move alike, the others take their mean), so
    the normalizer's fp32 variance of them is sum-order noise, which its
    std floor amplifies: the two losses and grad norms lie 1.0e-4 apart
    (relative) there, so the bound is 1e-3. Then 3 steps
    with a seeded numpy jitter of 0.01 on the valid nodes' features, which
    gives both packages a real spread, at tests/test_torch_train_step.py's
    fp32 bounds."""
    jg, tg = _batches(plate)
    ((jm, tm, *_),) = _train_runs(jg, tg, 1)
    np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=1e-3)
    np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-3)
    rng = np.random.default_rng(0)
    x = np.asarray(jg.x).copy()
    x[..., :6] += 0.01 * rng.normal(size=x[..., :6].shape).astype(np.float32) * np.asarray(
        jg.node_mask)[:, None, None]
    # the key projection's bias has a gradient of 0 up to rounding (a bias
    # on every key shifts all of a receiver's logits alike, which the
    # softmax cancels), so Adam moves its 2 x 32 values by up to lr a step
    # either way: they are held to 2·lr a step and the share of noisy
    # values is counted over the rest, as in the cylinder transformer's test
    check_fp32_steps(_train_runs(jg.replace(x=jnp.asarray(x)), tg.replace(x=torch.as_tensor(x)),
                                 3), noisy_share=1e-3, zero_grad="['k_proj']['bias']")


def test_sidecar_rollout_matches_jax_concat_rollout(plate):
    """The port validates in the sidecar layout where JAX validates in the
    concat layout: the same edges, the same rollout."""
    jsim = _jax_sim()
    jframes = plate["j_concat"].trajectory_frames(0)
    jtraj = jax.tree.map(lambda *xs: jnp.asarray(np.stack(xs)), *jframes)
    params, state = _jax_state(jsim, jax.tree.map(lambda a: a[0], jtraj))
    jroll = jrollout.make_rollout_fn(jsim, frame_transform=jtransforms.make_eval_transform(
        jtransforms.WorldPosConfig(0, 3)))
    want = jroll(params, state, jtraj)
    tsim = _port_sim()
    load_jax_params(tsim, params, state)
    traj = trajectory_graph(plate["t_side"], 0)
    assert traj.wedge_senders.shape == (STEPS - 1, 64)
    got = make_batched_rollout_fn(tsim, frame_transform=make_eval_transform(WORLD))(
        rollout_graph([traj], "cpu"))
    np.testing.assert_allclose(float(got.rmse_all_rollout[0]), float(want.rmse_all_rollout),
                               rtol=1e-4)
    np.testing.assert_allclose(float(got.rmse_1step[0]), float(want.rmse_1step), rtol=1e-4)
    n = int(traj.n_node)
    np.testing.assert_allclose(got.predictions[:, :n, 0].numpy(),
                               np.asarray(want.predictions)[:, :n], rtol=1e-4, atol=1e-4)


def test_plate_setup_on_its_layout_matches_the_plain_path_on_cpu():
    """bf16: the plate setup on the layout FusedTopologyManager chooses
    (the attention's world seam in its plain version) against the same
    model on the plain edge list; then train steps on the layout."""
    setup = entry.plate_setup("cpu", nx=8, ny=6, batch=4, edge_budget=64, radius=0.12,
                              mp_steps=BLOCKS, hidden=H)
    g = setup.graph
    assert setup.tiling is not None and g.wedge_mask.any()
    sim = setup.simulator
    with torch.no_grad():
        out = sim.forward(g, is_training=False)
        sim.model.tiling = None
        plain = sim.forward(g, is_training=False)
        sim.model.tiling = setup.tiling
    rows = g.node_mask
    torch.testing.assert_close(out.outputs[rows], plain.outputs[rows], rtol=0.1, atol=0.1)
    train = entry.plate_train_setup("cpu", nx=8, ny=6, batch=4, edge_budget=64, radius=0.12,
                                    mp_steps=BLOCKS, hidden=H)
    losses = [train.train_step(train.state, train.graph, torch.Generator().manual_seed(i))
              ["loss"].item() for i in range(2)]
    assert train.state.step == 2 and all(np.isfinite(losses))


# ---- DeformingPlate's MeshGraphNet: epd with world edges ---------------------

def _epd_batches(plate):
    jg, tg = _batches(plate, EPD_FRAMES)
    assert np.asarray(tg.wedge_mask).any(0).all(), "a sample without world edges"
    return jg, tg


def _jitter(jg, tg):
    """A seeded numpy jitter of 0.01 on the valid nodes' features, which
    gives the displacement columns a real spread (test_plate_train_steps_
    match_jax_fp32 says why)."""
    rng = np.random.default_rng(0)
    x = np.asarray(jg.x).copy()
    x[..., :6] += 0.01 * rng.normal(size=x[..., :6].shape).astype(np.float32) * np.asarray(
        jg.node_mask)[:, None, None]
    return jg.replace(x=jnp.asarray(x)), tg.replace(x=torch.as_tensor(x))


def _close(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * max(np.abs(want).max(), 1e-3),
                               err_msg=what)


def test_plate_epd_forward_gradients_and_edge_normalizer_match_jax_fp32(plate):
    """The world-position edge features appended in both packages (as the
    step and the rollout append them), JAX's statistics and the port's
    accumulated over the batch, the port's weights loaded from JAX."""
    jg, tg = _jitter(*_epd_batches(plate))
    jg = jtransforms.append_world_pos_features(jax.tree.map(jnp.asarray, jg),
                                               jtransforms.WorldPosConfig(0, 3))
    tg = append_world_pos_features(tg, WORLD)
    assert tg.edge_attr.shape[-1] == tg.wedge_attr.shape[-1] == 8
    jsim = _jax_sim(epd=True)
    # compiled: op by op, JAX's initialisation and forward take most of the time
    params = jax.tree.map(np.asarray, jax.jit(jsim.init_params)(jax.random.PRNGKey(0), jg))
    _, _, _, state = jsim.prepare(jsim.init_state(), jg, is_training=True)
    state = jax.tree.map(np.asarray, state)
    tsim = _port_sim(epd=True)
    tsim.prepare(tg, is_training=True)
    norm = tsim._edge_normalizer
    for got, want in ((norm._acc_sum, state.edge_norm.acc_sum),
                      (norm._acc_sum_squared, state.edge_norm.acc_sum_sq),
                      (norm._acc_count, state.edge_norm.acc_count)):
        _close(got.numpy(), want, "edge normalizer")
    # the world edges are in the count: the mesh's valid edges alone are fewer
    assert float(state.edge_norm.acc_count) == float(
        tg.edge_mask.sum() * tg.x.shape[1] + tg.wedge_mask.sum())

    load_jax_params(tsim, params, state)
    rows = np.asarray(tg.node_mask)
    want = jax.jit(lambda p, s, g: jsim.forward(p, s, g, is_training=False))(params, state, jg)
    with torch.no_grad():
        got = tsim.forward(tg, is_training=False)
    _close(got.outputs.numpy()[rows], np.asarray(want.outputs)[rows], "outputs")
    _close(got.net_out.numpy()[rows], np.asarray(want.net_out)[rows], "net_out")

    cot = np.random.default_rng(1).normal(size=want.net_out.shape).astype(np.float32)
    cot *= rows[:, None, None]
    jgrad = jax.jit(jax.grad(lambda p: jnp.sum(
        jsim.forward(p, state, jg, is_training=False).net_out * cot)))(params)
    g_in, _, _ = tsim.prepare(tg, is_training=False)
    (tsim.apply_model(g_in) * torch.as_tensor(cot)).sum().backward()
    flat = {k: v.detach().numpy().copy() for k, v in tsim.state_dict().items()}
    flat.update({k: p.grad.numpy().copy() for k, p in tsim.named_parameters()})
    tgrad, _ = convert_state_dict(flat, EPD_PARAM)
    paths = jax.tree_util.tree_flatten_with_path(jgrad)[0]
    assert len(paths) == len(jax.tree.leaves(tgrad)) > 40
    for (path, want_g), got_g in zip(paths, jax.tree.leaves(tgrad)):
        _close(got_g, want_g, jax.tree_util.keystr(path))


def test_plate_epd_train_steps_match_jax_fp32(plate):
    """Two fp32 steps at tests/test_torch_train_step.py's fp32 bounds, the
    world-position features computed in each step."""
    jg, tg = _jitter(*_epd_batches(plate))
    check_fp32_steps(_train_runs(jg, tg, 2, epd=True), noisy_share=1e-3)


def test_plate_epd_sidecar_rollout_matches_jax_concat_rollout(plate):
    jsim = _jax_sim(epd=True)
    jframes = plate["j_concat"].trajectory_frames(0)
    jtraj = jax.tree.map(lambda *xs: jnp.asarray(np.stack(xs)), *jframes)
    transform = jtransforms.make_eval_transform(jtransforms.WorldPosConfig(0, 3))
    params, state = _jax_state(jsim, transform(jax.tree.map(lambda a: a[0], jtraj)))
    want = jrollout.make_rollout_fn(jsim, frame_transform=transform)(params, state, jtraj)
    tsim = _port_sim(epd=True)
    load_jax_params(tsim, params, state)
    traj = trajectory_graph(plate["t_side"], 0)
    assert np.asarray(traj.wedge_mask).any(-1)[list(EPD_FRAMES)].all()
    got = make_batched_rollout_fn(tsim, frame_transform=make_eval_transform(WORLD))(
        rollout_graph([traj], "cpu"))
    np.testing.assert_allclose(float(got.rmse_all_rollout[0]), float(want.rmse_all_rollout),
                               rtol=1e-4)
    np.testing.assert_allclose(float(got.rmse_1step[0]), float(want.rmse_1step), rtol=1e-4)
    n = int(traj.n_node)
    np.testing.assert_allclose(got.predictions[:, :n, 0].numpy(),
                               np.asarray(want.predictions)[:, :n], rtol=1e-4, atol=1e-4)


def test_plate_epd_setup_on_its_layout_matches_the_plain_path_on_cpu():
    """bf16: ``entry.plate_epd_setup`` on the layout FusedTopologyManager
    ("epd") chooses (the GraphNetBlock kernels' plain versions with the
    world aggregate as ``extra_agg``) against the same model on the plain
    edge list; then train steps on the layout."""
    kw = dict(nx=8, ny=6, batch=4, edge_budget=64, radius=0.12, mp_steps=BLOCKS, hidden=H)
    setup = entry.plate_epd_setup("cpu", **kw)
    g = append_world_pos_features(setup.graph, WORLD)
    assert setup.tiling is not None and g.wedge_mask.any(0).all()
    sim = setup.simulator
    with torch.no_grad():
        out = sim.forward(g, is_training=False)
        sim.model.tiling = None
        plain = sim.forward(g, is_training=False)
        sim.model.tiling = setup.tiling
    rows = g.node_mask
    torch.testing.assert_close(out.net_out[rows], plain.net_out[rows], rtol=0.1, atol=0.1)
    train = entry.plate_epd_train_setup("cpu", **kw)
    losses = [train.train_step(train.state, train.graph, torch.Generator().manual_seed(i))
              ["loss"].item() for i in range(2)]
    assert train.state.step == 2 and all(np.isfinite(losses))
