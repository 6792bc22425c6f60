"""World edges found again at every rollout step (training/rollout.py's
``DynamicWorldEdges``, ROADMAP A 5.2) and the concat world layout, against
the JAX package on the CPU, on the synthetic 8x6 plate (radius 0.12, so
the small sheet meets its obstacle; 2 blocks, hidden 16):

  * ``FrameBuilder`` in the concat layout (the budgeted world edges after
    the mesh edges, the edge bucket widened by the budget): every field of
    every frame bit for bit (``np.array_equal``), with a budget that trims
    and one that does not;
  * ``apply_dynamic_world_edges`` on one frame, both tracks: the concat
    tail's pairs JAX's, a→b before b→a, their features to 1e-6, the mesh
    edges untouched; the sidecar's pairs the same, its unused slots
    padded (the order of pairs whose distances lie an ulp apart may differ:
    ops/knn.py says why, tests/test_torch_knn.py holds the index arrays
    equal where the distances are exact);
  * rollouts, fp32, at 1e-4 (a rollout compounds fp32 reorderings): JAX's
    concat rollout of DeformingPlate's MeshGraphNet (``epd``, which reads
    the tail's edge features) against the port's concat rollout and its
    sidecar rollout, in both tracks; JAX's vmapped rollout of plate.json's
    transformer over two trajectories against the port's packed R=2
    rollout, one search per trajectory;
  * ``get_dynamic_world_edges`` on each config case;
  * the CLIs: an unpacked world-edge run trains in the concat layout (the
    plain path), and a ``dynamic_rollout`` config trains, validates and
    predicts, predict's RMSE validate's (1e-6) and JAX's dynamic rollout of
    the same weights (1e-4).
JAX's host radius search runs without its native library, whose pair
order differs from the cKDTree path the port copies.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_physics_tpu import native as j_native
from graph_physics_tpu.core import padding as j_padding
from graph_physics_tpu.dataset import preprocessing as j_pre
from graph_physics_tpu.models.processors import EncodeProcessDecode as JEPD
from graph_physics_tpu.models.processors import EncodeTransformDecode as JETD
from graph_physics_tpu.models.simulator import Simulator as JSim
from graph_physics_tpu.training import config as j_config
from graph_physics_tpu.training import rollout as j_rollout
from graph_physics_tpu.training import transforms as j_transforms
from graph_physics_tpu_torch import entry
from graph_physics_tpu_torch.cli import predict as predict_cli
from graph_physics_tpu_torch.cli import train as train_cli
from graph_physics_tpu_torch.cli.common import load_inference_stack
from graph_physics_tpu_torch.core.graph import MeshGraph
from graph_physics_tpu_torch.dataset import preprocessing as t_pre
from graph_physics_tpu_torch.dataset import synthetic as t_syn
from graph_physics_tpu_torch.training import config as t_config
from graph_physics_tpu_torch.training import rollout as t_rollout
from graph_physics_tpu_torch.training.trainer import rollout_graph, stack_trajectory
from graph_physics_tpu_torch.training.transforms import WorldPosConfig, make_eval_transform
from graph_physics_tpu_torch.utils.convert import load_jax_params

RADIUS, BUDGET, STEPS, H, BLOCKS = 0.12, 64, 10, 16, 2
FIELDS = ("x", "y", "pos", "node_type", "node_mask", "senders", "receivers", "edge_mask",
          "edge_attr", "wedge_senders", "wedge_receivers", "wedge_mask", "wedge_attr")


@pytest.fixture(autouse=True)
def no_native(monkeypatch):
    monkeypatch.setattr(j_native, "radius_cross_pairs", lambda *a, **k: None)
    monkeypatch.setattr(j_native, "radius_pairs", lambda *a, **k: None)


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _traj(descent=0.01):
    return t_syn.make_plate_trajectory(8, 6, STEPS + 1, descent=descent)


def _frames(pre, traj, radius=1e-12, budget=BUDGET, sidecar=False):
    """Every frame of ``traj`` built by ``pre``'s FrameBuilder in the
    buckets its dataset pins (base.py:_setup_index)."""
    b = pre.FrameBuilder(pre.FrameConfig(targets=("world_pos",), world=pre.WorldConfig(
        0, 3, 6, radius=radius, edge_budget=budget, sidecar=sidecar)),
        t_syn.plate_meta_dict(len(traj["world_pos"])))
    n = traj["mesh_pos"].shape[1]
    ei = b.mesh_edges(0, traj["cells"][0], n)
    kw = dict(n_pad=j_padding.bucket_size(n), e_pad=b.edge_budget_for(ei.shape[1]),
              c_pad=j_padding.bucket_size(len(traj["cells"][0])), cache_key=0, train=False)
    return [b.build(traj, t, **kw) for t in range(STEPS)]


def _dwe(pkg, track_predicted, budget=BUDGET // 2):
    cls = j_rollout.DynamicWorldEdges if pkg == "jax" else t_rollout.DynamicWorldEdges
    return cls(world_pos_start=0, world_pos_end=3, radius=RADIUS, budget=budget,
               track_predicted=track_predicted)


@pytest.mark.parametrize("budget", [BUDGET, 16])
def test_frame_builder_concat_matches_jax(budget):
    traj = _traj()
    got, want = _frames(t_pre, traj, RADIUS, budget), _frames(j_pre, traj, RADIUS, budget)
    mesh, world = int(_frames(t_pre, traj)[0].n_edge), 0
    for g, w in zip(got, want):
        for name in FIELDS:
            a, b = getattr(g, name), getattr(w, name)
            assert (a is None) == (b is None), name
            if a is not None:
                assert np.asarray(a).dtype == np.asarray(b).dtype, name
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=name)
        assert (int(g.n_node), int(g.n_edge)) == (int(w.n_node), int(w.n_edge))
        world += int(g.n_edge) - mesh
    assert world > 0 and got[0].senders.shape[0] >= mesh + budget


@pytest.mark.parametrize("track_predicted", [True, False])
def test_apply_dynamic_world_edges_matches_jax(track_predicted):
    traj = _traj()
    frame = _frames(t_pre, traj)[7]
    n = int(frame.n_node)
    # predicted positions that drifted: the NORMAL nodes 0.05 closer to the obstacle
    x = np.asarray(frame.x).copy()
    x[:n, 2] += 0.05 * (np.asarray(frame.node_type[:n]) == 0)
    jg = jax.tree.map(jnp.asarray, _frames(j_pre, traj)[7])
    jd = j_rollout._apply_dynamic_world_edges(jg.replace(x=jnp.asarray(x)),
                                              _dwe("jax", track_predicted), true_x=jg.x)
    tg = MeshGraph.from_numpy(frame, "cpu")
    td = t_rollout.apply_dynamic_world_edges(tg.replace(x=torch.as_tensor(x)),
                                             _dwe("port", track_predicted), true_x=tg.x)
    off = frame.senders.shape[0] - BUDGET
    for name in ("senders", "receivers", "edge_mask", "edge_attr"):  # the mesh edges stay
        np.testing.assert_array_equal(getattr(td, name).numpy()[:off],
                                      np.asarray(getattr(frame, name))[:off])

    def tail(g):
        """{(sender, receiver): mesh features} of the valid tail edges, a→b
        in the first half, b→a in the second."""
        s, r, m = (np.asarray(getattr(g, k))[off:] for k in ("senders", "receivers",
                                                             "edge_mask"))
        ea = np.asarray(g.edge_attr)[off:]
        half = BUDGET // 2
        assert (s[:half][m[:half]] == r[half:][m[half:]]).all()
        return {(int(a), int(b)): ea[i] for i, (a, b) in enumerate(zip(s, r)) if m[i]}

    want, got = tail(jd), tail(td)
    assert want and got.keys() == want.keys()
    for pair, feats in want.items():
        np.testing.assert_allclose(got[pair], feats, rtol=1e-6, atol=1e-6)
    side = _frames(t_pre, traj, sidecar=True)[7]
    sg = MeshGraph.from_numpy(side, "cpu")
    sd = t_rollout.apply_dynamic_world_edges(sg.replace(x=torch.as_tensor(x)),
                                             _dwe("port", track_predicted), true_x=sg.x)
    sm = sd.wedge_mask.numpy()
    assert set(zip(sd.wedge_senders.numpy()[sm].tolist(),
                   sd.wedge_receivers.numpy()[sm].tolist())) == want.keys()
    assert (sd.wedge_senders.numpy()[~sm] == 0).all()
    assert (sd.wedge_receivers.numpy()[~sm] == side.x.shape[0] - 1).all()
    assert (sd.wedge_attr.numpy()[~sm] == 0).all()
    s, r = sd.wedge_senders.numpy()[sm], sd.wedge_receivers.numpy()[sm]
    pos = np.asarray(side.pos)
    np.testing.assert_allclose(sd.wedge_attr.numpy()[sm][:, :3], pos[s] - pos[r], atol=1e-6)


def _jax_epd():
    model = JEPD(message_passing_num=BLOCKS, node_input_size=15, edge_input_size=8,
                 output_size=3, hidden_size=H)
    return JSim(node_input_size=15, edge_input_size=8, output_size=3, feature_index_start=0,
                feature_index_end=6, output_index_start=0, output_index_end=3, node_type_index=6,
                model=model)


def _jax_transformer():
    model = JETD(message_passing_num=BLOCKS, node_input_size=15, output_size=3, hidden_size=H,
                 num_heads=4)
    return JSim(node_input_size=15, edge_input_size=0, output_size=3, feature_index_start=0,
                feature_index_end=6, output_index_start=0, output_index_end=3, node_type_index=6,
                model=model)


def _jax_state(sim, g):
    params = sim.init_params(jax.random.PRNGKey(0), g)
    _, _, _, state = sim.prepare(sim.init_state(), g, is_training=True)
    return jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state)


def _stack(frames):
    return jax.tree.map(lambda *xs: jnp.asarray(np.stack(xs)), *frames)


def _close(got, want, n):
    """Predictions on the valid nodes and both RMSEs at 1e-4."""
    np.testing.assert_allclose(got.predictions.numpy().reshape(want.predictions.shape)[..., :n, :],
                               np.asarray(want.predictions)[..., :n, :], rtol=1e-4, atol=1e-4)
    for key in ("rmse_all_rollout", "rmse_1step"):
        np.testing.assert_allclose(getattr(got, key).numpy().reshape(-1),
                                   np.asarray(getattr(want, key)).reshape(-1), rtol=1e-4)


@pytest.mark.parametrize("track_predicted", [True, False])
def test_dynamic_rollout_matches_jax_concat_and_sidecar(track_predicted):
    """DeformingPlate's MeshGraphNet: JAX's concat rollout, the port's
    concat rollout (make_rollout_fn) and its sidecar rollout
    (make_batched_rollout_fn, R=1)."""
    traj = _traj()
    concat = _frames(t_pre, traj)
    jtraj = _stack(_frames(j_pre, traj))
    jsim = _jax_epd()
    transform = j_transforms.make_eval_transform(j_transforms.WorldPosConfig(0, 3))
    params, state = _jax_state(jsim, transform(jax.tree.map(lambda a: a[0], jtraj)))
    want = j_rollout.make_rollout_fn(jsim, frame_transform=transform,
                                     dynamic_world_edges=_dwe("jax", track_predicted))(
        params, state, jtraj)
    tsim = entry.make_plate_epd_simulator(None, mp_steps=BLOCKS, hidden=H, dtype=torch.float32)
    load_jax_params(tsim, params, state)
    kw = dict(frame_transform=make_eval_transform(WorldPosConfig(0, 3)),
              dynamic_world_edges=_dwe("port", track_predicted))
    n = int(concat[0].n_node)
    got = t_rollout.make_rollout_fn(tsim, **kw)(
        rollout_graph([stack_trajectory(concat)], "cpu", packed=False))
    _close(got, want, n)
    side = stack_trajectory(_frames(t_pre, traj, sidecar=True))
    got = t_rollout.make_batched_rollout_fn(tsim, **kw)(rollout_graph([side], "cpu"))
    _close(got, want, n)
    assert float(want.rmse_all_rollout) > 0


def test_batched_dynamic_rollout_matches_jax():
    """plate.json's transformer over two trajectories whose obstacles
    descend at different rates: JAX vmaps its concat rollout, the port
    packs R=2 with sidecars and searches each trajectory's positions."""
    trajs = [_traj(0.01), _traj(0.0085)]
    jframes = jax.tree.map(lambda *xs: jnp.stack(xs), *[_stack(_frames(j_pre, t)) for t in trajs])
    jsim = _jax_transformer()
    params, state = _jax_state(jsim, jax.tree.map(lambda a: a[0, 0], jframes))
    want = j_rollout.make_batched_rollout_fn(jsim, dynamic_world_edges=_dwe("jax", True),
                                             frame_transform=j_transforms.make_eval_transform(
                                                 j_transforms.WorldPosConfig(0, 3)))(
        params, state, jframes)
    tsim = entry.make_plate_simulator(None, mp_steps=BLOCKS, hidden=H, heads=4,
                                      dtype=torch.float32)
    load_jax_params(tsim, params, state)
    frames = rollout_graph([stack_trajectory(_frames(t_pre, t, sidecar=True)) for t in trajs],
                           "cpu")
    got = t_rollout.make_batched_rollout_fn(
        tsim, frame_transform=make_eval_transform(WorldPosConfig(0, 3)),
        dynamic_world_edges=_dwe("port", True))(frames)
    n = int(_frames(t_pre, trajs[0])[0].n_node)
    np.testing.assert_allclose(got.predictions.numpy().transpose(2, 0, 1, 3)[:, :, :n],
                               np.asarray(want.predictions)[:, :, :n], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.rmse_all_rollout.numpy(), np.asarray(want.rmse_all_rollout),
                               rtol=1e-4)
    assert abs(float(want.rmse_all_rollout[0]) - float(want.rmse_all_rollout[1])) > 1e-6


@pytest.mark.parametrize("wp", [
    {"use": True},
    {"use": False, "dynamic_rollout": True},
    {"use": True, "dynamic_rollout": True},
    {"use": True, "dynamic_rollout": True, "dynamic_rollout_track": "ground_truth",
     "k_per_node": 4, "radius": 0.05, "edge_budget": 301},
    {"use": True, "dynamic_rollout": True, "dynamic_rollout_track": "sideways"},
])
def test_get_dynamic_world_edges_matches_jax(wp):
    param = {"transformations": {"world_pos_parameters": {
        "world_pos_index_start": 0, "world_pos_index_end": 3, **wp}}}
    if wp.get("dynamic_rollout_track") == "sideways":
        for pkg in (j_config, t_config):
            with pytest.raises(ValueError, match="dynamic_rollout_track"):
                pkg.get_dynamic_world_edges(param)
        return
    want, got = j_config.get_dynamic_world_edges(param), t_config.get_dynamic_world_edges(param)
    if want is None:
        assert got is None
        return
    assert isinstance(got, t_rollout.DynamicWorldEdges)
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name


@pytest.fixture(scope="module")
def plate_workspace(tmp_path_factory):
    d = tmp_path_factory.mktemp("dynamic_plate")
    h5, meta = t_syn.write_plate_h5_dataset(str(d / "train.h5"), num_trajectories=2,
                                            num_steps=STEPS, meta_path=str(d / "meta.json"))
    val, _ = t_syn.write_plate_h5_dataset(str(d / "val.h5"), num_trajectories=1,
                                          num_steps=STEPS, meta_path=str(d / "meta_val.json"))
    cfg = {"dataset": {"extension": "h5", "train_path": h5, "test_path": val, "meta_path": meta,
                       "targets": ["world_pos"], "khop": 1},
           "model": {"type": "transformer", "message_passing_num": BLOCKS, "hidden_size": H,
                     "num_heads": 4, "node_input_size": 6, "output_size": 3,
                     "edge_input_size": 0},
           "index": {"feature_index_start": 0, "feature_index_end": 6, "output_index_start": 0,
                     "output_index_end": 3, "node_type_index": 6},
           "transformations": {
               "preprocessing": {"noise": 0.003, "noise_index_start": [0],
                                 "noise_index_end": [3], "masking": 0},
               "world_pos_parameters": {"use": True, "world_pos_index_start": 0,
                                        "world_pos_index_end": 3, "radius": RADIUS,
                                        "edge_budget": BUDGET}},
           "training": {}}
    return d, cfg


def _train(d, cfg, name, *flags):
    path = d / f"{name}.json"
    path.write_text(json.dumps(cfg))
    out = d / "runs"
    assert train_cli.main(["--training_parameters_path", str(path), "--epochs", "1",
                           "--batch_size", "4", "--learning_rate", "1e-3", "--warmup", "5",
                           "--out_dir", str(out), "--run_name", name, "--device", "cpu",
                           *flags]) == 0
    records = [json.loads(line) for line in open(out / name / f"{name}.metrics.jsonl")]
    last = [r for r in records if "val_all_rollout_rmse" in r][-1]
    assert np.isfinite(last["train_loss_epoch"]) and np.isfinite(last["val_all_rollout_rmse"])
    return str(path), str(out / name / "checkpoints"), last


def test_unpacked_world_run_trains_in_the_concat_layout(plate_workspace):
    """Without --packed the frames keep JAX's concat layout: the world
    edges in each sample's own edge arrays, stacked per sample."""
    d, cfg = plate_workspace
    path, _, _ = _train(d, cfg, "concat")
    param = t_config.load_params(path)
    ds = t_config.get_dataset(param, t_config.get_frame_config(param))
    g = ds.get_frame(0, 7, train=False)
    assert g.wedge_senders is None
    mesh = ds.builder.mesh_edges(0, ds._trajectory(0)["cells"][0], int(g.n_node))
    assert int(g.n_edge) > mesh.shape[1]


def test_dynamic_rollout_trains_and_predicts_as_jax_rolls_out(plate_workspace):
    d, cfg = plate_workspace
    cfg = json.loads(json.dumps(cfg))
    cfg["transformations"]["world_pos_parameters"]["dynamic_rollout"] = True
    path, ckpt, last = _train(d, cfg, "dynamic", "--packed")
    argv = ["--training_parameters_path", path, "--model_path", ckpt, "--device", "cpu"]
    stack = load_inference_stack(predict_cli.build_argparser().parse_args(argv))
    assert stack.dynamic_world_edges == t_config.get_dynamic_world_edges(cfg)
    assert not stack.dataset.get_frame(0, 7, train=False).wedge_mask.any()  # reserved only
    got = predict_cli.predict(stack)[0]
    np.testing.assert_allclose(got.rmse_all_rollout, last["val_all_rollout_rmse"], rtol=1e-6)

    from graph_physics_tpu.utils.convert import convert_state_dict

    jparam = j_config.load_params(path)
    params, state = convert_state_dict(
        {k: v.detach().float().numpy() for k, v in stack.simulator.state_dict().items()},
        jparam)
    fc = j_config.get_frame_config(jparam, masking_ratio=0.0)
    fc = dataclasses.replace(fc, world=dataclasses.replace(fc.world, radius=1e-12))
    ds = j_config.get_dataset(jparam, fc, switch_to_val=True)
    jsim = j_config.get_simulator(jparam, j_config.get_model(jparam))
    want = j_rollout.make_rollout_fn(
        jsim, frame_transform=j_transforms.make_eval_transform(j_transforms.WorldPosConfig(0, 3)),
        dynamic_world_edges=j_config.get_dynamic_world_edges(jparam))(
        params, state, _stack(ds.trajectory_frames(0)))
    n = int(got.trajectory.n_node)
    np.testing.assert_allclose(got.predictions[:, :n], np.asarray(want.predictions)[:, :n],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.rmse_all_rollout, float(want.rmse_all_rollout), rtol=1e-4)
