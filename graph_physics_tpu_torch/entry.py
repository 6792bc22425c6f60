"""Setups of the port on the synthetic cylinder mesh and on the graded
mesh (``epd`` and graph-transformer inference and training on each).

Counterpart of __graft_entry__._cylinder_setup / entry:
``cylinder_setup`` builds the ``epd`` inference slice,
``setup.simulator.forward(setup.graph)`` runs it; ``cylinder_train_setup``
adds bench.py's optimizer, noise and loss, and
``setup.train_step(setup.state, setup.graph, generator)`` takes one step.
``transformer_setup`` builds the graph-transformer slice of
scripts/bench_models.py (``transformer_nk``: 10 blocks, hidden 64, 4
heads, B=64) on the same mesh and NK layout, and
``transformer_train_setup`` its training step.
The mesh is the 48x40 synthetic cylinder (1,920 nodes, ~11.2k directed
edges), its NK slot layout (K=6 slots x 1,920 receivers), a packed batch
of B copies of frame 0 on a device, and a model with weights drawn from a
seed: the reference cylinder model (epd, 5 GraphNetBlocks, hidden 32,
relu MLPs with an RMSNorm tail, 2-D velocity, bf16 compute) or the
transformer. For inference, normalizer statistics are accumulated over
the batch, standing in for a checkpoint's state; training starts them
empty. ``graded_setup`` and ``graded_transformer_setup`` run the same two
models at the same widths on the graded mesh of dataset/synthetic.py
(27,000 nodes, 160,612 directed edges, in-degree 2 to 13), laid out by
training/fused.FusedTopologyManager, which chooses the CSR layout for it,
with B=16 packed copies of frame 0 (scripts/bench_airfoil.py's batch);
``graded_train_setup`` and ``graded_transformer_train_setup`` add the
training step to them. ``transolver_setup`` builds Transolver++ at
scripts/bench_models.py:196-201's configuration (4 blocks, hidden 64, 4
heads, 32 slices, bf16) on a stacked [B, N, F] batch of B=16 copies of
frame 0 of the cylinder (or of the graded mesh, ``graded=True``: it reads
no edges, so that mesh is a 27,000-point cloud), and
``transolver_train_setup`` its training step, whose slice noise goes
through the kernel of ops/gumbel.py with ``fused_gumbel`` (the default).
Every setup runs on the card unless the caller passes another device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from graph_physics_tpu_torch.core import mesh as mesh_lib
from graph_physics_tpu_torch.core.graph import MeshGraph
from graph_physics_tpu_torch.dataset import synthetic
from graph_physics_tpu_torch.models.layers import reset_parameters
from graph_physics_tpu_torch.models.processors import (
    EncodeProcessDecode,
    EncodeTransformDecode,
    TransolverProcessor,
)
from graph_physics_tpu_torch.models.simulator import Simulator
from graph_physics_tpu_torch.models.transolver import init_parameters
from graph_physics_tpu_torch.ops.tiling import (
    CSRLayout,
    Layout,
    NKTiling,
    apply_to_graph_nk,
    build_nk_tiling,
)
from graph_physics_tpu_torch.training.fused import FusedTopologyManager
from graph_physics_tpu_torch.training.loss import l2_loss
from graph_physics_tpu_torch.training.packed import pack, stack
from graph_physics_tpu_torch.training.schedule import make_optimizer
from graph_physics_tpu_torch.training.step import (
    NoiseConfig,
    TrainState,
    init_train_state,
    make_train_step,
)

NODE_INPUT = 2 + 9  # velocity + one-hot node type
EDGE_INPUT = 3  # [Δpos, |Δpos|]
OUTPUT = 2

Tiling = Optional[Layout]


@dataclass
class CylinderSetup:
    simulator: Simulator
    graph: MeshGraph  # packed [N, B, F] (stacked [B, N, F] for Transolver) batch on the device
    tiling: Tiling
    trajectory: Dict[str, np.ndarray]  # the synthetic trajectory (numpy)
    template: MeshGraph  # host frame 0 in the graph's edge layout


def frame_graph(traj: Dict[str, np.ndarray], t: int) -> MeshGraph:
    """Host MeshGraph of frame ``t``: x = [velocity, node_type, 0], y = the
    next frame's velocity (as __graft_entry__._cylinder_setup builds it)."""
    pos = traj["mesh_pos"][0]
    nt = traj["node_type"][0, :, 0]
    x = np.concatenate([traj["velocity"][t], nt[:, None].astype(np.float32),
                        np.zeros((len(pos), 1), np.float32)], axis=-1)
    ei = mesh_lib.faces_to_edges(traj["cells"][0], len(pos))
    return mesh_lib.build_mesh_graph(x, pos, nt, ei, y=traj["velocity"][t + 1])


def _simulator(model, edge_input: int, seed: int, init=reset_parameters) -> Simulator:
    sim = Simulator(
        node_input_size=NODE_INPUT, edge_input_size=edge_input, output_size=OUTPUT,
        feature_index_start=0, feature_index_end=2, output_index_start=0,
        output_index_end=2, node_type_index=2, model=model,
    )
    init(sim, torch.Generator().manual_seed(seed))
    return sim


def make_simulator(hidden: int, mp_steps: int, dtype, tiling: Tiling, seed: int) -> Simulator:
    model = EncodeProcessDecode(
        message_passing_num=mp_steps, node_input_size=NODE_INPUT,
        edge_input_size=EDGE_INPUT, output_size=OUTPUT, hidden_size=hidden,
        dtype=dtype, tiling=tiling,
    )
    return _simulator(model, EDGE_INPUT, seed)


def make_transformer_simulator(hidden: int, mp_steps: int, heads: int, dtype,
                               tiling: Tiling, seed: int) -> Simulator:
    """scripts/bench_models.py's transformer (no edge features, exact GELU,
    no RoPE, no gate) in a Simulator with ``edge_input_size=0``."""
    model = EncodeTransformDecode(
        message_passing_num=mp_steps, node_input_size=NODE_INPUT, output_size=OUTPUT,
        hidden_size=hidden, num_heads=heads, dtype=dtype, tiling=tiling,
    )
    return _simulator(model, 0, seed)


def make_transolver_simulator(hidden: int = 64, mp_steps: int = 4, heads: int = 4,
                              slices: int = 32, dtype=torch.bfloat16,
                              fused_gumbel: bool = True, seed: int = 0) -> Simulator:
    """scripts/bench_models.py:196-201's Transolver++ (mlp_ratio 1, no
    unified_pos) in a Simulator with ``edge_input_size=0``, weights from
    ``seed`` as the reference draws them (models/transolver.init_parameters)."""
    model = TransolverProcessor(
        message_passing_num=mp_steps, node_input_size=NODE_INPUT, output_size=OUTPUT,
        hidden_size=hidden, num_heads=heads, slice_num=slices, fused_gumbel=fused_gumbel,
        dtype=dtype)
    return _simulator(model, 0, seed, init=init_parameters)


def _nk_layout(g: MeshGraph) -> Tuple[NKTiling, MeshGraph]:
    tiling = build_nk_tiling(g.senders, g.receivers, int(g.n_node), edge_mask=g.edge_mask)
    if tiling is None:
        raise ValueError("mesh rejected by the NK layout builder")
    return tiling, apply_to_graph_nk(g, tiling)


def _chosen_csr_layout(model: str) -> Callable[[MeshGraph], Tuple[CSRLayout, MeshGraph]]:
    """The layout FusedTopologyManager chooses for ``model`` (``epd`` or
    ``transformer``), which must be CSR."""
    def layout(g: MeshGraph):
        manager = FusedTopologyManager(model)
        tiling = manager.layout_for(g)
        if not isinstance(tiling, CSRLayout):
            raise ValueError(f"the layout manager chose {type(tiling).__name__} for the "
                             "graded mesh, not the CSR layout")
        return tiling, manager.transform_frame(g)
    return layout


def _packed_setup(device, make_sim: Callable[[Tiling], Simulator], traj: Dict[str, np.ndarray],
                  batch: int, layout: Optional[Callable], accumulate_stats: bool) -> CylinderSetup:
    """Frame 0 of ``traj`` in ``layout(g)``'s layout (None: the plain edge
    list), the packed batch of B copies of it and ``make_sim(tiling)`` on
    ``device``."""
    g = frame_graph(traj, 0)
    tiling = None
    if layout is not None:
        tiling, g = layout(g)
    graph = MeshGraph.from_numpy(pack(stack([g] * batch)), device)
    sim = make_sim(tiling).to(device)
    if accumulate_stats:
        sim.prepare(graph, is_training=True)
    return CylinderSetup(simulator=sim, graph=graph, tiling=tiling, trajectory=traj,
                         template=g)


def cylinder_setup(
    device="cuda",
    *,
    nx: int = 48,
    ny: int = 40,
    hidden: int = 32,
    mp_steps: int = 5,
    batch: int = 128,
    dtype=torch.bfloat16,
    nk: bool = True,
    seed: int = 0,
    num_steps: int = 3,
    accumulate_stats: bool = True,
) -> CylinderSetup:
    """``epd`` model, Simulator and packed batch of B copies of frame 0 on
    ``device``; ``accumulate_stats`` folds the batch into the normalizer
    statistics."""
    return _packed_setup(device, lambda t: make_simulator(hidden, mp_steps, dtype, t, seed),
                         synthetic.make_trajectory(nx, ny, num_steps=num_steps), batch,
                         _nk_layout if nk else None, accumulate_stats)


def transformer_setup(
    device="cuda",
    *,
    nx: int = 48,
    ny: int = 40,
    hidden: int = 64,
    mp_steps: int = 10,
    heads: int = 4,
    batch: int = 64,
    dtype=torch.bfloat16,
    nk: bool = True,
    seed: int = 0,
    num_steps: int = 3,
    accumulate_stats: bool = True,
) -> CylinderSetup:
    """The graph transformer of scripts/bench_models.py:142-166
    (``transformer_nk``: 10 blocks, hidden 64, 4 heads, bf16, B=64) with
    its Simulator and packed batch of B copies of frame 0 on ``device``;
    ``accumulate_stats`` folds the batch into the normalizer statistics."""
    return _packed_setup(
        device, lambda t: make_transformer_simulator(hidden, mp_steps, heads, dtype, t, seed),
        synthetic.make_trajectory(nx, ny, num_steps=num_steps), batch,
        _nk_layout if nk else None, accumulate_stats)


def graded_setup(device="cuda", *, num_nodes: int = 27_000, mp_steps: int = 5,
                 batch: int = 16, num_steps: int = 3,
                 accumulate_stats: bool = True) -> CylinderSetup:
    """The cylinder ``epd`` model (``cylinder_setup``'s widths: hidden 32,
    bf16, weights from seed 0) on the graded mesh, in the layout
    FusedTopologyManager("epd") chooses, which must be CSR: B
    packed copies of frame 0 on ``device``; ``accumulate_stats`` folds the
    batch into the normalizer statistics."""
    return _packed_setup(device, lambda t: make_simulator(32, mp_steps, torch.bfloat16, t, 0),
                         synthetic.make_graded_trajectory(num_nodes, num_steps),
                         batch, _chosen_csr_layout("epd"), accumulate_stats)


def graded_transformer_setup(device="cuda", *, num_nodes: int = 27_000, mp_steps: int = 10,
                             batch: int = 16, num_steps: int = 3,
                             accumulate_stats: bool = True) -> CylinderSetup:
    """The graph transformer (``transformer_setup``'s widths: hidden 64, 4
    heads, bf16, weights from seed 0) on the graded mesh, in the layout
    FusedTopologyManager("transformer") chooses, which must be CSR: B
    packed copies of frame 0 on ``device``; ``accumulate_stats`` folds the
    batch into the normalizer statistics."""
    return _packed_setup(
        device, lambda t: make_transformer_simulator(64, mp_steps, 4, torch.bfloat16, t, 0),
        synthetic.make_graded_trajectory(num_nodes, num_steps), batch,
        _chosen_csr_layout("transformer"), accumulate_stats)


def transolver_setup(device="cuda", *, batch: int = 16, graded: bool = False,
                     num_nodes: int = 27_000, nx: int = 48, ny: int = 40, num_steps: int = 3,
                     fused_gumbel: bool = True, accumulate_stats: bool = True,
                     **kw) -> CylinderSetup:
    """Transolver++ (``make_transolver_simulator``: 4 blocks, hidden 64, 4
    heads, 32 slices, bf16, weights from seed 0; ``kw`` goes to it) on a
    stacked [B, N, F] batch of B copies of frame 0 on ``device``: the
    cylinder mesh, or the graded mesh's ``num_nodes`` points with
    ``graded``. ``accumulate_stats`` folds the batch into the normalizer
    statistics. The setup has no edge layout (``tiling`` None)."""
    traj = (synthetic.make_graded_trajectory(num_nodes, num_steps) if graded
            else synthetic.make_trajectory(nx, ny, num_steps=num_steps))
    g = frame_graph(traj, 0)
    graph = MeshGraph.from_numpy(stack([g] * batch), device)
    sim = make_transolver_simulator(fused_gumbel=fused_gumbel, **kw).to(device)
    if accumulate_stats:
        sim.prepare(graph, is_training=True)
    return CylinderSetup(simulator=sim, graph=graph, tiling=None, trajectory=traj, template=g)


#: bench.py's training configuration (__graft_entry__._cylinder_setup :97-99)
LEARNING_RATE, WARMUP, NUM_STEPS = 1e-3, 100, 10000
NOISE = NoiseConfig(starts=(0,), ends=(2,), scales=(0.02,))


@dataclass
class CylinderTrainSetup:
    simulator: Simulator
    graph: MeshGraph  # packed [N, B, F] (stacked [B, N, F] for Transolver) batch on the device
    tiling: Tiling
    state: TrainState
    train_step: Callable


def make_trainer(sim: Simulator) -> Tuple[TrainState, Callable]:
    """A fresh train state and bench.py's train step for ``sim``: AdamW
    (lr 1e-3, warmup 100 of 10,000 steps), noise σ=0.02 on the velocity
    columns and the masked L2 loss."""
    opt = make_optimizer(LEARNING_RATE, warmup=WARMUP, num_steps=NUM_STEPS)
    return init_train_state(sim, opt), make_train_step(sim, l2_loss, NOISE, num_steps=NUM_STEPS)


def _train_setup(base: CylinderSetup) -> CylinderTrainSetup:
    state, step = make_trainer(base.simulator)
    return CylinderTrainSetup(simulator=base.simulator, graph=base.graph, tiling=base.tiling,
                              state=state, train_step=step)


def cylinder_train_setup(device="cuda", *, batch: int = 128, seed: int = 0, **kw) -> CylinderTrainSetup:
    """``cylinder_setup`` with fresh normalizer statistics and
    :func:`make_trainer`'s training step. ``kw`` goes to ``cylinder_setup``."""
    return _train_setup(cylinder_setup(device, batch=batch, seed=seed, accumulate_stats=False,
                                       **kw))


def transformer_train_setup(device="cuda", *, batch: int = 64, seed: int = 0,
                            **kw) -> CylinderTrainSetup:
    """``transformer_setup`` with fresh normalizer statistics and
    :func:`make_trainer`'s training step: the train step of
    scripts/bench_models.py:62-99 for ``transformer_nk`` (:142-166). ``kw``
    goes to ``transformer_setup``."""
    return _train_setup(transformer_setup(device, batch=batch, seed=seed,
                                          accumulate_stats=False, **kw))


def graded_train_setup(device="cuda", *, batch: int = 16, **kw) -> CylinderTrainSetup:
    """``graded_setup`` (the ``epd`` model on the graded mesh, CSR layout)
    with fresh normalizer statistics and :func:`make_trainer`'s training
    step: the step scripts/bench_airfoil.py trains at B=16. ``kw`` goes to
    ``graded_setup``."""
    return _train_setup(graded_setup(device, batch=batch, accumulate_stats=False, **kw))


def graded_transformer_train_setup(device="cuda", *, batch: int = 16,
                                   **kw) -> CylinderTrainSetup:
    """``graded_transformer_setup`` (the graph transformer on the graded
    mesh, CSR layout) with fresh normalizer statistics and
    :func:`make_trainer`'s training step, at B=16. ``kw`` goes to
    ``graded_transformer_setup``."""
    return _train_setup(graded_transformer_setup(device, batch=batch, accumulate_stats=False,
                                                 **kw))


def transolver_train_setup(device="cuda", *, batch: int = 16, fused_gumbel: bool = True,
                           **kw) -> CylinderTrainSetup:
    """``transolver_setup`` with fresh normalizer statistics and
    :func:`make_trainer`'s training step (bench_models.py:62-99 for
    ``transolver``, B=16, stacked). ``fused_gumbel`` draws each block's
    slice noise with the kernel of ops/gumbel.py (the slice's main path);
    False keeps the ``torch.rand`` draw, JAX's default. ``kw`` goes to
    ``transolver_setup``."""
    return _train_setup(transolver_setup(device, batch=batch, fused_gumbel=fused_gumbel,
                                         accumulate_stats=False, **kw))


def rollout_frames(setup: CylinderSetup, starts: Sequence[int], steps: int) -> MeshGraph:
    """R windows of the setup's trajectory as packed rollout frames on the
    graph's device: x [T, N, R, 4] (frame start+t), y [T, N, R, 2]
    (frame start+t+1). The trajectory needs max(starts) + steps + 1 frames."""
    vel = setup.trajectory["velocity"]
    tpl = setup.template
    n_valid = int(tpl.n_node)
    n = tpl.x.shape[0]
    r = len(starts)
    x = np.zeros((steps, n, r, tpl.x.shape[-1]), np.float32)
    y = np.zeros((steps, n, r, 2), np.float32)
    x[:, :n_valid, :, 2] = tpl.x[:n_valid, 2][None, :, None]  # node-type column
    for i, s in enumerate(starts):
        x[:, :n_valid, i, :2] = vel[s:s + steps]
        y[:, :n_valid, i, :] = vel[s + 1:s + steps + 1]
    ea = np.repeat(np.asarray(tpl.edge_attr)[:, None], r, axis=1)
    device = setup.graph.x.device
    g = MeshGraph.from_numpy(tpl.replace(x=x[0], y=y[0], edge_attr=ea), device)
    return g.replace(x=torch.as_tensor(x, device=device), y=torch.as_tensor(y, device=device))

