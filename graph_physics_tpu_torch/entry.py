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
``plate_setup`` and ``plate_train_setup`` run DeformingPlate
(training_config/plate.json's transformer: 10 blocks, hidden 64, 4 heads,
the 3-D ``world_pos`` target) at scripts/bench_plate.py's configuration:
a synthetic 44x30 sheet and its obstacle (dataset/synthetic.
make_plate_trajectory), world edges within radius 0.03 as each frame's
sidecar of 1,024 slots, B=64 consecutive frames packed, the layout
FusedTopologyManager("transformer") chooses, and the training step's
noise (0.003 on the world positions) and world-position edge features.
``plate_epd_setup`` and ``plate_epd_train_setup`` run DeformingPlate's
MeshGraphNet (Pfaff et al., ICLR 2021, arXiv:2010.03409, §4 and
Appendix A: an ``epd`` with world edges, latent 128, 15 blocks) on the
same sheet and sidecars, in the layout FusedTopologyManager("epd")
chooses, on frames that all have world edges, the world stream joining
each GraphNetBlock kernel through its ``extra_agg`` seam.
``panels_setup`` and ``panels_train_setup`` run the panels workload
(training_config/panels.json: 15 blocks, hidden 128, 4 heads of 32, bf16)
at scripts/bench_canonical.py's panels row: the synthetic 48x40 panels
grid (dataset/synthetic.make_panels_trajectory), frames 1..B built by
FrameBuilder with the panels feature builder (external/panels.py) as
``--external panels`` builds them, B=64 packed in the layout
FusedTopologyManager("transformer") chooses (NK), and the train step of
panels.json: noise 0.01 on the velocity, the 4-term MultiLoss with
least-squares gradients, clipped AdamW with the cosine warmup.
``plate_rollout_setup`` rolls DeformingPlate out (plate.json's
transformer, or its MeshGraphNet with ``model="epd"``) from frame 0 of R
synthetic plates whose obstacles descend at different rates, packed
[T, N, R, F], with each frame's sidecar only reserving its slots: the
rollout finds the world edges again at every step on the device
(training/rollout.DynamicWorldEdges, in either track).
``aneurysm_rollout_setup`` rolls out coarse-aneurysm.json's or
pinn-aneurysm.json's transformer (10 blocks, hidden 64, 4 heads) on R
synthetic aneurysm trajectories built as ``--external aneurysm`` builds
them, carrying the acceleration columns of x (``--use_previous_data``).
Every setup runs on the card unless the caller passes another device.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

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
from graph_physics_tpu_torch.training.packed import pack, pack_frames, stack
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


def graded_setup(device="cuda", *, num_nodes: int = 27_000, hidden: int = 32,
                 mp_steps: int = 5, batch: int = 16, num_steps: int = 3,
                 accumulate_stats: bool = True) -> CylinderSetup:
    """The cylinder ``epd`` model (``cylinder_setup``'s widths by default:
    hidden 32, bf16, weights from seed 0) on the graded mesh, in the layout
    FusedTopologyManager("epd") chooses, which must be CSR: B
    packed copies of frame 0 on ``device``; ``accumulate_stats`` folds the
    batch into the normalizer statistics."""
    return _packed_setup(device,
                         lambda t: make_simulator(hidden, mp_steps, torch.bfloat16, t, 0),
                         synthetic.make_graded_trajectory(num_nodes, num_steps),
                         batch, _chosen_csr_layout("epd"), accumulate_stats)


def graded_transformer_setup(device="cuda", *, num_nodes: int = 27_000, mp_steps: int = 10,
                             batch: int = 16, num_steps: int = 3, hidden: int = 64,
                             heads: int = 4, accumulate_stats: bool = True) -> CylinderSetup:
    """The graph transformer (``transformer_setup``'s widths by default:
    hidden 64, 4 heads, bf16, weights from seed 0) on the graded mesh, in
    the layout FusedTopologyManager("transformer") chooses, which must be
    CSR: B packed copies of frame 0 on ``device``; ``accumulate_stats``
    folds the batch into the normalizer statistics."""
    return _packed_setup(
        device, lambda t: make_transformer_simulator(hidden, mp_steps, heads, torch.bfloat16, t,
                                                     0),
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


#: DeformingPlate (training_config/plate.json, scripts/bench_plate.py:plate_param):
#: x = [world_pos (3), obstacle displacement (3), node type, time]
PLATE_FEATURES, PLATE_OUTPUT, PLATE_NODE_TYPE = 6, 3, 6
PLATE_RADIUS, PLATE_BUDGET = 0.03, 1024


def plate_frame_config(edge_budget: int = PLATE_BUDGET, radius: float = PLATE_RADIUS):
    """plate.json's frame configuration with its world edges as the
    sidecar (what ``cli.train --packed`` takes)."""
    from graph_physics_tpu_torch.dataset.preprocessing import FrameConfig, WorldConfig

    return FrameConfig(targets=("world_pos",), world=WorldConfig(
        world_pos_index_start=0, world_pos_index_end=3, node_type_index=PLATE_NODE_TYPE,
        radius=radius, edge_budget=edge_budget, sidecar=True))


def plate_frames(traj: Dict[str, np.ndarray], frames: Sequence[int], edge_budget: int,
                 radius: float, model: str = "transformer") -> List[MeshGraph]:
    """Host frames of a plate trajectory (dataset/preprocessing.FrameBuilder
    with :func:`plate_frame_config`), laid out by FusedTopologyManager
    (``model``)."""
    from graph_physics_tpu_torch.dataset.preprocessing import FrameBuilder

    builder = FrameBuilder(plate_frame_config(edge_budget, radius),
                           synthetic.plate_meta_dict(len(traj["world_pos"])))
    manager = FusedTopologyManager(model)
    return [manager.transform_frame(builder.build(traj, t, cache_key=0)) for t in frames]


def make_plate_simulator(tiling: Tiling, mp_steps: int = 10, hidden: int = 64,
                         heads: int = 4, dtype=torch.bfloat16, seed: int = 0) -> Simulator:
    """plate.json's transformer (no edge features, exact GELU, no RoPE, no
    gate) in its Simulator: features 0-6 and the node type at column 6,
    the world positions (columns 0-3) its output."""
    model = EncodeTransformDecode(
        message_passing_num=mp_steps, node_input_size=PLATE_FEATURES + 9,
        output_size=PLATE_OUTPUT, hidden_size=hidden, num_heads=heads, dtype=dtype,
        tiling=tiling)
    sim = Simulator(node_input_size=PLATE_FEATURES + 9, edge_input_size=0,
                    output_size=PLATE_OUTPUT, feature_index_start=0,
                    feature_index_end=PLATE_FEATURES, output_index_start=0,
                    output_index_end=PLATE_OUTPUT, node_type_index=PLATE_NODE_TYPE, model=model)
    reset_parameters(sim, torch.Generator().manual_seed(seed))
    return sim


def plate_setup(device="cuda", *, nx: int = 44, ny: int = 30, batch: int = 64,
                edge_budget: int = PLATE_BUDGET, radius: float = PLATE_RADIUS,
                mp_steps: int = 10, hidden: int = 64,
                accumulate_stats: bool = True) -> CylinderSetup:
    """DeformingPlate at scripts/bench_plate.py's configuration: frames
    0..B-1 of an (B+1)-frame synthetic plate trajectory on an nx x ny
    sheet, each with its own world-edge sidecar of ``edge_budget`` slots,
    packed [N, B, F] in the layout FusedTopologyManager("transformer")
    chooses, and plate.json's model (4 heads, weights from seed 0) on
    ``device``; ``accumulate_stats`` folds the batch into the normalizer
    statistics."""
    traj = synthetic.make_plate_trajectory(nx, ny, num_steps=batch + 1)
    frames = plate_frames(traj, range(batch), edge_budget, radius)
    graph = MeshGraph.from_numpy(pack_frames(frames), device)
    sim = make_plate_simulator(frames[0].layout, mp_steps, hidden).to(device)
    if accumulate_stats:
        sim.prepare(graph, is_training=True)
    return CylinderSetup(simulator=sim, graph=graph, tiling=frames[0].layout, trajectory=traj,
                         template=frames[0])


def plate_preprocess(num_steps: int = 10000) -> Callable:
    """plate.json's step transform: noise 0.003 on the world positions
    (columns 0-3), then the world-position edge features from the noised
    positions (training/transforms.make_device_preprocess)."""
    from graph_physics_tpu_torch.training.transforms import (
        WorldPosConfig,
        make_device_preprocess,
    )

    return make_device_preprocess(NoiseConfig(starts=(0,), ends=(3,), scales=(0.003,)),
                                  WorldPosConfig(0, 3), num_steps=num_steps)


#: the plate MeshGraphNet's edge features: the frames' 4 mesh-space
#: columns [Δmesh_pos, ‖Δmesh_pos‖] and the 4 world-space ones the step's
#: transform appends (plate_preprocess)
PLATE_EDGE_INPUT = 8
#: the frames of the synthetic 44x30 plate whose sidecars hold world edges
#: (radius 0.03): the obstacle is within reach of the sheet on these only
PLATE_WORLD_FRAMES = range(6, 14)


def plate_epd_block(mp_steps: int = 15, hidden: int = 128) -> Dict:
    """The ``model`` block of DeformingPlate's MeshGraphNet in a config
    shaped like plate.json."""
    return {"type": "epd", "message_passing_num": mp_steps, "hidden_size": hidden,
            "node_input_size": PLATE_FEATURES, "output_size": PLATE_OUTPUT,
            "edge_input_size": PLATE_EDGE_INPUT}


def make_plate_epd_simulator(tiling: Tiling, mp_steps: int = 15, hidden: int = 128,
                             dtype=torch.bfloat16, seed: int = 0) -> Simulator:
    """DeformingPlate's MeshGraphNet (relu MLPs with an RMSNorm tail, the
    edge encoder on PLATE_EDGE_INPUT columns) in its Simulator: features
    0-6 and the node type at column 6, the world positions its output."""
    model = EncodeProcessDecode(
        message_passing_num=mp_steps, node_input_size=PLATE_FEATURES + 9,
        edge_input_size=PLATE_EDGE_INPUT, output_size=PLATE_OUTPUT, hidden_size=hidden,
        dtype=dtype, tiling=tiling)
    sim = Simulator(node_input_size=PLATE_FEATURES + 9, edge_input_size=PLATE_EDGE_INPUT,
                    output_size=PLATE_OUTPUT, feature_index_start=0,
                    feature_index_end=PLATE_FEATURES, output_index_start=0,
                    output_index_end=PLATE_OUTPUT, node_type_index=PLATE_NODE_TYPE, model=model)
    reset_parameters(sim, torch.Generator().manual_seed(seed))
    return sim


def plate_epd_setup(device="cuda", *, nx: int = 44, ny: int = 30, batch: int = 64,
                    frames: Sequence[int] = PLATE_WORLD_FRAMES,
                    edge_budget: int = PLATE_BUDGET, radius: float = PLATE_RADIUS,
                    mp_steps: int = 15, hidden: int = 128, dtype=torch.bfloat16,
                    accumulate_stats: bool = True) -> CylinderSetup:
    """DeformingPlate's MeshGraphNet on the synthetic nx x ny plate: B
    frames taken from ``frames`` in turn (by default those with world
    edges), each with its own world-edge sidecar of ``edge_budget`` slots,
    packed [N, B, F] in the layout FusedTopologyManager("epd") chooses,
    and :func:`make_plate_epd_simulator` (weights from seed 0) on
    ``device``. The graph carries the frames' host edge features; with
    ``accumulate_stats`` the normalizer statistics fold in the batch with
    its world-position edge features appended, as the eval transform
    appends them."""
    from graph_physics_tpu_torch.training.transforms import (
        WorldPosConfig,
        append_world_pos_features,
    )

    frames = [frames[i % len(frames)] for i in range(batch)]
    traj = synthetic.make_plate_trajectory(nx, ny, num_steps=max(frames) + 2)
    host = plate_frames(traj, frames, edge_budget, radius, model="epd")
    graph = MeshGraph.from_numpy(pack_frames(host), device)
    sim = make_plate_epd_simulator(host[0].layout, mp_steps, hidden, dtype).to(device)
    if accumulate_stats:
        sim.prepare(append_world_pos_features(graph, WorldPosConfig(0, 3)), is_training=True)
    return CylinderSetup(simulator=sim, graph=graph, tiling=host[0].layout, trajectory=traj,
                         template=host[0])


def plate_epd_train_setup(device="cuda", *, batch: int = 64, **kw) -> "CylinderTrainSetup":
    """``plate_epd_setup`` with fresh normalizer statistics and the plate
    train step (:func:`plate_train_setup`'s: AdamW lr 1e-3, warmup 100 of
    10,000 steps, masked L2, :func:`plate_preprocess`). ``kw`` goes to
    ``plate_epd_setup``."""
    base = plate_epd_setup(device, batch=batch, accumulate_stats=False, **kw)
    preprocess = plate_preprocess(NUM_STEPS)
    state, step = make_trainer(base.simulator, preprocess)
    return CylinderTrainSetup(simulator=base.simulator, graph=base.graph, tiling=base.tiling,
                              state=state, train_step=step, device_preprocess=preprocess)


def plate_train_setup(device="cuda", *, batch: int = 64, **kw) -> CylinderTrainSetup:
    """``plate_setup`` with fresh normalizer statistics and the plate train
    step (scripts/bench_plate.py: AdamW lr 1e-3, warmup 100 of 10,000
    steps, masked L2, :func:`plate_preprocess`). ``kw`` goes to
    ``plate_setup``."""
    base = plate_setup(device, batch=batch, accumulate_stats=False, **kw)
    preprocess = plate_preprocess(NUM_STEPS)
    state, step = make_trainer(base.simulator, preprocess)
    return CylinderTrainSetup(simulator=base.simulator, graph=base.graph, tiling=base.tiling,
                              state=state, train_step=step, device_preprocess=preprocess)


@dataclass
class RolloutSetup:
    """R same-mesh trajectories, packed for make_batched_rollout_fn."""

    simulator: Simulator
    frames: MeshGraph  # x [T, N, R, F], y [T, N, R, F_out], a sidecar [T, W, R, ...]
    tiling: Tiling
    #: make_batched_rollout_fn's keyword arguments: frame_transform,
    #: dynamic_world_edges, previous_data_slice
    rollout_kw: Dict[str, Any]
    trajectories: List[Dict[str, np.ndarray]]  # the host trajectories
    host: List[MeshGraph]  # each trajectory's host graph (trainer.stack_trajectory)


#: plate_rollout_setup's obstacle descents a frame, one a trajectory: JAX's
#: 0.01 first; contacts start between frames 5 and 8
PLATE_DESCENTS = (0.01, 0.0085, 0.0115, 0.009, 0.011, 0.0095, 0.0105, 0.008)


def plate_rollout_setup(device="cuda", *, model: str = "transformer", trajectories: int = 8,
                        steps: int = 16, nx: int = 44, ny: int = 30,
                        edge_budget: int = PLATE_BUDGET, radius: float = PLATE_RADIUS,
                        track_predicted: bool = True, k_per_node: int = 16,
                        mp_steps: Optional[int] = None, hidden: Optional[int] = None,
                        seed: int = 0) -> RolloutSetup:
    """DeformingPlate rolled out ``steps`` steps from frame 0 of
    ``trajectories`` synthetic nx x ny plates (obstacle descents
    PLATE_DESCENTS), in the layout FusedTopologyManager(``model``) chooses,
    with world edges found again at every step (a DynamicWorldEdges of
    ``edge_budget // 2`` pairs a direction; the frames' sidecars, built at
    radius 1e-12 as the CLIs build validation frames, reserve the slots)
    and the world-position edge features after them. ``model``:
    plate.json's transformer or DeformingPlate's MeshGraphNet ("epd"), at
    their widths unless ``mp_steps``/``hidden``, weights from ``seed``,
    normalizer statistics from the first trajectory's frames with the
    host's world edges."""
    from graph_physics_tpu_torch.training.rollout import DynamicWorldEdges
    from graph_physics_tpu_torch.training.trainer import rollout_graph, stack_trajectory
    from graph_physics_tpu_torch.training.transforms import (
        WorldPosConfig,
        append_world_pos_features,
        make_eval_transform,
    )

    trajs = [synthetic.make_plate_trajectory(nx, ny, num_steps=steps + 1,
                                             descent=PLATE_DESCENTS[i % len(PLATE_DESCENTS)])
             for i in range(trajectories)]
    host = [stack_trajectory(plate_frames(traj, range(steps), edge_budget, 1e-12, model=model))
            for traj in trajs]
    frames = rollout_graph(host, device)
    layout = host[0].layout
    kw = {k: v for k, v in (("mp_steps", mp_steps), ("hidden", hidden)) if v is not None}
    if model == "epd":
        sim = make_plate_epd_simulator(layout, seed=seed, **kw)
    else:
        sim = make_plate_simulator(layout, seed=seed, **kw)
    sim = sim.to(device)
    stats = MeshGraph.from_numpy(pack_frames(plate_frames(
        trajs[0], range(steps), edge_budget, radius, model=model)), device)
    sim.prepare(append_world_pos_features(stats, WorldPosConfig(0, 3)), is_training=True)
    dynamic = DynamicWorldEdges(world_pos_start=0, world_pos_end=3, radius=radius,
                                budget=edge_budget // 2, k_per_node=k_per_node,
                                track_predicted=track_predicted)
    return RolloutSetup(simulator=sim, frames=frames, tiling=layout,
                        rollout_kw=dict(frame_transform=make_eval_transform(WorldPosConfig(0, 3)),
                                        dynamic_world_edges=dynamic),
                        trajectories=trajs, host=host)


#: the aneurysm configs of training_config/
ANEURYSM_CONFIGS = {name: Path(__file__).resolve().parents[1] / "training_config"
                    / f"{name}-aneurysm.json" for name in ("coarse", "pinn")}
#: the aneurysm trajectories' time step (synthetic.make_aneurysm_trajectory)
ANEURYSM_DT = 0.01


def aneurysm_param(config: str = "coarse") -> Dict:
    """training_config/coarse-aneurysm.json or pinn-aneurysm.json."""
    import json

    with open(ANEURYSM_CONFIGS[config]) as f:
        return json.load(f)


def aneurysm_fields(nx: int = 44, ny: int = 32, num_steps: int = 18,
                    dt: float = ANEURYSM_DT) -> Dict[str, np.ndarray]:
    """A synthetic aneurysm trajectory (synthetic.make_aneurysm_trajectory,
    nx x ny nodes) as the xdmf dataset reads its files
    (dataset/xdmf_dataset.trajectory_fields)."""
    from graph_physics_tpu_torch.dataset.xdmf_dataset import trajectory_fields

    traj = synthetic.make_aneurysm_trajectory(nx, ny, num_steps, dt)
    return trajectory_fields(traj["mesh_pos"], traj["cells"],
                             {k: v for k, v in traj.items() if k not in ("mesh_pos", "cells")})


def aneurysm_frame_config(config: str = "coarse", masking_ratio: Optional[float] = None):
    """The aneurysm config's frame configuration as ``cli.train --external
    aneurysm`` makes it: external/aneurysm.build_features, which reads the
    previous frame's data."""
    from graph_physics_tpu_torch.external import get_feature_builder
    from graph_physics_tpu_torch.training import config as config_lib

    return config_lib.get_frame_config(aneurysm_param(config), masking_ratio=masking_ratio,
                                       use_previous_data=True,
                                       extra_node_features=get_feature_builder("aneurysm"))


def aneurysm_previous_data(fields: Dict[str, np.ndarray], dt: float = ANEURYSM_DT
                           ) -> Tuple[int, int]:
    """The columns of x where external/aneurysm.build_features puts the
    acceleration for these fields: the rollout's ``previous_data_slice``
    (``--previous_data_start``, ``--previous_data_end``)."""
    from graph_physics_tpu_torch.dataset.preprocessing import extract_frame
    from graph_physics_tpu_torch.external.aneurysm import acceleration_columns

    meta = synthetic.xdmf_meta_dict(len(fields["mesh_pos"]), dt)
    return acceleration_columns(extract_frame(fields, 1, meta, ("Vitesse",),
                                              with_previous=True))


def aneurysm_rollout_setup(device="cuda", *, config: str = "coarse", trajectories: int = 8,
                           steps: int = 16, nx: int = 44, ny: int = 32,
                           mp_steps: Optional[int] = None, carry: bool = True,
                           seed: int = 0) -> RolloutSetup:
    """An aneurysm config's transformer rolled out ``steps`` steps from
    frame 1 (frame 0 is the first's previous frame) of ``trajectories``
    R windows of one synthetic nx x ny aneurysm trajectory, window r
    starting r frames later, in the layout FusedTopologyManager
    ("transformer") chooses; with ``carry`` the rollout carries the
    acceleration columns (:func:`aneurysm_previous_data`). Weights from
    ``seed``, normalizer statistics from the first window's frames."""
    from graph_physics_tpu_torch.dataset.preprocessing import FrameBuilder
    from graph_physics_tpu_torch.training import config as config_lib
    from graph_physics_tpu_torch.training.trainer import rollout_graph, stack_trajectory

    param = aneurysm_param(config)
    if mp_steps is not None:
        param["model"]["message_passing_num"] = mp_steps
    fields = aneurysm_fields(nx, ny, trajectories + steps + 1)
    builder = FrameBuilder(aneurysm_frame_config(config),
                           synthetic.xdmf_meta_dict(len(fields["mesh_pos"]), ANEURYSM_DT))
    manager = FusedTopologyManager("transformer")
    built = [manager.transform_frame(builder.build(fields, t, cache_key=0, train=False))
             for t in range(1, trajectories + steps)]
    host = [stack_trajectory(built[r:r + steps]) for r in range(trajectories)]
    frames = rollout_graph(host, device)
    layout = host[0].layout
    sim = config_lib.get_simulator(param, config_lib.get_model(param, dtype=torch.bfloat16))
    sim.model.tiling = layout
    reset_parameters(sim, torch.Generator().manual_seed(seed))
    sim = sim.to(device)
    sim.prepare(MeshGraph.from_numpy(pack_frames(built[:steps]), device), is_training=True)
    prev = aneurysm_previous_data(fields) if carry else None
    return RolloutSetup(simulator=sim, frames=frames, tiling=layout,
                        rollout_kw=dict(previous_data_slice=prev), trajectories=[fields],
                        host=host)


#: the panels workload's config and its frames' target field
PANELS_CONFIG = Path(__file__).resolve().parents[1] / "training_config" / "panels.json"


def panels_param() -> Dict:
    """training_config/panels.json."""
    import json

    with open(PANELS_CONFIG) as f:
        return json.load(f)


def panels_frames(traj: Dict[str, np.ndarray], frames: Sequence[int],
                  dt: float = 0.2) -> List[MeshGraph]:
    """Host frames of a panels trajectory (synthetic.make_panels_trajectory)
    as ``cli.train --external panels`` builds them from its xdmf files
    (dataset/xdmf_dataset.trajectory_fields, then FrameBuilder with
    external/panels.py and the previous frame's data), laid out by
    FusedTopologyManager("transformer")."""
    from graph_physics_tpu_torch.dataset.preprocessing import FrameBuilder
    from graph_physics_tpu_torch.dataset.xdmf_dataset import trajectory_fields
    from graph_physics_tpu_torch.external import get_feature_builder
    from graph_physics_tpu_torch.training import config as config_lib

    fields = trajectory_fields(traj["mesh_pos"], traj["cells"],
                               {k: v for k, v in traj.items() if k not in ("mesh_pos", "cells")})
    cfg = config_lib.get_frame_config(panels_param(), use_previous_data=True,
                                      extra_node_features=get_feature_builder("panels"))
    builder = FrameBuilder(cfg, synthetic.xdmf_meta_dict(len(traj["mesh_pos"]), dt))
    manager = FusedTopologyManager("transformer")
    return [manager.transform_frame(builder.build(fields, t, cache_key=0, train=False))
            for t in frames]


def make_panels_simulator(tiling: Tiling, mp_steps: Optional[int] = None,
                          dtype=torch.bfloat16, seed: int = 0) -> Simulator:
    """panels.json's transformer and Simulator (config.get_model and
    get_simulator), ``mp_steps`` blocks (15 by default), weights from
    ``seed``, on ``tiling``."""
    from graph_physics_tpu_torch.training import config as config_lib

    param = panels_param()
    if mp_steps is not None:
        param["model"]["message_passing_num"] = mp_steps
    sim = config_lib.get_simulator(param, config_lib.get_model(param, dtype=dtype))
    sim.model.tiling = tiling
    reset_parameters(sim, torch.Generator().manual_seed(seed))
    return sim


def panels_setup(device="cuda", *, nx: int = 48, ny: int = 40, batch: int = 64,
                 mp_steps: Optional[int] = None, accumulate_stats: bool = True) -> CylinderSetup:
    """The panels workload at scripts/bench_canonical.py's panels row: frames
    1..B of a (B+2)-frame synthetic panels trajectory on an nx x ny grid
    (frame 0 is each sample's previous frame), packed [N, B, F] in the layout
    FusedTopologyManager("transformer") chooses, and panels.json's model
    (15 blocks unless ``mp_steps``, weights from seed 0) on ``device``;
    ``accumulate_stats`` folds the batch into the normalizer statistics."""
    traj = synthetic.make_panels_trajectory(nx, ny, num_steps=batch + 2)
    frames = panels_frames(traj, range(1, batch + 1))
    graph = MeshGraph.from_numpy(pack_frames(frames), device)
    sim = make_panels_simulator(frames[0].layout, mp_steps).to(device)
    if accumulate_stats:
        sim.prepare(graph, is_training=True)
    return CylinderSetup(simulator=sim, graph=graph, tiling=frames[0].layout, trajectory=traj,
                         template=frames[0])


def panels_train_setup(device="cuda", *, batch: int = 64, **kw) -> "CylinderTrainSetup":
    """``panels_setup`` with fresh normalizer statistics and panels.json's
    train step: noise 0.01 on the velocity columns, the MultiLoss of L2,
    gradient-L2, convection-L2 and divergence-L1 terms (weights 1, 0.01,
    1e-4, 0.1) on least-squares gradients, AdamW lr 1e-3 with warmup 100 of
    10,000 steps and clip 1.0. ``kw`` goes to ``panels_setup``."""
    from graph_physics_tpu_torch.training import config as config_lib
    from graph_physics_tpu_torch.training.transforms import make_device_preprocess

    base = panels_setup(device, batch=batch, accumulate_stats=False, **kw)
    param = panels_param()
    loss_fn, _ = config_lib.get_loss(param)
    method = config_lib.get_gradient_method(param)
    preprocess = make_device_preprocess(config_lib.get_noise_config(param), num_steps=NUM_STEPS)
    state, step = make_trainer(base.simulator, preprocess, loss_fn, method)
    return CylinderTrainSetup(simulator=base.simulator, graph=base.graph, tiling=base.tiling,
                              state=state, train_step=step, device_preprocess=preprocess,
                              loss_fn=loss_fn, gradient_method=method)


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
    #: the step's (graph, generator, step) -> graph before the forward
    #: (training/transforms.py), where it is not bench.py's noise alone
    device_preprocess: Optional[Callable] = None
    #: the step's loss and gradient method, where it is not the masked L2
    loss_fn: Optional[Any] = None
    gradient_method: Optional[str] = None


def make_trainer(sim: Simulator, device_preprocess: Optional[Callable] = None,
                 loss_fn=None, gradient_method: Optional[str] = None
                 ) -> Tuple[TrainState, Callable]:
    """A fresh train state and bench.py's train step for ``sim``: AdamW
    (lr 1e-3, warmup 100 of 10,000 steps), noise σ=0.02 on the velocity
    columns (or ``device_preprocess`` in its place) and the masked L2 loss
    (or ``loss_fn`` with ``gradient_method``)."""
    from graph_physics_tpu_torch.training.transforms import make_device_preprocess

    opt = make_optimizer(LEARNING_RATE, warmup=WARMUP, num_steps=NUM_STEPS)
    return init_train_state(sim, opt), make_train_step(
        sim, loss_fn or l2_loss,
        device_preprocess or make_device_preprocess(NOISE, num_steps=NUM_STEPS),
        gradient_method=gradient_method)


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

