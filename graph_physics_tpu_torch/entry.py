"""Cylinder ``epd`` setups of the port: inference and training.

Counterpart of __graft_entry__._cylinder_setup / entry:
``cylinder_setup`` builds the inference slice,
``setup.simulator.forward(setup.graph)`` runs it; ``cylinder_train_setup``
adds bench.py's optimizer, noise and loss, and
``setup.train_step(setup.state, setup.graph, generator)`` takes one step.
The slice is the 48x40 synthetic cylinder mesh (1,920 nodes,
~11.2k directed edges), its NK slot layout (K=6 slots x 1,920
receivers), a packed batch of B frames on a device, and the reference
cylinder model (epd, 5 GraphNetBlocks, hidden 32, relu MLPs with an
RMSNorm tail, 2-D velocity, bf16 compute) with weights drawn from a
seed. For inference, normalizer statistics are accumulated over the
batch, standing in for a checkpoint's state; training starts them empty.
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
from graph_physics_tpu_torch.models.processors import EncodeProcessDecode
from graph_physics_tpu_torch.models.simulator import Simulator
from graph_physics_tpu_torch.ops.tiling import NKTiling, apply_to_graph_nk, build_nk_tiling
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


@dataclass
class CylinderSetup:
    simulator: Simulator
    graph: MeshGraph  # packed [N, B, F] batch on the device
    tiling: Optional[NKTiling]
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


def make_simulator(hidden: int, mp_steps: int, dtype, tiling: Optional[NKTiling],
                   seed: int) -> Simulator:
    model = EncodeProcessDecode(
        message_passing_num=mp_steps, node_input_size=NODE_INPUT,
        edge_input_size=EDGE_INPUT, output_size=OUTPUT, hidden_size=hidden,
        edge_tiling_nk=tiling, dtype=dtype,
    )
    sim = Simulator(
        node_input_size=NODE_INPUT, edge_input_size=EDGE_INPUT, output_size=OUTPUT,
        feature_index_start=0, feature_index_end=2, output_index_start=0,
        output_index_end=2, node_type_index=2, model=model,
    )
    reset_parameters(sim, torch.Generator().manual_seed(seed))
    return sim


def cylinder_setup(
    device,
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
    """Model, Simulator and packed batch of B copies of frame 0 on ``device``;
    ``accumulate_stats`` folds the batch into the normalizer statistics."""
    traj = synthetic.make_trajectory(nx, ny, num_steps=num_steps)
    g = frame_graph(traj, 0)
    tiling = None
    if nk:
        tiling = build_nk_tiling(g.senders, g.receivers, int(g.n_node), edge_mask=g.edge_mask)
        if tiling is None:
            raise ValueError("mesh rejected by the NK layout builder")
        g = apply_to_graph_nk(g, tiling)
    graph = MeshGraph.from_numpy(pack(stack([g] * batch)), device)
    sim = make_simulator(hidden, mp_steps, dtype, tiling, seed).to(device)
    if accumulate_stats:
        sim.prepare(graph, is_training=True)
    return CylinderSetup(simulator=sim, graph=graph, tiling=tiling, trajectory=traj,
                         template=g)


#: bench.py's training configuration (__graft_entry__._cylinder_setup :97-99)
LEARNING_RATE, WARMUP, NUM_STEPS = 1e-3, 100, 10000
NOISE = NoiseConfig(starts=(0,), ends=(2,), scales=(0.02,))


@dataclass
class CylinderTrainSetup:
    simulator: Simulator
    graph: MeshGraph  # packed [N, B, F] batch on the device
    tiling: Optional[NKTiling]
    state: TrainState
    train_step: Callable


def make_trainer(sim: Simulator) -> Tuple[TrainState, Callable]:
    """A fresh train state and bench.py's train step for ``sim``: AdamW
    (lr 1e-3, warmup 100 of 10,000 steps), noise σ=0.02 on the velocity
    columns and the masked L2 loss."""
    opt = make_optimizer(LEARNING_RATE, warmup=WARMUP, num_steps=NUM_STEPS)
    return init_train_state(sim, opt), make_train_step(sim, l2_loss, NOISE, num_steps=NUM_STEPS)


def cylinder_train_setup(device, *, batch: int = 128, seed: int = 0, **kw) -> CylinderTrainSetup:
    """``cylinder_setup`` with fresh normalizer statistics and
    :func:`make_trainer`'s training step. ``kw`` goes to ``cylinder_setup``."""
    base = cylinder_setup(device, batch=batch, seed=seed, accumulate_stats=False, **kw)
    state, step = make_trainer(base.simulator)
    return CylinderTrainSetup(simulator=base.simulator, graph=base.graph, tiling=base.tiling,
                              state=state, train_step=step)


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

