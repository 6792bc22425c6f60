"""Prediction CLI: rollouts from a checkpoint and their XDMF export.

Counterpart of graph_physics_tpu/cli/predict.py. :func:`predict` rolls out
the validation trajectories and returns their results; :func:`main` writes
each as ``<out_dir>/<run_name>/trajectory_<t>.xdmf``. With ``--fused`` each
trajectory is laid out for the kernels (training/fused.py) and rolled out
packed, as the trainer's validation does, so the card runs the kernels and
the rollout RMSE equals what ``validate`` reports for the same weights.
World edges ride as each frame's sidecar, and each step's graph gains
the world-position edge features from its predicted positions
(training/transforms.make_eval_transform), as in validation; with
``world_pos_parameters.dynamic_rollout`` each step finds the world edges
again on the device. ``--use_previous_data`` carries the columns
``--previous_data_start:--previous_data_end`` of x through the rollout
(cli/predict.py:45-56).
"""

from __future__ import annotations

import argparse
import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Rollout and export from a checkpoint")
    p.add_argument("--training_parameters_path", required=True)
    p.add_argument("--model_path", required=True, help="checkpoint directory")
    p.add_argument("--out_dir", default="predictions")
    p.add_argument("--run_name", default="prediction")
    p.add_argument("--num_trajectories", type=int, default=None)
    p.add_argument("--use_previous_data", action="store_true")
    p.add_argument("--previous_data_start", type=int, default=4)
    p.add_argument("--previous_data_end", type=int, default=7)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--external", default=None)
    p.add_argument("--fused", action="store_true",
                   help="lay each trajectory out for the Hopper kernels (with --bf16)")
    p.add_argument("--device", default="cuda", help="torch device (default: the card)")
    return p


@dataclass
class TrajectoryPrediction:
    index: int
    trajectory: object  # the host trajectory graph (training/trainer.trajectory_graph)
    predictions: np.ndarray  # [T, N', F] physical-space, boundary conditions imposed
    rmse_all_rollout: float
    rmse_1step: float


def predict(stack, num_trajectories: Optional[int] = None,
            fused: bool = False) -> List[TrajectoryPrediction]:
    """Roll out the first ``num_trajectories`` (all by default) trajectories
    of ``stack.dataset`` with ``stack.simulator``, the stack's previous-data
    slice and dynamic world edges."""
    from graph_physics_tpu_torch.models.processors import (
        EncodeProcessDecode,
        TransolverProcessor,
    )
    from graph_physics_tpu_torch.training.fused import FusedTopologyManager
    from graph_physics_tpu_torch.training.rollout import make_batched_rollout_fn, make_rollout_fn
    from graph_physics_tpu_torch.training.trainer import rollout_graph, trajectory_graph
    from graph_physics_tpu_torch.training.transforms import make_eval_transform

    sim, ds = stack.simulator, stack.dataset
    model = sim.model
    packed = not isinstance(model, TransolverProcessor)
    manager = None
    if fused and packed:
        manager = FusedTopologyManager(
            "epd" if isinstance(model, EncodeProcessDecode) else "transformer")
    kw = dict(previous_data_slice=stack.previous_data_slice,
              frame_transform=make_eval_transform(stack.world_dev),
              dynamic_world_edges=stack.dynamic_world_edges)
    rollout = make_batched_rollout_fn(sim, **kw) if packed else make_rollout_fn(sim, **kw)
    n_traj = ds.num_trajectories
    if num_trajectories is not None:
        n_traj = min(n_traj, num_trajectories)
    out = []
    for t in range(n_traj):
        traj = trajectory_graph(ds, t, manager)
        frames = rollout_graph([traj], stack.device, packed=packed)
        if hasattr(model, "tiling"):
            model.tiling = frames.layout
        res = rollout(frames)
        preds = res.predictions[:, :, 0] if packed else res.predictions
        out.append(TrajectoryPrediction(
            index=t, trajectory=traj, predictions=preds.cpu().numpy(),
            rmse_all_rollout=float(res.rmse_all_rollout.reshape(-1)[0]),
            rmse_1step=float(res.rmse_1step.reshape(-1)[0])))
    return out


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    from graph_physics_tpu_torch.cli.common import load_inference_stack
    from graph_physics_tpu_torch.training.trainer import write_rollout_xdmf

    stack = load_inference_stack(args)
    for p in predict(stack, args.num_trajectories, fused=args.fused):
        path = write_rollout_xdmf(
            os.path.join(args.out_dir, args.run_name, f"trajectory_{p.index}.xdmf"),
            p.predictions, p.trajectory)
        print(f"trajectory {p.index}: rollout_rmse={p.rmse_all_rollout:.6f} -> {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
