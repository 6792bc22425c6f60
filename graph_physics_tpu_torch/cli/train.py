"""Training CLI (counterpart of graph_physics_tpu/cli/train.py).

The same two-JSON contract: a training config (dataset/model/index/
transformations/loss/training blocks) and the dataset's meta.json, with
run-level knobs as flags; ``--device`` picks the device (default the
card). Example:

  python -m graph_physics_tpu_torch.cli.train \\
      --training_parameters_path training_config/cylinder.json \\
      --epochs 25 --batch_size 128 --packed --bf16 --fused

World edges (``world_pos_parameters.use``, plate.json; a transformer or
an ``epd``, DeformingPlate's MeshGraphNet) train in the sidecar layout
with ``--packed``, as JAX's CLI switches to it there, and in JAX's concat
layout (appended to each frame's mesh edges, stacked per sample, the
plain path) without it; the world-position edge features are computed
on the device after the noise. The validation rollouts use the sidecar
in both cases: where JAX's CLI builds them in the concat layout, the port
builds the same edge set beside the mesh, so the kernels' world seam (the
attention kernels', or the GraphNetBlock kernels' ``extra_agg``) runs
there as well. With ``world_pos_parameters.dynamic_rollout`` the
validation rollouts find the world edges again at every step on the
device (training/rollout.DynamicWorldEdges), and the validation frames
only reserve the sidecar's slots.

``--external NAME`` builds each frame's features with the named builder
of ``external/`` (panels, aneurysm, bezier), which reads the previous
frame's data. ``--use_previous_data`` makes the frames carry the
previous frame's data too, and the validation rollouts carry the columns
``--previous_data_start:--previous_data_end`` of x
(``TrainerConfig.previous_data_slice``): for the aneurysm configs, where
``external/aneurysm.build_features`` puts the acceleration. A config's
physics losses (``loss.type`` with several terms,
``loss.gradient_method``) reach the Trainer's step.

``--num_partitions`` and ``--max_nodes_per_partition`` train on sub-mesh
partitions (dataset/partition.py: recursive coordinate bisection, each
(frame, part) a sample); the validation rollouts take the full mesh, as
JAX's CLI builds them. With world edges, partitions need the concat layout
(no ``--packed``): the sidecar raises, as in JAX.

The flags of a later queue item raise NotImplementedError naming it:
``--num_dp_devices``, ``--multihost`` (A 9).
The weights are drawn from ``--seed`` as the JAX package's flax layers
draw theirs (models/layers.lecun_parameters: lecun-normal kernels, zero
biases).
"""

from __future__ import annotations

import argparse
import os

import torch


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train a mesh simulator with the PyTorch port")
    p.add_argument("--training_parameters_path", required=True)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--learning_rate", type=float, default=1e-3)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--warmup", type=int, default=1000)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--out_dir", default="runs")
    p.add_argument("--run_name", default=None)
    p.add_argument("--resume_training", action="store_true")
    p.add_argument("--masking_ratio", type=float, default=None)
    p.add_argument("--use_previous_data", action="store_true")
    p.add_argument("--previous_data_start", type=int, default=4)
    p.add_argument("--previous_data_end", type=int, default=7)
    p.add_argument("--max_val_trajectories", type=int, default=None)
    p.add_argument("--val_device_batch", type=int, default=8,
                   help="max same-topology val trajectories on the device at once "
                        "(0 = a whole group)")
    p.add_argument("--save_val_xdmf", action="store_true")
    p.add_argument("--use_wandb", action="store_true")
    p.add_argument("--multihost", action="store_true", help="not ported (ROADMAP A 9)")
    p.add_argument("--coordinator_address", default=None)
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--num_dp_devices", type=int, default=None,
                   help="not ported (ROADMAP A 9)")
    p.add_argument("--accumulate_grad_batches", type=int, default=1)
    p.add_argument("--num_partitions", type=int, default=None,
                   help="train on RCB sub-mesh partitions (Cluster-GCN style)")
    p.add_argument("--max_nodes_per_partition", type=int, default=None,
                   help="adaptive partition count cap by node budget")
    p.add_argument("--bf16", action="store_true", help="bfloat16 compute dtype")
    p.add_argument("--packed", action="store_true", help="trajectory-major [N,B,F] batching")
    p.add_argument("--fused", action="store_true",
                   help="lay topologies out for the Hopper kernels (requires --packed --bf16)")
    p.add_argument("--fused_wb_buckets", type=int, default=1,
                   help="JAX's sender-window buckets; the port accepts only 1")
    p.add_argument("--fused_attn_nk", action=argparse.BooleanOptionalAction, default=True,
                   help="transformer models: the NK attention layout where it is priced "
                        "in; --no-fused_attn_nk forces CSR everywhere")
    p.add_argument("--fused_gn_nk", action=argparse.BooleanOptionalAction, default=True,
                   help="epd models: the NK GraphNetBlock layout where it is priced in; "
                        "--no-fused_gn_nk forces CSR everywhere")
    p.add_argument("--loader_workers", type=int, default=1)
    p.add_argument("--broadcast_static", default=True, action=argparse.BooleanOptionalAction,
                   help="packed loader: ship shared static leaves as [E,1,F] views, "
                        "widened on the device by the train step")
    p.add_argument("--steps_per_dispatch", type=int, default=1)
    p.add_argument("--external", default=None,
                   help="feature builder of external/: panels, aneurysm or bezier")
    p.add_argument("--device", default="cuda", help="torch device (default: the card)")
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    from graph_physics_tpu_torch.cli.common import (
        external_features,
        previous_data_slice,
        validation_frame_config,
        with_sidecar,
    )
    from graph_physics_tpu_torch.models.layers import lecun_parameters
    from graph_physics_tpu_torch.models.processors import TransolverProcessor
    from graph_physics_tpu_torch.models.transolver import init_parameters
    from graph_physics_tpu_torch.training import config as config_lib
    from graph_physics_tpu_torch.training.trainer import Trainer, TrainerConfig, resolve_device

    device = resolve_device(args.device)
    if args.multihost or args.num_dp_devices:
        raise NotImplementedError("--multihost and --num_dp_devices are not ported "
                                  "(ROADMAP A 9)")
    param = config_lib.load_params(args.training_parameters_path)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    model = config_lib.get_model(param, dtype=dtype)
    simulator = config_lib.get_simulator(param, model)
    gen = torch.Generator().manual_seed(args.seed)
    if isinstance(model, TransolverProcessor):
        init_parameters(simulator, gen, dense_init=lecun_parameters)
    else:
        lecun_parameters(simulator, gen)
    config_lib.get_mtp_setup(param)
    loss_fn, loss_name = config_lib.get_loss(param)
    gradient_method = config_lib.get_gradient_method(param)
    dynamic_we = config_lib.get_dynamic_world_edges(param)
    noise_cfg = config_lib.get_noise_config(param)
    _, world_dev = config_lib.get_world_configs(param)
    extra, use_prev = external_features(args)
    frame_cfg = config_lib.get_frame_config(param, masking_ratio=args.masking_ratio,
                                            use_previous_data=use_prev,
                                            extra_node_features=extra)
    if args.packed:  # an unpacked run keeps the concat layout
        frame_cfg = with_sidecar(frame_cfg)
    train_ds = config_lib.get_dataset(param, frame_cfg, switch_to_val=False, seed=args.seed,
                                      num_partitions=args.num_partitions,
                                      max_nodes_per_partition=args.max_nodes_per_partition)
    val_cfg = with_sidecar(validation_frame_config(config_lib.get_frame_config(
        param, masking_ratio=0.0, use_previous_data=use_prev, extra_node_features=extra),
        dynamic_we))
    val_ds = config_lib.get_dataset(param, val_cfg, switch_to_val=True, seed=args.seed)
    run_name = args.run_name or os.path.splitext(
        os.path.basename(args.training_parameters_path))[0]
    if args.fused:
        if not (args.packed and args.bf16):
            raise SystemExit("--fused requires --packed and --bf16")
        if param["dataset"].get("new_edges_ratio", 0):
            raise SystemExit("--fused is incompatible with new_edges_ratio (per-frame topology)")
    tcfg = TrainerConfig(
        epochs=args.epochs, batch_size=args.batch_size, learning_rate=args.learning_rate,
        warmup=args.warmup, seed=args.seed, out_dir=args.out_dir, run_name=run_name,
        max_val_trajectories=args.max_val_trajectories,
        val_device_batch=args.val_device_batch or None, loader_workers=args.loader_workers,
        broadcast_static=args.broadcast_static, save_val_xdmf=args.save_val_xdmf,
        use_wandb=args.use_wandb, accumulate_grad_batches=args.accumulate_grad_batches,
        previous_data_slice=previous_data_slice(args),
        packed=args.packed, steps_per_dispatch=args.steps_per_dispatch, fused=args.fused,
        fused_wb_buckets=args.fused_wb_buckets, fused_attn_nk=args.fused_attn_nk,
        fused_gn_nk=args.fused_gn_nk)
    trainer = Trainer(simulator, train_ds, val_ds, loss_fn, tcfg,
                      gradient_method=gradient_method,
                      run_metadata={"config": param, "loss": loss_name}, noise_cfg=noise_cfg,
                      world_pos=world_dev, dynamic_world_edges=dynamic_we, device=device)
    state = trainer.fit(resume=args.resume_training)
    print(f"training done at step {int(state.step)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
