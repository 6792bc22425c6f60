"""Shared CLI plumbing: the checkpoint-restore preamble for inference.

Counterpart of graph_physics_tpu/cli/common.py:load_inference_stack: the
config gives the model and simulator, the checkpoint their weights and
normalizer statistics, and the validation dataset (noise and masking off)
the trajectories. A caller may pass the dataset itself, so a machine
without h5py can drive it (the card's ``chip_smoke.py`` does). World
edges come in the sidecar layout (:func:`with_sidecar`), where JAX's
inference stack builds them in the concat layout: the same edge set and
the same function (tests/test_world_sidecar.py:86, :124), and the
kernels' world seam runs in the rollouts. With
``world_pos_parameters.dynamic_rollout`` the rollout finds the world
edges again at every step, and the frames' sidecars only reserve their
slots (:func:`validation_frame_config`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch


@dataclasses.dataclass
class InferenceStack:
    param: Dict[str, Any]
    simulator: Any  # weights and normalizers restored, on ``device``
    dataset: Any
    metadata: Optional[Dict[str, Any]]
    step: int  # the restored checkpoint's train step
    device: torch.device
    #: the world-position edge features' columns (training/transforms.py), or None
    world_dev: Any = None
    #: the rollout's world edges found again at every step
    #: (training/rollout.DynamicWorldEdges), or None
    dynamic_world_edges: Any = None
    #: the columns of x the rollout carries (``--use_previous_data``), or None
    previous_data_slice: Optional[Tuple[int, int]] = None


def previous_data_slice(args) -> Optional[Tuple[int, int]]:
    """(``--previous_data_start``, ``--previous_data_end``) with
    ``--use_previous_data``, else None (cli/train.py:250-252)."""
    if not getattr(args, "use_previous_data", False):
        return None
    return args.previous_data_start, args.previous_data_end


def external_features(args):
    """(feature builder or None, use_previous_data): a builder of
    ``external/`` (``--external``) reads the previous frame's data, and so
    does ``--use_previous_data``; either makes the frame config take it
    (cli/train.py:157-160, :175; cli/common.py:45-57)."""
    use_prev = bool(getattr(args, "use_previous_data", False))
    name = getattr(args, "external", None)
    if not name:
        return None, use_prev
    from graph_physics_tpu_torch.external import get_feature_builder

    return get_feature_builder(name), True


def validation_frame_config(frame_cfg, dynamic_world_edges):
    """The rollout frames' configuration: with dynamic world edges the
    host finds none (radius 1e-12) but keeps the world budget, so each
    sidecar reserves the slots the rollout fills (cli/common.py:60-68,
    cli/train.py:201-212)."""
    if dynamic_world_edges is None or frame_cfg.world is None:
        return frame_cfg
    return dataclasses.replace(frame_cfg, world=dataclasses.replace(frame_cfg.world,
                                                                    radius=1e-12))


def with_sidecar(frame_cfg):
    """``frame_cfg`` with its world edges, if any, in the sidecar layout
    (cli/train.py:182-192)."""
    if frame_cfg.world is None:
        return frame_cfg
    return dataclasses.replace(frame_cfg, world=dataclasses.replace(frame_cfg.world,
                                                                    sidecar=True))


def load_inference_stack(args, dataset=None) -> InferenceStack:
    """Model, simulator and validation dataset from ``args``
    (``training_parameters_path``, ``model_path``, ``bf16``, ``device``,
    ``use_previous_data`` with ``previous_data_start``/``_end``,
    ``external``: the feature builder that makes the frames' features)
    and the latest checkpoint under ``model_path`` restored into the
    simulator. ``dataset`` replaces the config's validation dataset; with
    dynamic world edges its sidecars should reserve their slots
    (:func:`validation_frame_config`)."""
    from graph_physics_tpu_torch.training import checkpoint as ckpt_lib
    from graph_physics_tpu_torch.training import config as config_lib
    from graph_physics_tpu_torch.training.trainer import resolve_device

    device = resolve_device(getattr(args, "device", "cuda"))
    param = config_lib.load_params(args.training_parameters_path)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    simulator = config_lib.get_simulator(param, config_lib.get_model(param, dtype=dtype))
    simulator = simulator.to(device)
    dynamic_we = config_lib.get_dynamic_world_edges(param)
    _, world_dev = config_lib.get_world_configs(param)
    if dataset is None:
        extra, use_prev = external_features(args)
        frame_cfg = with_sidecar(validation_frame_config(config_lib.get_frame_config(
            param, masking_ratio=0.0, use_previous_data=use_prev, extra_node_features=extra),
            dynamic_we))
        dataset = config_lib.get_dataset(param, frame_cfg, switch_to_val=True)
    manager = ckpt_lib.make_manager(args.model_path)
    step = manager.latest_step()
    metadata = ckpt_lib.restore_checkpoint(manager, simulator)
    return InferenceStack(param=param, simulator=simulator, dataset=dataset, metadata=metadata,
                          step=step, device=device, world_dev=world_dev,
                          dynamic_world_edges=dynamic_we,
                          previous_data_slice=previous_data_slice(args))
