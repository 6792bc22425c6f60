"""Shared CLI plumbing: the checkpoint-restore preamble for inference.

Counterpart of graph_physics_tpu/cli/common.py:load_inference_stack: the
config gives the model and simulator, the checkpoint their weights and
normalizer statistics, and the validation dataset (noise and masking off)
the trajectories. A caller may pass the dataset itself, so a machine
without h5py can drive it (the card's ``chip_smoke.py`` does). World
edges come in the sidecar layout (:func:`with_sidecar`), where JAX's
inference stack builds them in the concat layout: the same edge set and
the same function (tests/test_world_sidecar.py:86, :124), and the
kernels' world seam runs in the rollouts.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

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


def check_later_options(args) -> None:
    """Flags of later queue items raise, naming their ROADMAP item."""
    if getattr(args, "use_previous_data", False):
        raise NotImplementedError("--use_previous_data (the rollout's previous_data_slice) "
                                  "is not ported (ROADMAP A 5.3)")


def external_features(args):
    """(feature builder or None, use_previous_data) of ``--external``: a
    builder of ``external/`` reads the previous frame's data, so the frame
    config takes it (cli/train.py:157-160, :175; cli/common.py:45-57)."""
    name = getattr(args, "external", None)
    if not name:
        return None, False
    from graph_physics_tpu_torch.external import get_feature_builder

    return get_feature_builder(name), True


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
    ``use_previous_data``, ``external``: the feature builder that makes
    the frames' features) and the latest checkpoint under ``model_path``
    restored into the simulator. ``dataset`` replaces the config's
    validation dataset."""
    from graph_physics_tpu_torch.training import checkpoint as ckpt_lib
    from graph_physics_tpu_torch.training import config as config_lib
    from graph_physics_tpu_torch.training.trainer import resolve_device

    device = resolve_device(getattr(args, "device", "cuda"))
    check_later_options(args)
    param = config_lib.load_params(args.training_parameters_path)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    simulator = config_lib.get_simulator(param, config_lib.get_model(param, dtype=dtype))
    simulator = simulator.to(device)
    config_lib.get_dynamic_world_edges(param)
    _, world_dev = config_lib.get_world_configs(param)
    if dataset is None:
        extra, use_prev = external_features(args)
        frame_cfg = with_sidecar(config_lib.get_frame_config(
            param, masking_ratio=0.0, use_previous_data=use_prev, extra_node_features=extra))
        dataset = config_lib.get_dataset(param, frame_cfg, switch_to_val=True)
    manager = ckpt_lib.make_manager(args.model_path)
    step = manager.latest_step()
    metadata = ckpt_lib.restore_checkpoint(manager, simulator)
    return InferenceStack(param=param, simulator=simulator, dataset=dataset, metadata=metadata,
                          step=step, device=device, world_dev=world_dev)
