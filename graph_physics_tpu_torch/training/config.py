"""JSON config -> the port's objects (the two-file contract of the JAX
package: a training config with dataset/model/index/transformations/
loss/training blocks, and the dataset's meta.json).

Counterpart of graph_physics_tpu/training/config.py: the h5 and xdmf
datasets, the data and physics losses (``LossType``, ``MultiLoss``) with
their gradient method, the rollout's dynamic world edges. Options that
belong to later queue items raise NotImplementedError naming their
ROADMAP item: the temporal block, RoPE and gates in the GraphNetBlock,
gated MLPs, multigrid, remat and spatial MTP (A 7).
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional

import torch

from graph_physics_tpu_torch.core.nodetype import NodeType
from graph_physics_tpu_torch.dataset.preprocessing import FrameConfig, WorldConfig
from graph_physics_tpu_torch.models.processors import (
    EncodeProcessDecode,
    EncodeTransformDecode,
    TransolverProcessor,
)
from graph_physics_tpu_torch.models.simulator import Simulator
from graph_physics_tpu_torch.training.loss import LossType, MultiLoss
from graph_physics_tpu_torch.training.step import NoiseConfig
from graph_physics_tpu_torch.training.transforms import WorldPosConfig


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported (ROADMAP {item})")


def load_params(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def get_model(param: Dict[str, Any], dtype=torch.float32):
    """The processor of the config's ``model`` block (config.py:get_model
    :35): ``node_input_size`` grows by NodeType.SIZE for the one-hot types.
    The Transolver draws its slice noise through ops/gumbel.py's kernel
    (its plain version on the CPU)."""
    m = param.get("model", {})
    model_type = m.get("type", "")
    training = param.get("training", {})
    node_input_size = m["node_input_size"] + int(NodeType.SIZE)
    if training.get("use_temporal_block", False):
        raise not_ported("the temporal block (training.use_temporal_block)", "A 7")
    if training.get("enable_vram_optimizations", False) and model_type != "transolver":
        raise not_ported("remat (training.enable_vram_optimizations)", "A 7")
    common = dict(message_passing_num=m["message_passing_num"],
                  node_input_size=node_input_size, output_size=m["output_size"],
                  hidden_size=m["hidden_size"], dtype=dtype)
    if model_type == "epd":
        for key in ("use_rope_embeddings", "use_gated_attention", "use_gated_mlp"):
            if m.get(key, False):
                raise not_ported(f"the GraphNetBlock option model.{key}", "A 7")
        return EncodeProcessDecode(edge_input_size=m["edge_input_size"], **common)
    if model_type == "transformer":
        if m.get("use_multigrid", False):
            raise not_ported("multigrid (model.use_multigrid)", "A 7")
        return EncodeTransformDecode(
            num_heads=m["num_heads"], use_rope_embeddings=m.get("use_rope_embeddings", False),
            use_gated_attention=m.get("use_gated_attention", False),
            rope_pos_dimension=m.get("rope_pos_dimension", 3),
            rope_base=m.get("rope_base", 10000.0),
            use_silu=m.get("use_silu_activation", False), **common)
    if model_type == "transolver":
        return TransolverProcessor(
            num_heads=m["num_heads"], mlp_ratio=m.get("mlp_ratio", 1),
            slice_num=m.get("slice_num", 32), ref=m.get("ref", 8),
            unified_pos=m.get("unified_pos", False), fused_gumbel=True, **common)
    raise ValueError(f"Model type '{model_type}' not supported.")


def get_simulator(param: Dict[str, Any], model) -> Simulator:
    """config.py:get_simulator (:94)."""
    return Simulator(
        node_input_size=param["model"]["node_input_size"] + int(NodeType.SIZE),
        edge_input_size=param["model"]["edge_input_size"],
        output_size=param["model"]["output_size"],
        feature_index_start=param["index"]["feature_index_start"],
        feature_index_end=param["index"]["feature_index_end"],
        output_index_start=param["index"]["output_index_start"],
        output_index_end=param["index"]["output_index_end"],
        node_type_index=param["index"]["node_type_index"],
        model=model,
    )


def get_noise_config(param: Dict[str, Any], remove_noise: bool = False
                     ) -> Optional[NoiseConfig]:
    """The preprocessing block's noise (config.py:get_noise_config :110)."""
    pp = param.get("transformations", {}).get("preprocessing", {})
    scale = pp.get("noise", 0)
    if not scale or remove_noise:
        return None
    starts = pp.get("noise_index_start")
    ends = pp.get("noise_index_end")
    starts = [starts] if isinstance(starts, int) else list(starts)
    ends = [ends] if isinstance(ends, int) else list(ends)
    scales = [scale] * len(starts) if isinstance(scale, (int, float)) else list(scale)
    return NoiseConfig(starts=tuple(starts), ends=tuple(ends), scales=tuple(scales),
                       curriculum=bool(pp.get("noise_curriculum", False)))


def get_world_configs(param: Dict[str, Any]):
    """World-edge parameters for the host builder and the device transform,
    ``(WorldConfig, WorldPosConfig)``, or (None, None) without
    ``world_pos_parameters.use`` (config.py:get_world_configs :129): radius
    0.03 and a budget of 1,024 edges unless set. FrameBuilder's layout is
    JAX's default, the concat one; the CLIs switch to the sidecar where
    the batch is packed, and for every rollout."""
    wp = param.get("transformations", {}).get("world_pos_parameters", {})
    if not wp.get("use", False):
        return None, None
    host = WorldConfig(world_pos_index_start=wp["world_pos_index_start"],
                       world_pos_index_end=wp["world_pos_index_end"],
                       node_type_index=param["index"]["node_type_index"],
                       radius=wp.get("radius", 0.03), edge_budget=wp.get("edge_budget", 1024))
    return host, WorldPosConfig(start=wp["world_pos_index_start"],
                                end=wp["world_pos_index_end"])


def get_dynamic_world_edges(param: Dict[str, Any]):
    """The rollout's world edges found again on the device at every step
    (training/rollout.DynamicWorldEdges), or None unless
    ``world_pos_parameters`` has ``use`` and ``dynamic_rollout``
    (config.py:get_dynamic_world_edges :147): ``edge_budget // 2`` pairs a
    direction, ``k_per_node`` (16) nearest a node, ``radius`` (0.03);
    ``dynamic_rollout_track`` "predicted" (the default) searches the
    predicted positions, "ground_truth" the frames' own."""
    from graph_physics_tpu_torch.training.rollout import DynamicWorldEdges

    wp = param.get("transformations", {}).get("world_pos_parameters", {})
    if not (wp.get("use", False) and wp.get("dynamic_rollout", False)):
        return None
    track = wp.get("dynamic_rollout_track", "predicted")
    if track not in ("predicted", "ground_truth"):
        raise ValueError("world_pos_parameters.dynamic_rollout_track must be "
                         f"'predicted' or 'ground_truth', got {track!r}")
    return DynamicWorldEdges(
        world_pos_start=wp["world_pos_index_start"], world_pos_end=wp["world_pos_index_end"],
        radius=wp.get("radius", 0.03), budget=wp.get("edge_budget", 1024) // 2,
        k_per_node=wp.get("k_per_node", 16), track_predicted=(track == "predicted"))


def get_frame_config(param: Dict[str, Any], masking_ratio: Optional[float] = None,
                     use_previous_data: bool = False,
                     use_edge_feature: bool = True,
                     extra_node_features=None, extra_edge_features=None) -> FrameConfig:
    """config.py:get_frame_config (:182); ``extra_node_features`` is a
    feature builder of ``external/``."""
    world, _ = get_world_configs(param)
    ds = param["dataset"]
    pp = param.get("transformations", {}).get("preprocessing", {})
    return FrameConfig(
        targets=tuple(ds["targets"]),
        khop=ds.get("khop", 1),
        world=world,
        new_edges_ratio=ds.get("new_edges_ratio", 0.0) or 0.0,
        masking_ratio=(masking_ratio if masking_ratio is not None
                       else pp.get("masking", 0) or 0.0),
        use_previous_data=use_previous_data,
        add_edge_features=use_edge_feature,
        extra_node_features=extra_node_features,
        extra_edge_features=extra_edge_features,
    )


def get_dataset(param: Dict[str, Any], frame_config: FrameConfig, switch_to_val: bool = False,
                seed: int = 0, num_partitions: Optional[int] = None,
                max_nodes_per_partition: Optional[int] = None):
    """config.py:get_dataset (:209): the h5 or the xdmf dataset, on sub-mesh
    partitions where ``num_partitions`` or ``max_nodes_per_partition`` is
    given."""
    ds = param["dataset"]
    ext = ds["extension"]
    path = ds["test_path"] if switch_to_val else ds["train_path"]
    kwargs = dict(seed=seed, num_partitions=num_partitions,
                  max_nodes_per_partition=max_nodes_per_partition)
    if ext == "h5":
        from graph_physics_tpu_torch.dataset.h5_dataset import H5Dataset

        return H5Dataset(path, ds["meta_path"], frame_config, **kwargs)
    if ext == "xdmf":
        from graph_physics_tpu_torch.dataset.xdmf_dataset import XDMFDataset

        return XDMFDataset(path, ds["meta_path"], frame_config, **kwargs)
    raise ValueError(f"Dataset extension '{ext}' not supported.")


def get_loss(param: Dict[str, Any]):
    """(loss, name or names) of the config's ``loss`` block
    (config.py:get_loss :237): ``LossType.L2LOSS`` without one, a
    ``LossType`` for one type, a ``MultiLoss`` with the block's weights for
    several."""
    loss_block = param.get("loss")
    if loss_block is None:
        return LossType.L2LOSS, LossType.L2LOSS.name
    types = loss_block["type"]
    if len(types) > 1:
        losses = [LossType[t.upper()] for t in types]
        return MultiLoss(losses, loss_block["weights"]), [loss.name for loss in losses]
    loss = LossType[types[0].upper()]
    return loss, loss.name


def get_gradient_method(param: Dict[str, Any]) -> Optional[str]:
    """The physics losses' gradient method, ``finite_diff`` or
    ``least_squares``, or None (config.py:get_gradient_method :251)."""
    return param.get("loss", {}).get("gradient_method")


def get_mtp_setup(param: Dict[str, Any]):
    """None; spatial MTP (``training.use_spatial_mtp``) raises: ROADMAP A 7."""
    if param.get("training", {}).get("use_spatial_mtp", False):
        raise not_ported("spatial MTP (training.use_spatial_mtp)", "A 7")
    return None
