"""Weight bridge: load the JAX package's parameters into the port.

The port's ``state_dict()`` names are the reference's (``model.
nodes_encoder.{i}.weight``, ``model.processor_list.{i}.edge_block...``,
``_output_normalizer._acc_sum`` ...), which graph_physics_tpu/utils/
convert.py:convert_state_dict maps to a flax parameter tree and a
SimulatorState. :func:`load_jax_params` goes the other way: it takes that
flax tree and normalizer state as numpy arrays (no jax needed) and fills a
port Simulator. flax kernels are ``[in, out]``; ``nn.Linear.weight`` is
``[out, in]``.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from graph_physics_tpu_torch.models.layers import MLP
from graph_physics_tpu_torch.models.normalizer import Normalizer


def _copy(dst: torch.Tensor, src) -> None:
    src = torch.from_numpy(np.array(src, dtype=np.float32))  # a copy: jax arrays are read-only
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"shape mismatch: {tuple(src.shape)} into {tuple(dst.shape)}")
    dst.copy_(src.to(dst.device))


@torch.no_grad()
def load_mlp(mlp: MLP, params: Mapping[str, Any], where: str = "mlp") -> None:
    """Fill a port MLP from a flax MLP's params (``Dense_j``, ``RMSNorm_0``)."""
    denses = mlp.denses
    names = sorted((k for k in params if k.startswith("Dense_")), key=lambda k: int(k[6:]))
    if len(names) != len(denses):
        raise ValueError(f"{where}: {len(names)} Dense layers for {len(denses)} Linear")
    for d, name in zip(denses, names):
        _copy(d.weight, np.asarray(params[name]["kernel"]).T)
        _copy(d.bias, params[name]["bias"])
    has_norm = "RMSNorm_0" in params
    if has_norm != (mlp.norm is not None):
        raise ValueError(f"{where}: RMSNorm present in one model only")
    if has_norm:
        _copy(mlp.norm.scale, params["RMSNorm_0"]["scale"])


def _load_normalizer(norm: Normalizer, state) -> None:
    _copy(norm._acc_sum, state.acc_sum)
    _copy(norm._acc_sum_squared, state.acc_sum_sq)
    _copy(norm._acc_count, state.acc_count)
    _copy(norm._num_accumulations, state.num_accumulations)


@torch.no_grad()
def load_jax_params(simulator, params: Mapping[str, Any], sim_state) -> None:
    """Fill an ``epd`` port Simulator from the JAX package's flax tree
    (``{"params": {...}}`` or the inner dict) and its SimulatorState, both
    with numpy leaves. ``sim_state`` is any object with the SimulatorState
    fields (``output_norm``, ``node_norm``, ``edge_norm``, each with
    ``acc_sum``, ``acc_sum_sq``, ``acc_count``, ``num_accumulations``)."""
    tree = params.get("params", params)
    model = simulator.model
    blocks = sorted((k for k in tree if k.startswith("block_")), key=lambda k: int(k[6:]))
    expected = {"nodes_encoder", "edges_encoder", "decode_module", *blocks}
    if set(tree) != expected or len(blocks) != len(model.processor_list):
        raise ValueError(f"unexpected epd parameter tree: {sorted(tree)}")
    load_mlp(model.nodes_encoder, tree["nodes_encoder"], "nodes_encoder")
    load_mlp(model.edges_encoder, tree["edges_encoder"], "edges_encoder")
    load_mlp(model.decode_module, tree["decode_module"], "decode_module")
    for name, block in zip(blocks, model.processor_list):
        load_mlp(block.edge_block, tree[name]["edge_block"], f"{name}.edge_block")
        load_mlp(block.node_block, tree[name]["node_block"], f"{name}.node_block")
    _load_normalizer(simulator._output_normalizer, sim_state.output_norm)
    _load_normalizer(simulator._node_normalizer, sim_state.node_norm)
    if simulator._edge_normalizer is not None:
        _load_normalizer(simulator._edge_normalizer, sim_state.edge_norm)
