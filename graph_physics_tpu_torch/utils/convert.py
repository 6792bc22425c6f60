"""Weight bridge: load the JAX package's parameters into the port.

The port's ``state_dict()`` names are the reference's (``model.
nodes_encoder.{i}.weight``, ``model.processor_list.{i}.edge_block...``,
``_output_normalizer._acc_sum`` ...), which graph_physics_tpu/utils/
convert.py:convert_state_dict maps to a flax parameter tree and a
SimulatorState. :func:`load_jax_params` goes the other way: it takes that
flax tree and normalizer state as numpy arrays (no jax needed) and fills a
port Simulator. flax kernels are ``[in, out]``; ``nn.Linear.weight`` is
``[out, in]``. Attention projections: the reference (and the port's
weights) keep heads last, channel d·H + h; the JAX package keeps heads
first, channel h·dh + d, and convert.py permutes the q/k/v/gate columns
and the proj rows by ``_head_perm`` (here ``layers.head_perm``), which
this module undoes. Transolver projections are heads-first in both, so
they load as they are; its LayerNorm ``scale`` is the port's ``weight``
and its attention ``bias`` [1, H, 1] the port's [1, H, 1, 1].
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from graph_physics_tpu_torch.models.layers import MLP, Attention, Dense, GatedMLPBlock, LayerNorm
from graph_physics_tpu_torch.models.normalizer import Normalizer
from graph_physics_tpu_torch.models.processors import EncodeTransformDecode, TransolverProcessor
from graph_physics_tpu_torch.models.transolver import (
    PhysicsAttention,
    TransolverBlock,
    TransolverModel,
)


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
def load_dense(dense: Dense, params: Mapping[str, Any], row_perm=None, col_perm=None) -> None:
    """Fill a port Dense from a flax Dense (``kernel [in, out]``, ``bias``
    unless both have none). ``row_perm``/``col_perm`` undo convert.py:
    _dense's column / row permutation: flax output (input) channel c is
    the port's perm[c]."""
    if ("bias" in params) != (dense.bias is not None):
        raise ValueError("Dense bias present in one model only")
    w = np.asarray(params["kernel"], np.float32).T  # [out, in] in flax order
    b = np.asarray(params["bias"], np.float32) if "bias" in params else None
    if row_perm is not None:  # port row perm[c] = flax row c
        inv = np.argsort(row_perm)
        w, b = w[inv], None if b is None else b[inv]
    if col_perm is not None:
        w = w[:, np.argsort(col_perm)]
    _copy(dense.weight, w)
    if b is not None:
        _copy(dense.bias, b)


@torch.no_grad()
def load_attention(attn: Attention, params: Mapping[str, Any], where: str) -> None:
    """A flax Attention into the port's, heads-first channels back to the
    reference's heads-last order (convert.py:_attention)."""
    names = {"q_proj", "k_proj", "v_proj", "proj"} | (
        {"gate_proj"} if attn.gate_proj is not None else set())
    if set(params) != names:
        raise ValueError(f"{where}: unexpected attention parameters {sorted(params)}")
    perm = attn.head_perm.cpu().numpy()
    for name in ("q_proj", "k_proj", "v_proj", "gate_proj"):
        if name in params:
            load_dense(getattr(attn, name), params[name], row_perm=perm)
    load_dense(attn.proj, params["proj"], col_perm=perm)


@torch.no_grad()
def load_gated_mlp(block: GatedMLPBlock, params: Mapping[str, Any]) -> None:
    """A flax GatedMLPBlock (``RMSNorm_0``, ``GatedMLP_0.Dense_0/1``,
    ``Dense_0``) into the port's (convert.py:_gated_mlp)."""
    _copy(block.norm.scale, params["RMSNorm_0"]["scale"])
    load_dense(block.gated.linear1, params["GatedMLP_0"]["Dense_0"])
    load_dense(block.gated.linear2, params["GatedMLP_0"]["Dense_1"])
    load_dense(block.out, params["Dense_0"])


def _load_layernorm(ln: LayerNorm, params: Mapping[str, Any]) -> None:
    _copy(ln.weight, params["scale"])
    _copy(ln.bias, params["bias"])


def _expect(params: Mapping[str, Any], names, where: str) -> None:
    if set(params) != set(names):
        raise ValueError(f"{where}: unexpected parameters {sorted(params)}")


@torch.no_grad()
def load_physics_attention(attn: PhysicsAttention, a: Mapping[str, Any], where: str) -> None:
    """A flax PhysicsAttention into the port's (heads-first in both)."""
    _expect(a, {"in_project_x", "in_project_slice", "proj_temperature_0", "proj_temperature_1",
                "bias", "to_q", "to_k", "to_v", "to_out"}, where)
    load_dense(attn.in_project_x, a["in_project_x"])
    load_dense(attn.in_project_slice, a["in_project_slice"])
    load_dense(attn.proj_temperature[0], a["proj_temperature_0"])
    load_dense(attn.proj_temperature[2], a["proj_temperature_1"])
    _copy(attn.bias, np.asarray(a["bias"])[..., None])
    for name in ("to_q", "to_k", "to_v"):
        load_dense(getattr(attn, name), a[name])
    load_dense(attn.to_out[0], a["to_out"])


@torch.no_grad()
def load_transolver_block(block: TransolverBlock, p: Mapping[str, Any], where: str) -> None:
    """A flax TransolverBlock (``ln_1``, ``ln_2``, ``Attn``, ``mlp``, and
    ``ln_3``/``mlp2`` on the last block) into the port's."""
    last = {"ln_3", "mlp2"} if block.last_layer else set()
    _expect(p, {"ln_1", "ln_2", "Attn", "mlp"} | last, where)
    _load_layernorm(block.ln_1, p["ln_1"])
    _load_layernorm(block.ln_2, p["ln_2"])
    load_mlp(block.mlp, p["mlp"], f"{where}.mlp")
    if block.last_layer:
        _load_layernorm(block.ln_3, p["ln_3"])
        load_dense(block.mlp2, p["mlp2"])
    load_physics_attention(block.Attn, p["Attn"], f"{where}.Attn")


@torch.no_grad()
def load_transolver(model: TransolverModel, tree: Mapping[str, Any]) -> None:
    """A flax TransolverModel's params (``preprocess``, ``placeholder``,
    ``blocks_i``) into the port's."""
    blocks = [f"blocks_{i}" for i in range(len(model.blocks))]
    _expect(tree, {"preprocess", "placeholder", *blocks}, "Transolver")
    load_mlp(model.preprocess, tree["preprocess"], "preprocess")
    _copy(model.placeholder, tree["placeholder"])
    for name, block in zip(blocks, model.blocks):
        load_transolver_block(block, tree[name], name)


@torch.no_grad()
def load_jax_params(simulator, params: Mapping[str, Any], sim_state) -> None:
    """Fill a port Simulator (``epd``, ``transformer`` or Transolver) from
    the JAX package's flax tree (``{"params": {...}}`` or the inner dict)
    and its SimulatorState, both with numpy leaves. ``sim_state`` is any
    object with the SimulatorState fields (``output_norm``, ``node_norm``,
    ``edge_norm``, each with ``acc_sum``, ``acc_sum_sq``, ``acc_count``,
    ``num_accumulations``)."""
    tree = params.get("params", params)
    model = simulator.model
    if isinstance(model, TransolverProcessor):
        _expect(tree, {"model"}, "TransolverProcessor")
        load_transolver(model.model, tree["model"])
        _load_normalizers(simulator, sim_state)
        return
    blocks = sorted((k for k in tree if k.startswith("block_")), key=lambda k: int(k[6:]))
    transformer = isinstance(model, EncodeTransformDecode)
    expected = {"nodes_encoder", "decode_module", *blocks} | (
        set() if transformer else {"edges_encoder"})
    if set(tree) != expected or len(blocks) != len(model.processor_list):
        kind = "transformer" if transformer else "epd"
        raise ValueError(f"unexpected {kind} parameter tree: {sorted(tree)}")
    load_mlp(model.nodes_encoder, tree["nodes_encoder"], "nodes_encoder")
    load_mlp(model.decode_module, tree["decode_module"], "decode_module")
    for name, block in zip(blocks, model.processor_list):
        p = tree[name]
        if transformer:
            _copy(block.norm1.scale, p["norm1"]["scale"])
            _copy(block.norm2.scale, p["norm2"]["scale"])
            load_attention(block.attention, p["attention"], f"{name}.attention")
            load_gated_mlp(block.gated_mlp, p["gated_mlp"])
        else:
            load_mlp(block.edge_block, p["edge_block"], f"{name}.edge_block")
            load_mlp(block.node_block, p["node_block"], f"{name}.node_block")
    if not transformer:
        load_mlp(model.edges_encoder, tree["edges_encoder"], "edges_encoder")
    _load_normalizers(simulator, sim_state)


def _load_normalizers(simulator, sim_state) -> None:
    _load_normalizer(simulator._output_normalizer, sim_state.output_norm)
    _load_normalizer(simulator._node_normalizer, sim_state.node_norm)
    if simulator._edge_normalizer is not None:
        _load_normalizer(simulator._edge_normalizer, sim_state.edge_norm)
