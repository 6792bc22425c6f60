"""The train step: noise → forward → masked loss → backward → clipped AdamW.

Counterpart of graph_physics_tpu/training/step.py (NoiseConfig,
init_train_state, make_train_step, make_multi_step) for the plain-loss
path: MultiLoss, spatial MTP and data parallelism are not ported.
PyTorch runs it eagerly where JAX jits it: the parameters and
normalizer statistics (JAX's params and SimulatorState) live in the
Simulator module and are updated in place; the TrainState holds the
AdamW state and the step count. On a bf16 packed NK graph on a card, the
forward of every GraphNetBlock, and of every TransformerBlock's attention
and gated FFN, is a fused kernel and its gradient a backward kernel.
A Transolver trains with gumbel noise in its slice assignment (step.py
:150-155): the step's generator goes into the forward, and each block
draws its own noise from it (with ``fused_gumbel``, a Philox key drawn on
the device for the kernel of ops/gumbel.py). Eval and rollout draw none.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from graph_physics_tpu_torch.core.graph import MeshGraph
from graph_physics_tpu_torch.models.processors import TransolverProcessor
from graph_physics_tpu_torch.models.simulator import Simulator
from graph_physics_tpu_torch.training import loss as loss_lib
from graph_physics_tpu_torch.training import noise as noise_lib
from graph_physics_tpu_torch.training.schedule import ClippedAdamW, OptimizerConfig


@dataclass(frozen=True)
class NoiseConfig:
    starts: Tuple[int, ...]
    ends: Tuple[int, ...]
    scales: Tuple[float, ...]
    curriculum: bool = False  # cosine curriculum over training progress

    @property
    def enabled(self) -> bool:
        return len(self.starts) > 0 and any(s > 0 for s in self.scales)


@dataclass
class TrainState:
    optimizer: ClippedAdamW  # AdamW moments and update count
    step: int = 0


def model_uses_gumbel(model) -> bool:
    """True for processors whose training forward draws gumbel noise: the
    Transolver (step.py:_model_uses_gumbel)."""
    return isinstance(model, TransolverProcessor)


def init_train_state(simulator: Simulator, optimizer: OptimizerConfig) -> TrainState:
    """Bind the optimizer to the simulator's parameters (the weights are
    the module's own: drawn at construction or loaded)."""
    return TrainState(optimizer=optimizer.init(simulator.parameters()))


def make_train_step(
    simulator: Simulator,
    loss_fn: Callable = loss_lib.l2_loss,
    noise_cfg: Optional[NoiseConfig] = None,
    mask_types: Sequence[int] = loss_lib.DEFAULT_MASK_TYPES,
    num_steps: int = 1,
) -> Callable[[TrainState, MeshGraph, torch.Generator], Dict[str, torch.Tensor]]:
    """``train_step(state, batch, generator) -> metrics``, updating ``state``
    in place. ``loss_fn(graph, network_output, target, mask_types)`` is a
    plain loss (loss.l2_loss). Metrics: ``loss``, ``grad_norm`` (of the
    gradients before clipping) and ``loss_term_0``, as device scalars.
    ``num_steps`` scales the noise curriculum's progress ``step / num_steps``."""
    mask_types = tuple(int(m) for m in mask_types)
    uses_gumbel = model_uses_gumbel(simulator.model)

    def train_step(state: TrainState, batch: MeshGraph,
                   generator: torch.Generator) -> Dict[str, torch.Tensor]:
        graph = batch
        if noise_cfg is not None and noise_cfg.enabled:
            t = state.step / max(num_steps, 1) if noise_cfg.curriculum else None
            graph = noise_lib.add_noise(graph, generator, noise_cfg.starts, noise_cfg.ends,
                                        noise_cfg.scales, t=t)
        with torch.enable_grad():
            out = simulator.forward(graph, is_training=True,
                                    gumbel=generator if uses_gumbel else None)
            loss = loss_fn(graph, out.net_out, out.target_norm, mask_types)
            state.optimizer.zero_grad()
            loss.backward()
        grad_norm = state.optimizer.step()
        state.step += 1
        loss = loss.detach()
        return {"loss": loss, "grad_norm": grad_norm, "loss_term_0": loss}

    return train_step


def make_multi_step(train_step, unroll: int = 1):
    """``multi_step(state, batch, generator, num_inner=unroll) -> metrics``
    with each metric stacked over ``num_inner`` steps on the same batch, a
    fresh noise draw each step (step.py:make_multi_step; a Python loop where
    JAX scans)."""

    def multi_step(state: TrainState, batch: MeshGraph, generator: torch.Generator,
                   num_inner: int = unroll) -> Dict[str, torch.Tensor]:
        runs = [train_step(state, batch, generator) for _ in range(num_inner)]
        return {k: torch.stack([m[k] for m in runs]) for k in runs[0]}

    return multi_step
