"""The train step: noise → forward → masked loss → backward → clipped AdamW.

Counterpart of graph_physics_tpu/training/step.py (NoiseConfig,
init_train_state, make_train_step, make_multi_step) with its three kinds
of loss: a plain loss, a ``LossType`` and a ``MultiLoss`` of data and
physics terms (step.py:184-237); spatial MTP (ROADMAP A 7) and data
parallelism (A 9) are not ported.
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
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch

from graph_physics_tpu_torch.core.graph import MeshGraph
from graph_physics_tpu_torch.models.processors import TransolverProcessor
from graph_physics_tpu_torch.models.simulator import Simulator, sample_of
from graph_physics_tpu_torch.training import loss as loss_lib
from graph_physics_tpu_torch.training.loss import LossInputs, LossType, MultiLoss
from graph_physics_tpu_torch.training import packed as packed_lib
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
    loss_fn: Union[Callable, LossType, MultiLoss] = loss_lib.l2_loss,
    device_preprocess: Optional[Callable] = None,
    mask_types: Sequence[int] = loss_lib.DEFAULT_MASK_TYPES,
    gradient_method: Optional[str] = None,
) -> Callable[[TrainState, MeshGraph, torch.Generator], Dict[str, torch.Tensor]]:
    """``train_step(state, batch, generator) -> metrics``, updating ``state``
    in place. ``loss_fn`` is a plain loss ``(graph, network_output, target,
    mask_types)`` (loss.l2_loss), a ``LossType`` or a ``MultiLoss``, whose
    physics terms take ``gradient_method`` (:func:`multi_loss`). Metrics:
    ``loss``, ``grad_norm`` (of the gradients before clipping) and
    ``loss_term_i`` for each term, as device scalars.
    A ``broadcast_static`` batch's [E, 1, F] leaves are widened first
    (packed.expand_static_leaves), as JAX's step does; then
    ``device_preprocess(graph, generator, step) -> graph``
    (training/transforms.make_device_preprocess: the noise, then the
    world-position features) runs when given. JAX's step also takes a
    ``noise_cfg``, which its ``device_preprocess`` supersedes: here the
    noise is only ever the preprocess's."""
    mask_types = tuple(int(m) for m in mask_types)
    uses_gumbel = model_uses_gumbel(simulator.model)

    def train_step(state: TrainState, batch: MeshGraph,
                   generator: torch.Generator) -> Dict[str, torch.Tensor]:
        graph = packed_lib.expand_static_leaves(batch)
        if device_preprocess is not None:
            graph = device_preprocess(graph, generator, state.step)
        with torch.enable_grad():
            out = simulator.forward(graph, is_training=True,
                                    gumbel=generator if uses_gumbel else None)
            if isinstance(loss_fn, MultiLoss):
                loss, terms = multi_loss(loss_fn, simulator, graph, out, mask_types,
                                         gradient_method)
            elif isinstance(loss_fn, LossType):
                loss = loss_fn.fn(LossInputs(graph=graph, target=out.target_norm,
                                             network_output=out.net_out,
                                             deselected=graph.deselected),
                                  mask_types=mask_types)
                terms = [loss]
            else:
                loss = loss_fn(graph, out.net_out, out.target_norm, mask_types)
                terms = [loss]
            state.optimizer.zero_grad()
            loss.backward()
        grad_norm = state.optimizer.step()
        state.step += 1
        metrics = {"loss": loss.detach(), "grad_norm": grad_norm}
        metrics.update({f"loss_term_{i}": t.detach() for i, t in enumerate(terms)})
        return metrics

    return train_step


def multi_loss(loss_fn: MultiLoss, simulator: Simulator, graph: MeshGraph, out,
               mask_types: Sequence[int], gradient_method: Optional[str]):
    """(total, [weighted term, ...]) of a MultiLoss on the forward ``out``
    (step.py:184-237): the prediction's and the target's physical values
    through ``Simulator.build_outputs_from_pre``, then, in the packed
    [N, B, F] layout, each term a mean per sample over the shared topology
    (:func:`loss.per_sample_mean`, batched over B), then the mean over the
    samples, as JAX's ``vmap`` over axis 1 gives them; a stacked batch
    sample by sample; one frame as it is."""
    pre_t = simulator.pre_target(graph)
    inp = LossInputs(graph=graph, target=out.target_norm, network_output=out.net_out,
                     network_output_physical=simulator.build_outputs_from_pre(out.net_out, pre_t),
                     target_physical=simulator.build_outputs_from_pre(out.target_norm, pre_t),
                     deselected=graph.deselected)
    kw = dict(mask_types=mask_types, gradient_method=gradient_method, return_all_losses=True)
    if simulator.is_packed(graph):
        total, terms = loss_fn(inp, mean_fn=loss_lib.per_sample_mean, **kw)
        return total.mean(), [t.mean() for t in terms]
    if simulator.is_stacked(graph):
        per = [loss_fn(_sample_inputs(inp, b), **kw) for b in range(graph.x.shape[0])]
        return (torch.stack([p[0] for p in per]).mean(),
                [torch.stack(t).mean() for t in zip(*(p[1] for p in per))])
    return loss_fn(inp, **kw)


def _sample_inputs(inp: LossInputs, b: int) -> LossInputs:
    """Sample ``b`` of a stacked batch's loss inputs."""
    def take(v):
        return None if v is None else v[b]

    return LossInputs(graph=sample_of(inp.graph, b), target=take(inp.target),
                      network_output=take(inp.network_output),
                      network_output_physical=take(inp.network_output_physical),
                      target_physical=take(inp.target_physical),
                      deselected=take(inp.deselected))


def make_multi_step(train_step, unroll: int = 1):
    """``multi_step(state, batch, generator, num_inner=unroll) -> metrics``
    with each metric stacked over the inner steps (step.py:make_multi_step;
    a Python loop where JAX scans). ``batch`` is one batch, taken
    ``num_inner`` times with a fresh noise draw each, or a sequence of
    batches, one a step. ``generator`` is a generator or a callable that
    gives the generator of a step from ``state.step`` (the trainer's
    per-step seeding)."""

    def multi_step(state: TrainState, batch, generator, num_inner: int = unroll
                   ) -> Dict[str, torch.Tensor]:
        batches = list(batch) if isinstance(batch, (list, tuple)) else [batch] * num_inner
        runs = [train_step(state, b, generator(state.step) if callable(generator) else generator)
                for b in batches]
        return {k: torch.stack([m[k] for m in runs]) for k in runs[0]}

    return multi_step
