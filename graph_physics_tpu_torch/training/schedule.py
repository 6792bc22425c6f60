"""LR schedule and optimizer (counterpart of graph_physics_tpu/training/schedule.py).

``make_optimizer`` gives the JAX package's optax chain: clip by global
norm, then AdamW driven by the cosine-warmup schedule. The clip follows
optax's formula, ``g · max_norm / ‖g‖`` once ‖g‖ ≥ max_norm, with no
epsilon in the denominator (``torch.nn.utils.clip_grad_norm_`` adds
1e-6). The schedule is evaluated at the count of updates made before
this one, as optax does.

Gradient accumulation (``accumulate_grad_batches`` k > 1) follows
``optax.MultiSteps`` as schedule.py:make_optimizer wraps the chain in it:
each call folds the batch's gradients into their running mean (Welford,
``acc + (g - acc) / (n + 1)``, as optax does), and every k-th call clips
that mean and takes the AdamW step. The schedule counts those updates,
not the batches; the train state's step counts batches, as JAX's does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Iterable

import torch


def cosine_warmup_schedule(base_lr: float, warmup: int, max_iters: int,
                           min_lr_factor: float = 0.001) -> Callable[[int], float]:
    """Cosine decay × linear warmup with a relative floor
    (schedule.py:cosine_warmup_schedule): the step is offset by +1, the
    warmup *multiplies* the cosine, and the floor applies after both."""
    warmup = max(int(warmup), 1)
    max_iters = max(int(max_iters), 1)

    def schedule(step: int) -> float:
        e = float(step) + 1.0
        factor = 0.5 * (1.0 + math.cos(math.pi * e / max_iters))
        if e <= warmup:
            factor = factor * e / warmup
        return base_lr * max(factor, min_lr_factor)

    return schedule


class ClippedAdamW:
    """Global-norm clip, then AdamW at the scheduled rate, on a fixed list
    of parameters. :meth:`step` reads their ``.grad`` and returns the
    global norm of those gradients (before clipping and accumulation).
    With ``every_k`` > 1 it accumulates and updates every k-th call."""

    def __init__(self, params: Iterable[torch.nn.Parameter], schedule: Callable[[int], float],
                 weight_decay: float, b1: float, b2: float, eps: float, grad_clip: float,
                 every_k: int = 1):
        self.params = [p for p in params if p.requires_grad]
        self.schedule = schedule
        self.grad_clip = grad_clip
        self.every_k = int(every_k)
        self.count = 0  # AdamW updates made
        self.mini_step = 0  # batches folded into ``acc`` since the last update
        self.acc = ([torch.zeros_like(p) for p in self.params] if self.every_k > 1 else None)
        self.adamw = torch.optim.AdamW(self.params, lr=schedule(0), betas=(b1, b2), eps=eps,
                                       weight_decay=weight_decay)

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))
        if self.acc is not None:
            for p, a in zip(self.params, self.acc):
                g = p.grad if p.grad is not None else torch.zeros_like(a)
                a.add_((g - a) / float(self.mini_step + 1))
            self.mini_step += 1
            if self.mini_step < self.every_k:
                return norm
            for p, a in zip(self.params, self.acc):
                p.grad = a.clone()
                a.zero_()
            self.mini_step = 0
            grads = [p.grad for p in self.params]
            clip_norm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))
        else:
            clip_norm = norm
        scale = torch.where(clip_norm < self.grad_clip, torch.ones_like(clip_norm),
                            self.grad_clip / clip_norm)
        for g in grads:
            g.mul_(scale)
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule(self.count)
        self.adamw.step()
        self.count += 1
        return norm

    def state_dict(self) -> Dict:
        """The moments, the update count and the accumulation buffers."""
        return {"adamw": self.adamw.state_dict(), "count": self.count,
                "mini_step": self.mini_step, "acc": self.acc}

    @torch.no_grad()
    def load_state_dict(self, state: Dict) -> None:
        self.adamw.load_state_dict(state["adamw"])
        self.count = int(state["count"])
        self.mini_step = int(state["mini_step"])
        if self.acc is not None:
            for a, b in zip(self.acc, state["acc"]):
                a.copy_(b)


@dataclass(frozen=True)
class OptimizerConfig:
    """What :func:`make_optimizer` returns; ``init(params)`` binds it to
    the parameters, as ``optax.GradientTransformation.init`` does."""

    learning_rate: float
    warmup: int
    num_steps: int
    weight_decay: float = 1e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    accumulate_grad_batches: int = 1

    def init(self, params: Iterable[torch.nn.Parameter]) -> ClippedAdamW:
        return ClippedAdamW(params, cosine_warmup_schedule(self.learning_rate, self.warmup,
                                                           self.num_steps),
                            self.weight_decay, self.b1, self.b2, self.eps, self.grad_clip,
                            every_k=self.accumulate_grad_batches)


def make_optimizer(learning_rate: float, warmup: int, num_steps: int,
                   weight_decay: float = 1e-4, b1: float = 0.9, b2: float = 0.95,
                   grad_clip: float = 1.0, accumulate_grad_batches: int = 1
                   ) -> OptimizerConfig:
    """AdamW (wd 1e-4, betas 0.9/0.95) after a global-norm clip of 1.0,
    with the cosine warmup, every ``accumulate_grad_batches`` batches on
    the mean of their gradients (schedule.py:make_optimizer)."""
    return OptimizerConfig(learning_rate, warmup, num_steps, weight_decay, b1, b2,
                           grad_clip=grad_clip,
                           accumulate_grad_batches=max(int(accumulate_grad_batches), 1))
