"""Running-statistics normalizer (counterpart of graph_physics_tpu/models/normalizer.py).

The statistics are fp32 buffers of the module, named as the reference's
(``_acc_sum``, ``_acc_sum_squared``, ``_acc_count``,
``_num_accumulations``), so they travel with ``state_dict()`` and through
the weight bridge. Semantics as in the JAX package: accumulate only while
fewer than ``MAX_ACCUMULATIONS`` calls have accumulated (counted per call),
mean and std from the sums with a count of at least 1, std clamped below
by ``STD_EPSILON``, and a validity mask keeps padded rows out.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

MAX_ACCUMULATIONS = 10**5
STD_EPSILON = 1e-8


class Normalizer(nn.Module):
    def __init__(self, size: int):
        super().__init__()
        self.register_buffer("_acc_sum", torch.zeros(size))
        self.register_buffer("_acc_sum_squared", torch.zeros(size))
        self.register_buffer("_acc_count", torch.zeros(()))
        self.register_buffer("_num_accumulations", torch.zeros(()))

    def mean_std(self) -> Tuple[torch.Tensor, torch.Tensor]:
        safe = torch.clamp(self._acc_count, min=1.0)
        mean = self._acc_sum / safe
        var = self._acc_sum_squared / safe - mean**2
        std = torch.sqrt(torch.clamp(var, min=0.0))
        return mean, torch.clamp(std, min=STD_EPSILON)

    @torch.no_grad()
    def accumulate(self, data: torch.Tensor, mask: Optional[torch.Tensor] = None) -> None:
        """Fold the statistics of ``data`` [..., F] (rows where ``mask``) in."""
        flat = data.float().reshape(-1, data.shape[-1])
        if mask is not None:
            m = mask.reshape(-1, 1).float()
            s, s2, cnt = (flat * m).sum(0), (flat * flat * m).sum(0), m.sum()
        else:
            s, s2 = flat.sum(0), (flat * flat).sum(0)
            cnt = torch.tensor(float(flat.shape[0]), device=flat.device)
        allow = (self._num_accumulations < MAX_ACCUMULATIONS).float()
        self._acc_sum += allow * s
        self._acc_sum_squared += allow * s2
        self._acc_count += allow * cnt
        self._num_accumulations += allow

    def normalize(self, data: torch.Tensor, mask: Optional[torch.Tensor] = None,
                  accumulate: bool = False) -> torch.Tensor:
        """``(data - mean) / std``, after folding ``data`` in when ``accumulate``."""
        if accumulate:
            self.accumulate(data, mask)
        mean, std = self.mean_std()
        return ((data.float() - mean) / std).to(data.dtype)

    def inverse(self, data: torch.Tensor) -> torch.Tensor:
        """``data * std + mean`` (normalizer.py:normalizer_inverse)."""
        mean, std = self.mean_std()
        return (data.float() * std + mean).to(data.dtype)
